"""The backward of K1's attention: the CUDA kernels' wrapper and the plain
PyTorch version.

The kernels are ``csrc/attention_bwd.cu`` (CUDA C++ for ``sm_90a``), after
FlashAttention-2's backward: a row pass (the log-sum-exp of each query row
by its own pass over the keys it can attend, and D = rowsum(dout * out)),
a dK / dV pass (a block owns a 64-key tile of one KV head and loops over
the query tiles that can see it) and a dQ pass (a block owns a 64-row
query tile of one head and loops over its key tiles), fp32 arithmetic on
the CUDA cores, no atomics, so a gradient is the same from run to run.
They replace no TPU kernel: the JAX package's backward is ``jax.vjp``
through the chunked attention because ``pallas_call`` has no AD rule.

Build and binding as ``kernels/flash_attention.py``: ``kernels.build``
compiles the source at first use, ``ctypes`` loads its C entry; the
wrapper checks devices, dtypes, shapes, contiguity and alignment,
allocates the gradients and the fp32 scratch with ``torch.empty``,
launches under the tensors' device on its current stream and raises if a
launch returned a CUDA error.

:func:`attention_bwd_plain` is autograd through ``layers.chunked_attention``
(the JAX package's ``_flash_bwd``): what ``ops.flash_attention``'s
backward runs on a CPU tensor, and the yardstick ``chip_smoke.py`` holds
the kernels against on the card.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.analysis import costs
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.obs import tracer as obs_tracer

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "attention_bwd.cu"
KEYS_PER_TILE = 64  # a dK / dV block's keys (the kernel's kKeys)

# backward calls through the kernels since the caller last set this to 0
# (one per call of :func:`attention_bwd_kernel` that launched its three or
# four kernels); ``variant_launches`` splits it by dtype
launches = 0
variant_launches = {"bf16": 0, "fp32": 0}

_lib = None
_prebuild = None  # prebuild()'s nvcc, until _entry() waits for it
_prebuilt = False


def prebuild():
    """Start compiling the kernels in the background, once, so that a
    checkout's first training step builds them beside K1's forward."""
    global _prebuild, _prebuilt
    if not _prebuilt:
        _prebuilt = True
        _prebuild = kbuild.start(SOURCE)


def _entry():
    global _lib, _prebuild
    if _lib is None:
        if _prebuild is not None:
            proc, _prebuild = _prebuild, None
            kbuild.finish(SOURCE, proc)
        lib = kbuild.load(SOURCE)
        fn = lib.attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.attention_bwd


def gqa_split(b: int, hkv: int, group: int, key_tiles: int,
              sms: int) -> int:
    """How many blocks share one key tile's GQA group in the dK / dV pass:
    the smallest divisor of ``group`` that gives at least three blocks an
    SM (``group`` if none does). Each split beyond one writes a partial
    dK / dV to fp32 scratch, summed in split order afterwards; causal
    key tiles differ in work up to the sequence's tile count, and more,
    smaller blocks even it out."""
    base = b * hkv * key_tiles
    for d in range(1, group + 1):
        if group % d == 0 and base * d >= 3 * sms:
            return d
    return group


def attention_bwd_kernel(q, k, v, out, dout, *, causal: bool = True,
                         window: int = 0, kv_offset: int = 0):
    """(dq, dk, dv) of K1's attention by the CUDA kernels. q, out, dout
    (b, sq, hq, hd); k / v (b, sk, hkv, hd); contiguous, one dtype
    (float32 or bfloat16), hd in ``HEAD_DIMS``; ``out`` the forward's
    output, ``dout`` its cotangent. Gradients in q's dtype."""
    global launches
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} must match q's "
                             f"{q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    b, sq, hq, hd = q.shape
    _, sk, hkv, hd_k = k.shape
    if k.shape[0] != b or hd_k != hd or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    dev = kbuild.launch_device("attention_bwd_kernel", q=q, k=k, v=v,
                               out=out, dout=dout)
    tensors = (q, k, v, out, dout)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v, out and dout must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k, v, out and dout must be 16-byte aligned "
                         "(16-byte loads)")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0 or sk == 0 or b == 0:  # nothing to launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    _launch(q, k, v, out, dout, dq, dk, dv, dev, causal, window, kv_offset)
    launches += 1
    variant_launches["bf16" if q.dtype == torch.bfloat16 else "fp32"] += 1
    tr = obs_tracer.current()
    if tr.enabled:  # the step's tracer: how many backward calls it ran
        tr.count("k1_backward")
    if costs.counting():
        costs.record_launch("attention_bwd", *costs.attention_bwd_work(
            q, k, v, causal, window, kv_offset)[:2])
    return dq, dk, dv


def _launch(q, k, v, out, dout, dq, dk, dv, dev, causal, window,
            kv_offset):
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=dev)
    lse, dsum = torch.empty((b, hq, sq), **f32), torch.empty((b, hq, sq),
                                                             **f32)
    n_split = gqa_split(b, hkv, hq // hkv, -(-sk // KEYS_PER_TILE),
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    part = (torch.empty((2, n_split, b, sk, hkv, hd), **f32)
            if n_split > 1 else None)
    with torch.cuda.device(dev):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                      dsum.data_ptr(),
                      part.data_ptr() if part is not None else None,
                      b, sq, sk, hq, hkv, hd, int(causal), int(window),
                      int(kv_offset), n_split,
                      int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kbuild.KernelLaunchError(
            f"attention_bwd launch failed: CUDA error {rc}")


def attention_bwd_plain(q, k, v, out, dout, *, causal: bool = True,
                        window: int = 0, kv_offset: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512):
    """(dq, dk, dv) by autograd through ``layers.chunked_attention`` in
    ``q_chunk`` x ``kv_chunk`` blocks, recomputing the score blocks from
    (q, k, v) (``out`` is not read); as the JAX package's ``_flash_bwd``.
    Same contract as :func:`attention_bwd_kernel`."""
    from repro_torch.models.layers import chunked_attention
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              kv_offset=kv_offset, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        return torch.autograd.grad(o, (q, k, v), dout)
