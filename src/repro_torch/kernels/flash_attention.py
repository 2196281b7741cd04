"""Flash attention over a full sequence: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``repro/kernels/flash_attention.py::flash_attention_bhsd`` (the
Pallas TPU kernel), the forward of the training path's attention. The
kernel is ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``: each block
owns a tile of query rows of one head and loops over the K/V tiles its rows
can attend (tiles above the causal diagonal or outside the window are
skipped; tiles are staged by ``cp.async``), with the reference's
online-softmax step in fp32 and (m, l, acc) in registers; 64 rows a
block. bf16 inputs run on the tensor cores (``mma.sync`` m16n8k16, the
next K/V tile loading while the current one is consumed); fp32 inputs on
the CUDA cores, since the reference's 2e-5 tolerance rules out TF32.
It reads the model's (b, s, h, hd) layout through strides, so the
reference's transposes to (B·H, S, hd) are not needed, and GQA is indexing
(query head h reads K/V head h // g): no ``repeat_kv``.

Build and binding as ``kernels/paged_attention.py``: ``kernels.build``
compiles the source at first use into ``build/repro_torch/`` and
``ctypes`` loads its C entry; the wrapper checks devices (every input on
one CUDA device), dtypes, shapes and contiguity, allocates the output with
``torch.empty``, launches under that device's context on its current
stream and raises if the launch returned a CUDA error.

:func:`flash_attention_plain` is direct softmax in fp32 with the output in
q's dtype (``ref.flash_attention_ref``'s math): the CPU lowering the tests
hold against JAX, and the yardstick ``chip_smoke.py`` holds the kernel
against on the card. ``ops.flash_attention`` picks between the two by
device and adds the backward.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.analysis import costs
from repro_torch.kernels import build as kbuild
from repro_torch.models.layers import attention_reference

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 112, 128)  # compiled for each (112: zamba2-7b)

# kernel launches since the caller last set this to 0 (one per launch, and
# nowhere else): chip_smoke.py reads it to show the train path ran the
# kernel; ``variant_launches`` splits it by variant (bf16 on the tensor
# cores, fp32 on the CUDA cores)
launches = 0
variant_launches = {"mma_bf16": 0, "fp32": 0}

_lib = None


def _entry():
    global _lib
    if _lib is None:
        lib = kbuild.load(SOURCE)
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.flash_attention_fwd


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           kv_offset: int = 0):
    """Launch the CUDA kernel. q (b, sq, hq, hd); k / v (b, sk, hkv, hd),
    contiguous, q's dtype (float32 or bfloat16); hd in ``HEAD_DIMS``;
    ``kv_offset`` the absolute position of q[0] minus that of k[0].
    Returns (b, sq, hq, hd) in q's dtype."""
    global launches
    dev = kbuild.launch_device("flash_attention_kernel", q=q, k=k, v=v)
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} must match q's "
                             f"{q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    _, sk, hkv, hd_k = k.shape
    if k.shape[0] != b or hd_k != hd or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (16-byte "
                         "loads)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, sq, sk, hq, hkv, hd, int(causal),
                      int(window), int(kv_offset),
                      int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kbuild.KernelLaunchError(
            f"flash_attention launch failed: CUDA error {rc}")
    launches += 1
    variant_launches["mma_bf16" if q.dtype == torch.bfloat16
                     else "fp32"] += 1
    if costs.counting():
        costs.record_launch("flash_attention", *costs.flash_work(
            q, k, v, causal, window, kv_offset)[:2])
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          kv_offset: int = 0):
    """Direct softmax in fp32, output in q's dtype (mirrors
    ``ref.flash_attention_ref``; GQA by a grouped einsum). Same contract
    as :func:`flash_attention_kernel`."""
    return attention_reference(q.float(), k.float(), v.float(),
                               causal=causal, window=window,
                               kv_offset=kv_offset).to(q.dtype)
