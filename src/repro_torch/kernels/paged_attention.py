"""Paged attention straight from the K/V block pool: the CUDA kernel's
wrapper and its plain PyTorch version.

Port of ``repro/kernels/paged_attention.py::paged_attention_pool`` (the
Pallas TPU kernel). The kernel is ``csrc/paged_attention.cu``, CUDA C++ for
``sm_90a``: grid ``(b, h_kv, ceil(g·sq / 16))``, each block owning 16 packed
query rows (row = head_in_group·sq + q_index) of one K/V head, looping over
the row's *live* table entries only and running the reference's
online-softmax step in fp32 on each physical block staged in shared memory
(one key per lane; block_size 4, 8, 16 or 32 and head_dim <= 128).

Build and binding: at first use ``kernels.build`` compiles the source with
``nvcc`` into a shared library under ``build/repro_torch/`` at the repo root
(named by a hash of the source and flags, so an edited source rebuilds),
and ``ctypes`` loads its plain C entry. The wrapper checks devices, dtypes,
shapes and contiguity, allocates the output with ``torch.empty``, launches
on ``torch.cuda.current_stream()`` and raises if ``cudaGetLastError()`` is
nonzero.

:func:`paged_attention_plain` is gather-then-attend in fp32, mirroring
``repro.kernels.ref.paged_attention_ref``: the CPU lowering the tests hold
against JAX, and the yardstick ``chip_smoke.py`` holds the kernel against
on the card. ``ops.paged_attention`` picks between the two by device.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.models.layers import attention_reference

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "paged_attention.cu"
MAX_HEAD_DIM = 128  # 4 head dims per lane
BLOCK_SIZES = (4, 8, 16, 32)  # one key per lane; compiled for each

# kernel launches since the caller last set this to 0 (one per launch, and
# nowhere else): chip_smoke.py reads it to show the serve path ran the kernel
launches = 0

_lib = None


def _entry():
    global _lib
    if _lib is None:
        lib = kbuild.load(SOURCE)
        fn = lib.paged_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.paged_attention_fwd


def _index(x, b: int, name: str, device):
    """(b,) per-row int32 on the kernel's device (tiny; converted here)."""
    x = torch.as_tensor(x, device=device).to(torch.int32).contiguous()
    if x.shape != (b,):
        raise ValueError(f"{name} must be ({b},), got {tuple(x.shape)}")
    return x


def paged_attention_kernel(q, k_pool, v_pool, block_tables, kv_offset,
                           kv_len, *, causal: bool = True, window: int = 0,
                           q_lens=None):
    """Launch the CUDA kernel. q (b, sq, hq, hd); k/v pool (n_blocks,
    block_size, hkv, hd), same dtype as q (float32 or bfloat16);
    block_tables (b, n_tbl) physical ids (-1 unallocated); kv_offset /
    kv_len / q_lens (b,). Returns (b, sq, hq, hd) in q's dtype."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_kernel needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} must "
                         f"match q's {q.dtype}")
    if q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    b, sq, hq, hd = q.shape
    _, bs, hkv, hd_k = k_pool.shape
    if hd_k != hd or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(k_pool.shape)}")
    if hd > MAX_HEAD_DIM or bs not in BLOCK_SIZES:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"block_size in {BLOCK_SIZES}, got {hd}, {bs}")
    if (hd * q.element_size()) % 16 or k_pool.data_ptr() % 16 \
            or v_pool.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned with head_dim "
                         "rows a multiple of 16 bytes (16-byte K/V loads)")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()):
        raise ValueError("q and the pools must be contiguous")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, n_tbl), got "
                         f"{tuple(block_tables.shape)}")
    tables = block_tables.to(torch.int32).contiguous()
    off = _index(kv_offset, b, "kv_offset", q.device)
    ln = _index(kv_len, b, "kv_len", q.device)
    ql = (torch.full((b,), sq, dtype=torch.int32, device=q.device)
          if q_lens is None else _index(q_lens, b, "q_lens", q.device))
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    rc = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  tables.data_ptr(), off.data_ptr(), ln.data_ptr(),
                  ql.data_ptr(), out.data_ptr(), b, sq, hq, hkv, hd, bs,
                  tables.shape[1], int(causal), int(window),
                  int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise kbuild.KernelLaunchError(
            f"paged_attention launch failed: CUDA error {rc}")
    launches += 1
    return out


def paged_attention_plain(q, k_pool, v_pool, block_tables, kv_offset,
                          kv_len, *, causal: bool = True, window: int = 0,
                          q_lens=None):
    """Gather-then-attend in fp32 (mirrors ``ref.paged_attention_ref``):
    materializes each row's full logical K/V view through its table and
    runs the direct-softmax reference over it; query positions past a
    row's ``q_lens`` are zeroed."""
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    b = q.shape[0]
    span = (block_tables.long().clamp(0, nb - 1)[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :]).reshape(b, -1)
    kf = k_pool.reshape(nb * bs, *k_pool.shape[2:])[span]
    vf = v_pool.reshape(nb * bs, *v_pool.shape[2:])[span]
    kv_len = torch.as_tensor(kv_len, device=q.device)
    kv_offset = torch.as_tensor(kv_offset, device=q.device)
    out = attention_reference(q.float(), kf.float(), vf.float(),
                              causal=causal, window=window,
                              kv_offset=kv_offset, kv_len=kv_len)
    if q_lens is not None:
        q_lens = torch.as_tensor(q_lens, device=q.device)
        keep = torch.arange(q.shape[1], device=q.device)[None, :] \
            < q_lens[:, None]
        out = torch.where(keep[:, :, None, None], out, 0.0)
    return out.to(q.dtype)
