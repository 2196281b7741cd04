"""Paged attention straight from the K/V block pool: the CUDA kernel's
wrapper, its plain PyTorch version, and a plain mirror of the kernel's
split-KV partition and combine.

Port of ``repro/kernels/paged_attention.py::paged_attention_pool`` (the
Pallas TPU kernel). The kernel is ``csrc/paged_attention.cu``, CUDA C++ for
``sm_90a``, with two variants that the wrapper picks from the dtype,
``sq`` and ``head_dim`` alone (:func:`pick_variant`):

* ``split_kv`` (decode and short rows; every fp32 call): grid
  ``(n_splits, h_kv * ceil(g·sq / 16), b)``; each block owns 16 packed
  query rows (row = head_in_group·sq + q_index) of one K/V head and one
  contiguous range of table entries, stages 32-key chunks with
  ``cp.async`` and runs the reference's online-softmax step in fp32 on the
  CUDA cores.
* ``append_mma`` (bf16 chunks of ``sq >= APPEND_MIN_SQ``, head_dim in
  ``MMA_HEAD_DIMS``): each block owns 64 packed rows of one K/V head and
  one range of table entries, and runs S = Q Kᵀ and O += P V on the tensor
  cores (``mma.sync`` m16n8k16), 64-key chunks of pages double-buffered by
  ``cp.async``.

With more than one split, the blocks write fp32 (m, l, acc) partials and
a combine kernel merges them. The plan comes from :func:`plan_splits`, a
function of shapes only: reading ``kv_len``'s values would put a host
sync in every layer.

Build and binding: at first use ``kernels.build`` compiles the source with
``nvcc`` into a shared library under ``build/repro_torch/`` at the repo root
(named by a hash of the sources and flags, so an edited source or header
rebuilds), and ``ctypes`` loads its plain C entry. The wrapper checks
devices, dtypes, shapes and contiguity, allocates the output and the
partials with ``torch.empty``, launches on ``torch.cuda.current_stream()``
and raises if a launch returned a CUDA error.

:func:`paged_attention_plain` is gather-then-attend in fp32, mirroring
``repro.kernels.ref.paged_attention_ref``: the CPU lowering the tests hold
against JAX, and the yardstick ``chip_smoke.py`` holds the kernel against
on the card. ``ops.paged_attention`` picks between the two by device.
:func:`paged_attention_split_plain` repeats the split-KV variant's
arithmetic (per-split partials, then the combine) for the tests only.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.models.layers import attention_reference

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "paged_attention.cu"
MAX_HEAD_DIM = 128  # split-KV: 4 head dims per lane
BLOCK_SIZES = (4, 8, 16, 32)  # powers of two dividing a 32-key chunk
MMA_HEAD_DIMS = (16, 32, 64, 128)  # the tensor-core tile is compiled for each
APPEND_MIN_SQ = 4  # bf16 calls with sq >= this take the tensor-core tile
# per variant: (packed query rows per block, keys per staged chunk, splits x
# row tiles the planner aims at per (row, kv head))
SPLIT_PLAN = {"split_kv": (16, 32, 32), "append_mma": (64, 64, 64)}
SPLIT_MIN_CHUNKS = 2  # chunks per split, at least
NEG_INF = -1e30  # the reference's masked score

# kernel launches since the caller last set this to 0 (one per wrapper
# call that launched, and nowhere else): chip_smoke.py reads it to show the
# serve path ran the kernel; ``variant_launches`` splits it by variant
launches = 0
variant_launches = {"split_kv": 0, "append_mma": 0}

_lib = None


def _entry():
    global _lib
    if _lib is None:
        lib = kbuild.load(SOURCE)
        fn = lib.paged_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.paged_attention_fwd


def pick_variant(dtype, sq: int, hd: int) -> str:
    """The kernel variant for a call: ``append_mma`` for bf16 chunks of at
    least ``APPEND_MIN_SQ`` tokens with head_dim in ``MMA_HEAD_DIMS``, else
    ``split_kv`` (head_dim <= 128, a multiple of 4 whose rows are whole
    16-byte copies). Raises on what neither takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dtype}")
    if dtype == torch.bfloat16 and sq >= APPEND_MIN_SQ \
            and hd in MMA_HEAD_DIMS:
        return "append_mma"
    es = 2 if dtype == torch.bfloat16 else 4
    if hd <= MAX_HEAD_DIM and hd % 4 == 0 and (hd * es) % 16 == 0:
        return "split_kv"
    raise ValueError(f"no paged-attention variant takes head_dim {hd} "
                     f"({dtype}, sq {sq})")


def plan_splits(n_tbl: int, block_size: int, sq: int, g: int,
                variant: str = "split_kv"):
    """(pages_per_split, n_splits) of a variant, from shapes the host knows
    (never from ``kv_len``'s values). Split i covers table entries
    [i·pages_per_split, min((i+1)·pages_per_split, n_tbl)): whole staged
    chunks, at least ``SPLIT_MIN_CHUNKS`` of them, and about target /
    row-tiles splits (``SPLIT_PLAN``), so a decode step (one row tile)
    spreads its live pages over many blocks while a long chunk of rows
    keeps one split and writes ``out`` directly."""
    rows, chunk, target = SPLIT_PLAN[variant]
    chunk_pages = max(1, chunk // block_size)
    n_chunks = -(-n_tbl // chunk_pages)
    row_tiles = -(-(g * sq) // rows)
    max_splits = max(1, target // max(row_tiles, 1))
    per_split = max(SPLIT_MIN_CHUNKS, -(-n_chunks // max_splits))
    pages = per_split * chunk_pages
    return pages, max(1, -(-n_tbl // pages))


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
    variant = pick_variant(q.dtype, sq, hd)
    if bs not in BLOCK_SIZES:
        raise ValueError(f"kernel takes block_size in {BLOCK_SIZES}, got "
                         f"{bs}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned (16-byte "
                         "copies)")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()):
        raise ValueError("q and the pools must be contiguous")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, n_tbl), got "
                         f"{tuple(block_tables.shape)}")
    tables = block_tables.to(torch.int32).contiguous()
    n_tbl = tables.shape[1]
    off = _index(kv_offset, b, "kv_offset", q.device)
    ln = _index(kv_len, b, "kv_len", q.device)
    ql = (torch.full((b,), sq, dtype=torch.int32, device=q.device)
          if q_lens is None else _index(q_lens, b, "q_lens", q.device))
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    pages, n_splits = plan_splits(n_tbl, bs, sq, hq // hkv, variant)
    part_acc = part_ml = None
    if n_splits > 1:
        rows = (hq // hkv) * sq
        part_acc = torch.empty((b, hkv, rows, n_splits, hd),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, hkv, rows, n_splits, 2),
                              dtype=torch.float32, device=q.device)
    rc = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  tables.data_ptr(), off.data_ptr(), ln.data_ptr(),
                  ql.data_ptr(), out.data_ptr(),
                  None if part_acc is None else part_acc.data_ptr(),
                  None if part_ml is None else part_ml.data_ptr(),
                  b, sq, hq, hkv, hd, bs, n_tbl, int(causal), int(window),
                  int(q.dtype == torch.bfloat16),
                  int(variant == "append_mma"), pages, n_splits,
                  1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise kbuild.KernelLaunchError(
            f"paged_attention launch failed ({variant}): CUDA error {rc}")
    launches += 1
    variant_launches[variant] += 1
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


def paged_attention_split_plain(q, k_pool, v_pool, block_tables, kv_offset,
                                kv_len, *, causal: bool = True,
                                window: int = 0, q_lens=None,
                                pages_per_split=None):
    """The split-KV arithmetic in plain PyTorch, fp32 (the tests hold it
    against JAX): the table is cut as :func:`plan_splits` cuts it for the
    split-KV variant (or into ``pages_per_split``-entry splits); each split
    gives a partial (m, l, acc) over its own keys with the reference's
    guards (an empty split: m = NEG_INF, l = 0); the combine weighs each
    non-empty partial by exp(m - max m) and divides by max(sum of weighted
    l, 1e-30), so a row whose every split is empty gives 0."""
    b, sq, hq, hd = q.shape
    nb, bs, hkv, _ = k_pool.shape
    n_tbl = block_tables.shape[1]
    g = hq // hkv
    if pages_per_split is None:
        pages_per_split, n_splits = plan_splits(n_tbl, bs, sq, g)
    else:
        n_splits = max(1, -(-n_tbl // pages_per_split))
    dev = q.device
    span = pages_per_split * bs  # keys per split
    n_keys = n_splits * span
    ids = block_tables.long().clamp(0, nb - 1)
    ids = torch.cat([ids, ids.new_zeros((b, n_splits * pages_per_split
                                         - n_tbl))], dim=1)
    flat = (ids[:, :, None] * bs
            + torch.arange(bs, device=dev)[None, None, :]).reshape(b, -1)
    kf = k_pool.reshape(nb * bs, hkv, hd)[flat].float()  # (b, n_keys, ...)
    vf = v_pool.reshape(nb * bs, hkv, hd)[flat].float()
    off = torch.as_tensor(kv_offset, device=dev).long().reshape(b)
    kv_end = torch.as_tensor(kv_len, device=dev).long().reshape(b).clamp(
        max=n_tbl * bs)
    ql = (torch.full((b,), sq, device=dev) if q_lens is None
          else torch.as_tensor(q_lens, device=dev).long().reshape(b))
    qi = torch.arange(sq, device=dev)
    qpos = off[:, None] + qi[None, :]  # (b, sq)
    kpos = torch.arange(n_keys, device=dev)
    ok = (kpos[None, None, :] < kv_end[:, None, None]) \
        & (qi[None, :, None] < ql[:, None, None])
    if causal:
        ok = ok & (kpos[None, None, :] <= qpos[:, :, None])
    if window > 0:
        ok = ok & (kpos[None, None, :] > qpos[:, :, None] - window)
    qg = q.float().reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) / math.sqrt(hd)
    ok = ok[:, None, None]  # (b, 1, 1, sq, n_keys)
    s = torch.where(ok, s, NEG_INF).reshape(b, hkv, g, sq, n_splits, span)
    ok = ok.reshape(b, 1, 1, sq, n_splits, span)
    m = s.amax(-1)  # (b, hkv, g, sq, n_splits); NEG_INF for an empty split
    m_safe = torch.where(m <= NEG_INF, 0.0, m)
    p = torch.where(ok, torch.exp(s - m_safe[..., None]), 0.0)
    l_part = p.sum(-1)
    acc = torch.einsum("bhgqsk,bskhd->bhgqsd", p,
                       vf.reshape(b, n_splits, span, hkv, hd))
    mx = m.amax(-1, keepdim=True)
    w = torch.where(m <= NEG_INF, 0.0, torch.exp(m - torch.where(
        mx <= NEG_INF, 0.0, mx)))
    out = (w[..., None] * acc).sum(-2) / torch.clamp(
        (w * l_part).sum(-1), min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
