"""Dispatch for the port's kernels.

``paged_attention`` sends a CPU tensor to the plain PyTorch version and a
CUDA tensor to the hand-written CUDA kernel — by the tensor's device alone:
no environment switch and no fallback (a kernel that fails to build or
launch raises).
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as pa


def paged_attention(q, k_pool, v_pool, block_tables, kv_offset, kv_len, *,
                    causal: bool = True, window: int = 0, q_lens=None):
    """q (b, sq, hq, hd); k/v pool (n_blocks, block_size, hkv, hd);
    block_tables (b, n_tbl) (-1 = unallocated); kv_offset / kv_len (b,)
    per-row cache depth / live length; ``q_lens (b,)`` optional per-row
    real query counts. Returns (b, sq, hq, hd). See
    ``kernels/paged_attention.py`` for the masking contract."""
    fn = (pa.paged_attention_plain if q.device.type == "cpu"
          else pa.paged_attention_kernel)
    return fn(q, k_pool, v_pool, block_tables, kv_offset, kv_len,
              causal=causal, window=window, q_lens=q_lens)
