"""The work one K1 (flash attention) launch must do, from its shapes, and
the least time an H100 could take for it (frozen copies of
``repro_torch/analysis/costs.py``'s ``flash_pairs``, ``flash_work`` and
``bound_s``): each input read once and the output written once; QK^T and
PV over the (query, key) pairs the masks keep, 2 operations per
multiply-add. The same work whatever implements the attention."""
from __future__ import annotations

import numpy as np

from bench.yardstick.peaks import HBM_BW, PEAK_FLOPS


def flash_pairs(sq: int, sk: int, causal: bool, window: int, off: int) -> int:
    qpos = np.arange(sq, dtype=np.int64) + off
    hi = np.minimum(sk, qpos + 1) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def flash_work(q_shape, k_shape, v_shape, element_size: int, causal=True,
               window=0, kv_offset=0):
    """(bytes, operations, attended pairs) of one launch on q (b, sq, hq,
    hd), k / v (b, sk, hkv, hd)."""
    b, sq, hq, hd = q_shape
    numel = lambda s: int(np.prod(s))
    pairs = flash_pairs(sq, k_shape[1], causal, window, kv_offset)
    nbytes = element_size * (2 * numel(q_shape) + numel(k_shape)
                             + numel(v_shape))
    return nbytes, 4 * hd * hq * b * pairs, pairs


def bound_s(nbytes: float, ops: float, precision: str):
    """(the least time (s), "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the peak rate of
    ``precision``."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_FLOPS[precision]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
