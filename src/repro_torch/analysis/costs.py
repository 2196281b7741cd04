"""Loop-aware operation and byte counts of one step — the port's counterpart
of ``repro/analysis/hlo.py``.

The reference parses compiled HLO and multiplies each while body by its
trip count. The port runs eagerly, so it counts the ops the step
dispatches, under a ``TorchDispatchMode``, on any device (``meta`` for the
dry-run: nothing is allocated or computed):

  * **flops** — the matmul-class ops that ``torch.utils.flop_counter``
    prices (mm, bmm, addmm, convolution, SDPA; ``hlo.py`` counts dot and
    convolution only), forward and backward;
  * **hbm bytes** — ``hlo.py``'s streaming model applied to eager ops:
    every op reads its operands and writes its result once (logical
    elements). Views, allocations and metadata ops move nothing. An upper
    bound (it ignores reuse in cache), consistent across variants;
  * **collective bytes** — 0: one process, no collectives.

The hand-written kernels are ``ctypes`` calls that no dispatch mode sees,
so each wrapper adds its launch's work with :func:`record_launch`, by the
formulas below (``flash_work``, ``paged_work``, ``scan_work``) — the same
ones ``chip_smoke.py`` bounds each kernel by.

**Loop-awareness.** A step's work is linear in its slot count (each
(stage, slot) pair does the same work; embedding, loss head and optimizer
are per pair or per step) and in its depth (every layer of a homogeneous
stack does the same work; a hybrid stack adds its shared-block sites). So
:func:`extrapolate` counts the step at a few small points (microbatches,
layers and, for long sequences, whole sequence units, in which the count
is quadratic) and solves for the coefficients exactly (rational
arithmetic), in place of the reference's trip counts; ``trip_counts``
records the points used. A count at a third point equals the extrapolation
exactly (``tests/test_torch_dryrun.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from fractions import Fraction
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS


@dataclasses.dataclass
class Costs:
    """Counted work of one call (``hlo.HloCosts``' fields, plus the FLOPs
    by kind). Kinds: ``matmul`` (ops the flop counter prices), ``eager``
    (every other op that moves bytes), and each kernel by name."""

    flops: int = 0
    collective_bytes: int = 0  # one process: nothing crosses a link
    hbm_bytes: int = 0
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    count_by_kind: dict = dataclasses.field(default_factory=dict)
    flops_by_kind: dict = dataclasses.field(default_factory=dict)
    trip_counts: list = dataclasses.field(default_factory=list)

    def record(self, kind: str, nbytes: int, flops: int) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        self.flops_by_kind[kind] = self.flops_by_kind.get(kind, 0) + flops

    def scalars(self) -> dict:
        """Every counted number, flat: 'flops', 'hbm_bytes' and
        '<field>/<kind>' for the per-kind dicts."""
        out = {"flops": self.flops, "hbm_bytes": self.hbm_bytes}
        for name in ("bytes_by_kind", "count_by_kind", "flops_by_kind"):
            out.update({f"{name}/{k}": v
                        for k, v in getattr(self, name).items()})
        return out

    @classmethod
    def from_scalars(cls, values: dict, trip_counts=()) -> "Costs":
        c = cls(flops=values["flops"], hbm_bytes=values["hbm_bytes"],
                trip_counts=list(trip_counts))
        for key, v in values.items():
            if "/" in key:
                name, kind = key.split("/", 1)
                getattr(c, name)[kind] = v
        return c

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Counting eager ops
# ---------------------------------------------------------------------------

_ACTIVE: list = []  # the Costs of every open count() (innermost last)

# ops that allocate without writing, or only read metadata
_FREE = {torch.ops.aten.empty, torch.ops.aten.empty_like,
         torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
         torch.ops.aten.new_empty_strided, torch.ops.aten.detach,
         torch.ops.aten.alias, torch.ops.aten.lift_fresh}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.is_view or packet in _FREE:
            return out
        flop_fn = flop_registry.get(packet)
        flops = int(flop_fn(*args, **kwargs, out_val=out)) if flop_fn else 0
        self.costs.record("matmul" if flop_fn else "eager",
                          _bytes((args, kwargs)) + _bytes(out), flops)
        return out


@contextlib.contextmanager
def count():
    """``with count() as c:`` — every op dispatched (forward and backward)
    and every kernel launch inside the block adds to the Costs ``c``."""
    costs = Costs()
    _ACTIVE.append(costs)
    try:
        with _Counter(costs):
            yield costs
    finally:
        _ACTIVE.remove(costs)


def counting() -> bool:
    """Whether a count is open (the kernel wrappers skip the work formulas
    otherwise)."""
    return bool(_ACTIVE)


def record_launch(kind: str, nbytes: int, flops: int) -> None:
    """A kernel wrapper's report of one launch to every open count."""
    for costs in _ACTIVE:
        costs.record(kind, int(nbytes), int(flops))


# ---------------------------------------------------------------------------
# The kernels' work: what each launch must move and do (chip_smoke.py
# bounds each kernel by these; the wrappers report them to open counts)
# ---------------------------------------------------------------------------


def bound_s(nbytes: float, ops: float, dtype: torch.dtype):
    """(the least time the card could take (s), 'bytes' or 'operations'):
    the larger of the bytes over the memory rate and the operations over
    the peak rate of ``dtype``."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_pairs(sq: int, sk: int, causal: bool, window: int, off: int) -> int:
    """Attended (query, key) pairs under K1's masks: query i (absolute
    position i + off) attends keys [max(0, qpos - window + 1) if windowed,
    min(sk, qpos + 1) if causal else sk)."""
    qpos = np.arange(sq, dtype=np.int64) + off
    hi = np.minimum(sk, qpos + 1) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def flash_work(q, k, v, causal=True, window=0, kv_offset=0):
    """(bytes, operations, attended pairs) one K1 launch must move and do:
    each input read once and the output written once; QK^T and PV over the
    pairs its masks keep, 2 operations per multiply-add."""
    b, sq, hq, hd = q.shape
    pairs = flash_pairs(sq, k.shape[1], causal, window, kv_offset)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return nbytes, 4 * hd * hq * b * pairs, pairs


def case_work(offsets, q_lens, sq, window):
    """(attended (query, key) pairs, live K/V tokens) that K2's masks need
    over rows at cache depths ``offsets``: each real query attends keys
    [max(0, qpos-window+1) if windowed, qpos]; a row's live tokens are the
    union of its queries'."""
    pairs = live = 0
    for off, ql in zip(offsets, q_lens or [sq] * len(offsets)):
        spans = [(max(0, off + i - window + 1) if window else 0, off + i + 1)
                 for i in range(ql)]
        pairs += sum(hi - lo for lo, hi in spans)
        if spans:
            live += max(h for _, h in spans) - min(lo for lo, _ in spans)
    return pairs, live


def paged_work(q, k_pool, block_tables, offsets, q_lens, window):
    """(bytes, operations, pairs, live tokens) of one K2 launch whose
    attending rows sit at ``offsets`` with ``q_lens`` real queries (None:
    all ``sq``): the live K/V tokens read once, q read and the output
    written once, the tables and three int32 per row; QK^T and PV over the
    pairs, 2 operations per multiply-add."""
    b, sq, hq, hd = q.shape
    pairs, live = case_work(offsets, q_lens, sq, window)
    es = q.element_size()
    nbytes = (live * k_pool.shape[2] * k_pool.shape[3] * 2 * es
              + 2 * q.numel() * es + 4 * (block_tables.numel() + 3 * b))
    return nbytes, pairs * hq * hd * 4, pairs, live


def paged_launch_work(q, k_pool, block_tables, kv_offset, window=0,
                      q_lens=None):
    """:func:`paged_work` of a launch as the engine makes it, counting
    the rows whose table is allocated (in the engine kv_len is always
    kv_offset + q_len). Reads the offsets back to the host."""
    b, sq = q.shape[0], q.shape[1]
    ql = [sq] * b if q_lens is None else q_lens.tolist()
    rows = [r for r, ok in enumerate((block_tables[:, 0] >= 0).tolist())
            if ok]
    off = kv_offset.tolist()
    return paged_work(q, k_pool, block_tables, [off[r] for r in rows],
                      [ql[r] for r in rows], window)


def scan_work(da, dbx, cmat, h0):
    """(bytes, operations) one K3 launch must move and do: da, dbx and C
    read once, h0 read and h_final written in fp32, y written in da's
    dtype; two fused multiply-adds per (step, channel, state)."""
    b, s, di, n = da.shape
    es = da.element_size()
    nbytes = (2 * b * s * di * n * es + b * s * n * es + b * di * n * 4 * 2
              + b * s * di * es)
    return nbytes, 4 * b * s * di * n


# ---------------------------------------------------------------------------
# Loop-awareness: exact extrapolation over (microbatches, layers)
# ---------------------------------------------------------------------------


def _solve(rows: list, rhs: list) -> list:
    """Exact solution of the square system rows · x = rhs (Fractions)."""
    n = len(rows)
    a = [[Fraction(v) for v in r] + [Fraction(b)] for r, b in zip(rows, rhs)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        for r in range(n):
            if r != col and a[r][col] != 0:
                f = a[r][col] / a[col][col]
                a[r] = [x - f * y for x, y in zip(a[r], a[col])]
    return [a[i][n] / a[i][i] for i in range(n)]


def extrapolate(count_at: Callable, points: Sequence, features: Callable,
                target) -> Costs:
    """The Costs at ``target`` of a call whose every count is linear in
    ``features(point)``: ``count_at(point)`` counts the call at each of
    ``points`` (as many as features, independent), and the coefficients
    are solved exactly. Raises if the result is not a whole number (the
    call is then not linear in those features)."""
    counted = [count_at(p).scalars() for p in points]
    keys = sorted({k for c in counted for k in c})
    rows = [features(p) for p in points]
    want = features(target)
    out = {}
    for key in keys:
        coef = _solve(rows, [c.get(key, 0) for c in counted])
        v = sum(c * f for c, f in zip(coef, want))
        if v.denominator != 1:
            raise ValueError(f"{key} is not linear in the features: "
                             f"extrapolates to {v}")
        out[key] = int(v)
    return Costs.from_scalars(out, trip_counts=[
        {"points": [list(p) for p in points], "target": list(target)}])
