"""Reductions of a ``torch.profiler`` trace, read from the profiler's raw
records (``prof.profiler.kineto_results.events()``): building its event
tree takes minutes for a step of a hundred thousand kernels.

* device work: every kernel and copy on a card (not the card-side mirror
  of a ``record_function`` range, which spans the gaps between its
  kernels), as (card, name, start ns, end ns);
* busy time: the union of a card's work intervals inside the window;
* host ops: the top-level ``aten::`` calls, those whose innermost
  enclosing host event on their thread is not itself an ``aten::`` call
  (``chip_smoke.py::host_ops``'s rule on the event tree);
* idle gaps: the stretches of the window in which a card runs nothing,
  each labelled by the innermost of the benchmark's own ranges (names
  starting ``bench.``) open on the host at the gap's middle.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

PREFIX = "bench."


@dataclasses.dataclass
class Records:
    device: list  # (card, name, start_ns, end_ns)
    host: list  # (thread, name, start_ns, end_ns, is_annotation)


def records(events) -> Records:
    """Split raw profiler records into device work and host events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.device_index(), e.name(), start, end))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.start_thread_id(), e.name(), start, end,
                         e.is_user_annotation()))
    return Records(dev, host)


def merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clipped(intervals, lo: int, hi: int) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_ns(rec: Records, card: int, lo: int, hi: int) -> int:
    spans = merged(clipped([(s, e) for c, _, s, e in rec.device
                            if c == card], lo, hi))
    return sum(e - s for s, e in spans)


def host_ops(rec: Records, lo: int, hi: int) -> int:
    """Top-level ``aten::`` calls that start inside [lo, hi)."""
    by_thread = defaultdict(list)
    for tid, name, s, e, _ in rec.host:
        by_thread[tid].append((s, -(e - s), e, name.startswith("aten::")))
    count = 0
    for evs in by_thread.values():
        stack = []  # (end, is_aten) of the enclosing events
        for s, _, e, aten in sorted(evs):
            while stack and stack[-1][0] <= s:
                stack.pop()
            if aten and lo <= s < hi and not (stack and stack[-1][1]):
                count += 1
            stack.append((e, aten))
    return count


def window(rec: Records, name: str):
    """(start, end) ns of the first host range named ``name``."""
    for _, n, s, e, ann in rec.host:
        if ann and n == name:
            return s, e
    raise ValueError(f"no range {name!r} in the trace")


def kernel_seconds(rec: Records, lo: int, hi: int) -> dict:
    """Device seconds by kernel or copy name, inside the window."""
    out = defaultdict(float)
    for _, name, s, e in rec.device:
        if e > lo and s < hi:
            out[name] += (min(e, hi) - max(s, lo)) / 1e9
    return dict(out)


def ranges(rec: Records) -> list:
    """(start, end, name) of the benchmark's own host ranges."""
    return [(s, e, name) for _, name, s, e, ann in rec.host
            if ann and name.startswith(PREFIX)]


def label_at(spans: list, t: int) -> str:
    """The innermost of ``spans`` (:func:`ranges`) open at ``t``: the one
    that started last."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else "outside"


def idle_gaps(rec: Records, card: int, lo: int, hi: int) -> list:
    """(start, end) of the card's idle stretches inside [lo, hi)."""
    spans = merged(clipped([(s, e) for c, _, s, e in rec.device
                            if c == card], lo, hi))
    gaps, at = [], lo
    for s, e in spans:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps
