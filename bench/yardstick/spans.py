"""The program's own ranges in a ``torch.profiler`` trace, read from the
profiler's raw records (``prof.profiler.kineto_results.events()``), as
``bench/yardstick/trace.py`` reads device work and host ops:

* program ranges: the host ranges the port opens while its tracer is on,
  named ``repro.<span>[:<pass>] key=value ...``; a range's label is its
  name up to the first space (``repro.train.layer:recompute``);
* attribution: a kernel or copy belongs to the program ranges open on
  its launching thread when it was launched. Its launch is the host op
  its record links to (``linked_correlation_id``), or else the CUDA
  runtime call (a host record named ``cu...``) with its own correlation
  id; work with neither is ``unlinked``. (Autograd launches the
  backward's kernels on its own device thread, so they carry the
  recompute ranges opened there and not the main thread's
  ``repro.train.backward``.)
* device time by label: per card, the union inside the window of the
  work launched inside a range of that label; ``recompute`` the same
  over every label of the recompute pass;
* idle-gap labels: the innermost of the benchmark's and the program's
  ranges (``bench.`` and ``repro.``) open at the gap's middle, on any
  thread.

:func:`program` gathers the first three, with the tracer's counters,
into the dict the per-layer readers take (``run["trace"]["program"]``).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from bench.yardstick import trace as Y

PREFIX = "repro."
RECOMPUTE = ":recompute"


def label(name: str) -> str:
    """A range's label: its name up to the first space."""
    return name.split(" ", 1)[0]


@dataclasses.dataclass
class Launched:
    work: list  # (card, start_ns, end_ns, thread, launch_ns); thread and
    # launch_ns None when the work links to no host record
    ranges: list  # (thread, label, start_ns, end_ns) of the program's ranges
    links: dict  # how many records linked through a host op, a runtime
    # call, or nothing


def launched(events) -> Launched:
    """Device work with the thread and host time of its launch, and the
    program's ranges, from raw profiler records."""
    from torch.autograd import DeviceType

    ops, runtime, raw, ranges = {}, {}, [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                start = e.start_ns()
                raw.append((e.device_index(), start,
                            start + e.duration_ns(),
                            e.linked_correlation_id(), e.correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            name = e.name()
            if e.is_user_annotation():
                if name.startswith(PREFIX):
                    ranges.append((e.start_thread_id(), label(name),
                                   e.start_ns(),
                                   e.start_ns() + e.duration_ns()))
            else:
                host = runtime if name.startswith("cu") else ops
                host[e.correlation_id()] = (e.start_thread_id(),
                                            e.start_ns())
    work, links = [], {"op": 0, "runtime": 0, "none": 0}
    for card, s, e, linked, own in raw:
        at, how = ops.get(linked) if linked else None, "op"
        if at is None:
            at, how = runtime.get(own), "runtime"
        links[how if at else "none"] += 1
        work.append((card, s, e) + (at or (None, None)))
    return Launched(work, ranges, links)


def attributed(rec: Launched) -> list:
    """(card, start, end, labels) of every kernel or copy: ``labels`` the
    program ranges open on its launching thread at its launch, outermost
    first (None for unlinked work). One sweep a thread, since ranges on
    one thread nest."""
    spans = defaultdict(list)
    for th, lab, s, e in rec.ranges:
        spans[th].append((s, e, lab))
    todo = defaultdict(list)
    out = []
    for i, (card, s, e, th, at) in enumerate(rec.work):
        out.append((card, s, e, None))
        if th is not None:
            todo[th].append((at, i))
    for th, items in todo.items():
        mine = sorted(spans.get(th, ()), key=lambda x: (x[0], -x[1]))
        stack, nxt = [], 0
        for at, i in sorted(items):
            while nxt < len(mine) and mine[nxt][0] <= at:
                while stack and stack[-1][1] <= mine[nxt][0]:
                    stack.pop()
                stack.append(mine[nxt])
                nxt += 1
            while stack and stack[-1][1] <= at:
                stack.pop()
            card, s, e, _ = out[i]
            out[i] = (card, s, e, tuple(lab for _, end, lab in stack
                                        if end > at))
    return out


def seconds_by_label(work: list, lo: int, hi: int) -> dict:
    """{label: {card: s}} over :func:`attributed` work: per card, the
    union inside [lo, hi) of the work launched inside a range of that
    label; ``recompute`` over every label of the recompute pass,
    ``unlinked`` over the work that links to no launch."""
    spans = defaultdict(lambda: defaultdict(list))
    for card, s, e, labels in work:
        if labels is None:
            spans["unlinked"][card].append((s, e))
            continue
        for lab in set(labels):
            spans[lab][card].append((s, e))
        if any(lab.endswith(RECOMPUTE) for lab in labels):
            spans["recompute"][card].append((s, e))
    return {lab: {card: sum(b - a for a, b in Y.merged(
                      Y.clipped(iv, lo, hi))) / 1e9
                  for card, iv in by_card.items()}
            for lab, by_card in spans.items()}


def host_ranges(rec: Y.Records) -> list:
    """(start, end, name) of the benchmark's and the program's host
    ranges, for ``trace.label_at`` (the innermost open at a time)."""
    return [(s, e, name) for _, name, s, e, ann in rec.host
            if ann and name.startswith((Y.PREFIX, PREFIX))]


def program(events, lo: int, hi: int, counters: dict) -> dict:
    """What the per-layer readers take from one traced step: ``device_s``
    (:func:`seconds_by_label` in [lo, hi)), ``ranges`` (how many ranges
    of each label started in it), ``counters`` (the tracer's, by counter
    and range: ``{name: {range label: n}}``) and ``links``
    (:class:`Launched`'s)."""
    rec = launched(events)
    opened = defaultdict(int)
    for _, lab, s, _ in rec.ranges:
        if lo <= s < hi:
            opened[lab] += 1
    return {"device_s": seconds_by_label(attributed(rec), lo, hi),
            "ranges": dict(opened),
            "counters": {n: dict(v) for n, v in counters.items()},
            "links": rec.links}
