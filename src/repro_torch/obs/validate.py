"""Span-pairing validator for per-request lifecycle traces.

The tracer's per-request taxonomy is a small state machine; this module
checks a recorded event stream actually walked it:

* first event for a rid is ``enqueue``; ``admit`` happens exactly once
  (re-entry after a retraction must be a ``restore``);
* every ``admit`` closes with exactly one ``complete``, or with a
  terminal ``retract`` that is never followed by a ``restore``;
* every ``retract`` carries ``via`` ∈ {swap, recompute, requeue} and a
  ``via="swap"`` retract pairs with a ``swap_out`` for the same rid;
* in-flight events (``prefill_chunk``, ``first_token``, ``spec_*``,
  ``rollback``, ``prefix_hit``, ``swap_out``) only occur while resident;
* per-request engine ticks are monotone non-decreasing.

``validate_spans`` raises :class:`TraceInvariantError` listing every
violation, and returns per-state counts for well-formed traces. It takes
either a live ``Tracer.events`` list or a JSONL reload
(``obs.export.read_events``) — the two are interchangeable.
"""
from __future__ import annotations

# request lifecycle states
_QUEUED, _RUNNING, _RETRACTED, _DONE = "queued", "running", "retracted", "done"

_RESIDENT_ONLY = ("prefill_chunk", "first_token", "prefix_hit", "swap_out",
                  "spec_propose", "spec_verify", "rollback")
_RETRACT_VIAS = ("swap", "recompute", "requeue")


class TraceInvariantError(AssertionError):
    """A trace violated the request-lifecycle state machine."""

    def __init__(self, violations):
        self.violations = list(violations)
        lines = "\n".join(f"  - {v}" for v in self.violations)
        super().__init__(
            f"{len(self.violations)} trace invariant violation(s):\n{lines}")


def validate_spans(events, allow_open: bool = False) -> dict:
    """Check request-lifecycle invariants over an event stream.

    ``allow_open`` accepts a truncated trace (requests still queued or
    resident at the end); a drained engine run must validate with the
    default ``False``.

    Returns ``{"requests", "completed", "retracted_terminal", "violations"}``
    (violations is always 0 on return — otherwise the call raises).
    """
    state: dict = {}  # rid -> lifecycle state
    last_tick: dict = {}  # rid -> last seen tick
    swapped_out: set = set()  # rids with a swap_out since last residency
    completed: set = set()
    bad: list = []

    def expect(rid, ev, *want):
        got = state.get(rid)
        if got not in want:
            bad.append(f"rid {rid}: {ev!r} in state {got!r} "
                       f"(expected {' or '.join(map(repr, want))})")
            return False
        return True

    for i, ev in enumerate(events):
        name = ev.get("ev")
        rid = ev.get("rid")
        if rid is None:
            continue  # round records, compile instants, search spans
        tick = ev.get("tick", -1)
        if tick is not None and tick >= 0:
            prev = last_tick.get(rid)
            if prev is not None and tick < prev:
                bad.append(f"rid {rid}: tick went backwards "
                           f"{prev} -> {tick} at event {i} ({name!r})")
            last_tick[rid] = tick

        if name == "enqueue":
            if rid in state:
                bad.append(f"rid {rid}: duplicate 'enqueue'")
            else:
                state[rid] = _QUEUED
        elif name == "admit":
            if rid not in state:
                bad.append(f"rid {rid}: 'admit' before 'enqueue'")
                state[rid] = _RUNNING
            elif expect(rid, name, _QUEUED):
                state[rid] = _RUNNING
        elif name == "retract":
            via = ev.get("via")
            if via not in _RETRACT_VIAS:
                bad.append(f"rid {rid}: 'retract' via={via!r} (expected one "
                           f"of {_RETRACT_VIAS})")
            if via == "swap" and rid not in swapped_out:
                bad.append(f"rid {rid}: 'retract' via='swap' without a "
                           f"preceding 'swap_out'")
            if expect(rid, name, _RUNNING):
                state[rid] = _RETRACTED
            swapped_out.discard(rid)
        elif name == "restore":
            if expect(rid, name, _RETRACTED):
                state[rid] = _RUNNING
        elif name == "complete":
            if rid in completed:
                bad.append(f"rid {rid}: more than one 'complete'")
            elif expect(rid, name, _RUNNING):
                state[rid] = _DONE
                completed.add(rid)
        elif name in _RESIDENT_ONLY:
            expect(rid, name, _RUNNING)
            if name == "swap_out":
                swapped_out.add(rid)

    if not allow_open:
        for rid, st in sorted(state.items()):
            if st == _RUNNING:
                bad.append(f"rid {rid}: resident at end of trace "
                           f"(no 'complete' or terminal 'retract')")
            elif st == _QUEUED:
                bad.append(f"rid {rid}: still queued at end of trace")

    if bad:
        raise TraceInvariantError(bad)
    return {
        "requests": len(state),
        "completed": len(completed),
        "retracted_terminal": sum(
            1 for st in state.values() if st == _RETRACTED),
        "violations": 0,
    }


__all__ = ["validate_spans", "TraceInvariantError"]
