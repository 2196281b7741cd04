"""Structured tracing: typed events with engine-tick + wall timestamps.

Two implementations share one interface:

* :class:`Tracer` — records events in memory for the exporters
  (``obs.export``: JSONL + Chrome trace-event/Perfetto) and the span
  validator (``obs.validate``).
* :class:`NullTracer` — the module-level :data:`NULL_TRACER` singleton the
  engine holds when tracing is off. Every method is a no-op and
  ``enabled`` is False, so hot emission sites guard with
  ``if tracer.enabled:`` and pay one attribute read + branch per *site*
  (not per event) — no kwargs dict is ever built on the disabled path.

Event taxonomy (the ``ev`` field):

Per-request lifecycle (all carry ``rid``):
  ``enqueue`` → ``admit`` (cell ``k,m,b``; ``prefix_hit`` rides alongside
  when admission matched cached blocks) → ``prefill_chunk``* →
  ``first_token`` → [``retract`` (``via`` = swap|recompute) →
  ``swap_out`` → ``restore``]* → [``spec_propose`` → ``spec_verify`` →
  ``rollback``]* → ``complete``.

Per-round engine records: ``round`` — call-mode mix, mixed-wave fill,
pool blocks in use, per-partition host-tier depth, transfer in-flight
peak, per-arch queue depths, slot occupancy.

Subsystem instants: ``prefix_spill`` / ``prefix_evict`` /
``host_evict`` (tiered store + radix cache), ``compile`` (first sight of
a (mode, token shape, table bucket) pipeline-program signature).

Search spans: ``span_begin`` / ``span_end`` (``name`` = gang | rung)
with wall timestamps — the successive-halving timeline of ``core.hydra``.

Timestamps: ``tick`` is the engine round (set once per round via
:meth:`begin_tick`; emission sites never thread it), ``wall`` is seconds
since the tracer was constructed. Search spans are wall-only
(``tick`` = -1 outside an engine round).
"""
from __future__ import annotations

import time
from typing import Optional


class Tracer:
    """In-memory structured event recorder. See the module docstring for
    the event taxonomy; exporters live in ``obs.export``."""

    enabled = True

    def __init__(self):
        self.events: list = []
        self.tick = -1  # current engine round; -1 = outside any round
        self._t0 = time.monotonic()

    # -- timestamps ----------------------------------------------------------

    def begin_tick(self, tick: int) -> None:
        """Set the engine-tick timestamp for every event until the next
        round (so per-event emission never threads the tick)."""
        self.tick = tick

    def _wall(self) -> float:
        return time.monotonic() - self._t0

    # -- emission ------------------------------------------------------------

    def emit(self, ev: str, **fields) -> None:
        fields["ev"] = ev
        fields["tick"] = self.tick
        fields["wall"] = round(self._wall(), 6)
        self.events.append(fields)

    def req(self, ev: str, rid: int, **fields) -> None:
        """Per-request lifecycle event."""
        self.emit(ev, rid=rid, **fields)

    def round(self, **fields) -> None:
        """Per-round engine record (one per engine tick while tracing)."""
        self.emit("round", **fields)

    def compile(self, mode: str, **fields) -> None:
        """First sight of a pipeline-program shape signature — each one is
        an XLA compile the serving timeline should show."""
        self.emit("compile", mode=mode, **fields)

    def span_begin(self, name: str, **fields) -> None:
        self.emit("span_begin", name=name, **fields)

    def span_end(self, name: str, **fields) -> None:
        self.emit("span_end", name=name, **fields)

    # -- management ----------------------------------------------------------

    def clear(self) -> None:
        self.events = []
        self.tick = -1
        self._t0 = time.monotonic()

    def __len__(self) -> int:
        return len(self.events)


class NullTracer:
    """The disabled path: ``enabled`` False, every method a no-op. Hot
    sites guard event construction with ``if tracer.enabled:`` so the only
    per-round cost when tracing is off is the attribute read + branch."""

    enabled = False
    events: list = []  # always empty; shared on purpose (never appended)
    tick = -1

    def begin_tick(self, tick: int) -> None:
        pass

    def emit(self, ev: str, **fields) -> None:
        pass

    def req(self, ev: str, rid: int, **fields) -> None:
        pass

    def round(self, **fields) -> None:
        pass

    def compile(self, mode: str, **fields) -> None:
        pass

    def span_begin(self, name: str, **fields) -> None:
        pass

    def span_end(self, name: str, **fields) -> None:
        pass

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()


def resolve(tracer: Optional[Tracer]):
    """``tracer or NULL_TRACER`` with the None-vs-disabled distinction kept
    explicit at construction sites."""
    return tracer if tracer is not None else NULL_TRACER


__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "resolve"]
