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

Training spans (``name`` = ``train.*``), opened by :meth:`Tracer.span`
inside ``core.pipeline.make_train_step``'s step when the step was given
an enabled tracer:

* ``train.step`` around the call, and inside it the phases in order:
  ``train.zero_grads``, ``train.batch``, ``train.forward`` (the tick
  loop), ``train.backward``, ``train.reduce_grads``, ``train.optimizer``
  (``optimizer.update``) and ``train.readback`` (the loss and grad-norm
  copies to the host);
* ``train.unit`` (fields ``t s k m dev``) around each (stage, slot)
  unit of the tick loop, and ``train.layer`` (fields ``layer`` — the
  global index — and ``dev``) around each real layer of
  ``models.lm.stack_apply`` in train mode. Both carry ``pass``:
  ``forward``, or ``recompute`` while ``train.backward`` is open, since
  remat runs a checkpointed unit or layer again inside ``backward()``:
  a unit once, each layer twice (in its unit's recompute and at its own
  checkpoint), except the last layer of a unit below the last stage,
  which PyTorch's checkpoint early stop leaves out of its unit's
  recompute;
* ``train.hop`` (fields ``src dst bytes``) around each activation
  ``.to`` between stages of the placed step.

Each span is also a ``torch.profiler.record_function`` range named
``repro.<name>[:<pass>] key=value ...``, so a profile of the step shows
the program's ranges beside the kernels they launch; readers take the
name up to the first space. Counters (:meth:`Tracer.count`) add up in
``tracer.counters[name][range]`` under the innermost span open on the
counting thread: ``hop_bytes`` (the bytes of each hop),
``host_syncs`` (each synchronising CUDA call the step makes, from
``torch.cuda.set_sync_debug_mode("warn")`` while the tracer is on; the
CPU makes none) and ``k1_backward`` (each K1 backward call that ran the
backward kernels, ``kernels/attention_bwd.py``; none on the CPU).

Timestamps: ``tick`` is the engine round (set once per round via
:meth:`begin_tick`; emission sites never thread it), ``wall`` is seconds
since ``t0_ns``, the tracer's construction or last :meth:`clear` as a
``time.time_ns()`` reading: ``t0_ns + wall`` (in ns) is on the
profiler's clock, the Unix time of its host events. Search and training
spans are wall-only (``tick`` = -1 outside an engine round).

``enabled`` is an instance attribute: a step built with a disabled
tracer emits nothing until it is switched on. Sites that run per unit or
per layer read the module's :func:`current` tracer, which the train step
sets for the length of each call (a module variable, not a
thread-local: autograd recomputes checkpointed units on its own device
threads).
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import Optional

BACKWARD = "train.backward"  # the span whose units and layers recompute
# the start of the warning ``set_sync_debug_mode("warn")`` gives
SYNC_WARNING = "called a synchronizing CUDA operation"


class _Span:
    """One open span of an enabled :class:`Tracer`: its begin and end
    events and its profiler range."""

    __slots__ = ("tracer", "name", "fields", "label", "range")

    def __init__(self, tracer, name: str, fields: dict):
        self.tracer, self.name, self.fields = tracer, name, fields
        self.label = "repro." + name + (
            ":" + fields["pass"] if fields.get("pass") else "")
        self.range = None

    def __enter__(self):
        from torch.profiler import record_function

        tr = self.tracer
        tr._open().append(self.label)
        if self.name == BACKWARD:
            tr._backward += 1
        self.range = record_function(self.label + "".join(
            f" {k}={v}" for k, v in self.fields.items() if k != "pass"))
        tr.span_begin(self.name, **self.fields)  # stamped just before ...
        self.range.__enter__()  # ... the range starts
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        self.range.__exit__(*exc)
        if self.name == BACKWARD:
            tr._backward -= 1
        tr._open().pop()
        tr.span_end(self.name, **self.fields)
        return False


class Tracer:
    """In-memory structured event recorder. See the module docstring for
    the event taxonomy; exporters live in ``obs.export``."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: list = []
        self.counters: dict = {}  # name -> {innermost open range: total}
        self.tick = -1  # current engine round; -1 = outside any round
        self.t0_ns = time.time_ns()
        self._backward = 0  # open train.backward spans
        self._threads = threading.local()  # each thread's open ranges

    # -- timestamps ----------------------------------------------------------

    def begin_tick(self, tick: int) -> None:
        """Set the engine-tick timestamp for every event until the next
        round (so per-event emission never threads the tick)."""
        self.tick = tick

    def _wall(self) -> float:
        return (time.time_ns() - self.t0_ns) / 1e9

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

    # -- training spans and counters -----------------------------------------

    def span(self, name: str, pass_: Optional[str] = None, **fields):
        """A context manager: ``span_begin`` / ``span_end`` events and a
        profiler range ``repro.<name>[:<pass_>] key=value ...`` around
        its body (nothing while the tracer is disabled)."""
        if not self.enabled:
            return NO_SPAN
        if pass_ is not None:
            fields["pass"] = pass_
        return _Span(self, name, fields)

    @property
    def train_pass(self) -> str:
        """``recompute`` while a ``train.backward`` span is open, else
        ``forward``: the pass of a unit or layer that runs now."""
        return "recompute" if self._backward else "forward"

    def _open(self) -> list:
        stack = getattr(self._threads, "open", None)
        if stack is None:
            stack = self._threads.open = []
        return stack

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to ``counters[name]`` under the innermost span open
        on this thread (``""`` outside every span)."""
        stack = self._open()
        key = stack[-1] if stack else ""
        by = self.counters.setdefault(name, {})
        by[key] = by.get(key, 0) + n

    def watch_syncs(self):
        """A context manager that counts ``host_syncs``: CUDA's sync debug
        mode set to warn (restored after), and each of its warnings
        counted under the innermost open span instead of shown. Nothing
        while the tracer is disabled; on the CPU nothing synchronises."""
        if not self.enabled:
            return NO_SPAN
        return self._watching_syncs()

    @contextlib.contextmanager
    def _watching_syncs(self):
        import torch

        cuda = torch.cuda.is_available()
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=SYNC_WARNING)
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None,
                     line=None):
                if str(message).startswith(SYNC_WARNING):
                    self.count("host_syncs")
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = show
            prev = torch.cuda.get_sync_debug_mode() if cuda else 0
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)

    # -- management ----------------------------------------------------------

    def clear(self) -> None:
        self.events = []
        self.counters = {}
        self.tick = -1
        self.t0_ns = time.time_ns()

    def __len__(self) -> int:
        return len(self.events)


class NullTracer:
    """The disabled path: ``enabled`` False, every method a no-op. Hot
    sites guard event construction with ``if tracer.enabled:`` so the only
    per-round cost when tracing is off is the attribute read + branch."""

    enabled = False
    events: list = []  # always empty; shared on purpose (never appended)
    counters: dict = {}  # likewise (never written)
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

    def span(self, name: str, pass_: Optional[str] = None, **fields):
        return NO_SPAN

    def count(self, name: str, n: int = 1) -> None:
        pass

    def watch_syncs(self):
        return NO_SPAN

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()
NO_SPAN = contextlib.nullcontext()  # the one span of a disabled tracer

_current = NULL_TRACER


def resolve(tracer: Optional[Tracer]):
    """``tracer or NULL_TRACER`` with the None-vs-disabled distinction kept
    explicit at construction sites."""
    return tracer if tracer is not None else NULL_TRACER


def current():
    """The tracer of the train step now running (:data:`NULL_TRACER`
    outside one)."""
    return _current


@contextlib.contextmanager
def using(tracer):
    """Make ``tracer`` the :func:`current` one for the body."""
    global _current
    prev, _current = _current, tracer
    try:
        yield tracer
    finally:
        _current = prev


__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "NO_SPAN", "resolve",
           "current", "using"]
