"""Trace exporters: JSONL event logs and Chrome trace-event/Perfetto JSON.

JSONL is the lossless interchange format — one event dict per line,
``read_events`` round-trips ``write_events`` exactly, and the span
validator (``obs.validate``) consumes either the in-memory list or a
reloaded file interchangeably.

The Perfetto export renders the engine timeline the way the paper argues
about utilization — as tracks you can see idle gaps on:

* **serve cells** (pid 1) — one track per (k, m, b) slot cell. A request's
  residency is a duration slice from its ``admit``/``restore`` round to its
  ``complete``/``retract`` round, named ``req <rid>``; ``prefill_chunk``
  slices nest inside it; ``first_token`` / ``retract`` / ``restore`` /
  ``rollback`` are instant markers on the cell's track.
* **pool** (pid 2) — counter tracks: device blocks in use, per-partition
  host-tier depth, transfer in-flight peak; ``prefix_spill`` /
  ``prefix_evict`` / ``host_evict`` instants.
* **queues** (pid 3) — one per-arch queue-depth counter track, with
  ``enqueue`` instants.
* **compile** (pid 4) — one instant per first-seen pipeline-program shape
  signature (mode × token width × table bucket).
* **search** (pid 5) — ``span_begin``/``span_end`` pairs (hydra gangs and
  successive-halving rungs) as wall-clock duration slices.
* **train** (pid 6, only when the events hold ``train.*`` spans) — the
  train step's spans as wall-clock slices: the step and its phases on a
  ``step`` track, and one track per card (the span's ``dev``, a hop's
  ``dst``) for the (stage, slot) units and layers, named with their pass
  (``train.layer:recompute``), and the placed step's hops.

Engine events are timestamped in *ticks* (1 tick rendered as
``TICK_US`` µs — the deterministic scheduling unit); search spans are
wall-clock. Perfetto displays both; cross-domain alignment is not
meaningful and not implied.
"""
from __future__ import annotations

import json

TICK_US = 1000  # one engine round rendered as 1ms of trace time

_PID_CELLS, _PID_POOL, _PID_QUEUES, _PID_COMPILE, _PID_SEARCH = 1, 2, 3, 4, 5
_PID_TRAIN = 6

# per-request instant markers rendered on the owning cell's track
_CELL_INSTANTS = ("first_token", "retract", "restore", "rollback",
                  "spec_verify", "prefix_hit")
_POOL_INSTANTS = ("prefix_spill", "prefix_evict", "host_evict")


def write_events(events, path: str) -> int:
    """One JSON object per line; returns the number of events written."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True))
            f.write("\n")
    return len(events)


def read_events(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_metrics(snapshot: dict, path: str) -> int:
    """Flatten a ``MetricRegistry.snapshot()`` (or any flat dict) to JSONL:
    one ``{"metric": name, "value"/"hist": ...}`` record per line."""
    n = 0
    with open(path, "w") as f:
        for name in sorted(snapshot):
            v = snapshot[name]
            rec = ({"metric": name, "hist": v} if isinstance(v, dict)
                   else {"metric": name, "value": v})
            f.write(json.dumps(rec, sort_keys=True))
            f.write("\n")
            n += 1
    return n


# -- Chrome trace-event / Perfetto ------------------------------------------


def _meta(pid, name, tid=None):
    if tid is None:
        return {"ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": name}}
    return {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": name}}


def _counter(pid, ts, name, value):
    return {"ph": "C", "pid": pid, "tid": 0, "ts": ts, "name": name,
            "args": {name: value}}


def _instant(pid, tid, ts, name, args):
    return {"ph": "i", "pid": pid, "tid": tid, "ts": ts, "s": "t",
            "name": name, "args": args}


def _slice(pid, tid, ts, dur, name, args):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "name": name, "args": args}


def _args(ev, drop=("ev", "tick", "wall", "rid", "k", "m", "b")):
    return {k: v for k, v in ev.items() if k not in drop and v is not None}


def to_chrome_trace(events) -> dict:
    """Build the Chrome trace-event JSON object (``{"traceEvents": [...]}``)
    from a tracer's event list. Open request residencies (a truncated
    trace) are closed at the last seen tick."""
    out = []
    cell_tids: dict = {}  # (k, m, b) -> tid
    open_res: dict = {}  # rid -> (cell, start_tick, kind)
    span_stack: dict = {}  # name -> [start events]
    train_stack: dict = {}  # (name, track) -> [start events]
    train_tids: dict = {}  # track -> tid
    last_tick = 0
    out.append(_meta(_PID_CELLS, "serve cells"))
    out.append(_meta(_PID_POOL, "pool"))
    out.append(_meta(_PID_QUEUES, "queues"))
    out.append(_meta(_PID_COMPILE, "compile"))
    out.append(_meta(_PID_SEARCH, "search"))

    def cell_tid(ev):
        key = (ev.get("k", 0), ev.get("m", 0), ev.get("b", 0))
        tid = cell_tids.get(key)
        if tid is None:
            tid = cell_tids[key] = len(cell_tids) + 1
            out.append(_meta(_PID_CELLS,
                             f"cell k{key[0]} m{key[1]} b{key[2]}", tid))
        return tid

    def train_track(ev):
        track = ev.get("dev") or ev.get("dst") or "step"
        tid = train_tids.get(track)
        if tid is None:
            if not train_tids:
                out.append(_meta(_PID_TRAIN, "train"))
            tid = train_tids[track] = len(train_tids)
            out.append(_meta(_PID_TRAIN, track, tid))
        return track, tid

    def close_residency(rid, end_tick, how):
        cell, start, kind = open_res.pop(rid)
        tid = cell_tids[cell]
        dur = max(end_tick - start, 1) * TICK_US
        out.append(_slice(_PID_CELLS, tid, start * TICK_US, dur,
                          f"req {rid}", {"rid": rid, "closed_by": how,
                                         "admitted_via": kind}))

    for ev in events:
        name = ev["ev"]
        tick = ev.get("tick", -1)
        if tick is not None and tick >= 0:
            last_tick = max(last_tick, tick)
        ts = max(tick, 0) * TICK_US
        if name in ("admit", "restore"):
            tid = cell_tid(ev)
            rid = ev["rid"]
            if rid in open_res:  # malformed but renderable: close first
                close_residency(rid, tick, "reopen")
            open_res[rid] = ((ev.get("k", 0), ev.get("m", 0),
                              ev.get("b", 0)), max(tick, 0), name)
            out.append(_instant(_PID_CELLS, tid, ts, name, _args(ev)))
        elif name in ("complete", "retract"):
            rid = ev["rid"]
            if rid in open_res:
                tid = cell_tids[open_res[rid][0]]
                out.append(_instant(_PID_CELLS, tid, ts, name, _args(ev)))
                close_residency(rid, max(tick, 0), name)
        elif name == "prefill_chunk":
            out.append(_slice(_PID_CELLS, cell_tid(ev), ts, TICK_US,
                              f"prefill q{ev.get('qlen', '?')}", _args(ev)))
        elif name in _CELL_INSTANTS:
            rid = ev.get("rid")
            if rid in open_res:
                tid = cell_tids[open_res[rid][0]]
            elif any(c in ev for c in ("k", "m", "b")):
                tid = cell_tid(ev)
            else:
                tid = 0
            out.append(_instant(_PID_CELLS, tid, ts, name, _args(ev)))
        elif name == "round":
            if "pool_blocks" in ev:
                out.append(_counter(_PID_POOL, ts, "device blocks in use",
                                    ev["pool_blocks"]))
            for i, depth in enumerate(ev.get("host_depth") or ()):
                out.append(_counter(_PID_POOL, ts, f"host tier p{i}", depth))
            if "inflight" in ev:
                out.append(_counter(_PID_POOL, ts, "transfer in-flight",
                                    ev["inflight"]))
            for i, depth in enumerate(ev.get("queues") or ()):
                out.append(_counter(_PID_QUEUES, ts, f"arch {i} queue",
                                    depth))
            if "occupied" in ev:
                out.append(_counter(_PID_CELLS, ts, "occupied cells",
                                    ev["occupied"]))
        elif name == "enqueue":
            out.append(_instant(_PID_QUEUES, ev.get("arch", 0), ts,
                                f"enqueue {ev['rid']}", _args(ev)))
        elif name in _POOL_INSTANTS:
            out.append(_instant(_PID_POOL, 0, ts, name, _args(ev)))
        elif name == "compile":
            out.append(_instant(_PID_COMPILE, 0,
                                int(ev.get("wall", 0.0) * 1e6),
                                f"compile {ev.get('mode', '?')}", _args(ev)))
        elif name in ("span_begin", "span_end") and str(
                ev.get("name", "")).startswith("train."):
            track, tid = train_track(ev)
            stack = train_stack.setdefault((ev["name"], track), [])
            if name == "span_begin":
                stack.append(ev)
            elif stack:
                start = stack.pop()
                ts0 = int(start.get("wall", 0.0) * 1e6)
                dur = max(int(ev.get("wall", 0.0) * 1e6) - ts0, 1)
                label = start["name"] + (f":{start['pass']}"
                                         if start.get("pass") else "")
                out.append(_slice(_PID_TRAIN, tid, ts0, dur, label,
                                  _args(start, drop=("ev", "tick", "wall",
                                                     "name", "pass"))))
        elif name == "span_begin":
            span_stack.setdefault(ev.get("name", "span"), []).append(ev)
        elif name == "span_end":
            stack = span_stack.get(ev.get("name", "span"))
            if stack:
                start = stack.pop()
                ts0 = int(start.get("wall", 0.0) * 1e6)
                dur = max(int(ev.get("wall", 0.0) * 1e6) - ts0, 1)
                label = start.get("name", "span")
                detail = start.get("label") or start.get("arch")
                if detail is not None:
                    label = f"{label} {detail}"
                out.append(_slice(_PID_SEARCH, len(stack), ts0, dur, label,
                                  _args(start, drop=("ev", "tick", "wall"))))
    for rid in sorted(open_res):  # truncated trace: close at last tick
        close_residency(rid, last_tick + 1, "open")
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_perfetto(events, path: str) -> int:
    """Write the Chrome trace-event JSON (Perfetto-loadable) for a tracer's
    events; returns the number of trace records."""
    trace = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return len(trace["traceEvents"])


__all__ = ["TICK_US", "write_events", "read_events", "write_metrics",
           "to_chrome_trace", "write_perfetto"]
