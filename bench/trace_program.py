"""The program's own spans over a cell's traced train step (not run by the
benchmark's own runs):

    python3 bench/trace_program.py --workload <name> --seed <n> \
        [--repeats 2] [--out FILE.json]

from the root of a checkout (a cell of ``BENCHMARK.json``, or the
four-card cell whose files ``bench/`` keeps). Builds the cell's program
as its driver
does (``bench/drivers/train.py``), with a ``repro_torch.obs.Tracer``
given to ``make_train_step`` and kept off, runs the traffic's set-up
steps, then ``--repeats`` times in turns with the program's spans off
and on: one step on the host clock (ended by a synchronisation of every
card), and one step under the profiler as the driver's ``--trace 1`` run
takes it (its ``bench.`` ranges, the window ``bench.window``); each
profiled step's window, busy time and count of device records are kept,
and ``spans_cost`` is the median with the spans on over the median with
them off, less 1, of the step and of the profiled window.
The last profiled step with the spans on is reduced to what a traced run reads
with the program's ranges (``bench/yardstick/spans.py``): device time by
program range, the tracer's counters, the idle gaps labelled by the
innermost ``bench.`` or ``repro.`` range (the longest with their start
and the range's fields), and the readings of
``bench/metrics/``'s ``recompute_share.train``, ``optimizer_ms.train``
and ``host_syncs_per_step.train``. Prints one JSON line (and writes it
to ``--out``).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
READERS = ("recompute_share.train", "optimizer_ms.train",
           "host_syncs_per_step.train")
N_GAPS = 10


def build(drv, cell, seed: int, tracer, device=None):
    """The driver's Program, its step built with ``tracer``."""
    from repro_torch.core import pipeline as pl

    make = pl.make_train_step
    pl.make_train_step = functools.partial(make, tracer=tracer)
    try:
        return drv.Program(cell.sizes, cell.traffic, seed,
                           drv.run_devices(cell.traffic, device))
    finally:
        pl.make_train_step = make


def timed_step(prog, step: int) -> float:
    """One step on the host clock, ended by a synchronisation."""
    prog.sync()
    t0 = time.perf_counter()
    prog.step(step)
    prog.sync()
    return time.perf_counter() - t0


def profiled_step(drv, prog, step: int):
    """One step under the profiler inside the driver's ranges; returns
    the raw records."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if prog.cards:
        acts.append(ProfilerActivity.CUDA)
    prog.sync()
    with profile(activities=acts) as prof, drv.annotated([]):
        with record_function("bench.window"):
            with record_function("bench.step"):
                prog.step(step)
            prog.sync()
    return prof.profiler.kineto_results.events()


def reduced(prog, events, counters: dict) -> dict:
    """A traced step's readings with the program's ranges."""
    from bench.harness import manifest
    from bench.yardstick import spans as Z
    from bench.yardstick import trace as Y

    rec = Y.records(events)
    lo, hi = Y.window(rec, "bench.window")
    trace = {"window_s": (hi - lo) / 1e9,
             "device_records": len(rec.device),
             "busy_s": {c: Y.busy_ns(rec, c, lo, hi) / 1e9
                        for c in prog.cards},
             "host_ops": Y.host_ops(rec, lo, hi),
             "program": Z.program(events, lo, hi, counters)}
    ranges = Z.host_ranges(rec)
    gaps = sorted(((e - s, c, s, e) for c in prog.cards
                   for s, e in Y.idle_gaps(rec, c, lo, hi)), reverse=True)
    idle = defaultdict(float)
    for d, c, s, e in gaps:
        name = Y.label_at(ranges, (s + e) // 2)
        idle[f"{Z.label(name)} cuda:{c}"] += d / 1e9
    # the longest gaps: seconds, start in the window (s), the innermost
    # range open at the middle, with its fields
    trace["idle_gaps"] = [[d / 1e9, (s - lo) / 1e9,
                           f"{Y.label_at(ranges, (s + e) // 2)} cuda:{c}"]
                          for d, c, s, e in gaps[:N_GAPS]]
    trace["idle_by_label"] = dict(sorted(idle.items(), key=lambda x: -x[1]))
    trace["readings"] = {n: manifest.reader(n).read({"trace": trace})
                         for n in READERS}
    return trace


def run(cell, seed: int, repeats: int, device=None) -> dict:
    """The measurements of the module docstring for one cell."""
    import torch

    from bench.drivers import train as drv
    from repro_torch.obs import Tracer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracer = Tracer(enabled=False)
    prog = build(drv, cell, seed, tracer, device)
    step = 0
    for step in range(cell.traffic["setup_steps"]):
        prog.step(step)
    kept = {k: {"off": [], "on": []} for k in (
        "step_s", "traced_window_s", "traced_busy_s",
        "traced_device_records")}
    host_ops = {}
    out = None
    for _ in range(repeats):
        for side in ("off", "on"):
            tracer.clear()
            tracer.enabled = side == "on"
            step += 1
            kept["step_s"][side].append(timed_step(prog, step))
            tracer.clear()
            step += 1
            events = profiled_step(drv, prog, step)
            tracer.enabled = False
            got = reduced(prog, events, tracer.counters)
            kept["traced_window_s"][side].append(got["window_s"])
            kept["traced_busy_s"][side].append(got["busy_s"])
            kept["traced_device_records"][side].append(
                got["device_records"])
            host_ops[side] = got["host_ops"]
            if side == "on":
                out = got
    kind = (torch.cuda.get_device_name(prog.cards[0]) if prog.cards
            else "cpu")
    cost = {k: statistics.median(kept[f"{k}_s"]["on"])
            / statistics.median(kept[f"{k}_s"]["off"]) - 1.0
            for k in ("step", "traced_window")}
    out["host_ops"] = host_ops
    return {"workload": cell.name, "seed": seed, "device": kind, **kept,
            "spans_cost": cost, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every build and kernel cache inside the checkout, as bench/run.py's
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    from bench.tests.tiny import real_cell

    out = run(real_cell(args.workload), args.seed, args.repeats)
    line = json.dumps(out, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
