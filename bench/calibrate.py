"""The readings a cell's limits are set from (not run by the benchmark's
own runs):

    python3 bench/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--skip-faults] [--out FILE.jsonl]

For every seed, in one process: the program's set-up steps and readings
(as a run's set-up makes them), the program freed, and the fp32
reference of every trial; the gaps between them are the program's
readings. For each control seed the fp32 reference (the program's
readings only if it is among ``--seeds``) and two stand-ins put in the
program's place against it: the reference in TF32 (the control) and the
reference on the first half of each microbatch alone (the ``half_batch``
fault). Prints one JSON line per seed and reading, and the
largest program gaps and smallest control and fault gaps last.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def as_program(refs: list) -> dict:
    """Per-trial reference readings in the program's form."""
    k = range(len(refs))
    return {"loss": [[refs[i]["loss"][s] for i in k]
                     for s in range(len(refs[0]["loss"]))],
            "grad": {n: [refs[i]["grad"][n] for i in k]
                     for n in refs[0]["grad"]},
            "change": {n: [refs[i]["change"][n] for i in k]
                       for n in refs[0]["change"]}}


def program_readings(drv, cell, seed: int, device=None) -> dict:
    import torch

    prog = drv.Program(cell.sizes, cell.traffic, seed,
                       drv.run_devices(cell.traffic, device))
    losses, grad = [], None
    for step in range(cell.traffic["setup_steps"]):
        losses.append([float(x) for x in prog.step(step)])
        if step == 0:
            b1 = cell.traffic["betas"][0]
            grad = {n: [v / (1 - b1) for v in vs]
                    for n, vs in prog.leaf_norms(prog.state["m"]).items()}
    change = prog.leaf_norms(prog.params, start=True)
    devices = prog.devices
    del prog
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad, "change": change}, devices


def reference(cell, seed: int, devices, **kw) -> list:
    from bench.reference import train as ref_train

    return [ref_train.run_trial(cell.sizes, cell.traffic, seed, k, devices,
                                devices[0], cell.traffic["setup_steps"],
                                **kw)
            for k in range(cell.traffic["trials"])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--skip-faults", action="store_true",
                    help="read the control alone on the control seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.harness import compare, manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.cell(args.workload, ROOT)
    drv = manifest.driver(cell.traffic, ROOT)
    out = open(args.out, "a") if args.out else None
    worst = {n: 0.0 for n in compare.NAMES}
    least = {}

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    devices = drv.run_devices(cell.traffic)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        if seed in args.seeds:
            prog, devices = program_readings(drv, cell, seed)
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        refs = reference(cell, seed, devices)
        t_ref = time.perf_counter() - t
        kinds = [("program", prog)] if seed in args.seeds else []
        if seed in args.control_seeds:
            kinds.append(("control_tf32", as_program(
                reference(cell, seed, devices, precision="tf32"))))
            if not args.skip_faults:
                kinds.append(("fault_half_batch", as_program(
                    reference(cell, seed, devices, fault="half_batch"))))
        for kind, readings in kinds:
            found = compare.gaps(readings, refs)
            emit({"cell": cell.name, "seed": seed, "kind": kind,
                  "gaps": {n: found[n][0] for n in compare.NAMES},
                  "where": {n: found[n][1] for n in compare.NAMES},
                  "left_out": compare.left_out(refs),
                  "program_s": t_prog, "reference_s": t_ref})
            for n in compare.NAMES:
                if kind == "program":
                    worst[n] = max(worst[n], found[n][0])
                else:
                    key = f"{kind}.{n}"
                    least[key] = min(least.get(key, float("inf")),
                                     found[n][0])
    emit({"cell": cell.name, "lower": worst, "control_and_faults": least})
    return 0


if __name__ == "__main__":
    sys.exit(main())
