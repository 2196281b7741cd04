"""The readings a hybrid MoE cell's limits are set from (not run by the
benchmark's own runs), as ``bench/calibrate.py`` takes them for the
attention families, against the cell driver's reference
(``bench/reference/hybrid_moe_train.py``):

    python3 bench/calibrate_hybrid_moe.py --workload <name> \
        --seeds 1 2 ... [--control-seeds 1 2 3] [--out FILE.jsonl]

from the root of a checkout. For every seed the program's gaps to the
fp32 reference; for each control seed the gaps of the reference in TF32
(the control) and on the first half of each microbatch (the
``half_batch`` fault). Prints one JSON line per seed and reading, and the
largest program gaps and the smallest control and fault gaps last.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = (("control_tf32", {"precision": "tf32"}),
         ("fault_half_batch", {"fault": "half_batch"}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.calibrate import as_program, program_readings
    from bench.harness import compare, manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.cell(args.workload, ROOT)
    drv = manifest.driver(cell.traffic, ROOT)
    device = drv.run_devices(cell.traffic)[0]
    worst, least = {n: 0.0 for n in compare.NAMES}, {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in sorted(set(args.seeds) | set(args.control_seeds)):
            kinds = []
            if seed in args.seeds:
                kinds.append(("program", program_readings(drv, cell,
                                                          seed)[0]))
            refs = drv.reference(cell, seed, device)
            if seed in args.control_seeds:
                kinds += [(kind, as_program(drv.reference(cell, seed,
                                                          device, **kw)))
                          for kind, kw in KINDS]
            for kind, readings in kinds:
                found = compare.gaps(readings, refs)
                line = json.dumps({
                    "cell": cell.name, "seed": seed, "kind": kind,
                    "gaps": {n: found[n][0] for n in compare.NAMES},
                    "where": {n: found[n][1] for n in compare.NAMES}})
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
                for n in compare.NAMES:
                    if kind == "program":
                        worst[n] = max(worst[n], found[n][0])
                    else:
                        key = f"{kind}.{n}"
                        least[key] = min(least.get(key, math.inf),
                                         found[n][0])
    finally:
        if out is not None:
            out.close()
    print(json.dumps({"cell": cell.name, "lower": worst,
                      "control_and_faults": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
