"""One run of one benchmark cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
are found by name (``bench/harness/manifest.py``); the traffic's driver
runs the program (``repro_torch``, from ``src/``) on the cell's cards and
returns its metrics and its comparison with the reference.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``timings`` (set-up's parts, the window and the
reference's check, in seconds), and last ``checks``: each compared number
with its limit, which also end standard error. Nothing is printed and the
exit code is
not 0 when CUDA is missing, when fewer cards exist than the cell asks
for, when the run fails, or when a module named ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package) was loaded.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """``time.perf_counter()`` at the moment the process started (from
    /proc, to 10 ms), or at this module's import where /proc is absent."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return STARTED


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int) -> int:
    print(f"bench/run.py: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    origin = process_start()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    import torch
    from bench.harness import manifest

    cell = manifest.cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        return fail("CUDA is not available", 2)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible", 2)
    driver = manifest.driver(cell.traffic, ROOT)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     origin)
    found = loaded_forbidden()
    if found:
        return fail("modules of JAX or the JAX package were loaded: "
                    + ", ".join(found), 3)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = manifest.reader(m["name"], ROOT).read(out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["timings"] = out["timings"]
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                        for n, c in out["checks"].items()}
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r} "
              f"(worst: {c['where']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
