"""Cells at a size a CPU test run holds: each benchmark cell's family,
objective and layout, with narrow widths, a small vocabulary and short
rows."""
from __future__ import annotations

import dataclasses
import json

from bench.harness import manifest
from bench.harness.sizes import sizes_of

WIDTHS = {"d_model": 64, "n_heads": 4, "head_dim": 16, "d_ff": 128,
          "vocab_size": 96}
# The comparison's limits at this size. The cells' own limits were set
# from readings at their real sizes on the card; here the program reads
# up to 1.7e-7 / 3.5e-6 / 6.6e-6 (loss / grad / change gaps over the three
# cells and two seeds, on this CPU) and the control (the reference with
# its products' operands rounded to TF32) at least 1.4e-5 / 1.2e-4 /
# 3.0e-4, so these sit about ten times above the one and below the other.
TEST_LIMITS = {"loss_gap": 2e-6, "grad_gap": 3e-5, "change_gap": 5e-5}


# The four-card cell's files: measured, and not yet a cell of
# BENCHMARK.json (PERF.md, Open questions); the tests keep its placed path.
PLACED = ("chatglm3-6b.hydra-k2-4chip", "chatglm3-6b", "hydra-k2-4chip", 4)


def real_cell(name: str) -> manifest.Cell:
    if name == PLACED[0]:
        return manifest.cell_of(
            name, manifest.BENCH / "configs" / f"{PLACED[1]}.json",
            PLACED[2], PLACED[3], manifest.manifest())
    return manifest.cell(name)


def tiny_cell(name: str, seq: int = 16, rows: int = None,
              limits: dict = None) -> manifest.Cell:
    """Cell ``name`` (of BENCHMARK.json, or :data:`PLACED`) at test size,
    with :data:`TEST_LIMITS` unless ``limits`` is given."""
    real = real_cell(name)
    kv = 2 if real.sizes.n_kv_heads < real.sizes.n_heads else 4
    sizes = dataclasses.replace(
        real.sizes, n_kv_heads=kv, max_positions=seq if
        real.sizes.max_positions else 0, **WIDTHS)
    traffic = dict(real.traffic, seq=seq)
    if rows is not None:
        traffic["rows"] = rows
    if traffic["objective"] == "mlm":
        traffic["mask_id"] = 3
    return dataclasses.replace(real, sizes=sizes, traffic=traffic,
                               limits=limits or TEST_LIMITS)


def cells() -> list:
    """BENCHMARK.json's cells and the four-card cell."""
    return [w["name"] for w in manifest.manifest()["workloads"]] \
        + [PLACED[0]]


def config_sizes(name: str):
    """The sizes of ``bench/configs/<name>.json``."""
    return sizes_of(json.loads(
        (manifest.BENCH / "configs" / f"{name}.json").read_text()))
