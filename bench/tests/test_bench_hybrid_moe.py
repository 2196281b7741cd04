"""The hybrid MoE cell (``bench/drivers/train_hybrid_moe.py``) at a size a
CPU test holds, against its own reference
(``bench/reference/hybrid_moe_train.py``): the reference follows the
program's plain path step by step; the control (the reference in TF32 in
the program's place) and a dropped pick come out not correct; the
readers of ``ssd_share.train``, ``moe_share.train`` and
``moe_bucket_fill.train`` on synthetic records and on a tiny traced run;
the reference imports nothing of the program."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from bench.harness import compare, manifest
from bench.tests.tiny import tiny_cell

CELL = "granite-4.0-h-small-l10.hydra-k2-4k"
SEED = 2 ** 31 + 13
READERS = ("ssd_share.train", "moe_share.train", "moe_bucket_fill.train")


def test_reference_follows_the_program():
    cell = tiny_cell(CELL)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  kernels=False))
    drv = manifest.driver(cell.traffic)
    from bench.reference import hybrid_moe_train as ref_train

    prog = drv.Program(cell.sizes, cell.traffic, 11,
                       drv.run_devices(cell.traffic, "cpu"), cell.config)
    losses = [prog.step(step) for step in range(2)]
    for k in range(cell.traffic["trials"]):
        weights, ref_losses, _ = ref_train.train_trial(
            prog.hybrid, cell.traffic, 11, k, "cpu", 2)
        for step in range(2):
            assert losses[step][k] == pytest.approx(ref_losses[step],
                                                    rel=1e-6)
        mine = prog.trial_leaves(prog.params, k)
        assert set(mine) == set(weights)
        for leaf, ref in weights.items():
            torch.testing.assert_close(mine[leaf], ref.detach(), rtol=0,
                                       atol=5e-5, msg=leaf)


def test_control_is_not_correct():
    from bench.calibrate import as_program

    cell = tiny_cell(CELL)
    drv = manifest.driver(cell.traffic)
    refs = drv.reference(cell, SEED, "cpu")
    control = as_program(drv.reference(cell, SEED, "cpu", precision="tf32"))
    found = compare.gaps(control, refs)
    assert not compare.decide(found, cell.limits), found


def test_a_dropped_pick_is_not_correct():
    """A capacity factor that leaves a bucket too small for its picks (the
    buckets hold at least top-k rows: 128 tokens route about 18 picks to
    each expert, over the 10 rows this factor leaves)."""
    cell = tiny_cell(CELL, seq=128)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  capacity_factor=0.05))
    out = manifest.driver(cell.traffic).run(
        cell, SEED, 0.0, False, time.perf_counter(), device="cpu")
    assert out["checks"]["moe_dropped_picks"]["value"] > 0
    assert not out["correct"]


def test_tiny_traced_run_carries_the_ranges_and_counters():
    cell = tiny_cell(CELL, seq=8)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  setup_steps=1))
    out = manifest.driver(cell.traffic).run(
        cell, SEED, 0.0, True, time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    prog = out["run"]["trace"]["program"]
    t, n = cell.traffic, cell.sizes.n_layers
    slots = t["trials"] * t["microbatches"]
    kinds = json.loads((manifest.BENCH / "configs"
                        / "granite-4.0-h-small-l10.json").read_text())[
        "layer_types"]
    ranges = prog["ranges"]
    assert ranges["repro.train.mixer:forward kind=mamba2"] \
        == slots * kinds.count("mamba")
    assert ranges["repro.train.mixer:forward kind=attention"] \
        == slots * kinds.count("attention")
    assert ranges["repro.train.moe:forward"] == slots * n
    counters = prog["counters"]
    assert counters["moe_dropped_picks"] == {"repro.train.moe:forward": 0}
    read = {m: manifest.reader(m).read(out["run"]) for m in READERS}
    # the CPU has no card: the device-time shares read nothing
    assert read["ssd_share.train"] is None
    assert read["moe_share.train"] is None
    rows = counters["moe_bucket_rows"]["repro.train.moe:forward"]
    picks = counters["moe_local_picks"]["repro.train.moe:forward"]
    assert read["moe_bucket_fill.train"] == pytest.approx(100 * picks / rows)


PROG = {"ranges": {"repro.train.mixer:forward kind=mamba2": 9},
        "device_s": {
            "repro.train.mixer:forward kind=mamba2": {0: 0.2},
            "repro.train.mixer:recompute kind=mamba2": {0: 0.3},
            "repro.train.mixer:forward kind=attention": {0: 0.05},
            "repro.train.moe:forward": {0: 0.1},
            "repro.train.moe:recompute": {0: 0.15},
            "recompute": {0: 0.45}},
        "counters": {"moe_local_picks": {"repro.train.moe:forward": 50},
                     "moe_bucket_rows": {"repro.train.moe:forward": 200}}}


def test_readers_read_the_program():
    run = {"trace": {"busy_s": {0: 2.0}, "program": PROG}}
    read = {m: manifest.reader(m).read(run) for m in READERS}
    assert read["ssd_share.train"] == pytest.approx(25.0)
    assert read["moe_share.train"] == pytest.approx(12.5)
    assert read["moe_bucket_fill.train"] == pytest.approx(25.0)


@pytest.mark.parametrize("run", [
    {"trace": None},  # no traced step
    {"trace": {"busy_s": {0: 1.0}}},  # a program without its ranges
    # a program without the hybrid family's ranges and counters (the
    # attention families', or a parent's)
    {"trace": {"busy_s": {0: 1.0}, "program": {
        "ranges": {"repro.train.step": 1},
        "device_s": {"repro.train.step": {0: 1.0}}, "counters": {}}}},
])
def test_readers_find_nothing(run):
    for name in READERS:
        assert manifest.reader(name).read(run) is None, name


def test_the_reference_imports_nothing_of_the_program():
    from bench.tests.test_bench_imports import FORBIDDEN, ROOT

    code = (f"import json, sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import bench.reference.hybrid_moe_train\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    found = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not found & (FORBIDDEN | {"repro_torch"})
