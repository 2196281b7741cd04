"""The plain reference against the program's plain path (kernels off) at
a size a CPU test holds: each trial's losses over two steps and every
parameter after them, for each cell's family, objective and layout."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench.harness import manifest
from bench.reference import train as ref_train
from bench.tests.tiny import cells, tiny_cell

STEPS = 2
# Adam divides each entry's gradient by its own scale, so an entry whose
# gradients nearly cancel over the two steps turns rounding into up to
# ~1e-5 of movement (seen at this size); a sixth of the largest learning
# rate, and far below one lost or doubled step.
PARAM_ATOL = 5e-5


@pytest.mark.parametrize("name", cells())
def test_reference_follows_the_program(name):
    cell = tiny_cell(name, rows=2)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  kernels=False))
    drv = manifest.driver(cell.traffic)
    prog = drv.Program(cell.sizes, cell.traffic, 11,
                       drv.run_devices(cell.traffic, "cpu"))
    losses = [prog.step(step) for step in range(STEPS)]
    for k in range(cell.traffic["trials"]):
        weights, ref_losses, _ = ref_train.train_trial(
            cell.sizes, cell.traffic, 11, k, prog.devices, "cpu", STEPS)
        for step in range(STEPS):
            assert losses[step][k] == pytest.approx(ref_losses[step],
                                                    rel=1e-6)
        mine = prog.trial_leaves(prog.params, k)
        assert set(mine) == set(weights)
        for leaf, ref in weights.items():
            torch.testing.assert_close(mine[leaf], ref.detach(), rtol=0,
                                       atol=PARAM_ATOL, msg=leaf)
