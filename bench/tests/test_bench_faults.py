"""A run's comparison at a size a CPU test holds: sound, it comes out
correct under the limits for that size (``tiny.TEST_LIMITS``); with the
timed path broken underneath it comes out not correct, for each fault a
training cell can have (the step leaves its state unchanged; half of each
microbatch left out, the mean taken over the rest; the activations' hop
between stages left out; the loss altered where the step produces it);
and the control — the reference in TF32 in the program's place — comes
out not correct too. The run skips only the look for cards."""
from __future__ import annotations

import time

import pytest
import torch

from bench.harness import compare, manifest
from bench.harness import traffic as T
from bench.tests.tiny import PLACED, cells, tiny_cell

SEED = 2 ** 31 + 11  # larger than 32 signed bits hold


def run(name, plant=None):
    cell = tiny_cell(name)
    return manifest.driver(cell.traffic).run(
        cell, SEED, 0.0, False, time.perf_counter(), device="cpu",
        plant=plant)


def unchanged(prog):
    object.__setattr__(prog.opt, "update",
                       lambda params, grads, state, *a, **kw: (params, state))


def half_batch(prog):
    """(The placed step takes a fixed number of rows: half the tokens.)"""
    step, placed = prog.step_fn, prog.layout is not None
    prog.step_fn = lambda p, s, b, h, i: step(
        p, s, T.half_batch(b, keep_rows=placed), h, i)


def loss_altered(prog):
    step = prog.step_fn

    def altered(*args):
        p, s, met = step(*args)
        met["loss"] = met["loss"] * (1 + 1e-3)
        return p, s, met

    prog.step_fn = altered


@pytest.mark.parametrize("name", cells())
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert out["attempted"] > tiny_cell(name).traffic["setup_steps"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, loss_altered])
@pytest.mark.parametrize("name", cells())
def test_fault_is_not_correct(name, fault):
    out = run(name, fault)
    assert not out["correct"], out["checks"]


def test_hop_left_out_is_not_correct(monkeypatch):
    """The four-card cell: every stage after the first gets zeros where
    the previous stage's activations should arrive."""
    from repro_torch.models import lm

    name = PLACED[0]
    apply = lm.stack_apply

    def no_hop(cfg, opts, layer_params, x, **kw):
        if kw.get("layer_offset", 0) > 0:
            x = torch.zeros_like(x)
        return apply(cfg, opts, layer_params, x, **kw)

    monkeypatch.setattr(lm, "stack_apply", no_hop)
    out = run(name)
    assert not out["correct"], out["checks"]
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct(name):
    """The reference in TF32 (its operands rounded to TF32 on the CPU)
    put in the program's place."""
    from bench.calibrate import as_program, reference

    cell = tiny_cell(name)
    devices = manifest.driver(cell.traffic).run_devices(cell.traffic, "cpu")
    refs = reference(cell, SEED, devices)
    control = as_program(reference(cell, SEED, devices, precision="tf32"))
    found = compare.gaps(control, refs)
    assert not compare.decide(found, cell.limits), found
