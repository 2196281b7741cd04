"""PyTorch port — the planner's cost model and the failure re-plan against
the JAX reference:

* ``layer_flops_per_token`` at seq 512, 4096 and 32768 for every registered
  arch (the hybrid's amortised shared block and the MoE router included),
  ``layer_param_bytes``, ``balance_report`` and ``StagePlan``'s
  ``real_layers_in_stage`` / ``pad_fraction`` / ``max_stage_layers`` at
  S = 1, 2, 4 and 16: each equal to the reference's;
* ``partition_costs`` on 200 seeded random cost lists at 1–8 parts: the
  same starts;
* ``replan_after_failure``: the re-formed gangs equal the reference's field
  by field on ``tests/test_scheduler.py``'s trial population and on four
  chatglm3-6b trials on the dry-run's 16×16 engine (FSDP) at seq 4096,
  when both hold a stage to the same budget and count the same bytes per
  parameter (the port's card budget and training state differ: the test
  sets them with monkeypatch, as ``test_torch_hydra.py`` does); the total
  loss raises in both;
* the reference's fault, mirrored: the re-plan keeps each gang's
  microbatch size and count and shrinks the data axis, so the global
  batch a trial trains on shrinks with it (176 → 165 rows a step in the
  16×16 case), in both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.core import partitioner as jpart
from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs as tlist
from repro_torch.core import partitioner as tpart
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched

REF_BYTES = {"param_bytes": 2, "opt_bytes_per_param": 12}


def test_registries_list_the_same_archs():
    assert tlist() == jlist()


@pytest.mark.parametrize("arch", jlist())
def test_layer_costs_match_reference(arch):
    cj, ct = jget(arch), tget(arch)
    for seq in (512, 4096, 32768):
        assert tpart.layer_flops_per_token(ct, seq) == \
            jpart.layer_flops_per_token(cj, seq)
        assert tpart._attn_flops_per_token(ct, seq) == \
            jpart._attn_flops_per_token(cj, seq)
    for nbytes in (2, 4):
        assert tpart.layer_param_bytes(ct, nbytes) == \
            jpart.layer_param_bytes(cj, nbytes)


@pytest.mark.parametrize("arch", jlist())
@pytest.mark.parametrize("n_stages", [1, 2, 4, 16])
def test_stage_plan_and_balance_match_reference(arch, n_stages):
    cj, ct = jget(arch), tget(arch)
    pj, pt = jpart.plan_stages(cj, n_stages), tpart.plan_stages(ct, n_stages)
    assert dataclasses.astuple(pt) == dataclasses.astuple(pj)
    assert [pt.real_layers_in_stage(s) for s in range(n_stages)] == \
        [pj.real_layers_in_stage(s) for s in range(n_stages)]
    assert pt.pad_fraction == pj.pad_fraction
    assert pt.max_stage_layers == pj.max_stage_layers
    for seq in (512, 4096):
        assert tpart.balance_report(ct, pt, seq) == \
            jpart.balance_report(cj, pj, seq)


def test_partition_costs_match_reference():
    rng = np.random.default_rng(20)
    for _ in range(200):
        n = int(rng.integers(1, 25))
        costs = rng.uniform(0.1, 10.0, size=n).tolist()
        if rng.random() < 0.3:  # homogeneous stacks too
            costs = [costs[0]] * n
        for parts in range(1, 9):
            assert tpart.partition_costs(costs, parts) == \
                jpart.partition_costs(costs, parts), (costs, parts)


# ---------------------------------------------------------------------------
# replan_after_failure
# ---------------------------------------------------------------------------


def _equal_budget(monkeypatch, n_stages):
    """The port's stage budget := the reference's chip budget, and the
    port's bytes per parameter := the reference's."""
    monkeypatch.setattr(tsched, "HBM_BYTES_PER_CHIP",
                        jsched.HBM_BYTES_PER_CHIP * n_stages)
    monkeypatch.setattr(tsched, "state_bytes", lambda dtype: REF_BYTES)


def _population(sched_mod, archs):
    return [sched_mod.TrialSpec(arch=arch, lr=1e-3 * (i + 1),
                                tag=f"{arch}/{i}")
            for arch, n in archs for i in range(n)]


def assert_same_gangs(gt, gj):
    assert len(gt) == len(gj)
    for t, j in zip(gt, gj):
        assert t.arch == j.arch
        assert [dataclasses.astuple(x) for x in t.trials] == \
            [dataclasses.astuple(x) for x in j.trials]
        for f in dataclasses.fields(t.engine):
            a, b = getattr(t.engine, f.name), getattr(j.engine, f.name)
            if f.name == "cache_dtype":
                a, b = str(a).split(".")[-1], jnp.dtype(b).name
            assert a == b, (f.name, a, b)
        assert t.bubble_fraction == j.bubble_fraction


def _engines(**kw):
    return jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)


SCHED_POPULATION = (("chatglm3-6b", 5), ("falcon-mamba-7b", 3),
                    ("granite-moe-3b-a800m", 2))


def test_replan_matches_reference_on_scheduler_population(monkeypatch):
    """``tests/test_scheduler.py``'s population and engine (reduced
    configs, S = 4, data 4, seq 128), two data rows lost."""
    _equal_budget(monkeypatch, 4)
    cj = {a: jget(a).reduced() for a, _ in SCHED_POPULATION}
    ct = {a: tget(a).reduced() for a, _ in SCHED_POPULATION}
    ej, et = _engines(n_trials=1, n_microbatches=1, microbatch=2,
                      n_stages=4, data_size=4)
    tj = _population(jsched, SCHED_POPULATION)
    tt = _population(tsched, SCHED_POPULATION)
    gj = jsched.plan_gangs(tj, ej, cj, 128)
    gt = tsched.plan_gangs(tt, et, ct, 128)
    assert_same_gangs(gt, gj)
    rj = jsched.replan_after_failure(gj, ej, cj, 128, lost_data_rows=2)
    rt = tsched.replan_after_failure(gt, et, ct, 128, lost_data_rows=2)
    assert_same_gangs(rt, rj)
    assert {g.engine.data_size for g in rt} == {2}


def _chatglm_16x16(monkeypatch):
    _equal_budget(monkeypatch, 16)
    cj, ct = ({"chatglm3-6b": jget("chatglm3-6b")},
              {"chatglm3-6b": tget("chatglm3-6b")})
    # the dry-run's 16×16 train_4k engine: FSDP over the data axis
    ej, et = _engines(n_trials=1, n_microbatches=16, microbatch=1,
                      n_stages=16, data_size=16, fsdp=True)
    gj = jsched.plan_gangs(_population(jsched, [("chatglm3-6b", 4)]), ej,
                           cj, 4096)
    gt = tsched.plan_gangs(_population(tsched, [("chatglm3-6b", 4)]), et,
                           ct, 4096)
    return (cj, ej, gj), (ct, et, gt)


def test_replan_matches_reference_on_16x16_chatglm(monkeypatch):
    (cj, ej, gj), (ct, et, gt) = _chatglm_16x16(monkeypatch)
    assert_same_gangs(gt, gj)
    rj = jsched.replan_after_failure(gj, ej, cj, 4096, lost_data_rows=1)
    rt = tsched.replan_after_failure(gt, et, ct, 4096, lost_data_rows=1)
    assert_same_gangs(rt, rj)


def test_replan_shrinks_the_global_batch_in_both_packages(monkeypatch):
    """The reference's docstring says the re-plan re-shards the global
    batch without re-sizing it; it re-sizes it: K and M stay, data_size
    falls, so a trial's rows a step (M · microbatch · data_size) fall."""
    for (cfgs, eng, gangs), sched_mod in zip(_chatglm_16x16(monkeypatch),
                                             (jsched, tsched)):
        before = [(g.engine.n_trials, g.engine.n_microbatches,
                   g.engine.data_size) for g in gangs]
        rows = lambda e: e.n_microbatches * e.microbatch * e.data_size
        assert before == [(2, 11, 16)] * 2
        assert {rows(g.engine) for g in gangs} == {176}
        after = sched_mod.replan_after_failure(gangs, eng, cfgs, 4096,
                                               lost_data_rows=1)
        assert [(g.engine.n_trials, g.engine.n_microbatches,
                 g.engine.data_size) for g in after] == [(2, 11, 15)] * 2
        assert {rows(g.engine) for g in after} == {165}


def test_replan_after_total_loss_raises_in_both(monkeypatch):
    _equal_budget(monkeypatch, 4)
    cj = {a: jget(a).reduced() for a, _ in SCHED_POPULATION}
    ct = {a: tget(a).reduced() for a, _ in SCHED_POPULATION}
    ej, et = _engines(n_trials=1, n_microbatches=1, microbatch=2,
                      n_stages=4, data_size=2)
    gj = jsched.plan_gangs(_population(jsched, SCHED_POPULATION), ej, cj, 128)
    gt = tsched.plan_gangs(_population(tsched, SCHED_POPULATION), et, ct, 128)
    with pytest.raises(RuntimeError, match="lost all data rows"):
        jsched.replan_after_failure(gj, ej, cj, 128, lost_data_rows=2)
    with pytest.raises(RuntimeError, match="lost all data rows"):
        tsched.replan_after_failure(gt, et, ct, 128, lost_data_rows=2)
