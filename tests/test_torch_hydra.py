"""PyTorch port — the Hydra layer against the JAX reference:

* the planner: ``per_chip_bytes``, ``max_concurrent_trials`` and
  ``plan_gangs`` equal to the reference's when both hold a stage to the
  same budget and count the same bytes per parameter (the port's budget
  is the card's 80 GB × 0.9 split over the S stages that share it, and
  its training state is 16 bytes per fp32 parameter where the reference
  counts 2 + 12; the test sets the reference's budget and the port's
  bytes per parameter to match, with monkeypatch, never in the files);
  the port's own count of its training state;
* ``core.trials``: the copy gives the same trial streams and selection;
* checkpoints: a checkpoint the JAX package wrote (fp32, bf16 and int32
  leaves, the runner's (params, opt_state) layout) restores into the
  port onto the template's device and dtype, and one the port wrote
  restores into the reference, with the same manifest;
* ``run_with_restarts``: an injected host failure resumes from the last
  checkpoint and ends bit-equal to an uninterrupted run; a device fault
  is never retried; a failure before the first checkpoint cannot rewind
  in-place state and re-raises;
* ``run_model_selection`` on the reduced config (2 stages, 2 data shards,
  3 trials, 3 steps) from the reference's initial weights: the same best
  trial, validation losses within 2e-4 (the pipeline exactness tolerance
  for losses), train losses within 2e-4;
* ``launch/train.py --device cpu --smoke`` runs to its JSON line.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.core import hydra as jhydra
from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro.core import trials as jtrials
from repro.core.partitioner import plan_stages as jplan
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.core import hydra as thydra
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched
from repro_torch.core import trials as ttrials
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.launch import train as ttrain
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.runtime import fault_tolerance as tft

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # n_layers (0 = published), n_stages, microbatch, seq, n_trials
    (4, 2, 1, 2048, 2),     # the card's training configuration
    (4, 2, 1, 2048, 5),
    (0, 4, 2, 4096, 3),
    (8, 1, 1, 512, 4),
    (2, 2, 4, 8192, 6),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_planner_matches_reference_at_equal_budget(case, monkeypatch):
    n_layers, s, mb, seq, n = PLAN_CASES[case]
    cfg_j, cfg_t = jget("chatglm3-6b"), tget("chatglm3-6b")
    if n_layers:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    kw = dict(n_trials=1, n_microbatches=4, microbatch=mb, n_stages=s)
    eng_j, eng_t = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    # the reference's per-chip budget := the port's per-stage budget, and
    # the port's bytes per parameter := the reference's
    monkeypatch.setattr(jsched, "HBM_BYTES_PER_CHIP",
                        tsched.HBM_BYTES_PER_CHIP / s)
    ref_bytes = {"param_bytes": 2, "opt_bytes_per_param": 12}
    monkeypatch.setattr(tsched, "state_bytes", lambda dtype: ref_bytes)
    assert jsched.HBM_BYTES_PER_CHIP * jsched.HBM_BUDGET_FRACTION \
        == pytest.approx(tsched.stage_budget(eng_t))
    for train in (True, False):
        assert (dataclasses.astuple(
            jsched.per_chip_bytes(cfg_j, eng_j, seq, train))
            == dataclasses.astuple(
                tsched.per_chip_bytes(cfg_t, eng_t, seq, train,
                                      **ref_bytes)))
        assert (jsched.max_concurrent_trials(cfg_j, eng_j, seq, train)
                == tsched.max_concurrent_trials(cfg_t, eng_t, seq, train))
    trials_j = jtrials.grid_search(cfg_j.name, [3e-3 * 0.5 ** i
                                                for i in range(n)])
    trials_t = ttrials.grid_search(cfg_t.name, [3e-3 * 0.5 ** i
                                                for i in range(n)])
    gj = jsched.plan_gangs(trials_j, eng_j, {cfg_j.name: cfg_j}, seq)
    gt = tsched.plan_gangs(trials_t, eng_t, {cfg_t.name: cfg_t}, seq)
    assert [(g.arch, [t.tag for t in g.trials], g.engine.n_trials,
             g.engine.n_microbatches, g.bubble_fraction) for g in gj] == \
        [(g.arch, [t.tag for t in g.trials], g.engine.n_trials,
          g.engine.n_microbatches, g.bubble_fraction) for g in gt]


@pytest.mark.parametrize("dtype,per_param", [(torch.float32, 16),
                                             (torch.bfloat16, 12)])
def test_state_bytes_count_the_ports_training_state(dtype, per_param):
    """Parameters, the gradient buffer (both in the parameter dtype) and
    fp32 m and v, as ``make_train_step`` and ``AdamW`` allocate them."""
    cfg = dataclasses.replace(tget("chatglm3-6b"), n_layers=4)
    eng = tpl.EngineConfig(n_trials=1, n_microbatches=4, microbatch=1,
                           n_stages=2)
    est = tsched.per_chip_bytes(cfg, eng, 2048, True,
                                **tsched.state_bytes(dtype))
    n_local = 2 * cfg.layer_param_count() + cfg.vocab_size * cfg.d_model \
        + cfg.d_model  # 2 layers a stage, half of embed + head, final norm
    assert est.params_bytes == n_local * dtype.itemsize
    assert est.params_bytes + est.opt_bytes == n_local * per_param


def test_card_plan_puts_both_trials_in_one_gang():
    """Full-width chatglm3-6b cut to 4 layers, S = 2, seq 2048: both trials
    fit one gang on the card, at M = 5 (bubble target 0.10)."""
    cfg = dataclasses.replace(tget("chatglm3-6b"), n_layers=4)
    eng = tpl.EngineConfig(n_trials=2, n_microbatches=4, microbatch=1,
                           n_stages=2)
    gangs = tsched.plan_gangs(ttrials.grid_search(cfg.name, [3e-3, 1.5e-3]),
                              eng, {cfg.name: cfg}, 2048)
    assert [(g.engine.n_trials, g.engine.n_microbatches)
            for g in gangs] == [(2, 5)]
    assert gangs[0].bubble_fraction <= 0.10


# ---------------------------------------------------------------------------
# trials
# ---------------------------------------------------------------------------


def test_trials_copy_matches_reference():
    assert jtrials.grid_search("a", [1e-3, 3e-4], [0.0, 0.1], [0, 1]) == \
        [jsched.TrialSpec(**dataclasses.asdict(t))
         for t in ttrials.grid_search("a", [1e-3, 3e-4], [0.0, 0.1], [0, 1])]
    rj, rt = jtrials.random_search("a", 7, seed=3), \
        ttrials.random_search("a", 7, seed=3)
    assert [dataclasses.asdict(t) for t in rj] == \
        [dataclasses.asdict(t) for t in rt]

    def fake(mod):
        def train(specs, n_steps):
            return [mod.TrialResult(s, n_steps,
                                    train_loss=abs(s.lr - 1e-3) + 1 / n_steps,
                                    val_loss=abs(s.lr - 1e-3) + 1 / n_steps)
                    for s in specs]
        return train

    specs = [1e-2, 3e-3, 1e-3, 3e-4]
    bj = jtrials.SuccessiveHalving(10, 2, 3).run(
        jtrials.grid_search("a", specs), fake(jtrials))
    bt = ttrials.SuccessiveHalving(10, 2, 3).run(
        ttrials.grid_search("a", specs), fake(ttrials))
    assert (bj.spec.lr, bj.steps, bj.val_loss) == \
        (bt.spec.lr, bt.steps, bt.val_loss)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(rng):
    params = {"embed": {"tok": rng.normal(size=(2, 8, 4))},
              "layers": {"w": rng.normal(size=(2, 3, 4, 4)),
                         "ln": rng.normal(size=(2, 3, 4))},
              "head": rng.normal(size=(2, 4, 8))}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    opt = {"m": jax.tree.map(np.zeros_like, params),
           "v": jax.tree.map(np.ones_like, params),
           "count": np.asarray(3, np.int32)}
    return params, opt


def test_checkpoint_written_by_reference_restores_into_port(tmp_path):
    params, opt = _state(np.random.default_rng(0))
    jtree = (jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt))
    jtree[0]["layers"]["ln"] = jtree[0]["layers"]["ln"].astype(jnp.bfloat16)
    jckpt.save(str(tmp_path), 7, jtree, extra={"step": 7})
    template = (params_from_numpy(params), {
        "m": params_from_numpy(opt["m"]), "v": params_from_numpy(opt["v"]),
        "count": torch.zeros((), dtype=torch.int32)})
    template[0]["layers"]["ln"] = template[0]["layers"]["ln"].bfloat16()
    template[0]["head"] = template[0]["head"].double()  # template's dtype
    assert tckpt.latest_step(str(tmp_path)) == 7
    got = tckpt.restore(str(tmp_path), 7, template)
    assert isinstance(got, tuple) and got[1]["count"].dtype == torch.int32
    assert int(got[1]["count"]) == 3
    assert got[0]["layers"]["ln"].dtype == torch.bfloat16
    assert got[0]["head"].dtype == torch.float64
    want_ln = np.asarray(jtree[0]["layers"]["ln"].astype(jnp.float32))
    np.testing.assert_array_equal(got[0]["layers"]["ln"].float().numpy(),
                                  want_ln)
    np.testing.assert_array_equal(got[0]["layers"]["w"].numpy(),
                                  params["layers"]["w"])
    np.testing.assert_array_equal(got[1]["v"]["embed"]["tok"].numpy(),
                                  opt["v"]["embed"]["tok"])
    # and back: the port's checkpoint restores into the reference
    tckpt.save(str(tmp_path / "port"), 8, got, extra={"step": 8})
    assert tckpt.manifest(str(tmp_path / "port"), 8)["leaves"] == \
        jckpt.manifest(str(tmp_path), 7)["leaves"]
    back = jckpt.restore(str(tmp_path / "port"), 8, jtree)
    np.testing.assert_array_equal(
        np.asarray(back[0]["layers"]["ln"]).astype(np.float32), want_ln)
    np.testing.assert_array_equal(back[0]["embed"]["tok"],
                                  params["embed"]["tok"])


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The saved values are those at save() time, although the caller
    overwrites the tensors in place right after (as the train step does)."""
    state = {"p": torch.arange(6, dtype=torch.float32)}
    saver = tckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(1, state)
    state["p"].add_(100.0)  # the next step, in place
    saver.wait()
    got = tckpt.restore(str(tmp_path), 1, state)
    np.testing.assert_array_equal(got["p"].numpy(), np.arange(6))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


def _step(state, step):
    """In-place update whose result depends on every earlier step."""
    state["x"].mul_(1.5).add_(step)
    state["n"] += 1
    return state, {"x": float(state["x"].sum())}


def _init():
    return {"x": torch.ones(4), "n": torch.zeros((), dtype=torch.int64)}


def test_run_with_restarts_resumes_exactly(tmp_path):
    clean = tft.run_with_restarts(_step, _init(),
                                  tft.LoopConfig(n_steps=7))
    fired = []

    def inject(step):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("injected host failure")

    rep = tft.run_with_restarts(
        _step, _init(), tft.LoopConfig(n_steps=7, checkpoint_every=2,
                                       ckpt_dir=str(tmp_path)),
        failure_injector=inject)
    assert fired == [5] and rep.restarts == 1
    assert torch.equal(rep.final_state["x"], clean.final_state["x"])
    assert int(rep.final_state["n"]) == 7  # steps 4 and 5 replayed from 4
    again = tft.run_with_restarts(
        _step, _init(), tft.LoopConfig(n_steps=7, checkpoint_every=2,
                                       ckpt_dir=str(tmp_path)))
    assert again.resumed_from == 7 and again.steps_run == 0
    assert torch.equal(again.final_state["x"], clean.final_state["x"])


def test_device_fault_is_never_retried(tmp_path):
    calls = []

    def step(state, s):
        calls.append(s)
        raise KernelLaunchError("flash_attention launch failed: CUDA error 9")

    with pytest.raises(KernelLaunchError):
        tft.run_with_restarts(step, _init(), tft.LoopConfig(
            n_steps=3, checkpoint_every=1, ckpt_dir=str(tmp_path)))
    assert calls == [0]


def test_failure_before_first_checkpoint_cannot_rewind(tmp_path):
    def inject(step):
        if step == 2:
            raise RuntimeError("injected")

    with pytest.raises(RuntimeError, match="injected"):
        tft.run_with_restarts(_step, _init(), tft.LoopConfig(
            n_steps=4, checkpoint_every=10, ckpt_dir=str(tmp_path)),
            failure_injector=inject)


# ---------------------------------------------------------------------------
# run_model_selection
# ---------------------------------------------------------------------------


def test_run_model_selection_matches_reference(monkeypatch):
    cfg_j, cfg_t = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    kw = dict(n_trials=1, n_microbatches=2, microbatch=1, n_stages=2,
              data_size=2)
    base_j, base_t = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    lrs = [3e-3, 1e-3, 3e-4]
    hc_j = jhydra.HydraConfig(seq_len=16, steps=3)
    hc_t = thydra.HydraConfig(seq_len=16, steps=3)

    def jax_init(cfg, eng, plan, gen, dtype, device, max_pos=0):
        """The reference runner's initial weights (PRNGKey(seed)), carried
        across: the two frameworks' generators differ."""
        je = jpl.EngineConfig(n_trials=eng.n_trials,
                              n_microbatches=eng.n_microbatches,
                              microbatch=eng.microbatch,
                              n_stages=eng.n_stages,
                              data_size=eng.data_size)
        p = jpl.init_trial_params(cfg_j, je, jplan(cfg_j, eng.n_stages),
                                  jax.random.PRNGKey(hc_t.seed),
                                  max_pos=max_pos)
        return params_from_numpy(jax.tree.map(np.asarray, p), device, dtype)

    monkeypatch.setattr(thydra.pl, "init_trial_params", jax_init)
    out_j = jhydra.run_model_selection(
        cfg_j, JOpts(remat=True), make_test_mesh(2, 2), hc_j,
        jtrials.grid_search(cfg_j.name, lrs), base_j)
    out_t = thydra.run_model_selection(
        cfg_t, TOpts(remat=True), hc_t, ttrials.grid_search(cfg_t.name, lrs),
        base_t, device="cpu")
    assert out_j["best"].spec.tag == out_t["best"].spec.tag
    assert [r.spec.tag for r in out_j["all"]] == \
        [r.spec.tag for r in out_t["all"]]
    for rj, rt in zip(out_j["all"], out_t["all"]):
        assert abs(rj.val_loss - rt.val_loss) < 2e-4, (rj, rt)
        assert abs(rj.train_loss - rt.train_loss) < 2e-4, (rj, rt)


def test_train_launcher_runs_on_cpu(capsys):
    ttrain.main(["--arch", "chatglm3-6b", "--smoke", "--trials", "2",
                 "--steps", "2", "--n-data", "2", "--n-model", "2",
                 "--n-microbatches", "2", "--seq-len", "16",
                 "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and len(out["results"]) == 2
    assert out["best_trial"] in {r["tag"] for r in out["results"]}
    assert all(np.isfinite(r["val_loss"]) for r in out["results"])
