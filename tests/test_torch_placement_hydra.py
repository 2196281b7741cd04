"""PyTorch port — the Hydra layer and the launcher on a device layout
(explicit ``["cpu"] * n`` device lists), on the CPU:

* ``run_model_selection`` on a data 2 × model 2 FSDP layout equals the
  one-device run from the same seed: the same best trial, train and
  validation losses within 2e-4;
* checkpoints hold the gathered one-device tree: one written under the
  layout restores on one device (bit for bit) and the one-device loop
  resumes from it, and one written on one device restores under the
  layout, where the placed loop resumes from it; each resumed run ends
  within the exactness gates (losses 2e-4, parameters 5e-3) of an
  uninterrupted one-device run;
* ``launch/train.py --smoke --n-data 2 --n-model 2 --fsdp --devices
  cpu,cpu,cpu,cpu`` prints each trial's train and validation loss within
  2e-4 of the JAX launcher's on the same flags (the reference's initial
  weights carried across, as in ``test_torch_hydra.py``), and names its
  layout;
* ``make_device_layout`` raises when asked for CUDA devices that do not
  exist (this torch has none), and so does the launcher's ``--fsdp``
  without a device list.
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.launch import train as jtrain
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.core import hydra as thydra
from repro_torch.core import pipeline as tpl
from repro_torch.core import trials as ttrials
from repro_torch.data.pipeline import TrainBatches
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_device_layout
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
SEQ = 16
CPU4 = ["cpu"] * 4


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _engines(fsdp=True):
    kw = dict(n_trials=2, n_microbatches=2, microbatch=1, n_stages=2,
              data_size=2)
    return tpl.EngineConfig(**kw, fsdp=fsdp), tpl.EngineConfig(**kw)


def test_run_model_selection_on_a_layout_equals_one_device():
    cfg = tget("chatglm3-6b").reduced()
    placed_eng, one_eng = _engines()
    hc = thydra.HydraConfig(seq_len=SEQ, steps=3)
    trials = ttrials.grid_search(cfg.name, [3e-3, 1e-3, 3e-4])
    layout = make_device_layout(2, 2, devices=CPU4)
    out_l = thydra.run_model_selection(cfg, TOpts(remat=True), hc, trials,
                                       placed_eng, layout=layout)
    out_1 = thydra.run_model_selection(cfg, TOpts(remat=True), hc, trials,
                                       one_eng, device="cpu")
    assert out_l["best"].spec.tag == out_1["best"].spec.tag
    assert [r.spec.tag for r in out_l["all"]] == \
        [r.spec.tag for r in out_1["all"]]
    for rl, r1 in zip(out_l["all"], out_1["all"]):
        assert abs(rl.val_loss - r1.val_loss) < 2e-4, (rl, r1)
        assert abs(rl.train_loss - r1.train_loss) < 2e-4, (rl, r1)
    with pytest.raises(ValueError, match="not both"):
        thydra.HydraRunner(cfg, TOpts(), hc, device="cpu", layout=layout)


class _Gang:
    """One gang's one-device and placed training loops from the same
    weights and batches."""

    def __init__(self):
        self.cfg = tget("chatglm3-6b").reduced()
        self.placed_eng, self.one_eng = _engines()
        self.layout = make_device_layout(2, 2, devices=CPU4)
        self.params = tpl.init_trial_params(
            self.cfg, self.one_eng, tpl.plan_stages(self.cfg, 2),
            torch.Generator().manual_seed(5))
        self.opt = AdamW(grad_clip=1.0)
        data = TrainBatches(self.cfg, self.one_eng, SEQ, seed=0)
        self.batches = [data.batch_for_step(i) for i in range(3)]
        data.close()
        self.hp = {"lr": [3e-3, 1e-3], "wd": [0.0, 0.01]}

    def one_device_state(self):
        p = tree_map(torch.clone, self.params)
        return p, self.opt.init(p)

    def placed_state(self):
        p = tpl.place_trial_params(self.cfg, self.placed_eng, self.params,
                                   self.layout)
        return p, self.opt.init(p)

    def loop(self, placed, state, n_steps, ckpt_dir):
        eng = self.placed_eng if placed else self.one_eng
        step = tpl.make_train_step(self.cfg, TOpts(remat=True), eng,
                                   self.opt,
                                   layout=self.layout if placed else None)

        def one(st, i):
            p, o, m = step(*st, self.batches[i], self.hp, i)
            return (p, o), m

        codec = (thydra.placed_state_codec(self.cfg, eng, self.layout)
                 if placed else None)
        return tft.run_with_restarts(
            one, state, tft.LoopConfig(n_steps=n_steps, checkpoint_every=1,
                                       ckpt_dir=str(ckpt_dir)), codec=codec)

    def gathered(self, state):
        return tpl.gather_trial_params(self.cfg, self.placed_eng, state[0],
                                       self.layout)


@pytest.mark.parametrize("writer_placed", [True, False],
                         ids=["layout-to-one-device", "one-device-to-layout"])
def test_checkpoints_cross_between_layout_and_one_device(tmp_path,
                                                         writer_placed):
    g = _Gang()
    want = g.loop(False, g.one_device_state(), 3, tmp_path / "straight")
    first = g.loop(writer_placed, g.placed_state() if writer_placed
                   else g.one_device_state(), 2, tmp_path / "ck")
    if writer_placed:  # the checkpoint holds the gathered tree
        p, o = first.final_state
        saved = tckpt.restore(str(tmp_path / "ck"), 2,
                              g.one_device_state())
        for a, b in zip(tree_leaves(saved[0]), tree_leaves(g.gathered(
                first.final_state))):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(saved[1]["v"]), tree_leaves(
                tpl.gather_trial_params(g.cfg, g.placed_eng, o["v"],
                                        g.layout))):
            assert torch.equal(a, b)
    # the other form resumes from step 2 and runs step 3
    resumed = g.loop(not writer_placed, g.one_device_state() if writer_placed
                     else g.placed_state(), 3, tmp_path / "ck")
    assert resumed.resumed_from == 2 and resumed.steps_run == 1
    assert _err(want.step_metrics[-1]["loss"],
                resumed.step_metrics[-1]["loss"]) < 2e-4
    got = resumed.final_state if writer_placed else \
        (g.gathered(resumed.final_state),)
    assert max(_err(a.numpy(), b.numpy()) for a, b in zip(
        tree_leaves(want.final_state[0]), tree_leaves(got[0]))) < 5e-3
    assert int(resumed.final_state[1]["count"]) == 3


def test_launcher_matches_the_jax_launcher(monkeypatch, capsys):
    cfg_j = jget("chatglm3-6b").reduced()

    def jax_init(cfg, eng, plan, gen, dtype, device, max_pos=0):
        """The reference runner's initial weights (PRNGKey(0)), carried
        across: the two frameworks' generators differ."""
        je = jpl.EngineConfig(n_trials=eng.n_trials,
                              n_microbatches=eng.n_microbatches,
                              microbatch=eng.microbatch,
                              n_stages=eng.n_stages,
                              data_size=eng.data_size)
        p = jpl.init_trial_params(cfg_j, je, jplan(cfg_j, eng.n_stages),
                                  jax.random.PRNGKey(0), max_pos=max_pos)
        return params_from_numpy(jax.tree.map(np.asarray, p), device, dtype)

    flags = ["--arch", "chatglm3-6b", "--smoke", "--trials", "2", "--steps",
             "2", "--n-data", "2", "--n-model", "2", "--fsdp",
             "--n-microbatches", "2", "--seq-len", str(SEQ)]
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    jtrain.main()
    want = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(thydra.pl, "init_trial_params", jax_init)
    ttrain.main(flags + ["--devices", ",".join(CPU4)])
    got = json.loads(capsys.readouterr().out)
    assert got["layout"] == {"axes": {"data": 2, "model": 2},
                             "devices": [[["cpu", "cpu"], ["cpu", "cpu"]]]}
    assert got["best_trial"] == want["best_trial"]
    for rj, rt in zip(want["results"], got["results"]):
        assert rj["tag"] == rt["tag"]
        assert abs(rj["train_loss"] - rt["train_loss"]) < 2e-4, (rj, rt)
        assert abs(rj["val_loss"] - rt["val_loss"]) < 2e-4, (rj, rt)


def test_layouts_never_fall_back_to_fewer_devices():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        make_device_layout(2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_device_layout(1, 2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="takes 8 devices"):
        make_device_layout(2, 2, multi_pod=True, devices=CPU4)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        ttrain.main(["--smoke", "--n-data", "2", "--n-model", "2",
                     "--fsdp"])
    layout = make_device_layout(1, 2, multi_pod=True, devices=CPU4)
    assert layout.devices.shape == (2, 1, 2)
    assert layout.axis_sizes == {"pod": 2, "data": 1, "model": 2}
