"""PyTorch port — Hydra training of the ssm family (reduced
falcon-mamba-7b) against the JAX reference on the same weights
(``params_from_numpy``) and the same batches (``TrainBatches``,
bit-identical in both packages):

* ``make_train_step``, K = 2 trials, S = 2 stages, 2 data shards, 2 steps
  of AdamW with clipping, with the chunked scan and with
  ``use_mamba_kernel`` (the reference's Pallas kernel in interpret mode;
  the port's plain sequential version on the CPU, whose backward is
  autograd of the plain scan, as the reference's ``_mamba_bwd``):
  per-step losses and grad norms within 1e-5 (JAX's norm divided by S,
  ROADMAP Queue 3), final parameters within 5e-4, each trial's change
  within 10 % of the reference's;
* ``layers.kernel_options`` turns K3 on for the ssm family (and the flash
  kernel for attention), the train launcher builds its options with it,
  and ``launch.train --arch falcon-mamba-7b --smoke`` runs the kernel
  branch on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.data.pipeline import TrainBatches as JBatches
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as launcher
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.layers import kernel_options
from repro_torch.models.lm import params_from_numpy
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
ARCH = "falcon-mamba-7b"
HP = {"lr": np.asarray([3e-3, 1e-3], np.float32),
      "wd": np.asarray([0.0, 0.01], np.float32)}
SEQ, N_STEPS, S = 16, 2, 2


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("kernel", [False, True])
def test_train_step_matches_reference(kernel, monkeypatch):
    cfg_j, cfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    kw = dict(n_trials=2, n_microbatches=2, microbatch=1, n_stages=S,
              data_size=2)
    eng_j, eng = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, S),
                                   jax.random.PRNGKey(0), max_pos=SEQ)
    data = JBatches(cfg_j, eng_j, SEQ, seed=0)
    batches = [data.batch_for_step(s) for s in range(N_STEPS)]
    data.close()
    p0 = jax.tree.map(np.array, params)  # copies: params is donated
    pt = params_from_numpy(p0)
    opt_j, opt_t = JAdamW(grad_clip=1.0), TAdamW(grad_clip=1.0)
    step_j = jpl.make_train_step(
        cfg_j, JOpts(remat=True, use_mamba_kernel=kernel), eng_j,
        make_test_mesh(2, S), opt_j)
    step_t = tpl.make_train_step(
        cfg, TOpts(remat=True, use_mamba_kernel=kernel), eng, opt_t)
    scans = []
    real = tops.mamba_scan
    monkeypatch.setattr(tops, "mamba_scan",
                        lambda *a: scans.append(1) or real(*a))
    launches = tms.launches
    oj, ot = opt_j.init(params), opt_t.init(pt)
    hp_j = {n: jnp.asarray(v) for n, v in HP.items()}
    pj = params
    for s in range(N_STEPS):
        pj, oj, mj = step_j(pj, oj, jax.tree.map(jnp.asarray, batches[s]),
                            hp_j, jnp.asarray(s, jnp.int32))
        pt, ot, mt = step_t(pt, ot, batches[s], HP, s)
        assert _err(mj["loss"], mt["loss"]) < 1e-5, (s, mj["loss"],
                                                     mt["loss"])
        assert _err(np.asarray(mj["grad_norm"]) / S, mt["grad_norm"]) \
            < 1e-5, s
    # the kernel branch took every scan (its plain version: CPU tensors)
    assert bool(scans) == kernel and tms.launches == launches
    pj = jax.tree.map(np.asarray, pj)
    leaves = list(zip(tree_leaves(p0), tree_leaves(pj), tree_leaves(pt)))
    assert max(_err(a, b.detach()) for _, a, b in leaves) < 5e-4
    for k in range(2):  # each trial's change, relative to the reference's
        change = (max(_err(a[k], b[k].detach()) for _, a, b in leaves)
                  / max(_err(a[k], x[k]) for x, a, _ in leaves))
        assert change < 0.1, (k, change)


def test_launcher_turns_kernels_on_by_family(monkeypatch, capsys):
    want = {"chatglm3-6b": (True, False), "falcon-mamba-7b": (False, True),
            "zamba2-7b": (True, False)}
    for arch, (flash, mamba) in want.items():
        opts = kernel_options(tget(arch), remat=True)
        assert (opts.use_flash_kernel, opts.use_mamba_kernel, opts.remat) \
            == (flash, mamba, True), arch
    made = []
    real_opts = launcher.kernel_options
    monkeypatch.setattr(launcher, "kernel_options",
                        lambda *a, **kw: made.append(real_opts(*a, **kw))
                        or made[-1])
    scans = []
    real = tops.mamba_scan
    monkeypatch.setattr(tops, "mamba_scan",
                        lambda *a: scans.append(1) or real(*a))
    launcher.main(["--arch", ARCH, "--smoke", "--trials", "2", "--steps",
                   "2", "--n-model", "2", "--n-microbatches", "2",
                   "--seq-len", "16", "--device", "cpu"])
    assert '"best_trial"' in capsys.readouterr().out
    assert [(o.use_mamba_kernel, o.remat) for o in made] == [(True, True)]
    assert scans  # the train path went through the kernel branch
