"""PyTorch port — the paper's 1.2M-parameter MLP workload (``mlp-1m``) and
the plain SGD it trains with, against the JAX reference on the same weights
(``params_from_numpy``) and numpy-seeded inputs, on the CPU:

* ``lm.mlp_init``'s leaves and parameter count (``MLPConfig.param_count``,
  the paper's "1.2 million");
* ``lm.mlp_forward`` / ``lm.mlp_loss`` within 1e-5, with and without a
  layer mask;
* 5 training steps of K = 2 trials (per-trial learning rates) with
  ``optim.SGD`` against the reference's ``SGD.update`` (the gradients from
  each package's own autodiff), with and without momentum: losses and
  parameters within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MLP_CONFIG as JMLP
from repro.models import lm as jlm
from repro.optim.adamw import SGD as JSGD
from repro_torch.configs import MLP_CONFIG
from repro_torch.models import lm as tlm
from repro_torch.models.lm import params_from_numpy
from repro_torch.optim import SGD
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
LR = np.asarray([0.05, 0.02], np.float32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, MLP_CONFIG.d_in)).astype(np.float32),
            rng.integers(0, MLP_CONFIG.d_out, (n,)).astype(np.int32))


def test_init_shapes_and_param_count():
    tp = tlm.mlp_init(MLP_CONFIG, torch.Generator().manual_seed(0))
    jp = jlm.mlp_init(JMLP, jax.random.PRNGKey(0))
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == MLP_CONFIG.param_count() == JMLP.param_count() == 1_195_018
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == \
        {k: {n_: tuple(v.shape) for n_, v in d.items()}
         for k, d in tp.items()}
    # weights N(0, 1/fan_in), biases 0
    assert abs(float(tp["layers"]["w"].std()) * 512 ** 0.5 - 1.0) < 0.02
    assert not tp["head"]["b"].any()


@pytest.mark.parametrize("masked", [False, True])
def test_forward_and_loss_match_reference(masked):
    jp = jlm.mlp_init(JMLP, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x, y = _data()
    mask = np.asarray([True, False, True]) if masked else None
    want = jlm.mlp_forward(jp, jnp.asarray(x),
                           None if mask is None else jnp.asarray(mask))
    got = tlm.mlp_forward(tp, torch.from_numpy(x), mask)
    assert got.shape == (16, MLP_CONFIG.d_out)
    assert _err(want, got) < 1e-5
    if not masked:
        batch = {"x": x, "y": y}
        assert _err(jlm.mlp_loss(jp, {n: jnp.asarray(v)
                                      for n, v in batch.items()}),
                    tlm.mlp_loss(tp, {n: torch.from_numpy(v)
                                      for n, v in batch.items()})) < 1e-5


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_steps_match_reference(momentum):
    """K = 2 trials (their own weights and learning rates), 5 steps each
    on its own batch."""
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    jp = jax.vmap(lambda k: jlm.mlp_init(JMLP, k))(keys)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    jopt, topt = JSGD(momentum=momentum), SGD(momentum=momentum)
    js, ts = jopt.init(jp), topt.init(tp)
    jgrad = jax.jit(jax.vmap(jax.value_and_grad(jlm.mlp_loss)))
    for step in range(5):
        xs, ys = zip(*(_data(seed=10 * step + k) for k in range(2)))
        xs, ys = np.stack(xs), np.stack(ys)
        jl, jg = jgrad(jp, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)})
        jp, js = jopt.update(jp, jg, js, {"lr": jnp.asarray(LR)}, step)
        tl = [tlm.mlp_loss({n: {m: v[k] for m, v in d.items()}
                            for n, d in tp.items()},
                           {"x": torch.from_numpy(xs[k]),
                            "y": torch.from_numpy(ys[k])})
              for k in range(2)]
        for leaf in tree_leaves(tp):
            leaf.grad = None
        sum(tl).backward()
        grads = {n: {m: v.grad for m, v in d.items()}
                 for n, d in tp.items()}
        topt.update(tp, grads, ts, {"lr": LR}, step)
        assert _err(jl, [t.item() for t in tl]) < 1e-5, step
    for n, d in tp.items():
        for m, v in d.items():
            assert _err(jp[n][m], v.detach()) < 1e-5, (n, m)
    assert int(ts["count"]) == int(js["count"]) == 5
    assert ("mom" in ts) == (momentum != 0.0)
