"""PyTorch port — Hydra's training on a device layout, against the JAX
reference on a mesh of the same sizes (the 8 fake CPU devices of
``tests/conftest.py``) and against the port's own one-device step, on the
CPU with explicit device lists (``["cpu"] * n``):

* ``place_trial_params`` then ``gather_trial_params`` gives the tree back
  bit for bit, for FSDP, the pod axis, the plain (not vocab-parallel)
  head, learned positions and the hybrid family's shared block; no two
  devices share a tensor;
* every shard of the placed tree, FSDP's included, has the shape and the
  values of the matching ``addressable_shards`` entry of the reference's
  ``param_pspecs`` placement on ``make_test_mesh(2, 4)`` with ``fsdp``;
* the placed ``make_train_step`` on data 2 × model 2 and 2 × 4 layouts,
  with and without FSDP, pod 2 × data 1 × model 2, and a replicated batch,
  for reduced chatglm3-6b, granite-moe-3b-a800m (2 data shards, capacity
  factor 1.25: each device's rows route as one shard) and falcon-mamba-7b
  at 2 layers: 2 steps against JAX ``make_train_step`` on the same mesh
  at the reference's gates (losses 2e-4, parameters and grad norms 5e-3;
  the reference's norm is S times the true one, ROADMAP Queue 3) and
  against the port's one-device step at the same gates; every replica of
  a shard ends bit-equal to the others;
* ``pipeline_train_loss`` with a layout equals the one-device loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.data.pipeline import TrainBatches as JBatches
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.launch.mesh import make_device_layout
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.tree import tree_items, tree_leaves, tree_map

torch.set_num_threads(2)
HP = {"lr": np.asarray([3e-3, 1e-3], np.float32),
      "wd": np.asarray([0.0, 0.01], np.float32)}
SEQ, N_STEPS = 16, 2


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _tree_err(a, b):
    """Max abs difference of two trees of tensors / arrays (leaf order)."""
    return max(_err(np.asarray(x), y.detach().numpy() if torch.is_tensor(y)
                    else y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _layout(n_pod, n_data, n_model):
    return make_device_layout(n_data, n_model, multi_pod=n_pod > 1,
                              devices=["cpu"] * (n_pod * n_data * n_model))


def _engine(mod, n_pod, n_data, n_model, fsdp=False, replicated=False,
            vocab_parallel=True, microbatch=2):
    return mod.EngineConfig(
        n_trials=2, n_microbatches=2, microbatch=microbatch,
        n_stages=n_model, data_size=n_data, pod_size=n_pod,
        pod_axis="pod" if n_pod > 1 else None, fsdp=fsdp,
        batch_replicated=replicated, vocab_parallel=vocab_parallel)


def _one_device_engine(eng):
    """The port's one-device counterpart: every replica's rows as logical
    data shards (a replicated batch: one shard of its rows)."""
    return tpl.EngineConfig(
        n_trials=eng.n_trials, n_microbatches=eng.n_microbatches,
        microbatch=eng.microbatch, n_stages=eng.n_stages,
        data_size=1 if eng.batch_replicated else eng.dp_degree,
        vocab_parallel=eng.vocab_parallel)


def _cfgs(arch, n_layers=0):
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    if n_layers:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    return cfg_j, cfg_t


def _replicas_agree(cfg, eng, layout, placed):
    """Every device holding the same shard holds the same bits."""
    specs = tree_leaves(tpl.param_splits(cfg, eng))
    n_pod, n_data, n_st = layout.devices.shape
    for i, sp in enumerate(specs):
        seen = {}
        for p in range(n_pod):
            for d in range(n_data):
                for s in range(n_st):
                    key = (d if sp.data is not None else None,
                           s if sp.stage is not None else None)
                    leaf = tree_leaves(placed[p][d][s])[i]
                    if key in seen:
                        assert torch.equal(seen[key], leaf), (i, p, d, s)
                    seen.setdefault(key, leaf)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_pod,n_data,n_model,fsdp,vp", [
    ("chatglm3-6b", 1, 2, 4, True, True),
    ("chatglm3-6b", 2, 1, 2, False, False),
    ("zamba2-7b", 1, 2, 2, True, True),
    ("bert-large", 2, 2, 2, True, True),
])
def test_place_then_gather_is_exact(arch, n_pod, n_data, n_model, fsdp, vp):
    cfg = tget(arch).reduced()
    eng = _engine(tpl, n_pod, n_data, n_model, fsdp, vocab_parallel=vp)
    layout = _layout(n_pod, n_data, n_model)
    params = tpl.init_trial_params(
        cfg, eng, tpl.plan_stages(cfg, n_model),
        torch.Generator().manual_seed(1), max_pos=SEQ)
    placed = tpl.place_trial_params(cfg, eng, params, layout)
    back = tpl.gather_trial_params(cfg, eng, placed, layout)
    assert [n for n, _ in tree_items(back)] == \
        [n for n, _ in tree_items(params)]
    for (n, a), b in zip(tree_items(params), tree_leaves(back)):
        assert torch.equal(a, b), n
    ptrs = [t.data_ptr() for t in tree_leaves(placed)]
    assert len(set(ptrs)) == len(ptrs)  # replicas never alias
    assert all(t.data_ptr() != a.data_ptr() for t, a in
               zip(tree_leaves(back), tree_leaves(params)))
    # a restore writes a tree into every shard in place
    zero = tree_map(torch.zeros_like, placed)
    tpl.scatter_trial_params_(cfg, eng, zero, params, layout)
    for a, b in zip(tree_leaves(zero), tree_leaves(placed)):
        assert torch.equal(a, b)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n in sorted(tree)
                for k, v in _flat(tree[n], f"{prefix}{n}/").items()}
    return {prefix[:-1]: tree}


def test_shards_match_reference_pspecs_placement():
    """FSDP on make_test_mesh(2, 4): each of the port's shards is the
    reference's addressable shard on the same (data, model) device, in
    shape and values."""
    cfg_j, cfg_t = _cfgs("chatglm3-6b")
    eng_j = _engine(jpl, 1, 2, 4, fsdp=True)
    eng_t = _engine(tpl, 1, 2, 4, fsdp=True)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 4),
                                   jax.random.PRNGKey(0))
    mesh = make_test_mesh(2, 4)
    specs = _flat(jpl.param_pspecs(cfg_j, eng_j))
    flat = _flat(params)
    placed = tpl.place_trial_params(
        cfg_t, eng_t, params_from_numpy(jax.tree.map(np.asarray, params)),
        _layout(1, 2, 4))
    sharded_dims = 0
    for name, x in flat.items():
        arr = jax.device_put(x, NamedSharding(mesh, specs[name]))
        assert len(arr.addressable_shards) == 8
        for sh in arr.addressable_shards:
            (d, s), = np.argwhere(mesh.devices == sh.device)
            mine = _flat(placed[0][d][s])[name]
            assert tuple(mine.shape) == sh.data.shape, (name, d, s)
            assert np.array_equal(mine.numpy(), np.asarray(sh.data)), name
        sharded_dims += name.startswith("layers/") and "model" in str(
            specs[name]) and "data" in str(specs[name])
    assert sharded_dims >= 4  # the matrices are FSDP-split


# ---------------------------------------------------------------------------
# the placed train step
# ---------------------------------------------------------------------------

STEP_CASES = [
    # arch, n_layers (0: reduced), pod, data, model, fsdp, replicated
    ("chatglm3-6b", 0, 1, 2, 2, False, False),
    ("chatglm3-6b", 0, 1, 2, 2, True, False),
    ("chatglm3-6b", 0, 1, 2, 4, False, False),
    ("chatglm3-6b", 0, 1, 2, 4, True, False),
    ("chatglm3-6b", 0, 2, 1, 2, False, False),
    ("chatglm3-6b", 0, 1, 2, 2, True, True),
    ("granite-moe-3b-a800m", 0, 1, 2, 2, True, False),
    ("falcon-mamba-7b", 2, 1, 2, 2, True, False),
]


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_placed_train_step_matches_reference_and_one_device(case):
    arch, n_layers, n_pod, n_data, n_model, fsdp, replicated = case
    cfg_j, cfg_t = _cfgs(arch, n_layers)
    moe = {"moe_capacity_factor": 1.25} if cfg_t.moe is not None else {}
    eng_j = _engine(jpl, n_pod, n_data, n_model, fsdp, replicated)
    eng_t = _engine(tpl, n_pod, n_data, n_model, fsdp, replicated)
    layout = _layout(n_pod, n_data, n_model)
    mesh = make_test_mesh(n_data, n_model, multi_pod=n_pod > 1)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, n_model),
                                   jax.random.PRNGKey(0), max_pos=SEQ)
    data = JBatches(cfg_j, eng_j, SEQ, seed=0)
    batches = [data.batch_for_step(s) for s in range(N_STEPS)]
    data.close()
    p0 = jax.tree.map(np.array, params)  # copies: params is donated
    assert batches[0]["tokens"].shape[2] == eng_t.mb_global

    opt_j, opt_t = JAdamW(grad_clip=1.0), TAdamW(grad_clip=1.0)
    step_j = jpl.make_train_step(cfg_j, JOpts(remat=True, **moe), eng_j,
                                 mesh, opt_j)
    topts = TOpts(remat=True, **moe)
    step_t = tpl.make_train_step(cfg_t, topts, eng_t, opt_t, layout=layout)
    eng_1 = _one_device_engine(eng_t)
    step_1 = tpl.make_train_step(cfg_t, topts, eng_1, opt_t)
    pt = tpl.place_trial_params(cfg_t, eng_t, params_from_numpy(p0), layout)
    p1 = params_from_numpy(p0)
    oj, ot, o1 = opt_j.init(params), opt_t.init(pt), opt_t.init(p1)
    hp_j = {n: jnp.asarray(v) for n, v in HP.items()}
    pj = params
    for s in range(N_STEPS):
        pj, oj, mj = step_j(pj, oj, jax.tree.map(jnp.asarray, batches[s]),
                            hp_j, jnp.asarray(s, jnp.int32))
        pt, ot, mt = step_t(pt, ot, batches[s], HP, s)
        p1, o1, m1 = step_1(p1, o1, batches[s], HP, s)
        assert _err(mj["loss"], mt["loss"]) < 2e-4, (s, mj["loss"],
                                                     mt["loss"])
        assert _err(np.asarray(mj["grad_norm"]) / n_model,
                    mt["grad_norm"]) < 5e-3, (s, mj["grad_norm"],
                                              mt["grad_norm"])
        assert _err(m1["loss"], mt["loss"]) < 2e-4, s
        assert _err(m1["grad_norm"], mt["grad_norm"]) < 5e-3, s
    got = tpl.gather_trial_params(cfg_t, eng_t, pt, layout)
    assert _tree_err(jax.tree.map(np.asarray, pj), got) < 5e-3
    assert _tree_err(p1, got) < 5e-3
    moments = tpl.gather_trial_params(cfg_t, eng_t, ot["m"], layout)
    assert _tree_err(jax.tree.map(np.asarray, oj["m"]), moments) < 5e-3
    _replicas_agree(cfg_t, eng_t, layout, pt)
    assert int(ot["count"]) == int(oj["count"]) == N_STEPS


def test_placed_loss_equals_one_device_loss():
    """``pipeline_train_loss`` on a layout (FSDP, data 2 × model 2, no
    gradients) against the one-device loss on the same weights: within
    2e-5 (fp32 forward)."""
    cfg = tget("chatglm3-6b").reduced()
    eng = _engine(tpl, 1, 2, 2, fsdp=True)
    layout = _layout(1, 2, 2)
    params = tpl.init_trial_params(cfg, eng, tpl.plan_stages(cfg, 2),
                                   torch.Generator().manual_seed(2))
    batch = JBatches(jget("chatglm3-6b").reduced(),
                     _engine(jpl, 1, 2, 2, fsdp=True), SEQ,
                     seed=3).batch_for_step(0)
    with torch.no_grad():
        want, _ = tpl.pipeline_train_loss(cfg, TOpts(),
                                          _one_device_engine(eng), params,
                                          batch)
        got, aux = tpl.pipeline_train_loss(
            cfg, TOpts(), eng, tpl.place_trial_params(cfg, eng, params,
                                                      layout),
            batch, layout=layout)
    assert _err(want.numpy(), got.numpy()) < 2e-5
    assert not aux.any()


def test_layout_must_match_the_engine():
    cfg = tget("chatglm3-6b").reduced()
    eng = _engine(tpl, 1, 2, 2)
    with pytest.raises(ValueError, match="do not match"):
        tpl.make_train_step(cfg, TOpts(), eng, TAdamW(),
                            layout=_layout(1, 2, 4))
