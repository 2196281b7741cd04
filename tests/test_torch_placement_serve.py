"""PyTorch port — Hydra's serving on a device layout, against the JAX
reference on a mesh of the same sizes (the 8 fake CPU devices of
``tests/conftest.py``) and against the port's own one-device engine, on
the CPU with explicit device lists (``["cpu"] * n``):

* ``place_serve_cache`` then ``gather_serve_cache`` gives the cache tree
  back bit for bit — the paged pool (data 2, pod 2 × data 2, a replicated
  batch), dense strips and the hybrid family's shared sites — and
  ``serve_cache_struct(..., layout=)`` allocates the placed shapes;
* after one append call, every shard of the placed cache has the shape
  and the values of the matching ``addressable_shards`` entry of the
  reference's cache under ``serve_cache_pspecs`` on ``make_test_mesh(2,
  2)``: written entries within 2e-5, unwritten ones bit-equal;
* the placed ``ServeEngine`` on data 2 × model 2 (with and without FSDP),
  pod 2 × data 1 × model 2 and a replicated batch, with the prefix cache,
  the host tier and overcommit 1.5 (retraction), fused admission, gang
  speculation, granite-moe-3b-a800m at 2 layers (each device's rows route
  as one shard), and the dense engine for falcon-mamba-7b and zamba2-7b
  at 2 layers (slot reset on each device): per-request tokens,
  ``ttft_ticks``, ``finished_tick``, every counter and the allocator's
  free lists equal the JAX engine's on the same mesh and the port's
  one-device engine's; ``static_serve`` likewise;
* the transfer kernels round-trip a written block bit for bit through the
  host on a placed pool;
* ``rebuild_layout`` follows the reference's ``rebuild_mesh`` device for
  device, with and without a pod axis, and a placed train step on the
  rebuilt layout (a gathered tree re-placed on it) equals the JAX step on
  the rebuilt mesh;
* the launcher's ``--devices`` runs every request to the one-device
  run's tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from test_prefix_cache import shared_prefix_trace
from test_retract import bursty_trace
from test_spec_decode import spec_trace
from test_torch_placement import HP, SEQ, _err, _tree_err
from test_torch_prefix_cache import to_port
from test_torch_retract import spill_trace
from test_torch_serve_engine import (MAX_SEQ, assert_parity, staggered)

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.data.pipeline import TrainBatches as JBatches
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro.optim.adamw import AdamW as JAdamW
from repro.runtime import elastic as jel
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import static_serve as jstatic
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import make_device_layout
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.runtime import elastic as tel
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import static_serve as tstatic
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)


def _layout(n_pod, n_data, n_model=2):
    return make_device_layout(n_data, n_model, multi_pod=n_pod > 1,
                              devices=["cpu"] * (n_pod * n_data * n_model))


def _cfgs(arch, n_layers=0):
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    if n_layers:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    return cfg_j, cfg_t


def _engines(n_pod=1, n_data=2, fsdp=False, replicated=False, paged=True,
             n_trials=1, n_blocks=24, prefill_chunks=2):
    """The JAX engine config, the port's placed one (the same sizes) and
    the port's one-device counterpart (every replica's rows as logical
    data shards; a replicated batch: one shard of its rows)."""
    mb = 2 if replicated else 2 // (n_pod * n_data)
    kw = dict(n_trials=n_trials, n_microbatches=2, microbatch=mb,
              n_stages=2, max_seq=MAX_SEQ, prefill_chunks=prefill_chunks,
              paged=paged, block_size=4, n_blocks=n_blocks if paged else 0)
    lay = dict(data_size=n_data, pod_size=n_pod,
               pod_axis="pod" if n_pod > 1 else None, fsdp=fsdp,
               batch_replicated=replicated)
    one = dict(data_size=1 if replicated else n_pod * n_data)
    return (jpl.EngineConfig(cache_dtype=jnp.float32, **kw, **lay),
            tpl.EngineConfig(cache_dtype=torch.float32, **kw, **lay),
            tpl.EngineConfig(cache_dtype=torch.float32, **kw, **one))


def _mesh(eng_j):
    return make_test_mesh(eng_j.data_size, eng_j.n_stages,
                          multi_pod=eng_j.pod_size > 1)


def _params(cfg_j, eng_j, mirror=False):
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=MAX_SEQ)
    if mirror:  # row 0's weights on both rows: a perfect drafter
        params = jax.tree.map(lambda x: jnp.concatenate([x[:1], x[:1]]),
                              params)
    return params


def _random_cache(cfg, eng, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tpl._map_cache(lambda x: torch.randn(x.shape, generator=gen)
                          .to(x.dtype), tpl.serve_cache_struct(cfg, eng))


# ---------------------------------------------------------------------------
# the placed cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,paged,n_pod,n_data,replicated", [
    ("chatglm3-6b", True, 1, 2, False),
    ("chatglm3-6b", True, 2, 2, False),
    ("chatglm3-6b", True, 1, 2, True),
    ("falcon-mamba-7b", False, 1, 2, False),
    ("zamba2-7b", False, 2, 1, False),
])
def test_place_then_gather_serve_cache_is_exact(arch, paged, n_pod, n_data,
                                                replicated):
    cfg = tget(arch).reduced()
    eng = tpl.EngineConfig(
        n_trials=2, n_microbatches=2, microbatch=2, n_stages=2,
        data_size=n_data, pod_size=n_pod, batch_replicated=replicated,
        max_seq=16, paged=paged, block_size=4, n_blocks=16 if paged else 0,
        cache_dtype=torch.float32)
    layout = _layout(n_pod, n_data)
    cache = _random_cache(cfg, eng)
    placed = tpl.place_serve_cache(cfg, eng, cache, layout)
    back = tpl.gather_serve_cache(cfg, eng, placed, layout)
    for a, b in zip(tree_leaves(cache), tree_leaves(back)):
        assert a is None and b is None or a is not b and torch.equal(a, b)
    assert (cache["shared"] is None) == (arch != "zamba2-7b")
    empty = tpl.serve_cache_struct(cfg, eng, layout=layout)
    n_parts = 1 if replicated else n_pod * n_data
    for p in range(n_pod):
        for d in range(n_data):
            for s in range(2):
                for a, b in zip(tree_leaves(placed[p][d][s]),
                                tree_leaves(empty[p][d][s])):
                    assert a is None and b is None or \
                        a.shape == b.shape and not b.any()
                lead = placed[p][d][s]["layers"]["k" if paged else
                                                 next(iter(cache["layers"]))]
                full = cache["layers"]["k" if paged else
                                       next(iter(cache["layers"]))]
                st, sh = (1, 2) if paged else (2, 3)
                assert lead.shape[st] == full.shape[st] // 2
                assert lead.shape[sh] == full.shape[sh] // n_parts
    ptrs = [t.data_ptr() for t in tree_leaves(placed) if t is not None]
    assert len(set(ptrs)) == len(ptrs)  # replicas never alias


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n in sorted(tree) if tree[n] is not None
                for k, v in _flat(tree[n], f"{prefix}{n}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch,paged", [("chatglm3-6b", True),
                                        ("falcon-mamba-7b", False)])
def test_placed_shards_match_reference_after_an_append(arch, paged):
    """One append call (two rows a shard, ragged depths) from a zero cache
    on data 2 × model 2: each placed shard is the reference's addressable
    shard on the same (data, model) device."""
    cfg_j, cfg_t = _cfgs(arch, 2)
    eng_j, eng_t, _ = _engines(paged=paged, prefill_chunks=1)
    eng_j = dataclasses.replace(eng_j, microbatch=2, n_microbatches=1)
    eng_t = dataclasses.replace(eng_t, microbatch=2, n_microbatches=1)
    layout, mesh = _layout(1, 2), _mesh(eng_j)
    params = _params(cfg_j, eng_j)
    rng = np.random.default_rng(0)
    qlen = 6
    batch = {"tokens": rng.integers(0, cfg_t.vocab_size, (1, 1, 4, qlen))
             .astype(np.int32),
             "positions": np.asarray([[[0, 3, 0, 5]]], np.int32),
             "active": np.asarray([[[True, True, False, True]]])}
    if paged:  # shard-local ids: rows 0-1 in shard 0, rows 2-3 in shard 1
        batch["block_tables"] = np.asarray(
            [[[[0, 1, 2, -1, -1, -1], [3, 4, 5, -1, -1, -1],
               [0, 1, -1, -1, -1, -1], [6, 7, 8, -1, -1, -1]]]], np.int32)
    step_j = jpl.make_serve_step(cfg_j, JOpts(), eng_j, mesh, "append",
                                 with_active=True)
    cache_j, tok_j, _ = step_j(params, jpl.serve_cache_struct(
        cfg_j, eng_j, dry_run=False), jax.tree.map(jnp.asarray, batch))
    step_t = tpl.make_serve_step(cfg_t, TOpts(), eng_t, "append",
                                 layout=layout)
    placed = tpl.place_trial_params(
        cfg_t, eng_t, params_from_numpy(jax.tree.map(np.asarray, params)),
        layout)
    cache_t = tpl.serve_cache_struct(cfg_t, eng_t, layout=layout)
    _, tok_t, _ = step_t(placed, cache_t,
                         {n: torch.from_numpy(v) for n, v in batch.items()})
    assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
    n_sharded = 0
    for name, leaf in _flat(cache_j).items():
        assert len(leaf.addressable_shards) == 4
        for sh in leaf.addressable_shards:
            (d, s), = np.argwhere(mesh.devices == sh.device)
            mine = _flat(cache_t[0][d][s])[name].numpy()
            want = np.asarray(sh.data)
            assert mine.shape == want.shape, (name, d, s)
            written = want != 0
            assert np.array_equal(mine[~written], want[~written]), name
            assert _err(mine[written], want[written]) < 2e-5, name
            n_sharded += bool(written.any())
    assert n_sharded >= 4  # every device holds written entries


# ---------------------------------------------------------------------------
# the placed engine
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    # name: (arch, n_layers, _engines kwargs, engine kwargs, trace, extra)
    "data2": ("chatglm3-6b", 0, {}, {}, "staggered", {}),
    "data2_fsdp": ("chatglm3-6b", 0, dict(fsdp=True), {}, "staggered", {}),
    "pod2": ("chatglm3-6b", 0, dict(n_pod=2, n_data=1), {}, "staggered", {}),
    "replicated": ("chatglm3-6b", 0, dict(replicated=True), {},
                   "staggered", {}),
    "prefix_host_retract": (
        "chatglm3-6b", 0, dict(n_blocks=12),
        dict(prefix_cache=True, host_blocks=16, overcommit=1.5), "bursty",
        {}),
    "prefix_spill": ("chatglm3-6b", 0, dict(n_blocks=12),
                     dict(prefix_cache=True, host_blocks=16), "spill", {}),
    "prefix_fused": ("chatglm3-6b", 0, dict(n_blocks=40),
                     dict(prefix_cache=True, fused=True), "prefix", {}),
    "spec": ("chatglm3-6b", 0, dict(n_trials=2, n_blocks=40),
             dict(spec_gamma=3), "spec", dict(mirror=True)),
    "granite": ("granite-moe-3b-a800m", 2, dict(fsdp=True), {}, "staggered",
                dict(moe=1.25)),
    "falcon_dense": ("falcon-mamba-7b", 2, dict(paged=False), {},
                     "staggered", {}),
    "zamba2_dense": ("zamba2-7b", 2, dict(paged=False, n_pod=2, n_data=1),
                     {}, "staggered", {}),
}


def _trace(name, vocab):
    if name == "staggered":
        return staggered(JRequest, vocab)
    if name == "bursty":
        return bursty_trace(vocab)
    if name == "spill":  # long enough for a hit on a spilled node
        return spill_trace(vocab, n=10)
    if name == "prefix":
        return shared_prefix_trace(vocab)
    return spec_trace(vocab)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_placed_engine_matches_reference_and_one_device(case):
    arch, n_layers, ekw, kw, trace, extra = ENGINE_CASES[case]
    cfg_j, cfg_t = _cfgs(arch, n_layers)
    eng_j, eng_t, eng_1 = _engines(**ekw)
    layout = _layout(eng_t.pod_size, eng_t.data_size)
    params = _params(cfg_j, eng_j, extra.get("mirror", False))
    paged = eng_t.paged
    moe = ({"moe_capacity_factor": extra["moe"]} if "moe" in extra else {})
    kernels = dict(use_paged_kernel=paged,
                   use_mamba_kernel=cfg_t.family == "ssm")
    reqs = _trace(trace, cfg_t.vocab_size)
    jeng = JEngine(cfg_j, eng_j, _mesh(eng_j), params,
                   JOpts(use_paged_kernel=paged, **moe), **kw)
    jcomp = jeng.run([r.clone() for r in reqs], max_ticks=2000)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    topts = TOpts(**kernels, **moe)
    one = TEngine(cfg_t, eng_1, tparams, topts, device="cpu", **kw)
    ocomp = one.run(to_port(reqs), max_ticks=2000)
    teng = TEngine(cfg_t, eng_t,
                   tpl.place_trial_params(cfg_t, eng_t, tparams, layout),
                   topts, layout=layout, **kw)
    resets = []
    if not paged:
        reset_fn = teng.reset_fn
        teng.reset_fn = lambda c, m: resets.append(np.asarray(m).sum()) \
            or reset_fn(c, m)
    tcomp = teng.run(to_port(reqs), max_ticks=2000)
    assert_parity(teng, jeng, tcomp, jcomp)
    assert_parity(teng, one, tcomp, ocomp)
    assert teng.device == layout.root
    assert isinstance(teng.cache, list) and len(teng.cache) == \
        eng_t.pod_size
    if paged:
        assert teng.allocator.n_partitions == eng_t.n_trials * (
            1 if eng_t.batch_replicated else eng_t.dp_degree)
        assert teng.allocator.all_free() or kw.get("prefix_cache")
        assert teng.transfer.pending() == 0
        if kw.get("host_blocks"):
            assert teng.store.host_used() == jeng.store.host_used()
    else:  # slots were recycled, their rows reset on every device
        assert sum(resets) == len(reqs) > teng.batcher.n_cells
    s = teng.stats
    if case == "prefix_host_retract":
        assert s.retractions > 0 and s.swap_out_blocks > 0
    if case == "prefix_spill":
        assert s.prefix_spills > 0 and s.swap_in_blocks > 0
    if case == "prefix_fused":
        assert s.prefix_hits > 0 and s.cow_forks > 0 and s.mixed_calls > 0
    if case == "spec":
        assert teng.spec_stats.acceptance_rate == 1.0
        assert teng.spec_stats.verify_calls > 0


def test_placed_static_serve_matches_reference_and_one_device():
    cfg_j, cfg_t = _cfgs("chatglm3-6b")
    eng_j, eng_t, eng_1 = _engines(paged=False, fsdp=True)
    layout = _layout(1, 2)
    params = _params(cfg_j, eng_j)
    rng = np.random.default_rng(5)
    reqs = [JRequest(i, rng.integers(0, cfg_t.vocab_size, (8,))
                     .astype(np.int32), 2 + i % 4) for i in range(6)]
    jcomp, jst = jstatic(cfg_j, eng_j, _mesh(eng_j), params,
                         [r.clone() for r in reqs])
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    ocomp, ost = tstatic(cfg_t, eng_1, tparams, to_port(reqs),
                         device="cpu")
    tcomp, tst = tstatic(cfg_t, eng_t, tpl.place_trial_params(
        cfg_t, eng_t, tparams, layout), to_port(reqs), layout=layout)
    for ref, st in ((jcomp, jst), (ocomp, ost)):
        assert [(c.rid, c.tokens, c.finished_tick) for c in tcomp] == \
            [(c.rid, c.tokens, c.finished_tick) for c in ref]
        assert (tst.calls, tst.ticks) == (st.calls, st.ticks)


def test_placed_transfer_round_trip_is_bit_exact():
    """extract two written blocks of shard 1 to the host and inject them
    over two others: every stage's pool holds the same bits at both."""
    cfg = tget("chatglm3-6b").reduced()
    _, eng, _ = _engines(n_blocks=16)
    layout = _layout(1, 2)
    placed = tpl.place_serve_cache(cfg, eng, _random_cache(cfg, eng),
                                   layout)
    tk = tpl.make_transfer_kernels(cfg, eng, layout=layout)
    payloads = tk.extract(placed, 0, 1, [0, 1])
    lp = tpl.plan_stages(cfg, 2).padded_layers
    assert [tuple(p.shape) for p in payloads] == \
        [(2, lp, 4, cfg.n_kv_heads, cfg.head_dim)] * 2
    tk.inject(placed, 0, 1, [5, 6], payloads)
    tk.copy(placed, np.asarray([[[-1], [2]]]), np.asarray([[[-1], [7]]]))
    for s in range(2):
        for n in ("k", "v"):
            pool = placed[0][1][s]["layers"][n][0]
            assert torch.equal(pool[:, [5, 6, 7]], pool[:, [0, 1, 2]])
            other = placed[0][0][s]["layers"][n][0]
            assert not torch.equal(other[:, 5], other[:, 0])


def test_one_device_steps_still_refuse_what_needs_a_layout():
    cfg = tget("chatglm3-6b").reduced()
    for ekw in (dict(n_pod=2, n_data=1), dict(fsdp=True),
                dict(replicated=True)):
        _, eng, _ = _engines(**ekw)
        with pytest.raises(ValueError, match="device layout"):
            tpl.make_serve_step(cfg, TOpts(), eng, "decode")
        tpl.make_serve_step(cfg, TOpts(), eng, "decode",
                            layout=_layout(eng.pod_size, eng.data_size))
    with pytest.raises(ValueError, match="do not match"):
        tpl.make_serve_step(cfg, TOpts(), eng, "decode",
                            layout=_layout(1, 1))
    with pytest.raises(ValueError, match="not both"):
        TEngine(cfg, eng, None, layout=_layout(1, 2), device="cpu")


# ---------------------------------------------------------------------------
# elastic layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pods,n_data,cordon,multi_pod", [
    (1, 4, (0, 1), False), (2, 2, (1, 0), True), (2, 2, (0, 1), False)])
def test_rebuild_layout_follows_reference_mesh(n_pods, n_data, cordon,
                                               multi_pod):
    health = jel.MeshHealth.fresh(n_pods, n_data).cordon(*cordon)
    mesh = jel.rebuild_mesh(jax.devices(), health, 2, multi_pod)
    thealth = tel.MeshHealth.fresh(n_pods, n_data).cordon(*cordon)
    layout = tel.rebuild_layout([f"cpu:{i}" for i in range(8)], thealth, 2,
                                multi_pod)
    assert layout.axis_sizes == dict(zip(mesh.axis_names,
                                         mesh.devices.shape))
    assert [d.index for d in layout.devices.flat] == \
        [d.id for d in mesh.devices.flat]
    assert layout.multi_pod == multi_pod
    with pytest.raises(RuntimeError, match="need"):
        tel.rebuild_layout(["cpu"] * (layout.devices.size - 1), thealth, 2,
                           multi_pod)


def test_placed_train_step_on_rebuilt_layout_matches_reference():
    """Data row 1 fails on data 2 × model 2: the gathered tree re-placed
    on the rebuilt data 1 × model 2 layout takes a step equal to the JAX
    step on the rebuilt mesh (test_torch_placement.py's gates)."""
    cfg_j, cfg_t = _cfgs("chatglm3-6b")
    kw = dict(n_trials=2, n_microbatches=2, microbatch=2, n_stages=2,
              data_size=2, fsdp=True)
    eng_j, eng_t = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=SEQ)
    p0 = jax.tree.map(np.array, params)
    placed = tpl.place_trial_params(cfg_t, eng_t, params_from_numpy(p0),
                                    _layout(1, 2))
    health = tel.MeshHealth.fresh(1, 2).cordon(0, 1)
    eng_t = tel.shrink_engine(eng_t, health)
    eng_j = jel.shrink_engine(eng_j, jel.MeshHealth.fresh(1, 2).cordon(0, 1))
    mesh = jel.rebuild_mesh(jax.devices(), jel.MeshHealth.fresh(1, 2)
                            .cordon(0, 1), 2, False)
    layout = tel.rebuild_layout(["cpu"] * 8, health, 2, False)
    tree = tpl.gather_trial_params(cfg_t, dataclasses.replace(
        eng_t, data_size=2), placed, _layout(1, 2))
    pt = tpl.place_trial_params(cfg_t, eng_t, tree, layout)
    batch = JBatches(cfg_j, eng_j, SEQ, seed=0).batch_for_step(0)
    opt_j, opt_t = JAdamW(grad_clip=1.0), TAdamW(grad_clip=1.0)
    step_j = jpl.make_train_step(cfg_j, JOpts(remat=True), eng_j, mesh,
                                 opt_j)
    step_t = tpl.make_train_step(cfg_t, TOpts(remat=True), eng_t, opt_t,
                                 layout=layout)
    pj, _, mj = step_j(params, opt_j.init(params),
                       jax.tree.map(jnp.asarray, batch),
                       {n: jnp.asarray(v) for n, v in HP.items()},
                       jnp.asarray(0, jnp.int32))
    pt, _, mt = step_t(pt, opt_t.init(pt), batch, HP, 0)
    assert _err(mj["loss"], mt["loss"]) < 2e-4
    assert _err(np.asarray(mj["grad_norm"]) / 2, mt["grad_norm"]) < 5e-3
    got = tpl.gather_trial_params(cfg_t, eng_t, pt, layout)
    assert _tree_err(jax.tree.map(np.asarray, pj), got) < 5e-3


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_devices_matches_one_device_run(capsys):
    common = ["--arch", "chatglm3-6b", "--smoke", "--paged", "--paged-kernel",
              "--n-data", "2", "--n-model", "2", "--n-requests", "6",
              "--prompt-len", "12", "--gen-len", "5"]
    launcher.main(common + ["--device", "cpu"])
    one = capsys.readouterr().out
    launcher.main(common + ["--devices", "cpu,cpu,cpu,cpu"])
    placed = capsys.readouterr().out
    gen = lambda out: [ln for ln in out.splitlines()
                       if ln.lstrip().startswith("req[")]
    assert len(gen(one)) == 6 and gen(placed) == gen(one)
    assert "6 requests" in placed and "on cpu,cpu,cpu,cpu" in placed
    with pytest.raises(SystemExit, match="--devices"):
        launcher.main(common + ["--device", "cpu", "--devices", "cpu"])
    with pytest.raises(ValueError, match="takes 4 devices"):
        launcher.main(common + ["--devices", "cpu,cpu"])
