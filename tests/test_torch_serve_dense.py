"""PyTorch port — dense (non-paged) serving against the JAX reference on the
same weights (carried across with ``params_from_numpy``), on reduced
chatglm3-6b (attention, K/V strips) and reduced falcon-mamba-7b (ssm,
recurrent states; the port runs its kernel branch, the plain version on
the CPU, against the reference's chunked scan):

* ``make_serve_step`` append, append, decode over S=4 stages at data_size
  1 and 2 (the setup of ``tests/integration/test_serve_pipeline.py``) with
  an ``active`` row mask: greedy tokens of the active rows equal,
  ``logit_max`` within 2e-5, every cache leaf within 2e-5 after every
  call. The second append leaves idle rows out — a whole slot and one row
  of a slot whose other row takes a chunk — and those rows' cache entries
  stay bit-equal to before (the reference's ``put_cache`` row mask), then
  decode from them as the reference does;
* ``make_slot_reset`` zeros exactly the masked (trial, group, row) rows,
  as the reference's;
* the reference's rejections for recurrent families (paged pools, a
  window, fused admission, speculation, mixed / verify steps) and for
  paged-only options on a dense engine;
* ``scheduler._cache_bytes_per_chip`` for falcon-mamba-7b against the
  reference's.

The dense ServeEngine itself is held against the reference in
``tests/test_torch_serve_dense_engine.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro.core.partitioner import plan_stages as jplan
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.serve import ServeEngine as TEngine

torch.set_num_threads(2)
TOL = 2e-5
MAX_SEQ, S, M, MB = 18, 4, 3, 2


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, data_size):
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    kw = dict(n_trials=1, n_microbatches=M, microbatch=MB, n_stages=S,
              data_size=data_size, max_seq=MAX_SEQ)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, S),
                                   jax.random.PRNGKey(0), max_pos=MAX_SEQ)
    mesh = make_test_mesh(data_size, S)
    ssm = cfg_t.family == "ssm"
    steps_j = {m: jpl.make_serve_step(cfg_j, JOpts(), eng_j, mesh, m,
                                      with_active=True)
               for m in ("append", "decode")}
    steps_t = {m: tpl.make_serve_step(cfg_t, TOpts(use_mamba_kernel=ssm),
                                      eng_t, m)
               for m in ("append", "decode")}
    return (cfg_j, eng_j, params, steps_j, mesh), (
        cfg_t, eng_t, params_from_numpy(_np_tree(params)), steps_t)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("data_size", [1, 2])
def test_dense_serve_steps_match_reference(arch, data_size):
    (cfg_j, eng_j, pj, sj, _), (cfg_t, eng_t, pt, st) = _setup(arch,
                                                               data_size)
    mbg = MB * data_size
    rng = np.random.default_rng(7)
    vocab = cfg_j.vocab_size
    grid = (1, M, mbg)
    first = np.ones(grid, bool)
    first[0, 0, mbg - 1] = False  # a cell that stays empty
    second = np.zeros(grid, bool)  # slot 2 and one row of slot 1 ride along
    second[0, 0] = first[0, 0]
    second[0, 1, 0] = True
    calls = [
        ("append", first, np.zeros(grid, np.int32), 6),
        ("append", second, np.where(second, 6, 0).astype(np.int32), 5),
        ("decode", first, np.where(second, 11, 6).astype(np.int32), 1),
    ]
    cache_j = jpl.serve_cache_struct(cfg_j, eng_j, dry_run=False)
    cache_t = tpl.serve_cache_struct(cfg_t, eng_t, device="cpu")
    for mode, active, positions, qlen in calls:
        tokens = rng.integers(0, vocab, grid + (qlen,)).astype(np.int32)
        batch = {"tokens": tokens, "positions": positions, "active": active}
        before = {n: v.clone() for n, v in cache_t["layers"].items()}
        cache_j, tok_j, val_j = sj[mode](
            pj, cache_j, {n: jnp.asarray(a) for n, a in batch.items()})
        cache_t, tok_t, val_t = st[mode](
            pt, cache_t, {n: torch.from_numpy(a) for n, a in batch.items()})
        np.testing.assert_array_equal(np.asarray(tok_j)[active],
                                      tok_t.numpy()[active])
        assert _err(np.asarray(val_j)[active], val_t.numpy()[active]) < TOL
        for n, buf in cache_t["layers"].items():
            assert buf.dtype == before[n].dtype
            assert _err(cache_j["layers"][n], buf) < TOL
            # rows outside the call: bit-equal to before (leaves are
            # (K, G, Lp, mbg, ...))
            idle = torch.from_numpy(~active)
            np.testing.assert_array_equal(
                buf.permute(0, 1, 3, 2, *range(4, buf.ndim))[idle].numpy(),
                before[n].permute(0, 1, 3, 2, *range(4, buf.ndim))[idle]
                .numpy())


def test_dense_cache_layout_and_dtypes():
    cfg = tget("falcon-mamba-7b").reduced()
    eng = tpl.EngineConfig(n_trials=2, n_microbatches=3, microbatch=2,
                           n_stages=2, data_size=2, max_seq=8,
                           cache_dtype=torch.bfloat16)
    c = tpl.serve_cache_struct(cfg, eng, device="cpu")["layers"]
    di, n = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state
    assert c["ssm"].shape == (2, 3, 4, 4, di, n)
    assert c["ssm"].dtype == torch.float32
    assert c["conv"].shape == (2, 3, 4, 4, cfg.ssm.d_conv - 1, di)
    assert c["conv"].dtype == torch.bfloat16
    # chunked-prefill groups share a cache, as the reference's layout
    chunked = dataclasses.replace(eng, prefill_chunks=3)
    assert chunked.cache_groups == 1
    assert tpl.serve_cache_struct(cfg, chunked)["layers"]["ssm"].shape[1] == 1


@pytest.mark.parametrize("arch", ["chatglm3-6b", "falcon-mamba-7b"])
def test_slot_reset_zeros_only_masked_rows(arch):
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    kw = dict(n_trials=2, n_microbatches=2, microbatch=1, n_stages=2,
              data_size=2, max_seq=8)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    rng = np.random.default_rng(3)
    struct = jpl.serve_cache_struct(cfg_j, eng_j)
    cache = {"layers": {n: rng.normal(size=s.shape).astype(np.float32)
                        for n, s in struct["layers"].items()},
             "shared": None}
    mask = np.zeros((2, 2, 2), bool)
    mask[0, 1, 0] = mask[1, 0, 1] = mask[1, 1, 1] = True
    reset_j = jpl.make_slot_reset(cfg_j, eng_j, make_test_mesh(2, 2))
    want = reset_j(jax.tree.map(jnp.asarray, cache), jnp.asarray(mask))
    ct = {"layers": params_from_numpy({n: a.copy() for n, a in
                                       cache["layers"].items()}),
          "shared": None}
    views = dict(ct["layers"])
    got = tpl.make_slot_reset(cfg_t, eng_t)(ct, mask)
    for n, buf in got["layers"].items():
        assert buf is views[n]  # in place
        np.testing.assert_array_equal(np.asarray(want["layers"][n]),
                                      buf.numpy())
        rows = np.moveaxis(buf.numpy(), 3, 2)  # (K, G, mbg, Lp, ...)
        assert not rows[mask].any()
        np.testing.assert_array_equal(rows[~mask],
                                      np.moveaxis(cache["layers"][n], 3,
                                                  2)[~mask])
    with pytest.raises(ValueError, match="paged"):
        tpl.make_slot_reset(cfg_t, dataclasses.replace(eng_t, paged=True,
                                                       n_blocks=4))


def _falcon_engine_parts():
    cfg = tget("falcon-mamba-7b").reduced()
    eng = tpl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                           n_stages=2, max_seq=16, cache_dtype=torch.float32)
    params = tpl.init_trial_params(cfg, eng, tpl.plan_stages(cfg, 2),
                                   torch.Generator().manual_seed(0))
    return cfg, eng, params


def test_recurrent_family_rejections_match_reference():
    cfg, eng, params = _falcon_engine_parts()
    paged = dataclasses.replace(eng, paged=True, block_size=4, n_blocks=8)
    for bad_eng, kw in ((paged, {}),
                        (dataclasses.replace(eng, window=4), {}),
                        (eng, dict(fused=True)),
                        (eng, dict(spec_gamma=2))):
        with pytest.raises(ValueError):
            TEngine(cfg, bad_eng, params, device="cpu", **kw)
    with pytest.raises(ValueError, match="attention-family"):
        tpl.serve_cache_struct(cfg, paged)
    for mode in ("mixed", "verify"):
        with pytest.raises(ValueError, match="recurrent"):
            tpl.make_serve_step(cfg, TOpts(), eng, mode)
    # paged-only options on a dense engine, as the reference
    for opts, kw in ((TOpts(use_paged_kernel=True), {}),
                     (TOpts(), dict(prefix_cache=True)),
                     (TOpts(), dict(overcommit=1.5))):
        with pytest.raises(ValueError, match="paged"):
            TEngine(cfg, eng, params, opts, device="cpu", **kw)
    # what the reference allows the attention family: a window
    glm = tget("chatglm3-6b").reduced()
    glm_params = tpl.init_trial_params(glm, eng, tpl.plan_stages(glm, 2),
                                       torch.Generator().manual_seed(0))
    windowed = TEngine(glm, dataclasses.replace(eng, window=4), glm_params,
                       device="cpu")
    assert windowed.eng.window == 4 and windowed.reset_fn is not None


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_ssm_cache_bytes_match_reference(cache_dtype):
    cfg_j, cfg_t = jget("falcon-mamba-7b"), tget("falcon-mamba-7b")
    kw = dict(n_trials=1, n_microbatches=2, microbatch=2, n_stages=2,
              max_seq=1056)
    eng_j = jpl.EngineConfig(cache_dtype=getattr(jnp, cache_dtype), **kw)
    eng_t = tpl.EngineConfig(cache_dtype=getattr(torch, cache_dtype), **kw)
    want = jsched._cache_bytes_per_chip(cfg_j, eng_j, 1056)
    assert tsched._cache_bytes_per_chip(cfg_t, eng_t, 1056) == want
    # 4 rows x 32 layers per stage x (fp32 state + conv window)
    di = 8192
    conv = 3 * di * (2 if cache_dtype == "bfloat16" else 4)
    assert want == 4 * 32 * (di * 16 * 4 + conv)
