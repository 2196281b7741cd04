"""PyTorch port — serving and training the hybrid family (reduced
zamba2-7b: 5 layers, ``attn_every`` 2, so each of S = 2 stages holds one
shared-attention site: global layers 1 and 3) against the JAX package on
the same weights (``params_from_numpy``):

* the dense ``ServeEngine`` on ``tests/test_serve_engine.py``'s staggered
  trace (seed 2: seven requests over four cells, so slots recycle): every
  request's tokens and tick latencies, every counter and schedule sample
  equal the JAX engine's, and the tokens equal the single-device oracle;
  every slot reset zeroes the recycled rows' states and shared strips;
* ``static_serve`` against the reference's (the shared block's prefill
  through ``ops.flash_attention``, its plain version here): tokens,
  latencies, the summary and the samples;
* the ``prefill`` step against the reference's (tokens, ``logit_max`` and
  every cache leaf, the shared strips included, within 2e-5), and chunked
  prefill (4 chunks) against plain prefill in tokens and caches (5e-4,
  ``tests/integration/test_chunked_prefill.py``);
* ``make_slot_reset`` on the shared strips; ``plan_serve_capacity`` field
  by field (the reference's hybrid cache bytes, mirrored); the
  reference's rejections (paged, a window on the continuous engine,
  mixed / verify, fused admission, speculation, the prefix cache);
* ``make_train_step`` (flash kernel on: its plain version against the
  Pallas kernel in interpret mode) against the reference's, K = 2, S = 2,
  2 data shards, 2 steps, at the reference's 2e-4 / 5e-3 and each
  trial's change within 10 % (grad norms: JAX's divided by S, ROADMAP
  Queue 3);
* the launchers: ``launch.serve`` (continuous and ``--static``) and
  ``launch.train --arch zamba2-7b --smoke --device cpu``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serve_engine import MAX_SEQ, build, staggered_trace
from test_torch_serve_engine import assert_parity

from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro.core.partitioner import plan_stages as jplan
from repro.data.pipeline import TrainBatches as JBatches
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro.optim.adamw import AdamW as JAdamW
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import static_serve as jstatic
from repro.configs import get_config as jget
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm as tlm
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import static_serve as tstatic
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
ARCH = "zamba2-7b"
TOL = 2e-5


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _port_eng(eng_j):
    fields = ("n_trials", "n_microbatches", "microbatch", "n_stages",
              "data_size", "max_seq", "prefill_chunks", "window")
    return tpl.EngineConfig(cache_dtype=torch.float32,
                            **{f: getattr(eng_j, f) for f in fields})


def _port_params(params):
    return params_from_numpy(jax.tree.map(np.asarray, params))


def _port_trace(jreqs):
    return [TRequest(r.rid, r.prompt.copy(), r.max_new_tokens,
                     arrival=r.arrival) for r in jreqs]


def test_reduced_stages_each_hold_a_site():
    cfg = tget(ARCH).reduced()
    plan = tpl.plan_stages(cfg, 2)
    assert (cfg.n_layers, cfg.hybrid.attn_every, plan.layers_per_stage) == \
        (5, 2, 3)
    assert [tlm.shared_site_flags(cfg, plan.layer_offset(s), 3)[0]
            for s in range(2)] == [[False, True, False], [True, False, False]]
    assert tpl.shared_slots_per_stage(cfg, plan) == 1


# ---------------------------------------------------------------------------
# the dense engine, static serving, prefill
# ---------------------------------------------------------------------------


def test_dense_engine_matches_reference_and_oracle():
    cfg_j, opts_j, mesh, eng_j, params = build(ARCH)
    jreqs = staggered_trace(cfg_j.vocab_size, seed=2)
    jeng = JEngine(cfg_j, eng_j, mesh, params, opts_j)
    jcomp = jeng.run([r.clone() for r in jreqs])
    cfg = tget(ARCH).reduced()
    pt = _port_params(params)
    teng = TEngine(cfg, _port_eng(eng_j), pt, TOpts(use_flash_kernel=True),
                   device="cpu")
    resets, reset_fn = [], teng.reset_fn

    def checked(cache, mask):
        out = reset_fn(cache, mask)
        rows = torch.as_tensor(mask).nonzero().tolist()
        for part in ("layers", "shared"):
            for buf in cache[part].values():  # (K, G, Lp | sites, mbg, ...)
                assert not any(buf[k, g, :, b].any() for k, g, b in rows)
        resets.append(len(rows))
        return out

    teng.reset_fn = checked
    tcomp = teng.run(_port_trace(jreqs))
    assert teng.cache["shared"]["k"].shape[:3] == (1, 2, 2)  # S sites
    assert sum(resets) == len(jreqs) > teng.batcher.n_cells  # recycled
    assert_parity(teng, jeng, tcomp, jcomp)
    p1 = tlm.layer_slice(pt, 0)
    for r, c in zip(jreqs, tcomp):
        assert c.tokens == tlm.greedy_generate(
            cfg, TOpts(), p1, r.prompt, r.max_new_tokens, MAX_SEQ,
            torch.float32), f"request {r.rid}: port != oracle"


GENS = [2, 7, 3, 6, 2, 5]
PLEN = 8


def test_static_serve_matches_reference():
    cfg_j, opts_j, mesh, eng_j, params = build(ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab_size, (PLEN,)).astype(np.int32)
               for _ in GENS]
    jcomp, jst = jstatic(cfg_j, eng_j, mesh, params,
                         [JRequest(i, p, g) for i, (p, g)
                          in enumerate(zip(prompts, GENS))], opts_j)
    tcomp, tst = tstatic(tget(ARCH).reduced(), _port_eng(eng_j),
                         _port_params(params),
                         [TRequest(i, p, g) for i, (p, g)
                          in enumerate(zip(prompts, GENS))],
                         TOpts(use_flash_kernel=True), device="cpu")
    for a, b in zip(tcomp, jcomp):
        assert a.tokens == b.tokens, f"request {a.rid}: port != reference"
        assert (a.admitted_tick, a.first_token_tick, a.finished_tick) == \
            (b.admitted_tick, b.first_token_tick, b.finished_tick), a.rid
    drop = ("wall_s", "tokens_per_s")
    assert {k: v for k, v in tst.summary().items() if k not in drop} == \
        {k: v for k, v in jst.summary().items() if k not in drop}


def _prefill(cfg, eng, params, toks):
    step = tpl.make_serve_step(cfg, TOpts(use_flash_kernel=True), eng,
                               "prefill")
    return step(params, tpl.serve_cache_struct(cfg, eng, device="cpu"),
                {"tokens": torch.from_numpy(toks)})


def test_prefill_and_chunked_prefill_match_reference():
    seq, nc = 16, 4
    cfg_j, cfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    kw = dict(n_trials=1, n_microbatches=2, microbatch=2, n_stages=2,
              data_size=2, max_seq=seq)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=seq)
    pt = _port_params(params)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 2, 4, seq), np.int32)
    step_j = jpl.make_serve_step(cfg_j, JOpts(), eng_j, make_test_mesh(2, 2),
                                 "prefill")
    cache_j, tok_j, val_j = step_j(
        params, jpl.serve_cache_struct(cfg_j, eng_j, dry_run=False),
        {"tokens": jnp.asarray(toks)})
    cache_t, tok_t, val_t = _prefill(cfg, eng, pt, toks)
    np.testing.assert_array_equal(np.asarray(tok_j), tok_t.numpy())
    assert _err(val_j, val_t) < TOL
    for part in ("layers", "shared"):
        for n, buf in cache_t[part].items():
            assert tuple(buf.shape) == cache_j[part][n].shape
            assert _err(cache_j[part][n], buf) < TOL, (part, n)
    assert cache_t["shared"]["k"].abs().amax() > 0
    # chunked: the 4 chunk slots of each request group share its cache
    chunked = dataclasses.replace(eng, n_microbatches=2 * nc,
                                  prefill_chunks=nc)
    toks_c = np.ascontiguousarray(toks.reshape(1, 2, 4, nc, seq // nc)
                                  .transpose(0, 1, 3, 2, 4)
                                  .reshape(1, 2 * nc, 4, seq // nc))
    cache_c, tok_c, _ = _prefill(cfg, chunked, pt, toks_c)
    np.testing.assert_array_equal(
        tok_c.numpy().reshape(1, 2, nc, 4)[:, :, -1], tok_t.numpy())
    for part in ("layers", "shared"):
        for n, buf in cache_t[part].items():
            assert _err(buf, cache_c[part][n]) < 5e-4, (part, n)


def test_slot_reset_zeroes_shared_strips():
    cfg = tget(ARCH).reduced()
    eng = tpl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=2,
                           n_stages=2, max_seq=8, cache_dtype=torch.float32)
    cache = tpl.serve_cache_struct(cfg, eng, device="cpu")
    for buf in tree_leaves(cache):
        buf.normal_()
    before = [b.clone() for b in tree_leaves(cache)]
    mask = np.zeros((2, 2, 2), bool)
    mask[1, 0, 1] = mask[0, 1, 0] = True
    tpl.make_slot_reset(cfg, eng)(cache, mask)
    keep = torch.from_numpy(~mask)
    for old, buf in zip(before, tree_leaves(cache)):
        rows = buf.transpose(2, 3)  # (K, G, mbg, Lp | sites, ...)
        assert not rows[torch.from_numpy(mask)].any()
        assert torch.equal(rows[keep], old.transpose(2, 3)[keep])


# ---------------------------------------------------------------------------
# capacity plans and rejections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,gib,window", [
    ("bfloat16", 16, 0), ("bfloat16", 20, 512), ("float32", 40, 0)])
def test_plan_serve_capacity_matches_reference(dtype, gib, window):
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float32": (jnp.float32, torch.float32)}[dtype]
    kw = dict(n_trials=1, n_microbatches=1, microbatch=2, n_stages=2,
              max_seq=0, window=window)
    j = jsched.plan_serve_capacity(jget(ARCH), jpl.EngineConfig(
        cache_dtype=jdt, **kw), 1056, hbm_bytes=gib * 1024 ** 3)
    t = tsched.plan_serve_capacity(tget(ARCH), tpl.EngineConfig(
        cache_dtype=tdt, **kw), 1056, hbm_bytes=2 * gib * 1024 ** 3)
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "cache_dtype":
            a, b = str(a).split(".")[-1], jnp.dtype(b).name
        assert a == b, (f.name, a, b)
    assert 1 < t.n_microbatches < 64


def test_rejections_match_reference():
    cfg = tget(ARCH).reduced()
    eng = tpl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                           n_stages=2, max_seq=16, cache_dtype=torch.float32)
    params = tpl.init_trial_params(cfg, eng, tpl.plan_stages(cfg, 2),
                                   torch.Generator().manual_seed(0))
    paged = dataclasses.replace(eng, paged=True, n_blocks=8, block_size=4)
    with pytest.raises(ValueError, match="attention-family"):
        tpl.serve_cache_struct(cfg, paged)
    with pytest.raises(ValueError, match="attention-family"):
        tpl.make_serve_step(cfg, TOpts(), paged, "decode")
    for mode in ("mixed", "verify"):
        with pytest.raises(ValueError, match="attention-family"):
            tpl.make_serve_step(cfg, TOpts(), eng, mode)
    with pytest.raises(ValueError, match="sliding-window"):
        TEngine(cfg, dataclasses.replace(eng, window=4), params,
                device="cpu")
    for kw, needle in (({"fused": True}, "fused"),
                       ({"spec_gamma": 2}, "speculation"),
                       ({"prefix_cache": True}, "prefix")):
        with pytest.raises(ValueError, match=needle):
            TEngine(cfg, eng, params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

HP = {"lr": np.asarray([3e-3, 1e-3], np.float32),
      "wd": np.asarray([0.0, 0.01], np.float32)}


def test_train_step_matches_reference():
    seq, n_steps, S = 16, 2, 2
    cfg_j, cfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    kw = dict(n_trials=2, n_microbatches=2, microbatch=1, n_stages=S,
              data_size=2)
    eng_j, eng = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, S),
                                   jax.random.PRNGKey(0), max_pos=seq)
    data = JBatches(cfg_j, eng_j, seq, seed=0)
    batches = [data.batch_for_step(s) for s in range(n_steps)]
    data.close()
    p0 = jax.tree.map(np.array, params)
    pt = params_from_numpy(p0)
    opt_j, opt_t = JAdamW(grad_clip=1.0), TAdamW(grad_clip=1.0)
    step_j = jpl.make_train_step(cfg_j, JOpts(remat=True,
                                              use_flash_kernel=True),
                                 eng_j, make_test_mesh(2, S), opt_j)
    opts = TOpts(remat=True, use_flash_kernel=True)  # as the launcher
    step_t = tpl.make_train_step(cfg, opts, eng, opt_t)
    oj, ot = opt_j.init(params), opt_t.init(pt)
    hp_j = {n: jnp.asarray(v) for n, v in HP.items()}
    pj = params
    for s in range(n_steps):
        pj, oj, mj = step_j(pj, oj, jax.tree.map(jnp.asarray, batches[s]),
                            hp_j, jnp.asarray(s, jnp.int32))
        pt, ot, mt = step_t(pt, ot, batches[s], HP, s)
        assert _err(mj["loss"], mt["loss"]) < 2e-4, s
        assert _err(np.asarray(mj["grad_norm"]) / S, mt["grad_norm"]) \
            < 5e-3, s
    pj = jax.tree.map(np.asarray, pj)
    leaves = list(zip(tree_leaves(p0), tree_leaves(pj), tree_leaves(pt)))
    assert max(_err(a, b.detach()) for _, a, b in leaves) < 5e-3
    assert max(_err(a["shared"]["attn"]["wq"], b["shared"]["attn"]["wq"])
               for a, b in [(pj, pt)]) < 5e-3
    for k in range(2):  # each trial's change, relative to the reference's
        change = (max(_err(a[k], b[k].detach()) for _, a, b in leaves)
                  / max(_err(a[k], x[k]) for x, a, _ in leaves))
        assert change < 0.1, (k, change)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def test_launchers_run_zamba2_on_cpu(capsys):
    common = ["--arch", ARCH, "--smoke", "--n-model", "2", "--slots", "2",
              "--microbatch", "1", "--prompt-len", "8", "--gen-len", "3",
              "--n-requests", "5", "--device", "cpu"]
    serve_launcher.main(common)
    assert "continuous/dense: 5 requests" in capsys.readouterr().out
    serve_launcher.main(common + ["--static"])
    assert "static: 5 requests" in capsys.readouterr().out
    for extra, needle in ((["--paged"], "attention"),
                          (["--window", "4"], "sliding-window")):
        with pytest.raises((SystemExit, ValueError), match=needle):
            serve_launcher.main(common + extra)
    train_launcher.main(["--arch", ARCH, "--smoke", "--trials", "2",
                         "--steps", "2", "--n-model", "2",
                         "--n-microbatches", "2", "--seq-len", "16",
                         "--device", "cpu"])
    assert '"best_trial"' in capsys.readouterr().out
