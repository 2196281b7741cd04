"""PyTorch port — the serving program against the JAX reference on the same
weights (carried across with ``params_from_numpy``):

* ``attn_apply`` paged append/decode, kernel form (the plain version on the
  CPU) and gather form: ``out`` within 2e-5, pool entries outside the write
  set bit-equal to before, written entries within 2e-5 (the two frameworks'
  matmuls differ in the last bits, so written K/V are not bit-equal);
* ``make_serve_step`` append then decode over S=2 stages at data_size 1 and
  2: identical greedy tokens, ``logit_max`` within 2e-5, pools within 2e-5;
* the vocab-parallel greedy head's cross-shard tie rule;
* the transfer kernels (pool copy, extract, inject).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.launch.mesh import make_test_mesh
from repro.models import blocks as jblocks
from repro.models.layers import ModelOptions as JOpts
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.models import blocks as tblocks
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy

torch.set_num_threads(2)
TOL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ---------------------------------------------------------------------------
# attn_apply over the paged pool
# ---------------------------------------------------------------------------


def _attn_case(seed, s, kv_lens, nb=16, bs=4, n_tbl=6):
    cfg = jget("chatglm3-6b").reduced()
    rng = np.random.default_rng(seed)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {w: (rng.normal(size=(d, n * hd)) / np.sqrt(d)).astype(np.float32)
         for w, n in (("wq", h), ("wk", hkv), ("wv", hkv))}
    p["wo"] = (rng.normal(size=(h * hd, d)) / np.sqrt(h * hd)
               ).astype(np.float32)
    b = len(kv_lens)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    pool = {n: rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
            for n in ("k", "v")}
    tables = np.full((b, n_tbl), -1, np.int32)
    free = list(rng.permutation(nb))
    for r, ln in enumerate(kv_lens):
        for j in range(-(-(ln + s) // bs)):
            tables[r, j] = free.pop()
    off = np.asarray(kv_lens, np.int32)
    pos = off[:, None] + np.arange(s, dtype=np.int32)[None, :]
    return p, x, pool, tables, off, pos


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("mode,s,kv_lens,window,wmask", [
    ("decode", 1, [7, 12], 0, None),
    ("decode", 1, [7, 12], 3, None),
    ("append", 4, [5, 9], 0, None),
    ("append", 3, [2, 10, 6], 2, [True, False, True]),
])
def test_attn_apply_paged_matches_reference(kernel, mode, s, kv_lens, window,
                                            wmask):
    p, x, pool, tables, off, pos = _attn_case(1, s, kv_lens)
    jcfg, tcfg = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    wm = None if wmask is None else np.asarray(wmask)
    jout, jcache = jblocks.attn_apply(
        jcfg, JOpts(use_paged_kernel=kernel), jax.tree.map(jnp.asarray, p),
        jnp.asarray(x), pos=jnp.asarray(pos),
        cache=jax.tree.map(jnp.asarray, pool), kv_offset=jnp.asarray(off),
        mode=mode, window=window, block_tables=jnp.asarray(tables),
        write_mask=None if wm is None else jnp.asarray(wm))
    tcache = params_from_numpy({n: a.copy() for n, a in pool.items()})
    tout, tcache = tblocks.attn_apply(
        tcfg, TOpts(use_paged_kernel=kernel), params_from_numpy(p),
        torch.from_numpy(x), pos=torch.from_numpy(pos), cache=tcache,
        kv_offset=torch.from_numpy(off), mode=mode, window=window,
        block_tables=torch.from_numpy(tables),
        write_mask=None if wm is None else torch.from_numpy(wm))
    assert _err(jout, tout) < TOL
    # the write set: each writing row's s new positions through its table
    nb, bs = pool["k"].shape[:2]
    written = np.zeros((nb, bs), bool)
    for r in range(len(kv_lens)):
        if wm is not None and not wm[r]:
            continue
        for q in pos[r]:
            written[tables[r, q // bs], q % bs] = True
    for n in ("k", "v"):
        got, ref = tcache[n].numpy(), np.asarray(jcache[n])
        np.testing.assert_array_equal(got[~written], pool[n][~written])
        assert _err(ref[written], got[written]) < TOL
        assert not np.array_equal(got[written], pool[n][written])


# ---------------------------------------------------------------------------
# make_serve_step: the pipelined program, tick by tick
# ---------------------------------------------------------------------------

MAX_SEQ, BS, NB = 24, 4, 24


def _engines(data_size, kernel):
    cfg_j = jget("chatglm3-6b").reduced()
    cfg_t = tget("chatglm3-6b").reduced()
    mb = 2 // data_size
    kw = dict(n_trials=1, n_microbatches=2, microbatch=mb, n_stages=2,
              data_size=data_size, max_seq=MAX_SEQ, paged=True,
              block_size=BS, n_blocks=NB)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=MAX_SEQ)
    mesh = make_test_mesh(data_size, 2)
    steps_j = {m: jpl.make_serve_step(cfg_j, JOpts(use_paged_kernel=kernel),
                                      eng_j, mesh, m, with_active=True)
               for m in ("append", "decode")}
    steps_t = {m: tpl.make_serve_step(cfg_t, TOpts(use_paged_kernel=kernel),
                                      eng_t, m) for m in ("append", "decode")}
    return (cfg_j, eng_j, params, steps_j), (cfg_t, eng_t,
                                             params_from_numpy(_np(params)),
                                             steps_t)


@pytest.mark.parametrize("data_size,kernel", [(1, True), (2, True),
                                              (1, False)])
def test_serve_step_matches_reference(data_size, kernel):
    (cfg_j, eng_j, pj, sj), (cfg_t, eng_t, pt, st) = _engines(data_size,
                                                              kernel)
    rng = np.random.default_rng(2)
    mbg = eng_j.microbatch * data_size
    per_shard = NB // data_size
    # shard-local tables: each row takes its own blocks from its shard's
    # partition; row (0, 1) sits idle (inactive, no table)
    tables = np.full((1, 2, mbg, MAX_SEQ // BS), -1, np.int32)
    nxt = [0] * data_size
    active = np.ones((1, 2, mbg), bool)
    active[0, 0, 1] = False
    for m in range(2):
        for b in range(mbg):
            if not active[0, m, b]:
                continue
            sh = b // eng_j.microbatch
            for j in range(3):
                tables[0, m, b, j] = nxt[sh]
                nxt[sh] += 1
            assert nxt[sh] <= per_shard
    cache_j = jpl.serve_cache_struct(cfg_j, eng_j, dry_run=False)
    cache_t = tpl.serve_cache_struct(cfg_t, eng_t, device="cpu")
    qlen = 5
    start = rng.integers(0, 3, (1, 2, mbg)).astype(np.int32)
    calls = [("append", rng.integers(0, cfg_j.vocab_size,
                                     (1, 2, mbg, qlen)).astype(np.int32),
              start)]
    calls.append(("decode", rng.integers(0, cfg_j.vocab_size,
                                         (1, 2, mbg, 1)).astype(np.int32),
                  start + qlen))
    for mode, tokens, positions in calls:
        batch = {"tokens": tokens, "positions": positions, "active": active,
                 "block_tables": tables}
        cache_j, tok_j, val_j = sj[mode](
            pj, cache_j, {n: jnp.asarray(a) for n, a in batch.items()})
        cache_t, tok_t, val_t = st[mode](
            pt, cache_t, {n: torch.from_numpy(a) for n, a in batch.items()})
        # idle rows compute garbage the engine discards (their -1 tables
        # clamp to local block 0 of their own shard in the reference, to
        # global block 0 in the port): compare the rows that ran
        np.testing.assert_array_equal(np.asarray(tok_j)[active],
                                      tok_t.numpy()[active])
        assert _err(np.asarray(val_j)[active], val_t.numpy()[active]) < TOL
        for n in ("k", "v"):
            assert _err(cache_j["layers"][n], cache_t["layers"][n]) < TOL


def test_global_block_tables_add_the_shard_offset():
    eng = tpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=2,
                           n_stages=1, data_size=2, paged=True, n_blocks=8)
    local = torch.tensor([[[[0, 1, -1], [2, -1, -1], [0, 3, 1],
                            [-1, -1, -1]]]])
    want = torch.tensor([[[[0, 1, -1], [2, -1, -1], [4, 7, 5],
                           [-1, -1, -1]]]])
    assert torch.equal(tpl.global_block_tables(eng, local), want)


def test_vp_greedy_tie_rule_matches_reference():
    """An exact logit tie across vocab shards returns the mean of the tied
    shard argmaxes (the reference's psum rule), not the first index."""
    cfg_j = dataclasses.replace(jget("chatglm3-6b").reduced(), vocab_size=7)
    cfg_t = dataclasses.replace(tget("chatglm3-6b").reduced(), vocab_size=7)
    d, S = cfg_j.d_model, 2
    head = np.zeros((d, 8), np.float32)  # vocab 7 padded to 8: shards of 4
    head[0, [1, 6]] = 2.0  # tie between shard 0 (id 1) and shard 1 (id 6)
    head[1, 3] = 1.5  # a non-tied runner-up
    head[:, 7] = 50.0  # the padded id must never win
    y = np.ones((2, 3, d), np.float32)
    y[1, :, 1] = 4.0  # row 1 makes id 3 win outright
    norm = np.ones((d,), np.float32)
    eng_j = jpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=1,
                             n_stages=S)
    mesh = make_test_mesh(1, S)
    fn = compat.shard_map(
        lambda n, h, x: jpl.vp_greedy_tokens(cfg_j, eng_j, n, h, x),
        mesh=mesh, in_specs=(P(), P(None, "model"), P()),
        out_specs=(P(), P()))
    tok_j, max_j = fn(jnp.asarray(norm), jnp.asarray(head), jnp.asarray(y))
    eng_t = tpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=1,
                             n_stages=S)
    tok_t, max_t = tpl.vp_greedy_tokens(cfg_t, eng_t, torch.from_numpy(norm),
                                        torch.from_numpy(head),
                                        torch.from_numpy(y))
    np.testing.assert_array_equal(np.asarray(tok_j), tok_t.numpy())
    assert tok_t[0, 0] == (1 + 6) // 2 and tok_t[1, 0] == 3
    assert _err(max_j, max_t) < TOL


def test_transfer_kernels_match_reference():
    """Pool copy (CoW), extract (device → host) and inject (host → device)
    over a K=2 × dp=2 partitioned pool, against the reference's kernels."""
    cfg_j, cfg_t = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    kw = dict(n_trials=2, n_microbatches=1, microbatch=1, n_stages=2,
              data_size=2, paged=True, block_size=BS, n_blocks=8)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    rng = np.random.default_rng(5)
    shape = (2, 4, 8, BS, cfg_j.n_kv_heads, cfg_j.head_dim)
    pool = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    kj = jpl.make_transfer_kernels(cfg_j, eng_j, make_test_mesh(2, 2))
    kt = tpl.make_transfer_kernels(cfg_t, eng_t)
    cj = {"layers": jax.tree.map(jnp.asarray, pool), "shared": None}
    ct = {"layers": params_from_numpy({n: a.copy() for n, a in pool.items()}),
          "shared": None}
    src = np.asarray([[[0, 2], [3, -1]], [[1, -1], [-1, -1]]], np.int32)
    dst = np.asarray([[[1, 3], [0, -1]], [[2, -1], [-1, -1]]], np.int32)
    cj = kj.copy(cj, jnp.asarray(src), jnp.asarray(dst))
    ct = kt.copy(ct, src, dst)
    for n in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(cj["layers"][n]),
                                      ct["layers"][n].numpy())
    out_j = kj.extract(cj, 1, 1, [0, 3])
    out_t = kt.extract(ct, 1, 1, [0, 3])
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(a, b.numpy())
    cj = kj.inject(cj, 0, 0, [2, 1], out_j)
    ct = kt.inject(ct, 0, 0, [2, 1], out_t)
    for n in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(cj["layers"][n]),
                                      ct["layers"][n].numpy())
