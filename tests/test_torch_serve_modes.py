"""PyTorch port — the ragged serving modes against the JAX reference on the
same weights (carried across with ``params_from_numpy``):

* ``attn_apply`` append with per-row ``q_lens`` (rows at 0 and at 1
  among full chunks) over the paged pool, kernel form (the plain version
  on the CPU) and gather form, and over dense strips (a row near the
  strip's end, whose padded tail must be dropped, not clamped back over
  its history): outputs at real positions within 2e-5, written cache
  entries within 2e-5, every other entry bit-equal to before;
* ``make_serve_step`` in ``mixed`` (the head at each row's ``qlens - 1``)
  and ``verify`` (the head at every position) over S = 2 stages, paged
  (kernel and gather, data_size 1 and 2) and dense: identical greedy
  tokens, ``logit_max`` within 2e-5, caches within 2e-5, unwritten
  entries untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve_pipeline import _attn_case, _err, _np

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


# ---------------------------------------------------------------------------
# attn_apply with q_lens
# ---------------------------------------------------------------------------

KV_LENS, Q_LENS, S = [5, 9, 2, 7], [3, 0, 1, 4], 4


def _real(q_lens, s):
    """(b, s) bool: each row's first q_lens positions."""
    return np.arange(s)[None, :] < np.asarray(q_lens)[:, None]


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("wmask", [None, [True, True, False, True]])
def test_attn_apply_paged_q_lens_matches_reference(kernel, wmask):
    p, x, pool, tables, off, pos = _attn_case(3, S, KV_LENS)
    ql = np.asarray(Q_LENS, np.int32)
    # padded positions clamp to each row's last real one, as the pipeline
    # passes them
    pos = np.minimum(pos, (off + np.maximum(ql - 1, 0))[:, None])
    jcfg, tcfg = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    wm = None if wmask is None else np.asarray(wmask)
    jout, jcache = jblocks.attn_apply(
        jcfg, JOpts(use_paged_kernel=kernel), jax.tree.map(jnp.asarray, p),
        jnp.asarray(x), pos=jnp.asarray(pos),
        cache=jax.tree.map(jnp.asarray, pool), kv_offset=jnp.asarray(off),
        mode="append", block_tables=jnp.asarray(tables),
        write_mask=None if wm is None else jnp.asarray(wm),
        q_lens=jnp.asarray(ql))
    tcache = params_from_numpy({n: a.copy() for n, a in pool.items()})
    tout, tcache = tblocks.attn_apply(
        tcfg, TOpts(use_paged_kernel=kernel), params_from_numpy(p),
        torch.from_numpy(x), pos=torch.from_numpy(pos), cache=tcache,
        kv_offset=torch.from_numpy(off), mode="append",
        block_tables=torch.from_numpy(tables),
        write_mask=None if wm is None else torch.from_numpy(wm),
        q_lens=torch.from_numpy(ql))
    real = _real(ql, S)
    assert _err(np.asarray(jout)[real], tout.numpy()[real]) < TOL
    assert np.isfinite(tout.numpy()).all()
    nb, bs = pool["k"].shape[:2]
    written = np.zeros((nb, bs), bool)
    for r in range(len(KV_LENS)):
        if wm is not None and not wm[r]:
            continue
        for q in range(ql[r]):
            t = off[r] + q
            written[tables[r, t // bs], t % bs] = True
    assert written.sum() == sum(int(q) for r, q in enumerate(ql)
                                if wm is None or wm[r])
    for n in ("k", "v"):
        got, ref = tcache[n].numpy(), np.asarray(jcache[n])
        np.testing.assert_array_equal(got[~written], pool[n][~written])
        assert _err(ref[written], got[written]) < TOL


def test_attn_apply_dense_q_lens_matches_reference():
    """Dense strips of 12 positions; row 1 sits at 10 with a 1-token
    chunk in a 4-wide wave, so two padded targets fall past the strip."""
    p, x, _, _, _, _ = _attn_case(4, S, KV_LENS)
    jcfg, tcfg = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    rng = np.random.default_rng(4)
    s_cache, b = 12, len(KV_LENS)
    cache = {n: rng.normal(size=(b, s_cache, jcfg.n_kv_heads, jcfg.head_dim))
             .astype(np.float32) for n in ("k", "v")}
    off = np.asarray([5, 10, 0, 8], np.int32)
    ql = np.asarray([3, 1, 0, 4], np.int32)
    pos = np.minimum(off[:, None] + np.arange(S)[None, :],
                     (off + np.maximum(ql - 1, 0))[:, None]).astype(np.int32)
    jout, jcache = jblocks.attn_apply(
        jcfg, JOpts(), jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        pos=jnp.asarray(pos), cache=jax.tree.map(jnp.asarray, cache),
        kv_offset=jnp.asarray(off), mode="append", q_lens=jnp.asarray(ql))
    tcache = params_from_numpy({n: a.copy() for n, a in cache.items()})
    tout, tcache = tblocks.attn_apply(
        tcfg, TOpts(), params_from_numpy(p), torch.from_numpy(x),
        pos=torch.from_numpy(pos), cache=tcache,
        kv_offset=torch.from_numpy(off), mode="append",
        q_lens=torch.from_numpy(ql))
    real = _real(ql, S)
    assert _err(np.asarray(jout)[real], tout.numpy()[real]) < TOL
    written = np.zeros((b, s_cache), bool)
    for r in range(b):
        written[r, off[r]:off[r] + ql[r]] = True
    for n in ("k", "v"):
        got, ref = tcache[n].numpy(), np.asarray(jcache[n])
        np.testing.assert_array_equal(got[~written], cache[n][~written])
        assert _err(ref[written], got[written]) < TOL


# ---------------------------------------------------------------------------
# make_serve_step: mixed and verify
# ---------------------------------------------------------------------------

MAX_SEQ, BS, NB, QLEN = 24, 4, 24, 5


def _steps(mode, data_size, paged, kernel):
    cfg_j = jget("chatglm3-6b").reduced()
    cfg_t = tget("chatglm3-6b").reduced()
    kw = dict(n_trials=1, n_microbatches=2, microbatch=2 // data_size,
              n_stages=2, data_size=data_size, max_seq=MAX_SEQ, paged=paged,
              block_size=BS, n_blocks=NB if paged else 0)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=MAX_SEQ)
    sj = jpl.make_serve_step(cfg_j, JOpts(use_paged_kernel=kernel), eng_j,
                             make_test_mesh(data_size, 2), mode,
                             with_active=True)
    st = tpl.make_serve_step(cfg_t, TOpts(use_paged_kernel=kernel), eng_t,
                             mode)
    return (cfg_j, eng_j, params, sj), (cfg_t, eng_t,
                                        params_from_numpy(_np(params)), st)


@pytest.mark.parametrize("mode", ["mixed", "verify"])
@pytest.mark.parametrize("data_size,paged,kernel", [
    (1, True, True), (2, True, True), (1, True, False), (1, False, False)])
def test_ragged_serve_step_matches_reference(mode, data_size, paged, kernel):
    (cfg_j, eng_j, pj, sj), (cfg_t, eng_t, pt, st) = _steps(
        mode, data_size, paged, kernel)
    rng = np.random.default_rng(6)
    mbg = 2
    # a full chunk, a decode row (1), an idle row (0) and a short chunk;
    # rows sit at ragged depths, one of them not block-aligned
    qlens = np.asarray([[[QLEN, 1], [0, 3]]], np.int32)
    positions = np.asarray([[[2, 9], [0, 6]]], np.int32)
    active = qlens > 0
    tokens = rng.integers(0, cfg_j.vocab_size,
                          (1, 2, mbg, QLEN)).astype(np.int32)
    batch = {"tokens": tokens, "positions": positions, "qlens": qlens,
             "active": active}
    per_shard = NB // data_size
    if paged:
        tables = np.full((1, 2, mbg, MAX_SEQ // BS), -1, np.int32)
        nxt = [0] * data_size
        for m in range(2):
            for b in range(mbg):
                if not active[0, m, b]:
                    continue
                sh = b // eng_j.microbatch
                need = -(-(positions[0, m, b] + qlens[0, m, b]) // BS)
                for j in range(need):
                    tables[0, m, b, j] = nxt[sh]
                    nxt[sh] += 1
                assert nxt[sh] <= per_shard
        batch["block_tables"] = tables
    cache_j = jpl.serve_cache_struct(cfg_j, eng_j, dry_run=False)
    cache_t = tpl.serve_cache_struct(cfg_t, eng_t, device="cpu")
    cache_j, tok_j, val_j = sj(pj, cache_j,
                               {n: jnp.asarray(a) for n, a in batch.items()})
    cache_t, tok_t, val_t = st(pt, cache_t,
                               {n: torch.from_numpy(a)
                                for n, a in batch.items()})
    tok_j, val_j = np.asarray(tok_j), np.asarray(val_j)
    tok_t, val_t = tok_t.numpy(), val_t.numpy()
    if mode == "verify":
        assert tok_t.shape == (1, 2, mbg, QLEN)
        real = np.arange(QLEN)[None, None, None, :] < qlens[..., None]
    else:
        assert tok_t.shape == (1, 2, mbg)
        real = active
    np.testing.assert_array_equal(tok_j[real], tok_t[real])
    assert _err(val_j[real], val_t[real]) < TOL
    # the written set: each active row's first qlens positions
    if paged:
        written = np.zeros((NB, BS), bool)
        for m in range(2):
            for b in range(mbg):
                off = (b // eng_j.microbatch) * per_shard
                for q in range(qlens[0, m, b]):
                    t = positions[0, m, b] + q
                    written[off + tables[0, m, b, t // BS], t % BS] = True
        idx = (slice(None), slice(None), written)  # (K, Lp, nb, bs, ...)
    else:
        written = np.zeros((1, 2, mbg, MAX_SEQ), bool)
        for m in range(2):
            for b in range(mbg):
                p0 = positions[0, m, b]
                written[0, m, b, p0:p0 + qlens[0, m, b]] = True
        idx = None
    for n in ("k", "v"):
        got, ref = cache_t["layers"][n].numpy(), np.asarray(
            cache_j["layers"][n])
        assert _err(ref, got) < TOL
        if idx is not None:
            keep = np.ones(got.shape[:4], bool)
            keep[idx] = False
        else:  # dense leaves (K, G, Lp, mbg, S, ...): written per row
            keep = ~np.broadcast_to(written[:, :, None],
                                    got.shape[:5])
        assert not got[keep].any(), "an unwritten entry changed"
        assert got[~keep].any()
