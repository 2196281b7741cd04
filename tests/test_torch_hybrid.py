"""PyTorch port — the hybrid family (zamba2-7b: a Mamba2 backbone with one
shared attention block) against the JAX reference on the same
numpy-seeded inputs and weights (carried across with
``params_from_numpy``):

* the config and its parameter counts, full (about 6.8 B) and reduced;
* ``gated_rms_norm``;
* ``mamba2_mix`` on ``tests/test_layers.py::test_mamba2_ssd_equals_step_decode``'s
  layer (s = 21 with chunk 8: two chunks and a padded third): the chunked
  SSD form, and the step-by-step decode with its conv state, each against
  JAX's ``mamba2_mix`` and against each other, at that test's 1e-4; from
  a nonzero incoming state too;
* ``hybrid_backbone_block`` (in-place states under a ``write_mask``) and
  ``shared_attn_block`` (prefill then decode into one site's strips);
* ``shared_site_flags`` / ``n_shared_sites`` at several stage offsets;
* reduced zamba2-7b ``lm.forward`` logits within 1e-4, prefill + decode
  and ``greedy_generate`` against the reference's oracle, and the
  windowed ring-buffer decode against the windowed full forward within
  5e-4 (``tests/test_models_smoke.py::test_sliding_window_ring_buffer_decode``);
* init: shapes and dtypes equal the reference's, the shared block
  included, ``dt_bias`` / ``A_log`` / ``D`` fp32 under bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import SSMConfig as JSSM
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.layers import ModelOptions as JOpts
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.tree import tree_items

torch.set_num_threads(2)
ARCH = "zamba2-7b"
TOL = 1e-4


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _cfgs():
    return jget(ARCH).reduced(), tget(ARCH).reduced()


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_param_counts_match_reference(reduced):
    ref, port = jget(ARCH), tget(ARCH)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for fn in ("param_count", "layer_param_count",
               "shared_block_param_count", "active_param_count"):
        assert getattr(port, fn)() == getattr(ref, fn)(), fn
    if not reduced:  # tests/test_configs.py: about 6.8 B
        assert abs(port.param_count() / 1e9 - 6.8) < 0.15 * 6.8
        assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
                port.head_dim, port.hybrid.attn_every) == (81, 3584, 32, 32,
                                                           112, 6)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_gated_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x, gate = (rng.normal(size=(2, 5, 32)).astype(np.float32)
               for _ in range(2))
    w = rng.normal(size=(32,)).astype(np.float32)
    want = JL.gated_rms_norm(jnp.asarray(x), jnp.asarray(gate),
                             jnp.asarray(w))
    got = TL.gated_rms_norm(*(torch.from_numpy(a) for a in (x, gate, w)))
    assert _err(want, got) < 2e-6


# tests/test_layers.py::test_mamba2_ssd_equals_step_decode's layer
M2 = dict(name="m2", family="hybrid", n_layers=2, d_model=32, n_heads=4,
          n_kv_heads=4, d_ff=64, vocab_size=64, rope="1d", head_dim=8)
M2_SSM = dict(kind="mamba2", d_state=8, d_conv=4, expand=2, head_dim=16,
              n_groups=2, chunk_size=8)


def _m2_layer():
    di, n, g, nh = 64, 8, 2, 4
    conv_dim = di + 2 * g * n
    rng = np.random.default_rng(1)
    r = lambda *shape, scale=1.0: (rng.normal(size=shape) * scale).astype(
        np.float32)
    p = {"in_proj": r(32, 2 * di + 2 * g * n + nh, scale=0.1),
         "conv_w": r(conv_dim, 4, scale=0.3),
         "conv_b": r(conv_dim, scale=0.1),
         "dt_bias": r(nh, scale=0.5),
         "A_log": r(nh, scale=0.1),
         "D": np.ones((nh,), np.float32),
         "norm_w": 1.0 + r(di, scale=0.1),
         "out_proj": r(di, 32, scale=0.1)}
    return p, conv_dim, (2, nh, 16, n)


def _m2_cfgs():
    return (JArch(ssm=JSSM(**M2_SSM), **M2), TArch(ssm=TSSM(**M2_SSM), **M2))


@pytest.mark.parametrize("state", [False, True])
def test_mamba2_mix_chunked_and_decode_match_reference(state):
    cfg_j, cfg_t = _m2_cfgs()
    p, conv_dim, st_shape = _m2_layer()
    pt = {n: torch.from_numpy(a) for n, a in p.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 21, 32)).astype(np.float32)
    h0 = (rng.normal(size=st_shape) * 0.5).astype(np.float32) if state \
        else None
    c0 = rng.normal(size=(2, 3, conv_dim)).astype(np.float32) if state \
        else None
    # the chunked SSD form: y, final state, conv window
    outs_j = JL.mamba2_mix(_jnp(p), jnp.asarray(x), cfg_j,
                           None if h0 is None else jnp.asarray(h0),
                           None if c0 is None else jnp.asarray(c0))
    outs_t = TL.mamba2_mix(pt, torch.from_numpy(x), cfg_t,
                           None if h0 is None else torch.from_numpy(h0),
                           None if c0 is None else torch.from_numpy(c0),
                           TOpts())
    for a, b in zip(outs_j, outs_t):
        assert a.shape == tuple(b.shape) and _err(a, b) < TOL
    # step by step through the decode branch, against JAX's and the chunks
    h = None if h0 is None else torch.from_numpy(h0)
    c = torch.from_numpy(c0) if state else torch.zeros((2, 3, conv_dim))
    hj = None if h0 is None else jnp.asarray(h0)
    cj = jnp.asarray(c.numpy())
    ys = []
    for t in range(21):
        yt, h, c = TL.mamba2_mix(pt, torch.from_numpy(x[:, t:t + 1]), cfg_t,
                                 h, c)
        yj, hj, cj = JL.mamba2_mix(_jnp(p), jnp.asarray(x[:, t:t + 1]),
                                   cfg_j, hj, cj)
        assert _err(yj, yt) < TOL and _err(hj, h) < TOL
        ys.append(yt)
    assert _err(outs_t[0], torch.cat(ys, 1)) < TOL
    assert _err(outs_t[1], h) < TOL and _err(outs_t[2], c) < TOL


def test_mamba2_mix_gradients_match_reference():
    """Gradients through the per-chunk checkpoints (the reference's
    ``jax.checkpoint`` on ``chunk_body``), w.r.t. x and every weight."""
    cfg_j, cfg_t = _m2_cfgs()
    p, _, _ = _m2_layer()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 21, 32)).astype(np.float32)
    ct = rng.normal(size=(2, 21, 32)).astype(np.float32)
    jg = jax.grad(lambda pp, xx: jnp.sum(
        JL.mamba2_mix(pp, xx, cfg_j)[0] * ct), argnums=(0, 1))(
        _jnp(p), jnp.asarray(x))
    pt = {n: torch.from_numpy(a).requires_grad_() for n, a in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    TL.mamba2_mix(pt, xt, cfg_t)[0].backward(torch.from_numpy(ct))
    assert _err(jg[1], xt.grad) < TOL
    for n, t in pt.items():
        assert _err(jg[0][n], t.grad) < TOL, n


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _layer_params(seed=0):
    cfg_j, _ = _cfgs()
    p = jax.tree.map(np.asarray, jlm.init_layer_params(
        cfg_j, jax.random.PRNGKey(seed), jnp.float32))
    return p, tlm.params_from_numpy(p)


def test_hybrid_backbone_block_matches_reference_in_place():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _layer_params(1)
    one = JB.layer_cache_shape(cfg_j, 2, 16, jnp.float32)
    rng = np.random.default_rng(4)
    cache = {n: rng.normal(size=s.shape).astype(np.float32)
             for n, s in one.items()}
    assert {n: (s.shape, s.dtype) for n, s in one.items()} == {
        n: (shape, jnp.float32) for n, (shape, _) in
        TB.layer_cache_shape(cfg_t, 2, 16, torch.float32).items()}
    x = rng.normal(size=(2, 7, cfg_j.d_model)).astype(np.float32)
    yj, cj, _ = JB.hybrid_backbone_block(
        cfg_j, JOpts(), _jnp(pj), jnp.asarray(x), pos=None,
        cache=_jnp(cache), mode="append")
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    wm = torch.tensor([True, False])  # row 1 rides along: states untouched
    yt, tc2, _ = TB.hybrid_backbone_block(
        cfg_t, TOpts(), pt, torch.from_numpy(x), pos=None, cache=tc,
        mode="append", write_mask=wm)
    assert tc2 is tc and _err(yj, yt) < TOL
    for n in cache:
        assert _err(cj[n][0], tc[n][0]) < TOL, n
        assert np.array_equal(tc[n][1].numpy(), cache[n][1]), n


def test_shared_attn_block_prefill_then_decode_matches_reference():
    cfg_j, cfg_t = _cfgs()
    pj = jax.tree.map(np.asarray, jlm.init_shared_params(
        cfg_j, jax.random.PRNGKey(5), jnp.float32))
    pt = tlm.params_from_numpy(pj)
    shape = JB.shared_cache_shape(cfg_j, 2, 12, jnp.float32)["k"].shape
    assert tuple(TB.shared_cache_shape(cfg_t, 2, 12)["k"][0]) == shape
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    jc = {n: jnp.zeros(shape) for n in ("k", "v")}
    tc = {n: torch.zeros(shape) for n in ("k", "v")}
    yj, jc = JB.shared_attn_block(cfg_j, JOpts(), _jnp(pj), jnp.asarray(x),
                                  pos=jnp.asarray(pos), cache=jc,
                                  mode="prefill")
    yt, tc = TB.shared_attn_block(cfg_t, TOpts(), pt, torch.from_numpy(x),
                                  pos=torch.from_numpy(pos.copy()), cache=tc,
                                  mode="prefill")
    assert _err(yj, yt) < TOL
    x1 = rng.normal(size=(2, 1, cfg_j.d_model)).astype(np.float32)
    off = np.asarray([9, 9], np.int32)
    yj, jc = JB.shared_attn_block(cfg_j, JOpts(), _jnp(pj), jnp.asarray(x1),
                                  pos=jnp.asarray(off[:, None]), cache=jc,
                                  kv_offset=jnp.asarray(off), mode="decode")
    yt, tc = TB.shared_attn_block(cfg_t, TOpts(), pt, torch.from_numpy(x1),
                                  pos=torch.from_numpy(off[:, None]),
                                  cache=tc, kv_offset=torch.from_numpy(off),
                                  mode="decode")
    assert _err(yj, yt) < TOL
    for n in ("k", "v"):
        assert _err(jc[n], tc[n]) < TOL


# ---------------------------------------------------------------------------
# shared-site bookkeeping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,offset,n_local", [
    ("zamba2-7b", 0, 81), ("zamba2-7b", 0, 41), ("zamba2-7b", 41, 41),
    ("zamba2-7b", 35, 12), ("zamba2-7b", 78, 6), ("reduced", 0, 3),
    ("reduced", 3, 3), ("reduced", 4, 1), ("chatglm3-6b", 0, 4)])
def test_shared_site_flags_match_reference(arch, offset, n_local):
    name = ARCH if arch == "reduced" else arch
    cfg_j, cfg_t = jget(name), tget(name)
    if arch == "reduced":
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    fj, sj = jlm.shared_site_flags(cfg_j, offset, n_local)
    ft, st = tlm.shared_site_flags(cfg_t, offset, n_local)
    assert list(np.asarray(fj)) == ft and list(np.asarray(sj)) == st
    assert tlm.n_shared_sites(cfg_t, offset, n_local) == \
        jlm.n_shared_sites(cfg_j, offset, n_local)
    assert tlm.n_shared_sites(cfg_t) == jlm.n_shared_sites(cfg_j)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _model(seed=0):
    cfg_j, cfg_t = _cfgs()
    p = jax.tree.map(np.asarray, jlm.init_params(
        cfg_j, jax.random.PRNGKey(seed), max_pos=32))
    return cfg_j, cfg_t, p, tlm.params_from_numpy(p)


def test_forward_prefill_decode_and_greedy_match_reference():
    cfg_j, cfg_t, p, pt = _model()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 21)).astype(np.int32)
    lj, _, _ = jlm.forward(cfg_j, JOpts(), _jnp(p),
                           {"tokens": jnp.asarray(toks)})
    lt, _, _ = tlm.forward(cfg_t, TOpts(), pt,
                           {"tokens": torch.from_numpy(toks)})
    assert _err(lj, lt) < TOL
    # prefill 9 tokens, then decode 12 one at a time: logits and caches
    jc = jlm.init_cache(cfg_j, 2, 24, cache_dtype=jnp.float32)
    tc = tlm.init_cache(cfg_t, 2, 24, cache_dtype=torch.float32)
    lj, jc, _ = jlm.forward(cfg_j, JOpts(), _jnp(p),
                            {"tokens": jnp.asarray(toks[:, :9])},
                            mode="prefill", cache=jc)
    lt, tc, _ = tlm.forward(cfg_t, TOpts(), pt,
                            {"tokens": torch.from_numpy(toks[:, :9])},
                            mode="prefill", cache=tc)
    assert _err(lj, lt) < TOL
    for t in range(9, 21):
        off = np.full((2,), t, np.int32)
        lj, jc, _ = jlm.forward(cfg_j, JOpts(), _jnp(p),
                                {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                mode="decode", cache=jc,
                                kv_offset=jnp.asarray(off))
        lt, tc, _ = tlm.forward(cfg_t, TOpts(), pt,
                                {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                mode="decode", cache=tc,
                                kv_offset=torch.from_numpy(off))
        assert _err(lj, lt) < TOL, t
    for (path, a), (_, b) in zip(tree_items(jax.tree.map(np.asarray, jc)),
                                 tree_items(tc)):
        assert _err(a, b) < TOL, path
    # the greedy oracle, against the reference's (tests/test_serve_engine)
    from test_serve_engine import oracle_tokens
    from repro.serve import Request
    req = Request(0, toks[0, :9], 6)
    pk = jax.tree.map(lambda a: jnp.asarray(a)[None], p)  # one trial row
    want = oracle_tokens(cfg_j, JOpts(), pk, req)
    assert tlm.greedy_generate(cfg_t, TOpts(), pt, toks[0, :9], 6, 24,
                               torch.float32) == want


def test_sliding_window_ring_buffer_decode():
    """Windowed decode with a window-sized ring-buffer shared cache equals
    the windowed full forward, and the reference's logits (5e-4, as
    ``tests/test_models_smoke.py``)."""
    cfg_j, cfg_t, p, pt = _model()
    toks = np.random.default_rng(8).integers(
        0, cfg_j.vocab_size, (2, 20)).astype(np.int32)
    w = 8
    full, _, _ = tlm.forward(cfg_t, TOpts(), pt,
                             {"tokens": torch.from_numpy(toks)}, window=w)
    fj, _, _ = jlm.forward(cfg_j, JOpts(), _jnp(p),
                           {"tokens": jnp.asarray(toks)}, window=w)
    assert _err(fj, full) < TOL
    cache = tlm.init_cache(cfg_t, 2, 32, cache_dtype=torch.float32, window=w)
    assert cache["shared"]["k"].shape[2] == w
    errs = []
    for t in range(20):
        ld, cache, _ = tlm.forward(
            cfg_t, TOpts(), pt, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            mode="decode", cache=cache, window=w,
            kv_offset=torch.full((2,), t, dtype=torch.int32))
        errs.append(_err(ld[:, 0], full[:, t]))
    assert max(errs) < 5e-4, errs


def test_init_matches_reference_shapes_and_dtypes():
    cfg_j, cfg_t = _cfgs()
    jp = jlm.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.bfloat16,
                         n_layers=6)
    tp = tlm.init_params(cfg_t, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, n_layers=6)
    want = {path: (tuple(a.shape), str(a.dtype))
            for path, a in tree_items(jax.tree.map(np.asarray, jp))}
    got = {path: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for path, t in tree_items(tp)}
    assert got == want
    assert "shared" in tp and tp["shared"]["mlp"]["w_up"].shape == (
        cfg_t.d_model, cfg_t.hybrid.shared_d_ff)
    for name in ("dt_bias", "A_log", "D"):
        assert tp["layers"]["mamba"][name].dtype == torch.float32
    fp = tlm.params_from_numpy(jax.tree.map(np.asarray, jp),
                               dtype=torch.bfloat16)
    assert fp["layers"]["mamba"]["D"].dtype == torch.float32
    assert fp["shared"]["attn"]["wq"].dtype == torch.bfloat16
