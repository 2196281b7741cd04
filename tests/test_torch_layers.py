"""PyTorch port — dense layers against the JAX reference on the same
numpy-seeded inputs: rms_norm, 1d/2d RoPE, attention_reference,
chunked_attention, the attention dispatch and mlp_apply, all at fp32 2e-5
(the reference's own layer tolerance)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as TL

torch.set_num_threads(2)
TOL = 2e-5


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(j, t, tol=TOL):
    err = float(np.max(np.abs(np.asarray(j, np.float32)
                              - t.float().numpy())))
    assert err < tol, err


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x), _both(w)
    _close(JL.rms_norm(jx, jw, 1e-5), TL.rms_norm(tx, tw, 1e-5))


@pytest.mark.parametrize("rope", ["1d", "2d"])
def test_apply_rope(rope):
    rng = np.random.default_rng(1)
    jc = dataclasses.replace(jget("chatglm3-6b").reduced(), rope=rope)
    tc = dataclasses.replace(tget("chatglm3-6b").reduced(), rope=rope)
    x = rng.normal(size=(2, 7, 4, jc.head_dim)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    _close(JL.apply_rope(jx, jp, jc), TL.apply_rope(tx, tp, tc))
    cj, sj = JL.rope_cos_sin(jp, 16, 10_000.0)
    ct, st = TL.rope_cos_sin(tp, 16, 10_000.0)
    _close(cj, ct)
    _close(sj, st)


def _qkv(seed, b, sq, sk, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]


ATTN_CASES = [
    # b, sq, sk, hq, hkv, causal, window, kv_offset, kv_len
    (2, 6, 6, 4, 2, True, 0, 0, None),            # prefill, GQA
    (2, 1, 9, 4, 2, False, 0, 0, [5, 9]),         # decode, ragged kv_len
    (2, 4, 12, 4, 4, True, 0, [3, 8], [7, 12]),   # append at row depths
    (3, 5, 11, 8, 2, True, 3, [2, 6, 0], None),   # windowed, g=4
    (2, 3, 8, 4, 2, True, 0, [0, 0], [0, 3]),     # fully masked row
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,causal,window,off,kv_len",
                         ATTN_CASES)
def test_attention_reference_and_chunked(b, sq, sk, hq, hkv, causal, window,
                                         off, kv_len):
    q, k, v = _qkv(2, b, sq, sk, hq, hkv, 16)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    jo = jo_t = off
    if isinstance(off, list):
        jo, jo_t = jnp.asarray(off, jnp.int32), torch.tensor(off)
    jl = tl = None
    if kv_len is not None:
        jl, tl = jnp.asarray(kv_len, jnp.int32), torch.tensor(kv_len)
    kw = dict(causal=causal, window=window)
    want = JL.attention_reference(jq, jk, jv, kv_offset=jo, kv_len=jl, **kw)
    _close(want, TL.attention_reference(tq, tk, tv, kv_offset=jo_t,
                                        kv_len=tl, **kw))
    # chunked online softmax, with chunks smaller than both lengths
    _close(JL.chunked_attention(jq, jk, jv, kv_offset=jo, kv_len=jl,
                                q_chunk=2, kv_chunk=3, **kw),
           TL.chunked_attention(tq, tk, tv, kv_offset=jo_t, kv_len=tl,
                                q_chunk=2, kv_chunk=3, **kw))


def test_attention_dispatch_takes_the_chunked_path_when_large():
    """sq * sk > 512² routes to the chunked path in both frameworks."""
    q, k, v = _qkv(3, 1, 520, 520, 2, 1, 8)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    jopt = JL.ModelOptions(attn_q_chunk=256, attn_kv_chunk=128)
    topt = TL.ModelOptions(attn_q_chunk=256, attn_kv_chunk=128)
    _close(JL.attention(jq, jk, jv, causal=True, opts=jopt),
           TL.attention(tq, tk, tv, causal=True, opts=topt))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(act):
    rng = np.random.default_rng(4)
    d, f = 32, 48
    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    _close(JL.mlp_apply(jp, jnp.asarray(x), act),
           TL.mlp_apply(tp, torch.from_numpy(x), act))


def test_unported_rope_raises():
    """Every rope kind of the reference is ported (M-RoPE is held to it in
    ``test_torch_families.py``); a kind outside them raises, as the
    reference's ``apply_rope`` does."""
    cfg = tget("chatglm3-6b").reduced()
    object.__setattr__(cfg, "rope", "alibi")  # past __post_init__'s check
    with pytest.raises(ValueError, match="alibi"):
        TL.apply_rope(torch.zeros(1, 2, 4, 16), torch.zeros(1, 2), cfg)


# ---------------------------------------------------------------------------
# The attention block in its dense modes, and the single-device LM
# ---------------------------------------------------------------------------


def _attn_params(rng, cfg):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {w: (rng.normal(size=(d, n * hd)) / np.sqrt(d)).astype(np.float32)
         for w, n in (("wq", h), ("wk", hkv), ("wv", hkv))}
    p["wo"] = (rng.normal(size=(h * hd, d)) / np.sqrt(h * hd)
               ).astype(np.float32)
    return p


@pytest.mark.parametrize("mode,s,window", [
    ("train", 6, 0), ("prefill", 6, 0), ("append", 3, 0), ("decode", 1, 0),
    ("decode", 1, 4),
])
def test_attn_apply_dense_modes(mode, s, window):
    """train / prefill / dense append / dense decode (ring buffer, with and
    without a window narrower than the strip): out and the written strips
    within 2e-5 of the reference, unwritten strip entries bit-equal."""
    from repro.models import blocks as JB
    from repro_torch.models import blocks as TB
    from repro_torch.models.lm import params_from_numpy
    jc, tc = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    rng = np.random.default_rng(5)
    p = _attn_params(rng, jc)
    b, s_max = 2, 12
    x = rng.normal(size=(b, s, jc.d_model)).astype(np.float32)
    cache = {n: rng.normal(size=(b, s_max, jc.n_kv_heads, jc.head_dim))
             .astype(np.float32) for n in ("k", "v")}
    off = np.asarray([3, 9 - s], np.int32) if mode != "prefill" \
        else np.zeros(b, np.int32)
    pos = off[:, None] + np.arange(s, dtype=np.int32)[None, :]
    kw_j = dict(pos=jnp.asarray(pos), mode=mode, window=window)
    kw_t = dict(pos=torch.from_numpy(pos), mode=mode, window=window)
    if mode != "train":
        kw_j.update(cache={n: jnp.asarray(a) for n, a in cache.items()},
                    kv_offset=jnp.asarray(off))
        kw_t.update(cache=params_from_numpy(cache),
                    kv_offset=torch.from_numpy(off))
    jout, jcache = JB.attn_apply(jc, JL.ModelOptions(),
                                 {n: jnp.asarray(a) for n, a in p.items()},
                                 jnp.asarray(x), **kw_j)
    tout, tcache = TB.attn_apply(tc, TL.ModelOptions(), params_from_numpy(p),
                                 torch.from_numpy(x), **kw_t)
    _close(jout, tout)
    if mode == "train":
        return
    for n in ("k", "v"):
        j, t = np.asarray(jcache[n]), tcache[n].numpy()
        same = j == cache[n]  # entries the reference left untouched
        np.testing.assert_array_equal(t[same], cache[n][same])
        assert np.max(np.abs(j - t)) < TOL


def test_lm_forward_prefill_decode_matches_reference():
    """lm.forward on the reference's weights (stage-padded stack, masked
    layer): prefill and decode logits within 2e-5, and the port's greedy
    oracle equals the reference's argmax chain."""
    import jax
    from repro.models import lm as JLM
    from repro_torch.models import lm as TLM
    jc, tc = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    params = JLM.init_params(jc, jax.random.PRNGKey(3), n_layers=5)
    tp = TLM.params_from_numpy(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, jc.vocab_size, (1, 7)).astype(np.int32)
    jcache = JLM.init_cache(jc, 1, 16, cache_dtype=jnp.float32, n_layers=5)
    tcache = TLM.init_cache(tc, 1, 16, cache_dtype=torch.float32, n_layers=5)
    jl, jcache = JLM.forward(jc, JL.ModelOptions(), params,
                             {"tokens": jnp.asarray(prompt)}, mode="prefill",
                             cache=jcache)[:2]
    tl, tcache, _ = TLM.forward(tc, TL.ModelOptions(), tp,
                                {"tokens": torch.from_numpy(prompt)},
                                mode="prefill", cache=tcache)
    _close(jl, tl)
    toks = [int(jnp.argmax(jl[0, -1]))]
    for t in range(3):
        off = np.asarray([7 + t], np.int32)
        tok = np.asarray([[toks[-1]]], np.int32)
        jl, jcache = JLM.forward(jc, JL.ModelOptions(), params,
                                 {"tokens": jnp.asarray(tok)}, mode="decode",
                                 cache=jcache, kv_offset=jnp.asarray(off))[:2]
        tl, tcache, _ = TLM.forward(tc, TL.ModelOptions(), tp,
                                    {"tokens": torch.from_numpy(tok)},
                                    mode="decode", cache=tcache,
                                    kv_offset=torch.from_numpy(off))
        _close(jl, tl)
        toks.append(int(jnp.argmax(jl[0, 0])))
    assert TLM.greedy_generate(tc, TL.ModelOptions(), tp, prompt[0], 4, 16,
                               torch.float32) == toks
