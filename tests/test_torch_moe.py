"""PyTorch port — the MoE family against the JAX reference on the same
numpy-seeded inputs and weights (``params_from_numpy``), on the CPU:

* the granite-moe-3b-a800m and llama4-scout-17b-a16e configs: fields,
  ``param_count``, ``active_param_count`` and ``reduced()`` equal to the
  reference's, and the reference's own published-size checks;
* ``layers.moe_apply`` against ``repro.models.layers.moe_apply``: outputs
  within 2e-5 and aux within 1e-6, dropless (64.0) and dropping (0.5,
  1.25), top-1 / 2 / 8, ``expert_chunk`` 0 and 2, a row of zeros (its
  router logits tie exactly, so the lower expert ids must win, as
  ``lax.top_k`` picks them), ``n_shards = 2`` against the reference
  applied to each half (its capacity, drops and aux per shard, the aux
  the mean of the two), and gradients against ``jax.grad`` within 2e-5;
  the reference's three MoE property cases (dropless equals the dense
  gate-weighted mixture, expert chunking equals none, capacity
  monotonicity);
* the bucket ranks (``moe_ranks``, a stable sort of the picks) bit-equal
  to the one-hot cumulative count and to the reference's ``pos`` over 1,
  2 and 4 shards, a ``held=`` window, every pick on two experts, router
  ties and the granite-4.0-h-small-l10 cell's routing shape, with
  ``moe_apply``'s output and gradients bit-equal under either rank;
* the model on reduced granite and reduced llama4-scout: ``moe_block``,
  ``lm.forward`` logits and aux, ``lm.loss_fn`` (``coef · aux /
  n_layers``), prefill then decode against the full forward (the
  reference's 5e-4) and against the reference's logits, greedy tokens;
* the planner: ``per_chip_bytes``, ``max_concurrent_trials`` and
  ``plan_serve_capacity`` for granite equal to the reference's field by
  field (budgets matched as in ``test_torch_hydra.py`` /
  ``test_torch_capacity.py``);
* ``kernel_options`` turns K1 on for the moe family, and the port's own
  init draws the moe leaves over the stage-padded stack.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.layers import ModelOptions as JOpts
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy

torch.set_num_threads(2)
ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
TOL, AUX_TOL = 2e-5, 1e-6


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_configs_match_reference(name, reduced):
    ref, port = jget(name), tget(name)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.layer_param_count() == ref.layer_param_count()
    assert port.active_param_count() == ref.active_param_count()
    if not reduced:  # tests/test_configs.py's published sizes
        nb = {ARCHS[0]: 3.4, ARCHS[1]: 101.7}[name]
        assert abs(port.param_count() / 1e9 - nb) < 0.15 * nb
        assert port.active_param_count() < port.param_count()
    if name == ARCHS[0] and not reduced:
        assert port.layer_param_count() == 100_727_808
        assert (port.moe.n_experts, port.moe.top_k, port.head_dim,
                port.n_heads // port.n_kv_heads) == (40, 8, 64, 3)
    if name == ARCHS[1] and not reduced:
        assert 9e9 < port.active_param_count() < 13e9
        assert (port.moe.n_experts, port.moe.top_k) == (16, 1)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _moe_case(seed, e, f=12, d=16, b=4, s=6, zero_row=False):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)) / 4,
         "w_gate": rng.normal(size=(e, d, f)) / 4,
         "w_up": rng.normal(size=(e, d, f)) / 4,
         "w_down": rng.normal(size=(e, f, d)) / 4}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    if zero_row:
        x[1] = 0.0  # router logits tie exactly on every token of row 1
    return p, x


def _jax_moe(p, x, n_shards=1, **kw):
    """The reference applied to each of ``n_shards`` row groups; the
    shards' aux averaged."""
    outs, auxes = [], []
    for xs in np.split(x, n_shards):
        o, a = JL.moe_apply(_jnp(p), jnp.asarray(xs), **kw)
        outs.append(np.asarray(o))
        auxes.append(float(a))
    return np.concatenate(outs), float(np.mean(auxes))


# (experts, top_k, capacity factor, expert_chunk, zero row, n_shards)
MOE_CASES = [
    (8, 2, 64.0, 0, False, 1),
    (8, 2, 0.5, 0, False, 1),
    (8, 2, 1.25, 0, False, 1),
    (8, 2, 1.25, 2, False, 1),
    (4, 1, 1.25, 0, False, 1),
    (16, 1, 64.0, 0, False, 1),
    (40, 8, 1.25, 0, False, 1),
    (40, 8, 64.0, 2, False, 1),
    (8, 2, 0.5, 0, True, 1),
    (40, 8, 1.25, 0, True, 1),
    (8, 2, 0.5, 0, False, 2),
    (8, 2, 1.25, 2, True, 2),
    (40, 8, 1.25, 0, False, 2),
    (4, 1, 0.5, 0, False, 2),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_moe_apply_matches_reference(case):
    e, k, cf, chunk, zero_row, n_shards = case
    p, x = _moe_case(0, e, zero_row=zero_row)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, expert_chunk=chunk)
    jo, ja = _jax_moe(p, x, n_shards, **kw)
    to, ta = TL.moe_apply(params_from_numpy(p), torch.from_numpy(x),
                          n_shards=n_shards, **kw)
    assert _err(jo, to) < TOL
    assert abs(ja - float(ta)) < AUX_TOL
    if cf < 2.0 and e >= 8 and k < 8:  # the case really drops picks
        dropless, _ = _jax_moe(p, x, n_shards, **dict(kw,
                                                      capacity_factor=64.0))
        assert _err(jo, dropless) > 1e-3


def test_moe_zero_row_ties_go_to_the_lower_expert_ids():
    """A row of zeros gives every expert the same probability: the k picks
    are experts 0..k-1 (``lax.top_k``'s rule), each gated 1/k."""
    e, k = 8, 3
    p, x = _moe_case(1, e, zero_row=True)
    xt = torch.from_numpy(x)
    _, gates, idx, _, _ = TL.moe_route(torch.from_numpy(p["router"]), xt,
                                       n_experts=e, top_k=k,
                                       capacity_factor=64.0)
    s = x.shape[1]  # row 1's tokens are (shard 0) tokens s..2s-1
    assert torch.equal(idx[0, s:2 * s], torch.arange(k).expand(s, k))
    assert torch.allclose(gates[0, s:2 * s], torch.full((s, k), 1.0 / k))
    out, _ = TL.moe_apply(params_from_numpy(p), xt, n_experts=e, top_k=k,
                          capacity_factor=64.0)
    jo, _ = _jax_moe(p, x, n_experts=e, top_k=k, capacity_factor=64.0)
    assert _err(jo, out) < TOL


def test_moe_n_shards_route_each_shard_alone():
    """Two shards at a dropping capacity differ from one routing over all
    rows (capacity, ranks and aux are per shard): the shard split is what
    the reference computes, the pooled call is not."""
    p, x = _moe_case(2, 8)
    kw = dict(n_experts=8, top_k=2, capacity_factor=0.5)
    pooled, pa = TL.moe_apply(params_from_numpy(p), torch.from_numpy(x),
                              **kw)
    split, sa = TL.moe_apply(params_from_numpy(p), torch.from_numpy(x),
                             n_shards=2, **kw)
    jo, ja = _jax_moe(p, x, 2, **kw)
    assert _err(jo, split) < TOL and abs(ja - float(sa)) < AUX_TOL
    assert _err(jo, pooled) > 1e-3
    with pytest.raises(ValueError, match="shards"):
        TL.moe_apply(params_from_numpy(p), torch.from_numpy(x), n_shards=3,
                     **kw)


@pytest.mark.parametrize("cf,chunk,n_shards", [(64.0, 0, 1), (1.25, 0, 1),
                                               (1.25, 2, 2), (0.5, 0, 2)])
def test_moe_gradients_match_jax_grad(cf, chunk, n_shards):
    e, k = 8, 2
    p, x = _moe_case(3, e, zero_row=True)
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, expert_chunk=chunk)

    def jf(p, x):
        outs, aux = [], 0.0
        for xs in jnp.split(x, n_shards):
            o, a = JL.moe_apply(p, xs, **kw)
            outs.append(o)
            aux = aux + a / n_shards
        return jnp.sum(jnp.concatenate(outs) * w) + aux

    gp, gx = jax.grad(jf, argnums=(0, 1))(_jnp(p), jnp.asarray(x))
    pt = {n: t.requires_grad_() for n, t in params_from_numpy(p).items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = TL.moe_apply(pt, xt, n_shards=n_shards, **kw)
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    assert _err(gx, xt.grad) < TOL
    for n in p:
        assert _err(gp[n], pt[n].grad) < TOL, n


# the bucket ranks: ``moe_ranks`` (a stable sort of the picks) against the
# one-hot cumulative count it replaced and the reference's own ``pos``


def _onehot_ranks(flat_e, e):
    """The one-hot cumulative count of each pick's expert in flat order,
    (G, t·k) as ``moe_ranks`` gives it (the oracle)."""
    onehot = (flat_e[..., None] == torch.arange(e)).to(torch.int32)
    return torch.cumsum(onehot, dim=1).gather(2, flat_e[..., None])[..., 0] - 1


def _jax_route(p, x, n_shards, e, k):
    """Each shard's expert ids and ``pos`` by the reference's lines of
    ``repro.models.layers.moe_apply``: (G, t, k), (G, t·k)."""
    ids, pos = [], []
    for xs in np.split(x, n_shards):
        xf = jnp.asarray(xs.reshape(-1, xs.shape[-1]))
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, jnp.asarray(
            p["router"])).astype(jnp.float32), axis=-1)
        _, idx = jax.lax.top_k(probs, k)
        flat = idx.reshape(-1)
        onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
        ids.append(np.asarray(idx))
        pos.append(np.asarray((jnp.cumsum(onehot, axis=0) * onehot)
                              .sum(axis=-1) - 1))
    return np.stack(ids), np.stack(pos)


# (name, experts, top_k, capacity factor, n_shards, held, rows, seq)
RANK_CASES = [
    ("shards1", 8, 2, 1.25, 1, None, 4, 6),
    ("shards2-top1", 16, 1, 1.25, 2, None, 4, 6),
    ("shards4", 40, 8, 1.25, 4, None, 4, 6),
    ("held", 8, 2, 1.25, 2, (2, 3), 4, 6),
    ("one-expert", 8, 2, 0.5, 1, None, 4, 6),
    ("ties", 8, 3, 0.5, 2, None, 4, 6),
    ("cell", 72, 10, 2.0, 1, None, 1, 4096),
]


@pytest.mark.parametrize("case", RANK_CASES, ids=lambda c: c[0])
def test_moe_ranks_match_onehot_count_and_reference(case, monkeypatch):
    """``moe_route``'s ranks bit-equal to the one-hot cumulative count and
    to the reference's ``pos`` on the reference's own expert ids; and
    ``moe_apply``'s output and gradients bit-equal with the one-hot ranks
    in its place. "one-expert" sends every token's picks to experts 5 and
    3 (the deepest overflow), "ties" has a row of zeros (every expert
    ties), "cell" is the granite-4.0-h-small-l10 cell's routing shape
    (t 4096, top-10 of 72, C 1137)."""
    name, e, k, cf, n_shards, held, b, s = case
    p, x = _moe_case(7, e, b=b, s=s, zero_row=name == "ties")
    if name == "one-expert":
        p["router"][:] = 0.0
        p["router"][0, 5], p["router"][0, 3] = 4.0, 2.0
        x[..., 0] = np.abs(x[..., 0]) + 1.0
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
    pt = params_from_numpy(p)
    _, _, idx, rank, cap = TL.moe_route(pt["router"], torch.from_numpy(x),
                                        n_shards=n_shards, **kw)
    if name == "cell":
        assert cap == 1137
    flat_e = idx.reshape(n_shards, -1)
    oracle = _onehot_ranks(flat_e, e)
    assert rank.dtype == torch.int64 and torch.equal(rank, oracle)
    j_ids, j_pos = _jax_route(p, x, n_shards, e, k)
    assert np.array_equal(j_ids, idx.numpy())
    assert np.array_equal(j_pos, rank.numpy())
    if name == "one-expert":
        assert torch.equal(rank[0, ::k], torch.arange(b * s))
        assert int((rank >= cap).sum()) == 2 * (b * s - cap)

    if held is not None:
        first, n = held
        for w in ("w_gate", "w_up", "w_down"):
            p[w] = p[w][first:first + n]
    seed = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def run():
        pg = {n_: t.requires_grad_() for n_, t in params_from_numpy(p).items()}
        xg = torch.from_numpy(x).requires_grad_()
        out, aux = TL.moe_apply(pg, xg, n_shards=n_shards, held=held, **kw)
        ((out * torch.from_numpy(seed)).sum() + aux).backward()
        return out.detach(), aux.detach(), xg.grad, {
            n_: t.grad for n_, t in pg.items()}

    new = run()
    monkeypatch.setattr(TL, "moe_ranks", _onehot_ranks)
    old = run()
    for a, o in zip(new[:3], old[:3]):
        assert torch.equal(a, o)
    for n_ in p:
        assert torch.equal(new[3][n_], old[3][n_]), n_


# the reference's MoE property cases (tests/test_layers.py,
# tests/test_property.py), on the port


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32))


def test_moe_dropless_equals_dense_mixture():
    rng = np.random.default_rng(5)
    d, e, f = 16, 4, 8
    p = {"router": _rand(rng, d, e, scale=0.5),
         "w_gate": _rand(rng, e, d, f, scale=0.3),
         "w_up": _rand(rng, e, d, f, scale=0.3),
         "w_down": _rand(rng, e, f, d, scale=0.3)}
    x = _rand(rng, 2, 12, d)
    out, aux = TL.moe_apply(p, x, n_experts=e, top_k=2, capacity_factor=64.0)
    probs = torch.softmax(x @ p["router"], dim=-1)
    gv, gi = torch.topk(probs, 2, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    dense = torch.zeros_like(x)
    for ei in range(e):
        ye = (torch.nn.functional.silu(x @ p["w_gate"][ei])
              * (x @ p["w_up"][ei])) @ p["w_down"][ei]
        dense += ye * torch.where(gi == ei, gv, 0.0).sum(-1)[..., None]
    assert _err(out, dense) < 2e-5
    assert float(aux) > 0


def test_moe_expert_chunking_matches_unchunked():
    rng = np.random.default_rng(6)
    d, e, f = 16, 8, 8
    p = {"router": _rand(rng, d, e, scale=0.5),
         "w_gate": _rand(rng, e, d, f, scale=0.3),
         "w_up": _rand(rng, e, d, f, scale=0.3),
         "w_down": _rand(rng, e, f, d, scale=0.3)}
    x = _rand(rng, 2, 12, d)
    o1, _ = TL.moe_apply(p, x, n_experts=e, top_k=2, capacity_factor=2.0)
    o2, _ = TL.moe_apply(p, x, n_experts=e, top_k=2, capacity_factor=2.0,
                         expert_chunk=2)
    assert _err(o1, o2) < 1e-5


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 4))
def test_moe_capacity_monotonicity(seed, top_k):
    rng = np.random.default_rng(seed)
    d, e = 8, 4
    p = {"router": _rand(rng, d, e), "w_gate": _rand(rng, e, d, 8, scale=.3),
         "w_up": _rand(rng, e, d, 8, scale=.3),
         "w_down": _rand(rng, e, 8, d, scale=.3)}
    x = _rand(rng, 1, 10, d)
    lo, _ = TL.moe_apply(p, x, n_experts=e, top_k=top_k, capacity_factor=0.5)
    hi, _ = TL.moe_apply(p, x, n_experts=e, top_k=top_k,
                         capacity_factor=99.0)
    assert torch.isfinite(lo).all() and torch.isfinite(hi).all()
    assert float(torch.linalg.norm(lo)) <= float(torch.linalg.norm(hi)) + 1e-3


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _model(name, cf=64.0, n_layers=None):
    cfg_j, cfg_t = jget(name).reduced(), tget(name).reduced()
    if n_layers:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    p = jlm.init_params(cfg_j, jax.random.PRNGKey(0), max_pos=64)
    return (cfg_j, cfg_t, p, params_from_numpy(jax.tree.map(np.asarray, p)),
            JOpts(moe_capacity_factor=cf), TOpts(moe_capacity_factor=cf))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_moe_block_matches_reference(mode):
    cfg_j, cfg_t, p, pt, oj, ot = _model(ARCHS[0], cf=1.25)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 8, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (4, 8)).copy()
    pj = jax.tree.map(lambda a: a[0], p["layers"])
    cj = ct = None
    if mode == "prefill":
        shape = (4, 12, cfg_j.n_kv_heads, cfg_j.head_dim)
        cj = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
        ct = {n: torch.zeros(shape) for n in ("k", "v")}
    yj, cj, aj = JB.moe_block(cfg_j, oj, pj, jnp.asarray(x),
                              pos=jnp.asarray(pos), cache=cj, mode=mode)
    yt, ct, at = TB.moe_block(cfg_t, ot, tlm.layer_slice(pt["layers"], 0),
                              torch.from_numpy(x), pos=torch.from_numpy(pos),
                              cache=ct, mode=mode)
    assert _err(yj, yt) < TOL and abs(float(aj) - float(at)) < AUX_TOL
    if mode == "prefill":
        for n in ("k", "v"):
            assert _err(cj[n], ct[n]) < TOL
    # the other families' blocks return a zero aux
    dense = tget("chatglm3-6b").reduced()
    pd = tlm.init_params(dense, torch.Generator().manual_seed(0))
    _, _, zero = TB.dense_block(dense, TOpts(), tlm.layer_slice(
        pd["layers"], 0), torch.from_numpy(x), pos=torch.from_numpy(pos))
    assert zero.dtype == torch.float32 and float(zero) == 0.0


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cf", [64.0, 1.25])
def test_forward_logits_aux_and_loss_match_reference(name, cf):
    cfg_j, cfg_t, p, pt, oj, ot = _model(name, cf)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg_j.vocab_size, (2, 12)).astype(np.int32)
    lj, _, aj = jlm.forward(cfg_j, oj, p, {"tokens": jnp.asarray(toks)})
    lt, _, at = tlm.forward(cfg_t, ot, pt, {"tokens": torch.from_numpy(toks)})
    assert _err(lj, lt) < 1e-4
    assert abs(float(aj) - float(at)) < AUX_TOL * cfg_t.n_layers
    assert float(at) > 0
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(labels)}
    ref = float(jlm.loss_fn(cfg_j, oj, p, batch_j))
    got = tlm.loss_fn(cfg_t, ot, pt, batch_t)
    assert abs(ref - float(got)) < TOL
    ce = tlm.cross_entropy(lt, batch_t["labels"])
    # fp32: the difference of two numbers near 5 is good to about 1e-6
    assert float(got - ce) == pytest.approx(
        cfg_t.moe.load_balance_coef * float(at) / cfg_t.n_layers, abs=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_consistency_and_greedy(name):
    """tests/test_models_smoke.py's prefill-then-decode case at 64.0: the
    port's prefill and decode logits equal its own full forward within
    5e-4 and the reference's within 1e-4; greedy tokens equal."""
    cfg_j, cfg_t, p, pt, oj, ot = _model(name)
    toks = np.random.default_rng(9).integers(
        0, cfg_j.vocab_size, (2, 16)).astype(np.int32)
    full, _, _ = tlm.forward(cfg_t, ot, pt, {"tokens": torch.from_numpy(toks)})
    cache = tlm.init_cache(cfg_t, 2, 32, cache_dtype=torch.float32)
    jcache = jlm.init_cache(cfg_j, 2, 32, cache_dtype=jnp.float32)
    lt, cache, _ = tlm.forward(cfg_t, ot, pt,
                               {"tokens": torch.from_numpy(toks[:, :8])},
                               mode="prefill", cache=cache)
    lj, jcache, _ = jlm.forward(cfg_j, oj, p,
                                {"tokens": jnp.asarray(toks[:, :8])},
                                mode="prefill", cache=jcache)
    errs = [_err(lt, full[:, :8])]
    assert _err(lj, lt) < 1e-4
    for t in range(8, 16):
        off = np.full((2,), t, np.int32)
        lt, cache, _ = tlm.forward(
            cfg_t, ot, pt, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            mode="decode", cache=cache, kv_offset=torch.from_numpy(off))
        lj, jcache, _ = jlm.forward(
            cfg_j, oj, p, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            mode="decode", cache=jcache, kv_offset=jnp.asarray(off))
        errs.append(_err(lt[:, 0], full[:, t]))
        assert _err(lj, lt) < 1e-4, t
    assert max(errs) < 5e-4, errs
    prompt = toks[0, :7]
    want = []
    logits, c, _ = jlm.forward(cfg_j, oj, p, {"tokens": jnp.asarray(
        prompt[None])}, mode="prefill", cache=jlm.init_cache(
        cfg_j, 1, 16, cache_dtype=jnp.float32))
    want.append(int(jnp.argmax(logits[0, -1])))
    for t in range(4):
        logits, c, _ = jlm.forward(
            cfg_j, oj, p, {"tokens": jnp.asarray([[want[-1]]])},
            mode="decode", cache=c, kv_offset=jnp.asarray([7 + t]))
        want.append(int(jnp.argmax(logits[0, 0])))
    assert tlm.greedy_generate(cfg_t, ot, pt, prompt, 5, 16,
                               torch.float32) == want


def test_init_params_and_kernel_options():
    cfg = tget(ARCHS[0]).reduced()
    assert TL.kernel_options(cfg).use_flash_kernel
    assert not TL.kernel_options(cfg).use_mamba_kernel
    eng = tpl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                           n_stages=3)
    plan = tpl.plan_stages(cfg, 3)  # 4 layers over 3 stages: 6 padded
    params = tpl.init_trial_params(cfg, eng, plan,
                                   torch.Generator().manual_seed(0))
    moe = params["layers"]["moe"]
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_d_ff
    assert moe["router"].shape == (2, 6, d, e)
    assert moe["w_gate"].shape == moe["w_up"].shape == (2, 6, e, d, f)
    assert moe["w_down"].shape == (2, 6, e, f, d)
    assert "mlp" not in params["layers"]
    jp = jlm.init_params(jget(ARCHS[0]).reduced(), jax.random.PRNGKey(0))
    assert {n: a.shape[1:] for n, a in jp["layers"]["moe"].items()} == {
        n: tuple(t.shape[2:]) for n, t in moe.items()}
    # the port's own weights run through its model
    p0 = tlm.layer_slice(params, 0)
    p0["embed"] = {"tok": p0["embed"]["tok"]}
    logits, _, aux = tlm.forward(cfg, TOpts(), p0, {
        "tokens": torch.zeros((1, 5), dtype=torch.int32)})
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers,s,mb,seq", [(8, 2, 1, 2048), (0, 2, 1, 2048),
                                               (0, 4, 2, 4096)])
def test_training_planner_matches_reference(n_layers, s, mb, seq,
                                            monkeypatch):
    cfg_j, cfg_t = jget(ARCHS[0]), tget(ARCHS[0])
    if n_layers:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    kw = dict(n_trials=1, n_microbatches=5, microbatch=mb, n_stages=s)
    eng_j, eng_t = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    monkeypatch.setattr(jsched, "HBM_BYTES_PER_CHIP",
                        tsched.HBM_BYTES_PER_CHIP / s)
    ref_bytes = {"param_bytes": 2, "opt_bytes_per_param": 12}
    monkeypatch.setattr(tsched, "state_bytes", lambda dtype: ref_bytes)
    for train in (True, False):
        assert (dataclasses.astuple(
            jsched.per_chip_bytes(cfg_j, eng_j, seq, train))
            == dataclasses.astuple(tsched.per_chip_bytes(
                cfg_t, eng_t, seq, train, **ref_bytes)))
        assert (jsched.max_concurrent_trials(cfg_j, eng_j, seq, train)
                == tsched.max_concurrent_trials(cfg_t, eng_t, seq, train))


GIB = 1024 ** 3


@pytest.mark.parametrize("s,dp,gib,max_seq,kw", [
    (2, 1, 8, 4096, {}),
    (2, 1, 6, 1056, {"paged": True, "expected_seq": 600}),
    (2, 2, 10, 2048, {"paged": True, "block_size": 32}),
    (1, 1, 20, 1056, {"paged": True, "hit_rate": 0.5,
                      "mix": [(3.0, 800), (1.0, 200)]}),
])
def test_plan_serve_capacity_matches_reference(s, dp, gib, max_seq, kw):
    base = dict(n_trials=1, n_microbatches=1, microbatch=2, n_stages=s,
                data_size=dp, max_seq=0)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.bfloat16, **base)
    eng_t = tpl.EngineConfig(cache_dtype=torch.bfloat16, **base)
    j = jsched.plan_serve_capacity(jget(ARCHS[0]), eng_j, max_seq,
                                   hbm_bytes=gib * GIB, **kw)
    t = tsched.plan_serve_capacity(tget(ARCHS[0]), eng_t, max_seq,
                                   hbm_bytes=gib * GIB * s, **kw)
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "cache_dtype":
            a, b = str(a).split(".")[-1], jnp.dtype(b).name
        assert a == b, (f.name, a, b)
