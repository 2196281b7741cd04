"""PyTorch port — the hybrid_moe family (granite-4.0-h-small: Mamba2 and
NoPE attention layers by ``layer_types``, each followed by a routed MoE
with a shared expert, the four multipliers, a tied head), against the
plain fp32 reference of ``bench/reference/hybrid_moe_model.py`` at a
small size on the CPU, with every mechanism present: both layer kinds,
more experts than the layer holds, the shared expert, every multiplier
away from 1, the tied embedding.

* the published config's parameter counts, its layer pattern, its
  registration beside the reference's registry, and the planner and the
  dry-run counting it;
* the forward (logits and load-balance term), the loss and every
  gradient of the single-device model against the reference;
* two AdamW steps of the pipelined Hydra step at K 2, S 2 (remat on, a
  stage-padded stack) against the reference trial by trial;
* the expert share: the held parts of 4 and 8 cards' shares, with the
  mixer and the shared expert counted once, add up to the uncut layer;
* the spans and counters: tracing changes no number, each mixer and MoE
  run is a span with its kind and layer, the MoE counters reach the
  tracer in the step's own readback;
* what the family refuses: a device layout, serving.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's reference and weights
    sys.path.insert(0, str(ROOT))

from bench.drivers import train_hybrid_moe as drv  # noqa: E402
from bench.harness import hybrid_moe as H  # noqa: E402
from bench.harness import traffic as T  # noqa: E402
from bench.harness.sizes import Sizes  # noqa: E402
from bench.reference import hybrid_moe_model as ref  # noqa: E402
from bench.reference import hybrid_moe_train as ref_train  # noqa: E402
from bench.reference.model import Precision  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import TRAIN_4K  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core.partitioner import (balance_report,  # noqa: E402
                                          plan_stages)
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import ModelOptions  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CONFIG = json.loads((ROOT / "bench" / "configs"
                     / "granite-4.0-h-small-l10.json").read_text())
SEED = 2 ** 31 + 5


def small(layers=("mamba", "mamba", "attention", "mamba", "mamba"),
          cards: int = 4, card: int = 1, held: int = 3, top_k: int = 4):
    """The cell's configuration at a CPU test's size: experts ``held``
    of card ``card`` out of ``cards``, five layers (attention third)."""
    conf = dict(CONFIG, layer_types=list(layers), num_local_experts=held,
                num_experts_per_tok=top_k, mamba_d_state=8, mamba_d_head=16,
                mamba_chunk_size=8,
                expert_parallel={"cards": cards, "card": card})
    sizes = Sizes(name="granite-small", family="decoder",
                  n_layers=len(layers), d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=32, vocab_size=96, norm_eps=1e-5,
                  act="swiglu", rope="none")
    return H.hybrid_of(conf, sizes)


def _tree_leaf(tree, path):
    for name in path.split("/"):
        tree = tree[name]
    return tree


def test_published_config():
    cfg = configs.get_config("granite-4.0-h-small")
    assert cfg.name not in configs.list_archs()  # the reference's twelve
    assert cfg.layer_types.count("attention") == 4
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] \
        == [5, 15, 25, 35]
    assert cfg.ssm.n_ssm_heads(cfg.d_model) == 128
    assert cfg.param_count() == pytest.approx(32.2e9, rel=0.01)
    assert cfg.active_param_count() == pytest.approx(8.8e9, rel=0.03)
    cut = dataclasses.replace(cfg, n_layers=10, layer_types=cfg.layer_types[
        :10], n_held_experts=9, vocab_size=12544)
    assert cut.layer_param_count(0) == 206_399_104
    assert cut.layer_param_count(5) == 146_055_168
    assert cut.param_count() == pytest.approx(2.055e9, rel=1e-3)
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(cfg, n_layers=39)


def test_the_reduced_config_trains():
    """``reduced()`` keeps every mechanism at a CPU test's size (both
    kinds, 3 of 8 experts held from id 2, the shared expert, the
    multipliers, the tied head): the pipelined step at K 2, S 2 with remat
    over its five layers padded to six."""
    cfg = configs.get_config("granite-4.0-h-small").reduced()
    assert cfg.held_experts == (2, 3) and cfg.tie_embeddings
    eng = pl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                          n_stages=2)
    gen = torch.Generator().manual_seed(0)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen)
    assert params["layers"][5] == {} and "attn" in params["layers"][2]
    assert "head" not in params
    opt = AdamW(grad_clip=1.0)
    state = opt.init(params)
    step = pl.make_train_step(cfg, ModelOptions(remat=True), eng, opt)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 1, 16), generator=gen)
    hp = {"lr": torch.tensor([1e-3, 2e-3]), "wd": torch.tensor([0.0, 0.1])}
    for i in range(2):
        params, state, met = step(params, state, {
            "tokens": tokens, "labels": tokens.roll(1, -1)}, hp, i)
        assert torch.isfinite(torch.as_tensor(met["loss"])).all()
        assert (met["grad_norm"] > 0).all()


def test_planner_and_dry_run_count_it():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = configs.get_config("granite-4.0-h-small")
    eng = pl.EngineConfig(n_trials=1, n_microbatches=4, microbatch=1,
                          n_stages=4)
    est = sched.per_chip_bytes(cfg, eng, 4096, train=True)
    plan = plan_stages(cfg, 4)
    worst = max(sum(cfg.layer_param_count(i)
                    for i in range(s * 10, s * 10 + 10)) for s in range(4))
    vocab = cfg.vocab_size * cfg.d_model // 4  # tied, vocab-parallel
    assert est.params_bytes == 4 * (worst + vocab + cfg.d_model)
    assert plan.layers_per_stage == 10
    loads = balance_report(cfg, plan, 4096)["per_stage_flops_per_token"]
    assert len(set(loads)) == 1  # each stage holds one period
    row = dryrun.run_cell(cfg, TRAIN_4K, make_production_mesh(), {})
    assert row["model_flops"] > 0 and row["modeled_bytes_per_device"] > 0


def _objective(ce, aux, hy):
    return ce + hy.aux_coef * aux


def test_forward_loss_and_gradients_match_the_reference():
    hy = small()
    cfg = drv.arch_config(hy)
    tree = H.trial_tree(hy, 1, 1, SEED, "cpu")
    params = pl.unstack_trials(tree)[0]
    params["layers"] = [{n: v for n, v in p.items()} for p in
                        params["layers"]]
    for t in tree_leaves(params):
        t.requires_grad_()
    tokens = torch.randint(0, hy.sizes.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(3))
    labels = tokens.roll(-1, 1)
    no_drops = ModelOptions(moe_capacity_factor=2.0 * hy.n_experts
                            / hy.top_k)  # the reference is dropless
    logits, _, aux = lm.forward(cfg, no_drops, params, {"tokens": tokens})
    ce = lm.cross_entropy(logits, labels)
    _objective(ce, aux, hy).backward()

    weights = ref_train.trial_weights(hy, 1, SEED, 0, "cpu")
    prec = Precision()
    x = ref.embed(hy, weights, tokens)
    ref_aux = 0.0
    for i in range(hy.sizes.n_layers):
        x, a = ref.layer(prec, hy, i, ref_train._layer_params(weights, i), x)
        ref_aux = ref_aux + a
    ref_logits = ref.rms_norm(x, weights["final_norm"], 1e-5) \
        @ weights["embed/tok"].t() / hy.logits_scaling
    ref_ce = ref.loss(prec, hy, weights, x, labels)
    _objective(ref_ce, ref_aux, hy).backward()

    torch.testing.assert_close(logits, ref_logits, rtol=1e-5, atol=1e-5)
    assert float(aux.detach()) == pytest.approx(float(ref_aux.detach()),
                                                rel=1e-5)
    assert float(ce) == pytest.approx(float(ref_ce), rel=1e-6)
    for name, w in weights.items():
        if name.startswith("layers/"):
            _, i, path = name.split("/", 2)
            mine = _tree_leaf(params["layers"][int(i)], path).grad
        else:
            mine = _tree_leaf(params, name).grad
        scale = float(w.grad.abs().max()) + 1e-12
        torch.testing.assert_close(mine / scale, w.grad / scale, rtol=0,
                                   atol=2e-5, msg=name)


TRAFFIC = {"trials": 2, "stages": 2, "microbatches": 2, "rows": 1,
           "seq": 16, "objective": "causal", "lr": [1e-3, 2e-3],
           "weight_decay": [0.0, 0.1], "grad_clip": 1.0,
           "betas": [0.9, 0.999], "eps": 1e-8, "remat": True,
           "kernels": False, "capacity_factor": 4.0, "layout": None,
           "setup_steps": 2}


def test_pipelined_hydra_steps_follow_the_reference():
    """K 2, S 2 with remat over a five-layer stack padded to six."""
    hy = small()
    prog = drv.Program(hy.sizes, TRAFFIC, SEED, [torch.device("cpu")],
                       config=dict(CONFIG, **_conf_of(hy)))
    assert prog.params["layers"][5] == {}  # the stage padding holds nothing
    prog.tracer.enabled = True
    losses = [prog.step(step) for step in range(2)]
    assert drv.dropped(prog.tracer.counters) == 0
    for k in range(2):
        weights, ref_losses, _ = ref_train.train_trial(
            hy, TRAFFIC, SEED, k, "cpu", 2)
        for step in range(2):
            assert losses[step][k] == pytest.approx(ref_losses[step],
                                                    rel=1e-6)
        mine = prog.trial_leaves(prog.params, k)
        assert set(mine) == set(weights)
        for leaf, w in weights.items():
            torch.testing.assert_close(mine[leaf], w.detach(), rtol=0,
                                       atol=5e-5, msg=leaf)


def _conf_of(hy):
    """The configuration keys :func:`small` changed."""
    return {"layer_types": list(hy.layer_types),
            "num_local_experts": hy.held[1],
            "num_experts_per_tok": hy.top_k,
            "mamba_d_state": hy.d_state, "mamba_d_head": hy.mamba_head_dim,
            "mamba_chunk_size": hy.chunk,
            "expert_parallel": {"cards": hy.n_experts // hy.held[1],
                                "card": hy.held[0] // hy.held[1]}}


@pytest.mark.parametrize("cards", [4, 8])
@pytest.mark.parametrize("kind", ["mamba", "attention"])
def test_expert_shares_add_up_to_the_uncut_layer(cards, kind):
    """72 experts, top-10: each card's layer (mixer, its held experts'
    part of the MoE, the shared expert) at every card, the mixer and the
    shared expert taken out of all but one, is the reference's layer
    with every expert held."""
    whole = small(layers=(kind,), cards=1, card=0, held=72, top_k=10)
    weights = ref_train.trial_weights(whole, 1, SEED, 0, "cpu")
    p = ref_train._layer_params(weights, 0)
    x = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(7))
    prec = Precision()
    with torch.no_grad():
        want, _ = ref.layer(prec, whole, 0, p, x)
        h = ref.rms_norm(x, p["ln1"], 1e-5)
        mix = (ref.mamba2 if kind == "mamba" else ref.attention)(
            prec, whole, p, h)
        h2 = ref.rms_norm(x + whole.residual_multiplier * mix, p["ln2"],
                          1e-5)
        once = x + whole.residual_multiplier * (mix + ref.swiglu(
            prec, h2, p["moe/shared/w_gate"], p["moe/shared/w_up"],
            p["moe/shared/w_down"]))
        per = 72 // cards
        total = -(cards - 1) * once
        for c in range(cards):
            share = dataclasses.replace(whole, held=(c * per, per))
            cfg = drv.arch_config(share)
            mine = {"ln1": p["ln1"], "ln2": p["ln2"], "moe": {
                "router": p["moe/router"],
                "w_gate": p["moe/w_gate"][c * per:(c + 1) * per],
                "w_up": p["moe/w_up"][c * per:(c + 1) * per],
                "w_down": p["moe/w_down"][c * per:(c + 1) * per],
                "shared": {n: p[f"moe/shared/{n}"]
                           for n in ("w_gate", "w_up", "w_down")}}}
            mixer = "mamba" if kind == "mamba" else "attn"
            mine[mixer] = {n.split("/", 1)[1]: v for n, v in p.items()
                           if n.startswith(mixer + "/")}
            opts = ModelOptions(moe_capacity_factor=8.0)  # no drops
            y, _, _ = B.hybrid_moe_block(cfg, opts, mine, x, pos=None)
            total = total + y
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


def test_held_share_routes_over_every_expert():
    """A share's picks of absent experts go to the scratch row: the held
    part is the masked sum of the whole layer's per-pick outputs."""
    g = torch.Generator().manual_seed(1)
    d, e, f, k = 16, 8, 8, 3
    p = {"router": torch.randn(d, e, generator=g),
         "w_gate": torch.randn(e, d, f, generator=g),
         "w_up": torch.randn(e, d, f, generator=g),
         "w_down": torch.randn(e, f, d, generator=g)}
    x = torch.randn(2, 6, d, generator=g)
    kw = dict(n_experts=e, top_k=k, capacity_factor=float(e))
    whole, aux = L.moe_apply(p, x, **kw)
    parts = []
    for first in (0, 3, 6):
        n = min(3, e - first)
        mine = {"router": p["router"], **{w: p[w][first:first + n] for w in
                                          ("w_gate", "w_up", "w_down")}}
        y, a = L.moe_apply(mine, x, held=(first, n), **kw)
        assert float(a) == pytest.approx(float(aux))  # over every expert
        parts.append(y)
    torch.testing.assert_close(sum(parts), whole, rtol=1e-5, atol=1e-5)


def _hybrid_step(tracer, steps=1):
    hy = small()
    prog = drv.Program(hy.sizes, TRAFFIC, SEED, [torch.device("cpu")],
                       config=dict(CONFIG, **_conf_of(hy)))
    prog.tracer = tracer
    eng = pl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                          n_stages=2)
    prog.step_fn = pl.make_train_step(
        drv.arch_config(hy), ModelOptions(remat=True, moe_capacity_factor=4.0),
        eng, prog.opt, tracer=tracer)
    mets = [prog.step(i) for i in range(steps)]
    return hy, mets, prog.params


def test_tracing_changes_no_number_and_counts_the_moe():
    tr = Tracer()
    hy, m_on, p_on = _hybrid_step(tr, steps=2)
    _, m_off, p_off = _hybrid_step(None, steps=2)
    for a, b in zip(m_on, m_off):
        assert (a == b).all()
    for x, y in zip(tree_leaves(p_on), tree_leaves(p_off)):
        assert torch.equal(x, y)
    begins = {}
    for ev in tr.events:
        if ev["ev"] == "span_begin" and ev["name"] in ("train.mixer",
                                                       "train.moe"):
            key = (ev["name"], ev["pass"], ev.get("kind"))
            begins[key] = begins.get(key, 0) + 1
    slots, n_mamba = 4, hy.layer_types.count("mamba")
    assert begins["train.mixer", "forward", "mamba2"] == 2 * slots * n_mamba
    assert begins["train.mixer", "forward", "attention"] == 2 * slots
    assert begins["train.moe", "forward", None] == 2 * slots * 5
    assert {ev["layer"] for ev in tr.events if ev.get("kind") ==
            "attention"} == {2}
    c = tr.counters
    cap = int(4.0 * 16 * hy.top_k / hy.n_experts)
    assert c["moe_bucket_rows"] == {"repro.train.moe:forward":
                                    2 * slots * 5 * hy.held[1] * cap}
    picks = c["moe_local_picks"]["repro.train.moe:forward"]
    assert 0 < picks <= 2 * slots * 5 * 16 * hy.top_k
    assert c["moe_dropped_picks"] == {"repro.train.moe:forward": 0}
    assert tr._pending == []  # read back with the step's losses
    assert "host_syncs" not in c  # the CPU synchronises nothing


def test_the_family_refuses_a_layout_and_serving():
    from repro_torch.launch.mesh import layout_of

    hy = small()
    cfg = drv.arch_config(hy)
    eng = pl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=1,
                          n_stages=2)
    layout = layout_of([torch.device("cpu")] * 2, (1, 1, 2))
    with pytest.raises(ValueError, match="mixed layer kinds"):
        pl.make_train_step(cfg, ModelOptions(), eng, AdamW(), layout=layout)
    with pytest.raises(ValueError, match="trains only"):
        pl.make_serve_step(cfg, ModelOptions(), eng, "decode")


def test_the_batch_draws_ids_from_the_vocabulary_slice():
    hy = small()
    b = T.batch(TRAFFIC, hy.sizes.vocab_size, SEED, 0, "cpu")
    assert int(b["tokens"].max()) < hy.sizes.vocab_size
