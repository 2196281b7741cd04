"""A hybrid Mamba2 / attention MoE configuration (HF ``granitemoehybrid``)
read into :class:`Hybrid`, and its weights drawn from ``--seed``: the
description the driver, the weights and the reference share. Nothing
here imports the program.

:class:`~bench.harness.sizes.Sizes` carries what every family has (depth,
widths, heads, the vocabulary slice); the rest comes from the
configuration's published keys. Where a width of ``Sizes`` differs from
the configuration's (a test's narrow cell), the widths that follow from
it are derived from ``Sizes``: the Mamba heads are ``mamba_expand ·
d_model / mamba_d_head``, the shared expert keeps its published ratio to
the expert width.

The router is ``num_local_experts × expert_parallel.cards`` wide (the
published count); a layer holds the ``num_local_experts`` experts of card
``expert_parallel.card``.

Weights: one unit a leaf, a layer and a trial (the embedding's vocabulary
slice of each stage its own unit, as ``bench.harness.weights`` draws),
each from its own generator seeded from (seed, leaf, trial, stage), so the
reference re-draws any unit alone. Matrices N(0, 1/fan_in), the embedding
N(0, 1), norms one, the conv bias zero, ``dt_bias`` the softplus inverse
of a dt drawn log-uniform in [1e-3, 1e-1], ``A_log`` log(1..heads), ``D``
one. Leaves are named by their paths in the program's tree
(``layers/<i>/mamba/in_proj``, ``layers/<i>/moe/shared/w_up``,
``embed/tok``, ``final_norm``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bench.harness.sizes import Sizes, padded_vocab, stage_layers
from bench.harness.weights import draw, unit_seed

KINDS = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class Hybrid:
    sizes: Sizes
    layer_types: tuple
    n_experts: int  # the router's width
    held: tuple  # (first expert id, count) held by this card
    top_k: int
    shared_d_ff: int
    mamba_heads: int
    mamba_head_dim: int
    d_state: int
    n_groups: int
    d_conv: int
    chunk: int
    attention_multiplier: float
    embedding_multiplier: float
    residual_multiplier: float
    logits_scaling: float
    aux_coef: float

    @property
    def d_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def hybrid_of(config: dict, sizes: Sizes) -> Hybrid:
    """:class:`Hybrid` of a configuration file's contents, at ``sizes``
    (the file's own, or a test's narrower ones)."""
    kinds = tuple(config["layer_types"])[:sizes.n_layers]
    if len(kinds) != sizes.n_layers or not set(kinds) <= set(KINDS):
        raise ValueError(f"layer_types must name each of the "
                         f"{sizes.n_layers} layers one of {KINDS}")
    share = config["expert_parallel"]
    held = config["num_local_experts"]
    shared = config["shared_intermediate_size"]
    if sizes.d_ff != config["intermediate_size"]:
        shared = shared * sizes.d_ff // config["intermediate_size"]
    return Hybrid(
        sizes=sizes, layer_types=kinds,
        n_experts=held * share["cards"], held=(held * share["card"], held),
        top_k=config["num_experts_per_tok"], shared_d_ff=shared,
        mamba_heads=config["mamba_expand"] * sizes.d_model
        // config["mamba_d_head"],
        mamba_head_dim=config["mamba_d_head"],
        d_state=config["mamba_d_state"], n_groups=config["mamba_n_groups"],
        d_conv=config["mamba_d_conv"], chunk=config["mamba_chunk_size"],
        attention_multiplier=config["attention_multiplier"],
        embedding_multiplier=config["embedding_multiplier"],
        residual_multiplier=config["residual_multiplier"],
        logits_scaling=config["logits_scaling"],
        aux_coef=config["router_aux_loss_coef"])


def layer_leaves(h: Hybrid, layer: int) -> list:
    """(path under ``layers/<layer>/``, shape, init) of every leaf of the
    layer; init is ("normal", fan_in), "ones", "zeros", "dt_bias",
    "a_log"."""
    s = h.sizes
    d, f, e = s.d_model, s.d_ff, h.held[1]
    out = [("ln1", (d,), "ones"), ("ln2", (d,), "ones"),
           ("moe/router", (d, h.n_experts), ("normal", d)),
           ("moe/w_gate", (e, d, f), ("normal", d)),
           ("moe/w_up", (e, d, f), ("normal", d)),
           ("moe/w_down", (e, f, d), ("normal", f)),
           ("moe/shared/w_gate", (d, h.shared_d_ff), ("normal", d)),
           ("moe/shared/w_up", (d, h.shared_d_ff), ("normal", d)),
           ("moe/shared/w_down", (h.shared_d_ff, d),
            ("normal", h.shared_d_ff))]
    if h.layer_types[layer] == "mamba":
        nh, di = h.mamba_heads, h.d_inner
        out += [("mamba/in_proj", (d, 2 * di + 2 * h.n_groups * h.d_state
                                   + nh), ("normal", d)),
                ("mamba/conv_w", (h.conv_dim, h.d_conv), ("normal",
                                                          h.d_conv)),
                ("mamba/conv_b", (h.conv_dim,), "zeros"),
                ("mamba/dt_bias", (nh,), "dt_bias"),
                ("mamba/A_log", (nh,), "a_log"),
                ("mamba/D", (nh,), "ones"),
                ("mamba/norm_w", (di,), "ones"),
                ("mamba/out_proj", (di, d), ("normal", di))]
    else:
        q = s.n_heads * s.head_dim
        kv = s.n_kv_heads * s.head_dim
        out += [("attn/wq", (d, q), ("normal", d)),
                ("attn/wk", (d, kv), ("normal", d)),
                ("attn/wv", (d, kv), ("normal", d)),
                ("attn/wo", (q, d), ("normal", q))]
    return out


def global_leaves(h: Hybrid, n_stages: int) -> list:
    """(path, full shape, split axis or None, real length, init) of the
    leaves outside the stack: the tied embedding split over the stages by
    vocabulary rows (padding rows zero), the final norm whole."""
    s = h.sizes
    d = s.d_model
    return [("embed/tok", (padded_vocab(s, n_stages), d), 0, s.vocab_size,
             ("normal", 1)),
            ("final_norm", (d,), None, d, "ones")]


def _init(shape, init, key: int, device) -> torch.Tensor:
    if init == "a_log":
        return torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                      device=device))
    if init == "dt_bias":
        gen = torch.Generator(device=device).manual_seed(key)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(torch.rand(shape, generator=gen, device=device)
                       * (hi - lo) + lo)
        return dt + torch.log1p(-torch.exp(-dt))
    return draw(shape, init, key, device)


def layer_unit(h: Hybrid, seed: int, layer: int, path: str, k: int,
               device) -> torch.Tensor:
    """Trial ``k``'s leaf ``path`` of layer ``layer``."""
    _, shape, init = next(x for x in layer_leaves(h, layer) if x[0] == path)
    return _init(shape, init, unit_seed(seed, f"layers/{layer}/{path}", k, 0),
                 device)


def global_unit(h: Hybrid, n_stages: int, seed: int, path: str, k: int,
                s: int, device) -> torch.Tensor:
    """Stage ``s``'s slice of a split leaf (its padding zeroed), or a
    replicated leaf whole (``s`` ignored)."""
    _, shape, axis, real, init = next(
        x for x in global_leaves(h, n_stages) if x[0] == path)
    if axis is None:
        return _init(shape, init, unit_seed(seed, path, k, 0), device)
    w = shape[axis] // n_stages
    local = list(shape)
    local[axis] = w
    out = _init(tuple(local), init, unit_seed(seed, path, k, s), device)
    pad = (s + 1) * w - real
    if pad > 0:
        out.narrow(axis, w - min(pad, w), min(pad, w)).zero_()
    return out


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for name in head:
        tree = tree.setdefault(name, {})
    tree[last] = value


def trial_tree(h: Hybrid, n_stages: int, n_trials: int, seed: int,
               device) -> dict:
    """The K trials' weights in the program's tree: ``layers`` a list over
    the stage-padded stack of per-layer dicts (a padding layer empty), each
    leaf (K, ...); ``embed/tok`` (K, Vp, D); ``final_norm`` (K, D)."""
    ls = stage_layers(h.sizes, n_stages)
    layers = []
    with torch.no_grad():
        for i in range(ls * n_stages):
            tree: dict = {}
            if i < h.sizes.n_layers:
                for path, shape, _ in layer_leaves(h, i):
                    leaf = torch.empty((n_trials,) + shape, device=device)
                    for k in range(n_trials):
                        leaf[k].copy_(layer_unit(h, seed, i, path, k,
                                                 device))
                    _set(tree, path, leaf)
            layers.append(tree)
        out: dict = {"layers": layers}
        for path, shape, axis, _, _ in global_leaves(h, n_stages):
            leaf = torch.empty((n_trials,) + shape, device=device)
            for k in range(n_trials):
                if axis is None:
                    leaf[k].copy_(global_unit(h, n_stages, seed, path, k, 0,
                                              device))
                    continue
                w = shape[axis] // n_stages
                for s in range(n_stages):
                    leaf[k].narrow(axis, s * w, w).copy_(global_unit(
                        h, n_stages, seed, path, k, s, device))
            _set(out, path, leaf)
    return out
