"""Stacked-layer language model in PyTorch: init, forward, loss, greedy
oracle.

Port of ``repro/models/lm.py`` (dense and ssm families). As in the
reference, every layer leaf carries a leading layer axis so the pipeline
engine can run a contiguous slice of layers per stage through the same
:func:`stack_apply`, with a per-layer validity mask for stage-padded
stacks. Parameters are nested dicts of tensors in the reference's layouts;
:func:`params_from_numpy` carries a JAX parameter pytree (as numpy arrays)
across unchanged, which is how the tests hold the port against the
reference on the same weights.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.layers import ModelOptions
from repro_torch.tree import tree_leaves, tree_map, tree_paths


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _normal(gen, shape, fan_in, dtype, device):
    """N(0, 1/fan_in) drawn in fp32 from ``gen``, stored as ``dtype``; a
    stacked leaf is drawn one layer at a time so the fp32 transient stays
    one layer's size."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for sub in (out if len(shape) > 2 else [out]):
        sub.copy_(torch.randn(sub.shape, generator=gen, device=device)
                  / math.sqrt(max(fan_in, 1)))
    return out


def _ssm_layers(cfg: ArchConfig, nl: int, nrm, ones, gen, dtype, device):
    """Mamba1 layer leaves (leading ``nl`` axis), as the reference's
    ``init_layer_params``: ``dt_bias`` is softplus^-1 of dt drawn
    log-uniform in [1e-3, 1e-1], ``A_log = log(1..n)``, ``D = 1``; those
    three are fp32 whatever ``dtype``."""
    s, d = cfg.ssm, cfg.d_model
    di, n = s.d_inner(d), s.d_state
    r = s.resolved_dt_rank(d)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((nl, di), generator=gen, device=device) * (hi - lo) + lo
    dt = torch.exp(u)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "ln": ones(nl, d),
        "mamba": {
            "in_proj": nrm((nl, d, 2 * di), d),
            "conv_w": nrm((nl, di, s.d_conv), s.d_conv),
            "conv_b": torch.zeros((nl, di), dtype=dtype, device=device),
            "x_proj": nrm((nl, di, r + 2 * n), di),
            "dt_proj": nrm((nl, r, di), r),
            "dt_bias": dt + torch.log1p(-torch.exp(-dt)),
            "A_log": a_log.expand(nl, di, n).contiguous(),
            "D": torch.ones((nl, di), dtype=torch.float32, device=device),
            "out_proj": nrm((nl, di, d), di),
        },
    }


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                n_layers: Optional[int] = None, device=None):
    """Full model parameter dict (dense or ssm family); layer leaves get a
    leading ``n_layers`` axis (``n_layers`` may exceed ``cfg.n_layers`` —
    stage padding; padded layers are masked at apply time). Draws from the
    torch generator ``gen`` (whose device must be ``device``); the numbers
    differ from the reference's ``jax.random`` init, so cross-framework
    tests load the reference's weights with :func:`params_from_numpy`
    instead."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    nl = n_layers or cfg.n_layers
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    nrm = lambda shape, fan: _normal(gen, shape, fan, dtype, device)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    if cfg.family == "ssm":
        layers = _ssm_layers(cfg, nl, nrm, ones, gen, dtype, device)
        embed = nrm((cfg.vocab_size, d), 1)
    else:
        mlp = ({"w_gate": nrm((nl, d, f), d), "w_up": nrm((nl, d, f), d),
                "w_down": nrm((nl, f, d), f)} if cfg.act == "swiglu" else
               {"w_up": nrm((nl, d, f), d), "w_down": nrm((nl, f, d), f)})
        embed = nrm((cfg.vocab_size, d), 1)
        layers = {
            "attn": {"wq": nrm((nl, d, h * hd), d),
                     "wk": nrm((nl, d, hkv * hd), d),
                     "wv": nrm((nl, d, hkv * hd), d),
                     "wo": nrm((nl, h * hd, d), h * hd)},
            "ln1": ones(nl, d),
            "ln2": ones(nl, d),
            "mlp": mlp,
        }
    params = {
        "embed": {"tok": embed},
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = nrm((d, cfg.vocab_size), d)
    return params


# leaves the reference keeps in fp32 whatever the parameter dtype (the SSM
# families' dt bias, decay log and skip)
FP32_LEAVES = frozenset({"dt_bias", "A_log", "D"})


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays (e.g. a JAX parameter pytree passed
    through ``np.asarray``) -> the same nesting of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when given, except the
    :data:`FP32_LEAVES`, which stay fp32 as in the reference. Serves the
    single-model tree and the K-stacked trial tree alike (layouts match)."""
    def leaf(x, path):
        if x is None:
            return None
        arr = np.array(x)  # a writable copy (JAX hands out read-only views)
        if arr.dtype.kind == "f" and arr.dtype.itemsize != 4:
            arr = arr.astype(np.float32)  # bf16 (ml_dtypes): no torch bridge
        t = torch.from_numpy(arr).to(device)
        if t.is_floating_point():
            if path.rsplit("/", 1)[-1] in FP32_LEAVES:
                t = t.float()
            elif dtype is not None:
                t = t.to(dtype)
        return t

    return tree_map(leaf, tree, tree_paths(tree))


def n_stacked_layers(layers) -> int:
    """Length of the leading layer axis of a layer-stacked tree (any
    family's leaves)."""
    return tree_leaves(layers)[0].shape[0]


def layer_slice(tree, i):
    """Layer ``i`` of a layer-stacked parameter/cache tree (views)."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               cache_dtype=torch.bfloat16, n_layers: Optional[int] = None,
               device=None):
    """Stacked dense per-layer cache (leading layer axis); each leaf in its
    own dtype (``B.layer_cache_shape``: the SSM state is fp32)."""
    nl = n_layers or cfg.n_layers
    one = B.layer_cache_shape(cfg, batch, max_seq, cache_dtype)
    return {"layers": {k: torch.zeros((nl,) + shape, dtype=dt, device=device)
                       for k, (shape, dt) in one.items()},
            "shared": None}


# ---------------------------------------------------------------------------
# Stacked layer application (the unit the pipeline engine runs per stage)
# ---------------------------------------------------------------------------


def stack_apply(cfg: ArchConfig, opts: ModelOptions, layer_params, x, *,
                pos, mode: str = "train", cache=None, layer_mask=None,
                kv_offset=None, window: int = 0, block_tables=None,
                write_mask=None):
    """Apply a contiguous slice of the layer stack.

    layer_params: a list of per-layer parameter dicts (views into the
    layer-stacked leaves; see :func:`layer_slice`).
    cache: {"layers": {"k", "v"} or {"ssm", "conv"} stacked per layer,
    "shared": None} or None; with ``block_tables`` the stacked leaves are
    per-layer block *pools*. ``write_mask`` (b,) gates which rows' cache
    entries append / decode may write.
    layer_mask: (n_local,) bools — False = padded no-op layer (skipped).
    In train mode with ``opts.remat`` each layer is a
    ``torch.utils.checkpoint`` — the reference's ``jax.checkpoint`` of the
    scan body: backward keeps each layer's input and recomputes the rest.
    Returns (y, cache); cache leaves are updated in place.
    """
    n_local = len(layer_params)
    if layer_mask is None:
        layer_mask = [True] * n_local
    block = B.block_fn_for(cfg)
    remat = mode == "train" and opts.remat
    for i in range(n_local):
        if not layer_mask[i]:
            continue
        p_i = layer_params[i]
        c_i = None if cache is None else layer_slice(cache["layers"], i)

        def run(x, p_i=p_i, c_i=c_i):
            return block(cfg, opts, p_i, x, pos=pos, cache=c_i,
                         kv_offset=kv_offset, mode=mode, window=window,
                         block_tables=block_tables, write_mask=write_mask)[0]

        x = (checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
             if remat and torch.is_grad_enabled() else run(x))
    return x, cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ArchConfig, p_embed, tokens, *, compute_dtype=None):
    x = p_embed["tok"][tokens.long()]
    return x if compute_dtype is None else x.to(compute_dtype)


def final_norm_apply(cfg: ArchConfig, p_norm, x):
    return L.rms_norm(x, p_norm, cfg.norm_eps)


def lm_logits(cfg: ArchConfig, params, x):
    x = final_norm_apply(cfg, params["final_norm"], x)
    head = params.get("head")
    if head is None:  # tied embeddings
        head = params["embed"]["tok"].T
    return x @ head


def cross_entropy(logits, labels, mask=None):
    """Mean CE over unmasked positions; fp32 accumulation."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Whole-model entry points (single-device oracle)
# ---------------------------------------------------------------------------


def default_positions(cfg: ArchConfig, batch: dict, b: int, s: int):
    """(b, s) positions 0..s-1 of a full-sequence batch (M-RoPE's three
    streams are not ported)."""
    if cfg.rope == "mrope":
        raise NotImplementedError("rope='mrope' is not ported yet")
    return torch.arange(s, device=batch["tokens"].device).expand(b, s)


def forward(cfg: ArchConfig, opts: ModelOptions, params, batch: dict,
            mode: str = "train", cache=None, kv_offset=None, window: int = 0,
            layer_mask=None):
    """Full-model forward. Returns (logits, cache).

    ``layer_mask`` supports stage-padded stacks (leaves longer than
    cfg.n_layers); it defaults to masking exactly the real layers.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    if mode == "decode":
        pos = kv_offset[:, None]  # (b, 1) absolute positions
    else:
        pos = default_positions(cfg, batch, b, s)
    x = embed_tokens(cfg, params["embed"], tokens,
                     compute_dtype=opts.compute_dtype)
    n_stack = n_stacked_layers(params["layers"])
    if layer_mask is None:
        layer_mask = [i < cfg.n_layers for i in range(n_stack)]
    layers = [layer_slice(params["layers"], i) for i in range(n_stack)]
    y, cache = stack_apply(cfg, opts, layers, x, pos=pos,
                           mode=mode, cache=cache, kv_offset=kv_offset,
                           window=window, layer_mask=layer_mask)
    return lm_logits(cfg, params, y), cache


def loss_fn(cfg: ArchConfig, opts: ModelOptions, params, batch: dict):
    """Mean next-token CE of a train batch ({tokens, labels[, loss_mask]})
    through the single-device forward (the ported families have no MoE
    aux term)."""
    logits, _ = forward(cfg, opts, params, batch, mode="train")
    return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def greedy_generate(cfg: ArchConfig, opts: ModelOptions, params, prompt,
                    max_new_tokens: int, max_seq: int, cache_dtype,
                    window: int = 0) -> list:
    """Single-device greedy decode of one prompt (the serving oracle):
    prefill the prompt into a dense cache, then decode one token at a time.
    The cache is sized to the (possibly stage-padded) layer stack."""
    device = params["final_norm"].device
    n_stack = n_stacked_layers(params["layers"])
    cache = init_cache(cfg, 1, max_seq, cache_dtype=cache_dtype,
                       n_layers=n_stack, device=device)
    toks = torch.as_tensor(np.asarray(prompt)[None], device=device)
    logits, cache = forward(cfg, opts, params, {"tokens": toks},
                            mode="prefill", cache=cache, window=window)
    out = [int(torch.argmax(logits[0, -1]))]
    for t in range(max_new_tokens - 1):
        logits, cache = forward(
            cfg, opts, params,
            {"tokens": torch.tensor([[out[-1]]], device=device)},
            mode="decode", cache=cache, window=window,
            kv_offset=torch.tensor([len(prompt) + t], device=device))
        out.append(int(torch.argmax(logits[0, 0])))
    return out
