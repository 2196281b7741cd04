"""Stacked-layer language model in PyTorch: init, forward, greedy oracle.

Port of ``repro/models/lm.py`` (dense family). As in the reference, every
layer leaf carries a leading layer axis so the pipeline engine can run a
contiguous slice of layers per stage through the same :func:`stack_apply`,
with a per-layer validity mask for stage-padded stacks. Parameters are
nested dicts of tensors in the reference's layouts; :func:`params_from_numpy`
carries a JAX parameter pytree (as numpy arrays) across unchanged, which is
how the tests hold the port against the reference on the same weights.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.layers import ModelOptions


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


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                n_layers: Optional[int] = None, device=None):
    """Full dense-model parameter dict; layer leaves get a leading
    ``n_layers`` axis (``n_layers`` may exceed ``cfg.n_layers`` — stage
    padding; padded layers are masked at apply time). Draws from the torch
    generator ``gen`` (whose device must be ``device``); the numbers differ
    from the reference's ``jax.random`` init, so cross-framework tests load
    the reference's weights with :func:`params_from_numpy` instead."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    nl = n_layers or cfg.n_layers
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    nrm = lambda shape, fan: _normal(gen, shape, fan, dtype, device)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    mlp = ({"w_gate": nrm((nl, d, f), d), "w_up": nrm((nl, d, f), d),
            "w_down": nrm((nl, f, d), f)} if cfg.act == "swiglu" else
           {"w_up": nrm((nl, d, f), d), "w_down": nrm((nl, f, d), f)})
    params = {
        "embed": {"tok": nrm((cfg.vocab_size, d), 1)},
        "layers": {
            "attn": {"wq": nrm((nl, d, h * hd), d),
                     "wk": nrm((nl, d, hkv * hd), d),
                     "wv": nrm((nl, d, hkv * hd), d),
                     "wo": nrm((nl, h * hd, d), h * hd)},
            "ln1": ones(nl, d),
            "ln2": ones(nl, d),
            "mlp": mlp,
        },
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = nrm((d, cfg.vocab_size), d)
    return params


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays (e.g. a JAX parameter pytree passed
    through ``np.asarray``) -> the same nesting of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when given. Serves the
    single-model tree and the K-stacked trial tree alike (layouts match)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    arr = np.array(tree)  # a writable copy (JAX hands out read-only views)
    if arr.dtype.kind == "f" and arr.dtype.itemsize != 4:
        arr = arr.astype(np.float32)  # bf16 (ml_dtypes) has no torch bridge
    t = torch.from_numpy(arr).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def layer_slice(tree, i):
    """Layer ``i`` of a layer-stacked parameter/cache tree (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               cache_dtype=torch.bfloat16, n_layers: Optional[int] = None,
               device=None):
    """Stacked dense per-layer cache (leading layer axis)."""
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

    layer_params: leaves with a leading local-layer axis (n_local, ...).
    cache: {"layers": {"k", "v"} stacked per layer, "shared": None} or None;
    with ``block_tables`` the stacked leaves are per-layer block *pools*.
    layer_mask: (n_local,) bools — False = padded no-op layer (skipped).
    Returns (y, cache); cache leaves are updated in place.
    """
    n_local = layer_params["ln1"].shape[0]
    if layer_mask is None:
        layer_mask = [True] * n_local
    block = B.block_fn_for(cfg)
    for i in range(n_local):
        if not layer_mask[i]:
            continue
        c_i = None if cache is None else layer_slice(cache["layers"], i)
        x, _ = block(cfg, opts, layer_slice(layer_params, i), x, pos=pos,
                     cache=c_i, kv_offset=kv_offset, mode=mode,
                     window=window, block_tables=block_tables,
                     write_mask=write_mask)
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


# ---------------------------------------------------------------------------
# Whole-model entry point (single-device oracle)
# ---------------------------------------------------------------------------


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
        pos = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(cfg, params["embed"], tokens,
                     compute_dtype=opts.compute_dtype)
    n_stack = params["layers"]["ln1"].shape[0]
    if layer_mask is None:
        layer_mask = [i < cfg.n_layers for i in range(n_stack)]
    y, cache = stack_apply(cfg, opts, params["layers"], x, pos=pos,
                           mode=mode, cache=cache, kv_offset=kv_offset,
                           window=window, layer_mask=layer_mask)
    return lm_logits(cfg, params, y), cache


def greedy_generate(cfg: ArchConfig, opts: ModelOptions, params, prompt,
                    max_new_tokens: int, max_seq: int, cache_dtype,
                    window: int = 0) -> list:
    """Single-device greedy decode of one prompt (the serving oracle):
    prefill the prompt into a dense cache, then decode one token at a time.
    The cache is sized to the (possibly stage-padded) layer stack."""
    device = params["final_norm"].device
    n_stack = params["layers"]["ln1"].shape[0]
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
