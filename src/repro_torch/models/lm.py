"""Stacked-layer language model in PyTorch: init, forward, loss, greedy
oracle.

Port of ``repro/models/lm.py`` (every family: dense, moe, ssm, hybrid, the
audio and vlm backbones, the encoder, and the paper's MLP through
``mlp_init`` / ``mlp_forward`` / ``mlp_loss``). As in
the reference, every layer leaf carries a leading layer axis so the
pipeline engine can run a contiguous slice of layers per stage through the
same :func:`stack_apply`, with a per-layer validity mask for stage-padded
stacks and, for hybrid archs, per-layer shared-attention site flags.
Parameters are nested dicts of tensors in the reference's layouts (the
hybrid family's shared block under ``"shared"``); :func:`params_from_numpy`
carries a JAX parameter pytree (as numpy arrays) across unchanged, which
is how the tests hold the port against the reference on the same
weights.
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
from repro_torch.obs import tracer as obs_tracer
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


def _mamba2_params(cfg: ArchConfig, lead: tuple, nrm, ones, gen, dtype,
                   device):
    """A Mamba2 mixer's leaves (leading ``lead`` axes), as the reference's
    ``init_layer_params``: per-head ``dt_bias`` (softplus^-1 of dt drawn
    log-uniform in [1e-3, 1e-1]), ``A_log = log(1..nh)``, ``D = 1``, all
    three fp32 whatever ``dtype``."""
    s, d = cfg.ssm, cfg.d_model
    di, n, g = s.d_inner(d), s.d_state, s.n_groups
    nh = s.n_ssm_heads(d)
    conv_dim = di + 2 * g * n
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand(lead + (nh,), generator=gen, device=device)
                   * (hi - lo) + lo)
    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": nrm(lead + (d, 2 * di + 2 * g * n + nh), d),
        "conv_w": nrm(lead + (conv_dim, s.d_conv), s.d_conv),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "dt_bias": dt + torch.log1p(-torch.exp(-dt)),
        "A_log": a_log.expand(lead + (nh,)).contiguous(),
        "D": torch.ones(lead + (nh,), dtype=torch.float32, device=device),
        "norm_w": ones(*lead, di),
        "out_proj": nrm(lead + (di, d), di),
    }


def _hybrid_layers(cfg: ArchConfig, nl: int, nrm, ones, gen, dtype, device):
    """Mamba2 backbone layer leaves (leading ``nl`` axis)."""
    return {"ln": ones(nl, cfg.d_model),
            "mamba": _mamba2_params(cfg, (nl,), nrm, ones, gen, dtype,
                                    device)}


def _hybrid_moe_layers(cfg: ArchConfig, nl: int, nrm, ones, gen, dtype,
                       device) -> list:
    """A mixed stack: a list of ``nl`` layer dicts, each with its own
    leaves and no layer axis. A real layer holds its mixer (``mamba`` or
    ``attn``, by ``cfg.layer_types``), its MoE with the shared expert and
    two pre-norms; a stage-padding layer holds nothing."""
    d = cfg.d_model
    out = []
    for i in range(nl):
        kind = cfg.layer_kind(i)
        if kind is None:
            out.append({})
            continue
        layer = {"ln1": ones(d), "ln2": ones(d),
                 "moe": _moe_params(cfg, (), nrm)}
        if kind == "mamba":
            layer["mamba"] = _mamba2_params(cfg, (), nrm, ones, gen, dtype,
                                            device)
        else:
            layer["attn"] = _attn_params(cfg, (), nrm)
        out.append(layer)
    return out


def _attn_params(cfg: ArchConfig, lead: tuple, nrm):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": nrm(lead + (d, h * hd), d),
            "wk": nrm(lead + (d, hkv * hd), d),
            "wv": nrm(lead + (d, hkv * hd), d),
            "wo": nrm(lead + (h * hd, d), h * hd)}


def _moe_params(cfg: ArchConfig, lead: tuple, nrm):
    """The moe family's FFN: router (d, E), w_gate / w_up (E_held, d, f)
    and w_down (E_held, f, d) of the held experts (all E but where the
    config holds a share), as the reference's ``init_layer_params``; and
    ``shared`` (a SwiGLU MLP) where the config has a shared expert."""
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_d_ff
    held = cfg.held_experts[1]
    out = {"router": nrm(lead + (d, e), d),
           "w_gate": nrm(lead + (held, d, f), d),
           "w_up": nrm(lead + (held, d, f), d),
           "w_down": nrm(lead + (held, f, d), f)}
    if cfg.shared_d_ff:
        out["shared"] = _mlp_params(d, cfg.shared_d_ff, "swiglu", lead, nrm)
    return out


def _mlp_params(d: int, f: int, act: str, lead: tuple, nrm):
    if act == "swiglu":
        return {"w_gate": nrm(lead + (d, f), d),
                "w_up": nrm(lead + (d, f), d),
                "w_down": nrm(lead + (f, d), f)}
    return {"w_up": nrm(lead + (d, f), d), "w_down": nrm(lead + (f, d), f)}


def init_shared_params(cfg: ArchConfig, gen: torch.Generator,
                       dtype=torch.float32, device=None):
    """The hybrid family's shared attention + SwiGLU MLP block (one set of
    weights, no layer axis); None for other families."""
    if cfg.hybrid is None:
        return None
    nrm = lambda shape, fan: _normal(gen, shape, fan, dtype, device)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    return {"ln1": ones(cfg.d_model), "ln2": ones(cfg.d_model),
            "attn": _attn_params(cfg, (), nrm),
            "mlp": _mlp_params(cfg.d_model, cfg.hybrid.shared_d_ff,
                               "swiglu", (), nrm)}


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                n_layers: Optional[int] = None, device=None,
                max_pos: int = 0):
    """Full model parameter dict (every family but ``mlp``, which has
    :func:`mlp_init`); layer leaves get a leading ``n_layers`` axis
    (``n_layers`` may exceed ``cfg.n_layers`` — stage padding; padded
    layers are masked at apply time), except a mixed stack's
    (``cfg.layer_types``), whose ``"layers"`` is a list of ``n_layers``
    per-layer dicts; hybrid archs add the ``"shared"`` block. The
    encoder's norms are layer norms with biases (``ln1_w`` / ``ln1_b`` /
    ``ln2_w`` / ``ln2_b``, ``final_norm`` {"w", "b"}), and
    ``rope="learned"`` archs get the position table ``embed/pos``
    (max(max_pos, 1), d). Draws from the torch generator ``gen`` (whose
    device must be ``device``); the numbers differ from the reference's
    ``jax.random`` init, so cross-framework tests load the reference's
    weights with :func:`params_from_numpy` instead."""
    if cfg.family == "mlp":
        raise ValueError("the mlp workload has its own parameters: "
                         "lm.mlp_init")
    nl = n_layers or cfg.n_layers
    d = cfg.d_model
    nrm = lambda shape, fan: _normal(gen, shape, fan, dtype, device)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    if cfg.family == "ssm":
        layers = _ssm_layers(cfg, nl, nrm, ones, gen, dtype, device)
        embed = nrm((cfg.vocab_size, d), 1)
    elif cfg.family == "hybrid":
        layers = _hybrid_layers(cfg, nl, nrm, ones, gen, dtype, device)
        embed = nrm((cfg.vocab_size, d), 1)
    elif cfg.family == "hybrid_moe":
        layers = _hybrid_moe_layers(cfg, nl, nrm, ones, gen, dtype, device)
        embed = nrm((cfg.vocab_size, d), 1)
    else:  # (draw order: MLP or experts, embedding, attention)
        ffn_name = "moe" if cfg.family == "moe" else "mlp"
        ffn = (_moe_params(cfg, (nl,), nrm) if cfg.family == "moe"
               else _mlp_params(d, cfg.d_ff, cfg.act, (nl,), nrm))
        embed = nrm((cfg.vocab_size, d), 1)
        layers = {"attn": _attn_params(cfg, (nl,), nrm), ffn_name: ffn}
        if cfg.family == "encoder":
            layers.update(ln1_w=ones(nl, d), ln1_b=zeros(nl, d),
                          ln2_w=ones(nl, d), ln2_b=zeros(nl, d))
        else:
            layers.update(ln1=ones(nl, d), ln2=ones(nl, d))
    params = {
        "embed": {"tok": embed},
        "layers": layers,
        "final_norm": ({"w": ones(d), "b": zeros(d)}
                       if cfg.family == "encoder" else ones(d)),
    }
    if cfg.rope == "learned":
        params["embed"]["pos"] = nrm((max(max_pos, 1), d), 1)
    if cfg.hybrid is not None:
        params["shared"] = init_shared_params(cfg, gen, dtype, device)
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
        if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "f"
                                            and arr.dtype.itemsize != 4):
            # ml_dtypes' bf16 (numpy kind "V") has no torch bridge
            arr = arr.astype(np.float32)
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


def layer_list(layers) -> list:
    """The per-layer dicts of a stack: a mixed stack's own list, or the
    views of a layer-stacked tree."""
    if isinstance(layers, list):
        return layers
    return [layer_slice(layers, i) for i in range(n_stacked_layers(layers))]


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               cache_dtype=torch.bfloat16, n_layers: Optional[int] = None,
               device=None, window: int = 0):
    """Stacked dense per-layer cache (leading layer axis) + the hybrid
    family's shared-site cache (leading site axis, ``n_shared_sites``;
    ``window`` > 0 bounds its strips to the window); each leaf in its own
    dtype (``B.layer_cache_shape``: the SSM state is fp32)."""
    nl = n_layers or cfg.n_layers
    one = B.layer_cache_shape(cfg, batch, max_seq, cache_dtype)
    shared = None
    if cfg.hybrid is not None:
        ns = n_shared_sites(cfg)
        shared = {k: torch.zeros((ns,) + shape, dtype=dt, device=device)
                  for k, (shape, dt) in B.shared_cache_shape(
                      cfg, batch, max_seq, cache_dtype, window).items()}
    return {"layers": {k: torch.zeros((nl,) + shape, dtype=dt, device=device)
                       for k, (shape, dt) in one.items()},
            "shared": shared}


# ---------------------------------------------------------------------------
# Shared-site bookkeeping (hybrid archs)
# ---------------------------------------------------------------------------


def shared_site_flags(cfg: ArchConfig, layer_offset: int, n_local: int):
    """(use_shared, site_slot) lists for layers [offset, offset + n_local):
    the shared block runs after every ``attn_every``-th real layer, and
    ``site_slot`` is its *local* slot in this stage's shared-cache buffer
    (sequential over the stage's flagged layers; 0 where unflagged)."""
    if cfg.hybrid is None:
        return [False] * n_local, [0] * n_local
    flags = [(g + 1) % cfg.hybrid.attn_every == 0 and g < cfg.n_layers
             for g in range(layer_offset, layer_offset + n_local)]
    slots, count = [], 0
    for f in flags:
        count += f
        slots.append(max(count - 1, 0))
    return flags, slots


def n_shared_sites(cfg: ArchConfig, layer_offset: int = 0,
                   n_local: Optional[int] = None) -> int:
    """Shared sites among layers [offset, offset + n_local) (all layers by
    default); at least 1, as the reference (a stage with none keeps one
    unused slot)."""
    if cfg.hybrid is None:
        return 0
    n_local = n_local if n_local is not None else cfg.n_layers
    return max(sum(shared_site_flags(cfg, layer_offset, n_local)[0]), 1)


# ---------------------------------------------------------------------------
# Stacked layer application (the unit the pipeline engine runs per stage)
# ---------------------------------------------------------------------------


def stack_apply(cfg: ArchConfig, opts: ModelOptions, layer_params, x, *,
                pos, mode: str = "train", cache=None, shared_params=None,
                layer_mask=None, layer_offset: int = 0, kv_offset=None,
                window: int = 0, block_tables=None, write_mask=None,
                q_lens=None, n_shards: int = 1, layer_param_fn=None):
    """Apply a contiguous slice of the layer stack.

    layer_params: a list of per-layer parameter dicts (views into the
    layer-stacked leaves; see :func:`layer_slice`).
    cache: {"layers": {"k", "v"} or {"ssm", "conv"} stacked per layer,
    "shared": the slice's shared-site K/V strips (leading local site axis)
    or None} or None; with ``block_tables`` the stacked leaves are
    per-layer block *pools*. ``write_mask`` (b,) gates which rows' cache
    entries a serving call may write; ``q_lens`` (b,) makes append a
    ragged wave (see ``blocks.attn_apply``).
    layer_mask: (n_local,) bools — False = padded no-op layer (skipped).
    ``shared_params`` (hybrid archs): after every flagged layer
    (:func:`shared_site_flags` at ``layer_offset``, the slice's first
    global layer) the shared attention block runs on that site's slot of
    ``cache["shared"]``. ``n_shards``: the rows' data shards, each routed
    on its own by the MoE blocks. ``layer_param_fn(i, p_i)`` (the FSDP
    gather of the placed train step, the reference's ``layer_param_fn``)
    turns local layer i's parameters into the ones the block runs on,
    inside the layer's remat boundary.
    In train mode with ``opts.remat`` each layer (with its shared block)
    is a ``torch.utils.checkpoint`` — the reference's ``jax.checkpoint``
    of the scan body: backward keeps each layer's input and recomputes
    the rest. Returns (y, cache, aux): aux is the sum of the real layers'
    MoE load-balance terms (a 0-d fp32 tensor, zero for the other
    families); cache leaves are updated in place.
    In train mode under the train step's enabled tracer
    (``obs.tracer.current()``) each real layer's run is a ``train.layer``
    span, again at each recompute.
    """
    n_local = len(layer_params)
    if layer_mask is None:
        layer_mask = [True] * n_local
    block = B.block_fn_for(cfg)
    remat = mode == "train" and opts.remat
    tr = obs_tracer.current() if mode == "train" else obs_tracer.NULL_TRACER
    flags, slots = shared_site_flags(cfg, layer_offset, n_local)
    sh_cache = None if cache is None else cache["shared"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_local):
        if not layer_mask[i]:
            continue
        p_i = layer_params[i]
        # a mixed stack's block names the layer in its spans
        at = {"layer": layer_offset + i} if cfg.layer_types else {}
        c_i = None if cache is None else layer_slice(cache["layers"], i)
        use_sh = shared_params is not None and flags[i]
        sc_i = (layer_slice(sh_cache, slots[i])
                if use_sh and sh_cache is not None else None)

        def run(x, i=i, p_i=p_i, c_i=c_i, use_sh=use_sh, sc_i=sc_i, at=at):
            with (tr.span("train.layer", tr.train_pass,
                          layer=layer_offset + i, dev=str(x.device))
                  if tr.enabled else obs_tracer.NO_SPAN):
                if layer_param_fn is not None:
                    p_i = layer_param_fn(i, p_i)
                y, _, aux_i = block(cfg, opts, p_i, x, pos=pos, cache=c_i,
                                    kv_offset=kv_offset, mode=mode,
                                    window=window, block_tables=block_tables,
                                    write_mask=write_mask, q_lens=q_lens,
                                    n_shards=n_shards, **at)
                if use_sh:
                    y = B.shared_attn_block(
                        cfg, opts, shared_params, y, pos=pos, cache=sc_i,
                        kv_offset=kv_offset, mode=mode, window=window,
                        write_mask=write_mask)[0]
                return y, aux_i

        x, aux_i = (checkpoint(run, x, use_reentrant=False,
                               preserve_rng_state=False)
                    if remat and torch.is_grad_enabled() else run(x))
        aux = aux + aux_i
    return x, cache, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ArchConfig, p_embed, tokens, *, positions=None,
                 frontend_embeds=None, compute_dtype=None):
    """Token rows, plus for ``rope="learned"`` the position rows at
    ``positions`` (clamped to the table's last row, as the reference's
    single-device embedding); ``frontend_embeds`` (b, nf, d) replace the
    first nf positions (the stubbed audio / vision frontend)."""
    x = p_embed["tok"][tokens.long()]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if cfg.rope == "learned" and positions is not None:
        tab = p_embed["pos"]
        x = x + tab[positions.long().clamp(max=tab.shape[0] - 1)].to(x.dtype)
    if frontend_embeds is not None:
        x = replace_frontend_rows(x, frontend_embeds)
    return x


def replace_frontend_rows(x, frontend_embeds):
    """x (b, s, d) with its first nf rows replaced by ``frontend_embeds``
    (b, nf, d), cast to x's dtype (out of place: x may be on the autograd
    tape)."""
    nf = frontend_embeds.shape[1]
    return torch.cat([frontend_embeds.to(x.dtype), x[:, nf:]], dim=1)


def final_norm_apply(cfg: ArchConfig, p_norm, x):
    if cfg.family == "encoder":
        return L.layer_norm(x, p_norm["w"], p_norm["b"], cfg.norm_eps)
    return L.rms_norm(x, p_norm, cfg.norm_eps)


def head_of(params):
    """The LM head (d, V): ``head``, or the embedding's transpose where
    the embeddings are tied."""
    head = params.get("head")
    return params["embed"]["tok"].T if head is None else head


def head_logits(cfg: ArchConfig, x, head):
    """x @ head over the config's ``logits_scaling``."""
    logits = x @ head
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def lm_logits(cfg: ArchConfig, params, x):
    x = final_norm_apply(cfg, params["final_norm"], x)
    return head_logits(cfg, x, head_of(params))


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
    """(b, s) positions 0..s-1 of a full-sequence batch; for M-RoPE the
    batch's (3, b, s) ``mrope_pos``, or the text-style fallback (all three
    streams the linear position)."""
    base = torch.arange(s, device=batch["tokens"].device).expand(b, s)
    if cfg.rope == "mrope":
        return batch["mrope_pos"] if "mrope_pos" in batch \
            else base.expand(3, b, s)
    return base


def forward(cfg: ArchConfig, opts: ModelOptions, params, batch: dict,
            mode: str = "train", cache=None, kv_offset=None, window: int = 0,
            layer_mask=None):
    """Full-model forward. Returns (logits, cache, aux), aux the sum over
    the real layers of the MoE load-balance term (zero for the other
    families).

    ``layer_mask`` supports stage-padded stacks (leaves longer than
    cfg.n_layers); it defaults to masking exactly the real layers.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    if mode == "decode":
        pos = kv_offset[:, None]  # (b, 1) absolute positions
        if cfg.rope == "mrope":
            pos = pos.expand(3, b, 1)
    else:
        pos = default_positions(cfg, batch, b, s)
    x = embed_tokens(cfg, params["embed"], tokens,
                     positions=pos if cfg.rope != "mrope" else None,
                     frontend_embeds=batch.get("frontend_embeds"),
                     compute_dtype=opts.compute_dtype)
    layers = layer_list(params["layers"])
    if layer_mask is None:
        layer_mask = [i < cfg.n_layers for i in range(len(layers))]
    y, cache, aux = stack_apply(cfg, opts, layers, x, pos=pos,
                                mode=mode, cache=cache,
                                shared_params=params.get("shared"),
                                kv_offset=kv_offset, window=window,
                                layer_mask=layer_mask)
    return lm_logits(cfg, params, y), cache, aux


def loss_fn(cfg: ArchConfig, opts: ModelOptions, params, batch: dict):
    """Mean next-token CE of a train batch ({tokens, labels[, loss_mask]})
    through the single-device forward, plus for the moe family ``coef ·
    aux / n_layers`` (the reference's normalisation here; the pipelined
    step's differs, see ``core.pipeline.make_train_step``)."""
    logits, _, aux = forward(cfg, opts, params, batch, mode="train")
    loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    if cfg.moe is not None:
        loss = loss + cfg.moe.load_balance_coef * aux / max(cfg.n_layers, 1)
    return loss


def greedy_generate(cfg: ArchConfig, opts: ModelOptions, params, prompt,
                    max_new_tokens: int, max_seq: int, cache_dtype,
                    window: int = 0) -> list:
    """Single-device greedy decode of one prompt (the serving oracle):
    prefill the prompt into a dense cache, then decode one token at a time.
    The cache is sized to the (possibly stage-padded) layer stack."""
    device = params["embed"]["tok"].device
    n_stack = n_stacked_layers(params["layers"])
    cache = init_cache(cfg, 1, max_seq, cache_dtype=cache_dtype,
                       n_layers=n_stack, device=device)
    toks = torch.as_tensor(np.asarray(prompt)[None], device=device)
    logits, cache, _ = forward(cfg, opts, params, {"tokens": toks},
                               mode="prefill", cache=cache, window=window)
    out = [int(torch.argmax(logits[0, -1]))]
    for t in range(max_new_tokens - 1):
        logits, cache, _ = forward(
            cfg, opts, params,
            {"tokens": torch.tensor([[out[-1]]], device=device)},
            mode="decode", cache=cache, window=window,
            kv_offset=torch.tensor([len(prompt) + t], device=device))
        out.append(int(torch.argmax(logits[0, 0])))
    return out


# ---------------------------------------------------------------------------
# The paper's 1.2M-param feed-forward workload (a uniform hidden stack, so it
# maps onto the same embed / stage / head structure)
# ---------------------------------------------------------------------------


def mlp_init(mlp_cfg, gen: torch.Generator, dtype=torch.float32,
             device=None):
    """{"embed": {w (d_in, h), b}, "layers": {w (n_hidden, h, h), b
    (n_hidden, h)}, "head": {w (h, d_out), b}}: weights N(0, 1/fan_in),
    biases 0, as the reference's ``mlp_init`` (whose ``jax.random`` draws
    differ: tests load its weights through :func:`params_from_numpy`)."""
    nrm = lambda shape, fan: _normal(gen, shape, fan, dtype, device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    h = mlp_cfg.d_hidden
    return {
        "embed": {"w": nrm((mlp_cfg.d_in, h), mlp_cfg.d_in), "b": zeros(h)},
        "layers": {"w": nrm((mlp_cfg.n_hidden, h, h), h),
                   "b": zeros(mlp_cfg.n_hidden, h)},
        "head": {"w": nrm((h, mlp_cfg.d_out), h),
                 "b": zeros(mlp_cfg.d_out)},
    }


def mlp_forward(params, x, layer_mask=None):
    """x (b, d_in) -> logits (b, d_out): ReLU layers; a hidden layer whose
    ``layer_mask`` entry is False passes its input through."""
    h = torch.relu(x @ params["embed"]["w"] + params["embed"]["b"])
    for i in range(params["layers"]["w"].shape[0]):
        if layer_mask is None or layer_mask[i]:
            h = torch.relu(h @ params["layers"]["w"][i]
                           + params["layers"]["b"][i])
    return h @ params["head"]["w"] + params["head"]["b"]


def mlp_loss(params, batch):
    """Mean CE of ``batch`` {"x" (b, d_in), "y" (b,)}."""
    logits = mlp_forward(params, batch["x"])
    return cross_entropy(logits[:, None, :], batch["y"][:, None])
