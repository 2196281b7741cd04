"""Attention, MoE, Mamba1 and hybrid blocks and the KV-cache ops in
PyTorch.

Port of ``repro/models/blocks.py`` for the dense attention family (with
the ``audio`` and ``vlm`` backbones and the non-causal ``encoder``), the
``moe`` family (attention + a top-k expert FFN), the Mamba1 (``ssm``)
family and the Zamba2 ``hybrid`` family (a Mamba2 backbone plus one shared
attention block applied at every ``attn_every``-th layer). A block is one
layer — pre-norm attention + pre-norm FFN with residuals, or a pre-norm
Mamba1 / Mamba2 mixer with a residual — called as

    y, cache, aux = block_fn(cfg, opts, p, x, pos=..., cache=..., mode=...)

as in the reference: ``aux`` is the MoE block's load-balance term (a 0-d
fp32 tensor; zero for the other families). ``n_shards`` splits the rows
into that many contiguous data shards, each routed by the MoE FFN on its
own (the reference routes inside ``shard_map``); the other blocks ignore
it.

Where the reference threads caches functionally (JAX returns a new pool),
the port updates cache tensors **in place** (``index_copy_`` on the pool,
slice assignment on dense strips, a masked copy of SSM / conv states) and
returns the same tensors: the serve pool is tens of GB at full width, and a
copy per layer per call would double it. Callers that need the old
contents clone them first. The reference's serve pipeline keeps the old
cache rows of every row outside a call (``put_cache`` with its row mask);
here ``write_mask`` (b,) gates the in-place writes themselves, so a row
that rides along in another row's call leaves its K/V and its recurrent
state untouched.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.models.layers import ModelOptions


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------


def paged_kv_scatter(cache, k, v, block_tables, kv_offset, write_mask=None):
    """Scatter a (b, s) chunk of new K/V into the shared block pool, in place.

    cache {'k','v'}: (n_blocks, block_size, h_kv, hd) — the pool, shared by
    every row. block_tables (b, max_blocks) physical ids, -1 = unallocated;
    kv_offset (b,) is each row's cache depth. ``write_mask`` is (b,) rows or
    (b, s) per token. Masked entries write nothing, and neither do tokens
    past table capacity (``pos // bs >= max_blocks``): clipping the block
    index instead would alias them onto the row's *last* allocated block
    and silently corrupt its cached K/V. Returns the (same) pool dict.
    """
    b, s = k.shape[0], k.shape[1]
    nb, bs = cache["k"].shape[0], cache["k"].shape[1]
    max_blocks = block_tables.shape[1]
    pos = kv_offset.long()[:, None] + torch.arange(s, device=k.device)[None]
    blk = (pos // bs).clamp(0, max_blocks - 1)
    phys = torch.gather(block_tables.long(), 1, blk)  # (b, s)
    ok = (phys >= 0) & (pos // bs < max_blocks)
    if write_mask is not None:
        ok = ok & (write_mask if write_mask.ndim == 2 else write_mask[:, None])
    sel = ok.reshape(-1).nonzero().squeeze(1)  # the one host sync
    flat = (phys * bs + pos % bs).reshape(-1).index_select(0, sel)
    for name, new in (("k", k), ("v", v)):
        pool = cache[name].view(nb * bs, *cache[name].shape[2:])
        pool.index_copy_(0, flat, new.reshape(b * s, *new.shape[2:])
                         .index_select(0, sel).to(pool.dtype))
    return cache


def paged_kv_update(cache, k, v, block_tables, kv_offset, write_mask=None):
    """Scatter (see :func:`paged_kv_scatter`), then gather each row's full
    logical view back out through its table: the *gather path*.

    Returns (cache, k_rows, v_rows) with k_rows/v_rows
    (b, max_blocks*block_size, h_kv, hd); their garbage tail (unallocated
    blocks, stale tokens) is the caller's to mask via kv_len.
    """
    b = k.shape[0]
    nb, bs = cache["k"].shape[0], cache["k"].shape[1]
    max_blocks = block_tables.shape[1]
    paged_kv_scatter(cache, k, v, block_tables, kv_offset, write_mask)
    span = (block_tables.long().clamp(0, nb - 1)[:, :, None] * bs
            + torch.arange(bs, device=k.device)[None, None, :]
            ).reshape(b, max_blocks * bs)
    k_rows = cache["k"].view(nb * bs, *cache["k"].shape[2:])[span]
    v_rows = cache["v"].view(nb * bs, *cache["v"].shape[2:])[span]
    return cache, k_rows, v_rows


# ---------------------------------------------------------------------------
# Attention sub-block
# ---------------------------------------------------------------------------


def _dense_write(cache, k, v, start, write_mask=None, q_lens=None):
    """Write (b, s) K/V into dense (b, S_max, ...) strips at per-row start
    offsets, in place (the reference's vmapped dynamic_update_slice, whose
    start clamps so the chunk stays inside the strip). Rows whose
    ``write_mask`` entry is False are left as they were. With ``q_lens``
    (a ragged wave) only each row's first ``q_lens`` tokens are written,
    at their own positions, and targets past the strip are dropped (no
    clamp: a clamped start would shift a row's padded write back over its
    history)."""
    s, s_cache = k.shape[1], cache["k"].shape[1]
    rows = (range(k.shape[0]) if write_mask is None
            else write_mask.nonzero().flatten().tolist())
    starts = start.tolist()
    ql = None if q_lens is None else q_lens.tolist()
    for r in rows:
        if ql is None:
            o, n = min(max(int(starts[r]), 0), s_cache - s), s
        else:
            o = int(starts[r])
            n = max(min(int(ql[r]), s, s_cache - o), 0)
        cache["k"][r, o:o + n] = k[r, :n].to(cache["k"].dtype)
        cache["v"][r, o:o + n] = v[r, :n].to(cache["v"].dtype)


def attn_apply(cfg: ArchConfig, opts: ModelOptions, p, x, *, pos,
               cache=None, kv_offset=None, mode: str = "train",
               window: int = 0, causal: bool = True, block_tables=None,
               write_mask=None, q_lens=None):
    """x (b, s, d) -> (b, s, d); dense cache {'k','v'}: (b, S_max, h_kv, hd).

    ``block_tables`` switches append/decode to the paged pool layout (cache
    is then the shared (n_blocks, block_size, h_kv, hd) pool). In every
    serving mode ``write_mask`` (b,) gates which rows write this call, in
    the pool and in dense strips alike. With
    ``opts.use_paged_kernel`` attention reads the pool straight through the
    tables (``kernels.ops.paged_attention``); otherwise each row's logical
    view is gathered first. Returns (out, cache) — caches are updated in
    place.

    ``q_lens (b,)`` gives append the ragged-wave semantics of mixed and
    verify calls: each row's real query count (chunk width for a
    prefilling row, 1 for a decoding row, 0 for an idle one). Only each
    row's first ``q_lens`` tokens are written, ``kv_len`` is
    ``kv_offset + q_lens``, and the padded positions' outputs are the
    caller's to discard.
    """
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    q = L.apply_rope(q, pos, cfg)
    k = L.apply_rope(k, pos, cfg)
    if mode == "train":
        out = L.attention(q, k, v, causal=causal, window=window, opts=opts)
    elif mode == "prefill":
        # write k/v into the cache from offset 0 (windowed caches keep the
        # tail), zeroing the rest of the strip as the reference's pad does;
        # rows outside ``write_mask`` keep their strips
        s_cache = cache["k"].shape[1]
        kw, vw = (k[:, -s_cache:], v[:, -s_cache:]) if s >= s_cache else (k, v)
        n = kw.shape[1]
        rows = (slice(None) if write_mask is None
                else write_mask.nonzero().flatten())
        for name, new in (("k", kw), ("v", vw)):
            cache[name][rows, :n] = new[rows].to(cache[name].dtype)
            cache[name][rows, n:] = 0
        out = L.attention(q, k, v, causal=causal, window=window, opts=opts)
    elif mode in ("append", "decode") and block_tables is not None:
        cap = block_tables.shape[1] * cache["k"].shape[1]
        kv_len = torch.clamp(kv_offset + (s if q_lens is None else q_lens),
                             max=cap)
        wm = write_mask
        if q_lens is not None:
            # ragged wave: only each row's first q_lens tokens are real
            wm = torch.arange(s, device=x.device)[None, :] < q_lens[:, None]
            if write_mask is not None:
                wm = wm & (write_mask if write_mask.ndim == 2
                           else write_mask[:, None])
        if opts.use_paged_kernel:
            # scatter only — the kernel attends straight from the pool
            # through the tables, never building the gathered view (at sq=1
            # its causal mask equals the gather path's kv_len-only mask)
            paged_kv_scatter(cache, k, v, block_tables, kv_offset, wm)
            out = kernel_ops.paged_attention(
                q, cache["k"], cache["v"], block_tables, kv_offset, kv_len,
                causal=True, window=window, q_lens=q_lens)
        else:
            _, kf, vf = paged_kv_update(cache, k, v, block_tables, kv_offset,
                                        wm)
            if mode == "append" or window > 0:
                out = L.attention(q, kf.to(q.dtype), vf.to(q.dtype),
                                  causal=True, window=window,
                                  kv_offset=kv_offset, kv_len=kv_len,
                                  opts=opts)
            else:
                out = L.attention(q, kf.to(q.dtype), vf.to(q.dtype),
                                  causal=False, window=0, kv_offset=0,
                                  kv_len=kv_len, opts=opts)
    elif mode == "append":
        # chunked prefill into dense strips at per-row depths kv_offset
        s_cache = cache["k"].shape[1]
        _dense_write(cache, k, v, kv_offset, write_mask, q_lens)
        kv_len = torch.clamp(kv_offset + (s if q_lens is None else q_lens),
                             max=s_cache)
        out = L.attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                          causal=True, window=window, kv_offset=kv_offset,
                          kv_len=kv_len, opts=opts)
    elif mode == "decode":
        # ring-buffer insert: slot = kv_offset mod cache_len
        s_cache = cache["k"].shape[1]
        _dense_write(cache, k, v, kv_offset % s_cache, write_mask)
        kv_len = torch.clamp(kv_offset + 1, max=s_cache)
        kc, vc = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        if window > 0 and s_cache > window:
            out = L.attention(q, kc, vc, causal=True, window=window,
                              kv_offset=kv_offset, kv_len=kv_len, opts=opts)
        else:
            out = L.attention(q, kc, vc, causal=False, window=0, kv_offset=0,
                              kv_len=kv_len, opts=opts)
    else:
        raise ValueError(mode)
    return out.reshape(b, s, h * hd) @ p["wo"], cache


# ---------------------------------------------------------------------------
# Family blocks
# ---------------------------------------------------------------------------


def _no_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _pre_norm(cfg, p, x, i: int):
    """The block's i-th pre-norm: RMS (``ln{i}``), or for the encoder a
    layer norm with a bias (``ln{i}_w`` / ``ln{i}_b``)."""
    if cfg.family == "encoder":
        return L.layer_norm(x, p[f"ln{i}_w"], p[f"ln{i}_b"], cfg.norm_eps)
    return L.rms_norm(x, p[f"ln{i}"], cfg.norm_eps)


def dense_block(cfg, opts, p, x, *, pos, cache=None, kv_offset=None,
                mode="train", window: int = 0, block_tables=None,
                write_mask=None, q_lens=None, n_shards: int = 1):
    """Pre-norm attention + pre-norm MLP with residuals: the dense, audio
    and vlm families (RMS norms, causal) and the encoder (layer norms with
    biases; its train and prefill attention is non-causal, as the
    reference's)."""
    h = _pre_norm(cfg, p, x, 1)
    a, cache = attn_apply(cfg, opts, p["attn"], h, pos=pos, cache=cache,
                          kv_offset=kv_offset, mode=mode, window=window,
                          causal=cfg.family != "encoder",
                          block_tables=block_tables, write_mask=write_mask,
                          q_lens=q_lens)
    x = x + a
    h = _pre_norm(cfg, p, x, 2)
    x = x + L.mlp_apply(p["mlp"], h, cfg.act)
    return x, cache, _no_aux(x)


def moe_block(cfg, opts, p, x, *, pos, cache=None, kv_offset=None,
              mode="train", window: int = 0, block_tables=None,
              write_mask=None, q_lens=None, n_shards: int = 1):
    """Attention then the top-k expert FFN (``layers.moe_apply``), each
    pre-norm with a residual; the rows are routed per data shard."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn_apply(cfg, opts, p["attn"], h, pos=pos, cache=cache,
                          kv_offset=kv_offset, mode=mode, window=window,
                          block_tables=block_tables, write_mask=write_mask,
                          q_lens=q_lens)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    m, aux = L.moe_apply(p["moe"], h, n_experts=cfg.moe.n_experts,
                         top_k=cfg.moe.top_k,
                         capacity_factor=opts.moe_capacity_factor,
                         act=cfg.act, expert_chunk=opts.moe_expert_chunk,
                         n_shards=n_shards)
    return x + m, cache, aux


def _masked_copy(dst, src, write_mask):
    """dst := src in place, on the rows (axis 0) where ``write_mask`` holds
    (all rows when it is None); no host sync."""
    src = src.to(dst.dtype)
    if write_mask is not None:
        keep = write_mask.reshape((-1,) + (1,) * (dst.ndim - 1))
        src = torch.where(keep, src, dst)
    dst.copy_(src)


def _recurrent_block(mix, cfg, opts, p, x, cache, write_mask):
    """norm -> ``mix`` (a Mamba mixer) -> residual; the cache {'ssm',
    'conv'} is read as the incoming state and overwritten in place with
    the new one on the rows ``write_mask`` allows."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    ssm_s = cache["ssm"] if cache is not None else None
    conv_s = cache["conv"] if cache is not None else None
    y, new_ssm, new_conv = mix(p["mamba"], h, cfg, ssm_s, conv_s, opts)
    if cache is not None:
        _masked_copy(cache["ssm"], new_ssm, write_mask)
        _masked_copy(cache["conv"], new_conv, write_mask)
    return x + y, cache, _no_aux(x)


def ssm_block(cfg, opts, p, x, *, pos, cache=None, kv_offset=None,
              mode="train", window: int = 0, block_tables=None,
              write_mask=None, q_lens=None, n_shards: int = 1):
    """Mamba1 block (falcon-mamba), cache {'ssm' (b, di, n) fp32, 'conv'
    (b, d_conv-1, di)}. (``pos`` / ``kv_offset`` / ``window`` /
    ``block_tables`` / ``q_lens`` / ``n_shards`` are accepted for
    signature uniformity: the recurrent state is O(1) per row, not
    positional, and never paged; ragged waves are attention-family
    only.)"""
    return _recurrent_block(L.mamba1_mix, cfg, opts, p, x, cache,
                            write_mask)


def hybrid_backbone_block(cfg, opts, p, x, *, pos, cache=None,
                          kv_offset=None, mode="train", window: int = 0,
                          block_tables=None, write_mask=None, q_lens=None,
                          n_shards: int = 1):
    """Zamba2 backbone layer: the Mamba2 mixer, cache {'ssm' (b, nh, hd,
    n) fp32, 'conv' (b, d_conv-1, di + 2·g·n)}; the other keywords as
    :func:`ssm_block`'s."""
    return _recurrent_block(L.mamba2_mix, cfg, opts, p, x, cache,
                            write_mask)


def shared_attn_block(cfg, opts, p, x, *, pos, cache=None, kv_offset=None,
                      mode="train", window: int = 0, write_mask=None):
    """Zamba2's shared attention + SwiGLU MLP block (one set of weights
    for every site). ``cache`` is one site's dense K/V strips {'k', 'v'}
    (b, seq, h_kv, hd), updated in place on the rows ``write_mask``
    allows (the reference's ``put_cache`` row mask)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn_apply(cfg, opts, p["attn"], h, pos=pos, cache=cache,
                          kv_offset=kv_offset, mode=mode, window=window,
                          write_mask=write_mask)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, "swiglu"), cache


BLOCK_FNS = {"dense": dense_block, "audio": dense_block,
             "vlm": dense_block, "encoder": dense_block, "moe": moe_block,
             "ssm": ssm_block, "hybrid": hybrid_backbone_block}


def block_fn_for(cfg: ArchConfig):
    return BLOCK_FNS[cfg.family]


# ---------------------------------------------------------------------------
# Per-layer cache structure
# ---------------------------------------------------------------------------


def layer_cache_shape(cfg: ArchConfig, batch: int, max_seq: int,
                      cache_dtype=torch.bfloat16) -> dict:
    """(shape, dtype) for ONE layer's dense cache (no leading layer dim).
    The ``ssm`` and ``hybrid`` families keep their recurrent state in fp32
    whatever the cache dtype, and their conv window in the cache dtype."""
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        return {"ssm": ((batch, di, s.d_state), torch.float32),
                "conv": ((batch, s.d_conv - 1, di), cache_dtype)}
    if cfg.family == "hybrid":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        nh = s.n_ssm_heads(cfg.d_model)
        conv_dim = di + 2 * s.n_groups * s.d_state
        return {"ssm": ((batch, nh, s.head_dim, s.d_state), torch.float32),
                "conv": ((batch, s.d_conv - 1, conv_dim), cache_dtype)}
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, cache_dtype), "v": (shape, cache_dtype)}


def shared_cache_shape(cfg: ArchConfig, batch: int, max_seq: int,
                       cache_dtype=torch.bfloat16, window: int = 0):
    """(shape, dtype) for ONE shared-attention site's K/V strips (hybrid
    archs; None otherwise). ``window`` > 0 bounds the strips to the
    sliding window (a ring buffer in decode)."""
    if cfg.hybrid is None:
        return None
    seq = min(max_seq, window) if window > 0 else max_seq
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, cache_dtype), "v": (shape, cache_dtype)}
