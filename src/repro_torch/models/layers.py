"""Core layers in PyTorch: RMS/layer norm (and Mamba2's gated RMS norm),
rotary embeddings (1d / 2d-half / M-RoPE), GQA attention (flash kernel / chunked
online-softmax / direct), the SwiGLU/GELU MLP, the top-k MoE FFN with
capacity-bounded scatter dispatch, the Mamba1 selective-scan mixer and the
Mamba2 (SSD) mixer.

Port of ``repro/models/layers.py`` (attention family, M-RoPE, MoE,
Mamba1 and Mamba2). Functions keep the reference's
tensor layouts (``(b, s, h, hd)`` activations, ``(d, f)`` weights) so the
tests compare like with like. Everything is a plain function on tensors;
the pipeline engine stacks layers along a leading axis exactly as the
reference does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.obs import tracer as obs_tracer


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution knobs (not architecture): activation precision, remat and
    the attention implementation. (Parameter dtype is the caller's:
    whatever the params were made in; the reference's ``param_dtype`` is
    not ported.)"""

    compute_dtype: torch.dtype = torch.float32
    remat: bool = False  # activation-checkpoint each block (train mode)
    attn_q_chunk: int = 2048  # online-softmax chunking of the direct path
    attn_kv_chunk: int = 1024
    use_flash_kernel: bool = False  # full-sequence attention through
    # kernels.ops.flash_attention (the CUDA kernel on a card)
    use_mamba_kernel: bool = False  # Mamba1 prefill / append scans through
    # kernels.ops.mamba_scan (the CUDA kernel on a card) instead of the
    # chunked scan
    use_paged_kernel: bool = False  # paged decode/append attends straight
    # from the block pool (kernels/paged_attention.py) instead of gathering
    # each row's full logical K/V view
    moe_capacity_factor: float = 1.25
    moe_expert_chunk: int = 0  # >0: run the expert FFNs in groups of this
    # size, each rematerialized in backward (bounds the weight-gradient
    # transients to one group's worth)


def kernel_options(cfg: ArchConfig, **kw) -> ModelOptions:
    """Options with the kernel of ``cfg``'s family's path on — K1
    (``use_flash_kernel``) for the attention of the dense, moe, audio, vlm
    and encoder (non-causal) families, the hybrid family's shared block
    and the hybrid_moe family's attention layers, K3
    (``use_mamba_kernel``) for the ssm family's scans — and ``kw`` (the
    launchers' choice)."""
    return ModelOptions(
        use_flash_kernel=cfg.family in ("dense", "moe", "hybrid", "audio",
                                        "vlm", "encoder", "hybrid_moe"),
        use_mamba_kernel=cfg.family == "ssm", **kw)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * w + b


def gated_rms_norm(x, gate, w, eps: float = 1e-5):
    """Mamba2 output norm: RMSNorm(x * silu(gate))."""
    return rms_norm(x * F.silu(gate), w, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (1d / 2d-half / M-RoPE)
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (..., s) -> cos/sin (..., s, head_dim//2)."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """x (..., s, h, d) with cos/sin (..., s, d//2): rotate the two halves."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x, positions, cfg: ArchConfig):
    """Apply the config's rotary variant. x: (b, s, h, hd).

    - "1d": standard rotary over the full head dim.
    - "2d": ChatGLM-style — rotary on the first half of the head dim only.
    - "mrope": Qwen2-VL — the hd // 2 rotation *pairs* split in 3 sections
      (1/4 temporal, 3/8 height, the rest width: 16, 24, 24 at hd 128),
      each section's pairs turned by its own position stream at the same
      pairs' frequencies of ``_rope_freqs(hd)``; ``positions`` (3, b, s).
    - "none"/"learned": identity (positions handled at the embedding).
    """
    if cfg.rope in ("none", "learned"):
        return x
    hd = cfg.head_dim
    if cfg.rope == "1d":
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        return _rotate(x, cos, sin)
    if cfg.rope == "2d":
        rot, keep = x[..., :hd // 2], x[..., hd // 2:]
        cos, sin = rope_cos_sin(positions, hd // 2, cfg.rope_theta)
        return torch.cat([_rotate(rot, cos, sin), keep], dim=-1)
    if cfg.rope == "mrope":
        half = hd // 2
        s_t = half // 4
        s_h = (half - s_t) // 2
        bounds = [0, s_t, s_t + s_h, half]
        freqs = _rope_freqs(hd, cfg.rope_theta, positions.device)
        ang = torch.cat([positions[i].float()[..., None]
                         * freqs[bounds[i]:bounds[i + 1]]
                         for i in range(3)], dim=-1)
        return _rotate(x, torch.cos(ang), torch.sin(ang))
    raise ValueError(cfg.rope)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _positions(kv_offset, sq: int, device):
    """Query positions: (1, sq, 1) for a scalar offset, (b, sq, 1) per row."""
    qi = torch.arange(sq, device=device)
    if not torch.is_tensor(kv_offset) or kv_offset.ndim == 0:
        return (qi + int(kv_offset))[None, :, None]
    return kv_offset.to(device)[:, None, None] + qi[None, :, None]


def _mask(qpos, kpos, causal: bool, window: int, kv_len):
    """(b|1, 1, 1, sq, sk) bool mask over (row, kv head, group, q, k)."""
    mask = torch.ones(qpos.shape[0], qpos.shape[1], kpos.shape[-1],
                      dtype=torch.bool, device=qpos.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    mask = mask[:, None, None]
    if kv_len is not None:
        mask = mask & (kpos[None, None] < kv_len[:, None, None, None, None])
    return mask


def attention_reference(q, k, v, *, causal: bool, window: int = 0,
                        kv_offset=0, kv_len=None):
    """Direct softmax attention with grouped-query support.

    q (b,sq,hq,hd), k/v (b,sk,hkv,hd) with hq = g·hkv; GQA is a grouped
    einsum (kv never expanded). ``kv_offset`` is the absolute position of
    q[0] minus that of k[0] — a scalar, or a (b,) tensor for rows at
    different cache depths. ``kv_len`` (b,) masks kv positions >= kv_len;
    ``window`` > 0 restricts to a sliding window. Fully masked rows give 0.
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    qpos = _positions(kv_offset, sq, q.device)
    kpos = torch.arange(sk, device=q.device)[None, None, :]
    mask = _mask(qpos, kpos, causal, window, kv_len)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v)
    return out.reshape(b, sq, hq, hd)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      kv_offset=0, kv_len=None, q_chunk: int = 2048,
                      kv_chunk: int = 1024):
    """Flash-style online-softmax attention, O(chunk) memory, GQA aware.

    Outer loop over q chunks, inner loop over kv chunks with running fp32
    (max, denom, accum) — the reference's ``lax.scan`` as a Python loop.
    Differentiable: when autograd records, each q chunk is a
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` on
    ``q_block``), so backward recomputes one chunk's score blocks at a time
    instead of stashing all of them. Fully masked rows (outside a window,
    or padding past ``sq``) give 0 and a zero, not NaN, gradient: masked
    scores enter ``exp`` as exact ``-inf`` and the final division is by
    ``l`` or 1 where ``l == 0`` (``l >= 1`` for any row with a live key,
    so this equals the reference's ``max(l, 1e-30)``).
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    n_q, n_k = -(-sq // q_chunk), -(-sk // kv_chunk)
    sq_p, sk_p = n_q * q_chunk, n_k * kv_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    scale = 1.0 / math.sqrt(hd)
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    qpos_all = _positions(kv_offset, sq_p, q.device)

    def q_block(q_blk, qpos, kp, vp):
        qg = q_blk.reshape(b, q_chunk, hkv, g, hd)
        m = torch.full((b, hkv, g, q_chunk), float("-inf"),
                       device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, hd), device=q.device)
        for ki in range(n_k):
            k0 = ki * kv_chunk
            k_blk, v_blk = kp[:, k0:k0 + kv_chunk], vp[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk).float() * scale
            kpos = (k0 + torch.arange(kv_chunk, device=q.device))[None,
                                                                  None, :]
            msk = _mask(qpos, kpos, causal, window, kv_len)
            s = s.masked_fill(~msk, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])  # masked: exp(-inf) = 0
            alpha = torch.exp(m - m_safe)  # 0 while m is still -inf
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk.float())
            m = m_new
        out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
        # (b, hkv, g, qc, hd) -> (b, qc, hq, hd)
        return out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq,
                                                  hd).to(q.dtype)

    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    blocks = []
    for qi in range(n_q):
        q0 = qi * q_chunk
        args = (qp[:, q0:q0 + q_chunk], qpos_all[:, q0:q0 + q_chunk], kp, vp)
        blocks.append(checkpoint(q_block, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if record else q_block(*args))
    return torch.cat(blocks, dim=1)[:, :sq]


DIRECT_ATTENTION_SCORES = 512 * 512  # the most scores a row computes directly


def attention(q, k, v, *, causal: bool, window: int = 0, kv_offset=0,
              kv_len=None, opts: ModelOptions):
    """Dispatch, under the reference's conditions: the flash kernel
    (``opts.use_flash_kernel``, more than one query, no ragged ``kv_len``,
    one scalar offset — training and full-sequence prefill); else direct
    softmax when the score tensor is small (decode scores are linear in
    cache length); else chunked online softmax."""
    sq, sk = q.shape[1], k.shape[1]
    if opts.use_flash_kernel and sq > 1 and kv_len is None \
            and not (torch.is_tensor(kv_offset) and kv_offset.ndim > 0):
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.flash_attention(
            q, k, v, causal=causal, window=window, kv_offset=int(kv_offset))
    if sq == 1 or sq * sk <= DIRECT_ATTENTION_SCORES:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   kv_offset=kv_offset, kv_len=kv_len)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             kv_offset=kv_offset, kv_len=kv_len,
                             q_chunk=opts.attn_q_chunk,
                             kv_chunk=opts.attn_kv_chunk)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_apply(p, x, act: str):
    if act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        return (F.silu(g) * u) @ p["w_down"]
    h = x @ p["w_up"]
    return F.gelu(h, approximate="tanh") @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (scatter dispatch into capacity-bounded buckets)
# ---------------------------------------------------------------------------


def _expert_ffn(w_gate, w_up, w_down, buckets, act: str):
    """Dense FFN of a group of experts: buckets (e, c, d) against weights
    (e, d, f) / (e, f, d), one batched matmul per projection."""
    if act == "swiglu":
        h = F.silu(torch.bmm(buckets, w_gate)) * torch.bmm(buckets, w_up)
    else:
        h = F.gelu(torch.bmm(buckets, w_up), approximate="tanh")
    return torch.bmm(h, w_down)


def moe_ranks(flat_e, n_experts: int):
    """Each pick's rank in its expert's bucket: for flat expert ids (G, N)
    in flat (token, pick) order, the number of earlier picks of the same
    expert in the same row (G, N), int64.

    Taken by a stable sort of each row: an expert's picks keep their flat
    order in the sorted run, so a pick's rank is its place there less the
    place where its expert's run starts. That is O(N) work with no (N, E)
    tensor, where a cumulative sum over a one-hot is, on the card, a
    serial walk of all N picks in each of only G·E columns."""
    g_n, n = flat_e.shape
    sorted_e, by_e = torch.sort(flat_e, dim=1, stable=True)
    # each expert's first place in the sorted run (G, E): the number of
    # picks of the lower experts
    start = torch.searchsorted(sorted_e, torch.arange(
        n_experts, device=flat_e.device).expand(g_n, n_experts).contiguous())
    place = torch.empty_like(flat_e).scatter_(1, by_e, torch.arange(
        n, device=flat_e.device).expand(g_n, n))
    return place - start.gather(1, flat_e)


def moe_route(router, x, *, n_experts: int, top_k: int,
              capacity_factor: float, n_shards: int = 1):
    """The routing decisions of :func:`moe_apply` for x (b, s, d), each of
    ``n_shards`` contiguous row groups on its own: fp32 softmax over the
    router logits, top-k with ties to the lower expert id (``lax.top_k``'s
    rule; a stable descending sort, since ``torch.topk`` promises no
    order), gates renormalised over the k picks (floor 1e-9), and each
    (token, pick) ranked in its expert's bucket by a cumulative count in
    flat (t, k) order (:func:`moe_ranks`), so earlier tokens win the
    capacity ``C = max(int(cf · t · k / E), k)``. Returns (probs (G, t,
    E), gates (G, t, k), expert ids (G, t, k), ranks (G, t·k), C); a pick
    is kept where rank < C."""
    b, s, d = x.shape
    if b % n_shards:
        raise ValueError(f"{b} rows do not split into {n_shards} shards")
    t = b // n_shards * s
    logits = (x.reshape(n_shards, t, d) @ router).float()  # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = vals[..., :top_k], order[..., :top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    cap = max(int(capacity_factor * t * top_k / n_experts), top_k)
    rank = moe_ranks(expert_idx.reshape(n_shards, t * top_k), n_experts)
    return probs, gates, expert_idx, rank, cap


def moe_apply(p, x, *, n_experts: int, top_k: int, capacity_factor: float,
              act: str = "swiglu", expert_chunk: int = 0, n_shards: int = 1,
              held=None):
    """Top-k MoE FFN. x (b, s, d) -> ((b, s, d), load-balance aux).

    Each of ``n_shards`` contiguous groups of ``b / n_shards`` rows is
    routed on its own (:func:`moe_route`), as the reference routes each
    data shard's local rows inside ``shard_map``: its own capacity, bucket
    ranks and drops, its own Switch aux; the shards ride a leading axis of
    batched ops, and the aux returned is the mean over shards. Overflowing
    picks are dropped (the residual path keeps those tokens); the expert
    products run dense over the (E, C) buckets, each row filled from its
    token and added back to it times its gate (gates cast to x's dtype).
    Nothing here waits on the host: a dropped pick is scattered into a
    scratch row past the E · C bucket rows, sliced away, and an empty row
    reads and writes a zero row past the tokens, so no mask ever becomes
    an index list.

    ``held`` (first id, count): the experts whose weights ``p`` holds (one
    card's share under expert parallelism; None: all ``n_experts``).
    Routing, capacity and the aux stay over all experts; picks of the
    held experts fill their buckets, and picks of the others go to the
    scratch row as dropped picks do, so the result is the held experts'
    part of the layer's. ``p["shared"]``, where present, is a shared
    SwiGLU expert that every token passes through, added to the result.
    In the forward pass of a train step with an enabled tracer
    (``obs.tracer.current()``) it counts ``moe_bucket_rows`` (held experts
    × capacity × shards) and, on the device, ``moe_local_picks`` (picks
    of the held experts) and ``moe_dropped_picks`` (those past capacity).
    """
    b, s, d = x.shape
    g_n, e_n, k = n_shards, n_experts, top_k
    probs, gate_vals, expert_idx, rank, cap = moe_route(
        p["router"], x, n_experts=e_n, top_k=k,
        capacity_factor=capacity_factor, n_shards=g_n)
    t = b // g_n * s
    flat_e = expert_idx.reshape(g_n, t * k)
    first, e_h = (0, e_n) if held is None else held
    rows = e_h * cap + 1  # bucket rows per shard, the scratch row last
    if held is None:
        local_e, mine, keep = flat_e, None, rank < cap
    else:
        local_e = flat_e - first  # the held experts' ids from 0
        mine = (local_e >= 0) & (local_e < e_h)
        keep = (rank < cap) & mine
    dest = torch.where(keep, local_e * cap + rank,
                       torch.full_like(rank, rows - 1))
    tr = obs_tracer.current()
    if tr.enabled and tr.train_pass == "forward":
        tr.count("moe_bucket_rows", g_n * e_h * cap)
        routed = rank >= 0 if mine is None else mine
        tr.count_on_device(("moe_local_picks", "moe_dropped_picks"),
                           torch.stack([routed.sum(),
                                        (routed & ~keep).sum()]))
    dest = (dest + torch.arange(g_n, device=x.device)[:, None] * rows
            ).reshape(-1)
    # each bucket row's token and gate, scattered from the picks: an empty
    # row takes the zero row past the tokens and gate 0, a scratch row
    # whichever pick wrote it last (it is sliced away); so the buckets and
    # the combine move E·C rows of d, never t·k
    n_tok = g_n * t
    row_tok = torch.full((g_n * rows,), n_tok, dtype=torch.long,
                         device=x.device).scatter_(
        0, dest, torch.arange(n_tok, device=x.device).repeat_interleave(k))
    row_gate = torch.zeros((g_n * rows,), dtype=x.dtype,
                           device=x.device).scatter(
        0, dest, gate_vals.reshape(-1).to(x.dtype))
    live = row_tok.reshape(g_n, rows)[:, :-1].reshape(-1)
    x_rows = torch.cat([x.reshape(n_tok, d), x.new_zeros((1, d))])
    # (G, E·C) live rows -> (E, G·C, d): one bmm per projection over all
    # shards' buckets
    buckets = (x_rows.index_select(0, live).reshape(g_n, e_h, cap, d)
               .transpose(0, 1).reshape(e_h, g_n * cap, d))
    w = [p[n] for n in ("w_gate", "w_up", "w_down")] if act == "swiglu" \
        else [None, p["w_up"], p["w_down"]]
    if expert_chunk and 0 < expert_chunk < e_h and e_h % expert_chunk == 0:
        record = torch.is_grad_enabled() and (
            x.requires_grad or any(w_ is not None and w_.requires_grad
                                   for w_ in w))
        ys = []
        for e0 in range(0, e_h, expert_chunk):
            part = [None if w_ is None else w_[e0:e0 + expert_chunk]
                    for w_ in w]
            args = (*part, buckets[e0:e0 + expert_chunk], act)
            ys.append(checkpoint(_expert_ffn, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if record else _expert_ffn(*args))
        y = torch.cat(ys)
    else:
        y = _expert_ffn(*w, buckets, act)
    y = y.reshape(e_h, g_n, cap, d).transpose(0, 1).reshape(-1, d)
    gate = row_gate.reshape(g_n, rows)[:, :-1].reshape(-1, 1)
    out = torch.zeros((n_tok + 1, d), dtype=x.dtype, device=x.device
                      ).index_add(0, live, y * gate)[:n_tok].reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, "swiglu")

    # load-balance auxiliary loss (Switch-style), per shard, over all experts
    me = probs.mean(dim=1)  # (G, E)
    ce = torch.zeros((g_n, e_n), device=x.device).scatter_add_(
        1, flat_e, torch.ones(flat_e.shape, device=x.device)) / (t * k)
    aux = e_n * (me * ce).sum(dim=-1)
    return out, aux.mean()


# ---------------------------------------------------------------------------
# Mamba1 (selective scan)
# ---------------------------------------------------------------------------


def _causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv. x (bt, s, c), w (c, width), state
    (bt, width-1, c). Returns (y, new_state) where new_state is the
    trailing (width-1) inputs."""
    width = w.shape[-1]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xe = torch.cat([state, x], dim=1)  # promotes as jnp.concatenate
    # depthwise conv as a sum of shifted slices (width is tiny, typically 4)
    s = x.shape[1]
    y = sum(xe[:, i:i + s] * w[:, i] for i in range(width))
    y = y + b
    new_state = xe[:, -(width - 1):] if width > 1 else state
    return y, new_state


def _selective_scan_chunk(h, da, dbx, cmat):
    """One chunk of the sequential scan: h (b, di, n) fp32, da / dbx
    (b, ck, di, n), cmat (b, ck, n) -> (h_new, y (b, ck, di))."""
    hs = []
    for t in range(da.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        hs.append(h)
    return h, torch.einsum("sbin,bsn->bsi", torch.stack(hs), cmat)


def mamba1_mix(p, x, cfg: ArchConfig, ssm_state=None, conv_state=None,
               opts: ModelOptions | None = None):
    """Mamba1 selective-scan mixer. x (b, s, d) -> (b, s, d).

    Decode (s == 1): one recurrent step against (conv_state, ssm_state).
    Prefill / append: the CUDA kernel through ``kernels.ops.mamba_scan``
    (``opts.use_mamba_kernel``; its plain version on a CPU tensor), else the
    chunked scan over time, padded steps masked to identity decay (each
    chunk a ``torch.utils.checkpoint`` when autograd records, the
    reference's ``jax.checkpoint``). ``da``, ``dbx`` and ``C`` are fp32
    whatever the compute dtype; ``y`` plus the ``D`` skip is cast to x's
    dtype before the ``silu(z)`` gate. Returns (y, new_ssm_state,
    new_conv_state); the caller writes the states back.
    """
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di, n = s_cfg.d_inner(cfg.d_model), s_cfg.d_state
    r = s_cfg.resolved_dt_rank(cfg.d_model)
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xin, new_conv = _causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)
    a = -torch.exp(p["A_log"].float())  # (di, n)

    def ssm_inputs(x_chunk):
        """x_chunk (b, t, di) -> decay da (b,t,di,n), input dbx (b,t,di,n),
        C (b,t,n)."""
        proj = x_chunk @ p["x_proj"]
        dt_in, bmat, cmat = proj.split([r, n, n], dim=-1)
        dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"]).float()
        da = torch.exp(dt[..., None] * a)
        dbx = (dt * x_chunk.float())[..., None] * bmat.float()[:, :, None, :]
        return da, dbx, cmat.float()

    if ssm_state is None:
        ssm_state = torch.zeros((b, di, n), dtype=torch.float32,
                                device=x.device)

    if s == 1:
        da, dbx, cmat = ssm_inputs(xin)
        new_state = da[:, 0] * ssm_state + dbx[:, 0]  # (b, di, n)
        y = torch.einsum("bin,bn->bi", new_state, cmat[:, 0])[:, None]
    elif opts is not None and opts.use_mamba_kernel:
        from repro_torch.kernels import ops as kernel_ops
        y, new_state = kernel_ops.mamba_scan(*ssm_inputs(xin), ssm_state)
    else:
        ck = min(s_cfg.chunk_size, s)
        s_p = -(-s // ck) * ck
        xin_p = F.pad(xin, (0, 0, 0, s_p - s))
        valid = (torch.arange(s_p, device=x.device) < s)[None, :, None, None]

        def chunk_body(h, x_chunk, v_chunk):
            da, dbx, cmat = ssm_inputs(x_chunk)
            # padded steps must not decay the carried state
            da = torch.where(v_chunk, da, torch.ones_like(da))
            dbx = torch.where(v_chunk, dbx, torch.zeros_like(dbx))
            return _selective_scan_chunk(h, da, dbx, cmat)

        record = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xin, *p.values()))
        h, ys = ssm_state.float(), []
        for c0 in range(0, s_p, ck):
            args = (h, xin_p[:, c0:c0 + ck], valid[:, c0:c0 + ck])
            h, y_c = (checkpoint(chunk_body, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if record else chunk_body(*args))
            ys.append(y_c)
        new_state = h
        y = torch.cat(ys, dim=1)[:, :s]

    y = (y + xin.float() * p["D"]).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], new_state, new_conv


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked)
# ---------------------------------------------------------------------------


def _ssd_chunk(h_enter, da_k, xh_k, bm_k, cm_k, dt_k, v_k):
    """One chunk of the state-space dual form: h_enter (b, nh, hd, n) fp32;
    da / dt (b, ck, nh), xh (b, ck, nh, hd), bm / cm (b, ck, g, n) (each
    group's, repeated here to its nh / g heads), all fp32; v_k (ck,) marks
    the real (unpadded) steps. Returns (h_exit, y (b, ck, nh, hd))."""
    ck = da_k.shape[1]
    rep = xh_k.shape[2] // bm_k.shape[2]
    bm_k, cm_k = (t.repeat_interleave(rep, dim=2) for t in (bm_k, cm_k))
    # padded steps: no decay (log-decay 0), no input (x already 0)
    da_k = torch.where(v_k[None, :, None], da_k, torch.zeros_like(da_k))
    cum = torch.cumsum(da_k, dim=1)  # (b, ck, nh), inclusive
    # pairwise decay L[t,u] = exp(cum_t - cum_u) for u <= t (exp <= 1)
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (b, ck, ck, nh)
    tri = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                device=da_k.device))[None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)),
                        torch.zeros_like(diff))
    # intra-chunk: scores[t,u] = (C_t·B_u) L[t,u] dt_u
    gb = torch.einsum("bthn,buhn->btuh", cm_k, bm_k)
    scores = gb * decay * dt_k[:, None, :, :]
    y_intra = torch.einsum("btuh,buhe->bthe", scores, xh_k)
    # inter-chunk: decay the state entering the chunk to each position
    y_inter = torch.einsum("bthn,bhen->bthe",
                           cm_k * torch.exp(cum)[..., None], h_enter)
    # state at the chunk's end
    wexit = torch.exp(cum[:, -1:, :] - cum) * dt_k  # (b, ck, nh)
    h_in = torch.einsum("buh,buhe,buhn->bhen", wexit, xh_k, bm_k)
    h_exit = torch.exp(cum[:, -1])[:, :, None, None] * h_enter + h_in
    return h_exit, y_intra + y_inter


def mamba2_mix(p, x, cfg: ArchConfig, ssm_state=None, conv_state=None,
               opts: ModelOptions | None = None):
    """Mamba2 (SSD) mixer, chunked "state-space dual" form. x (b, s, d).

    Scalar-per-head log-decay ``da``; state (b, nh, hd, n) fp32. Decode
    (s == 1): one recurrent step against (conv_state, ssm_state). Otherwise
    the sequence is padded to a multiple of the chunk size and each chunk
    takes the attention-like form (C Bᵀ ⊙ L) X with the stable pairwise
    decay L[t,u] = exp(min(cum_t − cum_u, 0)) (t ≥ u); padded steps are
    masked to log-decay 0 and the state is carried across chunks with
    per-chunk decay. Each chunk is a ``torch.utils.checkpoint`` when
    autograd records (the reference's ``jax.checkpoint`` on
    ``chunk_body``), so the (b, ck, ck, nh) intermediates stay transient
    in training. Pure tensor code, as in the reference (no kernel: K3's
    layout is Mamba1's). Returns (y, new_ssm_state, new_conv_state); the
    caller writes the states back.
    """
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.d_inner(cfg.d_model)
    n, g = s_cfg.d_state, s_cfg.n_groups
    hd = s_cfg.head_dim
    nh = di // hd
    z, xbc, dt_in = (x @ p["in_proj"]).split([di, di + 2 * g * n, nh],
                                             dim=-1)
    xbc, new_conv = _causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xin, bmat, cmat = xbc.split([di, g * n, g * n], dim=-1)
    dt = F.softplus(dt_in.float() + p["dt_bias"])  # (b, s, nh)
    a = -torch.exp(p["A_log"].float())  # (nh,)
    xh = xin.reshape(b, s, nh, hd)
    bm = bmat.reshape(b, s, g, n)  # each group's B / C, shared by its
    cm = cmat.reshape(b, s, g, n)  # nh / g heads
    da = dt * a  # (b, s, nh) log-decay per step (<= 0)

    if ssm_state is None:
        ssm_state = torch.zeros((b, nh, hd, n), dtype=torch.float32,
                                device=x.device)

    if s == 1:
        bm, cm = (t.repeat_interleave(nh // g, dim=2) for t in (bm, cm))
        dbx = (dt[:, 0, :, None, None] * xh[:, 0, :, :, None].float()
               * bm[:, 0, :, None, :].float())  # (b, nh, hd, n)
        new_state = (torch.exp(da[:, 0])[:, :, None, None] * ssm_state
                     + dbx)
        y = torch.einsum("bhen,bhn->bhe", new_state,
                         cm[:, 0].float()).reshape(b, 1, di)
    else:
        ck = min(s_cfg.chunk_size, s)
        s_p = -(-s // ck) * ck
        pad = s_p - s
        da_p, dt_p = (F.pad(t, (0, 0, 0, pad)) if pad else t
                      for t in (da, dt))
        xh_p, bm_p, cm_p = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) if pad
                            else t.float() for t in (xh, bm, cm))
        valid = torch.arange(s_p, device=x.device) < s
        record = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *p.values()))
        h, ys = ssm_state.float(), []
        for c0 in range(0, s_p, ck):
            args = (h,) + tuple(t[:, c0:c0 + ck] for t in (
                da_p, xh_p, bm_p, cm_p, dt_p)) + (valid[c0:c0 + ck],)
            h, y_c = (checkpoint(_ssd_chunk, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if record else _ssd_chunk(*args))
            ys.append(y_c)
        new_state = h
        y = torch.cat(ys, dim=1)[:, :s].reshape(b, s, di)

    y = (y + xh.reshape(b, s, di).float()
         * p["D"].repeat_interleave(hd)).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_state, new_conv
