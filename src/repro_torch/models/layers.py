"""Core dense layers in PyTorch: RMSNorm, rotary embeddings (1d / 2d-half),
GQA attention (direct / chunked online-softmax) and the SwiGLU/GELU MLP.

Port of ``repro/models/layers.py`` (attention family only — MoE, Mamba and
M-RoPE wait for their slices). Functions keep the reference's tensor layouts
(``(b, s, h, hd)`` activations, ``(d, f)`` weights) so the tests compare like
with like. Everything is a plain function on tensors; the pipeline engine
stacks layers along a leading axis exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution knobs (not architecture): activation precision and the
    attention implementation. (Parameter dtype is the caller's: whatever
    the params were made in; the reference's ``param_dtype`` and remat
    knobs are not ported.)"""

    compute_dtype: torch.dtype = torch.float32
    attn_q_chunk: int = 2048  # online-softmax chunking of the direct path
    attn_kv_chunk: int = 1024
    use_paged_kernel: bool = False  # paged decode/append attends straight
    # from the block pool (kernels/paged_attention.py) instead of gathering
    # each row's full logical K/V view


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


# ---------------------------------------------------------------------------
# Rotary position embeddings (1d / 2d-half)
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
    raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")


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
    (max, denom, accum) — the reference's ``lax.scan`` as a Python loop
    (forward only: the port serves, it does not train yet).
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
    blocks = []
    for qi in range(n_q):
        q0 = qi * q_chunk
        qg = qp[:, q0:q0 + q_chunk].reshape(b, q_chunk, hkv, g, hd)
        qpos = qpos_all[:, q0:q0 + q_chunk]
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
            p = torch.exp(s - m_safe[..., None]) * msk
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                torch.zeros_like(m))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (b, hkv, g, qc, hd) -> (b, qc, hq, hd)
        blocks.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq, hd)
                      .to(q.dtype))
    return torch.cat(blocks, dim=1)[:, :sq]


def attention(q, k, v, *, causal: bool, window: int = 0, kv_offset=0,
              kv_len=None, opts: ModelOptions):
    """Dispatch: direct softmax when the score tensor is small (decode
    scores are linear in cache length), else chunked online softmax. (The
    reference's flash-kernel branch serves training and static prefill
    only; it ports with Hydra training.)"""
    sq, sk = q.shape[1], k.shape[1]
    if sq == 1 or sq * sk <= 512 * 512:
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
