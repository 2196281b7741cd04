"""A hybrid Mamba2 / attention MoE decoder (HF ``granitemoehybrid``) in
plain PyTorch, written from the published description, with its loss.

A layer: ``x + r · mixer(rms(x))``, then ``x + r · (moe(h) + shared(h))``
with ``h = rms(x)`` and ``r`` the residual multiplier, the mixer by the
layer's type:

* Mamba2: ``in_proj`` to ``[z, xBC, dt]``; a depthwise causal conv (with
  bias) and SiLU over xBC, split into x, B, C (one group of B and C shared
  by every head); ``dt = softplus(dt + dt_bias)``; the state-space dual
  form of the Mamba2 paper (arXiv:2405.21060, its minimal discrete SSD
  listing) over chunks, on ``x · dt`` with the per-step log-decay ``A ·
  dt``, ``A = −exp(A_log)``; the skip ``D · x``; the gated norm
  ``rms(y · silu(z)) · w``; ``out_proj``;
* attention: GQA with no position encoding, causal, its scores scaled by
  ``attention_multiplier``;
* the MoE: the router's fp32 logits over every expert, a softmax, the
  top-k picks with their probabilities renormalised (the softmax over the
  picks' logits), and each expert this card holds run on exactly the
  tokens routed to it (dropless), one expert at a time; picks of experts
  held elsewhere add nothing here; the shared SwiGLU expert on every
  token. The load-balance term is the Switch form over all experts,
  ``n_experts · Σ_e mean_prob_e · pick_share_e``.

The embedding is multiplied by ``embedding_multiplier``; the logits are
the tied embedding's products over ``logits_scaling``.

Matrix products of the projections go through the precision's ``mm``
(``bench.reference.model.Precision``), so the reference can run as its
TF32 control; on the card TF32 reaches every product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.harness.hybrid_moe import Hybrid
from bench.reference.model import Precision, rms_norm


def segsum(x):
    """x (..., T) -> (..., T, T): entry (i, j) the sum of x[j+1 .. i] for
    j <= i, -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    out = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, a, b, c, chunk: int):
    """The minimal discrete SSD: x (n, l, h, p), a (n, l, h) log-decays,
    b / c (n, l, h, s), l a multiple of ``chunk``; a zero state enters.
    Returns y (n, l, h, p)."""
    n, l, h, p = x.shape
    nc = l // chunk
    x, b, c = (t.reshape(n, nc, chunk, *t.shape[2:]) for t in (x, b, c))
    a = a.reshape(n, nc, chunk, h).permute(0, 3, 1, 2)  # (n, h, c, l)
    a_cum = torch.cumsum(a, dim=-1)
    decay = torch.exp(segsum(a))  # (n, h, c, l, l)
    y_diag = torch.einsum("zclhs,zckhs,zhclk,zckhp->zclhp", c, b, decay, x)
    to_end = torch.exp(a_cum[..., -1:] - a_cum)  # (n, h, c, l)
    states = torch.einsum("zclhs,zhcl,zclhp->zchps", b, to_end, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("zhdc,zchps->zdhps", across, states)[:, :-1]
    y_off = torch.einsum("zclhs,zchps,zhcl->zclhp", c, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(n, l, h, p)


def mamba2(prec: Precision, hy: Hybrid, p: dict, x):
    n, l, _ = x.shape
    di, nh, hp = hy.d_inner, hy.mamba_heads, hy.mamba_head_dim
    gs = hy.n_groups * hy.d_state
    z, xbc, dt = prec.mm(x, p["mamba/in_proj"]).split([di, di + 2 * gs, nh],
                                                      dim=-1)
    xbc = F.conv1d(xbc.transpose(1, 2), p["mamba/conv_w"][:, None, :],
                   p["mamba/conv_b"], padding=hy.d_conv - 1,
                   groups=hy.conv_dim)[..., :l].transpose(1, 2)
    xs, b, c = F.silu(xbc).split([di, gs, gs], dim=-1)
    dt = F.softplus(dt + p["mamba/dt_bias"])  # (n, l, nh)
    a = -torch.exp(p["mamba/A_log"])
    xs = xs.reshape(n, l, nh, hp)
    rep = nh // hy.n_groups
    b = b.reshape(n, l, hy.n_groups, hy.d_state).repeat_interleave(rep, 2)
    c = c.reshape(n, l, hy.n_groups, hy.d_state).repeat_interleave(rep, 2)
    chunk = min(hy.chunk, l)
    pad = -l % chunk
    y = ssd(*(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (xs * dt[..., None], a * dt, b, c)), chunk)[:, :l]
    y = y + xs * p["mamba/D"][:, None]
    y = y.reshape(n, l, di)
    y = rms_norm(y * F.silu(z), p["mamba/norm_w"], hy.sizes.norm_eps)
    return prec.mm(y, p["mamba/out_proj"])


def attention(prec: Precision, hy: Hybrid, p: dict, x):
    s = hy.sizes
    n, l, _ = x.shape
    hd = s.head_dim
    q = prec.mm(x, p["attn/wq"]).reshape(n, l, s.n_heads, hd)
    k = prec.mm(x, p["attn/wk"]).reshape(n, l, s.n_kv_heads, hd)
    v = prec.mm(x, p["attn/wv"]).reshape(n, l, s.n_kv_heads, hd)
    g = s.n_heads // s.n_kv_heads
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = prec.mm(qt, kt.transpose(-1, -2)) * hy.attention_multiplier
    keep = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    out = prec.mm(torch.softmax(scores, dim=-1), vt)
    return prec.mm(out.transpose(1, 2).reshape(n, l, s.n_heads * hd),
                   p["attn/wo"])


def swiglu(prec: Precision, x, w_gate, w_up, w_down):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def moe(prec: Precision, hy: Hybrid, p: dict, x):
    """(output, load-balance term) of x (n, l, d)."""
    n, l, d = x.shape
    t = x.reshape(n * l, d)
    probs = torch.softmax(prec.mm(t, p["moe/router"]).float(), dim=-1)
    top, ids = torch.topk(probs, hy.top_k, dim=-1)
    gates = top / top.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(t)
    first, count = hy.held
    for e in range(count):
        rows, pick = torch.nonzero(ids == first + e, as_tuple=True)
        y = swiglu(prec, t[rows], p["moe/w_gate"][e], p["moe/w_up"][e],
                   p["moe/w_down"][e])
        out = out.index_add(0, rows, y * gates[rows, pick][:, None])
    out = out + swiglu(prec, t, p["moe/shared/w_gate"], p["moe/shared/w_up"],
                       p["moe/shared/w_down"])
    share = torch.zeros(hy.n_experts, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device))
    aux = hy.n_experts * (probs.mean(dim=0) * share / ids.numel()).sum()
    return out.reshape(n, l, d), aux


def layer(prec: Precision, hy: Hybrid, i: int, p: dict, x):
    """Layer ``i`` (p: its leaves by path): (output, load-balance term)."""
    eps, r = hy.sizes.norm_eps, hy.residual_multiplier
    h = rms_norm(x, p["ln1"], eps)
    mix = mamba2 if hy.layer_types[i] == "mamba" else attention
    x = x + r * mix(prec, hy, p, h)
    m, aux = moe(prec, hy, p, rms_norm(x, p["ln2"], eps))
    return x + r * m, aux


def embed(hy: Hybrid, g: dict, tokens):
    return g["embed/tok"][tokens] * hy.embedding_multiplier


def loss(prec: Precision, hy: Hybrid, g: dict, x, labels):
    """Mean cross-entropy over every position of x (n, l, d), the logits
    the tied embedding's over the logits scaling."""
    x = rms_norm(x, g["final_norm"], hy.sizes.norm_eps)
    logits = prec.mm(x, g["embed/tok"].t()) / hy.logits_scaling
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
