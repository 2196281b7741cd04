"""The two model families in plain PyTorch: a GLM-style decoder (RMS
pre-norms, rotary positions on the first half of each head's dims,
grouped-query attention, SwiGLU) and a BERT-style encoder (layer
pre-norms with biases, learned positions, non-causal attention, GELU),
each with its cross-entropy.

Every matrix product goes through :func:`mm`, so the reference can run
as its own lower-precision control (TF32): on a card by allowing TF32 in
cuBLAS, on the CPU (which has no TF32) by rounding each product's
operands to TF32's 10-bit mantissa, in the forward and the backward
products alike.

Departures from the published models, shared with the program and noted
in the configuration files: no q/k/v biases in the decoder; the
rotation pairs each rotated dim with the one half a rotary span away (the
published ChatGLM pairs neighbours, which is the same model under a fixed
permutation of each head's q and k columns); the encoder normalises
before each sub-layer and at the end, has no linear biases, no segment
embeddings, no embedding norm and an untied output head, and uses GELU's
tanh form.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.harness.sizes import Sizes


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_tf32(a), _tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return (torch.matmul(g, _tf32(b).transpose(-1, -2)),
                torch.matmul(_tf32(a).transpose(-1, -2), g))


class Precision:
    """How the reference multiplies: ``float32`` (TF32 off) or ``tf32``
    (the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(name)
        self.name = name

    def mm(self, a, b):
        if self.name == "tf32" and a.device.type == "cpu":
            return _TF32Matmul.apply(a, b)
        return torch.matmul(a, b)

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def rotary(x, theta: float):
    """x (b, s, h, hd): the first hd/2 dims turned in pairs (i, i + hd/4)
    at position p by p · theta^(-i / (hd/4)); the rest pass."""
    hd = x.shape[-1]
    r = hd // 4
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    freq = theta ** (-torch.arange(r, device=x.device,
                                   dtype=torch.float32) / r)
    ang = pos[:, None] * freq[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2, rest = x[..., :r], x[..., r:2 * r], x[..., 2 * r:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest],
                     dim=-1)


def attention(prec: Precision, q, k, v, causal: bool):
    """q (b, s, h, hd), k / v (b, s, hkv, hd): softmax attention, each
    query head reading K/V head h // (h / hkv)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (b, h, s, hd)
    scores = prec.mm(qt, kt.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    out = prec.mm(torch.softmax(scores, dim=-1), vt)
    return out.transpose(1, 2).reshape(b, s, h * hd)


def layer(prec: Precision, sizes: Sizes, p: dict, x):
    """One layer: p holds its leaves by path (``attn/wq``, ``ln1``, ...)."""
    b, s, _ = x.shape
    hd = sizes.head_dim
    if sizes.family == "encoder":
        norm1 = F.layer_norm(x, x.shape[-1:], p["ln1_w"], p["ln1_b"],
                             sizes.norm_eps)
    else:
        norm1 = rms_norm(x, p["ln1"], sizes.norm_eps)
    q = prec.mm(norm1, p["attn/wq"]).reshape(b, s, sizes.n_heads, hd)
    k = prec.mm(norm1, p["attn/wk"]).reshape(b, s, sizes.n_kv_heads, hd)
    v = prec.mm(norm1, p["attn/wv"]).reshape(b, s, sizes.n_kv_heads, hd)
    if sizes.rope == "2d":
        q, k = rotary(q, sizes.rope_theta), rotary(k, sizes.rope_theta)
    x = x + prec.mm(attention(prec, q, k, v, sizes.causal), p["attn/wo"])
    if sizes.family == "encoder":
        norm2 = F.layer_norm(x, x.shape[-1:], p["ln2_w"], p["ln2_b"],
                             sizes.norm_eps)
    else:
        norm2 = rms_norm(x, p["ln2"], sizes.norm_eps)
    if sizes.act == "swiglu":
        hidden = F.silu(prec.mm(norm2, p["mlp/w_gate"])) \
            * prec.mm(norm2, p["mlp/w_up"])
    else:
        hidden = F.gelu(prec.mm(norm2, p["mlp/w_up"]), approximate="tanh")
    return x + prec.mm(hidden, p["mlp/w_down"])


def embed(sizes: Sizes, g: dict, tokens):
    x = g["embed/tok"][tokens]
    if sizes.rope == "learned":
        x = x + g["embed/pos"][:tokens.shape[-1]]
    return x


def loss(prec: Precision, sizes: Sizes, g: dict, x, labels):
    """Mean cross-entropy over every position of x (b, s, D)."""
    if sizes.family == "encoder":
        x = F.layer_norm(x, x.shape[-1:], g["final_norm/w"],
                         g["final_norm/b"], sizes.norm_eps)
    else:
        x = rms_norm(x, g["final_norm"], sizes.norm_eps)
    logits = prec.mm(x, g["head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
