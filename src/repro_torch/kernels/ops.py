"""Dispatch for the port's kernels.

Each op sends a CPU tensor to the plain PyTorch version and a CUDA tensor
to the hand-written CUDA kernel — by the tensor's device alone: no
environment switch and no fallback (a kernel that fails to build or
launch raises). A ``meta`` tensor (the dry-run's) is refused: it has no
data for the kernel, and the plain version stands in for the kernel only
on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import attention_bwd as bwd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import paged_attention as pa


def _route(t, plain, kernel, *others):
    """``plain`` for a CPU tensor, ``kernel`` for a CUDA one; raises for a
    meta tensor, and when ``others`` (the op's other tensor inputs) lie on
    another device than ``t``."""
    split = [o.device for o in others if o.device != t.device]
    if split:
        raise ValueError(f"{kernel.__name__}: inputs split across devices "
                         f"({t.device} and {split[0]})")
    if t.device.type == "meta":
        raise ValueError(
            f"{kernel.__name__} got a meta tensor: a CUDA kernel needs "
            f"data on the card (and its plain version runs for CPU tensors "
            f"only). The dry-run counts the plain path: leave "
            f"use_flash_kernel, use_mamba_kernel and use_paged_kernel off "
            f"on meta")
    return plain if t.device.type == "cpu" else kernel


# ---------------------------------------------------------------------------
# flash attention: kernel forward + backward. The reference's
# ``_flash_core`` custom_vjp has no backward kernel (the Pallas kernel has
# no AD rule, and its backward is jax.vjp through the chunked jnp path):
# that chunked backward is the plain version here, and a CUDA tensor runs
# the port's own backward kernels
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    one. Backward: the backward kernels (``kernels/attention_bwd.py``) on a
    CUDA tensor; on a CPU one autograd through ``layers.chunked_attention``
    with ``q_chunk = max(block_q, 128)`` and ``kv_chunk = max(block_k,
    128)``, recomputing the score blocks from (q, k, v) — as
    ``ops._flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_offset, block_q, block_k):
        fn = _route(q, fa.flash_attention_plain, fa.flash_attention_kernel,
                    k, v)
        if (fn is fa.flash_attention_kernel
                and any(ctx.needs_input_grad[:3])):
            bwd.prebuild()  # the backward's nvcc beside the forward's
        out = fn(q, k, v, causal=causal, window=window, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, window, kv_offset, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, ct):
        causal, window, kv_offset, block_q, block_k = ctx.args
        q, k, v, out = ctx.saved_tensors
        plain = functools.partial(bwd.attention_bwd_plain,
                                  q_chunk=max(block_q, 128),
                                  kv_chunk=max(block_k, 128))
        fn = _route(q, plain, bwd.attention_bwd_kernel, k, v, ct)
        dq, dk, dv = fn(q, k, v, out, ct.contiguous(), causal=causal,
                        window=window, kv_offset=kv_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_offset: int = 0, kv_len=None, block_q: int = 512,
                    block_k: int = 512):
    """q (b, sq, hq, hd), k/v (b, sk, hkv, hd) -> (b, sq, hq, hd);
    differentiable. GQA is handled in the kernel's indexing. ``kv_len``
    (ragged decode) is not kernel-supported, as in the reference: callers
    use the direct path for it. ``block_q`` / ``block_k`` set the
    backward's chunking (the kernel's own tiles are fixed)."""
    if kv_len is not None:
        raise NotImplementedError("ragged kv_len uses the direct path")
    return _FlashAttention.apply(q, k, v, causal, window, int(kv_offset),
                                 block_q, block_k)


# ---------------------------------------------------------------------------
# paged attention: forward only (serving decode / append)
# ---------------------------------------------------------------------------


def paged_attention(q, k_pool, v_pool, block_tables, kv_offset, kv_len, *,
                    causal: bool = True, window: int = 0, q_lens=None):
    """q (b, sq, hq, hd); k/v pool (n_blocks, block_size, hkv, hd);
    block_tables (b, n_tbl) (-1 = unallocated); kv_offset / kv_len (b,)
    per-row cache depth / live length; ``q_lens (b,)`` optional per-row
    real query counts. Returns (b, sq, hq, hd). See
    ``kernels/paged_attention.py`` for the masking contract."""
    fn = _route(q, pa.paged_attention_plain, pa.paged_attention_kernel,
                k_pool, v_pool, block_tables)
    return fn(q, k_pool, v_pool, block_tables, kv_offset, kv_len,
              causal=causal, window=window, q_lens=q_lens)


# ---------------------------------------------------------------------------
# mamba selective scan: kernel forward + sequential backward (the
# reference's ``_mamba_core`` custom_vjp, whose backward is jax.vjp of the
# sequential oracle)
# ---------------------------------------------------------------------------


class _MambaScan(torch.autograd.Function):
    """Forward: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    one. Backward: autograd through ``mamba_scan_plain`` (as
    ``ops._mamba_bwd``)."""

    @staticmethod
    def forward(ctx, da, dbx, cmat, h0):
        ctx.save_for_backward(da, dbx, cmat, h0)
        fn = _route(da, ms.mamba_scan_plain, ms.mamba_scan_kernel, dbx,
                    cmat, h0)
        return fn(da, dbx, cmat, h0)

    @staticmethod
    def backward(ctx, ct_y, ct_h):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = ms.mamba_scan_plain(*leaves)
            return torch.autograd.grad(outs, leaves, (ct_y, ct_h))


def mamba_scan(da, dbx, cmat, h0):
    """Selective scan: da / dbx (b, s, di, n), cmat (b, s, n), h0
    (b, di, n) -> (y (b, s, di) in da's dtype, h_final (b, di, n) float32);
    differentiable. See ``kernels/mamba_scan.py``."""
    return _MambaScan.apply(da, dbx, cmat, h0.float())
