"""Modality frontend STUBS (port of ``repro/models/frontend.py``): the audio
(musicgen) and vision (qwen2-vl) archs run their transformer backbone only,
fed precomputed frame / patch embeddings.

These helpers make synthetic frontend embeddings of the right shape for
smoke runs and examples — a real deployment would put an EnCodec encoder
(musicgen) or a ViT tower (qwen2-vl) here. They draw from an explicit
``torch.Generator``, whose numbers differ from the reference's
``jax.random``: tests that compare the packages build their embeddings
with numpy and hand them to both.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig


def synth_frontend_embeds(cfg: ArchConfig, gen: torch.Generator, batch: int,
                          dtype=torch.float32, device=None):
    """(batch, n_frontend_tokens, d_model) standard-normal embeddings, or
    None for an arch without a frontend. ``gen``'s device must be
    ``device``."""
    if cfg.frontend is None:
        return None
    return torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                       generator=gen, device=device).to(dtype)


def synth_mrope_positions(cfg: ArchConfig, batch: int, seq: int,
                          device=None):
    """Text-style M-RoPE ids (3, batch, seq): all three sections share the
    linear position.

    A real VLM driver gives image patches (t, h, w) grid positions; for the
    backbone-only reproduction the linear fallback is what Qwen2-VL uses
    for pure-text segments.
    """
    base = torch.arange(seq, device=device).expand(batch, seq)
    return base.expand(3, batch, seq)


def grid_mrope_positions(cfg: ArchConfig, batch: int, seq: int,
                         device=None):
    """Image-then-text M-RoPE ids (3, batch, seq), as Qwen2-VL lays out one
    image: the ``n_frontend_tokens`` patches (a square grid, side
    ``isqrt(nf)``) at temporal 0 and their own (height, width) cell, then
    the text from position ``side`` on, all three streams equal. Unlike
    the text-style fallback, the three streams differ over the image, so
    the M-RoPE section split decides the rotary."""
    nf = cfg.n_frontend_tokens
    side = math.isqrt(nf)
    if side * side != nf or seq < nf:
        raise ValueError(f"grid positions need a square patch count <= seq, "
                         f"got {nf} patches, seq {seq}")
    i = torch.arange(nf, device=device)
    text = side + torch.arange(seq - nf, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(i), text]),
                       torch.cat([i // side, text]),
                       torch.cat([i % side, text])])
    return pos[:, None, :].expand(3, batch, seq)
