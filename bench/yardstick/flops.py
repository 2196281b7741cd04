"""Model FLOPs of one train step, no recompute counted (a frozen copy of
the attention families' branch of ``chip_smoke.py::model_flops_per_step``):
6 per matmul weight per token (forward and backward), plus three times
the forward's attention work, 4 · hd · hq per attended pair (causal:
seq (seq + 1) / 2 pairs a row; the encoder attends all seq²)."""
from __future__ import annotations

from bench.harness.sizes import Sizes


def layer_params(sizes: Sizes) -> int:
    """One layer's parameters, its two norms counted as 2 · d."""
    d, f = sizes.d_model, sizes.d_ff
    attn = d * sizes.head_dim * (sizes.n_heads + 2 * sizes.n_kv_heads) \
        + sizes.n_heads * sizes.head_dim * d
    ffn = 3 * d * f if sizes.act == "swiglu" else 2 * d * f
    return attn + ffn + 2 * d


def model_flops_per_step(sizes: Sizes, trials: int, microbatches: int,
                         rows: int, seq: int) -> int:
    tokens = trials * microbatches * rows * seq
    pairs = seq * seq if sizes.family == "encoder" else seq * (seq + 1) // 2
    attn = 3 * 4 * sizes.head_dim * sizes.n_heads * pairs * sizes.n_layers
    matmul = sizes.n_layers * (layer_params(sizes) - 2 * sizes.d_model) \
        + sizes.d_model * sizes.vocab_size
    return 6 * matmul * tokens + attn * tokens // seq
