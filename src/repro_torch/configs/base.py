"""Architecture configuration dataclasses (PyTorch port).

A copy of the architecture half of ``repro/configs/base.py`` without its
JAX dependency: every architecture is an :class:`ArchConfig`. The
reference's input-shape cells (``ShapeConfig``, ``SHAPES``) and
``input_specs`` (which builds ``jax.ShapeDtypeStruct`` stand-ins for the
dry-run) are not ported: the port has no dry-run yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (per-layer FFN experts)."""

    n_experts: int
    top_k: int
    expert_d_ff: int
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-family state-space block configuration."""

    kind: str  # "mamba1" | "mamba2"
    d_state: int
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # mamba1 only; 0 -> ceil(d_model / 16)
    head_dim: int = 64  # mamba2 only
    n_groups: int = 1  # mamba2 only
    chunk_size: int = 256  # mamba2 chunked-scan block size

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else math.ceil(d_model / 16)

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba-style hybrid: SSM backbone with a *shared* attention block."""

    attn_every: int  # apply the shared attention block after every N layers
    shared_d_ff: int  # MLP width inside the shared block


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "encoder", "mlp")
ROPE_KINDS = ("1d", "2d", "mrope", "none", "learned")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope: str = "1d"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: Optional[str] = None  # "audio" | "vision" (stub modality input)
    n_frontend_tokens: int = 0  # positions replaced by precomputed embeddings
    sliding_window: int = 0  # 0 = full attention; >0 = window (long-context)
    source: str = ""  # provenance note

    # -- derived ------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.rope not in ROPE_KINDS:
            raise ValueError(f"unknown rope kind {self.rope!r}")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- parameter counting (used by memory model + MODEL_FLOPS) -------------
    def layer_param_count(self) -> int:
        d, f = self.d_model, self.d_ff
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            if s.kind == "mamba1":
                r = s.resolved_dt_rank(d)
                return (
                    d * 2 * di  # in_proj
                    + di * s.d_conv + di  # conv
                    + di * (r + 2 * s.d_state)  # x_proj
                    + r * di + di  # dt_proj (+bias)
                    + di * s.d_state + di  # A_log, D
                    + di * d  # out_proj
                    + d  # norm
                )
            raise ValueError("ssm family expects mamba1")
        if self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_ssm_heads(d)
            g = s.n_groups
            conv_dim = di + 2 * g * s.d_state
            return (
                d * (2 * di + 2 * g * s.d_state + nh)  # in_proj (mamba2)
                + conv_dim * s.d_conv + conv_dim  # conv
                + 3 * nh  # A_log, D, dt_bias
                + di  # gated norm
                + di * d  # out_proj
                + d  # pre-norm
            )
        # attention sub-block
        attn = self.d_model * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * self.d_model
        if self.moe is not None:
            e, ff = self.moe.n_experts, self.moe.expert_d_ff
            ffn = self.d_model * self.moe.n_experts  # router
            ffn += e * (2 * self.d_model * ff + ff * self.d_model)
        elif self.act == "swiglu":
            ffn = 3 * self.d_model * f
        else:
            ffn = 2 * self.d_model * f
        norms = 2 * self.d_model
        return attn + ffn + norms

    def shared_block_param_count(self) -> int:
        if self.hybrid is None:
            return 0
        attn = self.d_model * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * self.d_model
        ffn = 3 * self.d_model * self.hybrid.shared_d_ff
        return attn + ffn + 2 * self.d_model

    def param_count(self) -> int:
        n = self.n_layers * self.layer_param_count()
        n += self.shared_block_param_count()
        n += self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # head
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts) — for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        e, k, ff = self.moe.n_experts, self.moe.top_k, self.moe.expert_d_ff
        dense_experts_per_layer = e * 3 * self.d_model * ff
        active_experts_per_layer = k * 3 * self.d_model * ff
        return self.param_count() - self.n_layers * (
            dense_experts_per_layer - active_experts_per_layer
        )

    # -- reduced config for CPU smoke tests ----------------------------------
    def reduced(self) -> "ArchConfig":
        """Same-family tiny config: a few layers, narrow width, tiny vocab."""
        kw: dict = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            head_dim=16 if self.n_heads else 0,
            rope=self.rope,
            rope_theta=self.rope_theta,
            act=self.act,
            tie_embeddings=self.tie_embeddings,
            frontend=self.frontend,
            n_frontend_tokens=min(self.n_frontend_tokens, 4),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            source="smoke",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=min(self.moe.top_k, 2),
                                  expert_d_ff=32)
            kw["d_ff"] = 32
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(kind=self.ssm.kind, d_state=8, d_conv=4,
                                  expand=2, dt_rank=4, head_dim=16, n_groups=1,
                                  chunk_size=8)
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(attn_every=2, shared_d_ff=64)
            kw["n_layers"] = 5
        return ArchConfig(**kw)
