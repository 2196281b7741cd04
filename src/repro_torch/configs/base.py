"""Architecture configuration dataclasses and input-shape cells (PyTorch
port of ``repro/configs/base.py``, without its JAX dependency).

Every architecture is an :class:`ArchConfig`. The four input-shape cells
(:class:`ShapeConfig`, ``SHAPES``) and :func:`input_specs` are the
dry-run's (``launch/dryrun.py``): ``input_specs`` gives the reference's
keys, shapes and dtypes as tensors on the ``meta`` device, where the
reference gives ``jax.ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


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

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "encoder", "mlp",
            "hybrid_moe")
LAYER_KINDS = ("mamba", "attention")  # a hybrid_moe layer's mixer
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

    # The hybrid_moe family's settings are fields of :class:`HybridMoEConfig`;
    # every other config reads these class defaults, under which they
    # change nothing (and add no operation).
    layer_types = ()  # each layer's mixer, one of LAYER_KINDS
    attention_multiplier = 0.0  # the attention scale; 0: 1 / sqrt(head_dim)
    embedding_multiplier = 1.0  # on the token embedding
    residual_multiplier = 1.0  # on each sub-layer's residual branch
    logits_scaling = 1.0  # the logits are divided by it
    shared_d_ff = 0  # a shared SwiGLU expert beside the routed ones; 0: none
    n_held_experts = 0  # the routed experts this card holds; 0: all
    first_held_expert = 0  # ... from this id on

    # -- derived ------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.rope not in ROPE_KINDS:
            raise ValueError(f"unknown rope kind {self.rope!r}")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_causal_lm(self) -> bool:
        return self.family not in ("encoder", "mlp")

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic sequence mixers (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def held_experts(self) -> tuple:
        """(first id, count) of the routed experts whose weights a layer
        holds: one card's share under expert parallelism, or all."""
        return (self.first_held_expert,
                self.n_held_experts or self.moe.n_experts)

    def layer_kind(self, layer: int) -> Optional[str]:
        """A mixed stack's mixer of ``layer`` (None past the real layers:
        stage padding, which holds no weights)."""
        return self.layer_types[layer] if layer < self.n_layers else None

    # -- parameter counting (used by memory model + MODEL_FLOPS) -------------
    def _attn_param_count(self) -> int:
        return self.d_model * self.head_dim * (self.n_heads
                                               + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * self.d_model

    def _mamba2_param_count(self) -> int:
        """A Mamba2 mixer without its pre-norm."""
        d, s = self.d_model, self.ssm
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
        )

    def layer_param_count(self, layer: Optional[int] = None) -> int:
        """Parameters of one layer; in a mixed stack (``layer_types``) of
        layer ``layer``, or with None of its largest kind."""
        d, f = self.d_model, self.d_ff
        if self.layer_types:
            if layer is None:
                return max(self.layer_param_count(self.layer_types.index(k))
                           for k in set(self.layer_types))
            mixer = (self._mamba2_param_count()
                     if self.layer_kind(layer) == "mamba"
                     else self._attn_param_count())
            e, ff = self.moe.n_experts, self.moe.expert_d_ff
            moe = d * e + self.held_experts[1] * 3 * d * ff \
                + 3 * d * self.shared_d_ff
            return mixer + moe + 2 * d  # two pre-norms
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
            return self._mamba2_param_count() + d  # + pre-norm
        # attention sub-block
        attn = self._attn_param_count()
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

    def stack_param_count(self, first: int, n: int) -> int:
        """Parameters of the layer stack's slice [first, first + n): a
        mixed stack's real layers (its stage padding holds none), or n of
        a uniform stack's layers (padding included: a stacked leaf holds
        every padded layer)."""
        if self.layer_types:
            return sum(self.layer_param_count(i)
                       for i in range(first, min(first + n, self.n_layers)))
        return n * self.layer_param_count()

    def shared_block_param_count(self) -> int:
        if self.hybrid is None:
            return 0
        attn = self._attn_param_count()
        ffn = 3 * self.d_model * self.hybrid.shared_d_ff
        return attn + ffn + 2 * self.d_model

    def param_count(self) -> int:
        n = self.stack_param_count(0, self.n_layers)
        n += self.shared_block_param_count()
        n += self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # head
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts) — for
        6·N_active·D. Where a layer holds a share of the routed experts, a token's top_k
        picks land on it top_k · held / n_experts times on average."""
        if self.moe is None:
            return self.param_count()
        e, k, ff = self.moe.n_experts, self.moe.top_k, self.moe.expert_d_ff
        if self.layer_types:
            held = self.held_experts[1]
            idle = held - k * held / e  # held experts a token leaves idle
            return self.param_count() - round(
                self.n_layers * idle * 3 * self.d_model * ff)
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


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ArchConfig):
    """The ``hybrid_moe`` family (HF ``granitemoehybrid``): each layer a
    Mamba2 (``ssm``) or NoPE GQA attention mixer, by ``layer_types``, then
    a routed MoE (``moe``) with a shared SwiGLU expert of width
    ``shared_d_ff``, both residual branches scaled by
    ``residual_multiplier``; the token embedding times
    ``embedding_multiplier``, the logits over ``logits_scaling``, the
    attention scale ``attention_multiplier``. ``n_held_experts`` from
    ``first_held_expert`` are the routed experts a layer holds (one card's
    share under expert parallelism; 0: all): the router keeps all
    ``moe.n_experts`` outputs and its ``top_k``."""

    layer_types: tuple = ()
    attention_multiplier: float = 0.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    shared_d_ff: int = 0
    n_held_experts: int = 0
    first_held_expert: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.family != "hybrid_moe":
            raise ValueError("a HybridMoEConfig is of the hybrid_moe family")
        if len(self.layer_types) != self.n_layers or not set(
                self.layer_types) <= set(LAYER_KINDS):
            raise ValueError(f"layer_types must give each of the "
                             f"{self.n_layers} layers one of {LAYER_KINDS}")
        first, n = self.held_experts
        if not 0 <= first and first + n <= self.moe.n_experts:
            raise ValueError(f"experts {first}..{first + n - 1} are not "
                             f"among the {self.moe.n_experts}")

    def reduced(self) -> "HybridMoEConfig":
        """Every mechanism at a CPU test's size: five layers, attention
        third, eight routed experts of which three are held (from id 2),
        top-3, the shared expert, the multipliers as they are."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=5, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128,
            layer_types=("mamba", "mamba", "attention", "mamba", "mamba"),
            moe=dataclasses.replace(self.moe, n_experts=8, top_k=3,
                                    expert_d_ff=32),
            ssm=dataclasses.replace(self.ssm, d_state=8, head_dim=16,
                                    chunk_size=8),
            shared_d_ff=48, n_held_experts=3, first_held_expert=2,
            source="smoke")


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; (False, reason) marks a recorded skip."""
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, "pure full-attention arch: 500k dense-causal decode is " \
                      "quadratic-cost; sub-quadratic mixing required (DESIGN.md §4)"
    if not arch.is_causal_lm and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    return True, ""


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins; no allocation)
# ---------------------------------------------------------------------------


def input_specs(arch: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    """Meta tensors for every model input of this (arch, shape) cell (the
    reference's ShapeDtypeStructs: the same keys, shapes and dtypes).

    train:   tokens + labels over the full sequence
    prefill: tokens (cache is an *output* of prefill)
    decode:  one new token per sequence + the live cache/state is threaded by
             the engine (``core/pipeline.py::serve_cache_struct``)
    Modality frontends (audio/vlm) additionally receive precomputed embeddings
    for ``n_frontend_tokens`` positions, and M-RoPE position ids for vlm.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    meta = lambda shape_, dt: torch.empty(shape_, dtype=dt, device="meta")
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = meta((b, s), i32)
        specs["labels"] = meta((b, s), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = meta((b, s), i32)
    else:  # decode: one token per sequence, against a cache of length s
        specs["tokens"] = meta((b, 1), i32)
        specs["position"] = meta((b,), i32)
    if arch.frontend is not None and shape.kind != "decode":
        nf = arch.n_frontend_tokens
        specs["frontend_embeds"] = meta((b, nf, arch.d_model), dtype)
    if arch.rope == "mrope" and shape.kind != "decode":
        specs["mrope_pos"] = meta((3, b, s), i32)
    return specs
