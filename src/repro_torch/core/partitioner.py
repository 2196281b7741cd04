"""Layer→stage partitioner: maps a model's layer stack onto pipeline stages.

Port of ``repro/core/partitioner.py``. For the homogeneous stacks of every
supported arch the balanced contiguous partition is optimal; the layer count
is padded to ``stages × layers_per_stage`` with masked no-op layers (padding
costs nothing in steady state: the tick time is the *maximum* stage load
either way). A mixed stack (the hybrid_moe family) keeps the same
contiguous split; its cost model counts each layer by its kind. The cost model below (per-layer FLOPs and bytes, the
linear-partition DP for heterogeneous stacks, the balance report) is the
reference's, number for number; the dry-run and the scheduler's what-if
analyses use it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How one architecture's layers map onto ``n_stages`` pipeline stages."""

    n_layers: int          # real layers
    n_stages: int
    layers_per_stage: int  # local (padded) layer count L_s
    padded_layers: int     # n_stages * layers_per_stage

    def layer_offset(self, stage: int) -> int:
        return stage * self.layers_per_stage

    def real_layers_in_stage(self, stage: int) -> int:
        lo = self.layer_offset(stage)
        return max(0, min(self.n_layers - lo, self.layers_per_stage))

    @property
    def pad_fraction(self) -> float:
        return 1.0 - self.n_layers / self.padded_layers

    @property
    def max_stage_layers(self) -> int:
        return max(self.real_layers_in_stage(s) for s in range(self.n_stages))


def plan_stages(cfg: ArchConfig, n_stages: int) -> StagePlan:
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    lps = -(-cfg.n_layers // n_stages)
    return StagePlan(n_layers=cfg.n_layers, n_stages=n_stages,
                     layers_per_stage=lps, padded_layers=lps * n_stages)


# ---------------------------------------------------------------------------
# Cost model (per-layer FLOPs / bytes) — used for balance analysis and the
# scheduler's memory/throughput planning.
# ---------------------------------------------------------------------------


def layer_flops_per_token(cfg: ArchConfig, seq_len: int,
                          layer: int = 0) -> float:
    """Approximate forward FLOPs per token for one layer (matmul-dominated);
    in a mixed stack (``cfg.layer_types``) for layer ``layer``: its mixer
    and its MoE, whose routed experts count by the picks that land on the
    held ones (top_k · held / n_experts), with the shared expert."""
    d = cfg.d_model
    if cfg.layer_types:
        mixer = (_mamba2_flops_per_token(cfg)
                 if cfg.layer_kind(layer) == "mamba"
                 else _attn_flops_per_token(cfg, seq_len))
        m = cfg.moe
        held = cfg.held_experts[1]
        moe = 2 * d * m.n_experts + m.top_k * held / m.n_experts \
            * 6 * d * m.expert_d_ff + 6 * d * cfg.shared_d_ff
        return mixer + moe
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.d_inner(d)
        r = s.resolved_dt_rank(d)
        proj = 2 * d * 2 * di + 2 * di * (r + 2 * s.d_state) + 2 * r * di \
            + 2 * di * d
        scan = 6 * di * s.d_state  # state update + output contraction
        return proj + scan
    if cfg.family == "hybrid":
        base = _mamba2_flops_per_token(cfg)
        # amortized shared attention block
        attn = _attn_flops_per_token(cfg, seq_len) / cfg.hybrid.attn_every
        mlp = 6 * d * cfg.hybrid.shared_d_ff / cfg.hybrid.attn_every
        return base + attn + mlp
    flops = _attn_flops_per_token(cfg, seq_len)
    if cfg.moe is not None:
        flops += 2 * d * cfg.moe.n_experts  # router
        flops += cfg.moe.top_k * 6 * d * cfg.moe.expert_d_ff
    elif cfg.act == "swiglu":
        flops += 6 * d * cfg.d_ff
    else:
        flops += 4 * d * cfg.d_ff
    return flops


def _mamba2_flops_per_token(cfg: ArchConfig) -> float:
    d, s = cfg.d_model, cfg.ssm
    di = s.d_inner(d)
    nh = s.n_ssm_heads(d)
    proj = 2 * d * (2 * di + 2 * s.n_groups * s.d_state + nh) + 2 * di * d
    chunk = 2 * s.chunk_size * nh * (s.d_state + s.head_dim)  # SSD intra
    scan = 6 * di * s.d_state
    return proj + chunk + scan


def _attn_flops_per_token(cfg: ArchConfig, seq_len: int) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    qkvo = 2 * d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 2 * cfg.n_heads * hd * d
    # causal attention: ~seq/2 effective kv per query
    eff = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    scores = 2 * 2 * cfg.n_heads * hd * eff / 2
    return qkvo + scores


def layer_param_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> int:
    return cfg.layer_param_count() * dtype_bytes


def partition_costs(costs: Sequence[float], n_parts: int) -> list[int]:
    """Contiguous partition of ``costs`` into ``n_parts`` minimizing the max
    part sum (linear-partition DP). Returns the start index of each part.

    Used for heterogeneous stacks; for homogeneous stacks it reduces to the
    balanced split that ``plan_stages`` assumes.
    """
    n = len(costs)
    if n_parts >= n:
        return list(range(n)) + [n] * (n_parts - n)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    # dp[j][i] = minimal max-part-sum splitting first i items into j parts
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(n_parts + 1)]
    cut = [[0] * (n + 1) for _ in range(n_parts + 1)]
    for i in range(n + 1):
        dp[1][i] = prefix[i]
    for j in range(2, n_parts + 1):
        for i in range(j, n + 1):
            for k in range(j - 1, i):
                cost = max(dp[j - 1][k], prefix[i] - prefix[k])
                if cost < dp[j][i]:
                    dp[j][i] = cost
                    cut[j][i] = k
    # recover starts
    starts = [0] * n_parts
    i = n
    for j in range(n_parts, 1, -1):
        i = cut[j][i]
        starts[j - 1] = i
    starts[0] = 0
    return starts


def balance_report(cfg: ArchConfig, plan: StagePlan, seq_len: int) -> dict:
    """Per-stage FLOPs loads + imbalance factor (max/mean); a mixed stack's
    stages sum their own layers' costs."""
    if cfg.layer_types:
        loads = [sum(layer_flops_per_token(cfg, seq_len, i)
                     for i in range(plan.layer_offset(s), plan.layer_offset(s)
                                    + plan.real_layers_in_stage(s)))
                 for s in range(plan.n_stages)]
    else:
        per_layer = layer_flops_per_token(cfg, seq_len)
        loads = [plan.real_layers_in_stage(s) * per_layer
                 for s in range(plan.n_stages)]
    mean = sum(loads) / len(loads)
    return {
        "per_stage_flops_per_token": loads,
        "imbalance": max(loads) / mean if mean else 1.0,
        "pad_fraction": plan.pad_fraction,
    }
