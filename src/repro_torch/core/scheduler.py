"""Hydra's shard-parallel task scheduler (the paper's "scheduler" box) —
port of the training half of ``repro/core/scheduler.py``.

* **capacity planning** — how many concurrent trials K fit given the device
  memory (params + optimizer + pipeline activation stash + caches);
* **gang planning** — grouping a trial population into same-architecture
  gangs of size <= K_max and choosing microbatch counts so the pipeline
  bubble fraction meets a target.

The memory model is the reference's, per pipeline stage. The device is the
card: one H100 with 80 GB, and all S stages of a gang share it (the port
runs the stage mesh inside one process), so the budget each stage's
estimate is held to is ``HBM_BYTES_PER_CHIP × HBM_BUDGET_FRACTION / S``.
The training state is the port's own (:func:`state_bytes`): parameters and
their gradient buffer in the parameter dtype, AdamW's m and v in fp32 —
16 bytes per parameter in fp32, where the reference counts bf16
parameters with fp32 m, v and master copy (2 + 12).
(Serving capacity planning and failure re-planning are not ported yet.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partitioner import plan_stages
from repro_torch.core.pipeline import EngineConfig

HBM_BYTES_PER_CHIP = 80 * 1000 ** 3  # one H100 SXM (NVIDIA data sheet)
HBM_BUDGET_FRACTION = 0.9  # headroom for the allocator and workspaces


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """One model-selection trial (the task-parallel unit of the paper)."""

    arch: str
    lr: float
    weight_decay: float = 0.0
    seed: int = 0
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    params_bytes: int
    opt_bytes: int
    act_bytes: int
    cache_bytes: int

    @property
    def total(self) -> int:
        return self.params_bytes + self.opt_bytes + self.act_bytes \
            + self.cache_bytes


def stage_budget(eng: EngineConfig) -> float:
    """Bytes one stage's estimate may use: the card's budget split over the
    S stages that share it."""
    return HBM_BYTES_PER_CHIP * HBM_BUDGET_FRACTION / eng.n_stages


def state_bytes(param_dtype: torch.dtype) -> dict:
    """Bytes per parameter of one trial's training state in the port, as
    :func:`per_chip_bytes` keywords: the parameter in ``param_dtype``, then
    its gradient buffer (same dtype) and AdamW's fp32 m and v."""
    size = param_dtype.itemsize
    return {"param_bytes": size, "opt_bytes_per_param": size + 8}


def per_chip_bytes(cfg: ArchConfig, eng: EngineConfig, seq_len: int,
                   train: bool, param_bytes: int = 4,
                   opt_bytes_per_param: int = 12) -> MemoryEstimate:
    """Per-stage memory model for ONE trial under the engine config (the
    reference's per-chip model; stage sharding divides layer params by
    n_stages, the vocab-parallel embedding and head by S as well). The
    activation stash covers the in-flight pipeline slots (n_ticks live
    stage inputs with remat). The defaults are :func:`state_bytes` of
    fp32: ``opt_bytes_per_param`` counts the gradient buffer and m, v."""
    plan = plan_stages(cfg, eng.n_stages)
    layer_p = cfg.layer_param_count() * plan.layers_per_stage
    vocab_p = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    vocab_p = math.ceil(vocab_p / (eng.n_stages if eng.vocab_parallel else 1))
    shared_p = cfg.shared_block_param_count()
    n_params_local = layer_p + vocab_p + shared_p + cfg.d_model
    params_b = n_params_local * param_bytes
    opt_b = n_params_local * opt_bytes_per_param if train else 0
    if train:
        # pipeline stash: one stage input per in-flight tick (remat), at
        # bf16 + fp32 = 6 bytes per element (the reference's budget)
        act_b = eng.n_ticks * eng.microbatch * seq_len * cfg.d_model * 6
        # transient working set: one layer's weights and grads, attention
        # carries
        act_b += 3 * cfg.layer_param_count() * 4
        act_b += 8 * eng.microbatch * min(seq_len, 4096) * cfg.d_model * 4
        cache_b = 0
    else:
        act_b = 4 * eng.microbatch * min(seq_len, 4096) * cfg.d_model * 4
        cache_b = _cache_bytes_per_chip(cfg, eng, seq_len)
    return MemoryEstimate(params_b, opt_b, act_b, cache_b)


def kv_token_bytes_per_chip(cfg: ArchConfig, eng: EngineConfig) -> int:
    """K+V bytes ONE cached token costs across a stage's layer slice."""
    plan = plan_stages(cfg, eng.n_stages)
    itemsize = eng.cache_dtype.itemsize
    return (cfg.n_kv_heads * cfg.head_dim * 2 * itemsize
            * plan.layers_per_stage)


def _cache_bytes_per_chip(cfg: ArchConfig, eng: EngineConfig,
                          seq_len: int) -> int:
    if cfg.family == "hybrid":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if eng.paged:
        # the persistent cache is the block pool, not slots × max_seq strips
        local_blocks = eng.n_blocks // max(eng.data_size, 1)
        return (local_blocks * eng.block_size
                * kv_token_bytes_per_chip(cfg, eng))
    b_local = eng.microbatch * eng.n_microbatches
    if cfg.family == "ssm":
        # O(1) per row: the fp32 state and the conv window, whatever seq_len
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        per_layer = b_local * di * s.d_state * 4
        per_layer += b_local * (s.d_conv - 1) * di * eng.cache_dtype.itemsize
        return per_layer * plan_stages(cfg, eng.n_stages).layers_per_stage
    return b_local * seq_len * kv_token_bytes_per_chip(cfg, eng)


def max_concurrent_trials(cfg: ArchConfig, eng: EngineConfig, seq_len: int,
                          train: bool = True,
                          param_dtype: torch.dtype = torch.float32) -> int:
    """K_max: how many trials fit on the card (the paper's memory
    ceiling)."""
    one = per_chip_bytes(cfg, dataclasses.replace(eng, n_trials=1), seq_len,
                         train, **state_bytes(param_dtype)).total
    return max(1, int(stage_budget(eng) // max(one, 1)))


# ---------------------------------------------------------------------------
# Gang planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GangPlan:
    """A set of same-architecture trials trained in one pipelined program."""

    arch: str
    trials: tuple  # TrialSpec...
    engine: EngineConfig

    @property
    def bubble_fraction(self) -> float:
        return self.engine.bubble_fraction


def plan_gangs(trials: Sequence[TrialSpec], base_eng: EngineConfig,
               arch_configs: dict, seq_len: int,
               target_bubble: float = 0.10, train: bool = True,
               param_dtype: torch.dtype = torch.float32) -> list[GangPlan]:
    """Greedy gang former: group by architecture, split into capacity-bounded
    gangs, and size microbatch counts so each gang's bubble fraction meets
    ``target_bubble`` when memory allows.

    The paper's key scheduling claim (utilization → 1) is exactly the bubble
    fraction (S−1)/(K·M+S−1) → 0; this planner drives it below the target by
    raising K (more trials per gang) first — the Hydra move — and M second.
    """
    by_arch: dict[str, list[TrialSpec]] = {}
    for t in trials:
        by_arch.setdefault(t.arch, []).append(t)

    gangs = []
    budget = stage_budget(base_eng)
    for arch, ts in by_arch.items():
        cfg = arch_configs[arch]
        k_max = max_concurrent_trials(cfg, base_eng, seq_len, train,
                                      param_dtype)
        i = 0
        while i < len(ts):
            k = min(k_max, len(ts) - i)
            # choose M so bubble <= target: (S-1)/(K*M+S-1) <= target
            s = base_eng.n_stages
            m_needed = max(1, math.ceil(
                (s - 1) * (1 - target_bubble) / (target_bubble * k)))
            eng = dataclasses.replace(base_eng, n_trials=k,
                                      n_microbatches=m_needed)
            # shrink M if memory no longer fits
            while (per_chip_bytes(cfg, eng, seq_len, train,
                                  **state_bytes(param_dtype)).total * k
                   > budget and eng.n_microbatches > 1):
                eng = dataclasses.replace(
                    eng, n_microbatches=eng.n_microbatches - 1)
            gangs.append(GangPlan(arch=arch, trials=tuple(ts[i:i + k]),
                                  engine=eng))
            i += k
    return gangs
