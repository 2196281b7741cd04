"""Hydra's shard-parallel task scheduler (the paper's "scheduler" box) —
port of ``repro/core/scheduler.py``.

* **capacity planning** — how many concurrent trials K fit given the device
  memory (params + optimizer + pipeline activation stash + caches), and
  the serving slot grid (:func:`plan_serve_capacity`);
* **gang planning** — grouping a trial population into same-architecture
  gangs of size <= K_max and choosing microbatch counts so the pipeline
  bubble fraction meets a target;
* **failure re-planning** — re-forming the gangs on a data axis shrunk by
  cordoned rows (:func:`replan_after_failure`, used by
  ``runtime/elastic.py``).

The memory model is the reference's, per pipeline stage. The device is the
card: one H100 with 80 GB, and all S stages of a gang share it (the port
runs the stage mesh inside one process), so the budget each stage's
estimate is held to is ``HBM_BYTES_PER_CHIP × HBM_BUDGET_FRACTION / S``.
The training state is the port's own (:func:`state_bytes`): parameters and
their gradient buffer in the parameter dtype, AdamW's m and v in fp32 —
16 bytes per parameter in fp32, where the reference counts bf16
parameters with fp32 m, v and master copy (2 + 12). Serving plans count
the weights in the dtype they are served in (bf16 on the card). The
engine's layout fields (``fsdp``, ``pod_size``, ``batch_replicated``) enter
the model as in the reference, for the dry-run's production layouts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.analysis.roofline import HBM_BYTES
from repro_torch.configs.base import ArchConfig
from repro_torch.core.partitioner import plan_stages
from repro_torch.core.pipeline import EngineConfig

HBM_BYTES_PER_CHIP = HBM_BYTES  # one H100 SXM (analysis/roofline.py)
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
    stage inputs with remat); FSDP (``eng.fsdp``, a production layout's)
    further divides layer params by data_size. The defaults are
    :func:`state_bytes` of fp32: ``opt_bytes_per_param`` counts the
    gradient buffer and m, v."""
    plan = plan_stages(cfg, eng.n_stages)
    layer_p = max(cfg.stack_param_count(plan.layer_offset(s),
                                        plan.layers_per_stage)
                  for s in range(eng.n_stages))
    if eng.fsdp:
        layer_p = math.ceil(layer_p / eng.data_size)
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
    if eng.paged:
        # the persistent cache is the block pool, not slots × max_seq strips
        dp = 1 if eng.batch_replicated else eng.data_size * eng.pod_size
        local_blocks = eng.n_blocks // max(dp, 1)
        return (local_blocks * eng.block_size
                * kv_token_bytes_per_chip(cfg, eng))
    b_local = eng.microbatch * eng.n_microbatches
    if cfg.family in ("ssm", "hybrid"):
        # O(1) per row: the fp32 state and the conv window, whatever
        # seq_len; hybrid archs add the shared-site K/V strips. The
        # reference's formula, kept so plans agree field by field: it
        # counts ONE shared site per stage (a stage of full zamba2-7b at
        # S = 2 holds 7) and ``di``, not the Mamba2 conv's di + 2·g·n, as
        # the conv width (ROADMAP Queue 3)
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        itemsize = eng.cache_dtype.itemsize
        per_layer = b_local * di * s.d_state * 4
        per_layer += b_local * (s.d_conv - 1) * di * itemsize
        total = per_layer * plan_stages(cfg, eng.n_stages).layers_per_stage
        if cfg.hybrid is not None:
            w = min(seq_len, eng.window) if eng.window else seq_len
            total += (b_local * w * cfg.n_kv_heads * cfg.head_dim * 2
                      * itemsize)
        return total
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
# Serving capacity planning (continuous-batching engine)
# ---------------------------------------------------------------------------


def plan_serve_capacity(cfg: ArchConfig, base_eng: EngineConfig,
                        max_seq: int, target_bubble: float = 0.25,
                        max_slots: int = 64, paged: bool = False,
                        expected_seq: Optional[int] = None,
                        block_size: int = 16,
                        hbm_bytes: Optional[int] = None,
                        budget_fraction: float = HBM_BUDGET_FRACTION,
                        mix: Optional[Sequence[tuple]] = None,
                        hit_rate: float = 0.0,
                        overcommit: float = 1.0,
                        host_blocks: int = 0,
                        param_dtype: torch.dtype = torch.bfloat16,
                        ) -> EngineConfig:
    """Choose the serving slot grid for one model — or a co-serving gang
    (the reference's planner, line for line).

    The card holds all S stages, so each stage's estimate
    (``per_chip_bytes(train=False)``, weights in ``param_dtype``) is held
    to ``hbm_bytes / S × budget_fraction``; ``hbm_bytes`` defaults to the
    card's ``HBM_BYTES_PER_CHIP``. ``mix`` sizes the grid for a traffic
    mix across a K-variant gang: one ``(arrival_weight, expected_seq)``
    pair per co-served arch; the returned config carries ``n_trials =
    len(mix)`` and every per-trial cost is multiplied by K (``mix=None``:
    K = 1, ``expected_seq`` the lone expectation).

    Dense: start from the pipeline-bubble target ((S-1)/(K·M+S-1) <=
    target), then shrink M until the strips (every cell reserves
    ``max_seq``) fit. Paged (``paged=True``): the leftover budget becomes
    one block pool per trial, and M is sized so the pools back K × M ×
    microbatch rows at their arrival-weighted *expected* lengths — lowered
    by ``hit_rate`` (the expected share of tokens served from shared
    prefix-cache blocks) and widened by ``overcommit`` (the factor the
    batcher admits past the pool, retraction absorbing the tail);
    ``host_blocks`` is carried into the config and never widens the grid.
    The returned config carries ``n_blocks`` (per trial) and
    ``block_size``.
    """
    if not 0.0 <= hit_rate < 1.0:
        raise ValueError(f"hit_rate must be in [0, 1), got {hit_rate}")
    if overcommit < 1.0:
        raise ValueError(f"planning overcommit must be >= 1.0 (the batcher "
                         f"accepts < 1.0 as a runtime safety margin, but a "
                         f"grid planned below capacity is dead weight), "
                         f"got {overcommit}")
    if host_blocks < 0:
        raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
    if (overcommit > 1.0 or host_blocks > 0) and not paged:
        raise ValueError("overcommit > 1.0 and host_blocks require "
                         "paged=True (dense strips cannot be retracted or "
                         "spilled)")
    s = base_eng.n_stages
    budget = ((HBM_BYTES_PER_CHIP if hbm_bytes is None else hbm_bytes)
              / s * budget_fraction)
    pbytes = dict(param_bytes=param_dtype.itemsize)
    if mix is not None:
        if not mix or any(w < 0 for w, _ in mix) \
                or sum(w for w, _ in mix) <= 0:
            raise ValueError(f"mix must be non-empty (weight, expected_seq) "
                             f"pairs with positive total weight, got {mix}")
        k_trials = len(mix)
        w_total = sum(w for w, _ in mix)
        # per-row expected demand of trial k, scaled by its arrival share
        demands = [min(max(int(e), 1), max_seq) * (w * k_trials / w_total)
                   for w, e in mix]
    else:
        k_trials = 1
        demands = [min(max(expected_seq or max_seq // 2, 1), max_seq)]
    if s > 1:
        m_bubble = math.ceil((s - 1) * (1.0 - target_bubble)
                             / max(target_bubble * k_trials, 1e-9))
    else:
        m_bubble = 1
    if paged:
        eng = dataclasses.replace(base_eng, n_trials=k_trials,
                                  max_seq=max_seq, paged=True,
                                  block_size=block_size, n_blocks=0,
                                  n_microbatches=1)
        est = per_chip_bytes(cfg, dataclasses.replace(eng, n_trials=1),
                             max_seq, train=False, **pbytes)
        # the per-tick working set does not scale with K: a tick advances
        # one slot per stage
        fixed = (est.params_bytes + est.opt_bytes) * k_trials + est.act_bytes
        token_b = kv_token_bytes_per_chip(cfg, eng)
        dp = 1 if eng.batch_replicated else eng.data_size * eng.pod_size
        per_row = -(-max_seq // block_size)  # serve.paging.blocks_for
        # floor: every (trial, shard) partition backs one max_seq request
        local_blocks = max(
            int(budget - fixed) // (token_b * block_size * k_trials),
            per_row)
        mean_demand = max(sum(demands) / k_trials * (1.0 - hit_rate), 1.0)
        m_cap = int(local_blocks * block_size * overcommit
                    // (mean_demand * eng.microbatch))
        m = min(max_slots, max(1, m_cap))
        # blocks beyond the capped grid's worst case are dead weight
        local_blocks = min(local_blocks, max(eng.microbatch * m, 1) * per_row)
        return dataclasses.replace(eng, n_microbatches=m,
                                   n_blocks=local_blocks * dp,
                                   host_blocks=host_blocks)
    m = min(max(m_bubble, base_eng.n_microbatches, 1), max_slots)
    eng = dataclasses.replace(base_eng, n_trials=k_trials, n_microbatches=m,
                              max_seq=max_seq)

    def total(e):
        one = per_chip_bytes(cfg, dataclasses.replace(e, n_trials=1),
                             max_seq, train=False, **pbytes)
        return ((one.params_bytes + one.opt_bytes + one.cache_bytes)
                * k_trials + one.act_bytes)

    while total(eng) > budget and eng.n_microbatches > 1:
        eng = dataclasses.replace(eng, n_microbatches=eng.n_microbatches - 1)
    return eng


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


# ---------------------------------------------------------------------------
# Failure policy (used by runtime/elastic.py)
# ---------------------------------------------------------------------------


def replan_after_failure(gangs: list[GangPlan], base_eng: EngineConfig,
                         arch_configs: dict, seq_len: int,
                         lost_data_rows: int) -> list[GangPlan]:
    """Shrink the data axis by the cordoned rows and re-form gangs.

    A failed device cordons its entire data row (the stage axis is a hard
    dependency ring; the data axis is the elastic one). Trials keep their
    identity and resume from the last checkpoint, but the global batch
    shrinks with the data axis: the engines keep ``microbatch`` and the
    planner's ``n_microbatches``, so a trial's rows per step,
    ``n_microbatches · microbatch · data_size``, fall with ``data_size``
    (and the data pipeline sizes its batches from ``data_size``). The
    gradients are those of a smaller batch, not a re-sharded one.
    """
    new_data = base_eng.data_size - lost_data_rows
    if new_data < 1:
        raise RuntimeError("mesh lost all data rows; cannot re-plan")
    shrunk = dataclasses.replace(base_eng, data_size=new_data)
    trials = [t for g in gangs for t in g.trials]
    return plan_gangs(trials, shrunk, arch_configs, seq_len)
