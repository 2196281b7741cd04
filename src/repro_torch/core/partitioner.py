"""Layer→stage partitioner: maps a model's layer stack onto pipeline stages.

Copy of ``StagePlan`` / ``plan_stages`` from ``repro/core/partitioner.py``
(the cost-model partitioner waits for the scheduler's port). For the
homogeneous stacks of every supported arch the balanced contiguous
partition is optimal; the layer count is padded to ``stages ×
layers_per_stage`` with masked no-op layers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How one architecture's layers map onto ``n_stages`` pipeline stages."""

    n_layers: int          # real layers
    n_stages: int
    layers_per_stage: int  # local (padded) layer count L_s
    padded_layers: int     # n_stages * layers_per_stage


def plan_stages(cfg: ArchConfig, n_stages: int) -> StagePlan:
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    lps = -(-cfg.n_layers // n_stages)
    return StagePlan(n_layers=cfg.n_layers, n_stages=n_stages,
                     layers_per_stage=lps, padded_layers=lps * n_stages)
