"""Three-term roofline model for one NVIDIA H100, fed by the port's counted
costs (``analysis/costs.py``) — the counterpart of
``repro/analysis/roofline.py``.

Per (arch × shape × layout) cell:

    compute    = counted FLOPs per device / peak FLOP/s of the compute dtype
    memory     = HBM bytes per device (stream model) / HBM bandwidth
    collective = 0: the port runs every stage and data shard in one process
                 on one card, so nothing crosses a link (the column stays so
                 that rows keep the reference's columns)

Derived metrics, as the reference's:

    MODEL_FLOPS          = 6·N·D (train) or 2·N·D (forward-only), N = params
                           (active params for MoE), D = tokens per step per
                           trial × trials
    useful-compute ratio = MODEL_FLOPS / (counted FLOPs per device × devices)
                           (catches bubble / remat / masked-block waste)
    roofline_fraction    = ideal model-compute time / dominant term
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

# dense rates (no sparsity), at the 700 W limit
PEAK_FLOPS_BF16 = 989e12  # FLOP/s bf16, tensor cores (H100 SXM data sheet)
PEAK_FLOPS_FP32 = 67e12  # FLOP/s fp32, CUDA cores (H100 SXM data sheet)
HBM_BW = 3.35e12  # B/s of HBM3 (H100 SXM data sheet)
HBM_BYTES = 80 * 1000 ** 3  # 80 GB of HBM3 (H100 SXM data sheet)
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float32: PEAK_FLOPS_FP32}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    counted_flops_per_device: float
    collective_detail: dict
    peak_flops: float = PEAK_FLOPS_BF16  # of the compute dtype

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        # the reference scales this by a bubble-skipping engine's wall
        # factor; the port skips bubble ticks outright and bills none
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.counted_flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def ideal_model_time_s(self) -> float:
        return self.model_flops / (self.n_chips * self.peak_flops)

    @property
    def roofline_fraction(self) -> float:
        t = self.bound_time_s
        return self.ideal_model_time_s / t if t else 0.0

    @property
    def roofline_fraction_streamed(self) -> float:
        """The reference's fraction with refilled bubbles: the same here
        (no bubble tick is billed)."""
        return self.roofline_fraction

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "counted_flops_device": self.counted_flops_per_device,
            "peak_flops": self.peak_flops,
            "useful_ratio": self.useful_ratio,
            "wall_factor": 1.0,
            "roofline_fraction": self.roofline_fraction,
            "roofline_fraction_streamed": self.roofline_fraction_streamed,
            "collectives": self.collective_detail,
        }


def model_flops_for_cell(cfg: ArchConfig, shape: ShapeConfig,
                         n_trials: int = 1) -> float:
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if shape.kind == "train":
        per_trial = 6.0 * n * shape.tokens_per_step
    else:  # prefill processes seq tokens; decode one token per sequence
        per_trial = 2.0 * n * shape.tokens_per_step
    return per_trial * n_trials


def from_costs(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
               n_chips: int, costs, n_trials: int = 1,
               dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """The roofline row of counted ``costs`` (an ``analysis.costs.Costs``)
    at the peak of ``dtype``, the cell's compute dtype."""
    peak = PEAK_FLOPS[dtype]
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        compute_s=costs.flops / peak,
        memory_s=costs.hbm_bytes / HBM_BW,
        collective_s=0.0,  # one process on one card: no collectives
        model_flops=model_flops_for_cell(cfg, shape, n_trials),
        counted_flops_per_device=costs.flops,
        collective_detail={}, peak_flops=peak)


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':26s} {'shape':12s} {'mesh':9s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'collect_s':>10s} {'dominant':>10s} "
           f"{'useful':>7s} {'roofline':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:9s} "
            f"{r['compute_s']:10.4f} {r['memory_s']:10.4f} "
            f"{r['collective_s']:10.4f} {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.3f} {r['roofline_fraction']:9.4f}")
    return "\n".join(lines)
