"""Elastic re-meshing: shrink the data axis around failed slices (port of
``repro/runtime/elastic.py``).

The stage ("model") axis is a hard dependency ring — losing a stage device
breaks the pipeline — so elasticity operates on the data axis: a failure
cordons the data row holding the device, the layout is rebuilt from the
surviving rows, gangs are re-planned (same trials, smaller data axis) and
training resumes from the last checkpoint. The re-plan changes more than
throughput: the engines keep their microbatch size and count, so the
global batch shrinks with the data axis, and the gradients after it are
those of a smaller batch (``core/scheduler.py::replan_after_failure``).

:func:`rebuild_mesh` returns the logical axis sizes the reference's
``Mesh`` would have; :func:`rebuild_layout` builds the device layout
(``launch.mesh.DeviceLayout``) of the surviving devices, on which the
placed train and serve steps run (re-place a gathered tree onto it with
``core.pipeline.place_trial_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

from repro_torch.core import scheduler as sched
from repro_torch.core.pipeline import EngineConfig
from repro_torch.launch.mesh import DeviceLayout, layout_of


@dataclasses.dataclass(frozen=True)
class MeshHealth:
    """Which (pod, data) rows are alive. The stage axis is all-or-nothing."""

    alive_rows: tuple  # of (pod_idx, data_idx)
    n_pods: int
    n_data: int

    @classmethod
    def fresh(cls, n_pods: int, n_data: int):
        return cls(tuple((p, d) for p in range(n_pods) for d in range(n_data)),
                   n_pods, n_data)

    def cordon(self, pod: int, data_row: int) -> "MeshHealth":
        alive = tuple(r for r in self.alive_rows if r != (pod, data_row))
        if not alive:
            raise RuntimeError("no healthy rows remain")
        return dataclasses.replace(self, alive_rows=alive)

    @property
    def usable_data_rows(self) -> int:
        """Largest uniform data-axis size across pods (a layout is a box)."""
        per_pod = {}
        for p, d in self.alive_rows:
            per_pod.setdefault(p, 0)
            per_pod[p] += 1
        return min(per_pod.values())

    @property
    def usable_pods(self) -> int:
        return len({p for p, _ in self.alive_rows})


def rebuild_mesh(devices: Union[int, Sequence], health: MeshHealth,
                 n_stages: int, multi_pod: bool) -> dict:
    """The largest healthy box layout from the surviving devices (a count,
    or a sequence of them): its axis sizes, as the reference's mesh has
    them."""
    have = devices if isinstance(devices, int) else len(devices)
    n_data = health.usable_data_rows
    n_pods = health.usable_pods if multi_pod else 1
    need = n_pods * n_data * n_stages
    if have < need:
        raise RuntimeError(f"need {need} devices, have {have}")
    if multi_pod:
        return {"pod": n_pods, "data": n_data, "model": n_stages}
    return {"data": n_data, "model": n_stages}


def rebuild_layout(devices: Sequence, health: MeshHealth, n_stages: int,
                   multi_pod: bool) -> DeviceLayout:
    """The reference's ``rebuild_mesh`` on ``torch.device``s: the largest
    healthy box layout, filled with the first ``pods · data · n_stages``
    of the surviving ``devices`` (strings or ``torch.device``) in the
    reference's reshape order (C order over pod, data, model; a size-1
    pod axis without ``multi_pod``). Raises where too few are given."""
    n_data = health.usable_data_rows
    n_pods = health.usable_pods if multi_pod else 1
    need = n_pods * n_data * n_stages
    if len(devices) < need:
        raise RuntimeError(f"need {need} devices, have {len(devices)}")
    return layout_of(list(devices)[:need], (n_pods, n_data, n_stages),
                     multi_pod)


def shrink_engine(eng: EngineConfig, health: MeshHealth) -> EngineConfig:
    return dataclasses.replace(
        eng, data_size=health.usable_data_rows,
        pod_size=health.usable_pods if eng.pod_axis else 1)


def elastic_replan(gangs, base_eng: EngineConfig, arch_configs: dict,
                   seq_len: int, health: MeshHealth):
    """Scheduler hook: same trials, shrunken data axis."""
    lost = base_eng.data_size - health.usable_data_rows
    return sched.replan_after_failure(gangs, base_eng, arch_configs, seq_len,
                                      lost_data_rows=lost)
