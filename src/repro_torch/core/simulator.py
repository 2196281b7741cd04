"""Discrete-event simulator of multi-model training schedules (port of
``repro/core/simulator.py``: plain Python, so its makespans and
utilizations equal the reference's float for float).

Reproduces the paper's Figure 2 comparison — task parallelism vs model
parallelism vs Hydra's shard parallelism — as *measured makespans and device
utilizations* of an event-driven executor, not just closed-form formulas (the
formulas are asserted against the simulator in tests).

Model (matches the paper's setting):
  * K models, each a chain of S shards; a device holds one shard per model
    (device d holds shard d of every model it serves).
  * A shard task (model k, shard s, microbatch m, direction) is ready when its
    predecessor finished; forward chains s=0..S-1, backward chains back.
  * Backward work costs ``bwd_ratio`` × forward work (default 2).
  * Task parallelism: each model trains alone on one device (needs the model
    to fit — the regime the paper says breaks for big models).
  * Model parallelism: models run one at a time, sharded over all devices.
  * Shard parallelism: all models' shards stream through the device ring.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SimResult:
    makespan: float
    utilization: float  # busy-time / (devices × makespan)
    per_device_busy: tuple

    def speedup_over(self, other: "SimResult") -> float:
        return other.makespan / self.makespan


def _simulate(task_graph, n_devices: int) -> SimResult:
    """Generic list-scheduler DES: task = (device, duration, deps...)."""
    n_tasks = len(task_graph)
    indeg = [0] * n_tasks
    succ: list[list[int]] = [[] for _ in range(n_tasks)]
    for i, (_, _, deps) in enumerate(task_graph):
        indeg[i] = len(deps)
        for d in deps:
            succ[d].append(i)
    dev_free = [0.0] * n_devices
    busy = [0.0] * n_devices
    ready: list[tuple[float, int]] = []  # (earliest_start, task)
    task_ready_time = [0.0] * n_tasks
    for i in range(n_tasks):
        if indeg[i] == 0:
            heapq.heappush(ready, (0.0, i))
    finish = [0.0] * n_tasks
    pending = n_tasks
    while ready:
        est, i = heapq.heappop(ready)
        dev, dur, _ = task_graph[i]
        start = max(est, dev_free[dev])
        end = start + dur
        dev_free[dev] = end
        busy[dev] += dur
        finish[i] = end
        pending -= 1
        for j in succ[i]:
            indeg[j] -= 1
            task_ready_time[j] = max(task_ready_time[j], end)
            if indeg[j] == 0:
                heapq.heappush(ready, (task_ready_time[j], j))
    if pending:
        raise RuntimeError("cyclic task graph")
    makespan = max(finish) if finish else 0.0
    util = sum(busy) / (n_devices * makespan) if makespan else 0.0
    return SimResult(makespan, util, tuple(busy))


def simulate_shard_parallel(n_models: int, n_shards: int,
                            n_microbatches: int = 1, fwd_cost: float = 1.0,
                            bwd_ratio: float = 2.0) -> SimResult:
    """Hydra: K models × M microbatches stream through S shard-devices."""
    tasks = []
    idx = {}
    for k in range(n_models):
        for m in range(n_microbatches):
            for s in range(n_shards):
                deps = []
                if s > 0:
                    deps.append(idx[(k, m, s - 1, "f")])
                idx[(k, m, s, "f")] = len(tasks)
                tasks.append((s, fwd_cost, deps))
            for s in reversed(range(n_shards)):
                deps = [idx[(k, m, s + 1, "b")] if s < n_shards - 1
                        else idx[(k, m, n_shards - 1, "f")]]
                idx[(k, m, s, "b")] = len(tasks)
                tasks.append((s, fwd_cost * bwd_ratio, deps))
    return _simulate(tasks, n_shards)


def simulate_model_parallel(n_models: int, n_shards: int,
                            n_microbatches: int = 1, fwd_cost: float = 1.0,
                            bwd_ratio: float = 2.0,
                            pipelined: bool = False) -> SimResult:
    """Model parallelism baselines, one model at a time over all devices.

    ``pipelined=False`` (default) is the paper's *traditional* model
    parallelism (Fig. 1): strictly sequential microbatches, utilization 1/S.
    ``pipelined=True`` is the stronger GPipe-style baseline — microbatches of
    one model pipeline, but each model still pays its own fill/drain bubble.
    """
    tasks = []
    prev_model_end: Optional[int] = None
    for k in range(n_models):
        idx = {}
        for m in range(n_microbatches):
            for s in range(n_shards):
                deps = []
                if s > 0:
                    deps.append(idx[(m, s - 1, "f")])
                elif m > 0:
                    # pipelined: next microbatch may enter as soon as stage 0
                    # frees; sequential: only after the previous microbatch's
                    # backward fully completes (the paper's Fig. 1 timeline)
                    deps.append(idx[(m - 1, 0, "f")] if pipelined
                                else idx[(m - 1, 0, "b")])
                if s == 0 and m == 0 and prev_model_end is not None:
                    deps.append(prev_model_end)
                idx[(m, s, "f")] = len(tasks)
                tasks.append((s, fwd_cost, deps))
            for s in reversed(range(n_shards)):
                deps = [idx[(m, s + 1, "b")] if s < n_shards - 1
                        else idx[(m, n_shards - 1, "f")]]
                idx[(m, s, "b")] = len(tasks)
                tasks.append((s, fwd_cost * bwd_ratio, deps))
        prev_model_end = idx[(n_microbatches - 1, 0, "b")]
    return _simulate(tasks, n_shards)


def simulate_task_parallel(n_models: int, n_devices: int,
                           n_shards: int, n_microbatches: int = 1,
                           fwd_cost: float = 1.0,
                           bwd_ratio: float = 2.0) -> SimResult:
    """Task parallelism: each model whole on one device (models must fit)."""
    tasks = []
    per_model = n_shards * n_microbatches * fwd_cost * (1 + bwd_ratio)
    for k in range(n_models):
        dev = k % n_devices
        deps = [len(tasks) - 1] if k >= n_devices else []
        tasks.append((dev, per_model, deps))
    return _simulate(tasks, n_devices)


def theoretical_shard_parallel_makespan(n_models: int, n_shards: int,
                                        n_microbatches: int = 1,
                                        fwd_cost: float = 1.0,
                                        bwd_ratio: float = 2.0) -> float:
    """Closed form used by the scheduler's what-if planning: steady-state
    work + fill/drain bubble. Asserted ≈ simulator in tests."""
    slots = n_models * n_microbatches
    per_slot = fwd_cost * (1 + bwd_ratio)
    return slots * per_slot + (n_shards - 1) * per_slot


def figure2_table(n_shards: int = 8, n_models_list=(1, 2, 4, 8, 16),
                  n_microbatches: int = 16) -> list[dict]:
    """The paper's Fig. 2 as numbers: speedup of shard parallelism.

    ``n_microbatches`` models the per-step batch stream (training runs many
    microbatches per model, so the fill/drain bubble amortizes — M=16 gives
    the steady-state regime the paper's figure depicts)."""
    rows = []
    for k in n_models_list:
        sp = simulate_shard_parallel(k, n_shards, n_microbatches)
        mp = simulate_model_parallel(k, n_shards, n_microbatches)
        gp = simulate_model_parallel(k, n_shards, n_microbatches,
                                     pipelined=True)
        tp = simulate_task_parallel(k, n_shards, n_shards, n_microbatches)
        rows.append({
            "n_models": k,
            "n_shards": n_shards,
            "shard_makespan": sp.makespan,
            "model_makespan": mp.makespan,
            "gpipe_makespan": gp.makespan,
            "task_makespan": tp.makespan,
            "shard_util": sp.utilization,
            "model_util": mp.utilization,
            "gpipe_util": gp.utilization,
            "task_util": tp.utilization,
            "speedup_vs_model_parallel": sp.speedup_over(mp) if sp.makespan else 0,
            "speedup_vs_gpipe": sp.speedup_over(gp) if sp.makespan else 0,
            "speedup_vs_task_parallel": sp.speedup_over(tp) if sp.makespan else 0,
        })
    return rows
