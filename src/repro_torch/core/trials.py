"""Model-selection strategies (the Cerebro/Vizier/Tune layer of the paper)
— a copy of ``repro/core/trials.py`` (pure Python).

Hydra pairs its shard-parallel executor with a selection system; this module
provides the search-space → trial-stream side: grid search, random search and
(asynchronous-style) successive halving, all operating on ``TrialSpec``s and
consuming per-trial validation losses from the gang runner.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Optional, Sequence

from repro_torch.core.scheduler import TrialSpec


@dataclasses.dataclass
class TrialResult:
    spec: TrialSpec
    steps: int
    train_loss: float
    val_loss: float


def grid_search(arch: str, lrs: Sequence[float],
                weight_decays: Sequence[float] = (0.0,),
                seeds: Sequence[int] = (0,)) -> list[TrialSpec]:
    out = []
    for lr, wd, seed in itertools.product(lrs, weight_decays, seeds):
        out.append(TrialSpec(arch=arch, lr=lr, weight_decay=wd, seed=seed,
                             tag=f"lr{lr:g}-wd{wd:g}-s{seed}"))
    return out


def random_search(arch: str, n: int, lr_range=(1e-5, 1e-2),
                  wd_range=(0.0, 0.1), seed: int = 0) -> list[TrialSpec]:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        lr = math.exp(rng.uniform(math.log(lr_range[0]), math.log(lr_range[1])))
        wd = rng.uniform(*wd_range)
        out.append(TrialSpec(arch=arch, lr=lr, weight_decay=wd, seed=i,
                             tag=f"rand{i}"))
    return out


@dataclasses.dataclass
class SuccessiveHalving:
    """Synchronous successive halving over Hydra gangs.

    Rung r trains the surviving trials for ``base_steps * eta**r`` steps, then
    keeps the top 1/eta by validation loss. Because Hydra trains a whole rung
    as one shard-parallel gang, a rung costs roughly one model's time instead
    of K models' time — this is the paper's throughput claim applied to the
    selection loop itself.
    """

    base_steps: int = 50
    eta: int = 2
    max_rungs: int = 3

    def rung_steps(self, rung: int) -> int:
        return self.base_steps * (self.eta ** rung)

    def survivors(self, results: Sequence[TrialResult]) -> list[TrialSpec]:
        keep = max(1, len(results) // self.eta)
        ranked = sorted(results, key=lambda r: r.val_loss)
        return [r.spec for r in ranked[:keep]]

    def run(self, trials: Sequence[TrialSpec], train_fn) -> TrialResult:
        """train_fn(trials, n_steps) -> list[TrialResult] (one gang run)."""
        alive = list(trials)
        last: Optional[list[TrialResult]] = None
        for rung in range(self.max_rungs):
            last = train_fn(alive, self.rung_steps(rung))
            alive = self.survivors(last)
            if len(alive) == 1:
                break
        final = [r for r in last if r.spec in alive]
        return min(final, key=lambda r: r.val_loss)
