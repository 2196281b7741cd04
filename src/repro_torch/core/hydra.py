"""Hydra orchestrator: search space → gangs → shard-parallel training →
model selection — port of ``repro/core/hydra.py`` (the paper's Fig. 3,
with Cerebro's role played by ``core.trials``).

Each gang's K trials train as one pipelined program over S stages
(``core.pipeline.make_train_step``), in one process on one device, or,
given a device layout, with every stage and data replica on its own
device of the layout; parameters and optimizer state are updated in
place.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import pipeline as pl
from repro_torch.core.partitioner import plan_stages
from repro_torch.core.scheduler import GangPlan, TrialSpec, plan_gangs
from repro_torch.core.trials import TrialResult
from repro_torch.data.pipeline import TrainBatches
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.layers import ModelOptions
from repro_torch.obs.tracer import resolve
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault_tolerance import (LoopConfig, StateCodec,
                                                 run_with_restarts)


@dataclasses.dataclass
class HydraConfig:
    seq_len: int
    steps: int
    checkpoint_every: int = 50
    ckpt_dir: Optional[str] = None
    seed: int = 0
    param_dtype: torch.dtype = torch.float32


def placed_state_codec(cfg: ArchConfig, eng: pl.EngineConfig,
                       layout) -> StateCodec:
    """Checkpoint a placed (params, opt_state) as the one-device tree: the
    parameters and every placed tree of the optimizer state gathered, its
    step count as it is."""
    def gather(state, device):
        params, opt = state
        g = lambda tree: pl.gather_trial_params(cfg, eng, tree, layout,
                                                device)
        return g(params), {n: g(v) if isinstance(v, list) else v
                           for n, v in opt.items()}

    def scatter(tree, state):
        params, opt = state
        s = lambda full, placed: pl.scatter_trial_params_(cfg, eng, placed,
                                                          full, layout)
        s(tree[0], params)
        for n, v in opt.items():
            if isinstance(v, list):
                s(tree[1][n], v)
            else:
                v.copy_(tree[1][n])
        return state

    return StateCodec(gather, scatter)


class HydraRunner:
    """Runs one gang (same-arch trials) as a single pipelined program on
    ``device`` (CUDA unless the caller passes "cpu"), or on ``layout`` (a
    ``launch.mesh.DeviceLayout``): the gang's weights are initialised on
    the layout's root device, from the same generator as on one device,
    and then placed."""

    def __init__(self, cfg: ArchConfig, opts: ModelOptions,
                 hydra_cfg: HydraConfig, optimizer: Optional[AdamW] = None,
                 tracer=None, device=None, layout=None):
        self.cfg, self.opts = cfg, opts
        self.hc = hydra_cfg
        self.optimizer = optimizer or AdamW(grad_clip=1.0)
        if layout is not None and device is not None:
            raise ValueError("pass a device or a layout, not both")
        self.layout = layout
        self.device = (layout.root if layout is not None
                       else resolve_device(device))
        # gang/rung wall-clock spans for the obs timeline (NULL_TRACER when
        # off — span emission is two events per gang, never per step)
        self.trace = resolve(tracer)

    def _build(self, gang: GangPlan):
        eng = gang.engine
        plan = plan_stages(self.cfg, eng.n_stages)
        gen = torch.Generator(device=self.device).manual_seed(self.hc.seed)
        max_pos = self.hc.seq_len if self.cfg.rope == "learned" else 0
        params = pl.init_trial_params(self.cfg, eng, plan, gen,
                                      dtype=self.hc.param_dtype,
                                      device=self.device, max_pos=max_pos)
        if self.layout is not None:
            params = pl.place_trial_params(self.cfg, eng, params,
                                           self.layout)
        opt_state = self.optimizer.init(params)
        hparams = {
            "lr": torch.tensor([t.lr for t in gang.trials],
                               dtype=torch.float32, device=self.device),
            "wd": torch.tensor([t.weight_decay for t in gang.trials],
                               dtype=torch.float32, device=self.device),
        }
        step_fn = pl.make_train_step(self.cfg, self.opts, eng,
                                     self.optimizer, layout=self.layout)
        return params, opt_state, hparams, step_fn

    def run_gang(self, gang: GangPlan, n_steps: Optional[int] = None
                 ) -> list[TrialResult]:
        eng = gang.engine
        n_steps = n_steps or self.hc.steps
        if self.trace.enabled:
            self.trace.span_begin("gang", arch=gang.arch,
                                  n_trials=eng.n_trials,
                                  n_microbatches=eng.n_microbatches,
                                  steps=n_steps)
        params, opt_state, hparams, step_fn = self._build(gang)
        data = TrainBatches(self.cfg, eng, self.hc.seq_len,
                            seed=self.hc.seed)
        losses = np.zeros((eng.n_trials,), np.float64)

        def one_step(state, step):
            p, o = state
            batch = data.batch_for_step(step)
            p, o, metrics = step_fn(p, o, batch, hparams, step)
            return (p, o), metrics

        # each gang owns a checkpoint subdirectory: restarts within one gang
        # resume exactly, but a later gang (another rung of successive
        # halving, a different K) can never restore a stale checkpoint whose
        # trial axis doesn't match its own parameter shapes
        ckpt_dir = self.hc.ckpt_dir
        if ckpt_dir is not None:
            tag = "|".join(t.tag or f"lr{t.lr:g}wd{t.weight_decay:g}s{t.seed}"
                           for t in gang.trials)
            digest = hashlib.md5(tag.encode()).hexdigest()[:8]
            ckpt_dir = os.path.join(
                ckpt_dir, f"{gang.arch}-k{eng.n_trials}-n{n_steps}-{digest}")
        try:
            report = run_with_restarts(
                one_step, (params, opt_state),
                LoopConfig(n_steps=n_steps,
                           checkpoint_every=self.hc.checkpoint_every,
                           ckpt_dir=ckpt_dir),
                codec=(None if self.layout is None else
                       placed_state_codec(self.cfg, eng, self.layout)))
        finally:
            data.close()
        params, opt_state = report.final_state
        if report.step_metrics:
            losses = np.asarray(report.step_metrics[-1]["loss"])
        # held-out evaluation: a fresh deterministic batch beyond train steps
        val = self.evaluate(gang, params, hparams, step=10_000_000)
        if self.trace.enabled:
            self.trace.span_end("gang", arch=gang.arch,
                                restarts=report.restarts,
                                steps_run=report.steps_run)
        return [TrialResult(spec=t, steps=n_steps,
                            train_loss=float(losses[i]),
                            val_loss=float(val[i]))
                for i, t in enumerate(gang.trials)]

    def evaluate(self, gang: GangPlan, params, hparams, step: int):
        """Per-trial validation loss (K,) numpy on a held-out deterministic
        batch."""
        data = TrainBatches(self.cfg, gang.engine, self.hc.seq_len,
                            seed=self.hc.seed + 999)
        batch = data.batch_for_step(step)
        data.close()
        with torch.no_grad():
            loss, _ = pl.pipeline_train_loss(self.cfg, self.opts,
                                             gang.engine, params, batch,
                                             layout=self.layout)
        return loss.cpu().numpy()


def run_model_selection(cfg: ArchConfig, opts: ModelOptions,
                        hydra_cfg: HydraConfig, trials: Sequence[TrialSpec],
                        base_eng: pl.EngineConfig, strategy=None,
                        tracer=None, device=None, layout=None) -> dict:
    """Full Hydra workflow: plan gangs, train them shard-parallel, select.
    The reference's ``mesh`` is ``layout`` (a ``launch.mesh.DeviceLayout``
    of ``base_eng``'s pod, data and stage sizes: each gang runs placed on
    it); without one the stage and data axes are structure inside one
    process on ``device``.

    ``tracer`` (``repro_torch.obs.Tracer``) wraps each successive-halving
    rung — every ``train_fn`` invocation — and each gang in wall-clock
    spans; a gang's end span carries its loop's restart count.

    Returns {"best": TrialResult, "all": [TrialResult...]}.
    """
    trace = resolve(tracer)
    runner = HydraRunner(cfg, opts, hydra_cfg, tracer=tracer, device=device,
                         layout=layout)
    all_results: list[TrialResult] = []
    rung = [0]  # train_fn call index (a halving strategy calls it per rung)

    def train_fn(specs, n_steps):
        if trace.enabled:
            trace.span_begin("rung", label=rung[0], n_trials=len(specs),
                             steps=n_steps)
        gangs = plan_gangs(specs, base_eng, {cfg.name: cfg},
                           hydra_cfg.seq_len,
                           param_dtype=hydra_cfg.param_dtype)
        out = []
        for g in gangs:
            out.extend(runner.run_gang(g, n_steps))
        all_results.extend(out)
        if trace.enabled:
            trace.span_end("rung", label=rung[0])
        rung[0] += 1
        return out

    if strategy is None:
        results = train_fn(list(trials), hydra_cfg.steps)
        best = min(results, key=lambda r: r.val_loss)
    else:
        best = strategy.run(list(trials), train_fn)
    return {"best": best, "all": all_results}
