"""Fault-tolerant training loop: checkpoint/restart, preemption handling and
failure injection (for tests) — port of ``repro/runtime/fault_tolerance.py``.

Two differences from the reference, both from PyTorch's in-place state:

* A fault of the card (a CUDA error, a kernel launch that failed, running
  out of device memory) is re-raised, never retried: after one the
  device's state is suspect, and a retry would hide a kernel fault behind
  a restart. Only host-side exceptions restart from the last checkpoint.
* The train step updates ``state`` in place, so after a step has run the
  initial state no longer exists: a failure before the first checkpoint
  re-raises unless no step has run yet (the reference would restart from
  its immutable initial state).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.kernels.build import KernelLaunchError


@dataclasses.dataclass
class LoopConfig:
    n_steps: int
    checkpoint_every: int = 50
    ckpt_dir: Optional[str] = None
    max_restarts: int = 3
    keep_checkpoints: int = 3


@dataclasses.dataclass
class LoopReport:
    final_state: Any
    steps_run: int
    restarts: int
    resumed_from: Optional[int]
    wall_time_s: float
    step_metrics: list


class PreemptionGuard:
    """Checkpoint-on-SIGTERM: cooperative preemption for managed clusters."""

    def __init__(self):
        self.requested = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            self.requested = True
        try:
            self._prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # non-main thread (tests)
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
        return False


def is_device_fault(e: BaseException) -> bool:
    """A CUDA error, a failed kernel launch, or device memory exhausted."""
    faults = (KernelLaunchError, torch.cuda.OutOfMemoryError,
              getattr(torch, "AcceleratorError", KernelLaunchError))
    return isinstance(e, faults) or (isinstance(e, RuntimeError)
                                     and "CUDA error" in str(e))


def run_with_restarts(step_fn: Callable[[Any, int], tuple],
                      init_state: Any, loop: LoopConfig,
                      failure_injector: Optional[Callable[[int], None]] = None
                      ) -> LoopReport:
    """Run ``state, metrics = step_fn(state, step)`` for n_steps with
    checkpoint/restart.

    On a host-side exception (real or injected) reloads the latest
    checkpoint and continues, up to ``max_restarts``; device faults
    (:func:`is_device_fault`) re-raise at once. The state must be a
    checkpoint-restorable tree of tensors; a restore places each leaf on
    its template's device.
    """
    t0 = time.monotonic()
    saver = (ckpt_lib.AsyncCheckpointer(loop.ckpt_dir, loop.keep_checkpoints)
             if loop.ckpt_dir else None)
    state = init_state
    start_step = 0
    resumed_from = None
    if loop.ckpt_dir:
        latest = ckpt_lib.latest_step(loop.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(loop.ckpt_dir, latest, init_state)
            start_step = latest
            resumed_from = latest
    restarts = 0
    metrics_log = []
    step = start_step
    stepped = False  # has step_fn run (and so changed state in place)?
    with PreemptionGuard() as guard:
        while step < loop.n_steps:
            try:
                if failure_injector is not None:
                    failure_injector(step)
                stepped = True
                state, metrics = step_fn(state, step)
                metrics_log.append(metrics)
                step += 1
                at_ckpt = loop.ckpt_dir and (
                    step % loop.checkpoint_every == 0 or step == loop.n_steps)
                if at_ckpt or (guard.requested and loop.ckpt_dir):
                    saver.save(step, state, extra={"step": step})
                if guard.requested:
                    break
            except Exception as e:
                restarts += 1
                if (is_device_fault(e) or restarts > loop.max_restarts
                        or not loop.ckpt_dir):
                    raise
                saver.wait()
                latest = ckpt_lib.latest_step(loop.ckpt_dir)
                if latest is None:
                    if stepped:
                        raise  # in-place state cannot rewind to step 0
                    state, step = init_state, 0
                else:
                    state = ckpt_lib.restore(loop.ckpt_dir, latest, state)
                    step = latest
    if saver:
        saver.wait()
    return LoopReport(final_state=state, steps_run=step - start_step,
                      restarts=restarts, resumed_from=resumed_from,
                      wall_time_s=time.monotonic() - t0,
                      step_metrics=metrics_log)
