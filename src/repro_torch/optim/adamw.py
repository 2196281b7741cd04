"""AdamW and SGD with per-trial hyperparameters — port of
``repro/optim/adamw.py``.

Hydra trains K trials in one program, so every hyperparameter the
model-selection layer searches over (learning rate, weight decay) is a (K,)
tensor broadcast against the leading trial axis of each parameter leaf, and
gradient clipping is by each trial's own global norm.

Parameters and state are nested dicts of tensors in the reference's
layout; the state is ``{"m", "v", "count"}`` with fp32 moments. The update
is **in place**: ``params``, ``state`` and (as scratch) ``grads`` are
overwritten. At full width one fp32 leaf is up to 1.8 GB, so a functional
update's temporaries would cost several times that; here each leaf's step
allocates one temporary of its size (the Adam denominator).

:class:`SGD` (the paper's MLP accuracy-parity experiment: plain, or with
momentum) updates in place the same way, with state ``{"count"}`` and, with
momentum, fp32 ``"mom"`` buffers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


def _bcast(vec, leaf):
    """(K,) -> (K, 1, 1, ...) matching leaf rank."""
    return vec.reshape(vec.shape + (1,) * (leaf.ndim - 1))


def _on_device(*vecs):
    """fn(device) -> the (K,) ``vecs`` on ``device``, copied once per
    device: a placed tree's leaves lie on several devices, and every
    replica of a leaf must see the same values."""
    cache = {}

    def at(device):
        if device not in cache:
            cache[device] = tuple(v.to(device) for v in vecs)
        return cache[device]

    return at


# ---------------------------------------------------------------------------
# LR schedules: step (int) -> multiplier (float)
# ---------------------------------------------------------------------------


def constant_schedule(step):
    return 1.0


def warmup_cosine_schedule(warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        step = float(step)
        warm = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi
                                                                  * prog))
        return warm * cos
    return fn


def warmup_linear_schedule(warmup: int, total: int):
    def fn(step):
        step = float(step)
        warm = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return warm * (1 - prog)
    return fn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # default; override per-trial via hparams["wd"]
    grad_clip: float = 0.0  # 0 = off; per-trial clip-by-global-norm
    schedule: Callable = dataclasses.field(default=constant_schedule)

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(self, params, grads, state, hparams, step,
               grad_norm: Optional[torch.Tensor] = None):
        """One AdamW step, in place. hparams: {"lr": (K,), optional "wd":
        (K,)} (tensors, arrays or lists); ``step`` the schedule's step;
        ``grad_norm`` the per-trial global gradient norm (K,), for
        clip-by-global-norm. Each leaf's update uses these (K,) vectors on
        the leaf's own device (a placed tree spans several). Returns
        (params, state), the same objects."""
        leaves = tree_leaves(params)
        dev = leaves[0].device
        as_vec = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                           device=dev).reshape(-1)
        lr = as_vec(hparams["lr"]) * float(self.schedule(int(step)))
        wd = hparams.get("wd")
        wd = (torch.full_like(lr, self.weight_decay) if wd is None
              else as_vec(wd))
        state["count"] += 1
        count = float(state["count"])
        b1c = 1 - self.b1 ** count
        b2c = 1 - self.b2 ** count
        if self.grad_clip > 0 and grad_norm is not None:
            scale = torch.clamp(self.grad_clip / (as_vec(grad_norm) + 1e-9),
                                max=1.0)
        else:
            scale = torch.ones_like(lr)
        vecs = _on_device(lr, wd, scale)
        for p, g, m, v in zip(leaves, tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            lr, wd, scale = vecs(p.device)
            g = g.float().mul_(_bcast(scale, g))  # grads are scratch
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = v.div(b2c).sqrt_().add_(self.eps)
            delta = torch.div(m, b1c, out=g).div_(denom)  # mhat / (√vhat+ε)
            del denom
            delta.addcmul_(p.float(), _bcast(wd, p))
            if p.dtype == torch.float32:
                p.addcmul_(delta, _bcast(lr, p), value=-1.0)
            else:
                p.copy_(p.float().addcmul_(delta, _bcast(lr, p), value=-1.0))
        return params, state


# ---------------------------------------------------------------------------
# SGD (the paper's MLP accuracy-parity experiment: plain or with momentum)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SGD:
    momentum: float = 0.0

    def init(self, params):
        state = {"count": torch.zeros((), dtype=torch.int32)}
        if self.momentum != 0.0:
            state["mom"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
        return state

    @torch.no_grad()
    def update(self, params, grads, state, hparams, step, grad_norm=None):
        """One step, in place: p -= lr · g, or with momentum mom = μ · mom
        + g and p -= lr · mom (fp32 arithmetic, the result in p's dtype).
        hparams: {"lr": (K,)} per trial (tensors, arrays or lists);
        ``step`` and ``grad_norm`` are accepted for the optimizer interface
        (no schedule, no clipping, as the reference's). Returns (params,
        state), the same objects."""
        leaves = tree_leaves(params)
        lr = torch.as_tensor(hparams["lr"], dtype=torch.float32,
                             device=leaves[0].device).reshape(-1)
        state["count"] += 1
        moms = (tree_leaves(state["mom"]) if self.momentum != 0.0
                else [None] * len(leaves))
        lr_at = _on_device(lr)
        for p, g, mom in zip(leaves, tree_leaves(grads), moms):
            lr, = lr_at(p.device)
            step_dir = g.float()
            if mom is not None:
                mom.mul_(self.momentum).add_(step_dir)
                step_dir = mom
            if p.dtype == torch.float32:
                p.addcmul_(step_dir, _bcast(lr, p), value=-1.0)
            else:
                p.copy_(p.float().addcmul_(step_dir, _bcast(lr, p),
                                           value=-1.0))
        return params, state
