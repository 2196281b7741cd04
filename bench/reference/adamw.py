"""A plain AdamW for one trial: clip by the global gradient norm, then
the decoupled update p -= lr · (m̂ / (√v̂ + ε) + wd · p), in fp32."""
from __future__ import annotations

import torch


class AdamW:
    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, grad_clip: float = 0.0):
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2 = betas
        self.eps, self.clip = eps, grad_clip

    def init(self, weights: dict) -> dict:
        return {"m": {n: torch.zeros_like(t) for n, t in weights.items()},
                "v": {n: torch.zeros_like(t) for n, t in weights.items()},
                "count": 0}

    @torch.no_grad()
    def step(self, weights: dict, state: dict, norms: bool = False):
        """One update from each leaf's ``.grad`` (cleared afterwards).
        With ``norms``, returns {leaf: norm of the gradient the update
        took, after clipping}."""
        grads = {n: t.grad for n, t in weights.items()}
        total = torch.sqrt(sum(g.double().pow(2).sum().to(
            next(iter(grads.values())).device) for g in grads.values()))
        scale = 1.0
        if self.clip > 0:
            scale = min(1.0, self.clip / (float(total) + 1e-9))
        state["count"] += 1
        c1 = 1 - self.b1 ** state["count"]
        c2 = 1 - self.b2 ** state["count"]
        out = {}
        for n, p in weights.items():
            g = grads[n] * scale
            if norms:
                out[n] = float(g.norm())
            m, v = state["m"][n], state["v"][n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * upd)
            p.grad = None
        return out if norms else None
