"""The reference's training of the hybrid MoE cells
(``bench/reference/hybrid_moe_model.py``): one trial alone, unpipelined,
its first steps with the plain AdamW, and the readings the comparison
takes from them, as ``bench/reference/train.py`` takes them for the
attention families.

A trial's weights are re-drawn unit by unit from the seed
(``bench.harness.hybrid_moe``), on the device the benchmark drew the
program's. Each microbatch's objective is its mean cross-entropy plus the
load-balance coefficient times the sum of its layers' load-balance
terms; the gradients add up microbatch by microbatch over the mean, and a
step's reported loss is the mean cross-entropy alone, as the program
defines a trial's objective and loss. Each layer runs under
``torch.utils.checkpoint`` (recomputed in the backward: the same
arithmetic, so that a 4096-token microbatch's activations fit beside the
trial's weights and AdamW state).

Readings (:func:`run_trial`): each step's loss; each leaf's first
gradient's norm as the optimizer takes it (after clipping by the trial's
global norm); each leaf's change's norm over the steps. A leaf is one
layer's matrix, vector or expert stack (``layers/<l>/moe/w_up``), or a
whole leaf outside the stack (``embed/tok``, ``final_norm``); the
vocabulary's padding is not part of any.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench.harness import hybrid_moe as H
from bench.harness import traffic as T
from bench.reference import hybrid_moe_model as model
from bench.reference.adamw import AdamW
from bench.reference.model import Precision


def trial_weights(hy: H.Hybrid, n_stages: int, seed: int, k: int,
                  device) -> dict:
    """Trial ``k``'s leaves by name as fresh fp32 tensors that require
    gradients."""
    out = {}
    with torch.no_grad():
        for i in range(hy.sizes.n_layers):
            for path, _, _ in H.layer_leaves(hy, i):
                out[f"layers/{i}/{path}"] = H.layer_unit(hy, seed, i, path, k,
                                                         device)
        for path, _, axis, real, _ in H.global_leaves(hy, n_stages):
            parts = [H.global_unit(hy, n_stages, seed, path, k, s, device)
                     for s in range(1 if axis is None else n_stages)]
            full = parts[0] if axis is None else torch.cat(parts, dim=axis)
            out[path] = full if axis is None else \
                full.narrow(axis, 0, real).clone()
    for t in out.values():
        t.requires_grad_()
    return out


def _layer_params(weights: dict, layer: int) -> dict:
    pre = f"layers/{layer}/"
    return {n[len(pre):]: t for n, t in weights.items() if n.startswith(pre)}


def microbatch_objective(prec, hy: H.Hybrid, weights: dict, tokens,
                         labels):
    """(cross-entropy, load-balance sum) of one microbatch (rows, seq)."""
    x = model.embed(hy, weights, tokens)
    aux = 0.0
    for i in range(hy.sizes.n_layers):
        x, a = checkpoint(model.layer, prec, hy, i,
                          _layer_params(weights, i), x, use_reentrant=False)
        aux = aux + a
    return model.loss(prec, hy, weights, x, labels), aux


def train_trial(hy: H.Hybrid, traffic: dict, seed: int, k: int, device,
                steps: int, precision: str = "float32", fault=None):
    """Trial ``k`` alone for ``steps`` steps on the benchmark's batches.
    ``precision``: ``float32`` or ``tf32`` (the control); ``fault``: None
    or ``half_batch`` (each microbatch's first half alone). Returns (its
    weights after the steps, each step's loss, {leaf: norm of the first
    gradient the optimizer took})."""
    weights = trial_weights(hy, traffic["stages"], seed, k, device)
    opt = AdamW(lr=traffic["lr"][k], weight_decay=traffic["weight_decay"][k],
                betas=tuple(traffic["betas"]), eps=traffic["eps"],
                grad_clip=traffic["grad_clip"])
    state = opt.init(weights)
    prec = Precision(precision)
    losses, first = [], None
    with prec:
        for step in range(steps):
            b = T.batch(traffic, hy.sizes.vocab_size, seed, step, device)
            if fault == "half_batch":
                b = T.half_batch(b)
            m = b["tokens"].shape[1]
            total = 0.0
            for i in range(m):
                ce, aux = microbatch_objective(prec, hy, weights,
                                               b["tokens"][k, i],
                                               b["labels"][k, i])
                ((ce + hy.aux_coef * aux) / m).backward()
                total += ce.item() / m
            losses.append(total)
            norms = opt.step(weights, state, norms=first is None)
            if first is None:
                first = norms
    return weights, losses, first


def run_trial(hy: H.Hybrid, traffic: dict, seed: int, k: int, device,
              steps: int, precision: str = "float32", fault=None) -> dict:
    """:func:`train_trial`'s readings: {"loss": [per step], "grad":
    {leaf: norm}, "change": {leaf: norm of its change over the steps}}."""
    weights, losses, first = train_trial(hy, traffic, seed, k, device, steps,
                                         precision, fault)
    change = {}
    with torch.no_grad():
        start = trial_weights(hy, traffic["stages"], seed, k, device)
        for n, t in weights.items():
            change[n] = float((t.detach() - start[n]).norm())
            start[n] = None
    del weights
    return {"loss": losses, "grad": first, "change": change}
