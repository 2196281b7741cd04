"""The reference's training: one trial alone, unpipelined, its first
steps with a plain AdamW, and the readings the comparison takes from
them.

A trial's weights are re-drawn unit by unit from the seed
(``bench.harness.weights``, the draw the program's weights came from) on
``draw_device``, the device the benchmark drew the program's on, and
each layer then moves to its own device: with several devices the stack
is cut into equal runs of layers, one a device, the embedding on the
first and the head on the last, and activations hop between them. Each
microbatch's loss is the mean over its tokens, a step's loss the mean
over the microbatches (the gradients add up microbatch by microbatch), as
the program defines a trial's loss.

Readings (:func:`run_trial`): each step's loss; the norm of each leaf's
first gradient as the optimizer takes it (after clipping by the trial's
global norm); the norm of each leaf's change over the steps. A leaf is
one layer's matrix or norm (``layers/<l>/attn/wq``), or a whole leaf
outside the stack (``embed/tok``, ``head``, ``final_norm``); the
vocabulary's padding is not part of any.
"""
from __future__ import annotations

import math

import torch

from bench.harness import traffic as T
from bench.harness import weights as W
from bench.harness.sizes import Sizes, stage_layers
from bench.reference import model
from bench.reference.adamw import AdamW


def layer_device(sizes: Sizes, devices, layer: int):
    per = -(-sizes.n_layers // len(devices))
    return devices[layer // per]


def trial_weights(sizes: Sizes, n_stages: int, seed: int, k: int, devices,
                  draw_device) -> dict:
    """Trial ``k``'s leaves by name, each on its device, as fresh fp32
    tensors that require gradients."""
    ls = stage_layers(sizes, n_stages)
    out = {}
    with torch.no_grad():
        for path, _, _ in W.layer_leaves(sizes):
            for s in range(n_stages):
                block = W.layer_unit(sizes, n_stages, seed, path, k, s,
                                     draw_device)
                for i in range(ls):
                    layer = s * ls + i
                    if layer < sizes.n_layers:
                        out[f"layers/{layer}/{path}"] = block[i].to(
                            layer_device(sizes, devices, layer), copy=True)
                del block
        for path, shape, axis, real, _ in W.global_leaves(sizes, n_stages):
            parts = [W.global_unit(sizes, n_stages, seed, path, k, s,
                                   draw_device)
                     for s in range(1 if axis is None else n_stages)]
            full = torch.cat(parts, dim=axis) if axis is not None \
                else parts[0]
            if axis is not None:
                full = full.narrow(axis, 0, real)
            home = devices[0] if path.startswith("embed/") else devices[-1]
            out[path] = full.to(home, copy=True)
    for t in out.values():
        t.requires_grad_()
    return out


def _layer_params(weights: dict, layer: int) -> dict:
    pre = f"layers/{layer}/"
    return {n[len(pre):]: t for n, t in weights.items() if n.startswith(pre)}


def microbatch_loss(prec, sizes: Sizes, weights: dict, devices, tokens,
                    labels):
    """The mean cross-entropy of one microbatch (rows, seq)."""
    x = model.embed(sizes, weights, tokens.to(devices[0]))
    for layer in range(sizes.n_layers):
        x = model.layer(prec, sizes, _layer_params(weights, layer),
                        x.to(layer_device(sizes, devices, layer)))
    return model.loss(prec, sizes, weights, x.to(devices[-1]),
                      labels.to(devices[-1]))


def train_trial(sizes: Sizes, traffic: dict, seed: int, k: int, devices,
                draw_device, steps: int, precision: str = "float32",
                fault=None):
    """Trial ``k`` alone for ``steps`` steps on the benchmark's batches.
    ``precision``: ``float32`` or ``tf32`` (the control); ``fault``:
    None or ``half_batch`` (each microbatch's first half alone). Returns
    (its weights after the steps, each step's loss, {leaf: norm of the
    first gradient the optimizer took})."""
    weights = trial_weights(sizes, traffic["stages"], seed, k, devices,
                            draw_device)
    opt = AdamW(lr=traffic["lr"][k], weight_decay=traffic["weight_decay"][k],
                betas=tuple(traffic["betas"]), eps=traffic["eps"],
                grad_clip=traffic["grad_clip"])
    state = opt.init(weights)
    prec = model.Precision(precision)
    losses, first = [], None
    with prec:
        for step in range(steps):
            b = T.batch(traffic, sizes.vocab_size, seed, step, draw_device)
            if fault == "half_batch":
                b = T.half_batch(b)
            m = b["tokens"].shape[1]
            total = 0.0
            for i in range(m):
                part = microbatch_loss(prec, sizes, weights, devices,
                                       b["tokens"][k, i], b["labels"][k, i])
                (part / m).backward()
                total += part.item() / m
            losses.append(total)
            norms = opt.step(weights, state, norms=first is None)
            if first is None:
                first = norms
    return weights, losses, first


def run_trial(sizes: Sizes, traffic: dict, seed: int, k: int, devices,
              draw_device, steps: int, precision: str = "float32",
              fault=None) -> dict:
    """:func:`train_trial`'s readings: {"loss": [per step], "grad":
    {leaf: norm}, "change": {leaf: norm of its change over the steps}}."""
    weights, losses, first = train_trial(sizes, traffic, seed, k, devices,
                                         draw_device, steps, precision,
                                         fault)
    change = {}
    with torch.no_grad():
        start = trial_weights(sizes, traffic["stages"], seed, k, devices,
                              draw_device)
        for n, t in weights.items():
            change[n] = float((t.detach() - start[n]).norm())
            start[n] = None
    del weights
    return {"loss": losses, "grad": first, "change": change}


def finite(readings: dict) -> bool:
    vals = list(readings["loss"]) + list(readings["grad"].values()) \
        + list(readings["change"].values())
    return all(math.isfinite(v) for v in vals)
