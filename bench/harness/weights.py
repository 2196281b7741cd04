"""The benchmark's weights, drawn on the device from ``--seed``.

The unit of a draw is one leaf of one trial on one pipeline stage: a
layer leaf's ``(layers per stage, ...)`` block, a vocabulary-split leaf's
slice (the embedding's rows, the head's columns, the learned position
table's rows), or a replicated leaf whole. Each unit has its own
generator, seeded from (seed, leaf, trial, stage), so a unit can be drawn
again alone: the reference re-draws the trial it follows, layer block by
layer block, and never reads the program's copy. Matrices are N(0,
1/fan_in), the embedding and position tables N(0, 1), norm weights one
and biases zero; rows and columns that pad the vocabulary to a multiple
of the stages are zero.

Leaves are named by their paths in the program's parameter tree
(``layers/attn/wq``, ``embed/tok``, ``head``, ...), and
:func:`trial_tree` lays the units out in that tree: K trials stacked on
a leading axis, the layer stack on the next. Nothing here imports the
program.
"""
from __future__ import annotations

import hashlib
import math

import torch

from bench.harness.sizes import Sizes, padded_vocab, stage_layers


def layer_leaves(sizes: Sizes) -> list:
    """(path under ``layers/``, one layer's shape, init) of every layer
    leaf; init is ("normal", fan_in), "ones" or "zeros"."""
    d, f = sizes.d_model, sizes.d_ff
    q, kv = sizes.n_heads * sizes.head_dim, sizes.n_kv_heads * sizes.head_dim
    out = [("attn/wq", (d, q), ("normal", d)),
           ("attn/wk", (d, kv), ("normal", d)),
           ("attn/wv", (d, kv), ("normal", d)),
           ("attn/wo", (q, d), ("normal", q))]
    if sizes.act == "swiglu":
        out.append(("mlp/w_gate", (d, f), ("normal", d)))
    out += [("mlp/w_up", (d, f), ("normal", d)),
            ("mlp/w_down", (f, d), ("normal", f))]
    if sizes.family == "encoder":
        out += [("ln1_w", (d,), "ones"), ("ln1_b", (d,), "zeros"),
                ("ln2_w", (d,), "ones"), ("ln2_b", (d,), "zeros")]
    else:
        out += [("ln1", (d,), "ones"), ("ln2", (d,), "ones")]
    return out


def global_leaves(sizes: Sizes, n_stages: int) -> list:
    """(path, full shape, split axis or None, real length along it, init)
    of every leaf outside the layer stack. A split leaf's slice for stage
    s is ``[s * n / S, (s + 1) * n / S)`` along its axis; entries at or
    past the real length are padding (zero)."""
    d, v = sizes.d_model, sizes.vocab_size
    vp = padded_vocab(sizes, n_stages)
    out = [("embed/tok", (vp, d), 0, v, ("normal", 1)),
           ("head", (d, vp), 1, v, ("normal", d))]
    if sizes.rope == "learned":
        p = sizes.max_positions
        if p % n_stages:
            raise ValueError(f"{p} positions do not split over {n_stages} "
                             f"stages")
        out.append(("embed/pos", (p, d), 0, p, ("normal", 1)))
    if sizes.family == "encoder":
        out += [("final_norm/w", (d,), None, d, "ones"),
                ("final_norm/b", (d,), None, d, "zeros")]
    else:
        out.append(("final_norm", (d,), None, d, "ones"))
    return out


def unit_seed(seed: int, path: str, k: int, s: int) -> int:
    """The generator seed of one unit: 63 bits of a hash of its key (any
    ``--seed``, however large, gives a valid seed)."""
    h = hashlib.blake2b(f"{seed}|{path}|{k}|{s}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def draw(shape, init, key: int, device) -> torch.Tensor:
    """A fresh contiguous fp32 tensor of ``shape``: N(0, 1/fan) from a
    generator seeded with ``key`` on ``device``, or ones, or zeros."""
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    _, fan = init
    gen = torch.Generator(device=device).manual_seed(key)
    out = torch.empty(shape, device=device)
    return out.normal_(0.0, 1.0 / math.sqrt(fan), generator=gen)


def layer_unit(sizes: Sizes, n_stages: int, seed: int, path: str, k: int,
               s: int, device) -> torch.Tensor:
    """Stage ``s``'s block (layers per stage, ...) of layer leaf ``path``
    for trial ``k``."""
    _, shape, init = next(x for x in layer_leaves(sizes) if x[0] == path)
    ls = stage_layers(sizes, n_stages)
    return draw((ls,) + shape, init, unit_seed(seed, "layers/" + path, k, s),
                device)


def global_unit(sizes: Sizes, n_stages: int, seed: int, path: str, k: int,
                s: int, device) -> torch.Tensor:
    """Stage ``s``'s slice of a split leaf (its padding zeroed), or, for a
    replicated leaf, the whole of it (``s`` ignored)."""
    _, shape, axis, real, init = next(
        x for x in global_leaves(sizes, n_stages) if x[0] == path)
    if axis is None:
        return draw(shape, init, unit_seed(seed, path, k, 0), device)
    w = shape[axis] // n_stages
    local = list(shape)
    local[axis] = w
    out = draw(tuple(local), init, unit_seed(seed, path, k, s), device)
    pad = (s + 1) * w - real
    if pad > 0:
        out.narrow(axis, w - min(pad, w), min(pad, w)).zero_()
    return out


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for name in head:
        tree = tree.setdefault(name, {})
    tree[last] = value


def trial_tree(sizes: Sizes, n_stages: int, n_trials: int, seed: int,
               device) -> dict:
    """The K trials' weights in the program's one-device layout: layer
    leaves (K, padded layers, ...), ``embed/tok`` (K, Vp, D), ``head`` (K,
    D, Vp), the position table (K, P, D), norms (K, D); filled unit by
    unit."""
    ls = stage_layers(sizes, n_stages)
    tree: dict = {}
    with torch.no_grad():
        for path, shape, _ in layer_leaves(sizes):
            leaf = torch.empty((n_trials, ls * n_stages) + shape,
                               device=device)
            for k in range(n_trials):
                for s in range(n_stages):
                    leaf[k, s * ls:(s + 1) * ls].copy_(layer_unit(
                        sizes, n_stages, seed, path, k, s, device))
            _set(tree, "layers/" + path, leaf)
        for path, shape, axis, _, _ in global_leaves(sizes, n_stages):
            leaf = torch.empty((n_trials,) + shape, device=device)
            for k in range(n_trials):
                if axis is None:
                    leaf[k].copy_(global_unit(sizes, n_stages, seed, path,
                                              k, 0, device))
                    continue
                w = shape[axis] // n_stages
                for s in range(n_stages):
                    leaf[k].narrow(axis, s * w, w).copy_(global_unit(
                        sizes, n_stages, seed, path, k, s, device))
            _set(tree, path, leaf)
    return tree
