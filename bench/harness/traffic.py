"""The general generator of training traffic: a traffic file
(``bench/traffic/<name>.json``) holds a job's parameters, and
:func:`batch` draws each step's token batch from them and the seed.

A job's parameters: ``trials`` (K), ``stages`` (S), ``microbatches`` (M),
``rows`` a microbatch and ``seq`` tokens a row; ``objective``
(``causal``: next-token labels over random token ids; ``mlm``: the ids
with a ``mask_rate`` share of them replaced by ``mask_id``, labelled with
the originals); the per-trial ``lr`` and ``weight_decay`` of the AdamW
trials, ``grad_clip``, ``betas``, ``eps``; ``remat`` and ``kernels``
(the family's attention kernel on); ``layout`` (null: one device, or
``{"data", "model"}``: the stages on their own cards); ``setup_steps``,
the steps set-up runs before the window and the comparison follows.
Token ids are uniform over the vocabulary, so every row differs.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from bench.harness.weights import unit_seed

OBJECTIVES = ("causal", "mlm")


def load_traffic(path) -> dict:
    t = json.loads(Path(path).read_text())
    if t["objective"] not in OBJECTIVES:
        raise ValueError(f"unknown objective {t['objective']!r}")
    for key in ("lr", "weight_decay"):
        if len(t[key]) != t["trials"]:
            raise ValueError(f"{key} needs one value a trial")
    return t


def tokens_per_step(traffic: dict) -> int:
    """Trained tokens of all K trials in one step."""
    return (traffic["trials"] * traffic["microbatches"] * traffic["rows"]
            * traffic["seq"])


def batch(traffic: dict, vocab_size: int, seed: int, step: int,
          device) -> dict:
    """Step ``step``'s batch: ``tokens`` and ``labels`` (K, M, rows, seq)
    int64 on ``device``, drawn from a generator seeded by (seed, step)."""
    shape = (traffic["trials"], traffic["microbatches"], traffic["rows"],
             traffic["seq"])
    gen = torch.Generator(device=device).manual_seed(
        unit_seed(seed, "batch", step, 0))
    if traffic["objective"] == "causal":
        ids = torch.randint(0, vocab_size, shape[:-1] + (shape[-1] + 1,),
                            generator=gen, device=device)
        return {"tokens": ids[..., :-1].contiguous(),
                "labels": ids[..., 1:].contiguous()}
    ids = torch.randint(0, vocab_size, shape, generator=gen, device=device)
    masked = torch.rand(shape, generator=gen, device=device) \
        < traffic["mask_rate"]
    return {"tokens": torch.where(masked, traffic["mask_id"], ids),
            "labels": ids}


def half_batch(b: dict, keep_rows: bool = False) -> dict:
    """A fault for the comparison's tests: the first half of every
    microbatch's rows (of its tokens, where it has one row or
    ``keep_rows``), as if the rest were left out and the mean taken over
    what is left."""
    rows = b["tokens"].shape[2]
    if rows > 1 and not keep_rows:
        return {n: v[:, :, :rows // 2].contiguous() for n, v in b.items()}
    seq = b["tokens"].shape[3]
    return {n: v[..., :seq // 2].contiguous() for n, v in b.items()}
