"""The comparison that decides ``correct`` for a training cell.

Set-up runs the program's first steps; the reference follows them, one
trial at a time. Three numbers are compared, each the worst over the
trials:

* ``loss_gap``: the largest |program − reference| / |reference| of a
  trial's loss over the followed steps;
* ``grad_gap``: by the worst leaf, the gap between the norms of the
  first gradient as the optimizer takes it (the program's worked out from
  its AdamW state after one step: m / (1 − β1)), over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same for the norm of each leaf's change over the
  followed steps, leaving out the leaves whose reference gradient is nought
  to rounding (under a thousandth of the median leaf's).

Readings are {"loss": [step][trial], "grad": {leaf: [trial]}, "change":
{leaf: [trial]}} for the program and, per trial, {"loss": [step], "grad":
{leaf: norm}, "change": {leaf: norm}} for the reference.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap")
NOUGHT = 1e-3  # of the median leaf's gradient norm


def _worst(prog: dict, ref: dict, keep) -> tuple:
    """(gap, leaf) of the worst leaf among ``keep``."""
    med = statistics.median(ref[n] for n in keep)
    worst = (0.0, None)
    for n in keep:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if not math.isfinite(gap):
            return math.inf, n
        worst = max(worst, (gap, n), key=lambda x: x[0])
    return worst


def gaps(prog: dict, refs: list) -> dict:
    """{name: (gap, where)} over every trial (``refs[k]`` is trial k's)."""
    out = {n: (0.0, None) for n in NAMES}

    def note(name, gap, where):
        cur = out[name][0]
        if not math.isnan(cur) and (math.isnan(gap) or gap > cur):
            out[name] = (gap, where)  # a NaN gap is the worst

    for k, ref in enumerate(refs):
        for step, r in enumerate(ref["loss"]):
            note("loss_gap", abs(prog["loss"][step][k] - r) / abs(r),
                 f"trial {k} step {step}")
        pg = {n: v[k] for n, v in prog["grad"].items()}
        gap, leaf = _worst(pg, ref["grad"], list(ref["grad"]))
        note("grad_gap", gap, f"trial {k} {leaf}")
        med = statistics.median(ref["grad"].values())
        keep = [n for n in ref["change"] if ref["grad"][n] >= NOUGHT * med]
        pc = {n: v[k] for n, v in prog["change"].items()}
        gap, leaf = _worst(pc, ref["change"], keep)
        note("change_gap", gap, f"trial {k} {leaf}")
    return out


def left_out(refs: list) -> list:
    """The leaves left out of ``change_gap`` (per trial)."""
    out = []
    for ref in refs:
        med = statistics.median(ref["grad"].values())
        out.append(sorted(n for n, g in ref["grad"].items()
                          if g < NOUGHT * med))
    return out


def decide(found: dict, limits: dict) -> bool:
    return all(found[n][0] <= limits[n] for n in NAMES)
