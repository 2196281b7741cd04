"""``device_idle.train``: the share of a train step's wall in which a card
runs no kernel and no copy, in %, averaged over the cell's cards: 1 − a
card's busy time in one profiled step (the union of its work intervals,
from the trace) over the mean wall of the window's steps, which ran
without the profiler (the profiler's own host cost would count as idle).
Moves ``train_tokens_per_s``."""


def read(run):
    trace = run["trace"]
    if trace is None or not trace["busy_s"] or not run["window_steps"]:
        return None
    busy = sum(trace["busy_s"].values()) / len(trace["busy_s"])
    step = run["window_s"] / run["window_steps"]
    return 100.0 * (1.0 - busy / step)
