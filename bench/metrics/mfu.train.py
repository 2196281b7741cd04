"""``mfu.train``: the whole train step's model FLOPs (no recompute
counted; ``bench/yardstick/flops.py``) over the window's steps, as a share
of the peak of the configuration's precision on every card the cell
uses, in %. Reads the host clock's window; moves ``train_tokens_per_s``."""
from bench.yardstick.peaks import PEAK_FLOPS


def read(run):
    if not run["window_steps"]:
        return None
    done = run["model_flops_per_step"] * run["window_steps"]
    peak = PEAK_FLOPS[run["sizes"].precision] * run["chips"]
    return 100.0 * done / (run["window_s"] * peak)
