"""``k1_roofline.train``: K1's share of its roofline over one profiled
train step, in %: the least time the card could take for every K1
launch of the step (from each launch's shapes:
``bench/yardstick/costs.py``, in the precision of the launch's inputs)
over the device time of the K1 kernels the trace recorded. Nothing when
the step launched no K1, or when the trace's K1 kernels do not match the
launches one for one. Moves ``train_tokens_per_s``."""
from bench.yardstick.costs import bound_s


def read(run):
    trace = run["trace"]
    if trace is None or not trace["k1_work"] or not trace["k1_device_s"]:
        return None
    if trace["k1_records"] != len(trace["k1_work"]):
        return None
    least = sum(bound_s(b, ops, prec)[0] for b, ops, prec in trace["k1_work"])
    return 100.0 * least / trace["k1_device_s"]
