"""``moe_share.train``: the share of a card's busy time in one profiled
train step taken by work launched inside the program's MoE ranges
(``repro.train.moe:<pass>``: ``models/layers.py`` ``moe_apply`` — route,
dispatch into the capacity buckets, the held experts, combine, the shared
expert), in %, averaged over the cell's cards; the forward and the
recompute passes. The backward proper runs on autograd's thread outside
every program range, so it is not counted. Nothing without such ranges or
a card. Moves ``train_tokens_per_s``."""

MOE = "repro.train.moe:"


def read(run):
    trace = run["trace"]
    prog = None if trace is None else trace.get("program")
    if prog is None or not trace["busy_s"]:
        return None
    labels = [lab for lab in prog["device_s"] if lab.startswith(MOE)]
    if not labels:
        return None
    busy = trace["busy_s"]
    return 100.0 * sum(sum(prog["device_s"][lab].get(c, 0.0)
                           for lab in labels) / b
                       for c, b in busy.items()) / len(busy)
