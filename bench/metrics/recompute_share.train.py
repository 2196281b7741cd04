"""``recompute_share.train``: the share of a card's busy time in one
profiled train step taken by work launched inside the program's
recompute ranges (``repro.train.unit:recompute``,
``repro.train.layer:recompute``: remat running a checkpointed tick unit
or layer again inside ``backward()``), in %, averaged over the cell's
cards (``bench/yardstick/spans.py``). Nothing without the program's
ranges or a card. Moves ``train_tokens_per_s``."""


def read(run):
    trace = run["trace"]
    prog = None if trace is None else trace.get("program")
    if prog is None or not prog["ranges"] or not trace["busy_s"]:
        return None
    rec = prog["device_s"].get("recompute", {})
    busy = trace["busy_s"]
    return 100.0 * sum(rec.get(c, 0.0) / b for c, b in busy.items()) \
        / len(busy)
