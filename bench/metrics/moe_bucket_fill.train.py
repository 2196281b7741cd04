"""``moe_bucket_fill.train``: the program's ``moe_local_picks`` (picks
routed to the experts this card holds) over its ``moe_bucket_rows``
(held experts × bucket capacity), summed over the layers and (stage,
slot) units of one traced train step's forward pass, in %: the share of
the capacity buckets' rows the expert products compute for a token
(``models/layers.py`` ``moe_apply``; the rest are empty rows). Nothing
without those counters. Moves ``train_tokens_per_s``."""


def read(run):
    trace = run["trace"]
    prog = None if trace is None else trace.get("program")
    if prog is None:
        return None
    counters = prog["counters"]
    rows = sum(counters.get("moe_bucket_rows", {}).values())
    if not rows:
        return None
    return 100.0 * sum(counters.get("moe_local_picks", {}).values()) / rows
