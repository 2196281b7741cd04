"""``host_syncs_per_step.train``: the synchronising CUDA calls of one
profiled train step, the program's ``host_syncs`` counter over every
range (``torch.cuda.set_sync_debug_mode("warn")`` while its tracer is
on): each stalls the host until the card drains. Nothing without the
program's ranges or a card (the CPU synchronises nothing). Moves
``train_tokens_per_s``."""


def read(run):
    trace = run["trace"]
    prog = None if trace is None else trace.get("program")
    if prog is None or not prog["ranges"] or not trace["busy_s"]:
        return None
    return float(sum(prog["counters"].get("host_syncs", {}).values()))
