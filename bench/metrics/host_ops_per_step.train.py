"""``host_ops_per_step.train``: the top-level ``aten::`` calls the host
issues in one profiled train step (``bench/yardstick/trace.py``), a
count of the dispatch work in ``core/pipeline.py``'s tick loop and the
models under it. Moves ``train_tokens_per_s``."""


def read(run):
    trace = run["trace"]
    return None if trace is None else float(trace["host_ops"])
