"""``optimizer_ms.train``: the device time of the optimizer update in one
profiled train step, in ms: per card, the union of the work launched
inside the program's ``repro.train.optimizer`` range
(``optim/adamw.py`` ``AdamW.update``; ``bench/yardstick/spans.py``),
summed over the cell's cards. Nothing without that range or a card.
Moves ``train_tokens_per_s``."""

OPTIMIZER = "repro.train.optimizer"


def read(run):
    trace = run["trace"]
    prog = None if trace is None else trace.get("program")
    if prog is None or OPTIMIZER not in prog["ranges"] \
            or not trace["busy_s"]:
        return None
    return 1e3 * sum(prog["device_s"].get(OPTIMIZER, {}).values())
