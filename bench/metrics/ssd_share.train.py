"""``ssd_share.train``: the share of a card's busy time in one profiled
train step taken by work launched inside the program's Mamba2 mixer
ranges (``repro.train.mixer:<pass> kind=mamba2``: ``models/layers.py``
``mamba2_mix``, its projections, conv, chunked SSD and gated norm), in %,
averaged over the cell's cards; the forward and the recompute passes
(``bench/drivers/train_hybrid_moe.py`` keeps each mixer range's kind in
its label). The backward proper runs on autograd's thread outside every
program range, so it is not counted. Nothing without such ranges or a
card. Moves ``train_tokens_per_s``."""

MIXER, KIND = "repro.train.mixer:", " kind=mamba2"


def read(run):
    trace = run["trace"]
    prog = None if trace is None else trace.get("program")
    if prog is None or not trace["busy_s"]:
        return None
    labels = [lab for lab in prog["device_s"]
              if lab.startswith(MIXER) and lab.endswith(KIND)]
    if not labels:
        return None
    busy = trace["busy_s"]
    return 100.0 * sum(sum(prog["device_s"][lab].get(c, 0.0)
                           for lab in labels) / b
                       for c, b in busy.items()) / len(busy)
