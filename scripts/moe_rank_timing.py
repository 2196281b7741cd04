"""Time the MoE bucket rank (``models/layers.py`` ``moe_ranks``) on one card
against the two one-hot cumulative counts that compute the same ranks.

Run from the repo root on a machine with an NVIDIA GPU:

    python3 scripts/moe_rank_timing.py [--out FILE.json]

Variants, each a function of the flat expert ids (G, t·k):

* ``sort``: ``moe_ranks``, a stable sort of each row, each expert's start
  by ``searchsorted`` and one scatter;
* ``onehot_outer_int64``: ``cumsum`` along dim 1 of a (G, t·k, E) int32
  one-hot, promoted to int64, then a gather (the port's rank before
  ``moe_ranks``; on the card an outer-dimension scan);
* ``onehot_inner_int32``: ``cumsum(dtype=int32)`` along the last dim of a
  (G, E, t·k) one-hot, then a gather.

Shapes: the granite-4.0-h-small-l10 cell's (one shard, t 4096, top-10 of
72 experts), llama4-scout's router (t 4096, top-1 of 16), granite-moe's
over two shards (t 2048 a shard, top-8 of 40) and a decode call's (t 16,
top-10 of 72). Expert ids come from ``moe_route`` on random tokens. Every
variant's ranks are held bit-equal to the sort's first. Each is timed in
turns (sort, outer, inner, inner, outer, sort) as the sum of device time
over ``CALLS`` back-to-back calls under ``torch.profiler`` (kernel names
kept), and by CUDA events around the same calls (which count the host's
enqueue where it is slower than the card). Then one whole ``moe_route``
call at the granite cell's shape (d 4096, fp32) with each rank. Prints one
JSON line per measurement and a last line with all of them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models import layers as L  # noqa: E402

CALLS = 50
# (name, shards, tokens a shard, top-k, experts)
SHAPES = [("granite-4.0-h-small-l10", 1, 4096, 10, 72),
          ("llama4-scout-17b-a16e", 1, 4096, 1, 16),
          ("granite-moe-3b-a800m.g2", 2, 2048, 8, 40),
          ("decode-t16", 1, 16, 10, 72)]


def onehot_outer_int64(flat_e, n_experts):
    onehot = (flat_e[..., None] == torch.arange(n_experts,
                                                device=flat_e.device)
              ).to(torch.int32)  # (G, t·k, E)
    return torch.cumsum(onehot, dim=1).gather(2, flat_e[..., None])[..., 0] - 1


def onehot_inner_int32(flat_e, n_experts):
    onehot = (flat_e[:, None, :] == torch.arange(
        n_experts, device=flat_e.device)[None, :, None]).to(torch.int32)
    cum = torch.cumsum(onehot, dim=2, dtype=torch.int32)  # (G, E, t·k)
    return cum.gather(1, flat_e[:, None, :])[:, 0].long() - 1


VARIANTS = {"sort": L.moe_ranks, "onehot_outer_int64": onehot_outer_int64,
            "onehot_inner_int32": onehot_inner_int32}
TURNS = ("sort", "onehot_outer_int64", "onehot_inner_int32",
         "onehot_inner_int32", "onehot_outer_int64", "sort")


def device_time(fn) -> dict:
    """Device seconds a call (profiler, summed over kernels) and the CUDA
    events' seconds a call, over ``CALLS`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    events_s = start.elapsed_time(end) / 1e3 / CALLS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            by_kernel[ev.key[:70]] += us / 1e6 / CALLS
    return {"device_s": sum(by_kernel.values()), "events_s": events_s,
            "kernels": dict(sorted(by_kernel.items(), key=lambda x: -x[1]))}


def routed(g_n, t, k, e, d, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(g_n, t, d, device=dev, generator=gen)
    router = torch.randn(d, e, device=dev, generator=gen) / d ** 0.5
    return x, router


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[:1]
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for name, g_n, t, k, e in SHAPES:
        x, router = routed(g_n, t, k, e, 64, dev)
        _, _, idx, rank, cap = L.moe_route(
            router, x, n_experts=e, top_k=k, capacity_factor=2.0,
            n_shards=g_n)
        flat_e = idx.reshape(g_n, t * k)
        equal = {v: bool(torch.equal(fn(flat_e, e), rank))
                 for v, fn in VARIANTS.items()}
        for turn, v in enumerate(TURNS):
            got = device_time(lambda: VARIANTS[v](flat_e, e))
            emit({"shape": name, "shards": g_n, "tokens": t, "top_k": k,
                  "experts": e, "capacity": cap, "variant": v,
                  "turn": turn, "equal": equal[v], **got})
    # one whole moe_route at the granite cell's shape, with each rank
    d = 4096
    x, router = routed(1, 4096, 10, 72, d, dev)
    x = x.reshape(1, 4096, d)
    kw = dict(n_experts=72, top_k=10, capacity_factor=2.0)
    for turn, v in enumerate(TURNS):
        L.moe_ranks = VARIANTS[v]
        try:
            got = device_time(lambda: L.moe_route(router, x, **kw))
        finally:
            L.moe_ranks = VARIANTS["sort"]
        emit({"shape": "moe_route granite-4.0-h-small-l10 d 4096",
              "variant": v, "turn": turn, **got})
    summary = {"device": torch.cuda.get_device_name(0), "card": card,
               "torch": torch.__version__, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary) + "\n")
    print(json.dumps({"device": summary["device"], "card": card,
                      "torch": summary["torch"]}))
    return 0 if all(r.get("equal", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
