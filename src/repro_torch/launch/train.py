"""Training launcher of the PyTorch port: Hydra model-selection training —
K trials stacked and pipelined over S stages in one program — on the card
by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
        --trials 2 --steps 3 --n-model 2 --seq-len 2048 --n-layers 4

    # CPU smoke run (plain PyTorch attention, reduced config)
    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
        --smoke --trials 2 --steps 4 --n-data 2 --n-model 2 \\
        --n-microbatches 2 --seq-len 16 --device cpu

Attention runs through the flash kernel (``use_flash_kernel=True``, the
reference's TPU-target setting): the CUDA kernel on a card, its plain
version on the CPU. ``--n-model`` stages and ``--n-data`` shards run as
structure inside one process. Weights are random, drawn from the run's
seed. ``--n-layers`` cuts the depth (full-width chatglm3-6b at full depth
needs 100 GB of fp32 state per trial; one H100 has 80 GB).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import get_config
from repro_torch.core import pipeline as pl
from repro_torch.core.hydra import HydraConfig, run_model_selection
from repro_torch.core.trials import SuccessiveHalving, grid_search
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.layers import ModelOptions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                    "config's)")
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--n-microbatches", type=int, default=4)
    ap.add_argument("--n-data", type=int, default=1)
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true",
                    help="(not ported yet: one device holds every shard)")
    ap.add_argument("--asha", action="store_true",
                    help="successive halving instead of full grid")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernels)")
    args = ap.parse_args(argv)
    if args.fsdp:
        raise SystemExit("--fsdp is not ported yet")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    opts = ModelOptions(remat=True, use_flash_kernel=True)
    eng = pl.EngineConfig(
        n_trials=args.trials, n_microbatches=args.n_microbatches,
        microbatch=args.microbatch, n_stages=args.n_model,
        data_size=args.n_data)
    hc = HydraConfig(seq_len=args.seq_len, steps=args.steps,
                     ckpt_dir=args.ckpt_dir)
    lrs = [3e-3 * (0.5 ** i) for i in range(args.trials)]
    trials = grid_search(cfg.name, lrs)[:args.trials]

    t0 = time.time()
    strategy = SuccessiveHalving(base_steps=max(args.steps // 4, 1)) \
        if args.asha else None
    out = run_model_selection(cfg, opts, hc, trials, eng, strategy=strategy,
                              device=device)
    dt = time.time() - t0
    print(json.dumps({
        "best_trial": out["best"].spec.tag,
        "best_val_loss": out["best"].val_loss,
        "results": [{"tag": r.spec.tag, "lr": r.spec.lr,
                     "train_loss": r.train_loss, "val_loss": r.val_loss}
                    for r in out["all"]],
        "device": str(device),
        "wall_s": round(dt, 1),
    }, indent=1))  # noqa: T201


if __name__ == "__main__":
    main()
