"""How far the pipelined train step's result can drift from sequential
runs on rounding alone, per parameter leaf, on one card.

Run from the repo root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/train_step_sensitivity.py --arch falcon-mamba-7b \\
        --n-layers 2 --seq 256 --lr 3e-3 1e-3

It builds the setup of ``chip_smoke.py``'s training exactness phases (K = 2
trials, 2 stages, 2 microbatches, 2 AdamW steps with clipping at 1.0, fp32,
full width, random weights from a seed; per-trial ``--lr``, weight decay 0
and 0.01), and prints JSON lines:

* the per-leaf gradient of the first step, pipelined (the kernels on, as
  the launcher sets them) against each trial's unpipelined loss through
  the plain versions: the largest difference relative to the leaf's
  largest entry (no optimizer in the way);
* for the pipelined step with the kernels on and with them off (the plain
  versions in the same tick schedule): each step's per-trial gradient
  norm, and each trial's parameter change after the 2 steps against the
  sequential run's — the largest difference relative to the largest
  change, and the leaves where it is largest.

A step whose gradient norm jumps makes the second update's direction
sensitive to the rounding of the first, and Adam's normalisation turns a
small gradient difference on a near-zero entry into a change of up to the
learning rate: the change comparison then measures the conditioning of
the run, not the pipeline.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core.partitioner import plan_stages  # noqa: E402
from repro_torch.data.pipeline import TrainBatches  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    ModelOptions, kernel_options)
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_items, tree_map  # noqa: E402


def say(**rec) -> None:
    print(json.dumps(rec), flush=True)  # noqa: T201


def first_grads(cfg, opts, eng, host0, batch, dev):
    """Per-leaf max |pipelined - sequential| / max |sequential| of the
    first step's gradient, per trial."""
    params = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(),
                      host0)
    pl.pipeline_train_loss(cfg, opts, eng, params, batch)[0].sum().backward()
    pipe = tree_map(lambda t: t.grad.to("cpu"), params)
    del params
    out = []
    for k in range(eng.n_trials):
        p = tree_map(lambda t: t[k].to(dev, copy=True).requires_grad_(),
                     host0)
        n_micro = batch["tokens"].shape[1]
        loss = sum(lm.loss_fn(cfg, ModelOptions(), p, {
            "tokens": torch.from_numpy(batch["tokens"][k, m]).to(dev),
            "labels": torch.from_numpy(batch["labels"][k, m]).to(dev)})
            for m in range(n_micro)) / n_micro
        loss.backward()
        rows = []
        for (path, a), (_, b) in zip(tree_items(pipe), tree_items(
                tree_map(lambda t: t.grad.to("cpu"), p))):
            rows.append((float((a[k] - b).abs().max())
                         / max(float(b.abs().max()), 1e-30), path))
        out.append(sorted(rows, reverse=True)[:4])
        del p, loss
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--lr", type=float, nargs=2, default=[3e-3, 1e-3])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)  # noqa: T201
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.n_layers)
    eng = pl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                          n_stages=2)
    hp = {"lr": list(args.lr), "wd": [0.0, 0.01]}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    host0 = tree_map(lambda t: t.to("cpu"), pl.init_trial_params(
        cfg, eng, plan_stages(cfg, 2), gen, device=dev))
    data = TrainBatches(cfg, eng, args.seq, seed=0)
    *batches, held_out = [data.batch_for_step(i) for i in range(3)]
    data.close()
    say(card=cs.card_line(), arch=cfg.name, layers=cfg.n_layers,
        seq=args.seq, seed=args.seed, hp=hp)
    say(first_step_grad_rel_err_top=first_grads(
        cfg, kernel_options(cfg, remat=True), eng, host0, batches[0], dev))
    refs = [cs.sequential_reference(cfg, host0, batches, held_out, k, dev,
                                    hp)[2] for k in range(2)]
    for name, opts in (("kernels", kernel_options(cfg, remat=True)),
                       ("plain", ModelOptions(remat=True))):
        params = tree_map(lambda t: t.to(dev, copy=True), host0)
        opt = AdamW(grad_clip=1.0)
        state = opt.init(params)
        step = pl.make_train_step(cfg, opts, eng, opt)
        norms = []
        for i, b in enumerate(batches):
            params, state, met = step(params, state, b, hp, i)
            norms.append(met["grad_norm"].tolist())
        pipe = tree_map(lambda t: t.to("cpu"), params)
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        trials = []
        for k, ref in enumerate(refs):
            items = list(zip(tree_items(host0), tree_items(pipe),
                             tree_items(ref)))
            den = max(float((r - p0[k]).abs().max())
                      for (_, p0), _, (_, r) in items)
            rows = sorted(((float((a[k] - r).abs().max()) / den, path)
                           for (path, _), (_, a), (_, r) in items),
                          reverse=True)
            trials.append(dict(max_change=den, change_rel_err=rows[0][0],
                               top=rows[:4]))
        say(pipeline=name, grad_norms_by_step=norms, trials=trials)
    return 0


if __name__ == "__main__":
    sys.exit(main())
