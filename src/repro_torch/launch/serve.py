"""Serving launcher of the PyTorch port: a Poisson request stream through the
paged continuous-batching engine (split admission), on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --paged --paged-kernel --n-data 1 --n-model 2 --slots 2 \\
        --microbatch 2 --n-requests 8 --rate 1.0 --prompt-len 256 \\
        --gen-len 32 --dtype bfloat16

    # CPU smoke run (plain PyTorch attention, reduced config)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --smoke --paged --paged-kernel --n-model 2 --slots 2 --device cpu

Weights are random, drawn from ``--seed``. ``--slots`` and ``--n-blocks``
are explicit (capacity planning is not ported yet); ``--n-blocks 0`` backs
every cell at ``max_seq``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import pipeline as pl
from repro_torch.core.partitioner import plan_stages
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.layers import ModelOptions
from repro_torch.obs import report
from repro_torch.serve import POLICIES, ServeEngine, blocks_for, poisson_trace

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_args():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced() config (few layers, narrow)")
    ap.add_argument("--n-data", type=int, default=1,
                    help="logical data shards (pool partitions per trial)")
    ap.add_argument("--n-model", type=int, default=1,
                    help="pipeline stages S (run in one process)")
    ap.add_argument("--slots", type=int, default=2,
                    help="microbatch slots M per trial")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="requests per (slot × data shard)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length of the synthetic trace")
    ap.add_argument("--gen-len", type=int, default=8,
                    help="max generation budget of the synthetic trace")
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrivals per engine tick")
    ap.add_argument("--prefill-chunks", type=int, default=2)
    ap.add_argument("--policy", choices=POLICIES, default="fcfs")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache (required: dense strips are not "
                    "ported yet)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="attend straight from the block pool through the "
                    "CUDA paged-attention kernel (its plain PyTorch version "
                    "on the CPU) instead of gathering each row's view")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="per-trial block-pool size (0 = back every cell at "
                    "max_seq)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="parameter, activation and KV-cache dtype")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_args().parse_args(argv)
    if not args.paged:
        raise SystemExit("dense (non-paged) serving is not ported yet; "
                         "add --paged")
    if args.slots < 1:
        raise SystemExit("--slots must be >= 1 (capacity planning is not "
                         "ported yet)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dtype = DTYPES[args.dtype]
    max_seq = args.prompt_len + args.gen_len
    n_blocks = args.n_blocks or (args.microbatch * args.slots * args.n_data
                                 * blocks_for(max_seq, args.block_size))
    eng = pl.EngineConfig(
        n_trials=1, n_microbatches=args.slots, microbatch=args.microbatch,
        n_stages=args.n_model, data_size=args.n_data, max_seq=max_seq,
        cache_dtype=dtype, prefill_chunks=args.prefill_chunks, paged=True,
        block_size=args.block_size, n_blocks=n_blocks)
    opts = ModelOptions(compute_dtype=dtype,
                        use_paged_kernel=args.paged_kernel)
    requests = poisson_trace(
        args.n_requests, args.rate, cfg.vocab_size,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        gen_lens=(max(args.gen_len // 2, 1), args.gen_len), seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, dtype=dtype, device=device)
    engine = ServeEngine(cfg, eng, params, opts, policy=args.policy,
                         device=device)
    pa.launches = 0
    completions = engine.run(requests)
    s = engine.stats.summary()
    mode = "continuous/paged" + ("+kernel" if args.paged_kernel else "")
    lines = report.render_completions(completions)
    lines += report.render_summary(mode, len(completions), s,
                                   policy=args.policy)
    lines += report.render_paged(s, eng.n_blocks, eng.block_size, 0, 1.0)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    lines.append(f"device {name}: {pa.launches} paged-attention kernel "
                 f"launches")
    for line in lines:
        print(line)  # noqa: T201


if __name__ == "__main__":
    main()
