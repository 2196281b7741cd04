"""Serving launcher of the PyTorch port: a Poisson request stream through the
continuous-batching engine over dense per-slot cache strips (the default)
or the paged KV pool, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --paged --paged-kernel --n-data 1 --n-model 2 --slots 2 \\
        --microbatch 2 --n-requests 8 --rate 1.0 --prompt-len 256 \\
        --gen-len 32 --dtype bfloat16

    # the paged serve features: radix prefix cache, fused mixed-tick
    # admission, overcommit retraction over a host tier
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --paged --paged-kernel --prefix-cache --fused-admission \\
        --overcommit 1.5 --host-blocks 64 --n-model 2 --slots 2 \\
        --microbatch 2 --n-requests 8 --prompt-len 256 --gen-len 32 \\
        --dtype bfloat16

    # gang speculation: a drafter row per target row, gamma 3
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --paged --paged-kernel --spec-draft chatglm3-6b --spec-gamma 3 \\
        --n-model 2 --slots 2 --microbatch 2 --n-requests 8 \\
        --prompt-len 256 --gen-len 32 --dtype bfloat16

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --n-model 2 --slots 2 --microbatch 2 --n-requests 8 --rate 1.0 \\
        --prompt-len 1024 --gen-len 32 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --n-model 2 --slots 2 --microbatch 2 --n-requests 8 --rate 1.0 \\
        --prompt-len 1024 --gen-len 32 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --paged --paged-kernel --n-model 2 \\
        --slots 2 --microbatch 2 --n-requests 8 --prompt-len 1024 \\
        --gen-len 32 --dtype bfloat16

    # the lockstep static baseline (uniform prompts; the prefill runs the
    # flash-attention kernel), sliding-window serving, a capacity-planned
    # grid, a recorded trace, and the trace / event / metric exports
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --static --n-model 2 --slots 2 --microbatch 2 --n-requests 8 \\
        --prompt-len 512 --gen-len 32 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --paged --paged-kernel --window 256 --slots 0 --n-model 2 \\
        --microbatch 2 --prompt-len 1024 --gen-len 32 --dtype bfloat16 \\
        --trace-out run.json --events-out events.jsonl \\
        --metrics-out metrics.jsonl

    # on a device layout: data 2 x model 2, each stage and data shard on
    # its own device (a device may repeat: cuda:0 four times on one card)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --paged --paged-kernel --n-data 2 --n-model 2 --slots 2 \\
        --microbatch 1 --n-requests 8 --prompt-len 256 --gen-len 32 \\
        --dtype bfloat16 --devices cuda:0,cuda:1,cuda:2,cuda:3

    # CPU smoke runs (plain PyTorch versions of the kernels, reduced config)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --smoke --paged --paged-kernel --n-model 2 --slots 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --smoke --paged --paged-kernel --prefix-cache --fused-admission \\
        --overcommit 1.5 --host-blocks 8 --n-model 2 --slots 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --smoke --n-model 2 --slots 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --n-model 2 --slots 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --smoke --static --n-model 2 --slots 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --smoke --window 8 --slots 0 --max-slots 4 --deadline-slack 2.0 \\
        --policy deadline --n-model 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
        --smoke --paged --paged-kernel --n-data 2 --n-model 2 \\
        --devices cpu,cpu,cpu,cpu

Weights are random, drawn from ``--seed``; with ``--arches K`` the gang
co-serves K variants (trial rows of independent weights) and the trace
routes each request to one of them (``--arch-weights``). ``--spec-draft``
adds a drafter row per target row, with weights of its own.
``--slots 0`` plans the grid with ``core.scheduler.plan_serve_capacity``
on the card's memory (``--max-slots``, ``--expected-seq``,
``--expected-hit-rate``) and prints the plan; with explicit ``--slots``,
``--n-blocks 0`` backs every cell at ``max_seq``. The launcher turns the
kernels on by family, as the train launcher does: for the attention and
moe families and the hybrid family's shared block (zamba2-7b, dense only;
head dim 112) every full-sequence prefill (``--static``) goes through
``kernels.ops.flash_attention``, for the ssm family (falcon-mamba-7b,
dense only) every prefill / append scan through ``kernels.ops.mamba_scan``;
each runs its CUDA kernel on the card and its plain PyTorch version on the
CPU. (The hybrid backbone's Mamba2 mixer is plain PyTorch, as the
reference's is plain jnp.) The moe family (granite-moe-3b-a800m,
llama4-scout-17b-a16e) routes at the reference launcher's capacity
factor, 1.25, each data shard's rows on their own. The dense configs
(yi-34b, deepseek-67b, starcoder2-15b) and the encoder (bert-large, a
``--prompt-len + --gen-len`` position table) serve like chatglm3-6b. The
frontend archs (musicgen-medium, qwen2-vl-72b) are refused here, by the
continuous engine and by ``--static`` alike, as the reference refuses
them: they serve through ``core.pipeline.make_serve_step``'s prefill (with
their frontend embeddings and M-RoPE positions) and decode.

Without ``--devices`` every stage and data shard runs as structure on the
one ``--device``. ``--devices`` lists the devices of a (data, model)
layout in C order (a device may repeat): stage ``s`` of data shard ``d``
runs on entry ``d · n_model + s``, holding its stage's weights and its
shard's cache (``core/pipeline.py`` with ``layout=``). The tokens are
those of the one-device run.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import pipeline as pl
from repro_torch.core import scheduler as sched
from repro_torch.core.partitioner import plan_stages
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.mesh import make_device_layout, resolve_device
from repro_torch.models.layers import kernel_options
from repro_torch.obs import (Tracer, report, write_events, write_metrics,
                             write_perfetto)
from repro_torch.serve import (POLICIES, Request, ServeEngine, blocks_for,
                               load_trace, poisson_trace, static_serve)
from repro_torch.tree import tree_items

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
    ap.add_argument("--arches", type=int, default=1,
                    help="model variants K co-served by one gang (trial "
                    "rows); requests are routed by their arch id")
    ap.add_argument("--arch-weights", default="",
                    help="comma arrival weights per arch for the synthetic "
                    "trace (default uniform)")
    ap.add_argument("--slots", type=int, default=2,
                    help="microbatch slots M per trial (0 = capacity-planned,"
                    " capped by --max-slots)")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=1,
                    help="requests per (slot × data shard)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length of the synthetic trace")
    ap.add_argument("--gen-len", type=int, default=8,
                    help="max generation budget of the synthetic trace")
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrivals per engine tick")
    ap.add_argument("--trace", default="",
                    help="JSONL request stream to replay instead of the "
                    "synthetic Poisson trace")
    ap.add_argument("--prefill-chunks", type=int, default=2)
    ap.add_argument("--policy", choices=POLICIES, default="fcfs",
                    help="per-arch admission order: fcfs | sjf (shortest "
                    "prompt first) | deadline (earliest Request.deadline)")
    ap.add_argument("--deadline-slack", type=float, default=0.0,
                    help=">0: stamp synthetic requests with arrival + slack "
                    "* total_len deadlines (for --policy deadline)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding attention window in tokens (0 = full "
                    "attention; attention-family archs only)")
    ap.add_argument("--static", action="store_true",
                    help="run the lockstep static-batch baseline instead "
                    "(uniform prompt lengths per group of slots)")
    cache = ap.add_mutually_exclusive_group()
    cache.add_argument("--paged", action="store_true",
                       help="paged KV-cache: per-trial block pools + "
                       "per-request block tables (attention family only)")
    cache.add_argument("--dense", action="store_true",
                       help="dense per-slot cache strips (the default; the "
                       "ssm family's recurrent state, scanned by the CUDA "
                       "selective-scan kernel on the card and its plain "
                       "PyTorch version on the CPU)")
    adm = ap.add_mutually_exclusive_group()
    adm.add_argument("--fused-admission", action="store_true",
                     help="fold each round's prefill waves + decode step "
                     "into ONE mixed-tick pipeline call: prefilling rows "
                     "ride at their chunk width, decoding rows at qlen 1, "
                     "idle rows at 0 (attention-family archs; greedy tokens "
                     "stay bit-identical to the split schedule)")
    adm.add_argument("--split-admission", action="store_true",
                     help="one append call per chunk-length group plus a "
                     "separate decode call per round (the default)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="attend straight from the block pool through the "
                    "CUDA paged-attention kernel (its plain PyTorch version "
                    "on the CPU) instead of gathering each row's view "
                    "(requires --paged)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="per-trial block-pool size (--paged with explicit "
                    "--slots; 0 = back every cell at max_seq)")
    ap.add_argument("--expected-seq", type=int, default=0,
                    help="expected request length for paged capacity "
                    "planning (0 = max_seq/2)")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="paged admission headroom: commit up to this "
                    "fraction of each pool partition (1.0 = preemption-free; "
                    "> 1.0 enables retraction — on pool exhaustion the "
                    "youngest running request is preempted, swapped to the "
                    "host tier or replayed, and restored later)")
    ap.add_argument("--host-blocks", type=int, default=0,
                    help="host-memory spill tier capacity per pool partition "
                    "(--paged): evicted prefix-cache blocks spill to host "
                    "instead of being destroyed, and retraction swaps KV out "
                    "instead of recomputing (0 = no host tier)")
    ap.add_argument("--no-spill", action="store_true",
                    help="keep the host tier for retraction payloads only: "
                    "prefix-cache eviction destroys blocks instead of "
                    "spilling them")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="radix prefix cache over the paged block pool: "
                    "completed prompts stay cached and new requests reuse "
                    "shared-prefix KV blocks (requires --paged)")
    ap.add_argument("--expected-hit-rate", type=float, default=0.0,
                    help="expected prefix-cache hit fraction for paged "
                    "capacity planning (shrinks per-row expected demand)")
    ap.add_argument("--spec-draft", default="",
                    help="gang-speculative decoding: pair every target arch "
                    "with a drafter trial row of THIS arch's shape and its "
                    "own weights (it must share the target's parameter "
                    "skeleton and vocab). Drafter rows propose --spec-gamma "
                    "tokens; the target verifies them in one call. Greedy "
                    "tokens stay bit-identical; drafter quality only moves "
                    "the acceptance rate")
    ap.add_argument("--spec-gamma", type=int, default=3,
                    help="draft tokens proposed per speculation round")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event / Perfetto JSON "
                    "timeline of the run here (one track per (k,m,b) slot "
                    "cell + pool/host-tier/queue counter tracks). Enables "
                    "tracing")
    ap.add_argument("--events-out", default="",
                    help="write the raw structured event log (JSONL, one "
                    "event per line) here. Enables tracing")
    ap.add_argument("--metrics-out", default="",
                    help="write the run's metric registry snapshot (JSONL, "
                    "one metric per line) here")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="parameter, activation and KV-cache dtype")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of a (data, model) layout "
                    "in C order, e.g. cpu,cpu,cpu,cpu or "
                    "cuda:0,cuda:1,cuda:2,cuda:3 (a device may repeat)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def parse_weights(spec: str, k: int):
    if not spec:
        return None
    w = [float(x) for x in spec.split(",")]
    if len(w) != k:
        raise SystemExit(f"--arch-weights needs {k} comma-separated values, "
                         f"got {len(w)}")
    return w


def check_args(args) -> None:
    """The reference launcher's flag rules (SystemExit on a bad mix)."""
    if args.slots < 0:
        raise SystemExit(f"--slots must be >= 0, got {args.slots}")
    if args.paged and args.static:
        raise SystemExit("--static is the dense lockstep baseline; "
                         "drop --paged")
    if args.prefix_cache and not args.paged:
        raise SystemExit("--prefix-cache shares paged KV blocks; add --paged")
    if args.overcommit > 1.0 and not args.paged:
        raise SystemExit(
            f"--overcommit {args.overcommit} > 1.0 admits past the block "
            f"pool and relies on retracting paged block commitments; dense "
            f"cache strips cannot be retracted — add --paged")
    if args.paged_kernel and not args.paged:
        raise SystemExit("--paged-kernel attends through block tables; "
                         "add --paged")
    if args.host_blocks < 0:
        raise SystemExit(f"--host-blocks must be >= 0, got {args.host_blocks}")
    if (args.host_blocks > 0 or args.no_spill) and not args.paged:
        raise SystemExit("--host-blocks/--no-spill manage the paged block "
                         "store's host tier; add --paged")
    if args.static and args.arches > 1:
        raise SystemExit("--static is single-arch lockstep batching; "
                         "multi-arch routing needs the continuous engine")
    if args.fused_admission and args.static:
        raise SystemExit("--fused-admission fuses the continuous engine's "
                         "round; drop --static")
    if args.spec_draft and args.static:
        raise SystemExit("--spec-draft speculates inside the continuous "
                         "engine's rounds; drop --static")
    if args.spec_draft and args.fused_admission:
        raise SystemExit("--spec-draft and --fused-admission both own the "
                         "round's ragged call structure; pick one")
    if args.spec_draft and args.spec_gamma < 1:
        raise SystemExit(f"--spec-gamma must be >= 1, got {args.spec_gamma}")
    if (args.trace_out or args.events_out) and args.static:
        raise SystemExit("--trace-out/--events-out trace the continuous "
                         "engine's rounds; drop --static")


def plan_grid(args, cfg, base, weights, max_seq):
    """``--slots 0``: the grid ``plan_serve_capacity`` fits on the card
    (weights in the serving dtype), capped by ``--max-slots``; returns
    (engine config, the plan's report lines)."""
    exp = args.expected_seq or None
    mix = None
    if args.arches > 1:
        w = weights or [1.0] * args.arches
        mix = [(wi, exp or max_seq // 2) for wi in w]
    planned = sched.plan_serve_capacity(
        cfg, base, max_seq, paged=args.paged, expected_seq=exp,
        block_size=args.block_size, max_slots=args.max_slots, mix=mix,
        hit_rate=args.expected_hit_rate if args.paged else 0.0,
        overcommit=args.overcommit if args.paged else 1.0,
        host_blocks=args.host_blocks, param_dtype=DTYPES[args.dtype])
    return (dataclasses.replace(base, n_microbatches=planned.n_microbatches,
                                n_blocks=planned.n_blocks,
                                host_blocks=planned.host_blocks),
            report.render_capacity_plan(planned, planned.n_microbatches,
                                        args.paged))


def make_requests(args, cfg, eng, weights, max_seq) -> list:
    """``--trace`` replay (checked against ``max_seq``, ``--arches`` and,
    for ``--static``, uniform prompt lengths per group of cells), uniform
    prompts with staggered budgets for ``--static``, else a Poisson
    trace."""
    if args.trace:
        requests = load_trace(args.trace)
        too_long = [r.rid for r in requests if r.total_len > max_seq]
        if too_long:
            raise SystemExit(f"trace requests {too_long} exceed max_seq="
                             f"{max_seq}; raise --prompt-len/--gen-len")
        bad_arch = [r.rid for r in requests if r.arch >= args.arches]
        if bad_arch:
            raise SystemExit(f"trace requests {bad_arch} target arch ids >= "
                             f"--arches={args.arches}; raise --arches")
        if args.static:
            n_cells = eng.n_microbatches * eng.mb_global
            for g0 in range(0, len(requests), n_cells):
                plens = {r.prompt_len for r in requests[g0:g0 + n_cells]}
                if len(plens) > 1:
                    raise SystemExit(
                        f"--static needs uniform prompt lengths per batch "
                        f"group; group at {g0} has {sorted(plens)} — drop "
                        f"--static or bucket the trace")
        return requests
    if args.static:
        # the lockstep baseline needs uniform prompts; stagger the budgets
        rng = np.random.default_rng(args.seed)
        return [
            Request(i, rng.integers(0, cfg.vocab_size,
                                    (args.prompt_len,)).astype(np.int32),
                    int(rng.integers(max(1, args.gen_len // 2),
                                     args.gen_len + 1)))
            for i in range(args.n_requests)]
    return poisson_trace(
        args.n_requests, args.rate, cfg.vocab_size,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        gen_lens=(max(args.gen_len // 2, 1), args.gen_len), seed=args.seed,
        n_arches=args.arches, arch_weights=weights,
        deadline_slack=args.deadline_slack)


def skeleton(cfg, eng) -> list:
    """(leaf path, shape, dtype) of one trial's parameters, built on the
    meta device (nothing is allocated)."""
    e1 = dataclasses.replace(eng, n_trials=1)
    params = pl.init_trial_params(cfg, e1, plan_stages(cfg, eng.n_stages),
                                  torch.Generator(), device="meta",
                                  max_pos=eng.max_seq)
    return [(path, tuple(v.shape), v.dtype)
            for path, v in tree_items(params)]


def main(argv=None):
    args = build_args().parse_args(argv)
    check_args(args)
    weights = parse_weights(args.arch_weights, args.arches)
    layout = None
    if args.devices:
        if args.device:
            raise SystemExit("--device runs one device; a layout takes "
                             "--devices")
        layout = make_device_layout(args.n_data, args.n_model,
                                    devices=args.devices.split(","))
        device = layout.root
    else:
        device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.family == "mlp":
        raise SystemExit(f"{args.arch} is the paper's MLP workload: it has "
                         f"no sequence to serve")
    if args.static and (cfg.frontend is not None or cfg.rope == "mrope"):
        raise SystemExit(
            f"--static feeds tokens only, and {args.arch}'s prefill needs "
            f"frontend embeddings / M-RoPE positions (the reference's "
            f"static path fails there too); serve it through "
            f"pipeline.make_serve_step's prefill and decode")
    if args.smoke:
        cfg = cfg.reduced()
    dtype = DTYPES[args.dtype]
    max_seq = args.prompt_len + args.gen_len
    eng = pl.EngineConfig(
        n_trials=args.arches, n_microbatches=max(args.slots, 1),
        microbatch=args.microbatch, n_stages=args.n_model,
        data_size=args.n_data, max_seq=max_seq, cache_dtype=dtype,
        prefill_chunks=args.prefill_chunks, paged=args.paged,
        block_size=args.block_size, window=args.window)
    lines = []
    if args.slots == 0:
        eng, lines = plan_grid(args, cfg, eng, weights, max_seq)
    elif args.paged:
        eng = dataclasses.replace(
            eng, host_blocks=args.host_blocks,
            n_blocks=args.n_blocks or (args.microbatch * args.slots
                                       * args.n_data
                                       * blocks_for(max_seq,
                                                    args.block_size)))
    spec_pairs = None
    if args.spec_draft:
        dcfg = get_config(args.spec_draft)
        if args.smoke:
            dcfg = dcfg.reduced()
        # drafter rows ride the same stacked parameters (leading K axis),
        # so the drafter arch must share the target's parameter skeleton
        if (dcfg.vocab_size != cfg.vocab_size
                or skeleton(dcfg, eng) != skeleton(cfg, eng)):
            raise SystemExit(
                f"--spec-draft {args.spec_draft}: drafter parameter skeleton "
                f"(or vocab) differs from {args.arch} — the trial axis "
                f"stacks rows of one shape; pick an arch variant with an "
                f"identical skeleton")
        # drafter rows follow the target rows: target k drafts on row K + k
        spec_pairs = {k: args.arches + k for k in range(args.arches)}
        eng = dataclasses.replace(eng, n_trials=2 * args.arches)
    opts = kernel_options(cfg, compute_dtype=dtype,
                          use_paged_kernel=args.paged_kernel)
    requests = make_requests(args, cfg, eng, weights, max_seq)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, dtype=dtype, device=device,
                                  max_pos=max_seq)
    where = dict(device=device)
    if layout is not None:
        params = pl.place_trial_params(cfg, eng, params, layout)
        where = dict(layout=layout)
    tracer = Tracer() if args.trace_out or args.events_out else None
    pa.launches = fa.launches = ms.launches = 0
    if args.static:
        completions, stats = static_serve(cfg, eng, params, requests, opts,
                                          **where)
        mode = "static"
    else:
        engine = ServeEngine(cfg, eng, params, opts,
                             overcommit=args.overcommit, policy=args.policy,
                             prefix_cache=args.prefix_cache,
                             spill=not args.no_spill,
                             fused=args.fused_admission,
                             spec_gamma=args.spec_gamma if args.spec_draft
                             else 0, spec_pairs=spec_pairs, tracer=tracer,
                             **where)
        completions = engine.run(requests)
        stats = engine.stats
        mode = ("continuous/" + ("paged" if args.paged else "dense")
                + ("+kernel" if args.paged_kernel else ""))
        if args.fused_admission:
            mode += "+fused"
        if args.spec_draft:
            mode += f"+spec(gamma={args.spec_gamma})"
        if args.prefix_cache:
            mode += "+prefix-cache"
        if args.arches > 1:
            mode += f" x{args.arches}-arch gang"
    if args.window:
        mode += f" window={args.window}"
    if layout is not None:
        mode += " on " + ",".join(str(d) for d in layout.devices.flat)
    s = stats.summary()
    lines += report.render_completions(completions,
                                       multi_arch=args.arches > 1)
    lines += report.render_summary(mode, len(completions), s,
                                   policy=args.policy)
    if args.paged:
        lines += report.render_paged(s, eng.n_blocks, eng.block_size,
                                     eng.host_blocks, args.overcommit)
    if args.spec_draft:
        lines += report.render_spec(s, engine.spec_stats.summary())
    if args.prefix_cache:
        lines += report.render_prefix(s)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    lines.append(f"device {name}: {pa.launches} paged-attention kernel "
                 f"launches, {fa.launches} flash-attention kernel launches, "
                 f"{ms.launches} selective-scan kernel launches")
    if args.trace_out:
        n = write_perfetto(tracer.events, args.trace_out)
        lines.append(f"wrote {n} trace records -> {args.trace_out} "
                     f"(Chrome trace-event JSON, loads in Perfetto)")
    if args.events_out:
        n = write_events(tracer.events, args.events_out)
        lines.append(f"wrote {n} events -> {args.events_out}")
    if args.metrics_out:
        n = write_metrics(stats.snapshot(), args.metrics_out)
        lines.append(f"wrote {n} metrics -> {args.metrics_out}")
    for line in lines:
        print(line)  # noqa: T201


if __name__ == "__main__":
    main()
