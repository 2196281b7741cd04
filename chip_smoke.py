"""Smoke test of the PyTorch port (src/repro_torch) on an NVIDIA GPU (phases
19 (b) and 20 (d) also use every other card they see).

Run from the root of a checkout on a machine with a CUDA card (H100):

    python3 chip_smoke.py [--out results.json] [--phases 2,3,5]

It builds the hand-written CUDA kernels from the checkout's sources (one
nvcc per source, all started together) and runs twenty phases, each a hard
assert; it exits 0 only if every phase passed, and exits non-zero without
a result when no CUDA device is visible. ``--phases`` runs a subset (the
build always runs) and then prints neither the kernels line nor the last
line.

1. Environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, TF32 off for matmuls and cuDNN, the kernels' build time.
2. The paged-attention kernel (K2) against its plain PyTorch version on
   the card at the serving path's shapes (32 query heads on 2 KV heads,
   head_dim 128): decode over ragged kv_len 1..2048, a 64-wide append
   chunk at ragged offsets, a windowed case, ragged q_lens with a zero row,
   tables with -1 tails; phase 5's own shapes (decode of 2 rows at 141 and
   1056 tokens, n_tbl 66; a 486-token append chunk); the split-KV edges
   (kv_len 0 and 1, a split only partly live, a window starting mid-split,
   q_lens 0, block sizes 4, 8 and 32); phase 12's verify call (4 rows of
   3-4 tokens at offsets 487-578, not block multiples), once as is and
   once with planted keys that make the in-chunk causal mask decide each
   output. Each in fp32 (tol 2e-5) and bf16 (tol 3e-2, and at most 1e-2
   of the largest plain output), with the variant that ran (split-KV or
   the tensor-core append tile) and its split count. Times are CUDA-event
   medians of 30
   launches after warm-up with L2 flushed (a 512 MiB memset, which also
   keeps the card busy while the host enqueues the call); the bound is
   max(bytes / 3.35 TB/s, operations / peak rate of the input type).
3. The flash-attention kernel (K1) against its plain version at the
   training path's shape (b 1, seq 2048, 32 query heads on 2 KV heads,
   head_dim 128, causal), at phase 13's static prefill shape (b 2, seq
   512), at the same two shapes for zamba2-7b's shared block (32 heads on
   32, head_dim 112: not a multiple of 64) and the reference sweep's edge
   cases (ragged sq
   33 with hq = hkv, window 24, kv_offset 32 with sq 16 / sk 48) plus sq
   100 (not a multiple of the bf16 tile's 64 rows) and a head_dim 64 case
   with kv_offset 64, bert-large's training call (b 8, seq 512, 16 heads
   on 16, hd 64, non-causal) and rows with no visible key (kv_offset -8,
   window 8), fp32 (tol 2e-5) and bf16 (tol 2e-2); the autograd op's
   q/k/v gradients against autograd of the plain version; K1's backward
   kernels (``kernels/attention_bwd.py``) at every case against the plain
   backward (autograd through ``chunked_attention``) in fp32 on the same
   values, each gradient within the tolerance of its largest entry; times
   as phase 2, beside ``F.scaled_dot_product_attention`` and its backward
   (timed as yardsticks only), the backward's time by kernel beside the
   bound of its five products and the plain backward's time. Then one
   profiled train step (full-width chatglm3-6b at 2 fp32 layers, K 2, M
   2, S 2, seq 512, remat): the card's ``flash_attention`` records equal
   K1's forward launches, and the backward kernels' calls equal the
   step's K1 backward calls (the tracer's ``k1_backward``), one per
   (trial, microbatch, layer).
4. Serving exactness: chatglm3-6b at full width, depth cut to 2 layers,
   fp32 weights and pool, 2 stages, 2 data shards: every request's greedy
   tokens from the paged ServeEngine (kernel path) equal the oracle.
5. The serving path at full size: chatglm3-6b, 28 layers, bf16 weights
   and pool, random weights from a seed; paged kernel, split admission,
   2 stages, 2 slots x microbatch 2; 8 requests with 128-1024 prompt
   tokens and 32 new tokens each. Every request completes with its budget,
   K2's launch count equals calls x slots x layers, and every decode
   launch took split-KV and every append launch the tensor-core tile. A
   profiled second run of the same trace gives K2's device time in decode
   and in append calls (launches, ms per launch, share of the wall); one
   more decode call is profiled for its host op count and the card's busy
   time by kernel class.
6. Training exactness: full-width chatglm3-6b cut to 2 layers, fp32, K = 2
   trials, 2 stages, 2 microbatches, seq 512, 2 steps of the pipelined
   train step (flash kernel) against K independent unpipelined runs
   (plain attention): losses, and each trial's loss on a held-out batch
   after the last update, within 2e-4; parameters within 5e-3; each
   trial's parameter change within 10 % of the sequential run's.
7. The training path: ``run_model_selection`` as ``launch/train.py``
   calls it, on full-width chatglm3-6b cut to 4 layers (full depth needs
   100 GB of fp32 state per trial), 2 trials, 2 stages, seq 2048, 3 steps,
   remat, flash kernel, fp32. Both trials in one gang, K1's launch count
   equal to the schedule's, 0 restarts, finite losses; step time, tokens/s,
   model FLOP/s, K1's share of step time and peak memory are recorded.
8. The selective-scan kernel (K3) against its plain version at the SSM
   serving path's largest shape (b 2, s 512, d_inner 8192, d_state 16,
   nonzero h0) in fp32 (tol 1e-4) and with bf16 inputs (tol 3e-2), a
   ragged s 37, a strided C (the last columns of x_proj's output, as the
   model passes it) and a d_state 8 case; y and h both; times as phase 2,
   bound by bytes; the op's gradients against autograd of the plain
   version.
9. SSM serving exactness: falcon-mamba-7b at full width, depth cut to 2
   layers, fp32 weights and cache, the dense ServeEngine (K3 in every
   append), 2 stages, 2 slots x microbatch 2, 7 staggered requests of
   17-70 prompt tokens (more than the 4 cells: slots recycle): every
   request's greedy tokens equal the oracle's (``lm.greedy_generate``
   through the chunked scan, independent of K3), K3's launches equal
   append calls x slots x layers, and every reset row is zero.
10. The SSM serving path at full size: falcon-mamba-7b, all 64 layers,
   bf16 weights and conv cache (fp32 SSM state), dense engine, split
   admission, 2 stages, 2 slots x microbatch 2; the same 8-request
   traffic as phase 5. Every request completes with its budget, K3's
   launch count equals 128 x append calls, a second run gives the same
   tokens; wall, tokens/s, ms per call, K3's share of wall, peak memory
   and one profiled decode call are recorded.
11. Serve-feature exactness: chatglm3-6b at full width, depth cut to 2
   layers, fp32 weights and pool, paged kernel, 2 stages, 2 data shards,
   block 16. Every request's greedy tokens equal the oracle's (0
   mismatches) with the prefix cache on and off (a shared 40-token head:
   hits end mid-block, so tails fork copy-on-write; a 6-block partition
   evicts), under overcommit 1.5 with a host tier (swap; every retracted
   request restored) and without (recompute), fused against split
   admission on phase 4's trace (the same tokens and tick latencies in
   fewer calls), and with gang speculation, K = 2, gamma 3 (a mirrored
   drafter accepts everything; one of other weights rolls blocks back).
   After every run the allocator holds only the cache's blocks, and K2's
   launches equal calls x slots x layers.
12. The serve features at full width: chatglm3-6b cut to 4 of its 28
   layers (``P12_LAYERS``), bf16, 2 stages, 2 slots x microbatch 2. Run A: the prefix cache, fused
   admission, overcommit 1.5 and a 256-block host tier on a 150-block
   pool (about 58 % of the four cells' peak demand); 16 requests, 2 a
   tick, each a shared 520-token system prompt, 32-480 unique tokens and
   32 new ones, the last four resubmitting the first four prompts; at
   least 8 hits, a CoW fork, a retraction, a restored request, hits
   served from the host tier and blocks swapped in; then two written pool
   blocks go to the host and back bit for bit. Run B: gang speculation,
   K = 2 (the drafter has the target's weights), gamma 3, split
   admission; 8 requests of 128-512 prompt tokens and 64 new ones,
   beside the target alone on the same trace. Every request completes
   with its budget; K2's launches equal calls x slots x layers, and by
   variant: every call of 4 or more tokens (mixed waves, verify calls of
   gamma + 1) the tensor-core tile, every narrower one split-KV.
   Recorded: wall, tokens/s, ms per call by kind, the mixed fill ratio,
   acceptance, target calls per token with and without speculation, swap
   blocks, peak memory, the share of requests whose bf16 tokens equal the
   plain run's (no gate: bf16 near-ties may flip an argmax) and the fp32
   logit gap at each first divergence (and each of run B's rejected
   proposals) beside the bf16 forward's own logit error there. A short run
   of each configuration profiles the first call of each kind (mixed
   wave, hit-offset wave, decode-only mixed call, decode, verify, draft,
   append): its host ops, device busy ms and idle share, K2's device ms
   per launch beside its bound, and every K2 launch of that call against
   the plain version (bf16 limit as phase 2's).
13. The rest of serving. (a) Exactness at full width, 2 fp32 layers:
   static lockstep serving (K1 in every prefill call; prompts of 128 and
   of 100 tokens, not a multiple of K1's 64-row tile) equal to the oracle
   and to the continuous engine; windowed serving (window 24 on 40-110
   token prompts) through dense strips, the paged pool with K2 and static
   serving with a windowed K1, equal to the windowed oracle, the window
   changing some request's tokens; falcon-mamba-7b static serving (K3)
   equal to the oracle; chunked prefill (4 chunks) equal to plain prefill
   in tokens and caches for both families; a traced run that passes the
   span validator and holds compile events. (b) chatglm3-6b at full
   width, ``P12_LAYERS`` bf16 layers, phase 5's grid: static serving of 8 requests of 512 prompt
   tokens and 16-32 new ones (K1's launches = prefill calls x slots x
   layers, all on the tensor cores) beside the continuous split engine on
   the same trace; wall, tokens/s, ms per prefill / decode call, peak
   memory; one prefill call profiled: K1's device ms per launch beside its
   bound, and every K1 launch of that call against the plain version
   (bf16 tol 2e-2). (c) Phase 5's trace with window 256 through the paged
   engine (K2), every launch windowed; the trace's longest prompt alone
   profiled, every K2 launch of its first append and decode calls against
   the plain version (also ``P12_LAYERS`` layers). (d)
   ``plan_serve_capacity`` on this card's 80 GB for chatglm3-6b's 28
   layers (bf16, paged, expected length 600, at most 8
   slots): the planned grid serves a few requests, and its peak memory
   stands beside the plan's estimate.
14. SSM training. (a) falcon-mamba-7b at full width, 2 fp32 layers,
   K = 2, S = 2, 2 microbatches, seq 256, 2 steps of the pipelined train
   step with K3 in the forward (backward: autograd of the plain scan)
   against K sequential runs through the chunked scan, by phase 6's
   criteria. (b) ``run_model_selection`` as ``launch/train.py`` calls it
   on 2 full-width layers, 2 trials, 2 stages, seq 512, 2 steps, remat,
   K3: K3's launches equal the schedule's, 0 restarts, finite losses;
   step time, tokens/s, model FLOP share, K3's share of step time and peak
   memory recorded, as phase 7.
15. The hybrid family, zamba2-7b (a Mamba2 backbone and one shared
   attention block at every 6th layer; K1 at head_dim 112). (a) Exactness
   at full width, 12 fp32 layers (one shared site in each of the 2
   stages): the dense engine on 7 staggered requests (slots recycle;
   every reset row, shared strips included, is zero) and static serving
   (K1 in each prefill) equal the oracle; chunked prefill (4 chunks)
   equals plain prefill in tokens and caches; the train step (K1 fp32)
   equals sequential runs by phase 6's criteria. (b) The first 12 of the
   81 layers (2 shared sites, every width as published) in bf16 (fp32
   SSM state) on phase 5's grid and trace through the dense engine: every
   budget met, a second run's tokens equal, wall, tokens/s, ms per call,
   peak memory and one profiled decode call; then static serving of 8 x
   512-token prompts: K1's launches = prefill calls x slots x 2 sites,
   all on the tensor cores,
   and every K1 launch of one profiled prefill call within 2e-2 of the
   plain version. (c) ``run_model_selection`` on 12 full-width layers,
   seq 2048, 2 steps, remat, K1 fp32 at head_dim 112: K1's launches equal
   the schedule's; what phase 7 records but its profiled step (left out
   to keep the script inside its time limit).
16. The MoE family (granite-moe-3b-a800m: 40 experts, top-8, 24 query
   heads on 8 at head_dim 64, vocab 49155; llama4-scout-17b-a16e: 16
   experts, top-1, 40 heads on 8 at head_dim 128). (a) K2 (decode, a
   64-wide append, phase 5's shapes) and K1 (b 1, seq 2048) at granite's
   heads against their plain versions, with phases 2 and 3's tolerances,
   timing, bounds and SDPA beside K1. (b) Phase 4's engine and trace at
   full width, 2 fp32 layers, 2 stages, 2 data shards (each shard's rows
   routed alone), capacity factor E / k (nothing dropped): 0 mismatches
   against the oracle for granite, then for llama4-scout (its 25 GB of
   weights shared with the oracle, freed after), K2's launches = calls x
   slots x layers. (c) Granite at its first 4 of 32 layers
   (``P16C_LAYERS``) in bf16 at the launcher's
   factor 1.25 on phase 5's grid and trace (``paged_serve_path``, phase
   5's checks and records); one profiled decode and one append call:
   host ops and the card's busy ms by region (``busy_by_region``: expert
   products, routing and dispatch, K2, the rest); every ``moe_apply`` of
   one decode call under ``torch.cuda.set_sync_debug_mode("error")``. (d)
   The train step (K1, 2 data shards) against sequential runs of the
   reference oracle's objective (per-shard CE and aux, each averaged), by
   phase 6's gates, at factor E / k and at 1.25; a failing gate reports
   the routing decisions that differ between K1 and plain attention. (e)
   ``run_model_selection`` on ``P16C_LAYERS`` full-width granite layers,
   seq 2048, K1
   fp32, factor 1.25: K1's launches equal the schedule's; what phase 7
   records, plus the capacity-padded FLOPs and the MoE share of a
   profiled step's busy time.
17. The remaining families. (a) K1 at bert-large's training shape (b 2,
   seq 512, 16 heads on 16 at hd 64, non-causal; SDPA with is_causal
   False beside it), a ragged non-causal case (sq = sk 100), musicgen-
   medium's prefill (24 on 24, hd 64) and qwen2-vl-72b's (64 on 8, hd
   128), with the op's gradients in fp32 (the non-causal backward
   included); K2's decode and append64 at groups 7 (56 on 8) and 12 (48
   on 4), hd 128; tolerances, timing and bounds as phases 2 and 3. (b)
   Phase 4's engine and trace on yi-34b and starcoder2-15b (GELU) at 2
   fp32 layers, 2 data shards, K2: 0 mismatches against the oracle. (c)
   ``make_serve_step`` prefill (K1 fp32) then 16 decode calls at 2 fp32
   layers for qwen2-vl-72b (320-token prompts, the first 256 seeded patch
   embeddings at t 0 on a 16 x 16 (h, w) grid, then text) and
   musicgen-medium (64 seeded frames): 0 mismatches against the
   single-device oracle with the same embeddings and positions. (d)
   musicgen-medium at all 48 layers in bf16: one prefill call of 8 x
   512-token prompts (2 slots x microbatch 2 x 2 data shards), 32 decode
   calls; tokens/s, ms per call, K1's launches (slots x layers), every
   K1 launch of a second prefill call against the plain version, one
   profiled decode call. (e) The train step against sequential runs by
   phase 6's gates for bert-large (K1 non-causal) and musicgen-medium
   (frontend batches), 2 fp32 layers, seq 512. (f) bert-large at 8 of
   its 24 layers (``P17F_LAYERS``) through ``run_model_selection``: 4
   trials, 2 rows a microbatch, 2 stages, seq 512, 3 steps, remat, K1
   fp32 non-causal;
   what phase 7 records, the model FLOPs counting seq^2 pairs. (g) The
   paper's MLP (mlp-1m) trained 20 steps with SGD(momentum=0.9) on the
   card and on the CPU from the same weights: losses within 1e-5.
18. The dry-run with the H100 roofline (``launch/dryrun.py``). (a) Every
   applicable (arch × shape) cell of the grid, bert-large included, on
   the card layout, counted on ``meta`` with loop-awareness (worker
   processes): one row a cell (dominant term, roofline fraction, modeled
   GB, fits_card) and the count of cells that fit; a cell that errors
   fails the phase. (b) Phase 7's training step (chatglm3-6b, 4
   full-width fp32 layers, K 2, M 5, S 2, seq 2048, remat) counted on
   the card with K1 on and on ``meta`` with the plain path: the FLOPs
   agree exactly once the attention terms are taken out (K1's forward
   and its backward kernels over the causal pairs, against the plain
   path's chunked forward and backward over every score block), and a
   count that misses K1's forward, or a backward call, fails; the
   counted FLOPs beside the model FLOPs and 6·N·D. (c) falcon-mamba-7b ``decode_32k`` at its
   published shape (64 layers, bf16, 128 rows, cache length 32768)
   allocated and run for one decode step through ``make_serve_step``
   with the launcher's kernel options: the measured peak memory beside
   the modeled bytes.
19. Hydra's training mesh on device layouts (``core/pipeline.py`` with
   ``layout=``): the number of visible cards first. (a) chatglm3-6b at
   every published width, 2 layers (``P19_LAYERS``), fp32, K 2, M 5, seq
   2048, remat, K1:
   2 steps of the placed train step on a data 2 x model 2 FSDP layout over
   ``["cuda:0"] * 4`` against 2 steps of the one-device step (2 logical
   data shards) from the same weights and batches: losses within 2e-4,
   grad norms and parameters within 5e-3; K1's launches (set to 0 just
   before the placed steps) = 2 replicas x 2 steps x 10 slots x (3 x 2 -
   1); step ms and peak memory beside the planner's per-chip bytes. (b)
   Only where several cards are visible (otherwise it says it did not
   run): stage s on cuda:s (data 1 x model 2, the same rows as a
   microbatch of 2) and, with 4 cards, (a)'s FSDP layout on cuda:0-3,
   each against (a)'s one-device step by the same gates, with each card's
   peak memory beside ``per_chip_bytes`` and the step ms beside (a)'s.
20. Serving on device layouts (``ServeEngine`` and ``static_serve`` with
   ``layout=``): the number of visible cards first. (a) chatglm3-6b at
   every published width and all 28 layers in bf16 through the paged
   engine with K2, phase 5's traffic (8 requests of 128-1024 prompt
   tokens, 32 new tokens each, split admission, block 16) on a data 2 x
   model 2 layout over ``["cuda:0"] * 4``, 1 row a shard (phase 5's 2
   rows a slot), against the one-device engine with 2 logical data
   shards from the same weights and pool: ttft and finished ticks, calls
   and the allocator's free lists equal; tokens equal, or each request's
   first differing token a bf16 near-tie (``near_ties``); K2's launches
   (set to 0 just before each run) 4536 one device, 9072 placed (2
   replicas x 81 calls x 2 slots x 28 layers); wall, tokens/s, ms per
   decode call, host ops per decode call and peak memory beside the
   one-device run's. (b) chatglm3-6b at full width, ``P20_LAYERS`` fp32
   layers, the prefix cache on a shared-prefix trace, a host tier: data 2
   x model 2 with FSDP and pod 2 x data 1 x model 2, each over
   ``["cuda:0"] * 4`` and held exactly to the one-device engine (tokens,
   ticks, calls, free lists); the placed pool gathered back is within
   2e-5 where written and bit-equal elsewhere; extract and inject round-
   trip two written blocks bit for bit on the FSDP layout; K2 256 each
   (one device 128). (c) ``P20_LAYERS`` fp32 layers at full width:
   falcon-mamba-7b through the placed dense engine with K3 (model 2 over
   ``["cuda:0"] * 2``, slots recycled and reset, K3 112 as one device)
   and chatglm3-6b through placed ``static_serve`` with K1 (data 2 x
   model 2, K1 32, one device 16), tokens equal to the one-device runs.
   (d) Only where several cards are visible (otherwise it says it did not
   run): (a) with stage s on cuda:s (data 1 x model 2, 2 rows a slot,
   against a one-device engine of that grid) and, with 4 cards, (a)'s
   layout on cuda:0-3, each under (a)'s gates, with each card's peak
   beside the planner's per-chip bytes and the ms per decode call beside
   (a)'s.
21. A {"kernels": [...]} line for every ported kernel, the card line, and
   the last line: {"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.analysis import costs  # noqa: E402
from repro_torch.analysis.roofline import PEAK_FLOPS as PEAK_OPS  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
BF16_REL = 1e-2  # K2 in bf16: also within 1e-2 of the largest plain output
HQ, HKV, HD, BS = 32, 2, 128, 16  # chatglm3-6b attention, serving block
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # test_kernels_flash
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # test_kernels_mamba


def say(*parts) -> None:
    print(*parts, flush=True)  # noqa: T201


def tidy() -> None:
    """Free what the last phase left (cycles first, then the allocator's
    cache)."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def reset_counts(mod) -> None:
    """Set a kernel module's launch counts to 0 (the total, and the
    per-variant counts where the module keeps them)."""
    mod.launches = 0
    for name in getattr(mod, "variant_launches", {}):
        mod.variant_launches[name] = 0


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

# name, sq, per-row kv_offset, q_lens (None = all sq), window, block size,
# n_tbl, timed. The first four are the original sweep (8 rows ragged to 2048
# tokens, n_tbl 128: the power of two covering 2048 / 16); "p5_*" are phase
# 5's own shapes (b 2 rows of one slot, live lengths 128-1056, n_tbl up to
# the 66 entries of a 1056-token row; the append chunk is one phase 5
# launches: 486 tokens, a second chunk at offset 487 beside a first at 0);
# "edge_*" are the split-KV edges: kv_len 0 and 1, a split only partly
# live, a window starting mid-split, q_lens 0, block sizes 4, 8 and 32
# (correctness only); "verify_sq4" is phase 12's verify call (gamma 3: 4
# tokens, 3 on rows whose last draft was not made) at offsets that are not
# block multiples, and "verify_sq4_needles" the same with planted keys
# (``plant_needles``) that make the in-chunk causal mask decide each
# output.
CASES = [
    ("decode", 1, [0, 16, 129, 510, 1023, 1499, 1999, 2047], None, 0, BS,
     128, True),
    ("append64", 64, [0, 100, 700, 1900], None, 0, BS, 128, True),
    ("decode_window256", 1, [299, 899, 2047, 4], None, 256, BS, 128, True),
    ("append64_ragged_qlens", 64, [100, 200, 300, 400], [64, 1, 0, 33], 0,
     BS, 128, True),
    ("p5_decode", 1, [140, 1055], None, 0, BS, 66, True),
    ("p5_append486", 486, [487, 0], None, 0, BS, 64, True),
    ("edge_kv_len_0_1", 1, [0, 0, 37], [0, 1, 1], 0, BS, 8, False),
    ("edge_partial_split", 1, [70, 200, 63], None, 0, BS, 16, False),
    ("edge_window_mid_split", 1, [150, 250], None, 100, BS, 16, False),
    ("edge_q_lens_0", 8, [40, 0, 90], [0, 8, 3], 0, BS, 16, False),
    ("edge_bs4_decode", 1, [0, 5, 33, 100], None, 0, 4, 32, False),
    ("edge_bs4_append", 6, [3, 40, 97], [6, 2, 6], 24, 4, 32, False),
    ("edge_bs8_decode", 1, [7, 64, 130], None, 0, 8, 32, False),
    ("edge_bs8_append", 5, [0, 61], None, 0, 8, 16, False),
    ("edge_bs32_decode", 1, [31, 32, 500], None, 40, 32, 16, False),
    ("edge_bs32_append", 17, [15, 300], [17, 9], 0, 32, 16, False),
    ("verify_sq4", 4, [487, 533, 502, 578], [4, 3, 4, 3], 0, BS, 64, True),
    ("verify_sq4_needles", 4, [487, 533, 502, 578], [4, 3, 4, 3], 0, BS, 64,
     False),
]
N_BLOCKS = 1024


def make_case(dev, dt, sq, offsets, q_lens, seed, bs=BS, n_tbl=128,
              needles=False, heads=(HQ, HKV, HD)):
    """Random pool and ragged tables: row r's live blocks are a random
    disjoint subset of the pool covering offsets[r] + sq positions; the rest
    of its table is -1. ``needles``: see :func:`plant_needles`. ``heads``:
    (query heads, KV heads, head_dim)."""
    hq, hkv, hd = heads
    rng = np.random.default_rng(seed)
    b = len(offsets)
    q_lens = [sq] * b if q_lens is None else q_lens
    tables = np.full((b, n_tbl), -1, np.int32)
    free = list(rng.permutation(N_BLOCKS))
    for r, off in enumerate(offsets):
        for j in range(-(-(off + sq) // bs)):
            tables[r, j] = free.pop()
    mk = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    case = dict(q=mk(b, sq, hq, hd), k_pool=mk(N_BLOCKS, bs, hkv, hd),
                v_pool=mk(N_BLOCKS, bs, hkv, hd),
                block_tables=torch.from_numpy(tables).to(dev),
                kv_offset=off, kv_len=off + ql, q_lens=ql)
    if needles:
        plant_needles(case, rng, tables, offsets, sq, bs)
    return case


def plant_needles(case, rng, tables, offsets, sq, bs) -> None:
    """Every query of row r is one random vector u (all chunk positions and
    heads), and the key at chunk position i has logit 10 (i + 1) against
    it, the history keys about N(0, 1): query i's output is about the value
    at its own position. A key leaked from later in the chunk, or a query's
    own key dropped, moves that output by O(1)."""
    for r, off in enumerate(offsets):
        u = torch.from_numpy(rng.standard_normal(HD, dtype=np.float32))
        case["q"][r] = u.to(case["q"])
        for i in range(sq):
            blk, at = int(tables[r, (off + i) // bs]), (off + i) % bs
            case["k_pool"][blk, at] = (10.0 * (i + 1) * HD ** 0.5 * u
                                       / u.dot(u)).to(case["k_pool"])


def k2_limit(want) -> float:
    """K2's limit on max |kernel - plain|: the reference's absolute
    tolerance, and in bf16 also ``BF16_REL`` of the largest plain output
    (1.3-2.6 bf16 ulps of it; the kernel accumulates in fp32 and rounds
    once, so it is off by at most one ulp). The absolute 3e-2 alone is as
    large as a typical output of a long row, where a dropped or leaked key
    moves the output by less."""
    limit = TOL[want.dtype]
    if want.dtype == torch.bfloat16:
        limit = min(limit, BF16_REL * float(want.float().abs().max()))
    return limit


def k2_check(pa, dev, flush, card, dt, seed, case, heads=(HQ, HKV, HD)):
    """One K2 case (a ``CASES`` row) against the plain version, timed with
    its bound when the row says so. Returns (record, failure or None)."""
    name, sq, offsets, q_lens, window, bs, n_tbl, timed = case
    hq, hkv, hd = heads
    a = make_case(dev, dt, sq, offsets, q_lens, seed=seed, bs=bs,
                  n_tbl=n_tbl, needles=name.endswith("needles"), heads=heads)
    kw = dict(causal=True, window=window, q_lens=a["q_lens"])
    args = [a[n] for n in ("q", "k_pool", "v_pool", "block_tables",
                           "kv_offset", "kv_len")]
    # (the first version of K2, timed for comparison, keeps neither
    # variant counts nor a split plan)
    counts = getattr(pa, "variant_launches", {})
    before = dict(counts)
    got = pa.paged_attention_kernel(*args, **kw)
    torch.cuda.synchronize()
    variant = next((v for v, n in counts.items() if n > before[v]), None)
    want = pa.paged_attention_plain(*args, **kw)
    err = float((got.float() - want.float()).abs().max())
    limit = k2_limit(want)
    rec = dict(card=card, case=name, dtype=str(dt).split(".")[-1],
               variant=variant, b=len(offsets), sq=sq, window=window,
               block_size=bs, n_tbl=n_tbl, hq=hq, hkv=hkv, hd=hd,
               splits=pa.plan_splits(n_tbl, bs, sq, hq // hkv, variant)[1]
               if variant else None,
               max_abs_err=err, tol=TOL[dt], limit=limit,
               max_abs_plain=float(want.float().abs().max()))
    failure = None
    if not (bool(torch.isfinite(got).all()) and err < TOL[dt]
            and err <= limit):
        failure = (f"{name}/{rec['dtype']} ({variant}): max |kernel - "
                   f"plain| {err} (limit {limit})")
    if timed:
        ms = cuda_ms(lambda: pa.paged_attention_kernel(*args, **kw), flush)
        plain_ms = cuda_ms(lambda: pa.paged_attention_plain(*args, **kw),
                           flush)
        nbytes, ops, _, live = costs.paged_work(
            a["q"], a["k_pool"], a["block_tables"], offsets, q_lens, window)
        bound, by = costs.bound_s(nbytes, ops, dt)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * bound,
                   bound_by=by, live_kv_tokens=live, bytes=nbytes, ops=ops)
    return rec, failure


def phase2(pa, dev, flush, card):
    results, failed = [], []
    for dt in (torch.float32, torch.bfloat16):
        for i, case in enumerate(CASES):
            rec, failure = k2_check(pa, dev, flush, card, dt, i, case)
            if failure:
                failed.append(failure)
            results.append(rec)
            say("phase 2:", json.dumps(rec))
    assert not failed, "phase 2: " + "; ".join(failed)
    return results


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel vs its plain version
# ---------------------------------------------------------------------------

# name, b, sq, sk, hq, hkv, hd, causal, window, kv_offset; the first five
# are timed: the training path's shape and phase 13's static prefill (b 2
# rows a slot, 512-token prompts), then the same for zamba2-7b's shared
# block (MHA, 32 heads on 32, head_dim 112; phase 15), then bert-large's
# training call (b 8 rows a slot, non-causal); "masked_rows" has query
# rows 0-7 with no visible key (a zero output and gradient)
FLASH_CASES = [
    ("train2048", 1, 2048, 2048, HQ, HKV, HD, True, 0, 0),
    ("serve_prefill512", 2, 512, 512, HQ, HKV, HD, True, 0, 0),
    ("zamba2_train2048_hd112", 1, 2048, 2048, 32, 32, 112, True, 0, 0),
    ("zamba2_prefill512_hd112", 2, 512, 512, 32, 32, 112, True, 0, 0),
    ("bert_train512", 8, 512, 512, 16, 16, 64, False, 0, 0),
    ("ragged_sq33_mha", 2, 33, 33, 4, 4, 32, True, 0, 0),
    ("window24", 1, 128, 128, 8, 2, 16, True, 24, 0),
    ("offset32", 1, 16, 48, 4, 1, 16, True, 0, 32),
    ("ragged_sq100", 1, 100, 100, HQ, HKV, HD, True, 0, 0),
    ("offset64_hd64", 2, 72, 136, 8, 2, 64, True, 0, 64),
    ("masked_rows", 1, 40, 40, 4, 2, 16, True, 8, -8),
]


FLASH_TIMED = ("train2048", "serve_prefill512", "zamba2_train2048_hd112",
               "zamba2_prefill512_hd112", "bert_train512")


def flash_bound_s(q, k, v, **kw) -> float:
    """The least time one K1 launch could take on this card (s)."""
    nbytes, ops, _ = costs.flash_work(q, k, v, **kw)
    return costs.bound_s(nbytes, ops, q.dtype)[0]


def phase3(fa, ops, dev, flush, card):
    results, failed = [], []
    gen = torch.Generator(device=dev).manual_seed(7)
    for dt in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            rec = k1_check(fa, ops, dev, flush, card, gen, dt, case,
                           case[0] in FLASH_TIMED, failed)
            results.append(rec)
            say("phase 3:", json.dumps(rec))
    assert not failed, "phase 3: " + "; ".join(failed)
    step = phase3_train_step(fa, dev, card)
    say("phase 3: profiled train step:", json.dumps(step))
    return dict(cases=results, train_step=step)


def phase3_train_step(fa, dev, card):
    """One profiled train step of full-width chatglm3-6b at 2 fp32 layers
    (K 2, M 2, S 2, seq 512, remat, K1 on) with the step's tracer on: the
    card's records named ``flash_attention`` equal K1's forward launches,
    and the backward kernels' calls (``attention_bwd.launches``) equal the
    step's K1 backward calls (the tracer's ``k1_backward`` counter) and
    one per (trial, microbatch, layer) use."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.data.pipeline import TrainBatches
    from repro_torch.kernels import attention_bwd as bwd
    from repro_torch.models.layers import kernel_options
    from repro_torch.obs.tracer import Tracer
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    eng = pl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                          n_stages=2)
    seq, tracer = 512, Tracer(enabled=False)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, device=dev)
    opt = AdamW(grad_clip=1.0)
    state = opt.init(params)
    step = pl.make_train_step(cfg, kernel_options(cfg, remat=True), eng, opt,
                              tracer=tracer)
    data = TrainBatches(cfg, eng, seq, seed=3)
    batches = [data.batch_for_step(i) for i in range(2)]
    data.close()
    hp = {"lr": [1e-4, 3e-4], "wd": [0.0, 0.1]}
    step(params, state, batches[0], hp, 0)
    torch.cuda.synchronize()
    reset_counts(fa)
    reset_counts(bwd)
    tracer.enabled = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, metrics = step(params, state, batches[1], hp, 1)
        torch.cuda.synchronize()
    tracer.enabled = False
    kernels = device_kernels(prof)
    k1_records = sum(1 for n, _, _ in kernels if "flash_attention" in n)
    bwd_calls = sum(tracer.counters.get("k1_backward", {}).values())
    uses = eng.n_trials * eng.n_microbatches * cfg.n_layers
    rec = dict(card=card, arch=cfg.name, n_layers=cfg.n_layers,
               trials=eng.n_trials, microbatches=eng.n_microbatches,
               stages=eng.n_stages, seq=seq,
               k1_forward_launches=fa.launches, k1_records=k1_records,
               k1_backward_calls=bwd_calls,
               attention_bwd_launches=bwd.launches,
               attention_uses=uses,
               attention_bwd_kernel_ms=backward_kernel_ms(kernels),
               losses=[float(x) for x in metrics["loss"]])
    assert np.isfinite(rec["losses"]).all(), rec
    assert k1_records == fa.launches > 0, rec
    assert bwd.launches == bwd_calls == uses, rec
    reset_counts(bwd)
    return rec


def k1_check(fa, ops, dev, flush, card, gen, dt, case, timed, failed):
    """One K1 case (a ``FLASH_CASES`` row) against the plain version;
    timed with its bound and SDPA's time when ``timed``; in fp32 also the
    gradients of the op against autograd of the plain version. Failures
    go to ``failed``; returns the record."""
    import torch.nn.functional as F
    name, b, sq, sk, hq, hkv, hd, causal, window, off = case
    mk = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dt)
    q, k, v = mk(b, sq, hq, hd), mk(b, sk, hkv, hd), mk(b, sk, hkv, hd)
    kw = dict(causal=causal, window=window, kv_offset=off)
    got = fa.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    if not (bool(torch.isfinite(got).all()) and got.dtype == dt
            and err < FLASH_TOL[dt]):
        failed.append(f"{name}/{dt}: max |kernel - plain| {err}")
    rec = dict(card=card, case=name, dtype=str(dt).split(".")[-1], b=b,
               sq=sq, sk=sk, hq=hq, hkv=hkv, hd=hd, causal=causal,
               window=window, kv_offset=off, max_abs_err=err,
               tol=FLASH_TOL[dt])
    if timed:
        nbytes, ops_n, pairs = costs.flash_work(q, k, v, **kw)
        bound, by = costs.bound_s(nbytes, ops_n, dt)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rec.update(
            ms=cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, **kw),
                       flush),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                             flush),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), flush),
            bound_ms=1e3 * bound, bound_by=by,
            pairs=pairs, bytes=nbytes, ops=ops_n)
        lib = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        rec["library_max_abs_err"] = float(
            (lib.transpose(1, 2).float() - want.float()).abs().max())
    rec["backward"] = k1_backward_check(dev, flush, gen, q, k, v, kw, name,
                                        timed, failed)
    if dt == torch.float32:
        # gradients: the op (both kernels) against autograd of the plain
        # version
        ct = torch.randn(q.shape, generator=gen, device=dev)
        grads = []
        for fn in (ops.flash_attention, fa.flash_attention_plain):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            fn(*leaves, **kw).backward(ct)
            grads.append([x.grad for x in leaves])
        gerr = max(float((a - b_).abs().max()) / max(
            1.0, float(b_.abs().max())) for a, b_ in zip(*grads))
        # fp32 sums over up to 2048 keys in other orders: 2e-5 relative
        # to the gradient's largest entry
        if not (all(bool(torch.isfinite(g).all()) for g in grads[0])
                and gerr < 2e-5):
            failed.append(f"{name}: gradient error {gerr}")
        rec["grad_rel_err"] = gerr
    return rec


def backward_kernel_ms(kernels, calls: int = 1) -> dict:
    """Device ms of K1's backward kernels by name (``attn_bwd_*``, template
    arguments dropped) over ``device_kernels`` records, per call."""
    out: dict = {}
    for n, _, ms in kernels:
        if "attn_bwd_" in n:
            key = n[n.index("attn_bwd_"):].split("<")[0]
            out[key] = out.get(key, 0.0) + ms / calls
    return out


def k1_backward_check(dev, flush, gen, q, k, v, kw, name, timed, failed):
    """K1's backward kernels at one case against the plain backward
    (autograd through ``chunked_attention``) run in fp32 on the same
    values: each gradient within ``FLASH_TOL`` of its largest entry;
    finite, zero on rows with no visible key. ``timed``: the kernels'
    time (and each kernel's, from a profile of three calls) beside the
    bound of the five products, the plain backward's time in the case's
    dtype (what the port ran before) and SDPA's backward as a yardstick.
    Failures go to ``failed``; returns the record."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import attention_bwd as bwd
    from repro_torch.kernels import flash_attention as fa

    dt = q.dtype
    out = fa.flash_attention_kernel(q, k, v, **kw)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dt)
    got = bwd.attention_bwd_kernel(q, k, v, out, dout, **kw)
    want = bwd.attention_bwd_plain(*(t.float() for t in (q, k, v, out,
                                                         dout)), **kw)
    torch.cuda.synchronize()
    errs = [float((g.float() - w).abs().max()) / float(w.abs().max())
            for g, w in zip(got, want)]
    off = kw["kv_offset"]
    ok = (all(g.dtype == dt and bool(torch.isfinite(g).all()) for g in got)
          and max(errs) < FLASH_TOL[dt]
          and (off >= 0 or not got[0][:, :-off].any()))
    if not ok:
        failed.append(f"{name}/{dt}: backward errors {errs}")
    rec = dict(rel_err_dq_dk_dv=errs, tol=FLASH_TOL[dt])
    if timed:
        nbytes, ops_n, _ = costs.attention_bwd_work(q, k, v, **kw)
        bound, by = costs.bound_s(nbytes, ops_n, dt)
        run = lambda: bwd.attention_bwd_kernel(q, k, v, out, dout, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        per_kernel = backward_kernel_ms(device_kernels(prof), calls=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        lib = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
        lib_ct = dout.transpose(1, 2)
        # the plain backward's own device time (CUDA events around it
        # time its host enqueue: thousands of small ops)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bwd.attention_bwd_plain(q, k, v, out, dout, **kw)
            torch.cuda.synchronize()
        rec["plain_device_ms"] = sum(ms for _, _, ms in device_kernels(prof))
        rec.update(
            ms=cuda_ms(run, flush), kernel_ms=per_kernel,
            plain_ms=cuda_ms(lambda: bwd.attention_bwd_plain(
                q, k, v, out, dout, **kw), flush, iters=10, warmup=2),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib, (qt, kt, vt), lib_ct, retain_graph=True), flush),
            bound_ms=1e3 * bound, bound_by=by, bytes=nbytes, ops=ops_n)
    return rec


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serve engine
# ---------------------------------------------------------------------------


def trace4(vocab):
    """Phase 4's trace: 7 staggered requests of 17-70 prompt tokens and 2-6
    new tokens."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    shapes = [(40, 4), (70, 3), (33, 5), (64, 6), (17, 2), (50, 4), (29, 3)]
    return [Request(i, rng.integers(0, vocab, (p,)).astype(np.int32), g,
                    arrival=0.5 * i) for i, (p, g) in enumerate(shapes)]


def phase4(dev):
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import ServeEngine, blocks_for

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    max_seq = 80
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=2, max_seq=max_seq,
                          cache_dtype=torch.float32, prefill_chunks=2,
                          paged=True, block_size=BS,
                          n_blocks=4 * blocks_for(max_seq, BS))
    gen = torch.Generator(device=dev).manual_seed(1)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  dtype=torch.float32, device=dev)
    opts = ModelOptions(use_paged_kernel=True)
    reqs = trace4(cfg.vocab_size)
    engine = ServeEngine(cfg, eng, params, opts, device=dev)
    comps = engine.run([r.clone() for r in reqs])
    p1 = lm.layer_slice(params, 0)  # vocab 65024 is already a multiple of 2
    mismatches = 0
    for r, c in zip(reqs, comps):
        want = lm.greedy_generate(cfg, opts, p1, r.prompt, r.max_new_tokens,
                                  max_seq, torch.float32)
        mismatches += sum(a != b for a, b in zip(c.tokens, want))
        assert c.tokens == want, f"request {r.rid}: {c.tokens} != {want}"
    assert engine.allocator.all_free()
    rec = dict(requests=len(comps), tokens=sum(len(c.tokens) for c in comps),
               mismatches=mismatches, calls=engine.stats.calls,
               ticks=engine.stats.ticks)
    say("phase 4: full-width 2-layer fp32 engine (2 stages, 2 data shards) "
        "vs single-device oracle:", json.dumps(rec))
    return rec


def profile_call(fn):
    """Run ``fn()`` under the profiler, host and card; returns (its result,
    host ops, the card's events). Host ops: top-level aten calls (the count
    depends only on the model's structure, not on timing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    return out, host_ops(events), [e for e in events
                                   if e.device_type == DeviceType.CUDA]


def host_ops(events) -> int:
    """Top-level aten calls among a profile's events."""
    return sum(1 for e in events if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def profile_decode_call(engine, req, by_class=None):
    """(host ops, device busy ms) of one decode call, from a profile of the
    host and the card (:func:`profile_call`). Device busy: the summed
    durations of the call's kernels and copies on the card (None if the
    profiler recorded no device activity). ``by_class``, a dict, receives
    the busy ms by ``kernel_class``."""
    step, counts = engine.decode_step, []

    def counted(params, cache, batch):
        out, host, dev = profile_call(lambda: step(params, cache, batch))
        for e in dev if by_class is not None else ():
            c = kernel_class(e.name)
            by_class[c] = by_class.get(c, 0.0) + e.time_range.elapsed_us() / 1e3
        busy = sum(e.time_range.elapsed_us() for e in dev)
        counts.append((host, busy / 1e3 if dev else None))
        return out

    engine.decode_step = counted
    r = req.clone()
    r.max_new_tokens = 2  # prefill, then exactly one decode call
    engine.run([r])
    engine.decode_step = step
    assert counts, "no decode call was profiled"
    return counts[0]


# the kernels of K1 and K2, as the first version and the redesign name them
K1_KERNELS = ("flash_attention_kernel", "flash_attention_mma_kernel",
              "flash_attention_fp32_kernel")
K2_KERNELS = ("paged_attention_kernel", "split_kv_kernel", "combine_kernel",
              "append_mma_kernel")


def device_kernels(prof) -> list:
    """(name, start ns, ms) of every kernel and copy a finished profile
    recorded on the card, read from its raw records: parsing them into
    the profiler's event tree takes minutes for a run of several hundred
    thousand host ops and kernels."""
    return [(e.name(), e.start_ns(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events() if on_card(e)]


def on_card(e) -> bool:
    """A raw profiler record of work on the card: a kernel or a copy, not
    the card-side span the profiler mirrors of a ``record_function`` range
    (which covers the gaps between the range's kernels)."""
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA and not e.is_user_annotation()


def launch_bound_s(q, k_pool, v_pool, block_tables, kv_offset, kv_len,
                   causal=True, window=0, q_lens=None) -> float:
    """The least time one K2 launch could take on this card (s), as phase
    2 bounds a case: the larger of its bytes over the memory rate and its
    operations over the peak of q's dtype, counting what this launch's
    data needs (``costs.case_work`` over the rows whose table is
    allocated; in the engine kv_len is always kv_offset + q_len)."""
    nbytes, ops, _, _ = costs.paged_launch_work(q, k_pool, block_tables,
                                                kv_offset, window, q_lens)
    return costs.bound_s(nbytes, ops, q.dtype)[0]


def profile_k2_by_mode(pa, make_engine, reqs):
    """Run ``reqs`` through a fresh engine under the profiler; returns (the
    completions, the profiled wall s, {mode: launches, kernel_s,
    ms_per_launch}). The wrapper records the mode (decode or append call)
    of each of its launches in order; one stream runs kernels in launch
    order, so the n-th K2 main kernel on the card is the n-th launch's,
    and a combine kernel belongs to the main kernel before it. (Matching
    by order, not by the host's and the card's clocks; the last n main
    kernels are taken, so nothing recorded from before the run counts.)
    The host's activity is recorded too: a profile of the card's alone
    lost one kernel record in a few hundred thousand on an H100."""
    from bisect import bisect_right

    from torch.profiler import ProfilerActivity, profile

    engine = make_engine()
    real, mode, modes = pa.paged_attention_kernel, ["none"], []

    def recorded(*args, **kw):
        modes.append(mode[0])
        return real(*args, **kw)

    def in_mode(name, step):
        def run(*a):
            mode[0] = name
            try:
                return step(*a)
            finally:
                mode[0] = "none"
        return run

    engine.decode_step = in_mode("decode", engine.decode_step)
    engine.append_step = in_mode("append", engine.append_step)
    pa.paged_attention_kernel = recorded
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            comps = engine.run([r.clone() for r in reqs])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        pa.paged_attention_kernel = real
    assert "none" not in modes, "a K2 launch outside decode and append"
    k2 = [e for e in device_kernels(prof)
          if any(k in e[0] for k in K2_KERNELS)]
    main = sorted((e for e in k2 if "combine_kernel" not in e[0]),
                  key=lambda e: e[1])
    assert len(main) >= len(modes), (len(main), len(modes))
    main = main[len(main) - len(modes):]
    starts = [e[1] for e in main]
    dev_ms = {"decode": 0.0, "append": 0.0}
    for (_, _, ms), m in zip(main, modes):
        dev_ms[m] += ms
    for name, start, ms in k2:
        i = bisect_right(starts, start) - 1
        if "combine_kernel" in name and i >= 0:
            dev_ms[modes[i]] += ms
    calls = {m: modes.count(m) for m in ("decode", "append")}
    return comps, wall, {
        name: dict(launches=calls[name], kernel_s=dev_ms[name] / 1e3,
                   ms_per_launch=(dev_ms[name] / calls[name]
                                  if calls[name] else None))
        for name in ("decode", "append")}


def phase5(pa, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.models.layers import ModelOptions

    opts = ModelOptions(compute_dtype=torch.bfloat16, use_paged_kernel=True)
    rec, launches, _ = paged_serve_path(pa, get_config("chatglm3-6b"), opts,
                                        dev, card)
    say("phase 5: full chatglm3-6b bf16 paged serving:", json.dumps(rec))
    return rec, launches


def paged_serve_path(pa, cfg, opts, dev, card):
    """Phase 5's grid and traffic on ``cfg`` at full depth in bf16 through
    the paged engine with K2 (``opts``): 2 stages, 2 slots × microbatch 2,
    block 16, 8 requests of 128-1024 prompt tokens and 32 new tokens,
    split admission. Asserts every budget met, K2's launches = calls ×
    slots × layers, all decode launches split-KV and all append launches
    the tensor-core tile; records wall, tokens/s, ms per call by kind, K2's
    device time by mode (a profiled second run, whose tokens must equal),
    one profiled decode call and peak memory. Returns (record, launches,
    {eng, params, reqs} for more profiling)."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.serve import Request, ServeEngine, blocks_for

    bf16 = torch.bfloat16
    gen_len, max_seq = 32, 1024 + 32
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                          n_stages=2, max_seq=max_seq, cache_dtype=bf16,
                          prefill_chunks=2, paged=True, block_size=BS,
                          n_blocks=4 * blocks_for(max_seq, BS))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, dtype=bf16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = p5_trace(cfg.vocab_size)

    times = {"decode": [], "append": []}
    append_tokens, chunk_lens = [], set()

    def timed(name, step):
        def run(params, cache, batch):
            t = time.perf_counter()
            out = step(params, cache, batch)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            if name == "append":
                append_tokens.append(int(batch["active"].sum())
                                     * batch["tokens"].shape[-1])
                chunk_lens.add(int(batch["tokens"].shape[-1]))
            return out
        return run

    engine = ServeEngine(cfg, eng, params, opts, device=dev)
    engine.decode_step = timed("decode", engine.decode_step)
    engine.append_step = timed("append", engine.append_step)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(pa)  # count the main path's launches only
    t0 = time.perf_counter()
    comps = engine.run([r.clone() for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    variants = dict(getattr(pa, "variant_launches", {}))
    st = engine.stats
    assert [c.rid for c in comps] == [r.rid for r in reqs]
    for r, c in zip(reqs, comps):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    expected = st.calls * eng.n_slots * cfg.n_layers
    assert launches == expected > 0, (launches, expected)

    # K2's device time by mode, from a profiled second run of the same
    # trace: the kernels' own durations on the card (CUDA events around
    # the wrapper would also count the host's enqueue time, since the card
    # idles between this host-bound loop's launches), each attributed to
    # the decode or append call it ran in
    t_run = time.perf_counter() - t0
    comps2, wall2, by_mode = profile_k2_by_mode(
        pa, lambda: ServeEngine(cfg, eng, params, opts, device=dev), reqs)
    t_prof = time.perf_counter() - t0 - t_run
    kernel_s = sum(v["kernel_s"] for v in by_mode.values())
    for v in by_mode.values():
        v["share_of_wall"] = v["kernel_s"] / wall
    assert [c.tokens for c in comps2] == [c.tokens for c in comps], \
        "the same trace gave different tokens on a second run"
    busy_by_class = {}
    ops_per_decode, busy_ms = profile_decode_call(
        ServeEngine(cfg, eng, params, opts, device=dev), reqs[0],
        busy_by_class)
    t_call = time.perf_counter() - t0 - t_run - t_prof
    decode_ms = 1e3 * float(np.median(times["decode"]))
    rec = dict(
        card=card, arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype="bfloat16",
        stages=eng.n_stages, slots=eng.n_microbatches,
        microbatch=eng.microbatch, requests=len(comps),
        prompt_tokens=st.prompt_tokens, tokens_generated=st.tokens_generated,
        ticks=st.ticks, calls=st.calls, decode_calls=len(times["decode"]),
        append_calls=len(times["append"]), kernel_launches=launches,
        expected_launches=expected, wall_s=wall,
        generated_tok_per_s=st.tokens_generated / wall,
        decode_ms_per_call=decode_ms,
        decode_ms_per_call_mean=1e3 * float(np.mean(times["decode"])),
        prefill_chunk_ms_per_call=1e3 * float(np.mean(times["append"])),
        prefill_tokens_per_s=sum(append_tokens) / sum(times["append"]),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        kernel_share_of_wall=kernel_s / wall, kernel_s=kernel_s,
        kernel_by_mode=by_mode, variant_launches=variants,
        append_chunk_lens=sorted(chunk_lens),
        append_ms_per_call=1e3 * float(np.median(times["append"])),
        host_ops_per_decode_call=ops_per_decode,
        decode_device_busy_ms=busy_ms,
        decode_device_busy_ms_by_class=busy_by_class,
        decode_device_idle_share=(None if busy_ms is None
                                  else 1.0 - busy_ms / decode_ms),
        profiled_wall_s=wall2, param_init_s=init_s,
        ttft_p50_ticks=st.summary().get("ttft_p50"),
        seconds=dict(run=t_run, k2_by_mode_profile=t_prof,
                     decode_call_profile=t_call))
    if variants:  # decode calls take split-KV, bf16 append chunks the tile
        slots_layers = eng.n_slots * cfg.n_layers
        assert variants == {
            "split_kv": len(times["decode"]) * slots_layers,
            "append_mma": len(times["append"]) * slots_layers}, variants
    return rec, launches, dict(eng=eng, params=params, reqs=reqs)


# ---------------------------------------------------------------------------
# Phases 6 and 7: training
# ---------------------------------------------------------------------------

TRAIN_HP = {"lr": [3e-3, 1e-3], "wd": [0.0, 0.01]}


def sequential_reference(cfg, params_host, batches, eval_batch, k, dev,
                         hp=TRAIN_HP, ref_opts=None, n_shards=1):
    """Trial k trained alone: its own unpipelined objective (plain
    attention and the chunked scan under ``ref_opts``, default
    ``ModelOptions()``) — the reference oracle's: the mean over
    (microbatch, data shard) of the single-device CE, plus for the moe
    family coef times the mean of each shard's aux — its true gradient
    norm, the same AdamW with trial k's row of ``hp``. The forward reads
    the real vocab of the (stage-padded) table; the padded rows stay
    leaves, so the parameters compare leaf by leaf. Returns (per-step CE
    losses, the CE on ``eval_batch`` after the last update, final params
    on the host, the first step's gradient on the host)."""
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    ref_opts = ref_opts or ModelOptions()
    p = tree_map(lambda t: t[k].to(dev, copy=True).requires_grad_(),
                 params_host)
    stacked = lambda tree: tree_map(lambda t: t[None], tree)
    opt = AdamW(grad_clip=1.0)
    state = opt.init(stacked(p))
    hp = {n: v[k:k + 1] for n, v in hp.items()}
    v = cfg.vocab_size

    def loss_of(batch):
        """(CE, objective) of one batch."""
        fwd = dict(p, embed=dict(p["embed"], tok=p["embed"]["tok"][:v]),
                   head=p["head"][:, :v])
        ces, auxes = [], []
        for m in range(batch["tokens"].shape[1]):
            # each data shard's rows alone (frontend embeddings along
            # rows; M-RoPE positions (3, mbg, seq) along their axis 1)
            sub = {n: torch.from_numpy(np.ascontiguousarray(
                batch[n][k, m])).to(dev).chunk(n_shards,
                                               dim=int(n == "mrope_pos"))
                for n in ("tokens", "labels", "frontend_embeds",
                          "mrope_pos") if n in batch}
            for i in range(n_shards):
                shard = {n: c[i] for n, c in sub.items()}
                logits, _, aux = lm.forward(cfg, ref_opts, fwd, shard)
                ces.append(lm.cross_entropy(logits, shard["labels"]))
                auxes.append(aux)
        ce = sum(ces) / len(ces)
        if cfg.moe is None:
            return ce, ce
        return ce, ce + cfg.moe.load_balance_coef * sum(auxes) / len(auxes)

    losses, first = [], None
    for step, batch in enumerate(batches):
        loss, objective = loss_of(batch)
        objective.backward()
        grads = tree_map(lambda t: t.grad[None], p)
        if step == 0:
            first = tree_map(lambda t: t[0].to("cpu", copy=True), grads)
        sq = [torch.linalg.vector_norm(g).square()
              for g in tree_leaves(grads)]
        opt.update(stacked(p), grads, state, hp, step,
                   grad_norm=torch.sqrt(sum(sq)).reshape(1))
        tree_map(lambda t: t.grad.zero_(), p)
        losses.append(loss.item())
    with torch.no_grad():
        final_loss = loss_of(eval_batch)[0].item()
    return losses, final_loss, tree_map(
        lambda t: t.detach().to("cpu", copy=True), p), first


def train_vs_sequential(cfg, opts, seq, seed, dev, card, hp=TRAIN_HP,
                        ref_opts=None, data_size=1):
    """K = 2 trials, 2 stages, 2 microbatches of one row per data shard
    (``data_size`` shards), 2 steps of the pipelined train step under
    ``opts`` (the kernels on) against K independent unpipelined runs
    through the plain versions (``ref_opts``; see
    :func:`sequential_reference`), per-trial learning rates
    and weight decays ``hp``: losses, and each trial's loss on a held-out
    batch after the last update, within 2e-4; parameters within 5e-3;
    each trial's parameter change within 10 % of the sequential run's;
    and, before any optimizer step, each leaf of each trial's first
    gradient within 1e-3 of its largest entry (fp32 sums in other orders:
    up to 5e-5 on an NVIDIA H100 80GB HBM3 at 700 W,
    scripts/train_step_sensitivity.py; a lost contribution, such as one
    stage's share of a shared block's gradient, is of the order of 1)."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.data.pipeline import TrainBatches
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    eng = pl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=data_size)
    n_steps = 2
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  device=dev, max_pos=seq)
    host0 = tree_map(lambda t: t.to("cpu", copy=True), params)
    data = TrainBatches(cfg, eng, seq, seed=0)
    # the last batch is held out: both runs' losses after the last update
    *batches, eval_batch = [data.batch_for_step(i)
                            for i in range(n_steps + 1)]
    data.close()
    opt = AdamW(grad_clip=1.0)
    state = opt.init(params)
    first = {}

    class Capture:  # the optimizer, keeping the first step's gradient
        def update(self, params_, grads, *a, **kw):
            if not first:
                first["grads"] = tree_map(lambda t: t.to("cpu", copy=True),
                                          grads)
            return opt.update(params_, grads, *a, **kw)

    step = pl.make_train_step(cfg, opts, eng, Capture())
    pipe_losses = []
    for i, batch in enumerate(batches):
        params, state, met = step(params, state, batch, hp, i)
        pipe_losses.append(met["loss"].tolist())
    with torch.no_grad():
        pipe_final = pl.pipeline_train_loss(cfg, opts, eng, params,
                                            eval_batch)[0].tolist()
    pipe_params = tree_map(lambda t: t.to("cpu", copy=True), params)
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    loss_err = param_err = 0.0
    change_err, grad_err = [], []
    for k in range(eng.n_trials):
        ref_losses, ref_final, ref_params, ref_grads = sequential_reference(
            cfg, host0, batches, eval_batch, k, dev, hp, ref_opts,
            data_size)
        grad_err.append(max(
            float((a[k] - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(tree_leaves(first["grads"]),
                            tree_leaves(ref_grads))))
        loss_err = max(loss_err, abs(pipe_final[k] - ref_final), max(
            abs(a[k] - b) for a, b in zip(pipe_losses, ref_losses)))
        leaves = list(zip(tree_leaves(host0), tree_leaves(pipe_params),
                          tree_leaves(ref_params)))
        param_err = max(param_err, max(float((a[k] - b).abs().max())
                                       for _, a, b in leaves))
        # trial k's parameter change, pipelined against sequential,
        # relative to the size of the sequential change: a dropped or
        # doubled last update moves it by about 1 / n_steps
        change_err.append(
            max(float((a[k] - b).abs().max()) for _, a, b in leaves)
            / max(float((b - p0[k]).abs().max()) for p0, _, b in leaves))
        gc.collect()
        torch.cuda.empty_cache()
    rec = dict(card=card, arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, trials=eng.n_trials, stages=eng.n_stages,
               microbatches=eng.n_microbatches, data_shards=data_size,
               seq=seq, steps=n_steps,
               pipelined_losses=pipe_losses, pipelined_final_losses=pipe_final,
               max_loss_err=loss_err, max_param_err=param_err,
               param_change_rel_err=change_err,
               first_grad_rel_err=grad_err, lr=list(hp["lr"]),
               wd=list(hp["wd"]))
    say(f"training exactness, {cfg.name}:", json.dumps(rec))
    assert max(grad_err) < 1e-3, f"first-step gradient error {grad_err}"
    assert loss_err < 2e-4, f"loss error {loss_err}"
    assert param_err < 5e-3, f"param error {param_err}"
    assert max(change_err) < 0.1, f"parameter change error {change_err}"
    return rec


def phase6(dev, card):
    from repro_torch.configs import get_config
    from repro_torch.models.layers import ModelOptions

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    rec = train_vs_sequential(
        cfg, ModelOptions(remat=True, use_flash_kernel=True), 512, 3, dev,
        card)
    say("phase 6: pipelined train step (flash kernel) vs sequential "
        "single-trial runs:", json.dumps(rec))
    return rec


def model_flops_per_step(cfg, eng, seq):
    """Model FLOPs of one train step (no remat recompute counted): 6 per
    matmul weight per token (forward + backward), plus 3 times each
    forward's other work: attention's 4·hd·hq per attended pair (causal,
    or all seq² for the encoder);
    Mamba1's scan, 4·di·n per token (decay and input, then C·h); Mamba2's
    chunked SSD, 2·ck·nh·(n + hd) per token within its chunk of ck plus
    4·nh·hd·n for the state in and out. A hybrid arch's shared block
    counts once per site it runs at. A moe layer counts its router and
    the top_k experts a token runs through (the reference's
    ``layer_flops_per_token``), not the capacity-padded buckets."""
    tokens = eng.n_trials * eng.n_microbatches * eng.mb_global * seq
    d, L = cfg.d_model, cfg.n_layers
    # causal: seq (seq + 1) / 2 pairs a sequence; the encoder attends all
    pairs = seq * seq if cfg.family == "encoder" else seq * (seq + 1) // 2
    attn = lambda n: 3 * 4 * cfg.head_dim * cfg.n_heads * pairs * n
    head = d * cfg.vocab_size
    if cfg.family == "ssm":
        s = cfg.ssm
        di, n, r = s.d_inner(d), s.d_state, s.resolved_dt_rank(d)
        matmul = L * (d * 2 * di + di * (r + 2 * n) + r * di + di * d) + head
        return 6 * matmul * tokens + 3 * 4 * di * n * L * tokens
    if cfg.family == "hybrid":
        from repro_torch.models import lm
        s = cfg.ssm
        di, n, g, hd = s.d_inner(d), s.d_state, s.n_groups, s.head_dim
        nh, ck = s.n_ssm_heads(d), min(s.chunk_size, seq)
        sites = sum(lm.shared_site_flags(cfg, 0, L)[0])
        shared = (4 * d * cfg.n_heads * cfg.head_dim
                  + 3 * d * cfg.hybrid.shared_d_ff)
        matmul = (L * (d * (2 * di + 2 * g * n + nh) + di * d)
                  + sites * shared + head)
        ssd = 2 * ck * nh * (n + hd) + 4 * nh * hd * n
        return (6 * matmul * tokens + 3 * ssd * L * tokens
                + attn(sites) * tokens // seq)
    if cfg.family == "moe":
        m = cfg.moe
        qkvo = d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        matmul = L * (qkvo + d * m.n_experts
                      + m.top_k * 3 * d * m.expert_d_ff) + head
        return 6 * matmul * tokens + attn(L) * tokens // seq
    matmul = L * (cfg.layer_param_count() - 2 * d) + head
    return 6 * matmul * tokens + attn(L) * tokens // seq


def moe_padded_flops_per_step(cfg, eng, seq, capacity_factor):
    """The expert work a train step really does beyond
    :func:`model_flops_per_step`: every routing group (one data shard's
    rows of one slot, t tokens) runs its experts over E · C bucket rows,
    C = max(int(cf · t · k / E), k), where the model counts t · k."""
    m = cfg.moe
    t = eng.microbatch * seq
    cap = max(int(capacity_factor * t * m.top_k / m.n_experts), m.top_k)
    groups = eng.n_trials * eng.n_microbatches * eng.data_size
    extra = (m.n_experts * cap - t * m.top_k) * groups * cfg.n_layers
    return model_flops_per_step(cfg, eng, seq) + 6 * 3 * cfg.d_model \
        * m.expert_d_ff * extra


def kernel_class(name: str) -> str:
    n = name.lower()
    if any(k in name for k in K1_KERNELS):
        return "k1_flash_attention"
    if "attn_bwd_" in name:
        return "k1_backward"
    if any(k in name for k in K2_KERNELS):
        return "k2_paged_attention"
    if any(t in n for t in ("gemm", "gemv", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    if "memcpy" in n or "memset" in n:
        return "copy_memset"
    return "other"


def profile_train_step(cfg, opts, eng, seq, dev, moe=False):
    """Device time by kernel class over one more train step of the planned
    gang (fresh weights from a seed; one warm step first, which allocates
    the gradient buffer): the summed durations of the step's kernels and
    copies on the card, from a profile with CUDA activity. ``moe``: also
    the busy time by region (:func:`busy_by_region`: the experts, the
    routing and dispatch, K1, the rest)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.data.pipeline import TrainBatches
    from repro_torch.optim.adamw import AdamW

    gen = torch.Generator(device=dev).manual_seed(0)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, device=dev, max_pos=seq)
    opt = AdamW(grad_clip=1.0)
    state = opt.init(params)
    step = pl.make_train_step(cfg, opts, eng, opt)
    data = TrainBatches(cfg, eng, seq, seed=0)
    batches = [data.batch_for_step(i) for i in range(2)]
    data.close()
    hp = {"lr": [3e-3 * 0.5 ** i for i in range(eng.n_trials)],
          "wd": [0.0] * eng.n_trials}
    step(params, state, batches[0], hp, 0)
    torch.cuda.synchronize()
    with (moe_annotated() if moe else contextlib.nullcontext()), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, state, batches[1], hp, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_class, kernels = {}, device_kernels(prof)
    for name, _, ms in kernels:
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + ms
    out = dict(profiled_step_ms=1e3 * wall, device_kernels=len(kernels),
               device_busy_ms=sum(by_class.values()),
               busy_ms_by_class=by_class)
    if moe:
        out["busy_ms_by_region"], out["top_routing_kernels"] = \
            busy_by_region(prof, K1_KERNELS, "k1")
    return out


def selection_path(kmod, kernel_name, cfg, opts, seq, n_steps, expected_of,
                   dev, card, profile=True, moe=False, n_trials=2,
                   microbatch=1):
    """``run_model_selection`` as ``launch/train.py`` calls it on ``cfg``:
    ``n_trials`` trials, 2 stages, ``microbatch`` rows a slot, ``n_steps``
    steps at ``seq``, fp32, the planner choosing the microbatch count.
    Asserts every trial trains in one gang,
    the kernel's launches (``kmod``, wrapper ``kernel_name``) equal
    ``expected_of(K, M, S)``, 0 restarts and finite losses; records step
    time, tokens/s, model FLOP/s, the kernel's share of step time (CUDA
    events around each launch inside the steps), peak memory beside the
    planner's estimate and, with ``profile``, a profiled step's device
    time by kernel class (two more steps on fresh weights; with ``moe``
    also by region). Returns (record, launches)."""
    from repro_torch.core import hydra
    from repro_torch.core import pipeline as pl
    from repro_torch.core.scheduler import per_chip_bytes, state_bytes
    from repro_torch.core.trials import grid_search
    from repro_torch.obs.tracer import Tracer

    base = pl.EngineConfig(n_trials=n_trials, n_microbatches=4,
                           microbatch=microbatch, n_stages=2)
    hc = hydra.HydraConfig(seq_len=seq, steps=n_steps)
    trials = grid_search(cfg.name,
                         [3e-3 * 0.5 ** i for i in range(n_trials)])

    step_s, in_step, events = [], [False], []
    real_make, real_kernel = pl.make_train_step, getattr(kmod, kernel_name)

    def timed_make(*a, **kw):
        fn = real_make(*a, **kw)

        def step(*sa, **skw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            in_step[0] = True
            out = fn(*sa, **skw)
            torch.cuda.synchronize()
            in_step[0] = False
            step_s.append(time.perf_counter() - t)
            return out
        return step

    def evented(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = real_kernel(*a, **kw)
        e.record()
        if in_step[0]:
            events.append((s, e))
        return out

    tracer = Tracer()
    pl.make_train_step = timed_make
    setattr(kmod, kernel_name, evented)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kmod)  # count the training path's launches only
    t0 = time.perf_counter()
    try:
        out = hydra.run_model_selection(cfg, opts, hc, trials, base,
                                        tracer=tracer, device=dev)
    finally:
        pl.make_train_step = real_make
        setattr(kmod, kernel_name, real_kernel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kmod.launches
    variants = dict(getattr(kmod, "variant_launches", {}))
    peak = torch.cuda.max_memory_allocated()
    gang = [e for e in tracer.events if e["ev"] == "span_begin"
            and e["name"] == "gang"]
    ends = [e for e in tracer.events if e["ev"] == "span_end"
            and e["name"] == "gang"]
    assert len(gang) == 1 and gang[0]["n_trials"] == n_trials, gang
    K, M = gang[0]["n_trials"], gang[0]["n_microbatches"]
    S, L = base.n_stages, cfg.n_layers
    expected = expected_of(K, M, S)
    assert launches == expected > 0, (launches, expected)
    assert [e["restarts"] for e in ends] == [0], ends
    res = out["all"]
    assert len(res) == n_trials and all(np.isfinite(r.train_loss)
                                 and np.isfinite(r.val_loss) for r in res)
    eng = dataclasses.replace(base, n_trials=K, n_microbatches=M)
    steady = step_s[1:]
    step_ms = 1e3 * float(np.median(steady))
    flops = model_flops_per_step(cfg, eng, seq)
    kernel_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    rec = dict(
        card=card, arch=cfg.name, layers=L, d_model=cfg.d_model,
        dtype="float32", params_per_trial=cfg.param_count(), trials=K,
        microbatches=M, stages=S, microbatch=base.microbatch, seq=seq,
        steps=n_steps, bubble_fraction=eng.bubble_fraction, step_ms=step_ms,
        step_ms_all=[1e3 * x for x in step_s],
        tokens_per_step=K * M * base.microbatch * seq,
        tokens_per_s=K * M * base.microbatch * seq / (step_ms / 1e3),
        model_flops_per_step=flops,
        model_tflops_per_s=flops / (step_ms / 1e3) / 1e12,
        share_of_fp32_peak=flops / (step_ms / 1e3) / PEAK_OPS[torch.float32],
        kernel_launches=launches, expected_launches=expected,
        variant_launches=variants, kernel_s_in_steps=kernel_s,
        kernel_share_of_step_time=kernel_s / sum(step_s),
        max_memory_allocated_gb=peak / 1e9,
        # the planner's memory model for the gang: per stage and trial,
        # times K trials and the S stages that share the card
        planner_estimate_gb=per_chip_bytes(
            cfg, eng, seq, True, **state_bytes(hc.param_dtype)).total
        * K * S / 1e9,
        restarts=ends[0]["restarts"],
        results=[dict(tag=r.spec.tag, lr=r.spec.lr, train_loss=r.train_loss,
                      val_loss=r.val_loss) for r in res],
        best_trial=out["best"].spec.tag, wall_s=wall)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    if profile:
        prof = profile_train_step(cfg, opts, eng, seq, dev, moe)
        prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / step_ms
        rec["profile"] = prof
    return rec, launches


def phase7(fa, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.models.layers import kernel_options

    # as launch/train.py --n-layers 4 --trials 2 --steps 3 --n-model 2
    # --seq-len 2048 builds it
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=4)
    L, n_steps = cfg.n_layers, 3

    def expected(K, M, S):
        # per train step every layer's forward runs 3 times per (trial,
        # microbatch) slot — forward, the (stage, slot) recompute (tick
        # remat), the layer recompute (layer remat) — except that torch's
        # checkpoint early stop skips the layer recompute of the last
        # layer of each stage before the last; the evaluation pass runs
        # each layer once per slot
        return n_steps * K * M * (3 * L - (S - 1)) + K * M * L

    rec, launches = selection_path(fa, "flash_attention_kernel", cfg,
                                   kernel_options(cfg, remat=True), 2048,
                                   n_steps, expected, dev, card)
    say(f"phase 7: gang plan K={rec['trials']} M={rec['microbatches']} "
        f"(S={rec['stages']}, bubble {rec['bubble_fraction']:.4f})")
    say("phase 7: run_model_selection, chatglm3-6b 4 layers fp32:",
        json.dumps(rec))
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 8: the selective-scan kernel vs its plain version
# ---------------------------------------------------------------------------

# name, b, s, di, n, strided C (C as the last n columns of a (b, s, r + 2n)
# projection with r = 256, falcon-mamba-7b's dt rank)
SCAN_CASES = [
    ("path512", 2, 512, 8192, 16, False),
    ("ragged_s37", 2, 37, 8192, 16, False),
    ("strided_c", 2, 64, 8192, 16, True),
    ("n8_s7", 1, 7, 64, 8, False),
]


def scan_inputs(dev, dt, b, s, di, n, strided, gen):
    """The reference test's distributions: decays in (0, 1], small inputs,
    a nonzero incoming state."""
    da = torch.exp(-(torch.randn(b, s, di, n, generator=gen, device=dev)
                     * 0.3).abs()).to(dt)
    dbx = (torch.randn(b, s, di, n, generator=gen, device=dev) * 0.2).to(dt)
    if strided:
        proj = torch.randn(b, s, 256 + 2 * n, generator=gen, device=dev)
        cmat = proj.to(dt)[..., 256 + n:]
        assert not cmat.is_contiguous()
    else:
        cmat = torch.randn(b, s, n, generator=gen, device=dev).to(dt)
    h0 = torch.randn(b, di, n, generator=gen, device=dev) * 0.1
    return da, dbx, cmat, h0


def phase8(ms, ops, dev, flush, card):
    results = []
    gen = torch.Generator(device=dev).manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        for name, b, s, di, n, strided in SCAN_CASES:
            args = scan_inputs(dev, dt, b, s, di, n, strided, gen)
            y, h = ms.mamba_scan_kernel(*args)
            torch.cuda.synchronize()
            y2, h2 = ms.mamba_scan_plain(*args)
            assert y.dtype == dt and h.dtype == torch.float32, name
            assert torch.isfinite(y).all() and torch.isfinite(h).all(), name
            err = max(float((y.float() - y2.float()).abs().max()),
                      float((h - h2).abs().max()))
            assert err < SCAN_TOL[dt], f"{name}/{dt}: max |kernel - plain| " \
                f"{err}"
            rec = dict(card=card, case=name, dtype=str(dt).split(".")[-1],
                       b=b, s=s, di=di, n=n, strided_c=strided,
                       max_abs_err=err, tol=SCAN_TOL[dt])
            if name == "path512":
                nbytes, ops_n = costs.scan_work(*args)
                # fp32 arithmetic whatever the input dtype
                bound, by = costs.bound_s(nbytes, ops_n, torch.float32)
                rec.update(
                    ms=cuda_ms(lambda: ms.mamba_scan_kernel(*args), flush),
                    plain_ms=cuda_ms(lambda: ms.mamba_scan_plain(*args),
                                     flush, iters=10, warmup=2),
                    library_ms=None, bound_ms=1e3 * bound, bound_by=by,
                    bytes=nbytes, ops=ops_n)
            results.append(rec)
            say("phase 8:", json.dumps(rec))
            del args, y, h, y2, h2
    # gradients: the op (kernel forward, backward through the plain
    # version) against autograd of the plain version
    args = scan_inputs(dev, torch.float32, 2, 37, 256, 16, True, gen)
    cts = (torch.randn(2, 37, 256, generator=gen, device=dev),
           torch.randn(2, 256, 16, generator=gen, device=dev))
    grads = []
    for fn in (ops.mamba_scan, ms.mamba_scan_plain):
        leaves = [t.detach().requires_grad_() for t in args]
        torch.autograd.backward(fn(*leaves), cts)
        grads.append([t.grad for t in leaves])
    gerr = max(float((a - b_).abs().max()) / max(1.0, float(b_.abs().max()))
               for a, b_ in zip(*grads))
    assert all(torch.isfinite(g).all() for g in grads[0])
    assert gerr < 1e-4, f"scan gradient error {gerr}"
    say("phase 8: op gradients vs plain autograd, max relative error",
        gerr)
    return results, gerr


# ---------------------------------------------------------------------------
# Phases 9 and 10: SSM serving through the dense engine
# ---------------------------------------------------------------------------


def dense_engine(cfg, dtype, dev, seed, max_seq):
    """A recurrent family (falcon-mamba-7b, zamba2-7b) behind the dense
    ServeEngine as launch/serve.py builds it: 2 stages, 2 slots x
    microbatch 2, split admission with 2 prefill chunks, the kernels on by
    family (K3 in every ssm append; K1 in the hybrid shared block's
    full-sequence prefills, which the engine's appends do not make)."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models.layers import kernel_options
    from repro_torch.serve import ServeEngine

    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                          n_stages=2, max_seq=max_seq, cache_dtype=dtype,
                          prefill_chunks=2)
    opts = kernel_options(cfg, compute_dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, dtype=dtype, device=dev)
    return eng, opts, params, lambda: ServeEngine(cfg, eng, params, opts,
                                                  device=dev)


def phase9(ms, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import Request

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    max_seq = 80
    eng, _, params, make = dense_engine(cfg, torch.float32, dev, 9, max_seq)
    rng = np.random.default_rng(9)
    shapes = [(40, 4), (70, 3), (33, 5), (64, 6), (17, 2), (50, 4), (29, 3)]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                    g, arrival=0.5 * i) for i, (p, g) in enumerate(shapes)]
    engine = make()
    appends, resets = [], []
    step, reset = engine.append_step, engine.reset_fn

    def counted_append(params_, cache, batch):
        appends.append(batch["tokens"].shape[-1])
        return step(params_, cache, batch)

    def checked_reset(cache, mask):
        cache = reset(cache, mask)
        for k, g, b in torch.as_tensor(mask).nonzero().tolist():
            for buf in cache["layers"].values():
                assert not buf[k, g, :, b].any(), "a reset row is not zero"
        resets.append(int(np.asarray(mask).sum()))
        return cache

    engine.append_step, engine.reset_fn = counted_append, checked_reset
    ms.launches = 0  # count this path's launches only
    comps = engine.run([r.clone() for r in reqs])
    torch.cuda.synchronize()
    launches = ms.launches
    expected = len(appends) * eng.n_slots * cfg.n_layers
    assert min(appends) > 1  # every chunk is a scan (s == 1 is a step)
    assert launches == expected > 0, (launches, expected)
    assert sum(resets) == len(reqs) > engine.batcher.n_cells  # recycled
    p1 = lm.layer_slice(params, 0)  # vocab 65024 is already a multiple of 2
    mismatches = 0
    for r, c in zip(reqs, comps):
        want = lm.greedy_generate(cfg, ModelOptions(), p1, r.prompt,
                                  r.max_new_tokens, max_seq, torch.float32)
        mismatches += sum(a != b for a, b in zip(c.tokens, want))
        assert c.tokens == want, f"request {r.rid}: {c.tokens} != {want}"
    rec = dict(card=card, layers=cfg.n_layers, d_model=cfg.d_model,
               requests=len(comps), tokens=sum(len(c.tokens) for c in comps),
               mismatches=mismatches, calls=engine.stats.calls,
               append_calls=len(appends), ticks=engine.stats.ticks,
               kernel_launches=launches, expected_launches=expected,
               reset_rows=sum(resets))
    say("phase 9: full-width 2-layer fp32 falcon-mamba-7b dense engine vs "
        "single-device oracle (chunked scan):", json.dumps(rec))
    return rec


def phase10(ms, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.serve import Request

    cfg = get_config("falcon-mamba-7b")
    bf16 = torch.bfloat16
    gen_len, max_seq = 32, 1024 + 32
    t0 = time.perf_counter()
    eng, _, params, make = dense_engine(cfg, bf16, dev, 0, max_seq)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)  # phase 5's traffic
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(p),))
                    .astype(np.int32), gen_len, arrival=float(i))
            for i, p in enumerate(rng.integers(128, 1025, 8))]

    times = {"decode": [], "append": []}
    append_tokens = []

    def timed(name, step):
        def run(params_, cache, batch):
            t = time.perf_counter()
            out = step(params_, cache, batch)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            if name == "append":
                append_tokens.append(int(batch["active"].sum())
                                     * batch["tokens"].shape[-1])
            return out
        return run

    engine = make()
    engine.decode_step = timed("decode", engine.decode_step)
    engine.append_step = timed("append", engine.append_step)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms.launches = 0  # count the main path's launches only
    t0 = time.perf_counter()
    comps = engine.run([r.clone() for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ms.launches
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    assert [c.rid for c in comps] == [r.rid for r in reqs]
    for r, c in zip(reqs, comps):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    expected = len(times["append"]) * eng.n_slots * cfg.n_layers
    assert launches == expected > 0, (launches, expected)

    # K3's share of wall time, from a second run of the same trace with
    # CUDA events around each launch (kept out of the timed run above)
    real, events = ms.mamba_scan_kernel, []

    def evented(*args, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*args, **kw)
        e.record()
        events.append((s, e))
        return out

    ms.mamba_scan_kernel = evented
    try:
        again = make()
        t1 = time.perf_counter()
        comps2 = again.run([r.clone() for r in reqs])
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t1
    finally:
        ms.mamba_scan_kernel = real
    kernel_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    assert [c.tokens for c in comps2] == [c.tokens for c in comps], \
        "the same trace gave different tokens on a second run"
    ops_per_decode, busy_ms = profile_decode_call(again, reqs[0])
    decode_ms = 1e3 * float(np.median(times["decode"]))
    rec = dict(
        card=card, layers=cfg.n_layers, d_model=cfg.d_model,
        d_inner=cfg.ssm.d_inner(cfg.d_model), dtype="bfloat16",
        params=cfg.param_count(), stages=eng.n_stages,
        slots=eng.n_microbatches, microbatch=eng.microbatch,
        requests=len(comps), prompt_tokens=st.prompt_tokens,
        tokens_generated=st.tokens_generated, ticks=st.ticks,
        calls=st.calls, decode_calls=len(times["decode"]),
        append_calls=len(times["append"]), kernel_launches=launches,
        expected_launches=expected, wall_s=wall,
        generated_tok_per_s=st.tokens_generated / wall,
        decode_ms_per_call=decode_ms,
        decode_ms_per_call_mean=1e3 * float(np.mean(times["decode"])),
        append_ms_per_call=1e3 * float(np.median(times["append"])),
        append_ms_per_call_mean=1e3 * float(np.mean(times["append"])),
        prefill_tokens_per_s=sum(append_tokens) / sum(times["append"]),
        max_memory_allocated_gb=peak / 1e9,
        kernel_share_of_wall=kernel_s / wall2, kernel_s=kernel_s,
        kernel_ms_per_launch=1e3 * kernel_s / max(len(events), 1),
        host_ops_per_decode_call=ops_per_decode,
        decode_device_busy_ms=busy_ms,
        decode_device_idle_share=(None if busy_ms is None
                                  else 1.0 - busy_ms / decode_ms),
        instrumented_wall_s=wall2, param_init_s=init_s,
        ttft_p50_ticks=st.summary().get("ttft_p50"))
    say("phase 10: full falcon-mamba-7b bf16 dense serving:",
        json.dumps(rec))
    return rec, launches


# ---------------------------------------------------------------------------
# Phases 11 and 12: the paged engine's serve features
# ---------------------------------------------------------------------------


def clean_pool(engine) -> bool:
    """The allocator holds exactly the prefix cache's blocks (nothing when
    the cache is off), and no transfer is pending."""
    held = (engine.prefix_cache.cached_blocks()
            if engine.prefix_cache is not None else 0)
    return (engine.allocator.used_blocks() == held
            and engine.transfer.pending() == 0)


def feature_stats(engine) -> dict:
    """The counters a feature run reports (ServeStats and SpecStats)."""
    st = engine.stats
    out = {n: getattr(st, n) for n in (
        "ticks", "calls", "prefill_calls", "mixed_calls", "tokens_generated",
        "prefix_hits", "prefix_hit_tokens", "prefix_inserts",
        "prefix_evictions", "prefix_spills", "host_hit_tokens", "cow_forks",
        "retractions", "restored", "swap_out_blocks", "swap_in_blocks",
        "pool_stalls")}
    if st.mixed_calls:
        out["mixed_fill_ratio"] = st.mixed_fill_ratio
    if engine.spec_gamma:
        out.update(engine.spec_stats.summary())
    return out


def shared_prefix_reqs(rng, vocab, n, prefix_len, tail, gen, per_tick,
                       start=0.0):
    """``n`` requests: one shared ``prefix_len``-token prompt head, then a
    unique tail of ``tail`` (lo, hi) tokens, ``gen`` new tokens each,
    ``per_tick`` arriving per engine tick from ``start``."""
    from repro_torch.serve import Request

    head = rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
    reqs = []
    for i in range(n):
        t = int(rng.integers(tail[0], tail[1] + 1))
        prompt = np.concatenate([head, rng.integers(0, vocab, (t,))
                                 .astype(np.int32)])
        reqs.append(Request(i, prompt, gen, arrival=start + i // per_tick))
    return reqs


def phase11(pa, dev, card):
    """Feature exactness at full width (2 layers, fp32): every run's greedy
    tokens equal ``lm.greedy_generate``'s (0 mismatches)."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import Request, ServeEngine, blocks_for
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    max_seq, f32 = 96, torch.float32
    per_row = blocks_for(max_seq, BS)
    base = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                           n_stages=2, data_size=2, max_seq=max_seq,
                           cache_dtype=f32, prefill_chunks=2, paged=True,
                           block_size=BS, n_blocks=4 * per_row)
    opts = ModelOptions(use_paged_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    params2 = pl.init_trial_params(
        cfg, dataclasses.replace(base, n_trials=2), plan_stages(cfg, 2), gen,
        dtype=f32, device=dev)  # row 0 the target, row 1 other weights
    params1 = tree_map(lambda x: x[:1], params2)
    p_oracle = lm.layer_slice(params1, 0)
    memo, oracle_s = {}, [0.0]

    def oracle(r):
        key = (r.prompt.tobytes(), r.max_new_tokens)
        if key not in memo:
            t = time.perf_counter()
            memo[key] = lm.greedy_generate(cfg, opts, p_oracle, r.prompt,
                                           r.max_new_tokens, max_seq, f32)
            oracle_s[0] += time.perf_counter() - t
        return memo[key]

    runs, total_mismatch = {}, 0

    def serve(name, reqs, eng, params=params1, **kw):
        nonlocal total_mismatch
        reset_counts(pa)
        engine = ServeEngine(cfg, eng, params, opts, device=dev, **kw)
        t = time.perf_counter()
        comps = engine.run([r.clone() for r in reqs], max_ticks=5000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        assert [c.rid for c in comps] == sorted(r.rid for r in reqs), name
        mism = 0
        for r, c in zip(sorted(reqs, key=lambda r: r.rid), comps):
            assert len(c.tokens) == r.max_new_tokens, (name, r.rid)
            mism += sum(a != b for a, b in zip(c.tokens, oracle(r)))
        total_mismatch += mism
        assert clean_pool(engine), f"{name}: allocator not clean"
        assert pa.launches == engine.stats.calls * eng.n_slots \
            * cfg.n_layers, (name, pa.launches)
        runs[name] = dict(feature_stats(engine), mismatches=mism,
                          wall_s=wall, kernel_launches=pa.launches)
        assert mism == 0, f"{name}: {mism} tokens differ from the oracle"
        return engine, comps

    rng = np.random.default_rng(11)
    # 1. prefix cache on vs off: a shared 40-token head (2.5 blocks: every
    # hit ends mid-block, so the first write forks the tail copy-on-write),
    # a warm-up pair first, then sharers; 6 blocks per partition, so
    # cached blocks are evicted under pressure
    reqs = shared_prefix_reqs(rng, cfg.vocab_size, 10, 40, (8, 24), 5, 2)
    for i, r in enumerate(reqs):
        r.arrival = 0.0 if i < 2 else 12.0 + (i - 2) // 2
    small = dataclasses.replace(base, n_blocks=2 * 6)
    on, _ = serve("prefix_on", reqs, small, prefix_cache=True)
    serve("prefix_off", reqs, small)
    assert on.stats.prefix_hits > 0 and on.stats.cow_forks >= 1, \
        runs["prefix_on"]
    # 2. overcommit 1.5 on 5 blocks per partition: swap (host tier) and
    # recompute (none); requests of 3-4 blocks, so two rows commit within
    # 1.5 x 5 but outgrow the 5 blocks while decoding (every victim is
    # decoding: swap restores them all)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(p),))
                    .astype(np.int32), int(g), arrival=0.0)
            for i, (p, g) in enumerate(zip(rng.integers(12, 25, 8),
                                           rng.integers(26, 37, 8)))]
    tight = dataclasses.replace(base, n_blocks=2 * 5)
    swap, _ = serve("overcommit_swap", reqs, tight, overcommit=1.5,
                    host_blocks=32)
    rec, _ = serve("overcommit_recompute", reqs, tight, overcommit=1.5,
                   host_blocks=0)
    assert swap.stats.retractions > 0 and rec.stats.retractions > 0
    assert swap.stats.restored == swap.stats.retractions, \
        runs["overcommit_swap"]
    assert swap.stats.swap_in_blocks > 0
    # 3. fused vs split on phase 4's trace
    shapes = [(40, 4), (70, 3), (33, 5), (64, 6), (17, 2), (50, 4), (29, 3)]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (p,))
                    .astype(np.int32), g, arrival=0.5 * i)
            for i, (p, g) in enumerate(shapes)]
    split, c_split = serve("split", reqs, base)
    fused, c_fused = serve("fused", reqs, base, fused=True)
    for a, b in zip(c_split, c_fused):
        assert (a.tokens, a.ttft_ticks, a.finished_tick) == \
            (b.tokens, b.ttft_ticks, b.finished_tick), a.rid
    assert fused.stats.calls < split.stats.calls, \
        (fused.stats.calls, split.stats.calls)
    # 4. gang speculation, K = 2 (row 0 the target, row 1 the drafter),
    # gamma 3: a mirrored drafter, then one of other weights
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(p),))
                    .astype(np.int32), int(g), arrival=0.5 * i)
            for i, (p, g) in enumerate(zip(rng.integers(17, 70, 6),
                                           rng.integers(8, 13, 6)))]
    spec_eng = dataclasses.replace(base, n_trials=2)
    mirrored = tree_map(lambda x: torch.cat([x[:1], x[:1]]), params2)
    perfect, _ = serve("spec_mirrored", reqs, spec_eng, mirrored,
                       spec_gamma=3)
    del mirrored
    other, _ = serve("spec_other", reqs, spec_eng, params2, spec_gamma=3)
    assert perfect.spec_stats.acceptance_rate == 1.0, runs["spec_mirrored"]
    assert other.spec_stats.rollback_blocks > 0, runs["spec_other"]
    rec = dict(card=card, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype="float32", stages=2, data_shards=2, block_size=BS,
               mismatches=total_mismatch, runs=runs,
               oracle_s=oracle_s[0], seconds=time.perf_counter() - t_phase)
    say("phase 11: full-width 2-layer fp32 serve features vs the oracle:",
        json.dumps(rec))
    return rec


class StepProbe:
    """Labelled wrappers around an engine's serve steps. ``labels`` maps
    each step attribute to a label, or to a function of (engine, params,
    cache, batch) giving one. Every call adds the K2 launches it must make
    (one per slot and layer) to ``expected`` under the variant its token
    width takes, and its width to ``widths``. A call is timed on the host
    clock (synchronized) into ``times``; with ``profile``, the first call
    of each label runs under the profiler instead (:func:`profile_call`):
    ``calls`` gets its width, host ops and device busy ms, and ``k2`` its
    K2 launches' device ms and bound per launch and each launch held
    against the plain version (:func:`k2_vs_plain`), both after the
    profile closes (the pools a launch read are not written again in its
    call: a row's blocks are its own, and shared prefix blocks are
    read-only)."""

    def __init__(self, pa, engine, labels, variant_of, profile=False):
        self.pa, self.engine, self.variant_of = pa, engine, variant_of
        self.profile = profile
        self.per_call = engine.eng.n_slots * engine.cfg.n_layers
        self.times, self.widths, self.expected = {}, {}, {}
        self.calls, self.k2 = {}, {}
        for attr, label in labels.items():
            setattr(engine, attr, self._wrap(label, getattr(engine, attr)))

    def _wrap(self, label, step):
        def run(params, cache, batch):
            lab = (label(self.engine, params, cache, batch)
                   if callable(label) else label)
            sq = int(batch["tokens"].shape[-1])
            v = self.variant_of(sq)
            self.expected[v] = self.expected.get(v, 0) + self.per_call
            self.widths.setdefault(lab, set()).add(sq)
            if self.profile and lab not in self.calls:
                return self._profiled(lab, sq, step, params, cache, batch)
            t = time.perf_counter()
            out = step(params, cache, batch)
            torch.cuda.synchronize()
            self.times.setdefault(lab, []).append(time.perf_counter() - t)
            return out
        return run

    def _profiled(self, lab, sq, step, params, cache, batch):
        pa, real, launches = self.pa, self.pa.paged_attention_kernel, []

        def launch(*args, **kw):
            launches.append((args, kw))
            return real(*args, **kw)

        pa.paged_attention_kernel = launch
        try:
            out, host, dev = profile_call(lambda: step(params, cache, batch))
        finally:
            pa.paged_attention_kernel = real
        assert len(launches) == self.per_call, (lab, len(launches))
        k2 = [e.time_range.elapsed_us() for e in dev
              if any(k in e.name for k in K2_KERNELS)]
        self.calls[lab] = dict(sq=sq, host_ops=host, device_busy_ms=(
            sum(e.time_range.elapsed_us() for e in dev) / 1e3
            if dev else None))
        self.k2[lab] = dict(
            launches=len(launches),
            ms_per_launch=sum(k2) / 1e3 / len(launches) if k2 else None,
            bound_ms_per_launch=1e3 * float(np.mean(
                [launch_bound_s(*a, **kw) for a, kw in launches])),
            vs_plain=k2_vs_plain(pa, launches))
        return out


def k2_vs_plain(pa, launches) -> dict:
    """K2 against its plain version on each of ``launches`` ([(args,
    kwargs)]): the largest |kernel - plain| and its largest share of the
    launch's ``k2_limit``, the largest plain output, and over the launches
    with a live row the least share of the limit by which the plain output
    moves when each row's last key is dropped (above 1: the limit sees that
    defect). Asserts every launch within its limit; a launch with no live
    row must give exact zeros."""
    errs, shares, peaks, drops = [], [], [], []
    for args, kw in launches:
        got = pa.paged_attention_kernel(*args, **kw)
        want = pa.paged_attention_plain(*args, **kw)
        err = float((got.float() - want.float()).abs().max())
        limit = k2_limit(want)
        assert bool(torch.isfinite(got).all()) and err <= limit, \
            (err, limit)
        errs.append(err)
        shares.append(err / limit if limit else 0.0)
        peaks.append(float(want.float().abs().max()))
        if peaks[-1] > 0:
            short = pa.paged_attention_plain(
                *args[:5], (args[5] - 1).clamp(min=0), **kw)
            drops.append(float((short.float() - want.float()).abs().max())
                         / limit)
    return dict(max_abs_err=max(errs), max_share_of_limit=max(shares),
                max_abs_plain=max(peaks),
                drop_last_key_over_limit_min=min(drops, default=None))


def near_ties(cfg, params, dev, reqs, comps, ref, proposals=()) -> dict:
    """Whether a run's departures from a plainer run of the same trace
    (``ref``) are bf16 near-ties. One teacher-forced forward per request
    that departs, over its prompt and the run's tokens, in fp32 (trial 0's
    weights cast up) and in bf16, gives the logits at every generated
    position. At each first divergence (the run's token a, ``ref``'s b)
    and each rejected proposal b of a drafter (the target committed a):
    the fp32 gap |l[a] - l[b]| beside the bf16 forward's own error there
    (max over the vocabulary of |l_bf16 - l_fp32|); and, for scale, the
    fp32 top-1 minus top-2 margin over those requests' generated
    positions. ``proposals``: (rid, tokens committed before, drafts) per
    verify row."""
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.tree import tree_map

    toks = {c.rid: c.tokens for c in comps}
    points = [("divergence", c.rid, j, r.tokens[j])
              for c, r, j in zip(comps, ref, first_divergence(comps, ref))
              if j is not None]
    for rid, g, drafts in proposals:
        i = next((i for i, x in enumerate(drafts) if x != toks[rid][g + i]),
                 None)
        if i is not None:
            points.append(("rejection", rid, g + i, drafts[i]))
    departing = {rid for _, rid, _, _ in points}
    p16 = lm.layer_slice(params, 0)
    p32 = tree_map(lambda x: x.float(), p16)
    logits, margins = {}, []
    with torch.no_grad():
        for r in (r for r in reqs if r.rid in departing):
            seq = torch.as_tensor(np.concatenate(
                [r.prompt, np.asarray(toks[r.rid][:-1], np.int32)])[None],
                device=dev)
            at = slice(r.prompt_len - 1, None)  # predicting each new token
            l32 = lm.forward(cfg, ModelOptions(), p32,
                             {"tokens": seq})[0][0, at].float()
            l16 = lm.forward(cfg, ModelOptions(compute_dtype=torch.bfloat16),
                             p16, {"tokens": seq})[0][0, at].float()
            top = l32.topk(2, dim=-1).values
            margins += (top[:, 0] - top[:, 1]).tolist()
            logits[r.rid] = (l32, (l16 - l32).abs().amax(-1))
    del p32
    rows = []
    for kind, rid, j, b in points:
        l32, noise = logits[rid]
        a = toks[rid][j]
        rows.append(dict(kind=kind, rid=rid, index=j,
                         gap=float((l32[j, a] - l32[j, b]).abs()),
                         bf16_noise=float(noise[j])))
    out = dict(top2_margin_median=(float(np.median(margins)) if margins
                                   else None),
               bf16_noise_median=(float(torch.cat(
                   [n for _, n in logits.values()]).median()) if logits
                   else None))
    for kind in ("divergence", "rejection"):
        sel = [p for p in rows if p["kind"] == kind]
        gaps = [p["gap"] for p in sel]
        out[kind] = dict(
            n=len(sel), within_noise=sum(p["gap"] <= p["bf16_noise"]
                                         for p in sel),
            gap_median=float(np.median(gaps)) if gaps else None,
            gap_max=max(gaps, default=None))
    out["divergences"] = [p for p in rows if p["kind"] == "divergence"]
    return out


def first_divergence(comps, ref) -> list:
    """Per request, the index of the first generated token that differs
    from ``ref``'s (None where all are equal)."""
    return [next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None) for a, b in zip(comps, ref)]


def mixed_label(engine, params, cache, batch):
    """A mixed call counts as ``mixed_hit`` when some row's first chunk
    starts at its prefix-hit length, else ``mixed_wave`` when it carries a
    chunk, else ``mixed_decode`` (decode rows only, 1 token)."""
    if any(s.request is not None and s.chunks and s.hit_tokens > 0
           and s.pos == s.hit_tokens for s in engine.batcher.slots):
        return "mixed_hit"
    return "mixed_wave" if batch["tokens"].shape[-1] > 1 else "mixed_decode"


def drafter_label(kind):
    """Calls of the decode / append steps on drafter rows (trial row 1)
    count as ``draft``; the target's own prefill appends as ``kind``."""
    def label(engine, params, cache, batch):
        return "draft" if bool(batch["active"][1].any()) else kind
    return label


def pool_round_trip(cfg, eng, cache) -> int:
    """The host tier's round trip, bit for bit: extract two written blocks
    of trial 0's pool to the host and inject them over two others; returns
    the payload bytes that came back equal (asserts every bit did)."""
    from repro_torch.core import pipeline as pl

    tk = pl.make_transfer_kernels(cfg, eng)
    src, dst = [0, 1], [2, 3]
    payloads = tk.extract(cache, 0, 0, src)
    assert all(p.device.type == "cpu" and p.dtype == eng.cache_dtype
               and bool(p.ne(0).any()) for p in payloads)
    tk.inject(cache, 0, 0, dst, payloads)
    bits = lambda t: t.view(torch.int16) if t.element_size() == 2 \
        else t.view(torch.int32)
    for buf in (cache["layers"][n] for n in ("k", "v")):
        assert torch.equal(bits(buf[0][:, dst]), bits(buf[0][:, src]))
    return sum(p.numel() * p.element_size() for p in payloads)


# phases 12 and 13 (b), (c)'s depth: chatglm3-6b's first 4 of 28 layers
# (2 a stage), every width as published; at all 28 they took 142-143 and
# 37-41 s of the script's 1200 s on an NVIDIA H100 80GB HBM3 (700 W)
P12_LAYERS = 4


def phase12(pa, dev, card):
    """The serve features at full width: chatglm3-6b cut to
    ``P12_LAYERS`` layers, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import Request, ServeEngine, blocks_for
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=P12_LAYERS)
    bf16 = torch.bfloat16
    opts = ModelOptions(compute_dtype=bf16, use_paged_kernel=True)
    variant_of = lambda sq: pa.pick_variant(bf16, sq, cfg.head_dim)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(12)
    out = dict(card=card, layers=cfg.n_layers, dtype="bfloat16", stages=2,
               slots=2, microbatch=2, block_size=BS)
    marks, t_mark = {}, [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    def run(name, engine, reqs, labels):
        """One timed, counted run; returns (completions, record)."""
        probe = StepProbe(pa, engine, labels, variant_of)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(pa)  # count the main path's launches only
        t = time.perf_counter()
        comps = engine.run([r.clone() for r in reqs], max_ticks=20000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = engine.stats
        assert [c.rid for c in comps] == [r.rid for r in reqs], name
        for r, c in zip(reqs, comps):
            assert len(c.tokens) == r.max_new_tokens, (name, r.rid)
        want = st.calls * engine.eng.n_slots * cfg.n_layers
        assert pa.launches == want > 0, (name, pa.launches, want)
        assert dict(pa.variant_launches) == \
            {v: probe.expected.get(v, 0) for v in pa.variant_launches}, \
            (name, pa.variant_launches, probe.expected)
        assert clean_pool(engine), f"{name}: allocator not clean"
        rec = dict(feature_stats(engine), wall_s=wall,
                   generated_tok_per_s=st.tokens_generated / wall,
                   kernel_launches=pa.launches,
                   variant_launches=dict(pa.variant_launches),
                   sq_by_label={k: sorted(v)
                                for k, v in probe.widths.items()},
                   ms_per_call={k: 1e3 * float(np.median(v))
                                for k, v in probe.times.items()},
                   calls_by_label={k: len(v) for k, v in probe.times.items()},
                   max_memory_allocated_gb=(torch.cuda.max_memory_allocated()
                                            / 1e9))
        return comps, rec

    def profiled(engine, reqs, labels, ms_per_call):
        """A short run whose first call of each label is profiled: K2 by
        path (against its plain version on every launch of that call), and
        the call's host ops, busy ms and idle share (against the label's
        median call in the timed run)."""
        probe = StepProbe(pa, engine, labels, variant_of, profile=True)
        t = time.perf_counter()
        engine.run([r.clone() for r in reqs])
        torch.cuda.synchronize()
        for lab, c in probe.calls.items():
            ms, busy = ms_per_call.get(lab), c["device_busy_ms"]
            c.update(median_call_ms=ms, idle_share=(
                None if busy is None or not ms else 1.0 - busy / ms))
        return dict(wall_s=time.perf_counter() - t, k2=probe.k2,
                    calls=probe.calls)

    # run A: prefix cache, fused admission, overcommit 1.5, host tier; the
    # last four requests resubmit the first four prompts (their cached
    # tails have been spilled to the host by then)
    prefix, tail, gen_a = 520, (32, 480), 32
    max_seq = prefix + tail[1] + gen_a
    eng_a = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                            n_stages=2, max_seq=max_seq, cache_dtype=bf16,
                            prefill_chunks=2, paged=True, block_size=BS,
                            n_blocks=150, host_blocks=256)
    peak = 4 * blocks_for(max_seq, BS)
    params = pl.init_trial_params(cfg, eng_a, plan_stages(cfg, 2), gen,
                                  dtype=bf16, device=dev)
    reqs_a = shared_prefix_reqs(rng, cfg.vocab_size, 16, prefix, tail,
                                gen_a, 2)
    reqs_a[-4:] = [dataclasses.replace(r, prompt=src.prompt)
                   for r, src in zip(reqs_a[-4:], reqs_a)]
    mark("init")
    feats = dict(prefix_cache=True, fused=True, overcommit=1.5)
    labels_a = {"mixed_step": mixed_label, "decode_step": "decode"}
    eng_a_run = ServeEngine(cfg, eng_a, params, opts, device=dev, **feats)
    comps_a, rec_a = run("run_a", eng_a_run, reqs_a, labels_a)
    mark("run_a")
    st = eng_a_run.stats
    assert st.prefix_hits >= 8 and st.cow_forks >= 1 \
        and st.retractions >= 1 and st.restored >= 1 \
        and st.host_hit_tokens > 0 and st.swap_in_blocks > 0, rec_a
    rec_a["round_trip_bytes"] = pool_round_trip(cfg, eng_a, eng_a_run.cache)
    del eng_a_run
    # the same trace, split admission, no cache, no overcommit, every cell
    # backed: how many requests' bf16 tokens come out equal
    eng_base = dataclasses.replace(eng_a, n_blocks=peak, host_blocks=0)
    comps_base, rec_base = run(
        "run_a_baseline", ServeEngine(cfg, eng_base, params, opts,
                                      device=dev), reqs_a,
        {"append_step": "append", "decode_step": "decode"})
    rec_a["pool_blocks"], rec_a["peak_demand_blocks"] = eng_a.n_blocks, peak
    rec_a["tokens_equal_share_vs_baseline"] = float(np.mean(
        [a.tokens == b.tokens for a, b in zip(comps_a, comps_base)]))
    rec_a["first_divergence_vs_baseline"] = first_divergence(comps_a,
                                                             comps_base)
    out["run_a"], out["run_a_baseline"] = rec_a, rec_base
    mark("run_a_baseline")
    gc.collect()
    rec_a["near_ties_vs_baseline"] = near_ties(cfg, params, dev, reqs_a,
                                               comps_a, comps_base)
    mark("run_a_near_ties")
    # K2 by path and one call of each kind, from a short run of three of
    # the trace's requests with 3 new tokens: two cold, the third arriving
    # after they finish (it hits the cache)
    short_a = [Request(r.rid, r.prompt, 3, arrival=8.0 * (i // 2))
               for i, r in enumerate(reqs_a[:3])]
    out["run_a_profile"] = profiled(
        ServeEngine(cfg, eng_a, params, opts, device=dev, **feats), short_a,
        labels_a, rec_a["ms_per_call"])
    mark("run_a_profile")
    gc.collect()
    torch.cuda.empty_cache()

    # run B: gang speculation, K = 2 (row 1 drafts with row 0's weights),
    # gamma 3, split admission; against the target alone on the same trace
    gen_b = 64
    max_seq_b = 512 + gen_b
    eng_b1 = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                             n_stages=2, max_seq=max_seq_b, cache_dtype=bf16,
                             prefill_chunks=2, paged=True, block_size=BS,
                             n_blocks=4 * blocks_for(max_seq_b, BS))
    reqs_b = [Request(i, rng.integers(0, cfg.vocab_size, (int(p),))
                      .astype(np.int32), gen_b, arrival=float(i))
              for i, p in enumerate(rng.integers(128, 513, 8))]
    comps_b1, rec_b1 = run(
        "run_b_target_only", ServeEngine(cfg, eng_b1, params, opts,
                                         device=dev), reqs_b,
        {"append_step": "append", "decode_step": "decode"})
    mark("run_b_target_only")
    params2 = tree_map(lambda x: torch.cat([x, x]), params)
    del params
    gc.collect()  # the engines above hold params in reference cycles
    torch.cuda.empty_cache()
    eng_b = dataclasses.replace(eng_b1, n_trials=2)
    labels_b = {"verify_step": "verify",
                "decode_step": drafter_label("decode"),
                "append_step": drafter_label("append")}
    eng_b_run = ServeEngine(cfg, eng_b, params2, opts, device=dev,
                            spec_gamma=3)
    proposals, verify_call = [], eng_b_run._verify_call

    def logged(slots, drafts):
        proposals.extend((s.request.rid, len(s.generated),
                          list(drafts[id(s)]))
                         for s in slots if s.request is not None)
        return verify_call(slots, drafts)

    eng_b_run._verify_call = logged
    comps_b, rec_b = run("run_b", eng_b_run, reqs_b, labels_b)
    mark("run_b")
    sp, st = eng_b_run.spec_stats, eng_b_run.stats
    assert 4 in rec_b["sq_by_label"]["verify"], rec_b
    rec_b["target_ticks_per_token"] = ((st.prefill_calls + sp.verify_calls)
                                       / st.tokens_generated)
    rec_b1["target_ticks_per_token"] = (rec_b1["calls"]
                                        / rec_b1["tokens_generated"])
    rec_b["tokens_equal_share_vs_target_only"] = float(np.mean(
        [a.tokens == b.tokens for a, b in zip(comps_b, comps_b1)]))
    rec_b["first_divergence_vs_target_only"] = first_divergence(comps_b,
                                                                comps_b1)
    out["run_b"], out["run_b_target_only"] = rec_b, rec_b1
    del eng_b_run
    gc.collect()
    rec_b["near_ties_vs_target_only"] = near_ties(
        cfg, params2, dev, reqs_b, comps_b, comps_b1, proposals)
    mark("run_b_near_ties")
    short_b = [Request(reqs_b[0].rid, reqs_b[0].prompt, 12)]
    out["run_b_profile"] = profiled(
        ServeEngine(cfg, eng_b, params2, opts, device=dev, spec_gamma=3),
        short_b, labels_b, rec_b["ms_per_call"])
    mark("run_b_profile")
    out["seconds"] = marks
    say(f"phase 12: full-width chatglm3-6b ({cfg.n_layers} layers) bf16 "
        f"serve features:", json.dumps(out))
    launches = rec_a["kernel_launches"] + rec_b["kernel_launches"]
    return out, launches


# ---------------------------------------------------------------------------
# Phase 13: the rest of serving — static lockstep serving (K1 in every
# prefill), sliding windows (K2), chunked prefill, traces, capacity plans
# ---------------------------------------------------------------------------


def timed_steps(pl, times):
    """Patch ``pl.make_serve_step`` so every step built from now on (as
    ``static_serve`` builds its own) adds each call's synchronized
    host-clock seconds to ``times[mode]``; returns the function that
    undoes the patch."""
    real = pl.make_serve_step

    def make(cfg, opts, eng, mode, **kw):
        step = real(cfg, opts, eng, mode, **kw)

        def run(params, cache, batch):
            t = time.perf_counter()
            out = step(params, cache, batch)
            torch.cuda.synchronize()
            times.setdefault(mode, []).append(time.perf_counter() - t)
            return out
        return run

    pl.make_serve_step = make
    return lambda: setattr(pl, "make_serve_step", real)


def k1_call_vs_plain(fa, fn):
    """Run ``fn()`` (one serving call) under the profiler with every K1
    launch recorded; returns (its result, host ops, record): K1's
    launches, device ms per launch beside its bound, the call's device
    busy ms, and each launch's output held against
    ``flash_attention_plain`` on its inputs (asserted within K1's
    tolerance for the input type)."""
    real, launches = fa.flash_attention_kernel, []

    def launch(q, k, v, **kw):
        out = real(q, k, v, **kw)
        launches.append((q, k, v, kw, out))
        return out

    fa.flash_attention_kernel = launch
    try:
        res, host, dev = profile_call(fn)
    finally:
        fa.flash_attention_kernel = real
    assert launches, "the call launched no K1"
    k1 = [e.time_range.elapsed_us() for e in dev
          if any(k in e.name for k in K1_KERNELS)]
    errs = []
    for q, k, v, kw, out in launches:
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = float((out.float() - want.float()).abs().max())
        assert bool(torch.isfinite(out).all()) \
            and err < FLASH_TOL[q.dtype], (err, kw)
        errs.append(err)
    q, k, _, kw, _ = launches[0]
    return res, host, dict(
        launches=len(launches), q_shape=list(q.shape), kv_shape=list(k.shape),
        window=kw.get("window", 0), dtype=str(q.dtype).split(".")[-1],
        ms_per_launch=sum(k1) / 1e3 / len(launches) if k1 else None,
        bound_ms_per_launch=1e3 * float(np.mean(
            [flash_bound_s(a, b, c, **w) for a, b, c, w, _ in launches])),
        max_abs_err=max(errs), tol=FLASH_TOL[q.dtype],
        device_busy_ms=(sum(e.time_range.elapsed_us() for e in dev) / 1e3
                        if dev else None))


def phase13_exact(fa, pa, ms, dev):
    """(a) Exactness at full width, 2 fp32 layers, 2 stages, 2 slots x
    microbatch 2: every greedy token of static serving (K1 in each
    prefill; one group of 128-token prompts, one of 100, not a multiple of
    K1's 64-row tile) equals the oracle's and the continuous engine's; of
    windowed serving (window 24 on 40-110-token prompts: dense strips, the
    paged pool through K2, and static with a windowed K1) the windowed
    oracle's, and the window changes some request's tokens; of
    falcon-mamba-7b static serving (K3) the oracle's (chunked scan);
    chunked prefill (4 chunks, the chunk slots of a group sharing one
    cache) equals plain prefill in tokens and caches, for both families;
    a traced windowed run passes the span validator and holds compile
    events."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.obs import Tracer, validate_spans
    from repro_torch.serve import Request, ServeEngine, blocks_for, \
        static_serve
    from repro_torch.tree import tree_leaves

    f32, window, max_seq = torch.float32, 24, 136
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    scfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    base = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                           n_stages=2, max_seq=max_seq, cache_dtype=f32,
                           prefill_chunks=2)
    paged = dataclasses.replace(base, paged=True, block_size=BS,
                                n_blocks=4 * blocks_for(max_seq, BS))
    gen = torch.Generator(device=dev).manual_seed(13)
    params = pl.init_trial_params(cfg, base, plan_stages(cfg, 2), gen,
                                  dtype=f32, device=dev)
    sparams = pl.init_trial_params(scfg, base, plan_stages(scfg, 2), gen,
                                   dtype=f32, device=dev)
    plain, flash = ModelOptions(), ModelOptions(use_flash_kernel=True)
    kernel = ModelOptions(use_paged_kernel=True)
    mamba = ModelOptions(use_mamba_kernel=True)
    rng = np.random.default_rng(13)
    memo, runs = {}, {}

    def oracle(r, window=0, c=cfg, p=params):
        key = (c.name, r.prompt.tobytes(), r.max_new_tokens, window)
        if key not in memo:  # plain attention and the chunked scan
            memo[key] = lm.greedy_generate(c, plain, lm.layer_slice(p, 0),
                                           r.prompt, r.max_new_tokens,
                                           max_seq, f32, window=window)
        return memo[key]

    def check(name, reqs, comps, **kw):
        mism = 0
        for r, comp in zip(sorted(reqs, key=lambda r: r.rid), comps):
            assert len(comp.tokens) == r.max_new_tokens, (name, r.rid)
            mism += sum(a != b for a, b in zip(comp.tokens, oracle(r, **kw)))
        runs[name] = dict(requests=len(comps), mismatches=mism)
        assert mism == 0, f"{name}: {mism} tokens differ from the oracle"

    # static serving: two groups of four uniform prompts
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    (128 if i < 4 else 100,))
                    .astype(np.int32), int(g))
            for i, g in enumerate(rng.integers(3, 9, 8))]
    reset_counts(fa)
    comps, st = static_serve(cfg, base, params, reqs, flash, device=dev)
    check("static_k1", reqs, comps)
    assert fa.launches == 2 * base.n_slots * cfg.n_layers, fa.launches
    runs["static_k1"].update(calls=st.calls, k1_launches=fa.launches)
    cont = ServeEngine(cfg, base, params, plain, device=dev).run(
        [r.clone() for r in reqs])
    assert [c.tokens for c in cont] == [c.tokens for c in comps], \
        "the continuous engine's tokens differ from static serving's"
    # sliding windows
    wreqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(p),))
                     .astype(np.int32), 6, arrival=0.5 * i)
             for i, p in enumerate(rng.integers(40, 111, 7))]
    for name, eng, opts in (("window_dense", base, plain),
                            ("window_paged_k2", paged, kernel)):
        reset_counts(pa)
        engine = ServeEngine(cfg, dataclasses.replace(eng, window=window),
                             params, opts, device=dev)
        check(name, wreqs, engine.run([r.clone() for r in wreqs]),
              window=window)
        runs[name]["k2_launches"] = pa.launches
    assert runs["window_paged_k2"]["k2_launches"] > 0
    bites = sum(oracle(r, window) != oracle(r) for r in wreqs)
    assert bites > 0, "the window never changed a request's tokens"
    runs["window_changes_requests"] = bites
    sreqs = [Request(i, rng.integers(0, cfg.vocab_size, (100,))
                     .astype(np.int32), 5) for i in range(4)]
    reset_counts(fa)
    comps, _ = static_serve(cfg, dataclasses.replace(base, window=window),
                            params, sreqs, flash, device=dev)
    check("window_static_k1", sreqs, comps, window=window)
    runs["window_static_k1"]["k1_launches"] = fa.launches
    # falcon-mamba-7b static serving: K3 scans each prompt once
    mreqs = [Request(i, rng.integers(0, scfg.vocab_size, (100,))
                     .astype(np.int32), int(g))
             for i, g in enumerate(rng.integers(3, 7, 4))]
    reset_counts(ms)
    comps, _ = static_serve(scfg, base, sparams, mreqs, mamba, device=dev)
    check("ssm_static_k3", mreqs, comps, c=scfg, p=sparams)
    assert ms.launches == base.n_slots * scfg.n_layers, ms.launches
    runs["ssm_static_k3"]["k3_launches"] = ms.launches

    # chunked prefill: 2 request groups of 128 tokens in 4 chunks each
    def prefill(c, p, opts, eng, toks):
        cache = pl.serve_cache_struct(c, eng, device=dev)
        step = pl.make_serve_step(c, opts, eng, "prefill")
        cache, tok, _ = step(p, cache,
                             {"tokens": torch.from_numpy(toks).to(dev)})
        return tree_leaves(cache["layers"]), tok.cpu().numpy()

    seq, nc = 128, 4
    eng_p = dataclasses.replace(base, max_seq=seq, prefill_chunks=1)
    eng_c = dataclasses.replace(eng_p, n_microbatches=2 * nc,
                                prefill_chunks=nc)
    for name, c, p, opts in (("chunked_prefill_attention", cfg, params,
                              flash),
                             ("chunked_prefill_ssm", scfg, sparams, mamba)):
        toks = rng.integers(0, c.vocab_size, (1, 2, 2, seq)).astype(np.int32)
        chunks = np.ascontiguousarray(
            toks.reshape(1, 2, 2, nc, seq // nc).transpose(0, 1, 3, 2, 4)
            .reshape(1, 2 * nc, 2, seq // nc))
        cache_p, tok_p = prefill(c, p, opts, eng_p, toks)
        cache_c, tok_c = prefill(c, p, opts, eng_c, chunks)
        cache_r, tok_r = prefill(c, p, plain, eng_p, toks)  # no kernel
        mism = int((tok_p != tok_c.reshape(1, 2, nc, 2)[:, :, -1]).sum())
        mism += int((tok_p != tok_r).sum())
        diff = lambda xs, ys: max(float((x.float() - y.float()).abs().max())
                                  for x, y in zip(xs, ys))
        runs[name] = dict(mismatches=mism,
                          chunked_cache_max_abs_diff=diff(cache_p, cache_c),
                          plain_cache_max_abs_diff=diff(cache_p, cache_r))
        assert mism == 0 and runs[name]["chunked_cache_max_abs_diff"] < 5e-4 \
            and runs[name]["plain_cache_max_abs_diff"] < 5e-4, runs[name]
    # a traced windowed paged run
    tr = Tracer()
    engine = ServeEngine(cfg, dataclasses.replace(paged, window=window),
                         params, kernel, tracer=tr, device=dev)
    engine.run([r.clone() for r in wreqs])
    rep = validate_spans(tr.events)
    compiles = sorted({(e["mode"], e["qlen"], e["table_width"])
                       for e in tr.events if e["ev"] == "compile"})
    assert rep["completed"] == len(wreqs) and compiles, rep
    runs["traced"] = dict(rep, events=len(tr.events),
                          compile_signatures=compiles)
    return runs


def phase13(fa, pa, ms, dev, card):
    """The rest of serving: (a) :func:`phase13_exact`; (b) full-width bf16
    chatglm3-6b cut to ``P12_LAYERS`` layers, phase 5's grid, static
    serving of 8
    requests of 512 prompt tokens (K1 in each prefill call) beside the
    continuous split engine on the same trace, and every K1 launch of one
    profiled prefill call held to the plain version; (c) phase 5's trace
    through the paged engine with window 256 (K2), every K2 launch of one
    profiled append and one decode call held to the plain version; (d) the
    capacity planner's grid for the whole model (all 28 layers) on this
    card, run with a few requests, its peak memory beside the plan's
    estimate."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core import scheduler as sched
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import Request, ServeEngine, blocks_for, \
        static_serve

    out = dict(card=card)
    marks, t_mark = {}, [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    out["a"] = phase13_exact(fa, pa, ms, dev)
    say("phase 13 (a): full-width 2-layer fp32 static / windowed / chunked "
        "serving vs the oracle:", json.dumps(out["a"]))
    gc.collect()
    torch.cuda.empty_cache()
    mark("a_exactness")

    full = get_config("chatglm3-6b")
    cfg = dataclasses.replace(full, n_layers=P12_LAYERS)
    bf16 = torch.bfloat16
    variant_of = lambda sq: pa.pick_variant(bf16, sq, cfg.head_dim)
    eng5 = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                           n_stages=2, max_seq=1024 + 32, cache_dtype=bf16,
                           prefill_chunks=2, paged=True, block_size=BS,
                           n_blocks=4 * blocks_for(1024 + 32, BS))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = pl.init_trial_params(cfg, eng5, plan_stages(cfg, 2), gen,
                                  dtype=bf16, device=dev)
    k2_opts = ModelOptions(compute_dtype=bf16, use_paged_kernel=True)
    flash = ModelOptions(compute_dtype=bf16, use_flash_kernel=True)
    rng = np.random.default_rng(13)
    mark("b_init")

    # (b) static serving: 8 requests of 512 prompt tokens, two groups
    plen = 512
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (plen,))
                    .astype(np.int32), int(g), arrival=float(i))
            for i, g in enumerate(rng.integers(16, 33, 8))]
    max_seq = plen + 32
    static_eng = dataclasses.replace(eng5, max_seq=max_seq, paged=False,
                                     n_blocks=0, prefill_chunks=1)
    times = {}
    restore = timed_steps(pl, times)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    try:
        t = time.perf_counter()
        comps_s, st_s = static_serve(cfg, static_eng, params, reqs, flash,
                                     device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    finally:
        restore()
    k1_launches = fa.launches
    k1_variants = dict(fa.variant_launches)
    want = len(times["prefill"]) * static_eng.n_slots * cfg.n_layers
    assert k1_launches == want == k1_variants["mma_bf16"] > 0, \
        (k1_launches, want, k1_variants)
    for r, c in zip(reqs, comps_s):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    static_rec = dict(
        wall_s=wall_s, generated_tok_per_s=st_s.tokens_generated / wall_s,
        calls=st_s.calls, prefill_calls=len(times["prefill"]),
        decode_calls=len(times["decode"]),
        prefill_ms_per_call=1e3 * float(np.median(times["prefill"])),
        decode_ms_per_call=1e3 * float(np.median(times["decode"])),
        slot_occupancy=st_s.slot_occupancy,
        decode_occupancy=st_s.decode_occupancy,
        tokens_generated=st_s.tokens_generated, k1_launches=k1_launches,
        k1_variant_launches=k1_variants,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    mark("b_static")
    # the continuous split engine (paged, K2) on the same trace
    split_eng = dataclasses.replace(eng5, max_seq=max_seq,
                                    n_blocks=4 * blocks_for(max_seq, BS))
    engine = ServeEngine(cfg, split_eng, params, k2_opts, device=dev)
    probe = StepProbe(pa, engine, {"append_step": "append",
                                   "decode_step": "decode"}, variant_of)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(pa)
    t = time.perf_counter()
    comps_c = engine.run([r.clone() for r in reqs])
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t
    split_launches = pa.launches
    assert split_launches == engine.stats.calls * split_eng.n_slots \
        * cfg.n_layers > 0, split_launches
    split_rec = dict(
        wall_s=wall_c,
        generated_tok_per_s=engine.stats.tokens_generated / wall_c,
        calls=engine.stats.calls, ticks=engine.stats.ticks,
        ms_per_call={k: 1e3 * float(np.median(v))
                     for k, v in probe.times.items()},
        calls_by_label={k: len(v) for k, v in probe.times.items()},
        slot_occupancy=engine.stats.slot_occupancy,
        decode_occupancy=engine.stats.decode_occupancy,
        k2_launches=split_launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        tokens_equal_share_vs_static=float(np.mean(
            [a.tokens == b.tokens for a, b in zip(comps_c, comps_s)])))
    del engine, probe
    gc.collect()
    # bf16 departures of the split engine from static serving: the fp32
    # logit gap beside the bf16 forward's own error (no gate)
    split_rec["near_ties_vs_static"] = near_ties(cfg, params, dev, reqs,
                                                 comps_c, comps_s)
    gc.collect()
    mark("b_split")
    # one prefill call (the first group) profiled; every K1 launch of it
    # against the plain version
    step = pl.make_serve_step(cfg, flash, static_eng, "prefill")
    tokens = np.stack([r.prompt for r in reqs[:4]]).reshape(1, 2, 2, plen)
    cache = pl.serve_cache_struct(cfg, static_eng, device=dev)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    (_, tok, _), host, k1_rec = k1_call_vs_plain(
        fa, lambda: step(params, cache, batch))
    assert tok.cpu().numpy().reshape(-1).tolist() == \
        [c.tokens[0] for c in comps_s[:4]], "profiled prefill's tokens"
    assert k1_rec["launches"] == static_eng.n_slots * cfg.n_layers
    k1_rec.update(host_ops=host,
                  prefill_ms_per_call=static_rec["prefill_ms_per_call"])
    if k1_rec["device_busy_ms"] is not None:
        k1_rec["idle_share"] = 1.0 - (k1_rec["device_busy_ms"]
                                      / k1_rec["prefill_ms_per_call"])
        k1_rec["k1_share_of_busy"] = (k1_rec["ms_per_launch"]
                                      * k1_rec["launches"]
                                      / k1_rec["device_busy_ms"])
    del cache, batch
    out["b"] = dict(static=static_rec, split=split_rec, k1_prefill=k1_rec,
                    layers=cfg.n_layers, dtype="bfloat16", stages=2,
                    slots=2, microbatch=2, prompt_len=plen,
                    requests=len(reqs))
    say(f"phase 13 (b): full-width chatglm3-6b ({cfg.n_layers} layers) bf16 "
        f"static serving (K1 prefill) beside the continuous split engine:",
        json.dumps(out["b"]))
    mark("b_profile")

    # (c) sliding window 256 on phase 5's trace, paged, K2
    rng5 = np.random.default_rng(4)
    reqs5 = [Request(i, rng5.integers(0, cfg.vocab_size, (int(p),))
                     .astype(np.int32), 32, arrival=float(i))
             for i, p in enumerate(rng5.integers(128, 1025, 8))]
    win_eng = dataclasses.replace(eng5, window=256)
    labels = {"append_step": "append", "decode_step": "decode"}
    engine = ServeEngine(cfg, win_eng, params, k2_opts, device=dev)
    probe = StepProbe(pa, engine, labels, variant_of)
    real, windows = pa.paged_attention_kernel, set()

    def seen(*args, **kw):
        windows.add(kw.get("window"))
        return real(*args, **kw)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(pa)
    pa.paged_attention_kernel = seen
    try:
        t = time.perf_counter()
        comps_w = engine.run([r.clone() for r in reqs5])
        torch.cuda.synchronize()
        wall_w = time.perf_counter() - t
    finally:
        pa.paged_attention_kernel = real
    win_launches = pa.launches
    st = engine.stats
    for r, c in zip(reqs5, comps_w):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    assert windows == {256}, windows
    assert win_launches == st.calls * win_eng.n_slots * cfg.n_layers > 0
    assert dict(pa.variant_launches) == \
        {v: probe.expected.get(v, 0) for v in pa.variant_launches}
    win_rec = dict(
        window=256, wall_s=wall_w,
        generated_tok_per_s=st.tokens_generated / wall_w, calls=st.calls,
        ticks=st.ticks, k2_launches=win_launches,
        variant_launches=dict(pa.variant_launches),
        ms_per_call={k: 1e3 * float(np.median(v))
                     for k, v in probe.times.items()},
        calls_by_label={k: len(v) for k, v in probe.times.items()},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del engine, probe
    gc.collect()
    mark("c_windowed")
    # the trace's longest prompt alone, 3 new tokens: its first append
    # chunk (longer than the window), second chunk (the window starts in
    # the history) and first decode call profiled, every K2 launch of the
    # profiled calls against the plain version
    longest = max(reqs5, key=lambda r: r.prompt_len)
    probe = StepProbe(pa, ServeEngine(cfg, win_eng, params, k2_opts,
                                      device=dev), labels, variant_of,
                      profile=True)
    probe.engine.run([Request(longest.rid, longest.prompt, 3)])
    torch.cuda.synchronize()
    for lab, c in probe.calls.items():
        ms_call = win_rec["ms_per_call"].get(lab)
        c.update(median_call_ms=ms_call, idle_share=(
            None if c["device_busy_ms"] is None or not ms_call
            else 1.0 - c["device_busy_ms"] / ms_call))
    win_rec.update(profiled_prompt_len=longest.prompt_len, k2=probe.k2,
                   profiled_calls=probe.calls)
    out["c"] = win_rec
    say(f"phase 13 (c): full-width chatglm3-6b ({cfg.n_layers} layers) bf16 "
        f"windowed paged serving (K2, window 256):", json.dumps(out["c"]))
    del probe, params
    gc.collect()
    torch.cuda.empty_cache()
    mark("c_profile")

    # (d) the capacity planner's grid on this card, for all 28 layers
    cfg = full
    params = pl.init_trial_params(cfg, eng5, plan_stages(cfg, 2), gen,
                                  dtype=bf16, device=dev)
    base = dataclasses.replace(eng5, paged=False, n_blocks=0,
                               n_microbatches=1)
    planned = sched.plan_serve_capacity(cfg, base, eng5.max_seq, paged=True,
                                        expected_seq=600, block_size=BS,
                                        max_slots=8)
    est = sched.per_chip_bytes(cfg, dataclasses.replace(planned, n_trials=1),
                               eng5.max_seq, train=False, param_bytes=2)
    estimate = est.total * planned.n_stages  # every stage on the card
    preqs = [Request(r.rid, r.prompt, 8, arrival=0.0) for r in reqs5]
    engine = ServeEngine(cfg, planned, params, k2_opts, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(pa)
    t = time.perf_counter()
    comps_p = engine.run([r.clone() for r in preqs])
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t
    plan_launches = pa.launches
    assert len(comps_p) == len(preqs) and engine.allocator.all_free()
    assert plan_launches == engine.stats.calls * planned.n_slots \
        * cfg.n_layers > 0
    peak = torch.cuda.max_memory_allocated()
    out["d"] = dict(
        planned=dict(n_microbatches=planned.n_microbatches,
                     microbatch=planned.microbatch,
                     n_blocks=planned.n_blocks,
                     block_size=planned.block_size,
                     max_seq=planned.max_seq, n_stages=planned.n_stages),
        hbm_bytes=sched.HBM_BYTES_PER_CHIP,
        budget_fraction=sched.HBM_BUDGET_FRACTION,
        estimate_gb=estimate / 1e9, estimate_parts_gb_per_stage=dict(
            params=est.params_bytes / 1e9, act=est.act_bytes / 1e9,
            cache=est.cache_bytes / 1e9),
        max_memory_allocated_gb=peak / 1e9, requests=len(preqs),
        calls=engine.stats.calls, wall_s=wall_p,
        peak_live=engine.stats.peak_live, k2_launches=plan_launches)
    say("phase 13 (d): planned grid for chatglm3-6b bf16:",
        json.dumps(out["d"]))
    del engine, params
    mark("d_plan")
    out["seconds"] = marks
    launches = dict(k1_static_prefill=k1_launches,
                    k2_windowed=win_launches, k2_split=split_launches,
                    k2_planned=plan_launches)
    return out, launches


# ---------------------------------------------------------------------------
# Phase 14: SSM training (falcon-mamba-7b, K3 in the forward)
# ---------------------------------------------------------------------------


def phase14(ms, dev, card):
    """(a) Exactness: full-width falcon-mamba-7b cut to 2 layers, fp32,
    K = 2, S = 2, 2 microbatches, seq 256, 2 steps of the pipelined train
    step with K3 in the forward (its backward autograd of the plain scan)
    against K sequential unpipelined runs through the chunked scan, by
    phase 6's criteria. (b) The path: ``run_model_selection`` as
    ``launch/train.py`` calls it on 4 full-width layers, 2 trials, 2
    stages, seq 512 (the plain-scan backward loops over time steps), 3
    steps, remat, K3."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import kernel_options

    out = {}
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    opts = kernel_options(cfg, remat=True)
    assert opts.use_mamba_kernel and opts.remat
    reset_counts(ms)
    # a tenth of phase 6's learning rates: at phase 6's, the first Adam
    # step (every weight moved by about lr) sends this random-weight
    # model's gradient norm from 7 to 93, and the second update's
    # direction then follows rounding: the plain pipeline (no kernel)
    # misses the change limit by itself (12 % at lr 1e-3), while the
    # first-step gradients agree within 1.3e-6 (NVIDIA H100 80GB HBM3,
    # 700 W: scripts/train_step_sensitivity.py; PERF.md)
    out["a"] = train_vs_sequential(cfg, opts, 256, 14, dev, card,
                                   hp={"lr": [3e-4, 1e-4],
                                       "wd": [0.0, 0.01]})
    out["a"]["k3_launches"] = ms.launches
    assert ms.launches > 0, "the train step launched no K3"
    say("phase 14 (a): falcon-mamba-7b 2-layer fp32 train step (K3) vs "
        "sequential runs (chunked scan):", json.dumps(out["a"]))
    gc.collect()
    torch.cuda.empty_cache()

    # 2 layers and 2 steps: 4 layers and 3 steps took 52 s of the 1200
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    L, n_steps = cfg.n_layers, 2

    def expected(K, M, S):
        # one K3 launch per layer forward: per step, per (trial,
        # microbatch) slot, the forward, the (stage, slot) recompute and
        # the layer recompute, less the last layer of each stage before
        # the last (torch's checkpoint early stop, as phase 7); K3's
        # backward (autograd of the plain scan) launches none; then one
        # evaluation pass of every layer per slot
        return n_steps * K * M * (3 * L - (S - 1)) + K * M * L

    # no profiled step: at about 17 s a step of 4 layers (NVIDIA H100
    # 80GB HBM3, 700 W) the two more steps it takes cost as much as the
    # path itself;
    # a profile of one (``profile=True``) found the step's device time
    # nearly all in the plain scan's backward, elementwise kernels
    out["b"], launches = selection_path(ms, "mamba_scan_kernel", cfg,
                                        kernel_options(cfg, remat=True), 512,
                                        n_steps, expected, dev, card,
                                        profile=False)
    say(f"phase 14 (b): run_model_selection, falcon-mamba-7b {L} layers "
        f"fp32 (K3):", json.dumps(out["b"]))
    return out, launches


# ---------------------------------------------------------------------------
# Phase 15: the hybrid family (zamba2-7b, K1 at head_dim 112)
# ---------------------------------------------------------------------------


def phase15_exact(fa, dev, card):
    """(a) Exactness at full width, zamba2-7b cut to 12 layers (one shared
    site in each of the 2 stages: layers 5 and 11), fp32: the dense engine
    on 7 staggered requests (slots recycle; every reset row, shared strips
    included, is zero) and static serving (K1 at head_dim 112 in each
    prefill; prompts of 128 and of 100 tokens) equal the oracle; chunked
    prefill (4 chunks) equals plain prefill in tokens and caches; the
    train step (K1 fp32) equals sequential runs by phase 6's criteria."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.models.layers import kernel_options
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import Request, static_serve
    from repro_torch.tree import tree_leaves

    f32, max_seq = torch.float32, 136
    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=12)
    sites = sum(lm.shared_site_flags(cfg, 0, cfg.n_layers)[0])
    eng, opts, params, make = dense_engine(cfg, f32, dev, 15, max_seq)
    assert opts.use_flash_kernel and sites == 2
    plain = ModelOptions()
    p1 = lm.layer_slice(params, 0)  # vocab 32000 is a multiple of 2
    rng = np.random.default_rng(15)
    runs = {}

    def check(name, reqs, comps):
        mism = 0
        for r, c in zip(sorted(reqs, key=lambda r: r.rid), comps):
            assert len(c.tokens) == r.max_new_tokens, (name, r.rid)
            want = lm.greedy_generate(cfg, plain, p1, r.prompt,
                                      r.max_new_tokens, max_seq, f32)
            mism += sum(a != b for a, b in zip(c.tokens, want))
        runs[name] = dict(requests=len(comps), mismatches=mism)
        assert mism == 0, f"{name}: {mism} tokens differ from the oracle"

    # the dense engine: phase 9's staggered shapes, slots recycled
    shapes = [(40, 4), (70, 3), (33, 5), (64, 6), (17, 2), (50, 4), (29, 3)]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                    g, arrival=0.5 * i) for i, (p, g) in enumerate(shapes)]
    engine, resets = make(), []
    reset = engine.reset_fn

    def checked_reset(cache, mask):
        cache = reset(cache, mask)
        for k, g, b in torch.as_tensor(mask).nonzero().tolist():
            for part in ("layers", "shared"):
                for buf in cache[part].values():
                    assert not buf[k, g, :, b].any(), \
                        f"a reset row of the {part} cache is not zero"
        resets.append(int(np.asarray(mask).sum()))
        return cache

    engine.reset_fn = checked_reset
    check("dense_engine", reqs, engine.run([r.clone() for r in reqs]))
    assert sum(resets) == len(reqs) > engine.batcher.n_cells  # recycled
    runs["dense_engine"].update(calls=engine.stats.calls,
                                reset_rows=sum(resets))
    del engine
    # static serving: K1 at head_dim 112 in every prefill call
    sreqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                     (128 if i < 4 else 100,))
                     .astype(np.int32), int(g))
             for i, g in enumerate(rng.integers(3, 9, 8))]
    reset_counts(fa)
    comps, st = static_serve(cfg, eng, params, sreqs, opts, device=dev)
    check("static_k1", sreqs, comps)
    assert fa.launches == 2 * eng.n_slots * sites, fa.launches
    runs["static_k1"].update(calls=st.calls, k1_launches=fa.launches)

    # chunked prefill: 2 request groups of 128 tokens in 4 chunks each
    def prefill(p_eng, toks, o):
        cache = pl.serve_cache_struct(cfg, p_eng, device=dev)
        step = pl.make_serve_step(cfg, o, p_eng, "prefill")
        cache, tok, _ = step(params, cache,
                             {"tokens": torch.from_numpy(toks).to(dev)})
        return tree_leaves(cache), tok.cpu().numpy()

    seq, nc = 128, 4
    eng_p = dataclasses.replace(eng, max_seq=seq, prefill_chunks=1)
    eng_c = dataclasses.replace(eng_p, n_microbatches=2 * nc,
                                prefill_chunks=nc)
    toks = rng.integers(0, cfg.vocab_size, (1, 2, 2, seq)).astype(np.int32)
    chunks = np.ascontiguousarray(
        toks.reshape(1, 2, 2, nc, seq // nc).transpose(0, 1, 3, 2, 4)
        .reshape(1, 2 * nc, 2, seq // nc))
    cache_p, tok_p = prefill(eng_p, toks, opts)
    cache_c, tok_c = prefill(eng_c, chunks, opts)
    cache_r, tok_r = prefill(eng_p, toks, plain)  # no kernel
    diff = lambda xs, ys: max(float((x.float() - y.float()).abs().max())
                              for x, y in zip(xs, ys))
    runs["chunked_prefill"] = dict(
        mismatches=int((tok_p != tok_c.reshape(1, 2, nc, 2)[:, :, -1]).sum()
                       + (tok_p != tok_r).sum()),
        chunked_cache_max_abs_diff=diff(cache_p, cache_c),
        plain_cache_max_abs_diff=diff(cache_p, cache_r))
    assert runs["chunked_prefill"]["mismatches"] == 0 \
        and runs["chunked_prefill"]["chunked_cache_max_abs_diff"] < 5e-4 \
        and runs["chunked_prefill"]["plain_cache_max_abs_diff"] < 5e-4, \
        runs["chunked_prefill"]
    del params, p1, cache_p, cache_c, cache_r
    gc.collect()
    torch.cuda.empty_cache()
    # the train step, K1 fp32 at head_dim 112
    reset_counts(fa)
    runs["train"] = train_vs_sequential(
        cfg, kernel_options(cfg, remat=True), 256, 15, dev, card)
    runs["train"]["k1_launches"] = dict(fa.variant_launches)
    assert fa.variant_launches["fp32"] > 0, "the train step ran no K1"
    return runs


# phase 15 (b)'s depth: zamba2-7b's first 12 of 81 layers (2 shared
# sites), every width as published; all 81 took 94-104 s of the 1200 s
# budget, which phase 17 needs, and 24 layers 35-38 s
P15B_LAYERS = 12


def phase15(fa, dev, card):
    """The hybrid family: (a) :func:`phase15_exact`; (b) serving zamba2-7b
    cut to ``P15B_LAYERS`` layers (2 shared sites) in bf16 through the
    dense engine on phase 5's grid and trace, then static serving of 8 x
    512-token prompts with K1 at head_dim 112 in each prefill call, every
    K1 launch of one profiled prefill call against the plain version;
    (c) ``run_model_selection`` on 12 full-width layers, seq 2048, K1 fp32
    at head_dim 112."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.models.layers import kernel_options
    from repro_torch.models import lm
    from repro_torch.serve import Request, static_serve

    out = dict(card=card)
    marks, t_mark = {}, [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    out["a"] = phase15_exact(fa, dev, card)
    say("phase 15 (a): full-width 12-layer fp32 zamba2-7b dense engine, "
        "static (K1 hd 112), chunked prefill and train step:",
        json.dumps(out["a"]))
    gc.collect()
    torch.cuda.empty_cache()
    mark("a_exactness")

    # (b) P15B_LAYERS of the 81 layers in bf16, phase 5's grid and traffic
    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=P15B_LAYERS)
    bf16 = torch.bfloat16
    sites = sum(lm.shared_site_flags(cfg, 0, cfg.n_layers)[0])
    say(f"phase 15 (b): zamba2-7b cut to {cfg.n_layers} of 81 layers "
        f"({sites} shared sites), every width as published")
    gen_len, max_seq = 32, 1024 + 32
    t0 = time.perf_counter()
    eng, opts, params, make = dense_engine(cfg, bf16, dev, 0, max_seq)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(p),))
                    .astype(np.int32), gen_len, arrival=float(i))
            for i, p in enumerate(rng.integers(128, 1025, 8))]
    times = {"decode": [], "append": []}

    def timed(name, step):
        def run(params_, cache, batch):
            t = time.perf_counter()
            res = step(params_, cache, batch)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            return res
        return run

    engine = make()
    engine.decode_step = timed("decode", engine.decode_step)
    engine.append_step = timed("append", engine.append_step)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    comps = engine.run([r.clone() for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    shared_mb = sum(b.numel() * b.element_size()
                    for b in engine.cache["shared"].values()) / 1e6
    state_mb = engine.cache["layers"]["ssm"].numel() * 4 / 1e6
    for r, c in zip(reqs, comps):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    del engine
    gc.collect()
    mark("b_serve")
    again = make()
    comps2 = again.run([r.clone() for r in reqs])
    assert [c.tokens for c in comps2] == [c.tokens for c in comps], \
        "the same trace gave different tokens on a second run"
    ops_per_decode, busy_ms = profile_decode_call(again, reqs[0])
    del again
    gc.collect()
    mark("b_again_profile")
    decode_ms = 1e3 * float(np.median(times["decode"]))
    serve = dict(
        layers=cfg.n_layers, shared_sites=sites, d_model=cfg.d_model,
        dtype="bfloat16", params=cfg.param_count(), stages=eng.n_stages,
        slots=eng.n_microbatches, microbatch=eng.microbatch,
        requests=len(comps), prompt_tokens=st.prompt_tokens,
        tokens_generated=st.tokens_generated, ticks=st.ticks,
        calls=st.calls, decode_calls=len(times["decode"]),
        append_calls=len(times["append"]), wall_s=wall,
        generated_tok_per_s=st.tokens_generated / wall,
        decode_ms_per_call=decode_ms,
        append_ms_per_call=1e3 * float(np.median(times["append"])),
        max_memory_allocated_gb=peak / 1e9,
        shared_strips_mb=shared_mb, ssm_state_mb=state_mb,
        host_ops_per_decode_call=ops_per_decode,
        decode_device_busy_ms=busy_ms,
        decode_device_idle_share=(None if busy_ms is None
                                  else 1.0 - busy_ms / decode_ms),
        param_init_s=init_s, ttft_p50_ticks=st.summary().get("ttft_p50"))
    say(f"phase 15 (b): zamba2-7b ({cfg.n_layers} layers) bf16 dense "
        f"serving:", json.dumps(serve))

    # static serving of 8 x 512-token prompts: K1 (bf16, head_dim 112) in
    # every prefill call, 13 sites a slot
    plen = 512
    rng = np.random.default_rng(13)
    sreqs = [Request(i, rng.integers(0, cfg.vocab_size, (plen,))
                     .astype(np.int32), int(g), arrival=float(i))
             for i, g in enumerate(rng.integers(16, 33, 8))]
    static_eng = dataclasses.replace(eng, max_seq=plen + 32,
                                     prefill_chunks=1)
    stimes = {}
    restore = timed_steps(pl, stimes)
    reset_counts(fa)
    try:
        t = time.perf_counter()
        scomps, sst = static_serve(cfg, static_eng, params, sreqs, opts,
                                   device=dev)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t
    finally:
        restore()
    k1_launches = fa.launches
    k1_variants = dict(fa.variant_launches)
    want = len(stimes["prefill"]) * static_eng.n_slots * sites
    assert k1_launches == want == k1_variants["mma_bf16"] > 0, \
        (k1_launches, want, k1_variants)
    for r, c in zip(sreqs, scomps):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    step = pl.make_serve_step(cfg, opts, static_eng, "prefill")
    tokens = np.stack([r.prompt for r in sreqs[:4]]).reshape(1, 2, 2, plen)
    cache = pl.serve_cache_struct(cfg, static_eng, device=dev)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    (_, tok, _), host, k1_rec = k1_call_vs_plain(
        fa, lambda: step(params, cache, batch))
    assert tok.cpu().numpy().reshape(-1).tolist() == \
        [c.tokens[0] for c in scomps[:4]], "profiled prefill's tokens"
    assert k1_rec["launches"] == static_eng.n_slots * sites
    prefill_ms = 1e3 * float(np.median(stimes["prefill"]))
    k1_rec.update(host_ops=host, prefill_ms_per_call=prefill_ms)
    if k1_rec["device_busy_ms"] is not None:
        k1_rec["idle_share"] = 1.0 - k1_rec["device_busy_ms"] / prefill_ms
        k1_rec["k1_share_of_busy"] = (k1_rec["ms_per_launch"]
                                      * k1_rec["launches"]
                                      / k1_rec["device_busy_ms"])
    static = dict(
        wall_s=swall, generated_tok_per_s=sst.tokens_generated / swall,
        calls=sst.calls, prefill_calls=len(stimes["prefill"]),
        decode_calls=len(stimes["decode"]), prefill_ms_per_call=prefill_ms,
        decode_ms_per_call=1e3 * float(np.median(stimes["decode"])),
        tokens_generated=sst.tokens_generated, k1_launches=k1_launches,
        k1_variant_launches=k1_variants, k1_prefill=k1_rec,
        requests=len(sreqs), prompt_len=plen)
    out["b"] = dict(dense=serve, static=static)
    say(f"phase 15 (b): zamba2-7b ({cfg.n_layers} layers) bf16 static "
        f"serving (K1 hd 112):", json.dumps(static))
    del params, cache, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    mark("b_static")

    # (c) training: 12 full-width layers, seq 2048, K1 fp32 at hd 112
    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=12)
    sites12, n_steps = sum(lm.shared_site_flags(cfg, 0, 12)[0]), 2

    def expected(K, M, S):
        # one K1 launch per shared-block forward, which runs inside its
        # site's layer: per step, per (trial, microbatch) slot, each site
        # runs in the forward, the (stage, slot) recompute and the layer
        # recompute, less the layer recompute torch's checkpoint early
        # stop skips (the last layer of each stage before the last: layer
        # 5, a site); then one evaluation pass per slot
        return n_steps * K * M * (3 * sites12 - (S - 1)) + K * M * sites12

    # no profiled step: it cost about a minute of the script's 1200 s; 2
    # steps, not 3: each took 15-35 s (host clock)
    out["c"], launches = selection_path(fa, "flash_attention_kernel", cfg,
                                        kernel_options(cfg, remat=True),
                                        2048, n_steps, expected, dev, card,
                                        profile=False)
    assert out["c"]["variant_launches"]["fp32"] == launches
    say("phase 15 (c): run_model_selection, zamba2-7b 12 layers fp32 (K1 "
        "hd 112):", json.dumps(out["c"]))
    mark("c_train")
    out["seconds"] = marks
    return out, dict(k1_static_prefill=k1_launches, k1_training=launches)


# ---------------------------------------------------------------------------
# Phase 16: the MoE family (granite-moe-3b-a800m; llama4-scout-17b-a16e)
# ---------------------------------------------------------------------------

GRANITE, SCOUT = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"
GRANITE_HEADS = (24, 8, 64)  # query heads, KV heads, head_dim: group 3
# phase 16 (c) and (e)'s depth: the first 4 of granite's 32 layers, every
# width as published (cut to keep the script inside its 1200 s: on an
# NVIDIA H100 80GB HBM3 (c) took 59.0 s at 16 layers, 29-31 s at 8, and
# (e) 70-77 s at 8)
P16C_LAYERS = 4
# K2 at granite's serving shapes (``CASES`` rows: phase 2's original decode
# and append sweep, then phase 5's own shapes) and K1 at its training shape
# (a ``FLASH_CASES`` row)
MOE_K2_CASES = [
    ("granite_decode", 1, [0, 16, 129, 510, 1023, 1499, 1999, 2047], None,
     0, BS, 128, True),
    ("granite_append64", 64, [0, 100, 700, 1900], None, 0, BS, 128, True),
    ("granite_p5_decode", 1, [140, 1055], None, 0, BS, 66, False),
    ("granite_p5_append486", 486, [487, 0], None, 0, BS, 64, False),
]
MOE_K1_CASE = ("granite_train2048_hd64", 1, 2048, 2048, *GRANITE_HEADS, True,
               0, 0)


@contextlib.contextmanager
def moe_annotated():
    """Profiler ranges around every ``moe_apply`` ("moe_apply") and every
    expert FFN inside it ("moe_experts"), recomputes included: the
    wrappers replace the module attributes the blocks and ``moe_apply``
    look up at call time, and are removed on exit."""
    from torch.profiler import record_function
    from repro_torch.models import layers as L

    real_apply, real_ffn = L.moe_apply, L._expert_ffn

    def apply(*a, **kw):
        with record_function("moe_apply"):
            return real_apply(*a, **kw)

    def ffn(*a, **kw):
        with record_function("moe_experts"):
            return real_ffn(*a, **kw)

    L.moe_apply, L._expert_ffn = apply, ffn
    try:
        yield
    finally:
        L.moe_apply, L._expert_ffn = real_apply, real_ffn


def _finder(intervals):
    """t -> the interval of ``intervals`` (non-nesting (start, end, ...)
    tuples) that holds t, or None."""
    from bisect import bisect_right

    intervals = sorted(intervals, key=lambda x: x[0])
    starts = [x[0] for x in intervals]

    def find(t):
        i = bisect_right(starts, t) - 1
        return intervals[i] if i >= 0 and t <= intervals[i][1] else None
    return find


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def op_regions(evs) -> dict:
    """{correlation id: "moe_experts" or "moe_apply"} for the aten ops of
    a profile's raw records (run under :func:`moe_annotated`) that belong
    to a MoE region: a forward op to the innermost range it ran in, on its
    thread (recomputes included); a backward op to the forward op whose
    autograd node it runs in (the node's sequence number), unless it is
    part of a recompute inside that node."""
    from torch.autograd import DeviceType

    cpu = [e for e in evs if e.device_type() == DeviceType.CPU]
    spans = {"moe_experts": {}, "moe_apply": {}}
    nodes = {}
    for e in cpu:
        name, th = e.name(), e.start_thread_id()
        if name in spans:
            spans[name].setdefault(th, []).append((e.start_ns(), e.end_ns()))
        elif name.startswith("autograd::engine::evaluate_function"):
            nodes.setdefault(th, []).append(
                (e.start_ns(), e.end_ns(), (e.fwd_thread_id(),
                                            e.sequence_nr())))
    spans = {n: {th: _finder(v) for th, v in d.items()}
             for n, d in spans.items()}
    node_at = {th: _finder(v) for th, v in nodes.items()}
    aten = [e for e in cpu if e.name().startswith("aten::")]

    def span_region(e):
        for name in ("moe_experts", "moe_apply"):
            f = spans[name].get(e.start_thread_id())
            if f and f(e.start_ns()):
                return name
        return None

    fwd, recompute = {}, {}
    for e in aten:
        th = e.start_thread_id()
        if e.sequence_nr() < 0:
            continue
        r = span_region(e)
        if r:
            fwd[(th, e.sequence_nr())] = r
        if th in node_at and node_at[th](e.start_ns()):
            recompute.setdefault(th, []).append((e.start_ns(), e.end_ns()))
    recompute = {th: _finder(_merged(v)) for th, v in recompute.items()}
    region = {}
    for e in aten:
        r = span_region(e)
        th, t = e.start_thread_id(), e.start_ns()
        if r is None and th in node_at:
            node = node_at[th](t)
            if node and not (th in recompute and recompute[th](t)):
                r = fwd.get(node[2])
        if r:
            region[e.correlation_id()] = r
    return region


def busy_by_region(prof, kernel_names, kernel_label):
    """The card's busy ms of a profile (run under :func:`moe_annotated`)
    by region: "expert_products" (the expert FFNs' matmuls and
    activations), "routing_dispatch" (the rest of ``moe_apply``: router,
    softmax, sort, ranks, scatter into the buckets, gather back, aux),
    ``kernel_label`` (kernels named by ``kernel_names``) and "rest"; and
    the routing and dispatch's five costliest kernels by name ([name, ms,
    launches]). Returns (ms by region, top kernels). Read from the raw
    records: a device
    kernel belongs to the aten op that launched it
    (``linked_correlation_id``), whose region :func:`op_regions` gives."""
    evs = list(prof.profiler.kineto_results.events())
    region = op_regions(evs)
    names = {"moe_experts": "expert_products",
             "moe_apply": "routing_dispatch"}
    out = {"expert_products": 0.0, "routing_dispatch": 0.0,
           kernel_label: 0.0, "rest": 0.0}
    routing = {}
    for e in evs:
        if not on_card(e):
            continue
        r = region.get(e.linked_correlation_id())
        if r:
            key = names[r]
        elif any(k in e.name() for k in kernel_names):
            key = kernel_label
        else:
            key = "rest"
        ms = e.duration_ns() / 1e6
        out[key] += ms
        if key == "routing_dispatch":
            n = e.name()[:80]
            ms0, k0 = routing.get(n, (0.0, 0))
            routing[n] = (ms0 + ms, k0 + 1)
    top = sorted(([n, ms, k] for n, (ms, k) in routing.items()),
                 key=lambda x: -x[1])[:5]
    return out, top


def profile_moe_call(engine, req, step_attr):
    """{host ops, busy ms, busy ms by region, the routing's top kernels}
    of the first ``step_attr`` call (``decode_step`` or ``append_step``)
    while ``engine`` serves ``req`` alone for two new tokens (its prefill
    appends, then one decode), profiled under :func:`moe_annotated`."""
    from torch.profiler import ProfilerActivity, profile

    step, out = getattr(engine, step_attr), []

    def profiled(params, cache, batch):
        if out:
            return step(params, cache, batch)
        with moe_annotated(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = step(params, cache, batch)
            torch.cuda.synchronize()
        by, top = busy_by_region(prof, K2_KERNELS, "k2")
        out.append(dict(host_ops=host_ops(prof.events()),
                        device_busy_ms=sum(by.values()),
                        busy_ms_by_region=by, top_routing_kernels=top))
        return res

    setattr(engine, step_attr, profiled)
    r = req.clone()
    r.max_new_tokens = 2
    try:
        engine.run([r])
    finally:
        setattr(engine, step_attr, step)
    assert out, f"no {step_attr} call was profiled"
    return out[0]


def oracle_params(cfg, params, k=0):
    """Trial k's weights as ``lm.greedy_generate`` takes them: views of
    the stacked tensors, the vocab padding sliced away (no copies)."""
    from repro_torch.models import lm

    p = lm.layer_slice(params, k)
    p["embed"] = dict(p["embed"], tok=p["embed"]["tok"][:cfg.vocab_size])
    p["head"] = p["head"][:, :cfg.vocab_size]
    return p


def paged_engine_exact(pa, cfg, opts, dev, card, label, extra=None):
    """Phase 4's engine and trace on ``cfg`` at full width (the caller
    cuts the depth), fp32 weights and pool, 2 stages, 2 data shards, K2
    under ``opts``: every request's greedy tokens equal the single-device
    oracle's, and K2's launches equal calls × slots × layers. Prints and
    returns the record (with ``extra`` in it), and frees the weights."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, blocks_for

    max_seq = 80
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=2, max_seq=max_seq,
                          cache_dtype=torch.float32, prefill_chunks=2,
                          paged=True, block_size=BS,
                          n_blocks=4 * blocks_for(max_seq, BS))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(1)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  dtype=torch.float32, device=dev,
                                  max_pos=max_seq)
    reqs = trace4(cfg.vocab_size)
    engine = ServeEngine(cfg, eng, params, opts, device=dev)
    reset_counts(pa)
    comps = engine.run([r.clone() for r in reqs])
    launches = pa.launches
    expected = engine.stats.calls * eng.n_slots * cfg.n_layers
    assert engine.allocator.all_free()
    p1 = oracle_params(cfg, params)
    mismatches = 0
    for r, c in zip(reqs, comps):
        want = lm.greedy_generate(cfg, opts, p1, r.prompt, r.max_new_tokens,
                                  max_seq, torch.float32)
        mismatches += sum(a != b for a, b in zip(c.tokens, want)) \
            + abs(len(c.tokens) - len(want))
    rec = dict(card=card, arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, **(extra or {}),
               heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
               padded_vocab=eng.padded_vocab(cfg.vocab_size),
               requests=len(comps), tokens=sum(len(c.tokens) for c in comps),
               mismatches=mismatches, calls=engine.stats.calls,
               ticks=engine.stats.ticks, kernel_launches=launches,
               expected_launches=expected,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9)
    say(f"{label}: 2-layer fp32 engine (2 stages, 2 data shards) vs "
        f"single-device oracle:", json.dumps(rec))
    assert mismatches == 0, f"{cfg.name}: {mismatches} tokens differ"
    assert launches == expected > 0, (cfg.name, launches, expected)
    del engine, params, p1
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase16_serve_exact(pa, dev, card):
    """(b) :func:`paged_engine_exact` on granite-moe-3b-a800m and
    llama4-scout-17b-a16e at 2 layers (each data shard's rows routed
    alone), at the capacity factor E / k (the least at which no pick is
    dropped: C = t); llama4-scout's ~25 GB of weights are freed before
    the next run."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import ModelOptions

    out = {}
    for name in (GRANITE, SCOUT):
        cfg = dataclasses.replace(get_config(name), n_layers=2)
        cf = cfg.moe.n_experts / cfg.moe.top_k
        opts = ModelOptions(use_paged_kernel=True, moe_capacity_factor=cf)
        out[name] = paged_engine_exact(
            pa, cfg, opts, dev, card, "phase 16 (b)",
            dict(experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                 capacity_factor=cf))
    return out


def routing_diff(cfg, opts, ref_opts, seq, seed, dev, data_size) -> int:
    """Routing decisions (expert ids, and kept or dropped) that differ
    between ``opts`` (K1) and ``ref_opts`` (plain attention) on
    :func:`train_vs_sequential`'s first batch at its initial weights, over
    every trial, microbatch, data shard and layer."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.data.pipeline import TrainBatches
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    eng = pl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=data_size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  device=dev)
    data = TrainBatches(cfg, eng, seq, seed=0)
    batch = data.batch_for_step(0)
    data.close()
    real, seen = L.moe_apply, []

    def recording(p, x, **kw):
        _, _, idx, rank, cap = L.moe_route(
            p["router"], x, n_experts=kw["n_experts"], top_k=kw["top_k"],
            capacity_factor=kw["capacity_factor"], n_shards=kw["n_shards"])
        seen[-1].append((idx, rank.reshape(idx.shape) < cap))
        return real(p, x, **kw)

    L.moe_apply = recording
    differ = 0
    try:
        with torch.no_grad():
            for k in range(eng.n_trials):
                p = oracle_params(cfg, params, k)
                for m in range(eng.n_microbatches):
                    toks = torch.from_numpy(batch["tokens"][k, m]).to(dev)
                    for ts in toks.chunk(data_size):
                        runs = []
                        for o in (opts, ref_opts):
                            seen.append([])
                            lm.forward(cfg, o, p, {"tokens": ts})
                            runs.append(seen.pop())
                        for (ia, ka), (ib, kb) in zip(*runs):
                            differ += int((ia != ib).sum() + (ka != kb).sum())
    finally:
        L.moe_apply = real
    return differ


def phase16(pa, fa, ops, dev, new_flush, card):
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.layers import ModelOptions, kernel_options

    out, marks, t_mark = {}, {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    # (a) K2 and K1 at granite's shapes (24 query heads on 8, head_dim 64)
    failed, k2, k1 = [], [], []
    gen = torch.Generator(device=dev).manual_seed(16)
    flush = new_flush()
    for dt in (torch.float32, torch.bfloat16):
        for i, case in enumerate(MOE_K2_CASES):
            rec, failure = k2_check(pa, dev, flush, card, dt, 100 + i, case,
                                    GRANITE_HEADS)
            if failure:
                failed.append(failure)
            k2.append(rec)
            say("phase 16 (a):", json.dumps(rec))
        rec = k1_check(fa, ops, dev, flush, card, gen, dt, MOE_K1_CASE, True,
                       failed)
        k1.append(rec)
        say("phase 16 (a):", json.dumps(rec))
    assert not failed, "phase 16 (a): " + "; ".join(failed)
    out["a"] = dict(k2=k2, k1=k1)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    mark("a_kernels")

    # (b) serving exactness: granite and llama4-scout, 2 fp32 layers
    out["b"] = phase16_serve_exact(pa, dev, card)
    mark("b_serve_exact")

    # (c) granite at P16C_LAYERS of its 32 layers, bf16, the launcher's
    # capacity factor
    cfg = dataclasses.replace(get_config(GRANITE), n_layers=P16C_LAYERS)
    opts = kernel_options(cfg, compute_dtype=torch.bfloat16,
                          use_paged_kernel=True)
    rec, serve_launches, ctx = paged_serve_path(pa, cfg, opts, dev, card)
    from repro_torch.serve import ServeEngine
    make = lambda: ServeEngine(cfg, ctx["eng"], ctx["params"], opts,
                               device=dev)
    req = ctx["reqs"][-1]
    for kind in ("decode", "append"):
        rec[f"{kind}_profile"] = profile_moe_call(make(), req, f"{kind}_step")
    # every moe_apply of one decode call with the card's sync check armed
    engine, real, n_checked = make(), L.moe_apply, [0]
    step, in_decode = engine.decode_step, [False]

    def armed(*a, **kw):
        if not in_decode[0]:
            return real(*a, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n_checked[0] += 1
        return res

    def decode_once(params, cache, batch):
        in_decode[0] = n_checked[0] == 0
        try:
            return step(params, cache, batch)
        finally:
            in_decode[0] = False

    engine.decode_step, L.moe_apply = decode_once, armed
    r = req.clone()
    r.max_new_tokens = 2
    try:
        engine.run([r])
    finally:
        L.moe_apply = real
    assert n_checked[0] == ctx["eng"].n_slots * cfg.n_layers, n_checked
    rec["sync_free_moe_apply_calls"] = n_checked[0]
    say(f"phase 16 (c): granite-moe-3b-a800m {P16C_LAYERS} layers bf16 "
        f"paged serving:",
        json.dumps(rec))
    out["c"] = rec
    del ctx, engine, make
    gc.collect()
    torch.cuda.empty_cache()
    mark("c_serve")

    # (d) training exactness at the dropless factor E / k and at the
    # launcher's 1.25 (drops included: the same rows go to the same
    # shards on both sides)
    cfg = dataclasses.replace(get_config(GRANITE), n_layers=2)
    out["d"] = {}
    for cf in (cfg.moe.n_experts / cfg.moe.top_k, 1.25):
        k1_opts = ModelOptions(remat=True, use_flash_kernel=True,
                               moe_capacity_factor=cf)
        ref = ModelOptions(moe_capacity_factor=cf)
        try:
            rec = train_vs_sequential(cfg, k1_opts, 512, 3, dev, card,
                                      ref_opts=ref, data_size=2)
        except AssertionError as e:
            n = routing_diff(cfg, k1_opts, ref, 512, 3, dev, 2)
            raise AssertionError(
                f"phase 16 (d) at capacity factor {cf}: {e}; routing "
                f"decisions differing between K1 and plain attention at "
                f"the first step: {n}") from e
        rec["capacity_factor"] = cf
        out["d"][str(cf)] = rec
        say(f"phase 16 (d): pipelined train step (K1, 2 data shards, "
            f"factor {cf}) vs sequential runs:", json.dumps(rec))
    mark("d_train_exact")

    # (e) run_model_selection on P16C_LAYERS full-width layers, seq 2048,
    # K1 fp32
    cfg = dataclasses.replace(get_config(GRANITE), n_layers=P16C_LAYERS)
    n_steps, seq = 3, 2048
    opts = kernel_options(cfg, remat=True)

    def expected(K, M, S):
        # as phase 7: three forwards of every layer per (trial,
        # microbatch) slot a step, less the layer recompute torch's
        # checkpoint early stop skips in each stage before the last; one
        # evaluation pass per slot
        return n_steps * K * M * (3 * cfg.n_layers - (S - 1)) \
            + K * M * cfg.n_layers

    rec, train_launches = selection_path(
        fa, "flash_attention_kernel", cfg, opts, seq, n_steps, expected, dev,
        card, moe=True)
    assert rec["variant_launches"]["fp32"] == train_launches
    from repro_torch.core import pipeline as pl
    eng = pl.EngineConfig(n_trials=rec["trials"],
                          n_microbatches=rec["microbatches"],
                          microbatch=rec["microbatch"],
                          n_stages=rec["stages"])
    padded = moe_padded_flops_per_step(cfg, eng, seq,
                                       opts.moe_capacity_factor)
    rec.update(capacity_factor=opts.moe_capacity_factor,
               capacity_padded_flops_per_step=padded,
               capacity_padded_share_of_fp32_peak=padded
               / (rec["step_ms"] / 1e3) / PEAK_OPS[torch.float32])
    by = rec["profile"]["busy_ms_by_region"]
    busy = sum(by.values())
    rec["moe_share_of_busy"] = ((by["expert_products"]
                                 + by["routing_dispatch"]) / busy
                                if busy else None)  # None: no device trace
    say(f"phase 16 (e): gang plan K={rec['trials']} M={rec['microbatches']}"
        f" (S={rec['stages']}, bubble {rec['bubble_fraction']:.4f})")
    say(f"phase 16 (e): run_model_selection, granite-moe-3b-a800m "
        f"{cfg.n_layers} layers fp32:", json.dumps(rec))
    out["e"] = rec
    mark("e_train")
    out["seconds"] = marks
    return out, dict(serving=serve_launches, training=train_launches)


# ---------------------------------------------------------------------------
# Phase 17: the remaining families (bert-large, musicgen-medium,
# qwen2-vl-72b, yi-34b, starcoder2-15b, the paper's MLP)
# ---------------------------------------------------------------------------

BERT, MUSICGEN, QWEN = "bert-large", "musicgen-medium", "qwen2-vl-72b"
YI, STARCODER = "yi-34b", "starcoder2-15b"
# K1 at the new families' shapes (name, b, sq, sk, hq, hkv, hd, causal,
# window, kv_offset): bert-large's training shape (2 rows a slot, seq 512,
# 16 heads on 16 at hd 64, NON-causal), a ragged non-causal case (100 is
# not a multiple of either kernel's 64-row tile), and the prefills of
# musicgen-medium (24 on 24, hd 64) and qwen2-vl-72b (64 on 8, hd 128)
P17_K1_CASES = [
    ("bert_train512_noncausal", 2, 512, 512, 16, 16, 64, False, 0, 0),
    ("noncausal_ragged_sq100", 2, 100, 100, 4, 4, 64, False, 0, 0),
    ("musicgen_prefill512", 2, 512, 512, 24, 24, 64, True, 0, 0),
    ("qwen2vl_prefill512", 2, 512, 512, 64, 8, 128, True, 0, 0),
]
P17_K1_TIMED = ("bert_train512_noncausal", "musicgen_prefill512",
                "qwen2vl_prefill512")
# K2 at GQA groups 7 (yi-34b: 56 query heads on 8) and 12
# (starcoder2-15b: 48 on 4), head_dim 128: phase 2's decode and append64
P17_K2_HEADS = {"yi34b": (56, 8, 128), "starcoder2": (48, 4, 128)}


def phase17_kernels(pa, fa, ops, dev, flush, card):
    """(a) K1 and K2 at the new shapes against their plain versions, as
    phases 2 and 3 hold them (tolerances, timing, bounds, SDPA beside
    K1, the op's gradients in fp32 — the non-causal backward included)."""
    failed, k1, k2 = [], [], []
    gen = torch.Generator(device=dev).manual_seed(17)
    for dt in (torch.float32, torch.bfloat16):
        for case in P17_K1_CASES:
            rec = k1_check(fa, ops, dev, flush, card, gen, dt, case,
                           case[0] in P17_K1_TIMED, failed)
            k1.append(rec)
            say("phase 17 (a):", json.dumps(rec))
        for tag, heads in P17_K2_HEADS.items():
            for i, row in enumerate(CASES[:2]):  # decode, append64
                rec, failure = k2_check(pa, dev, flush, card, dt, 170 + i,
                                        (f"{tag}_{row[0]}",) + row[1:],
                                        heads)
                if failure:
                    failed.append(failure)
                k2.append(rec)
                say("phase 17 (a):", json.dumps(rec))
    assert not failed, "phase 17 (a): " + "; ".join(failed)
    return dict(k1=k1, k2=k2)


def frontend_batch(cfg, eng, plen, dtype, dev, seed):
    """A prefill batch of a frontend arch on ``eng``'s grid: random
    tokens, standard-normal frontend embeddings in ``dtype`` and, for
    M-RoPE, the image-then-text grid positions (the three streams differ
    over the image), from a numpy seed."""
    from repro_torch.models.frontend import grid_mrope_positions

    rng = np.random.default_rng(seed)
    lead = (eng.n_trials, eng.n_microbatches, eng.mb_global)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, lead + (plen,)).astype(np.int32)).to(dev),
        "frontend_embeds": torch.from_numpy(rng.standard_normal(
            lead + (cfg.n_frontend_tokens, cfg.d_model),
            dtype=np.float32)).to(dev, dtype)}
    if cfg.rope == "mrope":
        batch["mrope_pos"] = grid_mrope_positions(
            cfg, eng.mb_global, plen, device=dev).expand(
                eng.n_trials, eng.n_microbatches, 3, eng.mb_global, plen)
    return batch


def frontend_serve_exact(fa, name, plen, dev, card, n_dec=16):
    """(c) A frontend arch at full width, 2 fp32 layers, through
    ``make_serve_step``: one prefill call (K1, fp32) of 2 slots × 2 data
    shards × 1 row, ``plen``-token prompts whose first nf positions are
    seeded frontend embeddings (and grid M-RoPE positions), then
    ``n_dec`` decode calls. Every row's tokens equal the single-device
    oracle's (``lm.forward`` prefill then decode, plain attention, the
    same embeddings and positions); K1's launches equal slots × layers.
    Returns (record, K1 launches)."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions, kernel_options

    cfg = dataclasses.replace(get_config(name), n_layers=2)
    max_seq = plen + n_dec
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=2, max_seq=max_seq,
                          cache_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(17)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  dtype=torch.float32, device=dev,
                                  max_pos=max_seq)
    opts = kernel_options(cfg)
    batch = frontend_batch(cfg, eng, plen, torch.float32, dev, 17)
    prefill = pl.make_serve_step(cfg, opts, eng, "prefill")
    decode = pl.make_serve_step(cfg, opts, eng, "decode")
    cache = pl.serve_cache_struct(cfg, eng, device=dev)
    reset_counts(fa)
    cache, tok, _ = prefill(params, cache, batch)
    toks = [tok]
    for i in range(n_dec):
        pos = torch.full(tok.shape, plen + i, dtype=torch.int32, device=dev)
        cache, tok, _ = decode(params, cache, {"tokens": toks[-1][..., None],
                                               "positions": pos})
        toks.append(tok)
    torch.cuda.synchronize()
    launches = fa.launches
    got = torch.stack(toks, -1)[0].cpu()  # (M, mbg, 1 + n_dec)
    p1 = oracle_params(cfg, params)
    mismatches, plain = 0, ModelOptions()
    with torch.no_grad():
        for m in range(eng.n_microbatches):
            sub = {n: v[0, m] for n, v in batch.items()}
            oc = lm.init_cache(cfg, eng.mb_global, max_seq,
                               cache_dtype=torch.float32, device=dev,
                               n_layers=lm.n_stacked_layers(p1["layers"]))
            logits, oc, _ = lm.forward(cfg, plain, p1, sub, mode="prefill",
                                       cache=oc)
            want = [logits[:, -1].argmax(-1)]
            for i in range(n_dec):
                logits, oc, _ = lm.forward(
                    cfg, plain, p1, {"tokens": want[-1][:, None]},
                    mode="decode", cache=oc,
                    kv_offset=torch.full((eng.mb_global,), plen + i,
                                         device=dev))
                want.append(logits[:, 0].argmax(-1))
            mismatches += int((torch.stack(want, -1).cpu() != got[m]).sum())
    rec = dict(card=card, arch=name, layers=cfg.n_layers,
               d_model=cfg.d_model, params=cfg.param_count(),
               heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
               rope=cfg.rope, frontend_tokens=cfg.n_frontend_tokens,
               rows=eng.n_slots * eng.mb_global, prompt_len=plen,
               decode_calls=n_dec, tokens=int(got.numel()),
               mismatches=mismatches, k1_launches=launches,
               expected_k1_launches=eng.n_slots * cfg.n_layers,
               k1_variants=dict(fa.variant_launches),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9)
    say("phase 17 (c): 2-layer fp32 make_serve_step prefill (frontend "
        "rows, K1) + decode vs single-device oracle:", json.dumps(rec))
    assert mismatches == 0, f"{name}: {mismatches} tokens differ"
    assert launches == eng.n_slots * cfg.n_layers \
        == fa.variant_launches["fp32"], (launches, fa.variant_launches)
    del params, p1, cache
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def musicgen_full(fa, dev, card):
    """(d) musicgen-medium at full depth (48 layers) in bf16 through
    ``make_serve_step``: one prefill call of 8 prompts × 512 tokens (2
    slots × microbatch 2 × 2 data shards; the first 64 positions seeded
    conditioning frames), then 32 decode calls, 2 stages. K1's launches
    equal slots × layers, all on the tensor cores; a second prefill call
    has every K1 launch held against the plain version; one decode call
    is profiled for host ops and the card's idle share. Returns (record,
    K1 launches of the timed prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models.layers import kernel_options

    cfg, bf16 = get_config(MUSICGEN), torch.bfloat16
    plen, n_dec = 512, 32
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                          n_stages=2, data_size=2, max_seq=plen + n_dec,
                          cache_dtype=bf16)
    opts = kernel_options(cfg, compute_dtype=bf16)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  dtype=bf16, device=dev,
                                  max_pos=eng.max_seq)
    batch = frontend_batch(cfg, eng, plen, bf16, dev, 0)
    prefill = pl.make_serve_step(cfg, opts, eng, "prefill")
    decode = pl.make_serve_step(cfg, opts, eng, "decode")
    cache = pl.serve_cache_struct(cfg, eng, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    cache, tok, _ = prefill(params, cache, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches, variants = fa.launches, dict(fa.variant_launches)
    assert launches == eng.n_slots * cfg.n_layers == variants["mma_bf16"], \
        (launches, variants)
    toks, dec_s = [tok], []
    for i in range(n_dec):
        t = time.perf_counter()
        pos = torch.full(tok.shape, plen + i, dtype=torch.int32, device=dev)
        cache, tok, _ = decode(params, cache, {"tokens": toks[-1][..., None],
                                               "positions": pos})
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t)
        toks.append(tok)
    wall = prefill_s + sum(dec_s)
    peak = torch.cuda.max_memory_allocated()
    out = torch.stack(toks, -1).cpu()
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids"
    # a second prefill call: every K1 launch against the plain version
    cache2 = pl.serve_cache_struct(cfg, eng, device=dev)
    (cache2, tok2, _), host_p, k1_rec = k1_call_vs_plain(
        fa, lambda: prefill(params, cache2, batch))
    assert torch.equal(tok2.cpu(), out[..., 0]), "repeated prefill's tokens"
    assert k1_rec["launches"] == launches
    # one decode call, profiled
    pos = torch.full(tok2.shape, plen, dtype=torch.int32, device=dev)
    _, host_d, evs = profile_call(lambda: decode(
        params, cache2, {"tokens": tok2[..., None], "positions": pos}))
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3 if evs \
        else None
    decode_ms = 1e3 * float(np.median(dec_s))
    prefill_ms = 1e3 * prefill_s
    rows = eng.n_slots * eng.mb_global
    rec = dict(
        card=card, arch=MUSICGEN, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype="bfloat16", params=cfg.param_count(), stages=eng.n_stages,
        slots=eng.n_microbatches, microbatch=eng.microbatch,
        data_shards=eng.data_size, prompts=rows, prompt_len=plen,
        frontend_tokens=cfg.n_frontend_tokens, decode_calls=n_dec,
        tokens_generated=int(out.numel()), wall_s=wall,
        generated_tok_per_s=out.numel() / wall,
        prefill_tok_per_s=rows * plen / prefill_s, prefill_ms=prefill_ms,
        decode_ms_per_call=decode_ms, decode_ms_all=[1e3 * x for x in dec_s],
        k1_launches=launches, k1_variant_launches=variants,
        k1_prefill=dict(k1_rec, host_ops=host_p),
        host_ops_per_decode_call=host_d, decode_device_busy_ms=busy,
        decode_device_idle_share=(None if busy is None
                                  else 1.0 - busy / decode_ms),
        max_memory_allocated_gb=peak / 1e9, param_init_s=init_s)
    if k1_rec["device_busy_ms"] is not None:
        rec["k1_share_of_prefill_busy"] = (k1_rec["ms_per_launch"]
                                           * launches
                                           / k1_rec["device_busy_ms"])
    say("phase 17 (d): musicgen-medium 48 bf16 layers, make_serve_step "
        "prefill + decode:", json.dumps(rec))
    del params, cache, cache2
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def mlp_sgd(dev, card, n_steps=20):
    """(g) The paper's MLP (mlp-1m, 1,195,018 parameters) trained
    ``n_steps`` steps with ``SGD(momentum=0.9)`` on the card and on the
    CPU from the same weights and batches (64 rows a step, numpy-seeded):
    losses within 1e-5 (fp32; TF32 off, as phase 1 sets it)."""
    from repro_torch.configs import MLP_CONFIG
    from repro_torch.models import lm
    from repro_torch.optim import SGD
    from repro_torch.tree import tree_leaves, tree_map

    rng = np.random.default_rng(17)
    xs = torch.from_numpy(rng.standard_normal(
        (n_steps, 64, MLP_CONFIG.d_in), dtype=np.float32))
    ys = torch.from_numpy(rng.integers(0, MLP_CONFIG.d_out,
                                       (n_steps, 64)).astype(np.int64))
    init = lm.mlp_init(MLP_CONFIG, torch.Generator().manual_seed(17))

    def train(device):
        params = tree_map(lambda t: t.to(device, copy=True)
                          .requires_grad_(), init)
        opt = SGD(momentum=0.9)
        state = opt.init(params)
        losses = []
        t = time.perf_counter()
        for i in range(n_steps):
            loss = lm.mlp_loss(params, {"x": xs[i].to(device),
                                        "y": ys[i].to(device)})
            loss.backward()
            grads = tree_map(lambda p: p.grad, params)
            opt.update(params, grads, state, {"lr": [0.05]}, i)
            for p in tree_leaves(params):
                p.grad = None
            losses.append(loss.item())
        return losses, time.perf_counter() - t, params

    card_losses, card_s, card_p = train(dev)
    cpu_losses, cpu_s, cpu_p = train("cpu")
    err = max(abs(a - b) for a, b in zip(card_losses, cpu_losses))
    perr = max(float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
    rec = dict(card=card, arch="mlp-1m",
               params=MLP_CONFIG.param_count(), steps=n_steps, rows=64,
               momentum=0.9, lr=0.05, card_losses=card_losses,
               cpu_losses=cpu_losses, max_loss_err=err,
               max_param_err=perr, card_s=card_s, cpu_s=cpu_s)
    say("phase 17 (g): mlp-1m, SGD(momentum=0.9), card vs CPU:",
        json.dumps(rec))
    assert all(np.isfinite(card_losses)) and err < 1e-5, err
    assert card_losses[-1] < card_losses[0], "the MLP did not train"
    return rec


# phase 17 (f)'s depth: bert-large's first 8 of 24 layers, every width as
# published; all 24 took 27-30 s of the script's 1200 s on an NVIDIA H100
# 80GB HBM3 (700 W)
P17F_LAYERS = 8


def phase17(pa, fa, ops, dev, new_flush, card):
    """The remaining families: (a) :func:`phase17_kernels`; (b)
    :func:`paged_engine_exact` on yi-34b (K2 at group 7) and
    starcoder2-15b (GELU, group 12) at 2 layers; (c)
    :func:`frontend_serve_exact` on qwen2-vl-72b (320-token prompts, 256
    patches on the grid) and musicgen-medium (64 frames, 128-token
    prompts); (d) :func:`musicgen_full`; (e) the train step against
    sequential runs (phase 6's gates) for bert-large (K1 non-causal) and
    musicgen-medium (frontend batches) at 2 fp32 layers, seq 512; (f)
    bert-large at ``P17F_LAYERS`` of its 24 layers through
    ``run_model_selection``: 4 trials, 2 rows a microbatch, seq 512, K1
    fp32 non-causal; (g) :func:`mlp_sgd`.
    Returns (record, launch counts by path)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import ModelOptions, kernel_options

    out, marks, t_mark = {}, {}, [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    flush = new_flush()
    out["a"] = phase17_kernels(pa, fa, ops, dev, flush, card)
    del flush
    mark("a_kernels")

    k2_serving = 0
    out["b"] = {}
    for name in (YI, STARCODER):
        cfg = dataclasses.replace(get_config(name), n_layers=2)
        rec = paged_engine_exact(pa, cfg, ModelOptions(use_paged_kernel=True),
                                 dev, card, "phase 17 (b)",
                                 dict(params=cfg.param_count(), act=cfg.act))
        out["b"][name] = rec
        k2_serving += rec["kernel_launches"]
    mark("b_serve_exact")

    out["c"], k1_frontend = {}, 0
    for name, plen in ((QWEN, 320), (MUSICGEN, 128)):
        out["c"][name], n = frontend_serve_exact(fa, name, plen, dev, card)
        k1_frontend += n
    mark("c_frontend_exact")

    out["d"], k1_musicgen = musicgen_full(fa, dev, card)
    mark("d_musicgen_full")

    out["e"] = {}
    k1_opts = ModelOptions(remat=True, use_flash_kernel=True)
    for name in (BERT, MUSICGEN):
        cfg = dataclasses.replace(get_config(name), n_layers=2)
        reset_counts(fa)
        rec = train_vs_sequential(cfg, k1_opts, 512, 3, dev, card)
        rec["k1_launches"] = fa.launches
        assert fa.launches > 0, "the pipelined step launched no K1"
        out["e"][name] = rec
        kind = "non-causal" if cfg.family == "encoder" else "causal"
        say(f"phase 17 (e): pipelined train step (K1 {kind}) vs "
            f"sequential runs, {name}:", json.dumps(rec))
    mark("e_train_exact")

    cfg = dataclasses.replace(get_config(BERT), n_layers=P17F_LAYERS)
    n_steps, seq = 3, 512

    def expected(K, M, S):
        # phase 7's count: three forwards of every layer per (trial,
        # microbatch) slot a step, less the layer recompute torch's
        # checkpoint early stop skips in each stage before the last; one
        # evaluation pass per slot
        return n_steps * K * M * (3 * cfg.n_layers - (S - 1)) \
            + K * M * cfg.n_layers

    rec, k1_bert = selection_path(fa, "flash_attention_kernel", cfg,
                                  kernel_options(cfg, remat=True), seq,
                                  n_steps, expected, dev, card, n_trials=4,
                                  microbatch=2)
    assert rec["variant_launches"]["fp32"] == k1_bert
    say(f"phase 17 (f): gang plan K={rec['trials']} M={rec['microbatches']}"
        f" (S={rec['stages']}, bubble {rec['bubble_fraction']:.4f})")
    say(f"phase 17 (f): run_model_selection, bert-large {cfg.n_layers} "
        f"layers fp32 (K1 non-causal):", json.dumps(rec))
    out["f"] = rec
    mark("f_bert_train")

    out["g"] = mlp_sgd(dev, card)
    mark("g_mlp")
    out["seconds"] = marks
    return out, dict(k2_dense_serving=k2_serving,
                     k1_frontend_prefill=k1_frontend,
                     k1_musicgen_prefill=k1_musicgen,
                     k1_bert_training=k1_bert)


# ---------------------------------------------------------------------------
# Phase 18: the dry-run with the H100 roofline
# ---------------------------------------------------------------------------

P18_WORKERS = 7  # count processes beside the main one (8 host cores)


def phase18_grid(card):
    """(a) Every applicable cell on the card layout, counted on meta."""
    from repro_torch.configs import (ASSIGNED_ARCHS, PAPER_ARCHS, SHAPES,
                                     shape_applicable)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_card_mesh

    archs = dict(ASSIGNED_ARCHS, **{"bert-large": PAPER_ARCHS["bert-large"]})
    shapes = list(SHAPES.values())
    t = time.perf_counter()
    res = dryrun.run_grid(archs, shapes, [make_card_mesh()],
                          str(ROOT / "build" / "dryrun_smoke"), force=True,
                          workers=P18_WORKERS)
    wall = time.perf_counter() - t
    rows = [r for r in res if "skipped" not in r]
    applicable = sum(shape_applicable(c, sh)[0] for c in archs.values()
                     for sh in shapes)
    failed = [f"{r['arch']} {r['shape']}: {r['error']}" for r in rows
              if "error" in r]
    for r in rows:
        if "error" in r:
            continue
        rl = r["roofline"]
        say(f"phase 18 (a): {r['arch']} {r['shape']} K={r['engine']['n_trials']}"
            f" M={r['engine']['n_microbatches']} dominant={rl['dominant']} "
            f"roofline={rl['roofline_fraction']:.4f} compute_s="
            f"{rl['compute_s']:.4f} memory_s={rl['memory_s']:.4f} "
            f"modeled={r['modeled_bytes_per_device'] / 1e9:.2f} GB "
            f"fits_card={r['fits_card']}")
    assert not failed, "phase 18 (a): " + "; ".join(failed)
    assert len(rows) == applicable, (len(rows), applicable)
    fits = [f"{r['arch']} {r['shape']}" for r in rows if r["fits_card"]]
    say(f"phase 18 (a): {len(rows)} cells counted in {wall:.1f} s, "
        f"{len(fits)} fit the card ({rows[0]['card_bytes'] / 1e9:.2f} GB, "
        f"{rows[0]['card_bytes_source']}): {', '.join(fits)}")
    return dict(card=card, cells=len(rows), seconds=wall, fits=fits,
                rows=[{k: r[k] for k in ("arch", "shape", "engine",
                                         "modeled_bytes_per_device",
                                         "fits_card", "model_flops",
                                         "costs", "roofline")}
                      for r in rows])


def attention_terms(cfg, opts, mbg, seq):
    """FLOPs of one attention use at the training step's shape, counted on
    meta: the plain path's forward and its backward (its chunked q-block
    recompute included); K1's forward and its backward kernels (the five
    products a causal pair needs) are their wrappers' own counts."""
    from repro_torch.models import layers as L

    meta = lambda *shape: torch.zeros(shape, device="meta",
                                      requires_grad=True)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = meta(mbg, seq, hq, hd), meta(mbg, seq, hkv, hd), \
        meta(mbg, seq, hkv, hd)
    ct = torch.zeros(mbg, seq, hq, hd, device="meta")
    with costs.count() as fwd:
        out = L.attention(q, k, v, causal=True, opts=opts)
    with costs.count() as bwd:
        torch.autograd.grad(out, (q, k, v), ct)
    return dict(plain_fwd=fwd.flops, plain_bwd=bwd.flops,
                k1_bwd=costs.attention_bwd_work(q, k, v)[1],
                k1_fwd=costs.flash_work(q, k, v)[1])


def phase18_counter(fa, dev, card):
    """(b) Phase 7's training step counted on the card with K1 on and on
    meta with the plain path; returns (record, K1 launches)."""
    from repro_torch.analysis.roofline import model_flops_for_cell
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models.layers import kernel_options
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=4)
    seq = 2048
    # phase 7's gang: the planner's K = 2, M = 5 at S = 2
    eng = pl.EngineConfig(n_trials=2, n_microbatches=5, microbatch=1,
                          n_stages=2)
    K, M, S, L = eng.n_trials, eng.n_microbatches, eng.n_stages, cfg.n_layers
    k1_opts = kernel_options(cfg, remat=True)
    plain_opts = dataclasses.replace(k1_opts, use_flash_kernel=False)
    plan = plan_stages(cfg, S)
    hp = {"lr": [3e-3, 1e-3], "wd": [0.0, 0.01]}

    def counted(device, opts):
        if device == "meta":
            params = pl.trial_params_struct(cfg, eng, plan,
                                            dtype=torch.float32)
            toks = torch.zeros(K, M, eng.mb_global, seq, dtype=torch.int32,
                               device="meta")
        else:
            gen = torch.Generator(device=device).manual_seed(18)
            params = pl.init_trial_params(cfg, eng, plan, gen, device=device)
            toks = torch.randint(0, cfg.vocab_size,
                                 (K, M, eng.mb_global, seq), generator=gen,
                                 device=device, dtype=torch.int32)
        opt = AdamW(grad_clip=1.0)
        state = opt.init(params)
        step = pl.make_train_step(cfg, opts, eng, opt)
        batch = {"tokens": toks, "labels": toks}
        reset_counts(fa)
        t = time.perf_counter()
        with costs.count() as c:
            _, _, metrics = step(params, state, batch, hp, 0)
        if device != "meta":
            torch.cuda.synchronize()
            assert np.isfinite(metrics["loss"]).all(), metrics
        return c, time.perf_counter() - t, fa.launches

    card_c, card_s, launches = counted(dev, k1_opts)
    tidy()
    meta_c, meta_s, _ = counted("meta", plain_opts)
    terms = attention_terms(cfg, plain_opts, eng.mb_global, seq)
    # attention forwards (the K1 launches) and backwards (one per (slot,
    # layer) use in the graph)
    n_fwd, n_bwd = launches, K * M * L
    k1_flops = card_c.flops_by_kind.get("flash_attention", 0)
    k1_count = card_c.count_by_kind.get("flash_attention", 0)
    explained = (n_fwd * (terms["k1_fwd"] - terms["plain_fwd"])
                 + n_bwd * (terms["k1_bwd"] - terms["plain_bwd"]))
    residual = card_c.flops - meta_c.flops - explained
    shape = ShapeConfig("phase18_train", seq_len=seq,
                        global_batch=M * eng.mb_global, kind="train")
    model = model_flops_per_step(cfg, eng, seq)
    six_nd = model_flops_for_cell(cfg, shape, K)
    rec = dict(
        card=card, arch=cfg.name, n_layers=L, trials=K, microbatches=M,
        stages=S, seq=seq, dtype="float32", k1_launches=launches,
        card_count=card_c.to_json(), meta_count=meta_c.to_json(),
        card_count_s=card_s, meta_count_s=meta_s,
        attention_terms=terms, n_attention_fwd=n_fwd,
        n_attention_bwd=n_bwd, explained_flops=explained,
        residual_flops=residual,
        relative_difference=(card_c.flops - meta_c.flops) / meta_c.flops,
        model_flops_per_step=model, six_n_d=six_nd,
        counted_over_model=card_c.flops / model,
        counted_over_six_n_d=card_c.flops / six_nd)
    say("phase 18 (b): counted training step:", json.dumps(
        {k: v for k, v in rec.items()
         if k not in ("card_count", "meta_count")}))
    assert launches > 0 and k1_count == launches, (launches, k1_count)
    bwd_count = card_c.count_by_kind.get("attention_bwd", 0)
    assert bwd_count == n_bwd, (bwd_count, n_bwd)
    assert k1_flops == n_fwd * terms["k1_fwd"] > 0, \
        f"the card's count misses K1's forward ({k1_flops})"
    assert residual == 0, f"phase 18 (b): unexplained FLOPs {residual}"
    return rec, launches


def phase18_fit(dev, card):
    """(c) falcon-mamba-7b decode_32k at its published shape on the card
    layout: one decode step, peak memory beside the modeled bytes."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.scheduler import per_chip_bytes, state_bytes
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.models.layers import kernel_options

    cfg, shape = get_config("falcon-mamba-7b"), SHAPES["decode_32k"]
    eng = dryrun.engine_for_cell(cfg, shape, make_card_mesh(), {})
    modeled = per_chip_bytes(cfg, eng, shape.seq_len, train=False,
                             **state_bytes(dryrun.DTYPE)).total \
        * eng.n_trials
    opts = kernel_options(cfg, compute_dtype=dryrun.DTYPE)
    tidy()
    torch.cuda.reset_peak_memory_stats()
    s = dryrun.cell_structs(cfg, shape, eng, None, device=dev, seed=18)
    step = pl.make_serve_step(cfg, opts, eng, "decode")
    reset_counts(ms)
    t = time.perf_counter()
    _, tok, val = step(s["params"], s["cache"], s["batch"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    K, M, mbg = eng.n_trials, eng.n_microbatches, eng.mb_global
    assert tuple(tok.shape) == (K, M, mbg), tok.shape
    assert bool(torch.isfinite(val).all())
    assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    # every row decodes the same token from the same (zero) state and
    # weights, in its own slot: the same answer everywhere
    assert bool((tok == tok.flatten()[0]).all()), tok.unique()
    rec = dict(card=card, arch=cfg.name, shape=shape.name,
               n_layers=cfg.n_layers, trials=K, microbatches=M,
               rows=K * M * mbg, cache_len=shape.seq_len, dtype="bfloat16",
               peak_bytes=peak, modeled_bytes=modeled,
               peak_over_modeled=peak / modeled, step_s=step_s,
               k3_launches=ms.launches,
               param_count=cfg.param_count())
    say("phase 18 (c): falcon-mamba-7b decode_32k on the card:",
        json.dumps(rec))
    del s
    return rec


def phase18(fa, dev, card):
    marks, t = {}, time.perf_counter()
    grid = phase18_grid(card)
    marks["a"] = time.perf_counter() - t
    counter, launches = phase18_counter(fa, dev, card)
    marks["b"] = time.perf_counter() - t - marks["a"]
    tidy()
    fit = phase18_fit(dev, card)
    marks["c"] = time.perf_counter() - t - marks["a"] - marks["b"]
    say("phase 18 seconds:", json.dumps(marks))
    return dict(a=grid, b=counter, c=fit, seconds=marks), launches


# ---------------------------------------------------------------------------
# Phase 19: Hydra's training mesh on device layouts
# ---------------------------------------------------------------------------

# 2 layers (one a stage): at 4, phase 19 took 60-62 s of the script's
# 1200 s on an NVIDIA H100 80GB HBM3 (700 W)
P19_LAYERS, P19_STEPS, P19_SEED = 2, 2, 19


def cuda_indices(layout, dev):
    """The CUDA device indices a layout (or, without one, ``dev``) uses."""
    if layout is None:
        return [dev.index or 0]
    return sorted({d.index for d in layout.devices.flat})


def train_steps(fa, cfg, opts, eng, batches, dev, card, layout=None):
    """``P19_STEPS`` steps of ``make_train_step`` on ``cfg`` from the
    seeded weights (drawn on ``dev``, then placed on ``layout`` when one is
    given), AdamW with clipping and phase 6's per-trial hyperparameters;
    K1's launches counted over the steps alone (set to 0 just before the
    first, read just after the last). Returns (record, the final
    trial-stacked parameters on the host)."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=dev).manual_seed(P19_SEED)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, device=dev)
    if layout is not None:
        params = pl.place_trial_params(cfg, eng, params, layout)
    tidy()
    opt = AdamW(grad_clip=1.0)
    state = opt.init(params)
    step = pl.make_train_step(cfg, opts, eng, opt, layout=layout)
    cards = cuda_indices(layout, dev)
    sync = lambda: [torch.cuda.synchronize(i) for i in cards]
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    losses, norms, step_s = [], [], []
    reset_counts(fa)  # this path's launches only
    for i, batch in enumerate(batches):
        sync()
        t = time.perf_counter()
        params, state, met = step(params, state, batch, TRAIN_HP, i)
        sync()
        step_s.append(time.perf_counter() - t)
        losses.append(met["loss"].tolist())
        norms.append(met["grad_norm"].tolist())
    launches = fa.launches
    rec = dict(
        card=card, layout=None if layout is None else layout.describe(),
        device=str(dev) if layout is None else None, data=eng.data_size,
        stages=eng.n_stages, fsdp=eng.fsdp, microbatch=eng.microbatch,
        losses=losses, grad_norms=norms, step_ms_all=[1e3 * s for s in
                                                      step_s],
        step_ms=1e3 * step_s[-1], k1_launches=launches,
        max_memory_allocated_gb={f"cuda:{i}": torch.cuda
                                 .max_memory_allocated(i) / 1e9
                                 for i in cards})
    host = (tree_map(lambda t: t.to("cpu", copy=True), params)
            if layout is None else
            pl.gather_trial_params(cfg, eng, params, layout, "cpu"))
    del params, state, step
    tidy()
    return rec, host


def held_to(rec, ref, host, ref_host, name):
    """The gates of ``tests/test_torch_train_pipeline.py``: losses within
    2e-4, grad norms and parameters within 5e-3 of ``ref``'s."""
    from repro_torch.tree import tree_leaves

    loss_err = max(abs(a - b) for x, y in zip(rec["losses"], ref["losses"])
                   for a, b in zip(x, y))
    norm_err = max(abs(a - b) for x, y in zip(rec["grad_norms"],
                                              ref["grad_norms"])
                   for a, b in zip(x, y))
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(host),
                                    tree_leaves(ref_host)))
    rec.update(max_loss_err=loss_err, max_grad_norm_err=norm_err,
               max_param_err=param_err)
    say(f"phase 19 {name}:", json.dumps(rec))
    assert loss_err < 2e-4, f"phase 19 {name}: loss error {loss_err}"
    assert norm_err < 5e-3, f"phase 19 {name}: grad norm error {norm_err}"
    assert param_err < 5e-3, f"phase 19 {name}: param error {param_err}"


def phase19(fa, dev, card):
    """(a) chatglm3-6b at every published width, ``P19_LAYERS`` layers,
    fp32, K 2, M 5, seq 2048, remat, K1: the placed train step on a data 2
    × model 2 FSDP layout over ``["cuda:0"] * 4`` against the one-device
    step (2 logical data shards) from the same weights and batches; (b)
    where several cards exist, stage s on cuda:s (data 1 × model 2, the
    same rows as a microbatch of 2) and, with 4 cards, the data 2 × model
    2 FSDP layout on cuda:0-3, each against (a)'s one-device step, with
    each card's peak beside the planner's per-chip bytes."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.scheduler import per_chip_bytes, state_bytes
    from repro_torch.data.pipeline import TrainBatches
    from repro_torch.launch.mesh import make_device_layout
    from repro_torch.models.layers import kernel_options

    n_cards = torch.cuda.device_count()
    say(f"phase 19: torch.cuda.device_count() = {n_cards}")
    cfg = dataclasses.replace(get_config("chatglm3-6b"),
                              n_layers=P19_LAYERS)
    opts = kernel_options(cfg, remat=True)
    seq, L = 2048, cfg.n_layers
    one = pl.EngineConfig(n_trials=2, n_microbatches=5, microbatch=1,
                          n_stages=2, data_size=2)
    fsdp = dataclasses.replace(one, fsdp=True)
    data = TrainBatches(cfg, one, seq, seed=0)
    batches = [data.batch_for_step(i) for i in range(P19_STEPS)]
    data.close()
    # launches a step: three forwards of each layer per slot and row
    # block, less the layer recompute checkpoint's early stop skips in
    # each stage before the last (phase 7's rule), once per replica
    per_replica = P19_STEPS * one.n_slots * (3 * L - (one.n_stages - 1))

    def planner_gb(eng):  # one stage of one replica: K trials' state
        return per_chip_bytes(cfg, eng, seq, True,
                              **state_bytes(torch.float32)).total \
            * eng.n_trials / 1e9

    out = {}
    t = time.perf_counter()
    ref, ref_host = train_steps(fa, cfg, opts, one, batches, dev, card)
    assert ref["k1_launches"] == per_replica, ref["k1_launches"]
    say("phase 19 (a) one device:", json.dumps(ref))
    out["one_device"] = ref
    layout = make_device_layout(2, 2, devices=["cuda:0"] * 4)
    rec, host = train_steps(fa, cfg, opts, fsdp, batches, dev, card, layout)
    rec["expected_k1_launches"] = 2 * per_replica
    rec["planner_gb_per_layout_entry"] = planner_gb(fsdp)
    rec["planner_gb_card"] = 4 * planner_gb(fsdp)
    rec["step_ms_over_one_device"] = rec["step_ms"] / ref["step_ms"]
    held_to(rec, ref, host, ref_host, "(a) data 2 x model 2 FSDP on "
            "cuda:0 x 4")
    assert rec["k1_launches"] == 2 * per_replica, rec["k1_launches"]
    out["a"], main_launches = rec, rec["k1_launches"]
    del host
    out["seconds_a"] = time.perf_counter() - t

    out["b"] = []
    if n_cards < 2:
        say(f"phase 19 (b): not run: {n_cards} CUDA device(s) visible, the "
            f"placement across cards needs at least 2")
        out["b_not_run"] = f"{n_cards} CUDA device(s)"
        return out, main_launches
    cases = [("(b) data 1 x model 2 on cuda:0-1",
              dataclasses.replace(one, microbatch=2, data_size=1),
              make_device_layout(1, 2), per_replica)]
    if n_cards >= 4:
        cases.append(("(b) data 2 x model 2 FSDP on cuda:0-3", fsdp,
                      make_device_layout(2, 2), 2 * per_replica))
    for name, eng, lay, want in cases:
        rec, host = train_steps(fa, cfg, opts, eng, batches, dev, card, lay)
        rec["expected_k1_launches"] = want
        rec["planner_gb_per_card"] = planner_gb(eng)
        rec["step_ms_over_one_device"] = rec["step_ms"] / ref["step_ms"]
        rec["step_ms_over_a"] = rec["step_ms"] / out["a"]["step_ms"]
        held_to(rec, ref, host, ref_host, name)
        assert rec["k1_launches"] == want, rec["k1_launches"]
        out["b"].append(rec)
        del host
    return out, main_launches


# ---------------------------------------------------------------------------
# Phase 20: serving on device layouts
# ---------------------------------------------------------------------------

P20_LAYERS = 4  # (b) and (c): full width, fp32


def p5_trace(vocab):
    """Phase 5's traffic: 8 requests of 128-1024 prompt tokens, 32 new
    tokens each, one a tick."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(4)
    return [Request(i, rng.integers(0, vocab, (int(p),)).astype(np.int32),
                    32, arrival=float(i))
            for i, p in enumerate(rng.integers(128, 1025, 8))]


def serve_run(pa, cfg, opts, eng, params, reqs, dev, layout=None, **kw):
    """One run of ``reqs`` through a fresh ServeEngine, placed on
    ``layout`` when one is given (``params`` then placed too). K2's
    launches are counted over the run alone (set to 0 just before it,
    read just after); every decode call is timed on the host clock
    between synchronisations of the cards the run uses; their peaks are
    read after it. Returns (engine, completions, record)."""
    from repro_torch.serve import ServeEngine

    where = dict(device=dev) if layout is None else dict(layout=layout)
    engine = ServeEngine(cfg, eng, params, opts, **where, **kw)
    cards = cuda_indices(layout, dev)
    sync = lambda: [torch.cuda.synchronize(i) for i in cards]
    step, times = engine.decode_step, []

    def timed(*args):
        sync()
        t = time.perf_counter()
        out = step(*args)
        sync()
        times.append(time.perf_counter() - t)
        return out

    engine.decode_step = timed
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    reset_counts(pa)
    sync()
    t0 = time.perf_counter()
    comps = engine.run([r.clone() for r in reqs])
    sync()
    wall = time.perf_counter() - t0
    engine.decode_step = step
    st = engine.stats
    for r, c in zip(reqs, comps):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    rec = dict(layout=None if layout is None else layout.describe(),
               device=str(dev) if layout is None else None,
               requests=len(comps), tokens=st.tokens_generated,
               ticks=st.ticks, calls=st.calls, wall_s=wall,
               tokens_per_s=st.tokens_generated / wall,
               decode_calls=len(times),
               decode_ms_per_call=(1e3 * float(np.median(times)) if times
                                   else None),
               k2_launches=pa.launches,
               max_memory_allocated_gb={
                   f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 1e9
                   for i in cards})
    return engine, comps, rec


def schedule(engine, comps) -> dict:
    """What phase 20 holds equal between two runs of a trace: each
    request's ttft and finished ticks, the calls, and the allocator's free
    lists."""
    return dict(ticks=[(c.rid, c.ttft_ticks, c.finished_tick)
                       for c in comps],
                calls=engine.stats.calls,
                free=(None if engine.allocator is None else
                      [list(f) for f in engine.allocator._free]))


def held_to_one_device(name, sched, comps, ref_sched, ref_comps, rec,
                       exact):
    """Phase 20's gates against the one-device run: the schedule equal;
    the tokens equal (``exact``), or else counted here and judged by the
    caller as bf16 near-ties."""
    rec["tokens_equal_share"] = float(np.mean(
        [a.tokens == b.tokens for a, b in zip(comps, ref_comps)]))
    rec["first_divergence"] = first_divergence(comps, ref_comps)
    say(f"phase 20 {name}:", json.dumps(rec))
    assert sched == ref_sched, f"phase 20 {name}: the schedule differs"
    if exact:
        assert rec["tokens_equal_share"] == 1.0, \
            f"phase 20 {name}: tokens differ"


def phase20_full(pa, dev, card, n_cards):
    """(a), and (d) where several cards are visible."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.core.scheduler import per_chip_bytes
    from repro_torch.launch.mesh import make_device_layout
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import blocks_for

    bf16 = torch.bfloat16
    cfg = get_config("chatglm3-6b")
    max_seq = 1024 + 32
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=2, max_seq=max_seq,
                          cache_dtype=bf16, prefill_chunks=2, paged=True,
                          block_size=BS,
                          n_blocks=4 * blocks_for(max_seq, BS))
    opts = ModelOptions(compute_dtype=bf16, use_paged_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  dtype=bf16, device=dev)
    reqs = p5_trace(cfg.vocab_size)
    per_slot_layer = eng.n_slots * cfg.n_layers
    out = {}

    def profiled(engine, rec):
        rec["host_ops_per_decode_call"], rec["decode_busy_ms"] = \
            profile_decode_call(engine, reqs[0])

    one_e, one_c, one = serve_run(pa, cfg, opts, eng, params, reqs, dev)
    one_s = schedule(one_e, one_c)
    one["expected_k2_launches"] = one["calls"] * per_slot_layer
    assert one["k2_launches"] == one["expected_k2_launches"], one
    profiled(one_e, one)
    del one_e
    out["a_one_device"] = one
    say("phase 20 (a) one device:", json.dumps(one))

    def placed_case(name, eng_p, layout, ref, ref_s, ref_c):
        placed = pl.place_trial_params(cfg, eng_p, params, layout)
        tidy()
        e, c, rec = serve_run(pa, cfg, opts, eng_p, placed, reqs, dev,
                              layout)
        sched = schedule(e, c)
        rec["expected_k2_launches"] = (pl.pool_partitions(eng_p)
                                       * ref["calls"] * per_slot_layer)
        profiled(e, rec)
        del e, placed
        tidy()
        for n in ("wall_s", "decode_ms_per_call", "host_ops_per_decode_call",
                  "tokens_per_s"):
            rec[f"{n}_over_one_device"] = rec[n] / ref[n] if ref[n] else None
        held_to_one_device(name, sched, c, ref_s, ref_c, rec, exact=False)
        assert rec["k2_launches"] == rec["expected_k2_launches"], rec
        if rec["tokens_equal_share"] < 1.0:  # bf16: only at near-ties
            nt = near_ties(cfg, params, dev, reqs, c, ref_c)
            rec["near_ties"] = nt
            say(f"phase 20 {name} near ties:", json.dumps(nt))
            assert nt["divergence"]["within_noise"] == \
                nt["divergence"]["n"], f"phase 20 {name}: not a near-tie"
        return rec

    layout = make_device_layout(2, 2, devices=["cuda:0"] * 4)
    out["a"] = placed_case("(a) data 2 x model 2 on cuda:0 x 4", eng,
                           layout, one, one_s, one_c)
    launches = out["a"]["k2_launches"]

    out["d"] = []
    if n_cards < 2:
        say(f"phase 20 (d): not run: {n_cards} CUDA device(s) visible, the "
            f"placement across cards needs at least 2")
        out["d_not_run"] = f"{n_cards} CUDA device(s)"
        return out, launches
    eng_s = dataclasses.replace(eng, microbatch=2, data_size=1)
    ref_e, ref_c, ref = serve_run(pa, cfg, opts, eng_s, params, reqs, dev)
    ref_s = schedule(ref_e, ref_c)
    profiled(ref_e, ref)
    del ref_e
    out["d_one_device_data1"] = ref
    cases = [("(d) data 1 x model 2 on cuda:0-1", eng_s,
              make_device_layout(1, 2), ref, ref_s, ref_c)]
    if n_cards >= 4:
        cases.append(("(d) data 2 x model 2 on cuda:0-3", eng,
                      make_device_layout(2, 2), one, one_s, one_c))
    for name, eng_p, lay, r, r_s, r_c in cases:
        rec = placed_case(name, eng_p, lay, r, r_s, r_c)
        rec["planner_gb_per_card"] = per_chip_bytes(
            cfg, eng_p, max_seq, False, param_bytes=2).total / 1e9
        rec["decode_ms_per_call_over_a"] = \
            rec["decode_ms_per_call"] / out["a"]["decode_ms_per_call"]
        say(f"phase 20 {name} beside the planner:", json.dumps(
            {n: rec[n] for n in ("planner_gb_per_card",
                                 "max_memory_allocated_gb",
                                 "decode_ms_per_call_over_a")}))
        out["d"].append(rec)
    return out, launches


def pool_parity(cfg, eng, placed_cache, layout, ref_cache) -> float:
    """The placed pool gathered back against the one-device run's: every
    written entry within 2e-5, every unwritten one bit-equal; returns the
    largest error."""
    from repro_torch.core import pipeline as pl

    got = pl.gather_serve_cache(cfg, eng, placed_cache, layout)
    err = 0.0
    for n in ("k", "v"):
        a, b = got["layers"][n], ref_cache["layers"][n]
        written = (a != 0) | (b != 0)
        assert torch.equal(a[~written], b[~written]), n
        err = max(err, float((a - b)[written].abs().max()))
    assert err <= 2e-5, f"pool entries differ by {err}"
    return err


def placed_round_trip(cfg, eng, cache, layout) -> int:
    """The host tier's round trip on a placed pool, bit for bit: extract
    two written blocks of shard 1 (read from both stages' devices) and
    inject them over two others; returns the payload bytes."""
    from repro_torch.core import pipeline as pl

    tk = pl.make_transfer_kernels(cfg, eng, layout=layout)
    src, dst = [0, 1], [2, 3]
    payloads = tk.extract(cache, 0, 1, src)
    assert all(p.device.type == "cpu" and bool(p.ne(0).any())
               for p in payloads)
    tk.inject(cache, 0, 1, dst, payloads)
    for s in range(eng.n_stages):
        for buf in cache[0][1][s]["layers"].values():
            assert torch.equal(buf[0][:, dst].view(torch.int32),
                               buf[0][:, src].view(torch.int32))
    return sum(p.numel() * p.element_size() for p in payloads)


def phase20_exact(pa, dev, card):
    """(b): fp32, ``P20_LAYERS`` full-width layers, prefix cache and a
    host tier, held exactly against the one-device engine on two
    layouts."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.launch.mesh import make_device_layout
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import blocks_for

    cfg = dataclasses.replace(get_config("chatglm3-6b"),
                              n_layers=P20_LAYERS)
    max_seq = 80
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=2, max_seq=max_seq,
                          cache_dtype=torch.float32, prefill_chunks=2,
                          paged=True, block_size=BS,
                          n_blocks=4 * blocks_for(max_seq, BS),
                          host_blocks=8)
    opts = ModelOptions(use_paged_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(20)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  device=dev)
    # a shared 40-token head, so later requests hit the prefix cache
    reqs = shared_prefix_reqs(np.random.default_rng(20), cfg.vocab_size, 8,
                              40, (4, 30), 4, 2)
    feats = dict(prefix_cache=True)
    one_e, one_c, one = serve_run(pa, cfg, opts, eng, params, reqs, dev,
                                  **feats)
    assert one_e.stats.prefix_hits > 0, "no prefix hit: vacuous"
    one_s = schedule(one_e, one_c)
    out = {"b_one_device": one}
    say("phase 20 (b) one device:", json.dumps(one))
    launches = 0
    for name, eng_p in (
            ("(b) data 2 x model 2 FSDP", dataclasses.replace(eng,
                                                              fsdp=True)),
            ("(b) pod 2 x data 1 x model 2", dataclasses.replace(
                eng, data_size=1, pod_size=2, pod_axis="pod"))):
        layout = make_device_layout(eng_p.data_size, 2,
                                    multi_pod=eng_p.pod_size > 1,
                                    devices=["cuda:0"] * 4)
        placed = pl.place_trial_params(cfg, eng_p, params, layout)
        e, c, rec = serve_run(pa, cfg, opts, eng_p, placed, reqs, dev,
                              layout, **feats)
        rec["expected_k2_launches"] = 2 * one["k2_launches"]
        rec["prefix_hits"] = e.stats.prefix_hits
        rec["pool_max_err"] = pool_parity(cfg, eng_p, e.cache, layout,
                                          one_e.cache)
        if eng_p.fsdp:
            rec["round_trip_bytes"] = placed_round_trip(cfg, eng_p, e.cache,
                                                        layout)
        held_to_one_device(name, schedule(e, c), c, one_s, one_c, rec,
                           exact=True)
        assert rec["k2_launches"] == rec["expected_k2_launches"], rec
        launches += rec["k2_launches"]
        out["b" if eng_p.fsdp else "b_pod"] = rec
        del e, placed
        tidy()
    return out, launches


def phase20_other(fa, ms, dev, card):
    """(c): fp32, ``P20_LAYERS`` full-width layers: falcon-mamba-7b
    through the placed dense engine with K3 (model 2 on cuda:0 x 2, slot
    reset included) and chatglm3-6b through placed ``static_serve`` with
    K1 (data 2 x model 2 on cuda:0 x 4), each against the one-device run:
    tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.launch.mesh import make_device_layout
    from repro_torch.models.layers import kernel_options
    from repro_torch.serve import Request, ServeEngine, static_serve

    out = {}
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=P20_LAYERS)
    eng, opts, params, make = dense_engine(cfg, torch.float32, dev, 9, 80)
    reqs = trace4(cfg.vocab_size)
    runs = {}
    layout = make_device_layout(1, 2, devices=["cuda:0"] * 2)
    for name in ("one_device", "placed"):
        engine = make() if name == "one_device" else ServeEngine(
            cfg, eng, pl.place_trial_params(cfg, eng, params, layout), opts,
            layout=layout)
        reset, resets = engine.reset_fn, []
        engine.reset_fn = lambda c, m: resets.append(
            int(np.asarray(m).sum())) or reset(c, m)
        reset_counts(ms)
        t = time.perf_counter()
        comps = engine.run([r.clone() for r in reqs])
        torch.cuda.synchronize()
        runs[name] = (schedule(engine, comps), comps, dict(
            wall_s=time.perf_counter() - t, k3_launches=ms.launches,
            calls=engine.stats.calls, reset_rows=sum(resets)))
        assert sum(resets) == len(reqs) > engine.batcher.n_cells
        del engine
    ref_s, ref_c, ref = runs["one_device"]
    sched, comps, rec = runs["placed"]
    rec["one_device"] = ref
    assert rec["k3_launches"] == ref["k3_launches"] > 0, rec
    held_to_one_device("(c) falcon-mamba-7b dense, model 2 on cuda:0 x 2",
                       sched, comps, ref_s, ref_c, rec, exact=True)
    out["c_ssm"], k3 = rec, rec["k3_launches"]
    del params
    tidy()

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=P20_LAYERS)
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                          n_stages=2, data_size=2, max_seq=64 + 6,
                          cache_dtype=torch.float32)
    opts = kernel_options(cfg)
    gen = torch.Generator(device=dev).manual_seed(21)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  device=dev)
    rng = np.random.default_rng(21)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (64,))
                    .astype(np.int32), 2 + i % 5) for i in range(8)]
    layout = make_device_layout(2, 2, devices=["cuda:0"] * 4)
    res = {}
    for name in ("one_device", "placed"):
        reset_counts(fa)
        t = time.perf_counter()
        comps, st = (static_serve(cfg, eng, params, reqs, opts, device=dev)
                     if name == "one_device" else static_serve(
                         cfg, eng, pl.place_trial_params(cfg, eng, params,
                                                         layout),
                         reqs, opts, layout=layout))
        torch.cuda.synchronize()
        res[name] = (comps, dict(wall_s=time.perf_counter() - t,
                                 k1_launches=fa.launches, calls=st.calls,
                                 ticks=st.ticks))
    ref_c, ref = res["one_device"]
    comps, rec = res["placed"]
    rec["one_device"] = ref
    prefills = -(-len(reqs) // (eng.n_slots * eng.mb_global))
    rec["expected_k1_launches"] = 2 * prefills * eng.n_slots * cfg.n_layers
    assert ref["k1_launches"] * 2 == rec["k1_launches"] \
        == rec["expected_k1_launches"], rec
    held_to_one_device("(c) chatglm3-6b static_serve, data 2 x model 2",
                       dict(ticks=[(c.rid, c.finished_tick) for c in comps],
                            calls=rec["calls"]),
                       comps, dict(ticks=[(c.rid, c.finished_tick)
                                          for c in ref_c],
                                   calls=ref["calls"]),
                       ref_c, rec, exact=True)
    out["c_static"] = rec
    return out, k3, rec["k1_launches"]


def phase20(pa, fa, ms, dev, card):
    """Serving on device layouts (``layout=`` through the engine): (a)
    full chatglm3-6b in bf16 on data 2 x model 2 over cuda:0 x 4, (b) and
    (c) fp32 exactness at ``P20_LAYERS`` layers, (d) across cards where
    several are visible. Returns (record, K2, K1 and K3 launches of the
    placed paths)."""
    n_cards = torch.cuda.device_count()
    say(f"phase 20: torch.cuda.device_count() = {n_cards}")
    t = time.perf_counter()
    out, k2 = phase20_full(pa, dev, card, n_cards)
    out["seconds_a_d"] = time.perf_counter() - t
    tidy()
    t = time.perf_counter()
    exact, k2_exact = phase20_exact(pa, dev, card)
    out.update(exact)
    out["seconds_b"] = time.perf_counter() - t
    tidy()
    t = time.perf_counter()
    other, k3, k1 = phase20_other(fa, ms, dev, card)
    out.update(other)
    out["seconds_c"] = time.perf_counter() - t
    return out, dict(k2=k2 + k2_exact, k1=k1, k3=k3)


PHASES = tuple(range(1, 21))
BWD_FIELDS = ("rel_err_dq_dk_dv", "ms", "kernel_ms", "plain_ms",
              "plain_device_ms", "bound_ms", "bound_by", "library_ms")


def write_json(path: str, res: dict) -> None:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every measured "
                    "number to this JSON file")
    ap.add_argument("--phases", default="", help="comma-separated phases "
                    "to run (default all; phase 1, the build, always runs). "
                    "A partial run prints neither the kernels line nor the "
                    "last line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke test needs a GPU",  # noqa: T201
              file=sys.stderr)
        return 2
    run = ({int(x) for x in args.phases.split(",")} | {1} if args.phases
           else set(PHASES))
    from repro_torch.kernels import attention_bwd as bwd
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("card:", card)
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    t0 = time.perf_counter()
    builds = [(m.SOURCE, kbuild.start(m.SOURCE))
              for m in (pa, fa, ms, bwd)]
    for source, proc in builds:  # one nvcc per source, all started at once
        report = kbuild.finish(source, proc)
        say(f"phase 1: built {kbuild.library_path(source).name} from "
            f"{source.relative_to(ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say("  nvcc:", line.strip())
    build_s = time.perf_counter() - t0
    say(f"phase 1: {len(builds)} kernels built in {build_s:.2f} s")

    res = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
               build_s=build_s)

    seconds, t_lap = {}, [time.perf_counter()]

    def lap(phase):  # each phase's wall seconds, tidied up after it
        tidy()
        now = time.perf_counter()
        seconds[f"phase{phase}"] = now - t_lap[0]
        t_lap[0] = now

    # the flush (a 512 MiB memset, about 0.2 ms) also keeps the card busy
    # while the host enqueues the timed call, so a short kernel's time
    # holds no host gap
    new_flush = lambda: torch.empty(512 * 2**20 // 4, dtype=torch.float32,
                                    device=dev)
    flush = new_flush()
    if 2 in run:
        res["phase2"] = phase2(pa, dev, flush, card)
        lap(2)
    if 3 in run:
        res["phase3"] = phase3(fa, ops, dev, flush, card)
        lap(3)
    del flush  # kept out of the serving and training phases' peak memory
    # phase 4's engine holds its weights in a reference cycle (the transfer
    # engine's cache callbacks): collect it, or its ~3.8 GB lingers into
    # phase 5's peak memory
    if 4 in run:
        res["phase4"] = phase4(dev)
        lap(4)
    tidy()
    if 5 in run:
        res["phase5"], pa_launches = phase5(pa, dev, card)
        lap(5)
    if 6 in run:
        res["phase6"] = phase6(dev, card)
        lap(6)
    if 7 in run:
        res["phase7"], fa_launches = phase7(fa, dev, card)
        lap(7)
    if 8 in run:
        flush = new_flush()
        res["phase8"], res["phase8_grad_rel_err"] = phase8(ms, ops, dev,
                                                           flush, card)
        del flush
        lap(8)
    if 9 in run:
        res["phase9"] = phase9(ms, dev, card)
        lap(9)
    if 10 in run:
        res["phase10"], ms_launches = phase10(ms, dev, card)
        lap(10)
    if 11 in run:
        res["phase11"] = phase11(pa, dev, card)
        lap(11)
    if 12 in run:
        res["phase12"], pa_feature_launches = phase12(pa, dev, card)
        lap(12)
    if 13 in run:
        res["phase13"], p13 = phase13(fa, pa, ms, dev, card)
        lap(13)
    if 14 in run:
        res["phase14"], ms_train_launches = phase14(ms, dev, card)
        lap(14)
    if 15 in run:
        res["phase15"], p15 = phase15(fa, dev, card)
        lap(15)
    if 16 in run:
        res["phase16"], p16 = phase16(pa, fa, ops, dev, new_flush, card)
        lap(16)
    if 17 in run:
        res["phase17"], p17 = phase17(pa, fa, ops, dev, new_flush, card)
        lap(17)
    if 18 in run:
        res["phase18"], p18_launches = phase18(fa, dev, card)
        lap(18)
    if 19 in run:
        res["phase19"], p19_launches = phase19(fa, dev, card)
        lap(19)
    if 20 in run:
        res["phase20"], p20 = phase20(pa, fa, ms, dev, card)
        lap(20)
    res["seconds"] = dict(build=build_s, **seconds)
    say("phase seconds:", json.dumps(res["seconds"]))
    if run != set(PHASES):
        if args.out:
            write_json(args.out, res)
        say(f"partial run (phases {sorted(run)}): every phase run passed")
        return 0
    p2, p3, p8 = res["phase2"], res["phase3"]["cases"], res["phase8"]
    def timed_rows(rows):
        return {r["case"] + "/" + r["dtype"]: {
            n: r.get(n) for n in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}
            for r in rows if "ms" in r}

    at_granite = timed_rows((*res["phase16"]["a"]["k2"],
                             *res["phase16"]["a"]["k1"]))
    p17a = res["phase17"]["a"]

    row = next(c for c in p2
               if c["case"] == "decode" and c["dtype"] == "bfloat16")
    frow = next(c for c in p3
                if c["case"] == "train2048" and c["dtype"] == "float32")
    srow = next(c for c in p8
                if c["case"] == "path512" and c["dtype"] == "float32")
    brow, bert = (next(c for c in p3 if c["case"] == case
                       and c["dtype"] == "float32")
                  for case in ("train2048", "bert_train512"))
    k2_paths = {"phase5_split_serving": pa_launches,
                "phase12_serve_features": pa_feature_launches,
                "phase13_windowed": p13["k2_windowed"],
                "phase13_split_beside_static": p13["k2_split"],
                "phase13_planned_grid": p13["k2_planned"],
                "phase16_moe_serving": p16["serving"],
                "phase17_dense_serving": p17["k2_dense_serving"],
                "phase20_placed_serving": p20["k2"]}
    k1_paths = {"phase7_training": fa_launches,
                "phase13_static_prefill": p13["k1_static_prefill"],
                "phase15_hybrid_static_prefill": p15["k1_static_prefill"],
                "phase15_hybrid_training": p15["k1_training"],
                "phase16_moe_training": p16["training"],
                "phase17_frontend_prefill": p17["k1_frontend_prefill"],
                "phase17_musicgen_prefill": p17["k1_musicgen_prefill"],
                "phase17_bert_training": p17["k1_bert_training"],
                "phase18_counted_training": p18_launches,
                "phase19_placed_training": p19_launches,
                "phase20_placed_static_prefill": p20["k1"]}
    k3_paths = {"phase10_ssm_serving": ms_launches,
                "phase14_ssm_training": ms_train_launches,
                "phase20_placed_dense_serving": p20["k3"]}
    kernels = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:189",
        "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "at_granite_shapes": {n: v for n, v in at_granite.items()
                              if n.startswith("granite_")
                              and "train" not in n},
        "at_phase17_shapes": timed_rows(p17a["k2"])}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:83",
        "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
        "max_abs_err": frow["max_abs_err"],
        "ms": frow["ms"], "plain_ms": frow["plain_ms"],
        "bound_ms": frow["bound_ms"], "bound_by": frow["bound_by"],
        "library_ms": frow["library_ms"],
        "at_granite_shapes": {n: v for n, v in at_granite.items()
                              if "train" in n},
        "at_phase17_shapes": timed_rows(p17a["k1"])}, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:62",
        "launches": sum(k3_paths.values()), "launches_by_path": k3_paths,
        "max_abs_err": srow["max_abs_err"],
        "ms": srow["ms"], "plain_ms": srow["plain_ms"],
        "bound_ms": srow["bound_ms"], "bound_by": srow["bound_by"],
        "library_ms": None}, {
        "name": "attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/attention_bwd.cu",
        "replaces": None,  # K1's backward: the TPU path has no kernel
        # phase 3's profiled step, then every backward call after it
        "launches": res["phase3"]["train_step"]["attention_bwd_launches"]
        + bwd.launches,
        **{n: brow["backward"].get(n) for n in BWD_FIELDS},
        "at_bert_shape": {n: bert["backward"].get(n) for n in BWD_FIELDS}}]}
    res["kernels"] = kernels["kernels"]
    if args.out:
        write_json(args.out, res)
    say(json.dumps(kernels))
    say("card:", card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
