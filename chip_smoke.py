"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card (H100):

    python3 chip_smoke.py [--out results.json] [--phases 2,3,5]

It builds the hand-written CUDA kernels from the checkout's sources (one
nvcc per source, all started together) and runs ten phases, each a hard
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
   q_lens 0, block sizes 4, 8 and 32). Each in fp32 (tol 2e-5) and bf16
   (tol 3e-2), with the variant that ran (split-KV or the tensor-core
   append tile) and its split count. Times are CUDA-event medians of 30
   launches after warm-up with L2 flushed (a 512 MiB memset, which also
   keeps the card busy while the host enqueues the call); the bound is
   max(bytes / 3.35 TB/s, operations / peak rate of the input type).
3. The flash-attention kernel (K1) against its plain version at the
   training path's shape (b 1, seq 2048, 32 query heads on 2 KV heads,
   head_dim 128, causal) and the reference sweep's edge cases (ragged sq
   33 with hq = hkv, window 24, kv_offset 32 with sq 16 / sk 48) plus sq
   100 (not a multiple of the bf16 tile's 64 rows) and a head_dim 64 case
   with kv_offset 64, fp32 (tol 2e-5) and bf16 (tol 2e-2); the autograd
   op's q/k/v gradients against autograd of the plain version; times as
   phase 2, beside ``F.scaled_dot_product_attention`` (timed as a
   yardstick only).
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
11. A {"kernels": [...]} line for every ported kernel, the card line, and
   the last line: {"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import argparse
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, same
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
HQ, HKV, HD, BS = 32, 2, 128, 16  # chatglm3-6b attention, serving block
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # test_kernels_flash
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # test_kernels_mamba


def say(*parts) -> None:
    print(*parts, flush=True)  # noqa: T201


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
# (correctness only).
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
]
N_BLOCKS = 1024


def make_case(dev, dt, sq, offsets, q_lens, seed, bs=BS, n_tbl=128):
    """Random pool and ragged tables: row r's live blocks are a random
    disjoint subset of the pool covering offsets[r] + sq positions; the rest
    of its table is -1."""
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
    return dict(q=mk(b, sq, HQ, HD), k_pool=mk(N_BLOCKS, bs, HKV, HD),
                v_pool=mk(N_BLOCKS, bs, HKV, HD),
                block_tables=torch.from_numpy(tables).to(dev),
                kv_offset=off, kv_len=off + ql, q_lens=ql)


def case_work(offsets, q_lens, sq, window):
    """(attended (query, key) pairs, live K/V tokens) that this case's
    masks need: each real query attends keys [max(0, qpos-window+1) if
    windowed, qpos]; a row's live tokens are the union of its queries'."""
    pairs = live = 0
    for off, ql in zip(offsets, q_lens or [sq] * len(offsets)):
        spans = [(max(0, off + i - window + 1) if window else 0, off + i + 1)
                 for i in range(ql)]
        pairs += sum(hi - lo for lo, hi in spans)
        if spans:
            live += max(h for _, h in spans) - min(lo for lo, _ in spans)
    return pairs, live


def phase2(pa, dev, flush, card):
    results, failed = [], []
    for dt in (torch.float32, torch.bfloat16):
        for i, (name, sq, offsets, q_lens, window, bs, n_tbl,
                timed) in enumerate(CASES):
            a = make_case(dev, dt, sq, offsets, q_lens, seed=i, bs=bs,
                          n_tbl=n_tbl)
            kw = dict(causal=True, window=window, q_lens=a["q_lens"])
            args = [a[n] for n in ("q", "k_pool", "v_pool", "block_tables",
                                   "kv_offset", "kv_len")]
            # (the first version of K2, timed for comparison, keeps
            # neither variant counts nor a split plan)
            counts = getattr(pa, "variant_launches", {})
            before = dict(counts)
            got = pa.paged_attention_kernel(*args, **kw)
            torch.cuda.synchronize()
            variant = next((v for v, n in counts.items() if n > before[v]),
                           None)
            want = pa.paged_attention_plain(*args, **kw)
            err = float((got.float() - want.float()).abs().max())
            rec = dict(card=card, case=name, dtype=str(dt).split(".")[-1],
                       variant=variant, b=len(offsets), sq=sq, window=window,
                       block_size=bs, n_tbl=n_tbl,
                       splits=pa.plan_splits(n_tbl, bs, sq, HQ // HKV,
                                             variant)[1]
                       if variant else None,
                       max_abs_err=err, tol=TOL[dt])
            if not (bool(torch.isfinite(got).all()) and err < TOL[dt]):
                failed.append(f"{name}/{rec['dtype']} ({variant}): max "
                              f"|kernel - plain| {err}")
            if timed:
                ms = cuda_ms(lambda: pa.paged_attention_kernel(*args, **kw),
                             flush)
                plain_ms = cuda_ms(
                    lambda: pa.paged_attention_plain(*args, **kw), flush)
                es = a["q"].element_size()
                pairs, live = case_work(offsets, q_lens, sq, window)
                nbytes = (live * HKV * HD * 2 * es + 2 * a["q"].numel() * es
                          + 4 * (a["block_tables"].numel()
                                 + 3 * len(offsets)))
                ops = pairs * HQ * HD * 4  # QK^T and PV, 2 ops per MAC
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dt]
                rec.update(ms=ms, plain_ms=plain_ms,
                           bound_ms=1e3 * max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations",
                           live_kv_tokens=live, bytes=nbytes, ops=ops)
            results.append(rec)
            say("phase 2:", json.dumps(rec))
    assert not failed, "phase 2: " + "; ".join(failed)
    return results


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel vs its plain version
# ---------------------------------------------------------------------------

# name, b, sq, sk, hq, hkv, hd, causal, window, kv_offset
FLASH_CASES = [
    ("train2048", 1, 2048, 2048, HQ, HKV, HD, True, 0, 0),
    ("ragged_sq33_mha", 2, 33, 33, 4, 4, 32, True, 0, 0),
    ("window24", 1, 128, 128, 8, 2, 16, True, 24, 0),
    ("offset32", 1, 16, 48, 4, 1, 16, True, 0, 32),
    ("ragged_sq100", 1, 100, 100, HQ, HKV, HD, True, 0, 0),
    ("offset64_hd64", 2, 72, 136, 8, 2, 64, True, 0, 64),
]


def flash_pairs(sq, sk, causal, window, off):
    """Attended (query, key) pairs under the masks."""
    pairs = 0
    for i in range(sq):
        qpos = i + off
        hi = min(sk, qpos + 1) if causal else sk
        lo = max(0, qpos - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return pairs


def phase3(fa, ops, dev, flush, card):
    import torch.nn.functional as F
    results, failed = [], []
    gen = torch.Generator(device=dev).manual_seed(7)
    for dt in (torch.float32, torch.bfloat16):
        for name, b, sq, sk, hq, hkv, hd, causal, window, off in FLASH_CASES:
            mk = lambda *shape: torch.randn(*shape, generator=gen,
                                            device=dev).to(dt)
            q, k, v = mk(b, sq, hq, hd), mk(b, sk, hkv, hd), mk(b, sk, hkv, hd)
            kw = dict(causal=causal, window=window, kv_offset=off)
            got = fa.flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, **kw)
            err = float((got.float() - want.float()).abs().max())
            if not (bool(torch.isfinite(got).all()) and got.dtype == dt
                    and err < FLASH_TOL[dt]):
                failed.append(f"{name}/{dt}: max |kernel - plain| {err}")
            rec = dict(card=card, case=name, dtype=str(dt).split(".")[-1],
                       b=b, sq=sq, sk=sk, hq=hq, hkv=hkv, hd=hd,
                       window=window, kv_offset=off, max_abs_err=err,
                       tol=FLASH_TOL[dt])
            if name == "train2048":
                es = q.element_size()
                pairs = flash_pairs(sq, sk, causal, window, off)
                nbytes = es * (2 * q.numel() + k.numel() + v.numel())
                ops_n = 4 * hd * hq * b * pairs  # QK^T and PV, 2 per MAC
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_n / PEAK_OPS[dt]
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                rec.update(
                    ms=cuda_ms(lambda: fa.flash_attention_kernel(q, k, v,
                                                                 **kw),
                               flush),
                    plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                        q, k, v, **kw), flush),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), flush),
                    bound_ms=1e3 * max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    pairs=pairs, bytes=nbytes, ops=ops_n)
                lib = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
                rec["library_max_abs_err"] = float(
                    (lib.transpose(1, 2).float() - want.float()).abs().max())
            if dt == torch.float32:
                # gradients: the op (kernel forward, chunked backward)
                # against autograd of the plain version
                ct = torch.randn(q.shape, generator=gen, device=dev)
                grads = []
                for fn in (ops.flash_attention, fa.flash_attention_plain):
                    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                    fn(*leaves, **kw).backward(ct)
                    grads.append([x.grad for x in leaves])
                gerr = max(float((a - b_).abs().max()) / max(
                    1.0, float(b_.abs().max())) for a, b_ in zip(*grads))
                # fp32 sums over up to 2048 keys in other orders: 2e-5
                # relative to the gradient's largest entry
                if not (all(bool(torch.isfinite(g).all()) for g in grads[0])
                        and gerr < 2e-5):
                    failed.append(f"{name}: gradient error {gerr}")
                rec["grad_rel_err"] = gerr
            results.append(rec)
            say("phase 3:", json.dumps(rec))
    assert not failed, "phase 3: " + "; ".join(failed)
    return results


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serve engine
# ---------------------------------------------------------------------------


def phase4(dev):
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import Request, ServeEngine, blocks_for

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
    rng = np.random.default_rng(1)
    shapes = [(40, 4), (70, 3), (33, 5), (64, 6), (17, 2), (50, 4), (29, 3)]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                    g, arrival=0.5 * i) for i, (p, g) in enumerate(shapes)]
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


def profile_decode_call(engine, req, by_class=None):
    """(host ops, device busy ms) of one decode call, from a profile of the
    host and the card. Host ops: top-level aten calls (the count depends
    only on the model's structure, not on timing). Device busy: the summed
    durations of the call's kernels and copies on the card (None if the
    profiler recorded no device activity). ``by_class``, a dict, receives
    the busy ms by ``kernel_class``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, counts = engine.decode_step, []

    def counted(params, cache, batch):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = step(params, cache, batch)
            torch.cuda.synchronize()
        events = prof.events()
        host = sum(1 for e in events if e.name.startswith("aten::")
                   and (e.cpu_parent is None
                        or not e.cpu_parent.name.startswith("aten::")))
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
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


def profile_k2_by_mode(pa, make_engine, reqs):
    """Run ``reqs`` through a fresh engine under the profiler; returns (the
    completions, the profiled wall s, {mode: launches, kernel_s,
    ms_per_launch}). The wrapper records the mode (decode or append call)
    of each of its launches in order; one stream runs kernels in launch
    order, so the n-th K2 main kernel on the card is the n-th launch's,
    and a combine kernel belongs to the main kernel before it. (Matching
    by order, not by the host's and the card's clocks; the last n main
    kernels are taken, so nothing recorded from before the run counts.)"""
    from bisect import bisect_right

    from torch.autograd import DeviceType
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
    k2 = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and any(k in e.name for k in K2_KERNELS)]
    main = sorted((e for e in k2 if "combine_kernel" not in e.name),
                  key=lambda e: e.time_range.start)
    assert len(main) >= len(modes), (len(main), len(modes))
    main = main[len(main) - len(modes):]
    starts = [e.time_range.start for e in main]
    dev_ms = {"decode": 0.0, "append": 0.0}
    for e, m in zip(main, modes):
        dev_ms[m] += e.time_range.elapsed_us() / 1e3
    for e in k2:
        i = bisect_right(starts, e.time_range.start) - 1
        if "combine_kernel" in e.name and i >= 0:
            dev_ms[modes[i]] += e.time_range.elapsed_us() / 1e3
    calls = {m: modes.count(m) for m in ("decode", "append")}
    return comps, wall, {
        name: dict(launches=calls[name], kernel_s=dev_ms[name] / 1e3,
                   ms_per_launch=(dev_ms[name] / calls[name]
                                  if calls[name] else None))
        for name in ("decode", "append")}


def phase5(pa, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import Request, ServeEngine, blocks_for

    cfg = get_config("chatglm3-6b")
    bf16 = torch.bfloat16
    gen_len, max_seq = 32, 1024 + 32
    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                          n_stages=2, max_seq=max_seq, cache_dtype=bf16,
                          prefill_chunks=2, paged=True, block_size=BS,
                          n_blocks=4 * blocks_for(max_seq, BS))
    opts = ModelOptions(compute_dtype=bf16, use_paged_kernel=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, dtype=bf16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(p),))
                    .astype(np.int32), gen_len, arrival=float(i))
            for i, p in enumerate(rng.integers(128, 1025, 8))]

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
    comps2, wall2, by_mode = profile_k2_by_mode(
        pa, lambda: ServeEngine(cfg, eng, params, opts, device=dev), reqs)
    kernel_s = sum(v["kernel_s"] for v in by_mode.values())
    for v in by_mode.values():
        v["share_of_wall"] = v["kernel_s"] / wall
    assert [c.tokens for c in comps2] == [c.tokens for c in comps], \
        "the same trace gave different tokens on a second run"
    busy_by_class = {}
    ops_per_decode, busy_ms = profile_decode_call(
        ServeEngine(cfg, eng, params, opts, device=dev), reqs[0],
        busy_by_class)
    decode_ms = 1e3 * float(np.median(times["decode"]))
    rec = dict(
        card=card, layers=cfg.n_layers, d_model=cfg.d_model, dtype="bfloat16",
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
        ttft_p50_ticks=st.summary().get("ttft_p50"))
    say("phase 5: full chatglm3-6b bf16 paged serving:", json.dumps(rec))
    if variants:  # decode calls take split-KV, bf16 append chunks the tile
        slots_layers = eng.n_slots * cfg.n_layers
        assert variants == {
            "split_kv": len(times["decode"]) * slots_layers,
            "append_mma": len(times["append"]) * slots_layers}, variants
    return rec, launches


# ---------------------------------------------------------------------------
# Phases 6 and 7: training
# ---------------------------------------------------------------------------

TRAIN_HP = {"lr": [3e-3, 1e-3], "wd": [0.0, 0.01]}


def sequential_reference(cfg, params_host, batches, eval_batch, k, dev):
    """Trial k trained alone: its own unpipelined loss (the mean over the
    microbatches of lm.loss_fn, plain attention), its true gradient norm,
    the same AdamW. Returns (per-step losses, the loss on ``eval_batch``
    after the last update, final params on the host)."""
    from repro_torch.models import lm
    from repro_torch.models.layers import ModelOptions
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    p = tree_map(lambda t: t[k].to(dev, copy=True).requires_grad_(),
                 params_host)
    stacked = lambda tree: tree_map(lambda t: t[None], tree)
    opt = AdamW(grad_clip=1.0)
    state = opt.init(stacked(p))
    hp = {n: v[k:k + 1] for n, v in TRAIN_HP.items()}

    def loss_of(batch):
        n_micro = batch["tokens"].shape[1]
        return sum(lm.loss_fn(cfg, ModelOptions(), p, {
            "tokens": torch.from_numpy(batch["tokens"][k, m]).to(dev),
            "labels": torch.from_numpy(batch["labels"][k, m]).to(dev)})
            for m in range(n_micro)) / n_micro

    losses = []
    for step, batch in enumerate(batches):
        loss = loss_of(batch)
        loss.backward()
        grads = tree_map(lambda t: t.grad[None], p)
        sq = [torch.linalg.vector_norm(g).square()
              for g in tree_leaves(grads)]
        opt.update(stacked(p), grads, state, hp, step,
                   grad_norm=torch.sqrt(sum(sq)).reshape(1))
        tree_map(lambda t: t.grad.zero_(), p)
        losses.append(loss.item())
    with torch.no_grad():
        final_loss = loss_of(eval_batch).item()
    return losses, final_loss, tree_map(
        lambda t: t.detach().to("cpu", copy=True), p)


def phase6(dev, card):
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.data.pipeline import TrainBatches
    from repro_torch.models.layers import ModelOptions
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    eng = pl.EngineConfig(n_trials=2, n_microbatches=2, microbatch=1,
                          n_stages=2)
    seq, n_steps = 512, 2
    gen = torch.Generator(device=dev).manual_seed(3)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, 2), gen,
                                  device=dev)
    host0 = tree_map(lambda t: t.to("cpu", copy=True), params)
    data = TrainBatches(cfg, eng, seq, seed=0)
    # the last batch is held out: both runs' losses after the last update
    *batches, eval_batch = [data.batch_for_step(i)
                            for i in range(n_steps + 1)]
    data.close()
    opt = AdamW(grad_clip=1.0)
    state = opt.init(params)
    opts = ModelOptions(remat=True, use_flash_kernel=True)
    step = pl.make_train_step(cfg, opts, eng, opt)
    pipe_losses = []
    for i, batch in enumerate(batches):
        params, state, met = step(params, state, batch, TRAIN_HP, i)
        pipe_losses.append(met["loss"].tolist())
    with torch.no_grad():
        pipe_final = pl.pipeline_train_loss(cfg, opts, eng, params,
                                            eval_batch)[0].tolist()
    pipe_params = tree_map(lambda t: t.to("cpu", copy=True), params)
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    loss_err = param_err = 0.0
    change_err = []
    for k in range(eng.n_trials):
        ref_losses, ref_final, ref_params = sequential_reference(
            cfg, host0, batches, eval_batch, k, dev)
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
    rec = dict(card=card, layers=cfg.n_layers, d_model=cfg.d_model,
               trials=eng.n_trials, stages=eng.n_stages,
               microbatches=eng.n_microbatches, seq=seq, steps=n_steps,
               pipelined_losses=pipe_losses, pipelined_final_losses=pipe_final,
               max_loss_err=loss_err, max_param_err=param_err,
               param_change_rel_err=change_err)
    say("phase 6: pipelined train step (flash kernel) vs sequential "
        "single-trial runs:", json.dumps(rec))
    assert loss_err < 2e-4, f"loss error {loss_err}"
    assert param_err < 5e-3, f"param error {param_err}"
    assert max(change_err) < 0.1, f"parameter change error {change_err}"
    return rec


def model_flops_per_step(cfg, eng, seq):
    """Model FLOPs of one train step (no remat recompute counted): 6 per
    matmul parameter per token (forward + backward), plus attention's
    4·hd·hq per attended causal pair per layer, times 3."""
    tokens = eng.n_trials * eng.n_microbatches * eng.mb_global * seq
    matmul = cfg.n_layers * (cfg.layer_param_count() - 2 * cfg.d_model) \
        + cfg.d_model * cfg.vocab_size  # layers' weights + the head
    pairs = seq * (seq + 1) // 2
    attn = 3 * 4 * cfg.head_dim * cfg.n_heads * pairs * cfg.n_layers
    return 6 * matmul * tokens + attn * tokens // seq


def kernel_class(name: str) -> str:
    n = name.lower()
    if any(k in name for k in K1_KERNELS):
        return "k1_flash_attention"
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


def profile_train_step(cfg, opts, eng, seq, dev):
    """Device time by kernel class over one more train step of the planned
    gang (fresh weights from a seed; one warm step first, which allocates
    the gradient buffer): the summed durations of the step's kernels and
    copies on the card, from a profile with CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.data.pipeline import TrainBatches
    from repro_torch.optim.adamw import AdamW

    gen = torch.Generator(device=dev).manual_seed(0)
    params = pl.init_trial_params(cfg, eng, plan_stages(cfg, eng.n_stages),
                                  gen, device=dev)
    opt = AdamW(grad_clip=1.0)
    state = opt.init(params)
    step = pl.make_train_step(cfg, opts, eng, opt)
    data = TrainBatches(cfg, eng, seq, seed=0)
    batches = [data.batch_for_step(i) for i in range(2)]
    data.close()
    hp = {"lr": [3e-3, 1.5e-3], "wd": [0.0, 0.0]}
    step(params, state, batches[0], hp, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, state, batches[1], hp, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_class, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = kernel_class(e.name)
            by_class[c] = by_class.get(c, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
    return dict(profiled_step_ms=1e3 * wall, device_kernels=n,
                device_busy_ms=sum(by_class.values()),
                busy_ms_by_class=by_class)


def phase7(fa, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.core import hydra
    from repro_torch.core import pipeline as pl
    from repro_torch.core.scheduler import per_chip_bytes, state_bytes
    from repro_torch.core.trials import grid_search
    from repro_torch.models.layers import ModelOptions
    from repro_torch.obs.tracer import Tracer

    # as launch/train.py --n-layers 4 --trials 2 --steps 3 --n-model 2
    # --seq-len 2048 builds it
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=4)
    opts = ModelOptions(remat=True, use_flash_kernel=True)
    base = pl.EngineConfig(n_trials=2, n_microbatches=4, microbatch=1,
                           n_stages=2)
    seq, n_steps = 2048, 3
    hc = hydra.HydraConfig(seq_len=seq, steps=n_steps)
    trials = grid_search(cfg.name, [3e-3 * 0.5 ** i for i in range(2)])

    step_s, in_step, events = [], [False], []
    real_make, real_kernel = pl.make_train_step, fa.flash_attention_kernel

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
    pl.make_train_step, fa.flash_attention_kernel = timed_make, evented
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)  # count the training path's launches only
    t0 = time.perf_counter()
    try:
        out = hydra.run_model_selection(cfg, opts, hc, trials, base,
                                        tracer=tracer, device=dev)
    finally:
        pl.make_train_step, fa.flash_attention_kernel = real_make, real_kernel
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    variants = dict(getattr(fa, "variant_launches", {}))
    peak = torch.cuda.max_memory_allocated()
    gang = [e for e in tracer.events if e["ev"] == "span_begin"
            and e["name"] == "gang"]
    ends = [e for e in tracer.events if e["ev"] == "span_end"
            and e["name"] == "gang"]
    assert len(gang) == 1 and gang[0]["n_trials"] == 2, gang
    K, M = gang[0]["n_trials"], gang[0]["n_microbatches"]
    S, L = base.n_stages, cfg.n_layers
    # per train step every layer's forward runs 3 times per (trial,
    # microbatch) slot — forward, the (stage, slot) recompute (tick remat),
    # the layer recompute (layer remat) — except that torch's checkpoint
    # early stop skips the layer recompute of the last layer of each stage
    # before the last; the evaluation pass runs each layer once per slot
    expected = n_steps * K * M * (3 * L - (S - 1)) + K * M * L
    assert launches == expected > 0, (launches, expected)
    assert [e["restarts"] for e in ends] == [0], ends
    res = out["all"]
    assert len(res) == 2 and all(np.isfinite(r.train_loss)
                                 and np.isfinite(r.val_loss) for r in res)
    eng = dataclasses.replace(base, n_trials=K, n_microbatches=M)
    steady = step_s[1:]
    step_ms = 1e3 * float(np.median(steady))
    flops = model_flops_per_step(cfg, eng, seq)
    kernel_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    rec = dict(
        card=card, layers=L, d_model=cfg.d_model, dtype="float32",
        params_per_trial=cfg.param_count(), trials=K, microbatches=M,
        stages=S, microbatch=base.microbatch, seq=seq, steps=n_steps,
        bubble_fraction=eng.bubble_fraction, step_ms=step_ms,
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
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_train_step(cfg, opts, eng, seq, dev)
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / step_ms
    rec["profile"] = prof
    say(f"phase 7: gang plan K={K} M={M} (S={S}, bubble "
        f"{eng.bubble_fraction:.4f})")
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
                es = args[0].element_size()
                # each input read once, each output written once
                nbytes = (2 * b * s * di * n * es + b * s * n * es
                          + b * di * n * 4 * 2 + b * s * di * es)
                ops_n = 4 * b * s * di * n  # 2 FMAs per (t, channel, state)
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = ops_n / PEAK_OPS[torch.float32]  # fp32 arithmetic
                rec.update(
                    ms=cuda_ms(lambda: ms.mamba_scan_kernel(*args), flush),
                    plain_ms=cuda_ms(lambda: ms.mamba_scan_plain(*args),
                                     flush, iters=10, warmup=2),
                    library_ms=None,
                    bound_ms=1e3 * max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
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


def ssm_engine(cfg, dtype, dev, seed, max_seq):
    """falcon-mamba-7b behind the dense ServeEngine as launch/serve.py
    builds it: 2 stages, 2 slots x microbatch 2, split admission with 2
    prefill chunks, K3 in every append."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serve import ServeEngine

    eng = pl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                          n_stages=2, max_seq=max_seq, cache_dtype=dtype,
                          prefill_chunks=2)
    opts = ModelOptions(compute_dtype=dtype, use_mamba_kernel=True)
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
    eng, _, params, make = ssm_engine(cfg, torch.float32, dev, 9, max_seq)
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
    eng, _, params, make = ssm_engine(cfg, bf16, dev, 0, max_seq)
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


PHASES = tuple(range(1, 11))


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
    sys.path.insert(0, str(ROOT / "src"))
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
    builds = [(m.SOURCE, kbuild.start(m.SOURCE)) for m in (pa, fa, ms)]
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

    def tidy():
        gc.collect()
        torch.cuda.empty_cache()

    # the flush (a 512 MiB memset, about 0.2 ms) also keeps the card busy
    # while the host enqueues the timed call, so a short kernel's time
    # holds no host gap
    new_flush = lambda: torch.empty(512 * 2**20 // 4, dtype=torch.float32,
                                    device=dev)
    flush = new_flush()
    if 2 in run:
        res["phase2"] = phase2(pa, dev, flush, card)
    if 3 in run:
        res["phase3"] = phase3(fa, ops, dev, flush, card)
    del flush  # kept out of the serving and training phases' peak memory
    if 4 in run:
        res["phase4"] = phase4(dev)
    # phase 4's engine holds its weights in a reference cycle (the transfer
    # engine's cache callbacks): collect it, or its ~3.8 GB lingers into
    # phase 5's peak memory
    tidy()
    if 5 in run:
        res["phase5"], pa_launches = phase5(pa, dev, card)
        tidy()
    if 6 in run:
        res["phase6"] = phase6(dev, card)
        tidy()
    if 7 in run:
        res["phase7"], fa_launches = phase7(fa, dev, card)
        tidy()
    if 8 in run:
        flush = new_flush()
        res["phase8"], res["phase8_grad_rel_err"] = phase8(ms, ops, dev,
                                                           flush, card)
        del flush
        tidy()
    if 9 in run:
        res["phase9"] = phase9(ms, dev, card)
        tidy()
    if 10 in run:
        res["phase10"], ms_launches = phase10(ms, dev, card)
    if run != set(PHASES):
        if args.out:
            write_json(args.out, res)
        say(f"partial run (phases {sorted(run)}): every phase run passed")
        return 0
    p2, p3, p8 = res["phase2"], res["phase3"], res["phase8"]

    row = next(c for c in p2
               if c["case"] == "decode" and c["dtype"] == "bfloat16")
    frow = next(c for c in p3
                if c["case"] == "train2048" and c["dtype"] == "float32")
    srow = next(c for c in p8
                if c["case"] == "path512" and c["dtype"] == "float32")
    kernels = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:189",
        "launches": pa_launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:83",
        "launches": fa_launches, "max_abs_err": frow["max_abs_err"],
        "ms": frow["ms"], "plain_ms": frow["plain_ms"],
        "bound_ms": frow["bound_ms"], "bound_by": frow["bound_by"],
        "library_ms": frow["library_ms"]}, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:62",
        "launches": ms_launches, "max_abs_err": srow["max_abs_err"],
        "ms": srow["ms"], "plain_ms": srow["plain_ms"],
        "bound_ms": srow["bound_ms"], "bound_by": srow["bound_by"],
        "library_ms": None}]}
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
