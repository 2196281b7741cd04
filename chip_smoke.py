"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card (H100):

    python3 chip_smoke.py [--out results.json]

It builds the hand-written CUDA kernel from the checkout's sources and runs
six phases, each a hard assert; it exits 0 only if every phase passed, and
exits non-zero without a result when no CUDA device is visible.

1. Environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, TF32 off for matmuls and cuDNN, the kernel's build time.
2. The paged-attention kernel against its plain PyTorch version on the card
   at the main path's shapes (32 query heads on 2 KV heads, head_dim 128,
   block 16): decode over ragged kv_len 1..2048, a 64-wide append chunk at
   ragged offsets, a windowed case, ragged q_lens with a zero row, tables
   with -1 tails; each in fp32 (tol 2e-5) and bf16 (tol 3e-2). Times are
   CUDA-event medians of 30 launches after warm-up with L2 flushed; the
   bound is max(live K/V + q + out + index bytes / 3.35 TB/s, operations /
   peak rate of the input type).
3. Exactness: chatglm3-6b at full width, depth cut to 2 layers, fp32
   weights and pool, 2 stages, 2 data shards: every request's greedy tokens
   from the paged ServeEngine (kernel path) equal the single-device oracle.
4. The main path at full size: chatglm3-6b, 28 layers, bf16 weights and
   pool, random weights from a seed; paged kernel, split admission, 2
   stages, 2 slots x microbatch 2; 8 requests with 128-1024 prompt tokens
   and 32 new tokens each. Every request completes with its budget and the
   kernel's launch count equals calls x slots x layers. One more decode
   call is profiled for its host op count and the card's busy time.
5. A {"kernels": [...]} line for every ported kernel.
6. The last line: {"ok": true, "device": {"platform": "gpu", ...}}.
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


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

# name, sq, per-row kv_offset, q_lens (None = all sq), window
CASES = [
    ("decode", 1, [0, 16, 129, 510, 1023, 1499, 1999, 2047], None, 0),
    ("append64", 64, [0, 100, 700, 1900], None, 0),
    ("decode_window256", 1, [299, 899, 2047, 4], None, 256),
    ("append64_ragged_qlens", 64, [100, 200, 300, 400], [64, 1, 0, 33], 0),
]
N_BLOCKS, N_TBL = 1024, 128  # n_tbl: the power of two covering 2048 / 16


def make_case(dev, dt, sq, offsets, q_lens, seed):
    """Random pool and ragged tables: row r's live blocks are a random
    disjoint subset of the pool covering offsets[r] + sq positions; the rest
    of its table is -1."""
    rng = np.random.default_rng(seed)
    b = len(offsets)
    q_lens = [sq] * b if q_lens is None else q_lens
    tables = np.full((b, N_TBL), -1, np.int32)
    free = list(rng.permutation(N_BLOCKS))
    for r, off in enumerate(offsets):
        for j in range(-(-(off + sq) // BS)):
            tables[r, j] = free.pop()
    mk = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    return dict(q=mk(b, sq, HQ, HD), k_pool=mk(N_BLOCKS, BS, HKV, HD),
                v_pool=mk(N_BLOCKS, BS, HKV, HD),
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
    results = []
    for dt in (torch.float32, torch.bfloat16):
        for i, (name, sq, offsets, q_lens, window) in enumerate(CASES):
            a = make_case(dev, dt, sq, offsets, q_lens, seed=i)
            kw = dict(causal=True, window=window, q_lens=a["q_lens"])
            args = [a[n] for n in ("q", "k_pool", "v_pool", "block_tables",
                                   "kv_offset", "kv_len")]
            got = pa.paged_attention_kernel(*args, **kw)
            torch.cuda.synchronize()
            want = pa.paged_attention_plain(*args, **kw)
            err = float((got.float() - want.float()).abs().max())
            assert torch.isfinite(got).all(), name
            assert err < TOL[dt], f"{name}/{dt}: max |kernel - plain| {err}"
            ms = cuda_ms(lambda: pa.paged_attention_kernel(*args, **kw),
                         flush)
            plain_ms = cuda_ms(lambda: pa.paged_attention_plain(*args, **kw),
                               flush)
            es = a["q"].element_size()
            pairs, live = case_work(offsets, q_lens, sq, window)
            nbytes = (live * HKV * HD * 2 * es + 2 * a["q"].numel() * es
                      + 4 * (a["block_tables"].numel() + 3 * len(offsets)))
            ops = pairs * HQ * HD * 4  # QK^T and PV, 2 ops per MAC
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dt]
            rec = dict(card=card, case=name, dtype=str(dt).split(".")[-1],
                       b=len(offsets), sq=sq, window=window,
                       max_abs_err=err, tol=TOL[dt], ms=ms,
                       plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       live_kv_tokens=live, bytes=nbytes, ops=ops)
            results.append(rec)
            say("phase 2:", json.dumps(rec))
    return results


# ---------------------------------------------------------------------------
# Phases 3 and 4: the serve engine
# ---------------------------------------------------------------------------


def phase3(dev):
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
    say("phase 3: full-width 2-layer fp32 engine (2 stages, 2 data shards) "
        "vs single-device oracle:", json.dumps(rec))
    return rec


def profile_decode_call(engine, req):
    """(host ops, device busy ms) of one decode call, from a profile of the
    host and the card. Host ops: top-level aten calls (the count depends
    only on the model's structure, not on timing). Device busy: the summed
    durations of the call's kernels and copies on the card (None if the
    profiler recorded no device activity)."""
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
        dev = [e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA]
        counts.append((host, sum(dev) / 1e3 if dev else None))
        return out

    engine.decode_step = counted
    r = req.clone()
    r.max_new_tokens = 2  # prefill, then exactly one decode call
    engine.run([r])
    engine.decode_step = step
    assert counts, "no decode call was profiled"
    return counts[0]


def phase4(pa, dev, card):
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
    append_tokens = []

    def timed(name, step):
        def run(params, cache, batch):
            t = time.perf_counter()
            out = step(params, cache, batch)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            if name == "append":
                append_tokens.append(int(batch["active"].sum())
                                     * batch["tokens"].shape[-1])
            return out
        return run

    engine = ServeEngine(cfg, eng, params, opts, device=dev)
    engine.decode_step = timed("decode", engine.decode_step)
    engine.append_step = timed("append", engine.append_step)
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0  # count the main path's launches only
    t0 = time.perf_counter()
    comps = engine.run([r.clone() for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    st = engine.stats
    assert [c.rid for c in comps] == [r.rid for r in reqs]
    for r, c in zip(reqs, comps):
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
    expected = st.calls * eng.n_slots * cfg.n_layers
    assert launches == expected > 0, (launches, expected)

    # the kernel's share of wall time, from a second run of the same trace
    # with CUDA events around each launch (kept out of the timed run above)
    real, events = pa.paged_attention_kernel, []

    def evented(*args, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*args, **kw)
        e.record()
        events.append((s, e))
        return out

    pa.paged_attention_kernel = evented
    again = ServeEngine(cfg, eng, params, opts, device=dev)
    t1 = time.perf_counter()
    comps2 = again.run([r.clone() for r in reqs])
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t1
    pa.paged_attention_kernel = real
    kernel_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    assert [c.tokens for c in comps2] == [c.tokens for c in comps], \
        "the same trace gave different tokens on a second run"
    ops_per_decode, busy_ms = profile_decode_call(again, reqs[0])
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
        kernel_share_of_wall=kernel_s / wall2, kernel_s=kernel_s,
        host_ops_per_decode_call=ops_per_decode,
        decode_device_busy_ms=busy_ms,
        decode_device_idle_share=(None if busy_ms is None
                                  else 1.0 - busy_ms / decode_ms),
        instrumented_wall_s=wall2, param_init_s=init_s,
        ttft_p50_ticks=st.summary().get("ttft_p50"))
    say("phase 4: full chatglm3-6b bf16 paged serving:", json.dumps(rec))
    return rec, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every measured "
                    "number to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke test needs a GPU",  # noqa: T201
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("card:", card)
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    t0 = time.perf_counter()
    report = pa.build()
    build_s = time.perf_counter() - t0
    say(f"phase 1: built {pa.library_path().name} from "
        f"{pa.SOURCE.relative_to(ROOT)} in {build_s:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            say("  nvcc:", line.strip())

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    cases = phase2(pa, dev, flush, card)
    del flush
    p3 = phase3(dev)
    # phase 3's engine holds its weights in a reference cycle (the transfer
    # engine's cache callbacks): collect it, or its ~3.8 GB lingers into
    # phase 4's peak memory
    gc.collect()
    torch.cuda.empty_cache()
    p4, launches = phase4(pa, dev, card)

    row = next(c for c in cases
               if c["case"] == "decode" and c["dtype"] == "bfloat16")
    kernels = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:189",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}]}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            card=card, torch=torch.__version__, cuda=torch.version.cuda,
            build_s=build_s, phase2=cases, phase3=p3, phase4=p4,
            kernels=kernels["kernels"]), indent=1))
    say(json.dumps(kernels))
    say("card:", card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
