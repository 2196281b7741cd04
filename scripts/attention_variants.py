"""Time launch-shape variants of the attention kernels (K1, K2) on one card.

Run from the repo root on a machine with an NVIDIA H100 and nvcc:

    python3 scripts/attention_variants.py [--baseline-k1 OLD.cu]

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` (K1) or
``paged_attention.cu`` (K2) with launch constants replaced, built with the
port's nvcc flags into ``build/attn_variants/``: the warps of a tensor-core
block (16 query rows each: ``kMmaWarps`` in K1, ``kTileWarps`` in K2's
append tile) and the resident blocks per SM its ``__launch_bounds__`` asks
for (``kMmaMinBlocks``, ``kTileMinBlocks``: a register cap), and K1's keys per
K / V tile (``kMmaKeys``).
``--baseline-k1`` adds another K1 source with the same C entry (for
instance the parent commit's, unpacked elsewhere). Every variant is checked
against the plain version and timed as ``chip_smoke.py`` phases 2 and 3
time the kernels (CUDA events, L2 flushed, median of 30) at the shapes of
the main paths: K1 at phase 3's ``train2048`` (bf16 and fp32), K2 at phase
2's ``append64`` and ``p5_append486`` (bf16), in turns (the committed
source first and last); and the split-KV planner's target (splits x row
tiles, a host-side constant) at phase 2's bf16 ``decode`` and
``p5_decode``. Prints one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

K1_WARPS = "constexpr int kMmaWarps = 4;"
K1_MIN = "constexpr int kMmaMinBlocks = 3;"
K1_KEYS = "constexpr int kMmaKeys = 64;"
K2_WARPS = "constexpr int kTileWarps = 4;"
K2_MIN = "constexpr int kTileMinBlocks = 2;"


def variant_sources(baseline_k1):
    """{name: (module, source text)}; the committed sources come first."""
    k1, k2 = fa.SOURCE.read_text(), pa.SOURCE.read_text()
    assert all(c in k1 for c in (K1_WARPS, K1_MIN, K1_KEYS)) \
        and all(c in k2 for c in (K2_WARPS, K2_MIN)), "constants moved"
    out = {"k1_committed": (fa, k1),
           "k1_warps8_minblocks1": (fa, k1.replace(
               K1_WARPS, "constexpr int kMmaWarps = 8;").replace(
               K1_MIN, "constexpr int kMmaMinBlocks = 1;")),
           "k1_warps8_keys128": (fa, k1.replace(
               K1_WARPS, "constexpr int kMmaWarps = 8;").replace(
               K1_MIN, "constexpr int kMmaMinBlocks = 1;").replace(
               K1_KEYS, "constexpr int kMmaKeys = 128;")),
           "k2_committed": (pa, k2),
           "k2_minblocks3": (pa, k2.replace(
               K2_MIN, "constexpr int kTileMinBlocks = 3;"))}
    if baseline_k1:
        out["k1_baseline"] = (fa, Path(baseline_k1).read_text())
    return out


def build_all(sources, out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, text) in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *kbuild.NVCC_FLAGS,
             "-I", str(fa.SOURCE.parent), "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
        regs = [line.split("Used")[1].split(",")[0].strip()
                for line in err.splitlines() if "registers" in line]
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
    return libs


def bind(mod, lib, entry: str) -> None:
    """Point ``mod``'s wrapper at ``lib`` (the same C entry and argtypes)."""
    committed = getattr(mod._entry(), "argtypes")
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = committed, ctypes.c_int
    mod._lib = lib


def k1_case(dev, dt):
    name, b, sq, sk, hq, hkv, hd, causal, window, off = cs.FLASH_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    mk = lambda *shape: torch.randn(*shape, generator=gen,
                                    device=dev).to(dt)
    q, k, v = mk(b, sq, hq, hd), mk(b, sk, hkv, hd), mk(b, sk, hkv, hd)
    kw = dict(causal=causal, window=window, kv_offset=off)
    return name, (q, k, v), kw, fa.flash_attention_kernel, \
        fa.flash_attention_plain, cs.FLASH_TOL[dt]


def k2_case(dev, dt, case_name):
    i = next(j for j, c in enumerate(cs.CASES) if c[0] == case_name)
    name, sq, offsets, q_lens, window, bs, n_tbl, _ = cs.CASES[i]
    a = cs.make_case(dev, dt, sq, offsets, q_lens, seed=i, bs=bs,
                     n_tbl=n_tbl)
    args = tuple(a[n] for n in ("q", "k_pool", "v_pool", "block_tables",
                                "kv_offset", "kv_len"))
    kw = dict(causal=True, window=window, q_lens=a["q_lens"])
    return name, args, kw, pa.paged_attention_kernel, \
        pa.paged_attention_plain, cs.TOL[dt]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-k1", default="",
                    help="another K1 source with the same C entry")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)  # noqa: T201
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    sources = variant_sources(args.baseline_k1)
    libs = build_all(sources, ROOT / "build" / "attn_variants")
    flush = torch.empty(512 * 2**20 // 4, dtype=torch.float32, device=dev)
    cases = [("k1", k1_case(dev, torch.bfloat16)),
             ("k1", k1_case(dev, torch.float32)),
             ("k2", k2_case(dev, torch.bfloat16, "append64")),
             ("k2", k2_case(dev, torch.bfloat16, "p5_append486"))]
    for kern, (name, xs, kw, fn, plain, tol) in cases:
        names = [n for n in sources if n.startswith(kern)]
        order = names + [names[0]]  # the committed source first and last
        want = plain(*xs, **kw)
        for var in order:
            mod, _ = sources[var]
            bind(mod, libs[var], "flash_attention_fwd" if kern == "k1"
                 else "paged_attention_fwd")
            got = fn(*xs, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ms = cs.cuda_ms(lambda: fn(*xs, **kw), flush)
            print(json.dumps(dict(card=card, variant=var, case=name,
                                  dtype=str(xs[0].dtype).split(".")[-1],
                                  max_abs_err=err, ok=err < tol, ms=ms)),
                  flush=True)
    for mod in (fa, pa):
        mod._lib = None  # back to the committed build
    # the split-KV plan's target (splits x row tiles): a host-side constant
    rows, chunk, committed = pa.SPLIT_PLAN["split_kv"]
    for case in ("decode", "p5_decode"):
        name, xs, kw, fn, plain, tol = k2_case(dev, torch.bfloat16, case)
        want = plain(*xs, **kw)
        for target in (committed, 16, 64, committed):
            pa.SPLIT_PLAN["split_kv"] = (rows, chunk, target)
            got = fn(*xs, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ms = cs.cuda_ms(lambda: fn(*xs, **kw), flush)
            print(json.dumps(dict(card=card, variant=f"split_target{target}",
                                  case=name, dtype="bfloat16",
                                  max_abs_err=err, ok=err < tol, ms=ms)),
                  flush=True)
    pa.SPLIT_PLAN["split_kv"] = (rows, chunk, committed)
    # device time by kernel of one bf16 decode call (split-KV + combine)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for case in ("decode", "p5_decode"):
        name, xs, kw, fn, _, _ = k2_case(dev, torch.bfloat16, case)
        fn(*xs, **kw)
        flush.zero_()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*xs, **kw)
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "kernel" in e.name \
                    and "elementwise" not in e.name:
                key = re.search(r"(\w+_kernel)\b", e.name).group(1)
                us[key] = us.get(key, 0.0) + e.time_range.elapsed_us()
        print(json.dumps(dict(card=card, case=name, dtype="bfloat16",
                              device_us_by_kernel=us)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
