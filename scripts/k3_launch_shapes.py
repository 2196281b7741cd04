"""Time launch-shape variants of the selective-scan kernel (K3) on one card.

Run from the repo root on a machine with an NVIDIA H100 and nvcc:

    python3 scripts/k3_launch_shapes.py

Each variant is ``src/repro_torch/csrc/mamba_scan.cu`` with its two launch
constants replaced (``kUnroll``: time steps per load group; ``kMinBlocks``:
the ``__launch_bounds__`` floor of resident blocks per SM, which caps the
registers a thread may take), built with the port's nvcc flags into
``build/k3_variants/``. Every variant is checked against the plain version
and timed as ``chip_smoke.py`` phase 8 times the kernel (CUDA events, L2
flushed, median of 30) at the serving path's largest shape (b 2, s 512,
d_inner 8192, d_state 16), fp32 and bf16 inputs, in turns (the committed
variant first and last). Prints one JSON line per measurement.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402

UNROLL = "constexpr int kUnroll = 4;"
MIN_BLOCKS = "constexpr int kMinBlocks = 4;"
VARIANTS = [(4, 4), (4, 1), (2, 1), (2, 4)]  # (kUnroll, kMinBlocks)


def build_all(out: Path) -> dict:
    src = ms.SOURCE.read_text()
    assert UNROLL in src and MIN_BLOCKS in src, "launch constants moved"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for u, mb in VARIANTS:
        name = f"unroll{u}_minblocks{mb}"
        cu = out / f"{name}.cu"
        cu.write_text(src.replace(UNROLL, f"constexpr int kUnroll = {u};")
                      .replace(MIN_BLOCKS,
                               f"constexpr int kMinBlocks = {mb};"))
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *kbuild.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        regs = sorted({int(line.split("Used")[1].split()[0])
                       for line in err.splitlines() if "Used" in line})
        spills = any("spill stores" in line and " 0 bytes spill stores"
                     not in line for line in err.splitlines())
        cs.say(json.dumps({"variant": name, "registers": regs,
                           "spills": spills}))
        fn = ctypes.CDLL(str(out / f"{name}.so")).mamba_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)  # noqa: T201
        return 2
    fns = build_all(ROOT / "build" / "k3_variants")
    dev = torch.device("cuda")
    card = cs.card_line()
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    order = list(fns) + [next(iter(fns))]
    for dt in (torch.float32, torch.bfloat16):
        da, dbx, c, h0 = cs.scan_inputs(dev, dt, 2, 512, 8192, 16, False,
                                        gen)
        want_y, want_h = ms.mamba_scan_plain(da, dbx, c, h0)
        y, h = torch.empty_like(want_y), torch.empty_like(want_h)
        stream = torch.cuda.current_stream().cuda_stream
        for name in order:
            def call(fn=fns[name]):
                rc = fn(da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
                        h0.data_ptr(), y.data_ptr(), h.data_ptr(), 2, 512,
                        8192, 16, c.stride(0), c.stride(1),
                        int(dt == torch.bfloat16), stream)
                assert rc == 0, f"{name}: CUDA error {rc}"
            call()
            torch.cuda.synchronize()
            err = max(float((y.float() - want_y.float()).abs().max()),
                      float((h - want_h).abs().max()))
            assert err < cs.SCAN_TOL[dt], (name, err)
            cs.say(json.dumps({"card": card, "variant": name,
                               "dtype": str(dt).split(".")[-1],
                               "max_abs_err": err,
                               "ms": cs.cuda_ms(call, flush)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
