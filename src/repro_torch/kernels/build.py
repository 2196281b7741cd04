"""Build and load the port's CUDA kernels: one ``nvcc`` per source file
into a shared library with a plain C entry, loaded with ``ctypes``.

Each library lands under ``build/repro_torch/`` at the repo root (ignored
by git), named by a hash of its source, the headers beside it and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. :func:`start` launches ``nvcc``
without waiting, so a caller can build every kernel at once
(``chip_smoke.py`` does); :func:`build` is start-then-finish for one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error (launch refused, bad
    configuration, or a fault from earlier work on the stream)."""


def library_path(source: Path) -> Path:
    """The library built from ``source``: named by a hash of the source,
    every ``*.cuh`` header in its directory (which it may include) and the
    flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def start(source: Path) -> Optional[subprocess.Popen]:
    """Launch ``nvcc`` on ``source`` (None when the hashed library
    exists). Finish with :func:`finish`."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    return subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(source: Path, proc: Optional[subprocess.Popen]) -> str:
    """Wait for :func:`start`'s ``nvcc`` and move the library into place.
    Returns nvcc's report (``-Xptxas=-v``: registers, shared memory,
    spills); raises if the build failed."""
    if proc is None:
        return ""
    _, err = proc.communicate()
    out = library_path(source)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{err}")
    os.replace(tmp, out)
    return err


def build(source: Path) -> str:
    """Compile ``source`` (no-op when its hashed library exists)."""
    return finish(source, start(source))


def load(source: Path) -> ctypes.CDLL:
    """Build if needed, then load the library."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))
