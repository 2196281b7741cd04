"""Checkpointing: an npz of named leaves + a JSON manifest per step, with
an async writer that keeps the save off the training critical path — port
of ``repro/checkpoint/ckpt.py`` with the same on-disk layout::

    <dir>/step_000100/
        manifest.json          {"step": 100, "leaves": [...], "procs": N}
        proc00000.npz          every leaf, keyed by its path

Leaf names are the reference's paths (dict keys and sequence indices
joined by "/", dicts in sorted key order), and bf16 leaves are stored as
their uint16 bits under ``name::bf16``, so a checkpoint the JAX package
wrote restores into the port and the other way round. Trees are nested
dicts / lists / tuples of tensors (or numpy arrays); ``restore`` puts each
leaf on the template leaf's device and dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_map, tree_paths


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         process_index: int = 0, process_count: int = 1) -> str:
    """Synchronous save. Returns the checkpoint path."""
    named = tree_items(tree)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + f".tmp{process_index}"
    os.makedirs(tmp_dir, exist_ok=True)
    arrays = {}
    for name, leaf in named:
        bf16 = torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16
        arrays[name + "::bf16" if bf16 else name] = _to_numpy(leaf)
    np.savez(os.path.join(tmp_dir, f"proc{process_index:05d}.npz"), **arrays)
    if process_index == 0:
        manifest = {"step": step, "leaves": [n for n, _ in named],
                    "procs": process_count, "extra": extra or {}}
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    # atomic-ish rename (single process owns the final move)
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


def restore(ckpt_dir: str, step: int, template: Any,
            process_index: int = 0) -> Any:
    """Restore into the structure of ``template`` (values replaced): each
    leaf becomes a tensor on the template leaf's device, in its dtype."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(step_dir, f"proc{process_index:05d}.npz")) as z:
        data = {}
        for k in z.files:
            if k.endswith("::bf16"):
                data[k[:-6]] = torch.from_numpy(
                    z[k].view(np.int16)).view(torch.bfloat16)
            else:
                data[k] = torch.from_numpy(z[k])

    def load(leaf, name):
        if name not in data:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = data[name]
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {name!r}: checkpoint shape {tuple(arr.shape)} != "
                f"{want}")
        if torch.is_tensor(leaf):
            arr = arr.to(device=leaf.device, dtype=leaf.dtype)
        return arr

    return tree_map(load, template, tree_paths(template))


def manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot-to-host then write on a background thread.

    ``save`` copies every leaf to host memory *before* the writer thread
    starts, and returns only then: the train step updates parameters and
    optimizer state in place, so the thread must never read device
    tensors the next step is overwriting. Disk I/O runs in the background.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = tree_map(_host_copy, tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                cleanup(self.ckpt_dir, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _host_copy(leaf):
    """A host copy that shares no memory with ``leaf``."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)
