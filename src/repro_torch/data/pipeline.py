"""Data pipeline: deterministic synthetic token streams, host-sharded loading
and background prefetch — a numpy copy of ``repro/data/pipeline.py``.

Determinism contract (the reference's): the tokens for (trial k, step t,
microbatch m, row r) depend only on (seed, k, t, m, r), drawn from numpy's
Philox generator exactly as the reference draws them, so a batch here is
bit-identical to the JAX package's for the same seed and engine shape.
Batches are numpy int32; the train step moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


def _philox(seed: int, *counters: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=counters[0]))


@dataclasses.dataclass(frozen=True)
class SyntheticTokenSource:
    """Zipf-ish synthetic token stream (deterministic per coordinates)."""

    vocab_size: int
    seq_len: int
    seed: int = 0

    def sequence(self, trial: int, step: int, micro: int, row: int) -> np.ndarray:
        ctr = ((trial * 1_000_003 + step) * 1_000_033 + micro) * 1_000_037 + row
        rng = _philox(self.seed, ctr)
        # zipf-flavored ids clipped to vocab (more realistic than uniform)
        raw = rng.zipf(1.3, size=self.seq_len + 1)
        return (raw % self.vocab_size).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class HostShard:
    """Which global batch rows this host materializes (multi-host loading)."""

    process_index: int
    process_count: int

    def rows(self, global_rows: int) -> range:
        per = global_rows // self.process_count
        lo = self.process_index * per
        hi = global_rows if self.process_index == self.process_count - 1 \
            else lo + per
        return range(lo, hi)


def _gen_tokens(vocab: int, seq: int, eng, step: int,
                seed: int) -> np.ndarray:
    """(K, M, microbatch × data_size, seq + 1) tokens: every data shard's
    rows of one global microbatch."""
    src = SyntheticTokenSource(vocab, seq, seed)
    out = np.empty((eng.n_trials, eng.n_microbatches, eng.mb_global,
                    seq + 1), np.int32)
    for k in range(eng.n_trials):
        for m in range(eng.n_microbatches):
            for r in range(eng.mb_global):
                out[k, m, r] = src.sequence(k, step, m, r)
    return out


class TrainBatches:
    """Iterator of slot-major train batches with background prefetch.
    ``batch_for_step`` builds any step's batch directly (what the Hydra
    runner calls)."""

    def __init__(self, cfg: ArchConfig, eng, seq_len: int, seed: int = 0,
                 prefetch: int = 2):
        if cfg.frontend is not None or cfg.rope == "mrope":
            raise NotImplementedError("frontend / M-RoPE batches are not "
                                      "ported yet")
        self.cfg, self.eng, self.seq_len, self.seed = cfg, eng, seq_len, seed
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def batch_for_step(self, step: int) -> dict:
        full = _gen_tokens(self.cfg.vocab_size, self.seq_len, self.eng, step,
                           self.seed)
        return {"tokens": full[..., :-1], "labels": full[..., 1:]}

    def _producer(self):
        while not self._stop.is_set():
            b = self.batch_for_step(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> dict:
        return self._q.get()

    def __iter__(self) -> Iterator[dict]:
        return self

    def close(self):
        self._stop.set()
