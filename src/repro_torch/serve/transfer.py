"""Async transfer engine: all block movement, batched once per round.

Before this module each movement kind had its own ad-hoc path —
``pipeline.make_block_copy`` was a one-shot CoW device copy the engine
flushed per call site, and swap-out/swap-in did not exist. The
:class:`TransferEngine` is now the single owner of block movement over the
pool:

* **CoW copies** (device → device): ``copy()`` enqueues (src, dst) pairs;
  one compiled pool-copy call per engine round moves them all.
* **Swap-in** (host → device): ``swap_in()`` enqueues a spilled payload for
  injection into a freshly allocated device block (prefix-cache restores,
  retraction restores).
* **Swap-out** (device → host): ``swap_out()`` extracts payloads *eagerly* —
  reclamation needs the device block back on the free list in the same
  Python call (the allocator retry follows immediately), and extraction is
  a read, so there is nothing to defer.

In-flight rule
--------------
Between enqueue and :meth:`flush`, every copy/swap-in *destination* block is
**in-flight**: its pool bytes do not yet hold the intended K/V, so no
compute call may read it and no caller may mutate, extract, or retract it
(:meth:`in_flight` is the query; the serve engine asserts the rule before
every pipeline call and skips in-flight slots as retraction victims).
``flush()`` applies swap-ins first, then CoW copies — a copy whose *source*
was restored this same round therefore reads the injected bytes, never the
stale pool content.

Kernels come from ``pipeline.make_transfer_kernels``; ``kernels=None`` runs
the engine in pure-bookkeeping mode (payloads are ``None``) so host-side
scheduling tests exercise the full lifecycle without tensors.
"""
from __future__ import annotations

from typing import List

import numpy as np


class TransferEngine:
    """Batched-per-round block mover over the (trial, shard)-partitioned pool.

    ``n_trials``/``n_shards`` recover the (k, shard) coordinates of a pool
    partition (p = k * n_shards + shard) so enqueued ops can be packed into
    the compiled kernels' (K, dp, C) id layout at flush time. ``bind()``
    attaches the cache accessors (the engine owns the live cache pytree;
    flush reads and replaces it through these).
    """

    def __init__(self, n_trials: int, n_shards: int, kernels=None):
        self.n_trials = n_trials
        self.n_shards = n_shards
        self.kernels = kernels
        self._get_cache = None
        self._set_cache = None
        self._copies: List[tuple] = []  # (partition, src, dst)
        self._swap_ins: List[tuple] = []  # (partition, dst, payload)
        self._in_flight: set = set()  # {(partition, block)} — dsts pre-flush
        self.cow_copies = 0
        self.swap_in_blocks = 0
        self.swap_out_blocks = 0
        self.round_peak = 0  # max concurrent in-flight dsts since last take

    def bind(self, get_cache, set_cache) -> None:
        self._get_cache = get_cache
        self._set_cache = set_cache

    # -- queries -------------------------------------------------------------

    def in_flight(self, partition: int, block: int) -> bool:
        """True while ``block`` is a pending transfer destination: its pool
        bytes are not yet valid — never read, mutate, or retract it."""
        return (partition, block) in self._in_flight

    def pending(self) -> int:
        return len(self._copies) + len(self._swap_ins)

    def take_round_peak(self) -> int:
        """Peak in-flight destination count since the last call — the
        per-round transfer-pressure sample of the tracer's round record."""
        peak, self.round_peak = self.round_peak, len(self._in_flight)
        return peak

    # -- enqueue -------------------------------------------------------------

    def copy(self, partition: int, src: int, dst: int) -> None:
        """Enqueue a CoW pool copy dst := src (both partition-local ids).
        ``dst`` is in-flight until flush; ``src`` stays readable."""
        self._copies.append((partition, src, dst))
        self._in_flight.add((partition, dst))
        self.round_peak = max(self.round_peak, len(self._in_flight))
        self.cow_copies += 1

    def swap_in(self, partition: int, dst: int, payload) -> None:
        """Enqueue a host → device restore of one spilled payload into pool
        block ``dst`` (freshly allocated by the caller); ``dst`` is in-flight
        until flush."""
        self._swap_ins.append((partition, dst, payload))
        self._in_flight.add((partition, dst))
        self.round_peak = max(self.round_peak, len(self._in_flight))
        self.swap_in_blocks += 1

    # -- eager device → host -------------------------------------------------

    def swap_out(self, partition: int, ids) -> list:
        """Extract the K/V payloads of pool blocks ``ids`` (device → host),
        eagerly — the caller frees the device blocks right after, so the
        bytes must be off the pool before this returns. Read-only: shared
        blocks (refcount > 1) may be extracted safely. Returns one opaque
        payload per id (``None`` each in bookkeeping mode)."""
        ids = list(ids)
        self.swap_out_blocks += len(ids)
        if self.kernels is None or not ids:
            return [None] * len(ids)
        k, shard = divmod(partition, self.n_shards)
        return self.kernels.extract(self._get_cache(), k, shard, ids)

    # -- flush ---------------------------------------------------------------

    def _pack(self, ops) -> tuple:
        """(K, n_shards, C) -1-padded local-id arrays for the copy kernel;
        C bucketed to powers of two to bound compile shapes."""
        per: dict = {}
        for p, src, dst in ops:
            per.setdefault(divmod(p, self.n_shards), []).append((src, dst))
        c = 1
        while c < max(len(v) for v in per.values()):
            c *= 2
        s = np.full((self.n_trials, self.n_shards, c), -1, np.int32)
        d = np.full((self.n_trials, self.n_shards, c), -1, np.int32)
        for (k, sh), pairs in per.items():
            for j, (s_, d_) in enumerate(pairs):
                s[k, sh, j], d[k, sh, j] = s_, d_
        return s, d

    def flush(self) -> int:
        """Apply every enqueued op to the live cache — swap-ins first (a CoW
        source restored this round must read injected bytes, not stale pool
        content), then the batched CoW copy call — and clear the in-flight
        set. Returns the number of ops applied."""
        n = self.pending()
        if n == 0:
            return 0
        if self.kernels is not None:
            cache = self._get_cache()
            if self._swap_ins:
                per: dict = {}
                for p, dst, payload in self._swap_ins:
                    per.setdefault(divmod(p, self.n_shards),
                                   []).append((dst, payload))
                for (k, shard), items in per.items():
                    cache = self.kernels.inject(
                        cache, k, shard, [d for d, _ in items],
                        [pl_ for _, pl_ in items])
            if self._copies:
                src, dst = self._pack(self._copies)
                cache = self.kernels.copy(cache, src, dst)
            self._set_cache(cache)
        self._copies = []
        self._swap_ins = []
        self._in_flight = set()
        return n


def make_null_transfer(n_trials: int = 1,
                       n_shards: int = 1) -> "TransferEngine":
    """Bookkeeping-only transfer engine (no kernels, payloads = None) for
    host-side scheduling tests of the tiered store lifecycle."""
    return TransferEngine(n_trials, n_shards, kernels=None)


__all__ = ["TransferEngine", "make_null_transfer"]
