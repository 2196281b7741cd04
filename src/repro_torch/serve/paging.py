"""Paged KV-cache bookkeeping: block pool, ref-counted allocator, block tables.

The dense serve cache reserves one ``max_seq``-length strip per slot cell, so
``plan_serve_capacity`` must admit by worst-case length and a short request
strands the HBM behind its strip. Paging (vLLM-style) replaces the strips
with one shared pool of fixed-size blocks per layer; each live request owns a
*block table* — the ordered list of physical block ids backing its logical
token positions — which grows one block at a time as chunked prefill and
decode append tokens (alloc-on-append) and drops its references the round
the request completes.

Everything here is host-side scheduling state (plain Python, no torch): the
device side consumes the tables as ``(rows, max_blocks)`` int32 arrays whose
entries are *local* physical ids. When the batch rows are sharded over the
data/pod axes, each shard owns an equal slice of the pool and the allocator
is split into one **partition** per shard — rows allocate only from their
shard's partition, so the ids written into the table index that shard's
local pool slice directly and the SPMD kernel needs no id translation.

Admission against the pool is *exact* in this engine (generation always runs
to the request's ``max_new_tokens`` budget, so the final footprint is known
at enqueue time): the batcher commits ``blocks_for(total_len)`` per live
request and defers admission when the committed total would exceed the
partition's pool — the backpressure that replaces worst-case ``max_seq``
reservation. ``overcommit`` > 1 relaxes the committed-total gate
(statistical packing); the engine then backstops per-append failures by
*retracting* the lowest-priority running request instead of stalling (see
the retract/restore state machine below).

Two-tier lifecycle (device ⊂ store; see serve/store.py, serve/transfer.py)
--------------------------------------------------------------------------
The device pool is the fast tier of a :class:`~repro_torch.serve.store.BlockStore`
that also owns a host-memory tier of spilled payloads. Device blocks are a
*cache* over the store, not a hard capacity wall:

* a block is **device-resident** while its id is live in the allocator; it
  becomes **host-resident** when the transfer engine extracts its K/V to a
  host block and the device id is freed (prefix-cache spills, retraction
  swap-outs), and device-resident again when a restore allocates a fresh id
  and enqueues a swap-in;
* every pressure-driven reclamation flows through ``BlockStore.reclaim`` —
  ``BlockTable`` never talks to the prefix cache directly — so eviction
  ordering is one LRU walk across both tiers instead of per-call-site.

**Transfer-in-flight rule**: between enqueue and the transfer engine's
per-round ``flush()``, every copy/swap-in *destination* block holds stale
pool bytes. No compute call may read it, nothing may mutate or extract it,
and a slot whose table contains one is not a valid retraction victim. The
serve engine asserts this before every pipeline call.

**Retract/restore state machine** (overcommit > 1 only):

  RUNNING ──pool exhausted, youngest-first──► RETRACTED ──re-admitted──►
  RESTORING ──transfer flush──► RUNNING

  A retracted decode-phase request either *swap-restores* (its table's
  payloads were extracted to pinned host blocks at retraction; restore
  allocates fresh device blocks and swap-ins them — no recompute) or
  *recompute-restores* (host tier full/disabled: replay prompt + generated
  tokens as a teacher-forced prefill; the replay's final head output must
  equal the last generated token). Both paths yield tokens bit-identical to
  an un-preempted run. A retracted prefill-phase request simply requeues.

Refcount / copy-on-write invariants (prefix sharing, see prefix_cache.py)
-------------------------------------------------------------------------
Blocks are **ref-counted** so one physical block can back the same logical
prefix of several requests at once (and of the radix prefix cache between
requests). The invariants every caller must preserve:

  1. ``alloc`` hands out blocks at refcount 1; ``decref`` releases one
     reference and the block returns to the free list only at refcount 0
     (``free`` is the legacy alias for ``decref``). A block is *live* while
     its refcount is >= 1 and is never handed out again until it drops to 0.
  2. Decref of a non-live block raises (double-free guard): a table that
     releases twice would let two requests share a block silently.
  3. **Writers own their blocks exclusively**: no K/V write may target a
     block whose refcount is > 1. Shared blocks are read-only; a request
     about to write into a shared block must first *fork* it
     (:meth:`BlockTable.fork_shared`) — allocate a fresh block, enqueue a
     device pool copy on the transfer engine, and drop its reference to the
     shared original (copy-on-write). The device scatter itself never
     touches positions below a row's ``kv_offset``, so full shared prefix
     blocks are structurally write-free; only the partially-filled *tail*
     block of a prefix hit can ever need the fork.
  4. Shared reads are safe without copies: the gather path
     (``blocks.paged_kv_update``) reads whole blocks through each row's
     table and masks the garbage tail via ``kv_len``, so two tables holding
     the same block id read the same bytes. Device → host extraction is a
     read too: swapping out a shared block never violates invariant 3.
  5. The radix prefix cache holds exactly one reference per cached
     device-resident block; reclamation (the store's LRU walk) may
     therefore spill or destroy only blocks at refcount 1 — a cached block
     also referenced by a live request is pinned until that request
     completes. Host-resident cache nodes hold no device reference at all.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to back ``n_tokens`` cache rows."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_size)


class BlockAllocator:
    """Ref-counted free-list allocator over ``n_blocks`` fixed-size blocks.

    ``n_partitions`` > 1 splits the pool into equal per-data-shard slices;
    every id handed out is local to its partition (0..n_blocks/P - 1).
    Allocation is all-or-nothing and FIFO: blocks that drop to refcount 0 go
    to the tail of the free list and are reused oldest-first, which keeps
    recycling deterministic (tested) and spreads writes over the pool.
    """

    def __init__(self, n_blocks: int, block_size: int, n_partitions: int = 1):
        if n_blocks < 1 or block_size < 1 or n_partitions < 1:
            raise ValueError("n_blocks, block_size, n_partitions must be >= 1")
        if n_blocks % n_partitions:
            raise ValueError(f"n_blocks={n_blocks} not divisible by "
                             f"n_partitions={n_partitions}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_partitions = n_partitions
        self.blocks_per_partition = n_blocks // n_partitions
        self._free = [deque(range(self.blocks_per_partition))
                      for _ in range(n_partitions)]
        self._ref = [dict() for _ in range(n_partitions)]  # id -> refcount

    # -- queries -------------------------------------------------------------

    def free_blocks(self, partition: Optional[int] = None) -> int:
        if partition is None:
            return sum(len(f) for f in self._free)
        return len(self._free[partition])

    def used_blocks(self, partition: Optional[int] = None) -> int:
        if partition is None:
            return sum(len(r) for r in self._ref)
        return len(self._ref[partition])

    def all_free(self) -> bool:
        return self.used_blocks() == 0

    def ref_count(self, block: int, partition: int = 0) -> int:
        """Current refcount of a block (0 = free)."""
        return self._ref[partition].get(block, 0)

    # -- alloc / ref / free --------------------------------------------------

    def alloc(self, n: int, partition: int = 0) -> Optional[List[int]]:
        """Pop ``n`` blocks from the partition's free list, oldest-first,
        each at refcount 1.

        All-or-nothing: returns None (and changes nothing) when fewer than
        ``n`` blocks are free — the caller defers admission, evicts cached
        prefixes, or stalls the append until references drop.
        """
        free = self._free[partition]
        if n < 0:
            raise ValueError(f"alloc({n}): negative block count")
        if len(free) < n:
            return None
        ids = [free.popleft() for _ in range(n)]
        ref = self._ref[partition]
        for i in ids:
            ref[i] = 1
        return ids

    def incref(self, ids, partition: int = 0) -> None:
        """Add one reference per id (prefix sharing: a second request — or
        the radix cache — adopts an already-live block read-only)."""
        ref = self._ref[partition]
        for i in ids:
            if i not in ref:
                raise ValueError(f"incref of free block {i} "
                                 f"(partition {partition})")
            ref[i] += 1

    def decref(self, ids, partition: int = 0) -> List[int]:
        """Drop one reference per id; blocks reaching refcount 0 return to
        the tail of the partition's free list (and are reported back).

        Raises ValueError on non-live ids — a table that releases twice
        would let two requests share a physical block silently.
        """
        ref = self._ref[partition]
        freed = []
        for i in ids:
            if i not in ref:
                raise ValueError(f"double free of block {i} "
                                 f"(partition {partition})")
            ref[i] -= 1
            if ref[i] == 0:
                del ref[i]
                self._free[partition].append(i)
                freed.append(i)
        return freed

    # legacy alias (PR-3 API): free-on-completion is now a refcount drop
    free = decref

    def rollback(self, ids, partition: int = 0) -> None:
        """Inverse of :meth:`alloc`, for speculative-decoding rollback:
        return ``ids`` to the *head* of the partition's free list in their
        original allocation order, so the allocator ends up bit-identical to
        never having handed them out. ``decref`` cannot do this — it recycles
        through the free-list tail, which would permute every later
        allocation relative to the never-proposed schedule.

        Every id must be exclusively owned (refcount exactly 1): rolling
        back a block another holder still references (a shared prefix block,
        a cached block) would corrupt that holder's view, and rolling back a
        free block is a double-free. Raises ValueError without touching
        anything on violation (all-or-nothing, like ``alloc``)."""
        ref = self._ref[partition]
        ids = list(ids)
        for i in ids:
            if ref.get(i, 0) != 1:
                raise ValueError(
                    f"rollback of block {i} (partition {partition}) at "
                    f"refcount {ref.get(i, 0)}: only exclusively-owned "
                    f"blocks can be rolled back")
        for i in ids:
            del ref[i]
        self._free[partition].extendleft(reversed(ids))


class BlockTable:
    """Per-request view of the pool: ordered physical ids backing positions
    [0, n_tokens). Grows via :meth:`ensure` (alloc-on-append) and drops its
    references with :meth:`close` (on completion).

    With a prefix cache, the leading entries may be *shared* blocks seeded
    from a radix hit (:meth:`seed`); the caller must already hold a
    reference on them (``PrefixCache.acquire``), which :meth:`close`
    releases uniformly. Allocation pressure is routed through the tiered
    ``store`` (``BlockStore.reclaim`` — the single LRU walk across the
    device and host tiers); passing a bare ``cache`` (the pre-store API,
    kept for host-side tests) routes through that cache's own store.
    """

    def __init__(self, allocator: BlockAllocator, partition: int = 0,
                 cache=None, store=None):
        self.allocator = allocator
        self.partition = partition
        if store is None and cache is not None:
            store = cache.store  # legacy wiring: the cache carries its store
        self.store = store  # Optional[BlockStore] — reclamation on pressure
        self.blocks: List[int] = []
        self._closed = False

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def capacity_tokens(self) -> int:
        return len(self.blocks) * self.allocator.block_size

    def seed(self, shared_ids) -> None:
        """Prepend shared prefix blocks (a radix-cache hit). Must be called
        on an empty table, and the caller must hold one reference per id —
        :meth:`close` decrefs every entry uniformly."""
        if self.blocks or self._closed:
            raise RuntimeError("seed() on a non-empty or closed block table")
        self.blocks.extend(shared_ids)

    def _alloc(self, need: int) -> Optional[List[int]]:
        got = self.allocator.alloc(need, self.partition)
        if got is None and self.store is not None:
            # reclaim through the tiered store (spill/evict LRU unreferenced
            # cached prefixes across both tiers), then retry once
            self.store.reclaim(self.partition, need)
            got = self.allocator.alloc(need, self.partition)
        return got

    def ensure(self, n_tokens: int) -> bool:
        """Grow the table to cover ``n_tokens`` positions; False = pool
        exhausted (nothing allocated — retry after references drop).
        """
        if self._closed:
            raise RuntimeError("ensure() on a closed block table")
        need = blocks_for(n_tokens, self.allocator.block_size) - len(self.blocks)
        if need <= 0:
            return True
        got = self._alloc(need)
        if got is None:
            return False
        self.blocks.extend(got)
        return True

    def fork_shared(self, t0: int, t1: int) -> Optional[list]:
        """Copy-on-write: replace every *shared* block (refcount > 1)
        overlapping token positions [t0, t1) with a fresh private block.

        Returns the [(src, dst), ...] physical-id pairs the caller must
        device-copy (pool row dst := pool row src) **before** the write that
        motivated the fork, or None when the pool cannot back the fork right
        now (nothing changed — stall and retry). Two-phase: the replacement
        ids are allocated all-or-nothing first, so a failed fork never
        leaves an un-copied private block in the table.
        """
        if self._closed:
            raise RuntimeError("fork_shared() on a closed block table")
        bs = self.allocator.block_size
        idxs = [i for i in range(t0 // bs, blocks_for(t1, bs))
                if i < len(self.blocks)
                and self.allocator.ref_count(self.blocks[i],
                                             self.partition) > 1]
        if not idxs:
            return []
        got = self._alloc(len(idxs))
        if got is None:
            return None
        pairs = []
        for i, dst in zip(idxs, got):
            src = self.blocks[i]
            self.allocator.decref([src], self.partition)
            self.blocks[i] = dst
            pairs.append((src, dst))
        return pairs

    def truncate(self, n_tokens: int) -> List[int]:
        """Partial-row rollback: shrink the table to the blocks backing
        positions [0, n_tokens), un-allocating the tail blocks a rejected
        speculation grew it by. The dropped blocks must be exclusively owned
        — speculative writes only ever target the row's write range, which
        the engine proves private (``_assert_clean``) before the verify call
        — and they return to the free-list *head* in order
        (:meth:`BlockAllocator.rollback`), so allocator state is
        bit-identical to never having grown the table. Shared/seeded prefix
        blocks sit structurally below any speculation offset and are never
        touched; the retained tail block may hold stale positions >=
        ``n_tokens``, which every later read masks via kv_len and every
        later write overwrites. Returns the dropped ids."""
        if self._closed:
            raise RuntimeError("truncate() on a closed block table")
        keep = blocks_for(n_tokens, self.allocator.block_size)
        if keep >= len(self.blocks):
            return []
        drop = self.blocks[keep:]
        if self.store is not None:
            # chokepoint: the store asserts none of the ids is an in-flight
            # transfer destination before handing them back
            self.store.rollback(self.partition, drop)
        else:
            self.allocator.rollback(drop, self.partition)
        self.blocks = self.blocks[:keep]
        return drop

    def close(self) -> None:
        """Drop this table's reference on every block. Idempotent (a second
        close is a no-op, the allocator itself rejects genuine
        double-frees). Shared blocks survive under their other references
        (radix cache / other requests); private blocks return to the free
        list."""
        if self._closed:
            return
        self.allocator.decref(self.blocks, self.partition)
        self.blocks = []
        self._closed = True

    def as_row(self, max_blocks: int) -> np.ndarray:
        """(max_blocks,) int32 device view, unallocated tail = -1."""
        if len(self.blocks) > max_blocks:
            raise ValueError(f"table holds {len(self.blocks)} blocks > "
                             f"max_blocks={max_blocks}")
        row = np.full((max_blocks,), -1, np.int32)
        row[:len(self.blocks)] = self.blocks
        return row
