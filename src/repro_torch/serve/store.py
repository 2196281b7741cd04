"""Tiered block store: the device pool fronted by a host-memory tier.

``BlockAllocator`` (serve/paging.py) only knows the device free list, and
before this module every caller under memory pressure had its own idea of
what to reclaim — ``BlockTable.ensure`` asked the prefix cache for
partition-local room, retraction freed blocks outright, and evicted radix
blocks were destroyed. :class:`BlockStore` centralizes that ownership story:
device HBM is a *cache* over a larger host tier (Hydra's spilled
model-parallelism applied to serving), and every pressure-driven reclamation
flows through :meth:`reclaim`, so eviction ordering is LRU across *both*
tiers instead of per-call-site.

Tiers
-----
* **Device tier** — the ref-counted :class:`~repro_torch.serve.paging.BlockAllocator`
  pool partitions. Blocks here are addressable by the SPMD kernels through
  block tables.
* **Host tier** — up to ``host_blocks`` spilled blocks *per partition*, each
  holding the raw K/V payload of one pool block (extracted by the
  :class:`~repro_torch.serve.transfer.TransferEngine`). Host blocks are reached
  only by swapping back into the device tier; they come in two kinds:

  - *cache spills* (``owner`` = a radix node): unreferenced prefix-cache
    leaves moved out of HBM by :meth:`reclaim`; evictable LRU when the host
    tier itself fills (the node is then destroyed — the old single-tier
    behavior, now the last resort instead of the first).
  - *retract payloads* (``pinned=True``): a preempted request's KV, owned by
    its pending restore — never evicted, freed when the restore swaps them
    back in.

The store itself is host-side bookkeeping; actual byte movement is the
transfer engine's job (``self.transfer``). With no transfer engine attached
(pure scheduling tests) the host tier still tracks capacity but payloads are
opaque ``None`` placeholders.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve.paging import BlockAllocator


@dataclasses.dataclass
class HostBlock:
    """One spilled block in the host tier."""

    payload: object  # raw K/V bytes (kernel-defined); None in host-only tests
    owner: object = None  # radix node for cache spills, None for retracts
    pinned: bool = False  # retract payloads: owned by a pending restore
    last_used: int = 0


class BlockStore:
    """Two-tier block lifecycle manager (device pool + host spill tier).

    ``host_blocks`` is the host-tier capacity per pool partition; 0 disables
    the host tier entirely (spills degrade to destruction, retraction falls
    back to recompute-based restore). ``spill`` gates whether cache eviction
    may use the host tier at all (``--no-spill``).

    Wiring: the engine attaches a :class:`TransferEngine` via ``transfer``;
    :class:`~repro_torch.serve.prefix_cache.PrefixCache` attaches itself as
    ``cache`` on construction (it owns the LRU structure that
    :meth:`reclaim` walks).
    """

    def __init__(self, allocator: BlockAllocator, host_blocks: int = 0,
                 spill: bool = True, transfer=None):
        if host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
        self.allocator = allocator
        self.host_capacity = host_blocks
        self.spill = bool(spill) and host_blocks > 0
        self.transfer = transfer
        self.cache = None  # PrefixCache attaches itself (reclaim LRU walk)
        self._host = [dict() for _ in range(allocator.n_partitions)]
        self._next_hid = [0] * allocator.n_partitions
        self._clock = 0
        self.host_evictions = 0  # host blocks destroyed under host pressure
        self.rollbacks = 0  # device blocks un-allocated by spec rollback
        self.trace = NULL_TRACER  # engine swaps in its tracer when tracing

    # -- queries -------------------------------------------------------------

    @property
    def n_partitions(self) -> int:
        return self.allocator.n_partitions

    def host_used(self, partition: Optional[int] = None) -> int:
        if partition is None:
            return sum(len(h) for h in self._host)
        return len(self._host[partition])

    def host_free(self, partition: int) -> int:
        return self.host_capacity - len(self._host[partition])

    # -- device tier ---------------------------------------------------------

    def alloc(self, n: int, partition: int = 0):
        """Device alloc with cross-tier reclamation on pressure: when the
        free list cannot back ``n`` blocks, spill (or destroy) LRU
        unreferenced cached blocks via :meth:`reclaim` and retry once.
        Returns the ids or None (nothing changed) — same contract as
        ``BlockAllocator.alloc``."""
        got = self.allocator.alloc(n, partition)
        if got is None:
            self.reclaim(partition, n)
            got = self.allocator.alloc(n, partition)
        return got

    def rollback(self, partition: int, ids) -> None:
        """Speculation rollback chokepoint (``BlockTable.truncate``): assert
        none of the blocks is an in-flight transfer destination — an
        in-flight block's bytes are not addressable, so it cannot have been
        written by the verify call being rolled back, and un-allocating it
        would hand the pending transfer's destination to a new owner — then
        return them to the device free-list head via
        :meth:`BlockAllocator.rollback` (bit-identical pool state)."""
        ids = list(ids)
        if self.transfer is not None:
            for i in ids:
                if self.transfer.in_flight(partition, i):
                    raise RuntimeError(
                        f"rollback of in-flight block {i} (partition "
                        f"{partition}): pending transfer destinations "
                        f"cannot be un-allocated")
        self.allocator.rollback(ids, partition)
        self.rollbacks += len(ids)

    def reclaim(self, partition: int, need: int) -> int:
        """The single chokepoint for pressure-driven reclamation: delegate
        to the prefix cache's LRU walk (spill-first when the host tier has
        room, destroy as last resort). Returns blocks reclaimed."""
        if self.cache is None:
            return 0
        return self.cache.make_room(partition, need)

    # -- host tier -----------------------------------------------------------

    def host_can_put(self, partition: int) -> bool:
        """Whether one more host block fits (possibly by evicting an
        unpinned cache spill) — checked before paying for an extraction."""
        if self.host_capacity <= 0:
            return False
        if len(self._host[partition]) < self.host_capacity:
            return True
        return self._host_victim(partition) is not None

    def host_put(self, partition: int, payload, owner=None,
                 pinned: bool = False) -> Optional[int]:
        """Adopt one block's payload into the host tier; evicts LRU unpinned
        cache spills to make room (their radix nodes are destroyed — the
        host tier is itself a cache). Returns the host id, or None when the
        tier is full of pinned/unevictable blocks (caller falls back to the
        destroy / recompute path)."""
        if self.host_capacity <= 0:
            return None
        while len(self._host[partition]) >= self.host_capacity:
            hid = self._host_victim(partition)
            if hid is None:
                return None
            self._evict_host(partition, hid)
        self._clock += 1
        hid = self._next_hid[partition]
        self._next_hid[partition] += 1
        self._host[partition][hid] = HostBlock(payload, owner, pinned,
                                               self._clock)
        return hid

    def host_get(self, partition: int, hid: int) -> HostBlock:
        return self._host[partition][hid]

    def host_pop(self, partition: int, hid: int):
        """Remove a host block (a restore is consuming it) and return its
        payload."""
        return self._host[partition].pop(hid).payload

    def touch(self, partition: int, hid: int) -> None:
        self._clock += 1
        self._host[partition][hid].last_used = self._clock

    def _host_victim(self, partition: int) -> Optional[int]:
        """LRU unpinned host block whose owner node (if any) can be dropped
        from the radix tree without orphaning children."""
        best, best_t = None, None
        for hid, hb in self._host[partition].items():
            if hb.pinned:
                continue
            if hb.owner is not None and hb.owner.children:
                continue  # interior node: dropping it would orphan the path
            if best_t is None or hb.last_used < best_t:
                best, best_t = hid, hb.last_used
        return best

    def _evict_host(self, partition: int, hid: int) -> None:
        hb = self._host[partition].pop(hid)
        self.host_evictions += 1
        if self.trace.enabled:
            self.trace.emit("host_evict", partition=partition)
        if hb.owner is not None and self.cache is not None:
            self.cache.drop_host_node(partition, hb.owner)
