"""Radix prefix cache: cross-request KV sharing over the paged block pool.

Real model-selection serving traffic is massively prefix-redundant — system
prompts, few-shot scaffolds, and eval templates repeat across requests (and
across the arches of a co-serving gang). This module lets a new request skip
recomputing any prefix an earlier request already pushed through the model:
completed requests *insert* their prompt blocks into a radix tree instead of
freeing them, and admission *matches* each incoming prompt against the tree,
seeding the request's block table with the shared blocks so chunked prefill
starts at the hit boundary (TTFT drops with hit length).

Structure
---------
One radix tree per pool **partition** (= per (trial, data-shard), matching
``BlockAllocator`` partitioning — block ids are partition-local, so a cached
block is only addressable by rows admitted into the same partition). Each
edge/node covers exactly one **block-aligned chunk** of ``block_size`` token
ids and owns the K/V written for exactly the token path root → node; causal
attention makes that K/V valid for *any* request whose prompt starts with
the same path.

Two-tier residency (serve/store.py): a node's K/V lives either in a device
pool block (``node.block`` >= 0) or, after being spilled under pool
pressure, in a host block of the tiered store (``node.block`` == -1,
``node.host`` set). Matching walks the tree regardless of residency;
*acquiring* a hit restores host-resident nodes — allocate a fresh device
block, enqueue an async swap-in on the transfer engine (flushed before the
slot's first compute call), move the payload out of the host tier — so a
spilled prefix still saves the prefill work, at the cost of a copy instead
of a recompute.

Sharing rules (the refcount/CoW invariants of serve/paging.py):

* the tree holds **one reference** per cached device-resident block; a radix
  hit adds one reference per matched block for the admitted request (dropped
  when its table closes), so a block's refcount is 1 + (live requests
  reading it). Host-resident nodes hold no device reference;
* full-block hits are read-only forever — the device scatter never writes
  below a row's ``kv_offset``;
* a **partial tail hit** (the request's prompt diverges inside a cached
  block) reuses the matched positions of that block but must write the rest:
  the engine forks it copy-on-write (``BlockTable.fork_shared`` + a transfer
  -engine pool copy) before the first write, so no block with refcount > 1
  is ever mutated;
* **reclamation** (:meth:`make_room`, reached via ``BlockStore.reclaim``)
  walks LRU *evictable* nodes — device-resident, refcount 1 (tree-only),
  with no device-resident children — and **spills** them to the host tier
  (extract payload, free the device block); only when the host tier is
  full or disabled does it fall back to destroying the node, the old
  single-tier behavior. Blocks referenced by live requests are pinned
  until completion either way.

Host-side only: matching, refcounts, and reclamation are plain Python; the
device interactions (CoW copies, swap-out extraction, swap-in injection)
all flow through ``serve.transfer.TransferEngine``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve.paging import BlockAllocator
from repro_torch.serve.store import BlockStore


class RadixNode:
    """One cached block-aligned chunk: ``key`` is its token chunk, ``block``
    the partition-local device id holding its K/V (-1 while the chunk is
    spilled to the host tier, ``host`` then names the host block)."""

    __slots__ = ("key", "block", "host", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["RadixNode"], last_used: int = 0):
        self.key = key
        self.block = block
        self.host: Optional[int] = None
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.last_used = last_used


@dataclasses.dataclass
class PrefixHit:
    """Result of matching one prompt against one partition's radix tree.

    ``nodes`` is the chain of fully matched blocks (each ``block_size``
    tokens); ``tail``/``tail_tokens`` an optional partially matched block —
    its first ``tail_tokens`` positions carry valid K/V for this prompt and
    the engine must CoW-fork it before writing the rest. The hit is always
    capped below ``prompt_len`` so at least one prompt token remains to
    prefill (the head needs a final-position forward to emit token 0).

    Matched nodes may be host-resident (``block`` == -1); ``acquire``
    restores them and returns the *effective* hit whose ``block_ids`` are
    all device ids.
    """

    partition: int
    nodes: List[RadixNode]
    tail: Optional[RadixNode]
    tail_tokens: int
    block_size: int

    @property
    def hit_tokens(self) -> int:
        return len(self.nodes) * self.block_size + self.tail_tokens

    @property
    def n_full_blocks(self) -> int:
        return len(self.nodes)

    def _chain(self) -> List[RadixNode]:
        return self.nodes + ([self.tail] if self.tail is not None else [])

    @property
    def block_ids(self) -> List[int]:
        return [n.block for n in self._chain()]

    @property
    def device_ids(self) -> List[int]:
        """Device-resident matched ids (valid pre-acquire)."""
        return [n.block for n in self._chain() if n.block >= 0]

    @property
    def n_host_blocks(self) -> int:
        """Host-resident matched nodes — each restore will claim one fresh
        device block (admission charges them like new allocations)."""
        return sum(1 for n in self._chain() if n.block < 0)


class PrefixCache:
    """Per-partition radix trees over the tiered block store, with LRU
    spill-then-destroy reclamation of unreferenced nodes. See the module
    docstring for the sharing/residency rules; counters (hits, evictions,
    host_hit_tokens, ...) feed ``ServeStats``.

    Constructed over a :class:`~repro_torch.serve.store.BlockStore` (a bare
    ``BlockAllocator`` is auto-wrapped in a host-tier-less store — the
    pre-tier API, identical destroy-on-evict semantics).
    """

    def __init__(self, store):
        if isinstance(store, BlockAllocator):
            store = BlockStore(store)
        self.store = store
        self.allocator = store.allocator
        store.cache = self  # the store's reclaim chokepoint walks this tree
        self._roots = [RadixNode((), -1, None)
                       for _ in range(self.allocator.n_partitions)]
        self._clock = 0  # deterministic LRU time (bumped per touch/insert)
        self.lookups = 0
        self.hits = 0  # matches with hit_tokens > 0 that were acquired
        self.hit_tokens = 0
        self.inserts = 0  # blocks adopted into the tree
        self.evictions = 0  # nodes destroyed (evicted from BOTH tiers)
        self.spills = 0  # nodes spilled device -> host (still matchable)
        self.host_hits = 0  # host-resident nodes restored by acquire()
        self.host_hit_tokens = 0  # hit tokens served via host restores
        self.trace = NULL_TRACER  # engine swaps in its tracer when tracing

    # -- queries -------------------------------------------------------------

    def _walk(self, partition: int):
        stack = [self._roots[partition]]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.parent is not None:
                yield node

    def cached_blocks(self, partition: Optional[int] = None) -> int:
        """Device-resident blocks currently held by the tree (1 per
        device-resident node; spilled nodes hold host blocks instead)."""
        parts = (range(self.allocator.n_partitions) if partition is None
                 else [partition])
        return sum(1 for p in parts for n in self._walk(p) if n.block >= 0)

    def host_cached_blocks(self, partition: Optional[int] = None) -> int:
        """Host-resident (spilled) nodes still matchable in the tree."""
        parts = (range(self.allocator.n_partitions) if partition is None
                 else [partition])
        return sum(1 for p in parts for n in self._walk(p) if n.block < 0)

    # -- match / acquire -----------------------------------------------------

    def match(self, partition: int, prompt) -> PrefixHit:
        """Longest cached prefix of ``prompt`` in this partition's tree:
        a chain of full block-aligned chunks plus at most one partially
        matched tail block. Read-only (no refcounts change, no LRU touch) —
        admission may probe several partitions before committing to one via
        :meth:`acquire`. Host-resident nodes match like device ones."""
        bs = self.allocator.block_size
        plen = int(prompt.shape[0])
        self.lookups += 1
        node = self._roots[partition]
        nodes: List[RadixNode] = []
        i = 0
        while (i + 1) * bs <= plen:
            child = node.children.get(tuple(int(t) for t in
                                            prompt[i * bs:(i + 1) * bs]))
            if child is None:
                break
            nodes.append(child)
            node = child
            i += 1
        # leave at least one prompt token to prefill (head output = token 0)
        while nodes and len(nodes) * bs >= plen:
            nodes.pop()
        node = nodes[-1] if nodes else self._roots[partition]
        base = len(nodes) * bs
        rest = prompt[base:]
        # partial tail: longest common prefix with any child chunk, again
        # capped one short of the prompt end
        limit = min(int(rest.shape[0]) - 1, bs)
        tail, tail_tokens = None, 0
        for key, child in node.children.items():
            j = 0
            while j < limit and key[j] == int(rest[j]):
                j += 1
            if j > tail_tokens:
                tail, tail_tokens = child, j
        return PrefixHit(partition, nodes, tail, tail_tokens, bs)

    def acquire(self, hit: PrefixHit) -> PrefixHit:
        """Commit to a hit at admission: restore host-resident nodes to the
        device tier (fresh block + async swap-in, flushed before the slot's
        first compute call), add one reference per matched block (the
        request's table drops it on close), and refresh LRU stamps.

        Returns the *effective* hit — possibly truncated at the first node
        that could not be brought device-resident (restore allocation can
        fail under overcommit races, and a restore's own reclamation may
        destroy a deeper not-yet-referenced node of this very chain). The
        caller must seed/charge from the returned hit, not the matched one.
        Nodes are claimed in chain order, so reclamation can never evict an
        already-acquired link."""
        p = hit.partition
        self._clock += 1
        eff_nodes: List[RadixNode] = []
        truncated = False
        for node in hit.nodes:
            if not self._claim(p, node):
                truncated = True
                break
            eff_nodes.append(node)
        eff_tail, eff_tt = None, 0
        if not truncated and hit.tail is not None \
                and self._claim(p, hit.tail, tokens=hit.tail_tokens):
            eff_tail, eff_tt = hit.tail, hit.tail_tokens
        eff = PrefixHit(p, eff_nodes, eff_tail, eff_tt, hit.block_size)
        if eff.hit_tokens > 0:
            self.hits += 1
            self.hit_tokens += eff.hit_tokens
        return eff

    def _claim(self, partition: int, node: RadixNode,
               tokens: Optional[int] = None) -> bool:
        """Make one matched node device-resident and add the request's
        reference. False = the node is gone (destroyed since match) or the
        pool cannot back its restore right now."""
        if node.parent is None:  # destroyed by reclamation since match()
            return False
        if node.block < 0:
            if self.store.transfer is None:
                return False
            got = self.store.alloc(1, partition)  # may reclaim LRU others
            if got is None:
                return False
            payload = self.store.host_pop(partition, node.host)
            node.block, node.host = got[0], None
            self.store.transfer.swap_in(partition, node.block, payload)
            self.host_hits += 1
            self.host_hit_tokens += (self.allocator.block_size
                                     if tokens is None else tokens)
        self.allocator.incref([node.block], partition)
        node.last_used = self._clock
        return True

    # -- insert --------------------------------------------------------------

    def insert(self, partition: int, prompt, blocks: List[int]) -> int:
        """Adopt a completed request's *full* prompt blocks into the tree
        (called before its table closes, so every id in ``blocks`` is still
        live). Chunks already cached keep their existing node — the
        request's duplicate block simply drops with its table — except
        *host-resident* nodes, which are promoted back to the device tier by
        adopting the request's block (and freeing the stale host copy): the
        request just rewrote exactly this K/V on device, so the promotion
        saves a future swap-in for free. Returns the number of newly
        adopted blocks."""
        bs = self.allocator.block_size
        node = self._roots[partition]
        adopted = 0
        self._clock += 1
        for i in range(int(prompt.shape[0]) // bs):
            if i >= len(blocks):
                break
            key = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, blocks[i], node, self._clock)
                node.children[key] = child
                self.allocator.incref([blocks[i]], partition)
                adopted += 1
            elif child.block < 0:
                self.store.host_pop(partition, child.host)  # drop stale copy
                child.block, child.host = blocks[i], None
                self.allocator.incref([blocks[i]], partition)
            child.last_used = self._clock
            node = child
        self.inserts += adopted
        return adopted

    # -- reclamation ---------------------------------------------------------

    def _evictable_leaves(self, partition: int) -> List[RadixNode]:
        """Device-resident nodes safe to spill/destroy: tree-only reference
        (refcount 1) and no device-resident children — a node whose children
        all live on the host may itself leave the device tier (its K/V is
        not an attention dependency of theirs; the path stays matchable)."""
        return [n for n in self._walk(partition)
                if n.block >= 0
                and all(c.block < 0 for c in n.children.values())
                and self.allocator.ref_count(n.block, partition) == 1]

    def make_room(self, partition: int, need: int) -> int:
        """Reclaim LRU unreferenced nodes until ``need`` device blocks are
        free in the partition (or nothing evictable remains): **spill** each
        victim to the host tier when it has room (the node stays matchable;
        an acquire swaps it back in), **destroy** it otherwise — the
        pre-tier behavior, now the last resort. Reclaiming a node may
        expose its parent as the next victim — cascades are rediscovered
        per round, which keeps the walk simple (trees are pool-bounded
        small). Called through ``BlockStore.reclaim`` (the single
        reclamation chokepoint). Returns the device blocks reclaimed."""
        reclaimed = 0
        while self.allocator.free_blocks(partition) < need:
            leaves = self._evictable_leaves(partition)
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            if not self._spill(partition, victim):
                self._drop(partition, victim)
            reclaimed += 1
        return reclaimed

    def _spill(self, partition: int, node: RadixNode) -> bool:
        """Move one unreferenced device-resident node to the host tier."""
        st = self.store
        if not st.spill or st.transfer is None \
                or not st.host_can_put(partition):
            return False
        payload = st.transfer.swap_out(partition, [node.block])[0]
        hid = st.host_put(partition, payload, owner=node)
        if hid is None:
            return False
        self.allocator.decref([node.block], partition)
        node.block, node.host = -1, hid
        self.spills += 1
        if self.trace.enabled:
            self.trace.emit("prefix_spill", partition=partition)
        return True

    def _drop(self, partition: int, node: RadixNode) -> None:
        """Destroy a device-resident node outright (no host room)."""
        del node.parent.children[node.key]
        node.parent = None
        self.allocator.decref([node.block], partition)
        self.evictions += 1
        if self.trace.enabled:
            self.trace.emit("prefix_evict", partition=partition, tier="device")

    def drop_host_node(self, partition: int, node: RadixNode) -> None:
        """Destroy a host-resident node whose host block was LRU-evicted
        under host-tier pressure (called back by the store; the host block
        itself is already gone)."""
        del node.parent.children[node.key]
        node.parent = None
        node.host = None
        self.evictions += 1
        if self.trace.enabled:
            self.trace.emit("prefix_evict", partition=partition, tier="host")
