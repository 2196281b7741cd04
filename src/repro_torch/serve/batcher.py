"""Admission scheduling: map per-arch request queues onto the (k, m, b) grid.

The pipelined serve step has a fixed slot grid — ``n_trials`` trial rows ×
``n_microbatches`` microbatch slots × ``mb_global`` batch rows — and every
(k, m, b) cell owns one KV/SSM-cache row of trial k. Trial row k holds the
weights of model variant k (the co-serving analogue of the paper's gang: K
model variants sharded onto one device gang), so a request addressed to
``arch`` a may only ever occupy cells with k == a.

The :class:`Batcher` keeps one queue per arch, admits each queue into its own
trial rows under the configured ``policy`` (FCFS / shortest-prompt-first /
deadline-aware — ordering is always *within* an arch; arches never compete
for each other's cells), and plans chunked prefill *waves*: each admitted
prompt is split into ``prefill_chunks`` near-equal chunks, and each wave
groups cells by next-chunk length so every pipeline call keeps a static token
shape (cells in the same call may sit at different cache depths — the append
step takes per-row kv offsets).

Paged backpressure is per (trial, data-shard) pool partition: an arch whose
head request cannot commit its blocks defers *only that arch's* admission —
other arches keep admitting into their own partitions, so one overloaded
variant can never starve the rest of the gang (the cross-arch guard the
engine's stall detector backstops).

With a radix ``prefix_cache`` (paged only), admission additionally matches
each head request's prompt against every candidate partition's tree and
commits only the *non-cached* block need: the slot is seeded with the shared
prefix blocks, ``Slot.pos`` starts at the hit boundary, and the committed
total counts each referenced cached block once across the partition's live
slots (shared residency is charged exactly once; unreferenced cached blocks
are evictable and never charged). Host-resident (spilled) matched nodes are
charged one fresh block each — their restore allocates from the pool.

Gang speculation (``spec_pairs``): target trial row k is paired with drafter
row ``spec_pairs[k]``. Admitting a request to a target cell (k, m, b) also
claims the *mirror* drafter cell (spec_pairs[k], m, b) — same request, own
block table in the drafter row's partition — so a request is only admitted
when BOTH its target commitment and its drafter commitment fit
(:meth:`_attach_draft`). Drafter cells never admit requests of their own
(their rows are reserved), never prefill (their cache is built by catch-up
appends from the committed stream), and are excluded from
:meth:`decode_slots` (the engine drives them through its draft calls). The
pair lives and dies atomically: completion and retraction release both cells.

Retraction (overcommit > 1): the engine may :meth:`Batcher.requeue` a
running request it preempted under pool exhaustion, together with a
:class:`ResumeState` continuation. The request re-enters the *head* of its
arch's queue (it was admitted once — oldest priority, and victim selection
is youngest-first, so a restored request is not immediately re-victimized)
and admission places it down one of two bit-identical paths: swap-restore
(``host_ids`` set — fresh device blocks + async swap-in of the extracted
payloads, straight back to decode) or recompute-restore (replay
prompt ++ generated tokens as a teacher-forced prefill).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.obs.tracer import resolve
from repro_torch.serve.paging import BlockAllocator, BlockTable, blocks_for
from repro_torch.serve.request import Request

POLICIES = ("fcfs", "sjf", "deadline")


@dataclasses.dataclass
class Slot:
    """One (trial k, microbatch m, batch-row b) cell of the serve grid."""

    k: int
    m: int
    b: int
    request: Optional[Request] = None
    pos: int = 0  # tokens currently written to this cell's cache row
    chunks: list = dataclasses.field(default_factory=list)  # pending prompt
    generated: list = dataclasses.field(default_factory=list)
    admitted_tick: int = -1
    first_token_tick: int = -1  # tick the head emitted this request's first token
    table: Optional[BlockTable] = None  # paged: this request's block table
    block_commit: int = 0  # paged: exact NEW blocks this request will peak at
    cached_ids: set = dataclasses.field(default_factory=set)  # prefix-hit
    # blocks this slot references (shared; charged once per partition)
    hit_tokens: int = 0  # prefix-cache hit length (prefill starts here)
    resumed: bool = False  # restored from a retraction (stats count once)
    resume_tokens: Optional[list] = None  # recompute-restore: the tokens
    # generated before retraction; the teacher-forced replay re-derives them
    # (asserted bit-identical) instead of re-sampling
    is_draft: bool = False  # gang speculation: this cell drafts for ``peer``
    peer: Optional["Slot"] = None  # paired drafter/target mirror cell

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return self.request is not None and bool(self.chunks)

    @property
    def decoding(self) -> bool:
        return self.request is not None and not self.chunks

    @property
    def finished(self) -> bool:
        return (self.request is not None and not self.chunks
                and len(self.generated) >= self.request.max_new_tokens)

    def release(self) -> None:
        self.request = None
        self.pos = 0
        self.chunks = []
        self.generated = []
        self.admitted_tick = -1
        self.first_token_tick = -1
        if self.table is not None:  # drop references on completion
            self.table.close()
            self.table = None
        self.block_commit = 0
        self.cached_ids = set()
        self.hit_tokens = 0
        self.resumed = False
        self.resume_tokens = None
        self.is_draft = False
        self.peer = None


@dataclasses.dataclass
class ResumeState:
    """Continuation of a retracted (preempted) request, held while it waits
    in the queue for re-admission. ``host_ids`` set = swap-restore (the
    victim's table payloads sit pinned in the host tier of ``partition``);
    None = recompute-restore (replay prompt ++ generated[:-1] as a
    teacher-forced prefill — the replay's final head output must re-derive
    ``generated[-1]``)."""

    generated: list  # tokens emitted before retraction (>= 1)
    pos: int  # cache depth at retraction (prompt_len + len(generated) - 1)
    admitted_tick: int  # original admission (victim ordering + queue stats)
    first_token_tick: int  # original TTFT tick (latency stats stay honest)
    partition: int = -1  # host-tier partition holding the swapped payloads
    host_ids: Optional[list] = None  # pinned host blocks, table order


class Batcher:
    """Per-arch admission of queued requests into the arch's trial rows.

    ``n_trials`` is the gang width K: request ``arch`` a is only ever placed
    in cells (a, m, b). ``policy`` orders admission *within* an arch's queue
    among the requests that have arrived:

    * ``"fcfs"``   — arrival order (the default);
    * ``"sjf"``    — shortest prompt first (minimizes mean TTFT under load);
    * ``"deadline"`` — earliest ``Request.deadline`` first (None sorts last).

    With a :class:`BlockAllocator` (paged serving), the pool is split into one
    partition per (trial, data-shard) pair — partition k * n_shards + shard —
    so each trial row's cache writes land in its own pool slice and admission
    additionally commits each request's exact block footprint (generation
    always runs to its budget, so ``blocks_for(total_len)`` is known at
    admission) against its partition, deferring — per-arch backpressure —
    when the committed total would exceed ``blocks_per_partition ×
    overcommit``. At the default overcommit of 1.0 the schedule is
    preemption-free: every later alloc-on-append is covered by its
    commitment and can never stall. ``rows_per_partition`` maps batch row b
    to data shard b // rows_per_partition.
    """

    def __init__(self, n_microbatches: int, mb_global: int,
                 prefill_chunks: int, max_seq: int,
                 n_trials: int = 1,
                 allocator: Optional[BlockAllocator] = None,
                 rows_per_partition: int = 0, overcommit: float = 1.0,
                 policy: str = "fcfs", prefix_cache=None, store=None,
                 transfer=None, spec_pairs=None, tracer=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r} "
                             f"(choose from {POLICIES})")
        if prefix_cache is not None and allocator is None:
            raise ValueError("prefix_cache requires a paged BlockAllocator")
        self.n_trials = n_trials
        self.spec_pairs = dict(spec_pairs or {})  # target row -> drafter row
        self.draft_rows = set(self.spec_pairs.values())
        self.prefix_cache = prefix_cache
        # the tiered store routes allocation-pressure reclamation; a cache
        # always carries one (legacy wiring), otherwise it may be passed
        self.store = store if store is not None else (
            prefix_cache.store if prefix_cache is not None else None)
        self.transfer = transfer  # TransferEngine (swap-restore admission)
        self.trace = resolve(tracer)
        self.resume: dict = {}  # rid -> ResumeState for retracted requests
        self.restored = 0  # retracted requests brought back into a slot
        self.n_microbatches = n_microbatches
        self.mb_global = mb_global
        self.prefill_chunks = max(1, prefill_chunks)
        self.max_seq = max_seq
        self.allocator = allocator
        self.rows_per_partition = rows_per_partition
        self.overcommit = overcommit
        self.policy = policy
        self.slots = [Slot(k, m, b) for k in range(n_trials)
                      for m in range(n_microbatches)
                      for b in range(mb_global)]
        self.queues: list[list] = [[] for _ in range(n_trials)]

    @property
    def n_shards(self) -> int:
        """Data-shard partitions per trial (1 when unsharded/unpaged)."""
        if self.allocator is None:
            return 1
        return self.allocator.n_partitions // self.n_trials

    def partition_of(self, k: int, b: int) -> int:
        if self.allocator is None:
            return 0
        shard = 0
        if self.rows_per_partition > 0:
            shard = min(b // self.rows_per_partition, self.n_shards - 1)
        return k * self.n_shards + shard

    def committed_blocks(self, partition: int) -> int:
        """Blocks promised to live requests in one pool partition: each
        slot's exact new-block commitment, plus every *referenced* cached
        block counted once — shared prefix blocks are pinned (unevictable)
        while a live slot reads them, so they charge the partition exactly
        once no matter how many slots share them."""
        total, referenced = 0, set()
        for s in self.slots:
            if s.free or self.partition_of(s.k, s.b) != partition:
                continue
            total += s.block_commit
            referenced |= s.cached_ids
        return total + len(referenced)

    def _referenced_cached(self, partition: int) -> set:
        out = set()
        for s in self.slots:
            if not s.free and self.partition_of(s.k, s.b) == partition:
                out |= s.cached_ids
        return out

    # -- queue ---------------------------------------------------------------

    def cell(self, k: int, m: int, b: int) -> Slot:
        """The Slot at grid coordinate (k, m, b)."""
        return self.slots[(k * self.n_microbatches + m) * self.mb_global + b]

    def enqueue(self, req: Request) -> None:
        if req.arch >= self.n_trials:
            raise ValueError(
                f"request {req.rid}: arch={req.arch} but this gang co-serves "
                f"{self.n_trials} variant(s) (trial rows 0..{self.n_trials - 1})")
        if req.arch in self.draft_rows:
            raise ValueError(
                f"request {req.rid}: arch={req.arch} is a drafter row "
                f"(reserved for gang speculation); address a target row")
        if req.total_len > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt_len + max_new_tokens - 1 = "
                f"{req.total_len} exceeds the engine cache length "
                f"{self.max_seq}")
        if self.allocator is not None:
            need = blocks_for(req.total_len, self.allocator.block_size)
            # a request can never be admitted past the physical partition
            # size OR past the admission limit (overcommit < 1 lowers it)
            ceiling = min(self.allocator.blocks_per_partition,
                          int(self.allocator.blocks_per_partition
                              * self.overcommit))
            if need > ceiling:
                raise ValueError(
                    f"request {req.rid}: needs {need} blocks but admission "
                    f"is capped at {ceiling} per pool partition "
                    f"(blocks_per_partition="
                    f"{self.allocator.blocks_per_partition}, overcommit="
                    f"{self.overcommit}) — it could never be admitted")
        if self.trace.enabled:
            self.trace.req("enqueue", req.rid, arch=req.arch,
                           plen=req.prompt_len)
        self.queues[req.arch].append(req)

    def requeue(self, req: Request,
                state: Optional["ResumeState"] = None) -> None:
        """Put a retracted request back at the *head* of its arch's queue —
        it was admitted once, so it outranks everything still waiting — with
        its continuation (None = retracted mid-prefill, plain re-admission
        from scratch)."""
        self.queues[req.arch].insert(0, req)
        if state is not None:
            self.resume[req.rid] = state

    # -- admission -----------------------------------------------------------

    def split_chunks(self, prompt: np.ndarray, full_len: int = 0) -> list:
        """Near-equal prompt chunks (lengths differ by at most 1), so a trace
        with L distinct prompt lengths compiles at most 2L append shapes.

        ``full_len`` > len(prompt) marks a prefix-cache hit: ``prompt`` is
        the uncached suffix of a ``full_len``-token prompt, and the chunk
        count shrinks proportionally (the suffix is split at the chunk size
        the *full* prompt would have used) — a hit saves whole prefill
        waves, not just tokens per wave."""
        n = int(prompt.shape[0])
        if full_len > n:
            per_chunk = -(-full_len // self.prefill_chunks)
            nc = min(max(1, -(-n // per_chunk)), n)
        else:
            nc = min(self.prefill_chunks, n)
        return [c for c in np.array_split(prompt, nc) if c.size]

    def _head(self, k: int, now: float) -> Optional[Request]:
        """The next admissible request of arch k under the policy (among the
        requests that have arrived), without removing it from the queue."""
        arrived = [r for r in self.queues[k] if r.arrival <= now]
        if not arrived:
            return None
        if self.policy == "sjf":
            return min(arrived, key=lambda r: (r.prompt_len, r.arrival, r.rid))
        if self.policy == "deadline":
            inf = float("inf")
            return min(arrived, key=lambda r: (
                r.deadline if r.deadline is not None else inf,
                r.arrival, r.rid))
        return arrived[0]  # fcfs: queues preserve arrival order

    def admit(self, now: float) -> list:
        """Move queued requests (arrival <= now) into free cells of their own
        arch's trial rows, ordered per the admission policy within each arch.

        Paged: each arch's head request is placed in the free cell whose pool
        partition has the fewest committed blocks, and *that arch's*
        admission stops (defers — the queue keeps its order) as soon as the
        head's exact block commitment fits none of the arch's partitions.
        Other arches continue admitting into their own partitions, so pool
        exhaustion in one variant never starves the rest of the gang.

        With a prefix cache, each candidate partition is first matched
        against the head's prompt; cells are tried longest-hit-first (then
        fewest-committed) and the admitted slot commits only its non-cached
        block need, seeded with the shared prefix blocks at ``pos`` =
        hit length. Returns the newly admitted slots.
        """
        admitted = []
        for k in range(self.n_trials):
            if k in self.draft_rows:
                continue  # reserved: drafter cells fill via _attach_draft
            free = [s for s in self.slots if s.free and s.k == k]
            if k in self.spec_pairs:
                # pairing admission: a target cell is only usable when its
                # mirror drafter cell is free too (pairs release atomically,
                # so this is belt-and-braces)
                kd = self.spec_pairs[k]
                free = [s for s in free if self.cell(kd, s.m, s.b).free]
            while free:
                req = self._head(k, now)
                if req is None:
                    break
                state = self.resume.get(req.rid)
                if state is not None and state.host_ids is not None:
                    # swap-restore: fresh blocks + async swap-in, no prefill
                    slot = self._place_restore(req, state, free)
                    if slot is None:
                        break
                    free.remove(slot)
                    self.queues[k].remove(req)
                    del self.resume[req.rid]
                    self.restored += 1
                    self._attach_draft(slot)
                    admitted.append(slot)
                    continue
                # recompute-restore rides the normal placement with the
                # teacher-forced replay prompt (prefix hits may re-seed it)
                replay = None
                if state is not None:
                    replay = np.concatenate(
                        [req.prompt, np.asarray(state.generated[:-1],
                                                req.prompt.dtype)])
                if self.allocator is None:
                    slot = free.pop(0)
                else:
                    slot = self._place_paged(req, free, prompt=replay)
                    if slot is None:  # per-arch pool backpressure: defer
                        break
                    free.remove(slot)
                self.queues[k].remove(req)
                slot.request = req
                slot.pos = slot.hit_tokens
                src = req.prompt if replay is None else replay
                slot.chunks = self.split_chunks(src[slot.pos:],
                                                full_len=int(src.shape[0]))
                slot.generated = []
                slot.admitted_tick = int(now)
                if state is not None:
                    del self.resume[req.rid]
                    self.restored += 1
                    slot.resumed = True
                    slot.resume_tokens = list(state.generated)
                    slot.admitted_tick = state.admitted_tick
                    slot.first_token_tick = state.first_token_tick
                self._attach_draft(slot)
                admitted.append(slot)
        return admitted

    def _attach_draft(self, slot: Slot) -> None:
        """Claim the mirror drafter cell for a freshly placed target slot
        (gang speculation). The drafter shares the target's Request but owns
        its own block table in the drafter row's partition; it gets no
        prompt chunks — its cache is rebuilt by the engine's catch-up
        appends from the committed stream, starting at position 0 after any
        admission (including restores, where the target resumes mid-decode).
        Capacity for ``Request.draft_total_len`` was already checked by the
        placement path."""
        kd = self.spec_pairs.get(slot.k)
        if kd is None:
            return
        d = self.cell(kd, slot.m, slot.b)
        assert d.free, "drafter mirror cell occupied"
        req = slot.request
        d.request = req
        d.is_draft = True
        d.peer = slot
        slot.peer = d
        d.pos = 0
        d.chunks = []
        d.generated = []
        d.admitted_tick = slot.admitted_tick
        if self.allocator is not None:
            p = self.partition_of(kd, d.b)
            d.table = BlockTable(self.allocator, p, store=self.store)
            d.block_commit = blocks_for(req.draft_total_len,
                                        self.allocator.block_size)

    def _place_paged(self, req: Request, free: list,
                     prompt=None) -> Optional[Slot]:
        """Pick and prepare a paged slot for ``req``: match the prefix cache
        per candidate partition, charge the non-cached commitment, seed the
        table. ``prompt`` overrides the matched/prefilled token stream (the
        recompute-restore replay). None = no partition fits (defer)."""
        prompt = req.prompt if prompt is None else prompt
        bs = self.allocator.block_size
        total_need = blocks_for(req.total_len, bs)
        limit = int(self.allocator.blocks_per_partition * self.overcommit)
        # gang speculation: admission also reserves the mirror drafter
        # cell's commitment in the drafter row's partition
        kd = self.spec_pairs.get(req.arch)
        draft_need = (blocks_for(req.draft_total_len, bs)
                      if kd is not None else 0)
        # per-partition state once per placement (candidate slots map onto
        # only K*n_shards partitions — don't rescan the grid per candidate)
        tparts = {self.partition_of(c.k, c.b) for c in free}
        parts = set(tparts)
        if kd is not None:
            parts |= {self.partition_of(kd, c.b) for c in free}
        committed, hits, pinned = {}, {}, {}
        for p in parts:
            committed[p] = self.committed_blocks(p)
        for p in tparts:
            if self.prefix_cache is not None:
                hits[p] = self.prefix_cache.match(p, prompt)
                pinned[p] = self._referenced_cached(p)

        def hit_len(p):
            return hits[p].hit_tokens if p in hits else 0

        def fits(c):
            # commitment = new blocks + cached blocks this request would pin
            # that no live slot pins yet (pinned blocks charge once) + one
            # fresh block per host-resident matched node (its restore
            # allocates from the pool); committed_blocks() already balances
            # by *committed* blocks, not the allocator's free count —
            # commitments from requests admitted earlier this round have not
            # allocated yet but already claim their pool
            p = self.partition_of(c.k, c.b)
            commit = total_need
            fresh_refs = 0
            if p in hits:
                commit -= hits[p].n_full_blocks
                fresh_refs = (sum(1 for b in hits[p].device_ids
                                  if b not in pinned[p])
                              + hits[p].n_host_blocks)
            if committed[p] + commit + fresh_refs > limit:
                return False
            if kd is not None:  # the drafter commitment must fit too
                pd = self.partition_of(kd, c.b)
                if committed[pd] + draft_need > limit:
                    return False
            return True

        # longest hit first (prefix reuse beats perfect balance), then the
        # partition with the fewest committed blocks
        ordered = sorted(free, key=lambda s: (
            -hit_len(self.partition_of(s.k, s.b)),
            committed[self.partition_of(s.k, s.b)], s.m, s.b))
        slot = next((c for c in ordered if fits(c)), None)
        if slot is None:
            return None
        p = self.partition_of(slot.k, slot.b)
        slot.table = BlockTable(self.allocator, p, store=self.store)
        slot.block_commit = total_need
        slot.cached_ids = set()
        slot.hit_tokens = 0
        if p in hits and hits[p].hit_tokens > 0:
            # acquire restores host-resident matched nodes (async swap-in)
            # and returns the *effective* hit — possibly truncated when the
            # pool cannot back a restore under overcommit races
            hit = self.prefix_cache.acquire(hits[p])
            if hit.hit_tokens > 0:
                slot.table.seed(hit.block_ids)
                slot.block_commit = total_need - hit.n_full_blocks
                slot.cached_ids = set(hit.block_ids)
                slot.hit_tokens = hit.hit_tokens
        return slot

    def _place_restore(self, req: Request, state: ResumeState,
                       free: list) -> Optional[Slot]:
        """Swap-restore placement: allocate fresh device blocks for the
        retracted request's extracted payloads and enqueue their swap-in —
        the slot resumes *decoding* at its retracted position once the
        round's transfer flush lands the bytes (no prefill replay).
        None = no partition can back it yet (defer; the pinned host blocks
        wait)."""
        bs = self.allocator.block_size
        total_need = blocks_for(req.total_len, bs)
        limit = int(self.allocator.blocks_per_partition * self.overcommit)
        kd = self.spec_pairs.get(req.arch)
        draft_need = (blocks_for(req.draft_total_len, bs)
                      if kd is not None else 0)
        parts = {self.partition_of(c.k, c.b) for c in free}
        if kd is not None:
            parts |= {self.partition_of(kd, c.b) for c in free}
        committed = {p: self.committed_blocks(p) for p in parts}
        ordered = sorted(free, key=lambda s: (
            committed[self.partition_of(s.k, s.b)], s.m, s.b))
        n = len(state.host_ids)
        for cand in ordered:
            p = self.partition_of(cand.k, cand.b)
            if committed[p] + total_need > limit:
                continue
            if kd is not None and (committed[self.partition_of(kd, cand.b)]
                                   + draft_need > limit):
                continue
            table = BlockTable(self.allocator, p, store=self.store)
            if not table.ensure(n * bs):  # physical pressure: next partition
                continue
            for dst, hid in zip(table.blocks, state.host_ids):
                self.transfer.swap_in(
                    p, dst, self.store.host_pop(state.partition, hid))
            cand.table = table
            cand.request = req
            cand.pos = state.pos
            cand.chunks = []
            cand.generated = list(state.generated)
            cand.admitted_tick = state.admitted_tick
            cand.first_token_tick = state.first_token_tick
            cand.block_commit = total_need
            cand.cached_ids = set()
            cand.hit_tokens = 0
            cand.resumed = True
            return cand
        return None

    # -- wave planning -------------------------------------------------------

    def prefill_groups(self) -> dict:
        """{chunk_len: [slots]} for the cells whose next prompt chunk has
        that length — one static-shape append call per key (slots of every
        trial row ride in the same call; the step carries a k index per cell)."""
        groups: dict = {}
        for s in self.slots:
            if s.prefilling:
                groups.setdefault(int(s.chunks[0].shape[0]), []).append(s)
        return groups

    def decode_slots(self) -> list:
        """Decoding cells, drafters excluded — the engine drives drafter
        cells itself inside its speculative draft/verify rounds."""
        return [s for s in self.slots
                if s.decoding and not s.finished and not s.is_draft]

    def occupied(self) -> int:
        return sum(1 for s in self.slots if not s.free)

    @property
    def n_cells(self) -> int:
        return len(self.slots)

    def queued(self) -> int:
        return sum(len(q) for q in self.queues)

    def idle(self) -> bool:
        return self.queued() == 0 and all(s.free for s in self.slots)
