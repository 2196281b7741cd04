"""Continuous-batching serve engine over the pipelined serving program.

Port of ``repro/serve/engine.py`` with split admission over either cache
layout. The slot grid is (trial k, microbatch m, batch row b), and the
batcher routes each request's arch id to its own trial rows. Dense strips
(the default, and the only layout for the ssm family): every (k, m, b)
cell owns one cache row of trial k — K/V strips of ``max_seq`` tokens, or
the recurrent SSM and conv states. Paged (``eng.paged``): every cell owns
one block table into trial k's pool partition for its data shard.

Cell lifecycle (dense):

  FREE ──admit──► PREFILL ──last chunk──► DECODE ──budget hit──► FREE
   ▲   (the cell's cache row is zeroed         (one token per engine round │
   │    before the round's calls — KV rows     via the masked decode step)│
   │    beyond kv_len are never attended,                                 │
   │    but SSM states are recurrent and                                  │
   │    must restart from zero)                                           │
   └──────────────────────────────────────────────────────────────────────┘

Cell lifecycle (paged):

  FREE ──admit──► PREFILL ──last chunk──► DECODE ──budget hit──► FREE
   ▲   (admission defers until the request's   (one token per engine round │
   │    exact block commitment fits its        via the masked decode step;│
   │    partition; each prefill chunk grows    crossing a block boundary  │
   │    the block table; stale blocks are      allocs one block)          │
   │    masked by kv_len, never zeroed)                                   │
   └────────────── blocks returned to the allocator's free list ──────────┘

Each round: admit → one ``append`` call per chunk-length group (chunked
prefill; the final chunk's head output is the first generated token) → one
``decode`` call for every decoding cell. Tables are trimmed to the
power-of-two bucket covering the longest live table under the paged kernel,
so per-call attention work follows live length, not ``max_seq``.

Not ported yet (the constructor raises ``NotImplementedError``):
sliding-window serving, the radix prefix cache, overcommit retraction,
fused mixed-tick admission, gang speculation, and ``static_serve``. The
reference's own rejections come first (``ValueError``): a window, fused
admission or speculation for a recurrent family, the prefix cache,
overcommit or the paged kernel without a paged pool, and a paged pool for
the ssm family.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import pipeline as pl
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.layers import ModelOptions
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.tracer import resolve
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.paging import BlockAllocator, blocks_for
from repro_torch.serve.request import Completion, Request
from repro_torch.serve.store import BlockStore
from repro_torch.serve.transfer import TransferEngine


def _pctl(samples, q) -> float:
    return float(np.percentile(np.asarray(samples, np.float64), q))


# ServeStats' numeric fields, now typed metrics in a MetricRegistry (the
# attribute name IS the metric name, so exports need no mapping table)
_COUNTER_FIELDS = (
    "ticks", "calls", "prefill_calls", "mixed_calls", "prefill_slot_ticks",
    "tokens_generated", "prompt_tokens", "pool_stalls", "prefix_hits",
    "prefix_hit_tokens", "prefix_inserts", "prefix_evictions",
    "prefix_spills", "host_hit_tokens", "cow_forks", "retractions",
    "restored", "swap_out_blocks", "swap_in_blocks")
_GAUGE_FIELDS = ("wall_s", "peak_live")
_HIST_FIELDS = (
    "occupancy_samples", "decode_busy_samples", "mixed_fill_samples",
    "block_usage_samples", "ttft_samples", "tpot_samples")
_ROUTED = frozenset(_COUNTER_FIELDS + _GAUGE_FIELDS + _HIST_FIELDS)


class ServeStats:
    """Scheduling/throughput counters for one engine run.

    A facade over :class:`repro.obs.metrics.MetricRegistry`: counters and
    gauges keep their legacy attribute interface (``stats.calls += 1``,
    ``stats.wall_s = ...``) by routing reads/writes through the registry,
    and the former unbounded ``*_samples`` lists are bounded
    :class:`~repro.obs.metrics.Reservoir` histograms that still support
    ``append``/``len``/``max``/``np.mean``. ``summary()`` keeps its exact
    historical key set (plus additive p99s), so bench gates and tests see
    the same shape.

    Counter semantics (unchanged):

    * ``prefill_calls`` — append-mode pipeline calls (prefill waves);
      ``mixed_calls`` — fused mixed-tick calls (prefill + decode).
    * ``prefill_slot_ticks`` — (cell, round) pairs spent prefilling — the
      per-request prefill-tick total (calls group concurrent cells, so this
      is the measure a prefix-cache hit actually shrinks).
    * ``peak_live`` — max concurrently admitted requests (capacity used);
      ``pool_stalls`` — paged row-rounds deferred on an exhausted pool.
    * prefix cache: ``prefix_hits`` (admitted requests with a non-empty
      hit), ``prefix_hit_tokens``, ``prefix_inserts`` (blocks adopted),
      ``prefix_evictions`` (nodes destroyed — gone from BOTH tiers),
      ``prefix_spills`` (nodes spilled device → host, still matchable),
      ``host_hit_tokens`` (hit tokens served via host restores),
      ``cow_forks`` (shared tail blocks forked copy-on-write).
    * tiered store: ``retractions`` (running requests preempted under
      overcommit > 1), ``restored`` (retracted requests re-admitted),
      ``swap_out_blocks`` / ``swap_in_blocks`` (payloads device ↔ host).
    """

    def __init__(self, prefix_enabled: bool = False,
                 registry: Optional[MetricRegistry] = None):
        # bypass __setattr__ for the plain attributes (the registry most of
        # all — routing consults it)
        object.__setattr__(self, "registry",
                           registry if registry is not None
                           else MetricRegistry())
        object.__setattr__(self, "prefix_enabled", bool(prefix_enabled))
        object.__setattr__(self, "tokens_per_arch", {})
        for n in _COUNTER_FIELDS:
            self.registry.counter(n)
        self.registry.gauge("wall_s", 0.0)
        self.registry.gauge("peak_live", 0)
        for n in _HIST_FIELDS:
            self.registry.histogram(n)

    def __getattr__(self, name):
        # normal lookup failed: metric fields live in the registry
        try:
            reg = object.__getattribute__(self, "registry")
            return reg.value(name)
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        if name in _ROUTED:
            self.registry.set_value(name, value)  # TypeError on histograms
        else:
            object.__setattr__(self, name, value)

    @property
    def slot_occupancy(self) -> float:
        """Mean fraction of slot cells holding a live request, sampled once
        per engine round — the paper's utilization story applied to serving."""
        s = self.occupancy_samples
        return s.mean_value if s else 0.0

    @property
    def decode_occupancy(self) -> float:
        """Mean busy fraction of the decode step's rows."""
        s = self.decode_busy_samples
        return s.mean_value if s else 0.0

    @property
    def mixed_fill_ratio(self) -> float:
        """Mean fraction of the mixed wave's padded (cell, qmax) token grid
        carrying real tokens — how much of each fused call is useful work."""
        s = self.mixed_fill_samples
        return s.mean_value if s else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s > 0 else 0.0

    def record_completion(self, comp: Completion) -> None:
        self.ttft_samples.append(comp.ttft_ticks)
        if len(comp.tokens) > 1:
            self.tpot_samples.append(comp.tpot_ticks)
        self.tokens_per_arch[comp.arch] = (
            self.tokens_per_arch.get(comp.arch, 0) + len(comp.tokens))

    def snapshot(self) -> dict:
        """Every metric (counters/gauges as numbers, histograms summarized)
        for the metrics exporter; ``summary()`` stays the human/bench view."""
        out = self.registry.snapshot()
        if len(self.tokens_per_arch) > 1:
            for k in sorted(self.tokens_per_arch):
                out[f"tokens_arch{k}"] = self.tokens_per_arch[k]
        return out

    def summary(self) -> dict:
        out = {"ticks": self.ticks, "calls": self.calls,
               "prefill_calls": self.prefill_calls,
               "prefill_slot_ticks": self.prefill_slot_ticks,
               "tokens_generated": self.tokens_generated,
               "prompt_tokens": self.prompt_tokens,
               "peak_live": self.peak_live,
               "slot_occupancy": round(self.slot_occupancy, 4),
               "decode_occupancy": round(self.decode_occupancy, 4),
               "wall_s": round(self.wall_s, 4),
               "tokens_per_s": round(self.tokens_per_s, 2)}
        if self.mixed_calls:
            out["mixed_calls"] = self.mixed_calls
            out["mixed_fill_ratio"] = round(self.mixed_fill_ratio, 4)
        if self.ttft_samples:
            out["ttft_p50"] = round(_pctl(self.ttft_samples, 50), 2)
            out["ttft_p95"] = round(_pctl(self.ttft_samples, 95), 2)
            out["ttft_p99"] = round(_pctl(self.ttft_samples, 99), 2)
        if self.tpot_samples:
            out["tpot_p50"] = round(_pctl(self.tpot_samples, 50), 2)
            out["tpot_p95"] = round(_pctl(self.tpot_samples, 95), 2)
            out["tpot_p99"] = round(_pctl(self.tpot_samples, 99), 2)
        if len(self.tokens_per_arch) > 1:
            out["tokens_per_arch"] = {
                k: self.tokens_per_arch[k]
                for k in sorted(self.tokens_per_arch)}
        if self.block_usage_samples:
            out["peak_blocks_in_use"] = int(
                self.block_usage_samples.max_value)
            out["pool_stalls"] = self.pool_stalls
            out["retractions"] = self.retractions
            out["restored"] = self.restored
            out["swap_out_blocks"] = self.swap_out_blocks
            out["swap_in_blocks"] = self.swap_in_blocks
        if self.prefix_enabled:
            out["prefix_hits"] = self.prefix_hits
            out["prefix_hit_tokens"] = self.prefix_hit_tokens
            out["host_hit_tokens"] = self.host_hit_tokens
            out["prefix_inserts"] = self.prefix_inserts
            out["prefix_evictions"] = self.prefix_evictions
            out["prefix_spills"] = self.prefix_spills
            out["cow_forks"] = self.cow_forks
        return out


class ServeEngine:
    """Continuous-batching engine: per-arch request queues → (k, m, b) cells.

    ``eng.n_trials`` trial rows (one per co-served variant — ``params``
    carries each variant's weights on its leading K axis) ×
    ``eng.n_microbatches`` × global microbatch rows form the slot grid,
    ``eng.max_seq`` bounds each request, ``eng.prefill_chunks`` sets the
    admission chunk count and ``policy`` the per-arch admission order
    (fcfs / sjf / deadline); ``eng.paged`` picks the cache layout. The
    caches live on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``), where ``params`` must live too.
    """

    def __init__(self, cfg: ArchConfig, eng: pl.EngineConfig, params,
                 opts: Optional[ModelOptions] = None,
                 overcommit: float = 1.0, policy: str = "fcfs",
                 prefix_cache: bool = False, fused: bool = False,
                 spec_gamma: int = 0, tracer=None, device=None):
        if cfg.rope == "mrope" or cfg.frontend is not None:
            raise ValueError("continuous batching supports text-only archs")
        recurrent = cfg.family in ("ssm", "hybrid") or cfg.hybrid is not None
        if eng.window and recurrent:
            raise ValueError(
                "sliding-window continuous serving supports attention-only "
                "archs (SSM state is not positional; the hybrid shared cache "
                "is a window-sized ring the append step cannot address)")
        if fused and recurrent:
            raise ValueError(
                "fused mixed-tick admission is attention-family only "
                "(ragged waves pad rows to the wave max and a recurrent "
                "state would advance through the padded positions)")
        if spec_gamma > 0 and recurrent:
            raise ValueError(
                "gang speculation is attention-family only (rollback "
                "truncates KV positionally; recurrent state cannot be "
                "rewound to an earlier position)")
        opts = opts or ModelOptions()
        if opts.use_paged_kernel and not eng.paged:
            raise ValueError("use_paged_kernel attends through block tables; "
                             "enable eng.paged")
        if prefix_cache and not eng.paged:
            raise ValueError("the radix prefix cache shares paged KV blocks; "
                             "enable eng.paged to use prefix_cache")
        if overcommit > 1.0 and not eng.paged:
            raise ValueError("overcommit > 1.0 preempts paged block "
                             "commitments; dense strips cannot be retracted "
                             "— enable eng.paged")
        for flag, what in ((eng.window > 0, "sliding-window serving"),
                           (prefix_cache, "the radix prefix cache"),
                           (overcommit > 1.0, "overcommit retraction"),
                           (fused, "fused mixed-tick admission"),
                           (spec_gamma > 0, "gang speculation")):
            if flag:
                raise NotImplementedError(f"{what} is not ported yet")
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)
        # NULL_TRACER when off: emission sites guard with `if tr.enabled:`
        self.trace = resolve(tracer)
        self._round_modes: list = []
        self.eng = dataclasses.replace(eng, prefill_chunks=1)
        self.n_arches = self.eng.n_trials
        self.n_chunks = max(1, eng.prefill_chunks)
        self.params = params
        self.mb_global = self.eng.mb_global
        self.decode_step = pl.make_serve_step(cfg, self.opts, self.eng,
                                              "decode")
        self.append_step = pl.make_serve_step(cfg, self.opts, self.eng,
                                              "append")
        self.paged = bool(self.eng.paged)
        self.allocator = self.store = self.transfer = self.reset_fn = None
        if self.paged:
            # one pool partition per (trial, data shard): rows allocate only
            # from the partition their (k, shard) owns (tables carry local
            # ids); no slot reset — stale blocks are masked via kv_len
            n_parts = self.eng.data_size
            self.allocator = BlockAllocator(
                self.eng.n_blocks * self.n_arches, self.eng.block_size,
                n_partitions=self.n_arches * n_parts)
            self.max_blocks = blocks_for(self.eng.max_seq,
                                         self.eng.block_size)
            self.transfer = TransferEngine(
                self.n_arches, n_parts,
                kernels=pl.make_transfer_kernels(cfg, self.eng))
            self.transfer.bind(lambda: self.cache, self._set_cache)
            self.store = BlockStore(self.allocator, transfer=self.transfer)
            self.store.trace = self.trace
        else:
            self.reset_fn = pl.make_slot_reset(cfg, self.eng)
        self.cache = pl.serve_cache_struct(cfg, self.eng, device=self.device)
        self.batcher = Batcher(self.eng.n_microbatches, self.mb_global,
                               self.n_chunks, self.eng.max_seq,
                               n_trials=self.n_arches,
                               allocator=self.allocator,
                               rows_per_partition=self.eng.microbatch,
                               overcommit=overcommit, policy=policy,
                               store=self.store, transfer=self.transfer,
                               tracer=self.trace)
        self.tick = 0
        self._stalled_ticks = 0
        self.stats = ServeStats()
        self.completions: list = []

    def _set_cache(self, cache) -> None:
        self.cache = cache

    # -- public API ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.batcher.enqueue(req)

    def done(self) -> bool:
        return self.batcher.idle()

    def run(self, requests=None, max_ticks: int = 100_000) -> list:
        """Drive the engine until every submitted request completes."""
        for r in requests or []:
            self.submit(r)
        t0 = time.monotonic()
        while not self.done():
            if self.tick >= max_ticks:
                raise RuntimeError(f"engine did not drain in {max_ticks} "
                                   f"ticks ({self.batcher.occupied()} live)")
            self.step()
        self.stats.wall_s += time.monotonic() - t0
        return sorted(self.completions, key=lambda c: c.rid)

    # -- one scheduling round ------------------------------------------------

    def step(self) -> bool:
        """Admit → prefill waves → decode. Returns False when drained."""
        if self.done():
            return False
        self.tick += 1
        self.stats.ticks += 1
        tr = self.trace
        if tr.enabled:
            tr.begin_tick(self.tick)
            self._round_modes = []
        calls_before = self.stats.calls
        admitted = self.batcher.admit(self.tick)
        if admitted:
            if not self.paged:
                self._reset_rows(admitted)
            self.stats.prompt_tokens += sum(
                s.request.prompt_len for s in admitted)
            if tr.enabled:
                for s in admitted:
                    tr.req("admit", s.request.rid, k=s.k, m=s.m, b=s.b,
                           plen=s.request.prompt_len)
        occupied = self.batcher.occupied()
        self.stats.peak_live = max(self.stats.peak_live, occupied)
        self.stats.occupancy_samples.append(occupied / self.batcher.n_cells)
        if self.allocator is not None:
            self.stats.block_usage_samples.append(
                self.allocator.used_blocks())
        for qlen, slots in sorted(self.batcher.prefill_groups().items()):
            self._prefill_call(qlen, slots)
        dec = self.batcher.decode_slots()
        if dec:
            self._decode_call(dec)
        if self.transfer is not None and self.transfer.pending():
            self.transfer.flush()
        # a pool can still wedge; flag the deadlock instead of spinning
        if occupied and self.stats.calls == calls_before and not admitted:
            self._stalled_ticks += 1
            if self._stalled_ticks > 100:
                raise RuntimeError(
                    "engine stalled: block pool exhausted with every live "
                    "row waiting for a block (grow n_blocks)")
        else:
            self._stalled_ticks = 0
        if self.transfer is not None:
            self.stats.swap_out_blocks = self.transfer.swap_out_blocks
            self.stats.swap_in_blocks = self.transfer.swap_in_blocks
        if tr.enabled:
            rec = {"modes": self._round_modes, "occupied": occupied,
                   "occupancy": round(occupied / self.batcher.n_cells, 4),
                   "queues": [len(q) for q in self.batcher.queues]}
            if self.allocator is not None:
                rec["pool_blocks"] = self.allocator.used_blocks()
                rec["host_depth"] = [
                    self.store.host_used(p)
                    for p in range(self.store.n_partitions)]
                rec["inflight"] = self.transfer.take_round_peak()
            tr.round(**rec)
        return True

    # -- internals -----------------------------------------------------------

    def _grid(self, qlen: int):
        k, m, b = self.n_arches, self.eng.n_microbatches, self.mb_global
        return (np.zeros((k, m, b, qlen), np.int32),
                np.zeros((k, m, b), np.int32),
                np.zeros((k, m, b), bool))

    def _reset_rows(self, slots) -> None:
        """Zero the dense cache rows of the admitted cells, before this
        round's calls."""
        mask = np.zeros((self.n_arches, self.eng.n_microbatches,
                         self.mb_global), bool)
        for s in slots:
            mask[s.k, s.m, s.b] = True
        self.cache = self.reset_fn(self.cache, mask)

    def _block_tables(self, slots):
        """(K, M, mb_global, width) int32 local ids; rows not in the call
        stay -1. Under ``use_paged_kernel`` the width is trimmed to the
        power-of-two bucket covering the longest live table, so the kernel
        takes ``n_tbl`` at run time and per-call work follows live length
        (the gather path always pays ``max_blocks``)."""
        width = self.max_blocks
        if self.opts.use_paged_kernel:
            live = max((len(s.table.blocks) for s in slots), default=1)
            width = 1
            while width < max(live, 1):
                width *= 2
            width = min(width, self.max_blocks)
        bt = np.full((self.n_arches, self.eng.n_microbatches, self.mb_global,
                      width), -1, np.int32)
        for s in slots:
            bt[s.k, s.m, s.b] = s.table.as_row(width)
        return bt

    def _prepare(self, slots, extra) -> list:
        """Grow each slot's block table to cover its next ``extra``
        positions; rows the pool cannot back are stalled (kept out of this
        round's call, retried next round). Dense cells are always ready."""
        if not self.paged:
            return list(slots)
        ready = []
        for s in slots:
            if s.request is None:
                continue
            if s.table.ensure(s.pos + extra):
                ready.append(s)
            else:
                self.stats.pool_stalls += 1
        return ready

    def _assert_clean(self, slots, extra) -> None:
        """Compute-call precondition: no participating block is mid-transfer,
        and every block in a row's write range is exclusively owned."""
        bs = self.eng.block_size
        for s in slots:
            p = self.batcher.partition_of(s.k, s.b)
            assert not any(self.transfer.in_flight(p, b)
                           for b in s.table.blocks), \
                "pipeline call would read an in-flight block"
            for j in range(s.pos // bs, blocks_for(s.pos + extra, bs)):
                assert self.allocator.ref_count(s.table.blocks[j], p) == 1, \
                    "write range overlaps a shared (refcount > 1) block"

    def _batch(self, tokens, positions, active, slots) -> dict:
        dev = self.device
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "positions": torch.from_numpy(positions).to(dev),
                 "active": torch.from_numpy(active).to(dev)}
        if self.paged:
            batch["block_tables"] = torch.from_numpy(
                self._block_tables(slots)).to(dev)
        return batch

    def _prefill_call(self, qlen: int, slots) -> None:
        slots = self._prepare(slots, qlen)
        if self.transfer is not None:
            self.transfer.flush()
        if not slots:
            return
        if self.paged:
            self._assert_clean(slots, qlen)
        tokens, positions, active = self._grid(qlen)
        for s in slots:
            tokens[s.k, s.m, s.b] = s.chunks[0]
            positions[s.k, s.m, s.b] = s.pos
            active[s.k, s.m, s.b] = True
        self.cache, tok, _ = self.append_step(
            self.params, self.cache, self._batch(tokens, positions, active,
                                                 slots))
        tok = tok.cpu().numpy()
        self.stats.calls += 1
        self.stats.prefill_calls += 1
        self.stats.prefill_slot_ticks += len(slots)
        tr = self.trace
        if tr.enabled:
            self._round_modes.append(f"append:{qlen}")
        for s in slots:
            if tr.enabled:
                tr.req("prefill_chunk", s.request.rid, k=s.k, m=s.m, b=s.b,
                       qlen=qlen, pos=s.pos)
            s.chunks.pop(0)
            s.pos += qlen
            if not s.chunks:  # final chunk → first generated token
                s.generated.append(int(tok[s.k, s.m, s.b]))
                s.first_token_tick = self.tick
                self.stats.tokens_generated += 1
                if tr.enabled:
                    tr.req("first_token", s.request.rid)
                self._maybe_finish(s)

    def _decode_call(self, slots) -> int:
        """One decode-mode pipeline call for ``slots``; returns the number of
        rows that actually ran (pool stalls drop rows)."""
        slots = self._prepare(slots, 1)
        if self.transfer is not None:
            self.transfer.flush()
        if not slots:
            # a fully pool-stalled decode round is zero decode work
            self.stats.decode_busy_samples.append(0.0)
            return 0
        if self.paged:
            self._assert_clean(slots, 1)
        tokens, positions, active = self._grid(1)
        for s in slots:
            tokens[s.k, s.m, s.b, 0] = s.generated[-1]
            positions[s.k, s.m, s.b] = s.pos
            active[s.k, s.m, s.b] = True
        self.cache, tok, _ = self.decode_step(
            self.params, self.cache, self._batch(tokens, positions, active,
                                                 slots))
        tok = tok.cpu().numpy()
        self.stats.calls += 1
        if self.trace.enabled:
            self._round_modes.append("decode")
        self.stats.decode_busy_samples.append(
            len(slots) / self.batcher.n_cells)
        for s in slots:
            s.pos += 1
            s.generated.append(int(tok[s.k, s.m, s.b]))
            self.stats.tokens_generated += 1
            self._maybe_finish(s)
        return len(slots)

    def _maybe_finish(self, slot) -> None:
        if not slot.finished:
            return
        req = slot.request
        comp = Completion(
            rid=req.rid, prompt_len=req.prompt_len,
            tokens=list(slot.generated[:req.max_new_tokens]),
            arrival=req.arrival, admitted_tick=slot.admitted_tick,
            finished_tick=self.tick, arch=req.arch,
            first_token_tick=slot.first_token_tick)
        self.completions.append(comp)
        self.stats.record_completion(comp)
        if self.trace.enabled:
            self.trace.req("complete", req.rid, tokens=len(comp.tokens),
                           ttft=comp.ttft_ticks)
        slot.release()  # the cell is reusable the same round it finishes
