"""Continuous-batching serve engine over the pipelined serving program.

Port of ``repro/serve/engine.py`` over either cache layout. The slot grid is (trial k, microbatch m, batch row b), and the
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

Paged serve features, as in the reference:

* **Radix prefix cache** (``prefix_cache=True``): completed requests insert
  their prompt blocks into a radix tree (``serve/prefix_cache.py``);
  admission seeds a matching request's table from the tree and starts its
  chunked prefill at the hit length; a write into a shared, partly matched
  tail block first forks it copy-on-write through the transfer engine.
* **Host spill tier** (``host_blocks`` > 0): under pool pressure cached
  blocks spill to the :class:`BlockStore`'s host tier (``spill=False``
  destroys them instead) and a later hit swaps them back in.
* **Overcommit retraction** (``overcommit`` > 1): on pool exhaustion the
  youngest-admitted running request is preempted — its KV swapped to the
  host tier, or its tokens replayed teacher-forced — and requeued.
* **Fused mixed-tick admission** (``fused=True``): each round's prefill
  waves and decode step are one ``mixed`` call (per-row ragged ``qlens``).
* **Gang speculation** (``spec_gamma`` > 0): drafter trial rows propose
  ``spec_gamma`` tokens and each target row scores them in one ``verify``
  call, committing the longest matching prefix plus its own token.

Every block movement (CoW copies, swap-out, swap-in) is batched into one
transfer flush before the compute call that needs it, on the current
stream, so no call reads a block whose copy is pending. Greedy tokens stay
bit-identical to the plain split schedule with every feature on.

* **Sliding window** (``eng.window`` > 0, attention family only): every
  query sees only the trailing window; the strips and the pool keep their
  absolute ``max_seq`` layout and the steps mask the rest, so greedy
  tokens equal a windowed single-device oracle.

The constructor raises the reference's ``ValueError`` for a window, fused
admission or speculation on a recurrent family, the prefix cache,
overcommit or the paged kernel without a paged pool, a paged pool for the
ssm family, speculation together with fused admission, and bad drafter
pairings.

:func:`static_serve` is the lockstep baseline over the same slot grid:
one ``prefill`` call per group of uniform-length prompts, then decode
calls until the whole group drains.
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
from repro_torch.serve.batcher import Batcher, ResumeState
from repro_torch.serve.paging import BlockAllocator, blocks_for
from repro_torch.serve.prefix_cache import PrefixCache
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

    A facade over :class:`repro_torch.obs.metrics.MetricRegistry`: counters and
    gauges keep their legacy attribute interface (``stats.calls += 1``,
    ``stats.wall_s = ...``) by routing reads/writes through the registry,
    and the former unbounded ``*_samples`` lists are bounded
    :class:`~repro_torch.obs.metrics.Reservoir` histograms that still support
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


@dataclasses.dataclass
class SpecStats:
    """Gang-speculation counters: drafter proposals vs target verification.

    The headline metric is target-row ticks per output token — with
    speculation the target only runs prefill calls and verify calls
    (drafter rows absorb the autoregressive ticks), so
    ``(prefill_calls + verify_calls) / tokens_generated`` drops below the
    target-only engine's ``calls / tokens_generated`` whenever acceptance
    is non-trivial. Tokens are bit-identical by construction either way.
    """

    proposed: int = 0  # drafter tokens offered to verify calls
    accepted: int = 0  # proposals matching the target's own greedy argmax
    bonus: int = 0  # free target tokens (one per verified row: position
    # n_acc is the target's own argmax, correct even on full rejection)
    draft_calls: int = 0  # drafter-row pipeline calls (catch-up + propose)
    verify_calls: int = 0  # target verify calls (one per spec round)
    rollback_blocks: int = 0  # pool blocks freed by partial-row truncation

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def summary(self) -> dict:
        return {"spec_proposed": self.proposed,
                "spec_accepted": self.accepted,
                "spec_bonus_tokens": self.bonus,
                "spec_draft_calls": self.draft_calls,
                "spec_verify_calls": self.verify_calls,
                "spec_rollback_blocks": self.rollback_blocks,
                "acceptance_rate": round(self.acceptance_rate, 4)}


class ServeEngine:
    """Continuous-batching engine: per-arch request queues → (k, m, b) cells.

    ``eng.n_trials`` trial rows (one per co-served variant — ``params``
    carries each variant's weights on its leading K axis) ×
    ``eng.n_microbatches`` × global microbatch rows form the slot grid,
    ``eng.max_seq`` bounds each request, ``eng.prefill_chunks`` sets the
    admission chunk count and ``policy`` the per-arch admission order
    (fcfs / sjf / deadline); ``eng.paged`` picks the cache layout. The
    caches live on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``), where ``params`` must live too. ``prefix_cache``,
    ``host_blocks`` / ``spill``, ``overcommit``, ``fused`` and
    ``spec_gamma`` / ``spec_pairs`` turn on the paged serve features (see
    the module docstring); ``host_blocks``, when given, overrides
    ``eng.host_blocks`` (the reference's engine takes the same keyword,
    and the parity tests pass it to both); ``fused`` keeps greedy tokens bit-identical to
    the split schedule, and tick latencies too when nothing is preempted
    (under retraction the atomic fused round preempts a wave row before
    its chunk runs, where split preempts after).
    """

    def __init__(self, cfg: ArchConfig, eng: pl.EngineConfig, params,
                 opts: Optional[ModelOptions] = None,
                 overcommit: float = 1.0, policy: str = "fcfs",
                 prefix_cache: bool = False,
                 host_blocks: Optional[int] = None, spill: bool = True,
                 fused: bool = False, spec_gamma: int = 0,
                 spec_pairs: Optional[dict] = None, tracer=None,
                 device=None):
        if cfg.rope == "mrope" or cfg.frontend is not None:
            raise ValueError("continuous batching supports text-only archs; "
                             "use the static path for mrope/frontend models")
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
        n_arches = eng.n_trials
        if spec_gamma > 0:
            if fused:
                raise ValueError(
                    "gang speculation and fused mixed-tick admission both "
                    "own the round's ragged call structure; enable one")
            if recurrent:
                raise ValueError(
                    "gang speculation is attention-family only (rollback "
                    "truncates KV positionally; recurrent state cannot be "
                    "rewound to an earlier position)")
            if spec_pairs is None:
                if n_arches % 2:
                    raise ValueError(
                        f"default drafter pairing needs an even n_trials "
                        f"(targets 0..K/2-1 draft on K/2..K-1), got "
                        f"{n_arches}; pass spec_pairs explicitly")
                half = n_arches // 2
                spec_pairs = {k: half + k for k in range(half)}
            tgt, drf = set(spec_pairs), set(spec_pairs.values())
            if len(drf) != len(spec_pairs) or (tgt & drf) or not all(
                    0 <= k < n_arches for k in tgt | drf):
                raise ValueError(
                    f"spec_pairs must map disjoint target rows to distinct "
                    f"drafter rows, all within n_trials={n_arches}: "
                    f"got {spec_pairs}")
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
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)
        # NULL_TRACER when off: emission sites guard with `if tr.enabled:`
        self.trace = resolve(tracer)
        _tr = self.trace if self.trace.enabled else None
        self._round_modes: list = []
        self._retracted: set = set()  # rids retracted at least once (tracing)
        self.eng = dataclasses.replace(eng, prefill_chunks=1)
        self.n_arches = n_arches
        self.n_chunks = max(1, eng.prefill_chunks)
        self.params = params
        self.mb_global = self.eng.mb_global
        self.decode_step = pl.make_serve_step(cfg, self.opts, self.eng,
                                              "decode", tracer=_tr)
        self.append_step = pl.make_serve_step(cfg, self.opts, self.eng,
                                              "append", tracer=_tr)
        self.fused = bool(fused)
        self.mixed_step = (pl.make_serve_step(cfg, self.opts, self.eng,
                                              "mixed", tracer=_tr)
                           if self.fused else None)
        # gang speculation: each target trial row drafts on its peer row
        self.spec_gamma = int(spec_gamma)
        self.spec_pairs = dict(spec_pairs) if self.spec_gamma > 0 else {}
        self.spec_stats = SpecStats()
        self.verify_step = (pl.make_serve_step(cfg, self.opts, self.eng,
                                               "verify", tracer=_tr)
                            if self.spec_gamma > 0 else None)
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
            # every block movement — CoW copies, swap-out, swap-in — flows
            # through the transfer engine, batched into one flush per call
            self.transfer = TransferEngine(
                self.n_arches, n_parts,
                kernels=pl.make_transfer_kernels(cfg, self.eng))
            self.transfer.bind(lambda: self.cache, self._set_cache)
            hb = self.eng.host_blocks if host_blocks is None else host_blocks
            self.store = BlockStore(self.allocator, host_blocks=hb,
                                    spill=spill, transfer=self.transfer)
            self.store.trace = self.trace
        else:
            self.reset_fn = pl.make_slot_reset(cfg, self.eng)
        self.prefix_cache = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(self.store)
            self.prefix_cache.trace = self.trace
        self.cache = pl.serve_cache_struct(cfg, self.eng, device=self.device)
        self.batcher = Batcher(self.eng.n_microbatches, self.mb_global,
                               self.n_chunks, self.eng.max_seq,
                               n_trials=self.n_arches,
                               allocator=self.allocator,
                               rows_per_partition=self.eng.microbatch,
                               overcommit=overcommit, policy=policy,
                               prefix_cache=self.prefix_cache,
                               store=self.store, transfer=self.transfer,
                               spec_pairs=self.spec_pairs,
                               tracer=self.trace)
        # preemption replaces the stall-retry deadlock guard past 1.0
        self.retractable = self.paged and overcommit > 1.0
        self.tick = 0
        self._stalled_ticks = 0
        self.stats = ServeStats(prefix_enabled=prefix_cache)
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
        """Admit → prefill wave → decode. Returns False when fully drained."""
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
                s.request.prompt_len for s in admitted if not s.resumed)
            if tr.enabled:
                for s in admitted:
                    rid = s.request.rid
                    if rid in self._retracted:
                        via = ("recompute" if s.resume_tokens
                               else "swap" if s.resumed else "requeue")
                        tr.req("restore", rid, k=s.k, m=s.m, b=s.b, via=via)
                        self._retracted.discard(rid)
                    else:
                        tr.req("admit", rid, k=s.k, m=s.m, b=s.b,
                               plen=s.request.prompt_len)
                    if s.hit_tokens:
                        tr.req("prefix_hit", rid, tokens=s.hit_tokens)
        occupied = self.batcher.occupied()
        self.stats.peak_live = max(self.stats.peak_live, occupied)
        self.stats.occupancy_samples.append(occupied / self.batcher.n_cells)
        if self.allocator is not None:
            self.stats.block_usage_samples.append(
                self.allocator.used_blocks())
        if self.fused:
            self._mixed_call()
        else:
            for qlen, slots in sorted(self.batcher.prefill_groups().items()):
                self._prefill_call(qlen, slots)
            dec = self.batcher.decode_slots()
            if self.spec_pairs:
                plain = [s for s in dec if s.peer is None]
                if plain:
                    self._decode_call(plain)
                paired = [s for s in dec if s.peer is not None]
                if paired:
                    self._spec_round(paired)
            elif dec:
                self._decode_call(dec)
        # belt-and-braces: nothing stays in flight across rounds (admission
        # swap-ins with no same-round compute call, e.g.)
        if self.transfer is not None and self.transfer.pending():
            self.transfer.flush()
        # a pool can still wedge (e.g. overcommit 1.0 with every live row at
        # a block boundary, or retraction finding only in-flight victims);
        # flag the deadlock instead of spinning to max_ticks
        if occupied and self.stats.calls == calls_before and not admitted:
            self._stalled_ticks += 1
            if self._stalled_ticks > 100:
                raise RuntimeError(
                    "engine stalled: block pool exhausted with every live "
                    "row waiting for a block (raise overcommit above 1.0 to "
                    "enable retraction, grow n_blocks, or grow host_blocks)")
        else:
            self._stalled_ticks = 0
        if self.transfer is not None:
            self.stats.cow_forks = self.transfer.cow_copies
            self.stats.swap_out_blocks = self.transfer.swap_out_blocks
            self.stats.swap_in_blocks = self.transfer.swap_in_blocks
            self.stats.restored = self.batcher.restored
        if self.prefix_cache is not None:
            # synced at end of round so this tick's completions (inserts)
            # and allocation-pressure evictions are already counted
            self.stats.prefix_hits = self.prefix_cache.hits
            self.stats.prefix_hit_tokens = self.prefix_cache.hit_tokens
            self.stats.host_hit_tokens = self.prefix_cache.host_hit_tokens
            self.stats.prefix_inserts = self.prefix_cache.inserts
            self.stats.prefix_evictions = self.prefix_cache.evictions
            self.stats.prefix_spills = self.prefix_cache.spills
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
        """Zero the dense cache rows of the admitted cells (and of their
        drafter peers), before this round's calls."""
        mask = np.zeros((self.n_arches, self.eng.n_microbatches,
                         self.mb_global), bool)
        for s in slots:
            mask[s.k, s.m, s.b] = True
            if s.peer is not None:  # the drafter mirror cell starts cold too
                mask[s.peer.k, s.peer.m, s.peer.b] = True
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
        """Make each slot writable for its next ``extra`` positions: grow its
        block table (retracting a victim under overcommit if the pool is
        dry), then enqueue CoW forks for shared write-range blocks. Rows the
        pool still cannot back are stalled (kept out of this round's call,
        retried next round)."""
        if not self.paged:
            return list(slots)
        ready = []
        for s in slots:
            if s.request is None:
                continue  # retracted earlier this round by another row
            if self._ensure(s, extra):
                ready.append(s)
            elif s.request is not None:
                self.stats.pool_stalls += 1
        # a later row's retraction may have victimized an already-ready one
        ready = [s for s in ready if s.request is not None]
        return self._cow_forks(ready, extra)

    def _ensure(self, slot, extra) -> bool:
        if slot.table.ensure(slot.pos + extra):
            return True
        if not self.retractable:
            return False
        return self._retract_for(slot, extra)

    def _retract_for(self, slot, extra) -> bool:
        """Free pool room for ``slot`` by preempting the lowest-priority
        running request in its partition (youngest admission tick, ties by
        rid — SGLang-style). The requester itself is fair game: if it IS the
        youngest, it gets retracted and the round moves on. Victims with
        in-flight transfer blocks are skipped (their bytes are not yet
        addressable)."""
        p = self.batcher.partition_of(slot.k, slot.b)
        while True:
            cands = [s for s in self.batcher.slots
                     if s.request is not None
                     and self.batcher.partition_of(s.k, s.b) == p
                     and not self._pair_in_flight(s)]
            if not cands:
                return False
            victim = max(cands,
                         key=lambda s: (s.admitted_tick, s.request.rid))
            self._retract(victim)
            if slot.request is None:  # the requester (or its pair) lost
                return False
            if slot.table.ensure(slot.pos + extra):
                return True

    def _pair_in_flight(self, slot) -> bool:
        """Whether any block of ``slot``'s table — or its speculation
        peer's — is an in-flight transfer destination (such a pair cannot
        be retracted: the pending bytes' home would be reallocated)."""
        for s in (slot, slot.peer):
            if s is None or s.table is None:
                continue
            p = self.batcher.partition_of(s.k, s.b)
            if any(self.transfer.in_flight(p, b) for b in s.table.blocks):
                return True
        return False

    def _retract(self, victim) -> None:
        """Preempt a running request: swap its blocks to host when the tier
        has room (decode-phase rows only — their whole KV is generated
        state), else remember its tokens for a teacher-forced recompute
        replay; release the cell and requeue the request at its queue head
        with its original admission tick (so restore order is stable and a
        freshly restored row is not the next victim).

        A speculation pair is preempted atomically: a drafter victim is
        redirected to its target peer (the request lives there), only the
        target's KV is swapped/replayed — drafter KV is disposable, rebuilt
        by catch-up from position 0 after re-admission — and both cells
        release."""
        if victim.is_draft and victim.peer is not None:
            victim = victim.peer
        req = victim.request
        peer = victim.peer
        p = self.batcher.partition_of(victim.k, victim.b)
        gen = (list(victim.generated) if victim.generated
               else (list(victim.resume_tokens)
                     if victim.resume_tokens else []))
        state = None
        if gen and not victim.chunks:
            state = self._swap_out_victim(victim, p, gen)
        if state is None and gen:
            state = ResumeState(generated=gen, pos=victim.pos,
                                admitted_tick=victim.admitted_tick,
                                first_token_tick=victim.first_token_tick)
        tr = self.trace
        if tr.enabled:
            swapped = state is not None and state.host_ids is not None
            if swapped:
                tr.req("swap_out", req.rid, blocks=len(state.host_ids))
            via = ("swap" if swapped
                   else "recompute" if state is not None else "requeue")
            tr.req("retract", req.rid, via=via, pos=victim.pos)
            self._retracted.add(req.rid)
        victim.release()
        if peer is not None:
            peer.release()
        self.batcher.requeue(req, state)
        self.stats.retractions += 1

    def _swap_out_victim(self, victim, p, gen):
        """Extract the victim's whole block table to pinned host blocks.
        Returns a swap ResumeState, or None when the host tier cannot take
        the full table (partial swaps are useless — fall back to replay)."""
        st = self.store
        ids = list(victim.table.blocks)
        if not (st.spill and st.host_capacity >= len(ids)):
            return None
        payloads = self.transfer.swap_out(p, ids)
        hids = []
        for payload in payloads:
            hid = st.host_put(p, payload, pinned=True)
            if hid is None:  # tier full of pinned/interior blocks: roll back
                for h in hids:
                    st.host_pop(p, h)
                self.transfer.swap_out_blocks -= len(payloads)
                return None
            hids.append(hid)
        return ResumeState(generated=gen, pos=victim.pos,
                           admitted_tick=victim.admitted_tick,
                           first_token_tick=victim.first_token_tick,
                           partition=p, host_ids=hids)

    def _cow_forks(self, slots, extra) -> list:
        """Enforce the writer-exclusivity invariant: any *shared* block
        (refcount > 1) overlapping a row's next write range [pos, pos+extra)
        is forked — a private block is allocated, a pool copy is enqueued on
        the transfer engine (flushed once per round), and the table entry
        swaps — before the write is issued. Only the partially-matched tail
        block of a prefix hit can ever be shared in a write range, so forks
        are rare."""
        if self.prefix_cache is None:
            return list(slots)
        ready = []
        for s in slots:
            pairs = s.table.fork_shared(s.pos, s.pos + extra)
            if pairs is None:  # pool can't back the fork: stall this row
                self.stats.pool_stalls += 1
                continue
            p = self.batcher.partition_of(s.k, s.b)
            for src, dst in pairs:
                s.cached_ids.discard(src)  # no longer pinned by this slot
                self.transfer.copy(p, src, dst)
            ready.append(s)
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

    def _batch(self, tokens, positions, active, slots, qlens=None) -> dict:
        """The call's numpy grids as tensors on ``self.device`` (plus the
        block tables of ``slots`` when paged)."""
        dev = self.device
        grids = {"tokens": tokens, "positions": positions, "active": active}
        if qlens is not None:
            grids["qlens"] = qlens
        if self.paged:
            grids["block_tables"] = self._block_tables(slots)
        return {n: torch.from_numpy(a).to(dev) for n, a in grids.items()}

    def _prefill_call(self, qlen: int, slots) -> None:
        slots = self._prepare(slots, qlen)
        if self.transfer is not None:
            # batched flush: this call's CoW forks plus any admission-time
            # swap-ins land in ONE transfer round before the compute reads
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
            if not s.chunks:
                t = int(tok[s.k, s.m, s.b])
                if s.resume_tokens is not None:
                    # recompute-restore replay: the final chunk re-derives
                    # the victim's LAST pre-retraction token — it must match
                    # bit-for-bit and is not re-counted (already generated)
                    assert t == s.resume_tokens[-1], \
                        "recompute replay diverged from retracted tokens"
                    s.generated = list(s.resume_tokens)
                    s.resume_tokens = None
                else:  # final chunk → first generated token
                    s.generated.append(t)
                    s.first_token_tick = self.tick
                    self.stats.tokens_generated += 1
                    if tr.enabled:
                        tr.req("first_token", s.request.rid)
                self._maybe_finish(s)

    def _decode_call(self, slots, sample: bool = True) -> int:
        """One decode-mode pipeline call for ``slots``; returns the number of
        rows that actually ran (pool stalls drop rows). ``sample=False``
        suppresses the per-round occupancy sample (the fused path records one
        combined sample covering the mixed call plus this tail call)."""
        slots = self._prepare(slots, 1)
        if self.transfer is not None:
            self.transfer.flush()
        if not slots:
            # a fully pool-stalled decode round is zero decode work, not a
            # skipped sample — keep the occupancy metric honest
            if sample:
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
        if sample:
            self.stats.decode_busy_samples.append(
                len(slots) / self.batcher.n_cells)
        for s in slots:
            s.pos += 1
            s.generated.append(int(tok[s.k, s.m, s.b]))
            self.stats.tokens_generated += 1
            self._maybe_finish(s)
        return len(slots)

    # -- gang speculation ----------------------------------------------------

    def _spec_round(self, slots) -> None:
        """One propose–verify–commit round for the paired decoding targets.

        Each target's drafter first *catches up* to the committed stream
        (one append covering every position the drafter has not yet
        written — after a full accept that is 2 tokens, after a partial
        accept 1, after admission the whole prompt), emitting its first
        proposal; ``spec_gamma - 1`` width-1 drafter decodes extend the
        draft. The target then scores all drafts in ONE ragged verify call
        (per-row qlens + per-position argmax — the mixed-tick machinery),
        commits the longest matching prefix plus its own argmax at the first
        mismatch, and rolls rejected positions back. Greedy tokens are
        bit-identical to the target-only engine by construction: every
        committed token is the target's own argmax at its own position —
        drafter quality moves only the acceptance rate.
        """
        plan, drafts = {}, {}
        for s in slots:
            remaining = s.request.max_new_tokens - len(s.generated)
            # never draft the request's final token: it is emitted by the
            # verify head and has no successor to verify against
            plan[id(s)] = min(self.spec_gamma, max(remaining - 1, 0))
            drafts[id(s)] = []
        widths: dict = {}
        for s in slots:
            if plan[id(s)] > 0:
                widths.setdefault(s.pos + 1 - s.peer.pos, []).append(s)
        for w in sorted(widths):
            self._draft_call(w, widths[w], drafts)
        for i in range(1, self.spec_gamma):
            group = [s for s in slots
                     if s.request is not None and plan[id(s)] > i
                     and len(drafts[id(s)]) == i]
            if group:
                self._draft_call(1, group, drafts)
        live = [s for s in slots if s.request is not None]
        if live:
            self._verify_call(live, drafts)

    def _draft_call(self, w: int, group, drafts) -> None:
        """One width-``w`` pipeline call on the drafter rows of ``group``:
        each drafter consumes ``w`` tokens of its extended stream
        (prompt ++ committed ++ drafts-so-far) from its own depth and its
        head output is appended to the pair's draft list."""
        dslots = self._prepare([s.peer for s in group], w)
        if self.transfer is not None:
            self.transfer.flush()
        group = [s for s in group if s.request is not None
                 and s.peer is not None and s.peer in dslots]
        if not group:
            return
        if self.paged:
            self._assert_clean([s.peer for s in group], w)
        tokens, positions, active = self._grid(w)
        for s in group:
            d = s.peer
            ext = s.request.prompt.tolist() + s.generated + drafts[id(s)]
            tokens[d.k, d.m, d.b, :] = ext[d.pos:d.pos + w]
            positions[d.k, d.m, d.b] = d.pos
            active[d.k, d.m, d.b] = True
        step = self.decode_step if w == 1 else self.append_step
        self.cache, tok, _ = step(
            self.params, self.cache,
            self._batch(tokens, positions, active, [s.peer for s in group]))
        tok = tok.cpu().numpy()
        self.stats.calls += 1
        self.spec_stats.draft_calls += 1
        if self.trace.enabled:
            self._round_modes.append(f"draft:{w}")
        for s in group:
            d = s.peer
            d.pos += w
            drafts[id(s)].append(int(tok[d.k, d.m, d.b]))

    def _verify_call(self, slots, drafts) -> None:
        """ONE ragged verify call scoring every pair's drafts on the target
        rows, then per-pair accept/commit/rollback."""
        ready = []
        for s in slots:
            if s.request is None:
                continue
            extra = len(drafts[id(s)]) + 1
            if self.paged and not self._ensure(s, extra):
                if s.request is not None:
                    self.stats.pool_stalls += 1
                continue
            ready.append(s)
        ready = [s for s in ready if s.request is not None]
        if self.prefix_cache is not None:
            ready = [s for s in ready
                     if self._cow_forks([s], len(drafts[id(s)]) + 1)]
        if self.transfer is not None:
            self.transfer.flush()
        if not ready:
            self.stats.decode_busy_samples.append(0.0)
            return
        if self.paged:
            for s in ready:
                self._assert_clean([s], len(drafts[id(s)]) + 1)
        qmax = max(len(drafts[id(s)]) for s in ready) + 1
        tokens, positions, active = self._grid(qmax)
        qlens = np.zeros((self.n_arches, self.eng.n_microbatches,
                          self.mb_global), np.int32)
        for s in ready:
            ds = drafts[id(s)]
            q = len(ds) + 1
            # re-feed the last committed token (its KV row is unwritten —
            # decode-style), then the drafts; the verify head returns the
            # target's argmax at every one of the q positions
            tokens[s.k, s.m, s.b, :q] = [s.generated[-1]] + ds
            positions[s.k, s.m, s.b] = s.pos
            qlens[s.k, s.m, s.b] = q
            active[s.k, s.m, s.b] = True
        self.cache, tok, _ = self.verify_step(
            self.params, self.cache,
            self._batch(tokens, positions, active, ready, qlens))
        tok = tok.cpu().numpy()  # (K, M, mb_global, qmax)
        self.stats.calls += 1
        sp = self.spec_stats
        sp.verify_calls += 1
        tr = self.trace
        if tr.enabled:
            self._round_modes.append("verify")
        self.stats.decode_busy_samples.append(
            len(ready) / self.batcher.n_cells)
        for s in ready:
            ds = drafts[id(s)]
            out = [int(t) for t in tok[s.k, s.m, s.b, :len(ds) + 1]]
            n_acc = 0
            while n_acc < len(ds) and ds[n_acc] == out[n_acc]:
                n_acc += 1
            # accepted prefix + the target's own token at the first mismatch
            # (or the bonus token after a full accept) — always >= 1 token,
            # so a round never regresses below plain decode
            commit = ds[:n_acc] + [out[n_acc]]
            sp.proposed += len(ds)
            sp.accepted += n_acc
            sp.bonus += 1
            if tr.enabled:
                tr.req("spec_propose", s.request.rid, n=len(ds))
                tr.req("spec_verify", s.request.rid, accepted=n_acc,
                       committed=len(commit))
            new_pos = s.pos + n_acc + 1
            d = s.peer
            rolled = 0
            if self.paged and n_acc < len(ds):
                # rejected positions' blocks go back to the free-list head:
                # pool state is bit-identical to never having written them
                rolled += len(s.table.truncate(new_pos))
            if d is not None and d.pos > new_pos:
                if self.paged:
                    rolled += len(d.table.truncate(new_pos))
                d.pos = new_pos  # rewind over the rejected draft positions
            sp.rollback_blocks += rolled
            if tr.enabled and n_acc < len(ds):
                tr.req("rollback", s.request.rid, blocks=rolled,
                       rejected=len(ds) - n_acc)
            s.pos = new_pos
            s.generated.extend(commit)
            self.stats.tokens_generated += len(commit)
            self._maybe_finish(s)

    def _mixed_call(self) -> None:
        """One fused mixed-tick pipeline call for the whole round: every
        prefilling cell rides at its chunk width, every decoding cell at
        qlen 1, idle cells at qlen 0 — one shared active mask, per-row
        positions/kv offsets, rows padded to the wave max. Only rows whose
        chunk completes the prompt (and the decode rows) sample a token.

        Schedule parity with the split path is exact: slots are *prepared*
        (block growth, retraction, CoW) in the split order — per sorted qlen
        group then decode, each followed by a transfer flush — and a slot
        that finishes its final chunk here also decodes once more this same
        round via a tail decode call, mirroring the split schedule where
        ``decode_slots()`` is taken after the prefill waves. Greedy tokens
        and (preemption-free) per-request tick latencies are therefore
        bit-identical; under retraction the atomic round preempts a wave
        row before its chunk runs (split preempts after), so preemption
        timing may differ — tokens still never change."""
        pre = []
        for qlen, slots in sorted(self.batcher.prefill_groups().items()):
            ready = self._prepare(slots, qlen)
            if self.transfer is not None:
                self.transfer.flush()
            pre.extend((s, qlen) for s in ready)
        dec_all = self.batcher.decode_slots()
        dec = self._prepare(dec_all, 1)
        if self.transfer is not None:
            self.transfer.flush()
        # a later group's retraction may have victimized an earlier-prepared
        # row — drop released slots before building the wave
        pre = [(s, q) for s, q in pre if s.request is not None]
        dec = [s for s in dec if s.request is not None]
        if not pre and not dec:
            if dec_all:
                self.stats.decode_busy_samples.append(0.0)
            return
        if self.paged:
            for s, q in pre:
                self._assert_clean([s], q)
            self._assert_clean(dec, 1)
        qmax = max(q for _, q in pre) if pre else 1
        tokens, positions, active = self._grid(qmax)
        qlens = np.zeros((self.n_arches, self.eng.n_microbatches,
                          self.mb_global), np.int32)
        for s, q in pre:
            tokens[s.k, s.m, s.b, :q] = s.chunks[0]
            positions[s.k, s.m, s.b] = s.pos
            qlens[s.k, s.m, s.b] = q
            active[s.k, s.m, s.b] = True
        for s in dec:
            tokens[s.k, s.m, s.b, 0] = s.generated[-1]
            positions[s.k, s.m, s.b] = s.pos
            qlens[s.k, s.m, s.b] = 1
            active[s.k, s.m, s.b] = True
        self.cache, tok, _ = self.mixed_step(
            self.params, self.cache,
            self._batch(tokens, positions, active,
                        [s for s, _ in pre] + dec, qlens))
        tok = tok.cpu().numpy()
        self.stats.calls += 1
        self.stats.mixed_calls += 1
        self.stats.prefill_slot_ticks += len(pre)
        fill = float(qlens.sum()) / (self.batcher.n_cells * qmax)
        self.stats.mixed_fill_samples.append(fill)
        tr = self.trace
        if tr.enabled:
            self._round_modes.append(f"mixed:{round(fill, 4)}")
        tail = []  # final-chunk completions decode again this round
        for s, q in pre:
            if tr.enabled:
                tr.req("prefill_chunk", s.request.rid, k=s.k, m=s.m, b=s.b,
                       qlen=q, pos=s.pos)
            s.chunks.pop(0)
            s.pos += q
            if not s.chunks:
                t = int(tok[s.k, s.m, s.b])
                if s.resume_tokens is not None:
                    assert t == s.resume_tokens[-1], \
                        "recompute replay diverged from retracted tokens"
                    s.generated = list(s.resume_tokens)
                    s.resume_tokens = None
                else:  # final chunk → first generated token
                    s.generated.append(t)
                    s.first_token_tick = self.tick
                    self.stats.tokens_generated += 1
                    if tr.enabled:
                        tr.req("first_token", s.request.rid)
                self._maybe_finish(s)
                if s.request is not None:
                    tail.append(s)
        for s in dec:
            s.pos += 1
            s.generated.append(int(tok[s.k, s.m, s.b]))
            self.stats.tokens_generated += 1
            self._maybe_finish(s)
        ran = self._decode_call(tail, sample=False) if tail else 0
        if dec_all or tail:
            self.stats.decode_busy_samples.append(
                (len(dec) + ran) / self.batcher.n_cells)

    def _maybe_finish(self, slot) -> None:
        if not slot.finished:
            return
        req = slot.request
        if self.prefix_cache is not None:
            # cache instead of free: adopt the request's full prompt blocks
            # into the radix tree (they keep one tree reference when the
            # table closes in release() below)
            self.prefix_cache.insert(
                self.batcher.partition_of(slot.k, slot.b),
                req.prompt, slot.table.blocks)
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
        peer = slot.peer
        slot.release()  # the cell is reusable the same round it finishes
        if peer is not None:  # the drafter mirror cell frees with its target
            peer.release()


# ---------------------------------------------------------------------------
# Static-batching baseline (the lockstep path)
# ---------------------------------------------------------------------------


def static_serve(cfg: ArchConfig, eng: pl.EngineConfig, params, requests,
                 opts: Optional[ModelOptions] = None, device=None):
    """Lockstep static batching over the same slot grid, for comparison.

    Single-arch (trial row 0 of ``params`` only: the lockstep baseline has
    no routing) over dense per-slot strips. Admits requests in consecutive
    groups of ``n_cells``, prefills each group in one call (prompts must
    share one length — the static path's restriction), then decodes until
    EVERY request of the group hits its budget; early finishers idle their
    slots. Arrival times are ignored (a clairvoyant static scheduler, which
    flatters the baseline). ``device`` as :class:`ServeEngine`'s. Returns
    (completions, ServeStats)."""
    if cfg.rope == "mrope" or cfg.frontend is not None:
        # the reference's static path feeds its prefill tokens only, while
        # its prefill step expects frontend_embeds / mrope_pos: it fails
        # there. These archs serve through make_serve_step's prefill
        # (with their frontend inputs) and decode
        raise ValueError(
            f"static_serve feeds tokens only; {cfg.name} needs frontend "
            f"embeddings / M-RoPE positions in its prefill — serve it "
            f"through pipeline.make_serve_step('prefill') and 'decode'")
    opts = opts or ModelOptions()
    dev = resolve_device(device)
    # the lockstep baseline keeps dense per-slot strips (it IS the
    # worst-case reservation the paged engine is measured against)
    eng = dataclasses.replace(eng, n_trials=1, prefill_chunks=1, paged=False,
                              n_blocks=0)
    mb_global = eng.mb_global
    n_cells = eng.n_microbatches * mb_global
    prefill = pl.make_serve_step(cfg, opts, eng, "prefill")
    decode = pl.make_serve_step(cfg, opts, eng, "decode")
    grid = (1, eng.n_microbatches, mb_global)
    stats = ServeStats()
    completions = []
    reqs = list(requests)
    t0 = time.monotonic()
    for g0 in range(0, len(reqs), n_cells):
        group = reqs[g0:g0 + n_cells]
        plens = {r.prompt_len for r in group}
        if len(plens) != 1:
            raise ValueError("static batching requires uniform prompt "
                             f"lengths per group, got {sorted(plens)}")
        plen = plens.pop()
        tokens = np.zeros(grid + (plen,), np.int32)
        for i, r in enumerate(group):
            tokens[0, i // mb_global, i % mb_global] = r.prompt
        cache = pl.serve_cache_struct(cfg, eng, device=dev)
        stats.ticks += 1
        admitted_tick = stats.ticks  # the group's prefill tick
        stats.calls += 1
        stats.occupancy_samples.append(len(group) / n_cells)
        stats.prompt_tokens += plen * len(group)
        cache, tok, _ = prefill(params, cache,
                                {"tokens": torch.from_numpy(tokens).to(dev)})
        gen = [tok]
        stats.tokens_generated += len(group)
        max_gen = max(r.max_new_tokens for r in group)
        positions = torch.full(grid, plen, dtype=torch.int32, device=dev)
        for t in range(1, max_gen):
            live = sum(1 for r in group if r.max_new_tokens > t)
            stats.ticks += 1
            stats.calls += 1
            stats.occupancy_samples.append(live / n_cells)
            stats.decode_busy_samples.append(live / n_cells)
            cache, tok, _ = decode(params, cache, {
                "tokens": gen[-1][..., None], "positions": positions})
            gen.append(tok)
            stats.tokens_generated += live
            positions = positions + 1
        toks = torch.stack(gen, dim=-1).cpu().numpy()  # (1, M, mbg, max_gen)
        for i, r in enumerate(group):
            comp = Completion(
                rid=r.rid, prompt_len=plen,
                tokens=toks[0, i // mb_global, i % mb_global,
                            :r.max_new_tokens].tolist(),
                arrival=r.arrival, admitted_tick=admitted_tick,
                # the decode tick that produced the request's last token
                # (its slot still idles until the group drains)
                finished_tick=admitted_tick + r.max_new_tokens - 1,
                arch=r.arch, first_token_tick=admitted_tick)
            completions.append(comp)
            stats.record_completion(comp)
    stats.wall_s = time.monotonic() - t0
    return sorted(completions, key=lambda c: c.rid), stats
