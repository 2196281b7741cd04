"""PyTorch port — the radix prefix cache.

* The reference's host-side unit cases (allocator refcounts, radix
  match / insert / LRU eviction, copy-on-write forks, hit-aware admission;
  tests/test_prefix_cache.py), each run against the reference's
  ``repro.serve`` and the port's copy in ``repro_torch.serve``.
* Engine parity on the reference's prefix traces: the port's engine with
  the cache on (kernel path and gather path) against the JAX engine's run
  of the same trace on the same weights — tokens, tick latencies, every
  counter, the allocator's free lists — and against its own oracle; the
  cache-off run gives the same tokens; eviction under pool pressure
  serves everything.
"""
import importlib

import numpy as np
import pytest
import torch
from test_prefix_cache import shared_prefix_trace
from test_torch_serve_engine import (assert_oracle, assert_parity, configs,
                                     jax_engine, jax_params, torch_engine)

from repro.serve import Request as JRequest
from repro_torch.serve import Request as TRequest

torch.set_num_threads(2)


@pytest.fixture(params=["repro.serve", "repro_torch.serve"])
def serve(request):
    return importlib.import_module(request.param)


# ---------------------------------------------------------------------------
# BlockAllocator refcounts
# ---------------------------------------------------------------------------


def test_refcounts_share_and_release(serve):
    a = serve.BlockAllocator(n_blocks=6, block_size=4)
    ids = a.alloc(2)
    assert [a.ref_count(i) for i in ids] == [1, 1]
    a.incref(ids)  # a second reader (prefix sharing)
    assert a.decref(ids) == []  # still live under the first reference
    assert a.used_blocks() == 2
    assert a.decref(ids) == ids  # last reference: back to the free list
    assert a.all_free()
    with pytest.raises(ValueError):
        a.decref([ids[0]])  # double free still rejected
    with pytest.raises(ValueError):
        a.incref([ids[0]])  # incref of a free block is a bug


def test_shared_block_never_rehanded_out(serve):
    a = serve.BlockAllocator(n_blocks=2, block_size=4)
    ids = a.alloc(2)
    a.incref([ids[0]])
    a.decref(ids)  # ids[1] freed, ids[0] still referenced
    assert a.alloc(2) is None  # only one block is actually free
    assert a.alloc(1) == [ids[1]]


# ---------------------------------------------------------------------------
# Radix tree: match / insert / LRU eviction
# ---------------------------------------------------------------------------


def _prompt(tokens):
    return np.asarray(tokens, np.int32)


def _cache_prompt(serve, alloc, pc, prompt, partition=0):
    """Run one request's life host-side: alloc blocks, insert, release."""
    t = serve.BlockTable(alloc, partition, cache=pc)
    assert t.ensure(int(prompt.shape[0]))
    pc.insert(partition, prompt, t.blocks)
    t.close()
    return t


def test_match_full_blocks_and_partial_tail(serve):
    alloc = serve.BlockAllocator(16, 4)
    pc = serve.PrefixCache(alloc)
    _cache_prompt(serve, alloc, pc, _prompt(range(14)))  # 3 full blocks
    assert pc.cached_blocks() == 3
    # 10 shared tokens: 2 full blocks + 2 tokens into the third
    hit = pc.match(0, _prompt(list(range(10)) + [99, 98]))
    assert hit.n_full_blocks == 2 and hit.tail_tokens == 2
    assert hit.hit_tokens == 10 and len(hit.block_ids) == 3
    # no hit for a diverging prompt
    assert pc.match(0, _prompt([55] * 12)).hit_tokens == 0


def test_match_capped_below_prompt_len(serve):
    """A fully cached prompt must still leave >= 1 token to prefill."""
    alloc = serve.BlockAllocator(16, 4)
    pc = serve.PrefixCache(alloc)
    _cache_prompt(serve, alloc, pc, _prompt(range(12)))
    hit = pc.match(0, _prompt(range(12)))  # identical, block-aligned
    assert hit.hit_tokens == 11  # 2 full blocks + 3 of the last
    assert hit.n_full_blocks == 2 and hit.tail_tokens == 3


def test_insert_dedupes_existing_chunks(serve):
    alloc = serve.BlockAllocator(16, 4)
    pc = serve.PrefixCache(alloc)
    _cache_prompt(serve, alloc, pc, _prompt(range(8)))
    used = alloc.used_blocks()
    # a second identical prompt adopts nothing: its blocks drop with it
    _cache_prompt(serve, alloc, pc, _prompt(range(8)))
    assert alloc.used_blocks() == used and pc.cached_blocks() == 2


def test_lru_eviction_leaf_first_and_pinned_blocks_skipped(serve):
    alloc = serve.BlockAllocator(8, 4)
    pc = serve.PrefixCache(alloc)
    _cache_prompt(serve, alloc, pc, _prompt(range(8)))  # chain A: 2 blocks
    _cache_prompt(serve, alloc, pc, _prompt([50 + i for i in range(8)]))
    assert alloc.used_blocks() == 4 and alloc.free_blocks() == 4
    # pin chain A via a live hit so chain B's leaf is the LRU victim
    hit = pc.match(0, _prompt(list(range(8)) + [1]))
    pc.acquire(hit)
    # drain the pool, then ask for one more: B's leaf must go first
    alloc.alloc(4)
    t = serve.BlockTable(alloc, cache=pc)
    assert t.ensure(4)
    assert pc.evictions == 1
    assert pc.match(0, _prompt([50 + i for i in range(8)] + [1])) \
        .hit_tokens == 4  # B's root block survives, its leaf is gone
    # chain A is pinned by the live hit: only B's root can go, one short
    t2 = serve.BlockTable(alloc, cache=pc)
    assert not t2.ensure(8)
    assert pc.match(0, _prompt(list(range(8)) + [1])).hit_tokens == 8


# ---------------------------------------------------------------------------
# Copy-on-write forking
# ---------------------------------------------------------------------------


def test_fork_shared_replaces_only_shared_blocks(serve):
    alloc = serve.BlockAllocator(16, 4)
    pc = serve.PrefixCache(alloc)
    _cache_prompt(serve, alloc, pc, _prompt(range(14)))
    hit = pc.match(0, _prompt(list(range(10)) + [99, 98]))
    pc.acquire(hit)
    t = serve.BlockTable(alloc, cache=pc)
    t.seed(hit.block_ids)
    assert t.ensure(12)
    shared_tail = t.blocks[2]
    assert alloc.ref_count(shared_tail) == 2  # tree + this table
    # writing tokens [10, 12) overlaps only the tail block
    pairs = t.fork_shared(10, 12)
    assert len(pairs) == 1 and pairs[0][0] == shared_tail
    assert t.blocks[2] == pairs[0][1] != shared_tail
    assert alloc.ref_count(shared_tail) == 1  # back to tree-only
    assert alloc.ref_count(t.blocks[2]) == 1  # private to the writer
    # full-hit blocks stay shared and untouched
    assert t.blocks[:2] == [n.block for n in hit.nodes]
    assert t.fork_shared(12, 16) == []  # nothing shared in later ranges
    t.close()


def test_fork_shared_is_atomic_under_exhaustion(serve):
    alloc = serve.BlockAllocator(4, 4)
    pc = serve.PrefixCache(alloc)
    _cache_prompt(serve, alloc, pc, _prompt(range(8)))
    hit = pc.match(0, _prompt(list(range(6)) + [9]))
    assert hit.n_full_blocks == 1 and hit.tail_tokens == 2
    pc.acquire(hit)
    t = serve.BlockTable(alloc, cache=pc)
    t.seed(hit.block_ids)
    # drain the pool so the fork cannot allocate (cached blocks are pinned)
    held = alloc.alloc(2)
    assert t.fork_shared(6, 7) is None  # stall signal...
    assert alloc.ref_count(hit.tail.block) == 2  # ...and nothing changed
    alloc.decref(held)
    assert len(t.fork_shared(6, 7)) == 1  # retry succeeds
    t.close()


# ---------------------------------------------------------------------------
# Batcher admission with the prefix cache
# ---------------------------------------------------------------------------


def _req(serve, rid, prompt, gen=3, arrival=0.0, arch=0):
    return serve.Request(rid, _prompt(prompt), gen, arrival=arrival,
                         arch=arch)


def test_admission_commits_only_non_cached_need(serve):
    alloc = serve.BlockAllocator(16, 4)
    pc = serve.PrefixCache(alloc)
    b = serve.Batcher(n_microbatches=2, mb_global=2, prefill_chunks=2,
                      max_seq=32, allocator=alloc, prefix_cache=pc)
    _cache_prompt(serve, alloc, pc, _prompt(range(12)))
    assert b.admit(1.0) == []  # nothing queued yet
    # 10 cached of 12 prompt tokens; total 14 -> 4 blocks, 2 full cached
    b.enqueue(_req(serve, 0, list(range(10)) + [77, 66]))
    slot = b.admit(1.0)[0]
    assert slot.hit_tokens == 10 and slot.pos == 10
    assert slot.block_commit == 2  # 4 total - 2 full cached
    assert len(slot.cached_ids) == 3  # 2 full + shared tail
    assert sum(c.shape[0] for c in slot.chunks) == 2  # suffix only
    # referenced cached blocks charge the partition once
    assert b.committed_blocks(0) == 2 + 3
    # a second sharer adds only its own commit (cached ids already pinned)
    b.enqueue(_req(serve, 1, list(range(10)) + [11, 22]))
    slot2 = b.admit(2.0)[0]
    assert slot2.hit_tokens == 10
    assert b.committed_blocks(0) == 2 + 2 + 3


def test_admission_defers_when_pinned_cache_exceeds_pool(serve):
    alloc = serve.BlockAllocator(4, 4)
    pc = serve.PrefixCache(alloc)
    b = serve.Batcher(n_microbatches=2, mb_global=1, prefill_chunks=1,
                      max_seq=16, allocator=alloc, prefix_cache=pc)
    _cache_prompt(serve, alloc, pc, _prompt(range(8)))  # 2 cached blocks
    b.enqueue(_req(serve, 0, list(range(8)) + [3, 4], gen=5))  # 4 blocks
    slot = b.admit(1.0)[0]
    # 2 new + 2 pinned cached = 4 = full partition
    assert b.committed_blocks(0) == 4
    b.enqueue(_req(serve, 1, [91, 92, 93, 94], gen=2))  # no room
    assert b.admit(2.0) == []
    slot.release()
    assert [s.request.rid for s in b.admit(3.0)] == [1]


def test_prefix_pressure_preserves_per_arch_fairness(serve):
    alloc = serve.BlockAllocator(8, 4, n_partitions=2)
    pc = serve.PrefixCache(alloc)
    b = serve.Batcher(n_microbatches=2, mb_global=1, prefill_chunks=1,
                      max_seq=16, n_trials=2, allocator=alloc,
                      prefix_cache=pc)
    _cache_prompt(serve, alloc, pc, _prompt(range(8)), partition=0)
    # arch 0: hits 8 tokens, pins 2 cached + commits 1 new = 3 of 4
    b.enqueue(_req(serve, 0, list(range(8)) + [1, 2], gen=3, arch=0))
    # arch 0 second request (2 blocks): deferred, 3 + 2 > 4
    b.enqueue(_req(serve, 1, [71, 72, 73, 74], gen=2, arch=0))
    # arch 1: unaffected by arch 0's cached blocks
    b.enqueue(_req(serve, 2, [81, 82, 83, 84], gen=2, arch=1))
    admitted = b.admit(1.0)
    by_arch = {k: [s.request.rid for s in admitted if s.k == k]
               for k in (0, 1)}
    assert by_arch[0] == [0] and by_arch[1] == [2]


# ---------------------------------------------------------------------------
# Engine parity with the JAX engine
# ---------------------------------------------------------------------------


def to_port(reqs):
    return [TRequest(r.rid, r.prompt.copy(), r.max_new_tokens,
                     arrival=r.arrival, arch=r.arch) for r in reqs]


def eviction_trace(vocab):
    """tests/test_prefix_cache.py's eviction trace: four prompts whose
    cached blocks fill most of an 8-block pool, then four fresh ones."""
    rng = np.random.default_rng(3)
    return [JRequest(i, rng.integers(0, vocab, (9,)).astype(np.int32), 2,
                     arrival=float(10 * i if i < 4 else 60 + 10 * (i - 4)))
            for i in range(8)]


@pytest.fixture(scope="module")
def shared_run():
    """The JAX engine's prefix-cached run of the shared-prefix trace (run
    once; the port's runs below are held against it)."""
    cfg_j, cfg_t, eng_j, eng_t = configs()
    params = jax_params(cfg_j, eng_j)
    reqs = shared_prefix_trace(cfg_j.vocab_size)
    jeng = jax_engine(cfg_j, eng_j, params, prefix_cache=True)
    jcomp = jeng.run([r.clone() for r in reqs])
    return cfg_t, eng_t, params, reqs, jeng, jcomp


@pytest.mark.parametrize("kernel", [True, False])
def test_engine_prefix_cache_matches_reference_and_oracle(shared_run,
                                                          kernel):
    cfg, eng_t, params, reqs, jeng, jcomp = shared_run
    teng = torch_engine(cfg, eng_t, params, kernel, prefix_cache=True)
    tcomp = teng.run(to_port(reqs))
    assert_parity(teng, jeng, tcomp, jcomp)
    assert_oracle(cfg, teng, to_port(reqs), tcomp)
    s = teng.stats
    assert s.prefix_hits >= 3 and s.prefix_hit_tokens >= 30
    assert s.cow_forks >= 1
    assert teng.prefix_cache.cached_blocks() > 0
    assert teng.allocator.used_blocks() == teng.prefix_cache.cached_blocks()


def test_engine_prefix_cache_off_same_tokens_more_prefill(shared_run):
    cfg, eng_t, params, reqs, jeng, jcomp = shared_run
    off = torch_engine(cfg, eng_t, params)
    comps = off.run(to_port(reqs))
    assert [c.tokens for c in comps] == [c.tokens for c in jcomp]
    assert jeng.stats.prefill_calls < off.stats.prefill_calls
    assert off.allocator.all_free()


def test_engine_eviction_under_pressure_matches_reference():
    cfg_j, cfg_t, eng_j, eng_t = configs(n_blocks=8)
    params = jax_params(cfg_j, eng_j)
    reqs = eviction_trace(cfg_j.vocab_size)
    jeng = jax_engine(cfg_j, eng_j, params, prefix_cache=True)
    jcomp = jeng.run([r.clone() for r in reqs], max_ticks=2000)
    teng = torch_engine(cfg_t, eng_t, params, prefix_cache=True)
    tcomp = teng.run(to_port(reqs), max_ticks=2000)
    assert [c.rid for c in tcomp] == list(range(8))
    assert_parity(teng, jeng, tcomp, jcomp)
    assert_oracle(cfg_t, teng, to_port(reqs), tcomp)
    assert teng.stats.prefix_evictions > 0
    assert teng.allocator.used_blocks() == teng.prefix_cache.cached_blocks()
