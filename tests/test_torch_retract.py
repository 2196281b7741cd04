"""PyTorch port — overcommit retraction and the host spill tier, against
the JAX engine on the reference's traces (tests/test_retract.py) and the
same weights: per-request tokens, tick latencies, every counter (prefix,
CoW, spill, swap, retraction), the allocator's free lists and the host
tier's holdings agree exactly, and the port's tokens equal its own oracle.

* overcommit 1.5 on a 6-block pool with a host tier: retracted requests
  swap their KV out and back in (bit-exact payload round trip);
* the same without a host tier: teacher-forced recompute replay;
* the prefix cache over the host tier: cached nodes spill under pressure,
  stay matchable, and hits swap them back in; ``spill=False`` destroys
  them instead.
"""
import numpy as np
import pytest
import torch
from test_retract import bursty_trace
from test_torch_prefix_cache import to_port
from test_torch_serve_engine import (assert_oracle, assert_parity, configs,
                                     jax_engine, jax_params, torch_engine)

from repro.serve import Request as JRequest

torch.set_num_threads(2)


def spill_trace(vocab, repeat_suffixes=True, n=6):
    """tests/test_retract.py's host-spill traces: a shared 8-token prefix
    and 4-token suffixes (repeated from request 3 on, so later requests
    can hit nodes spilled in the meantime)."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, vocab, (8,)).astype(np.int32)
    reqs = []
    for i in range(n):
        fresh = i < 3 or not repeat_suffixes
        suffix = (rng.integers(0, vocab, (4,)).astype(np.int32) if fresh
                  else reqs[i - 3].prompt[8:])
        gen = 4 + i % 3 if repeat_suffixes else 4
        reqs.append(JRequest(i, np.concatenate([base, suffix]), gen,
                             arrival=2.0 * i))
    return reqs


def pair_run(reqs, kernels=(True,), **kw):
    """The JAX engine's run of ``reqs`` on the 6-block pool, and the port's
    runs (one per kernel flag), each held to it exactly."""
    cfg_j, cfg_t, eng_j, eng_t = configs(n_blocks=6)
    params = jax_params(cfg_j, eng_j)
    jeng = jax_engine(cfg_j, eng_j, params, **kw)
    jcomp = jeng.run([r.clone() for r in reqs], max_ticks=2000)
    out = []
    for kernel in kernels:
        teng = torch_engine(cfg_t, eng_t, params, kernel, **kw)
        tcomp = teng.run(to_port(reqs), max_ticks=2000)
        assert_parity(teng, jeng, tcomp, jcomp)
        assert_oracle(cfg_t, teng, to_port(reqs), tcomp)
        assert teng.store.host_used() == jeng.store.host_used()
        assert teng.transfer.pending() == 0
        out.append(teng)
    return out


@pytest.mark.parametrize("host_blocks", [16, 0], ids=["swap", "recompute"])
def test_overcommit_retraction_matches_reference(host_blocks):
    reqs = bursty_trace(configs()[0].vocab_size)
    for teng in pair_run(reqs, kernels=(True, False), overcommit=1.5,
                         host_blocks=host_blocks):
        s = teng.stats
        assert s.retractions > 0, "pool never pressured — vacuous"
        assert 0 < s.restored <= s.retractions
        if host_blocks:
            assert s.swap_out_blocks > 0 and s.swap_in_blocks > 0
            assert teng.store.host_used() == 0  # pinned payloads consumed
        else:
            assert s.swap_in_blocks == 0  # no host tier: replay only
        assert teng.allocator.all_free()


def test_host_prefix_spill_matches_reference():
    reqs = spill_trace(configs()[0].vocab_size)
    (teng,) = pair_run(reqs, host_blocks=16, prefix_cache=True)
    s = teng.stats
    assert s.prefix_hits > 0 and s.prefix_spills > 0
    assert s.host_hit_tokens > 0 and s.swap_in_blocks > 0
    assert teng.allocator.used_blocks() == teng.prefix_cache.cached_blocks()
    assert teng.store.host_used() == teng.prefix_cache.host_cached_blocks()


def test_no_spill_destroys_instead_matches_reference():
    reqs = spill_trace(configs()[0].vocab_size, repeat_suffixes=False, n=5)
    (teng,) = pair_run(reqs, host_blocks=16, prefix_cache=True, spill=False)
    s = teng.stats
    assert s.prefix_spills == 0 and s.swap_out_blocks == 0
    assert teng.prefix_cache.evictions > 0
    assert teng.allocator.used_blocks() == teng.prefix_cache.cached_blocks()


def test_swap_payloads_round_trip_bit_exactly_in_bf16():
    """extract (device → host) then inject (host → device) restores a
    bf16 pool bit for bit."""
    from repro_torch.core import pipeline as tpl
    from repro_torch.configs import get_config
    cfg = get_config("chatglm3-6b").reduced()
    eng = tpl.EngineConfig(n_trials=2, n_microbatches=1, microbatch=1,
                           n_stages=2, data_size=2, paged=True, block_size=4,
                           n_blocks=8, cache_dtype=torch.bfloat16)
    kern = tpl.make_transfer_kernels(cfg, eng)
    cache = tpl.serve_cache_struct(cfg, eng, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for buf in cache["layers"].values():
        buf.copy_(torch.randn(buf.shape, generator=gen))
    before = {n: v.clone() for n, v in cache["layers"].items()}
    payloads = kern.extract(cache, 1, 1, [0, 3, 2])
    assert all(p.dtype == torch.bfloat16 and p.device.type == "cpu"
               for p in payloads)
    for buf in cache["layers"].values():  # shard 1 owns blocks 4..7
        buf[1, :, [4, 7, 6]] = 0
    kern.inject(cache, 1, 1, [0, 3, 2], payloads)
    for n, v in cache["layers"].items():
        assert torch.equal(v, before[n])
