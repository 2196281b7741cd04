"""PyTorch port — fused mixed-tick admission, against the JAX engine on
the reference's traces (tests/test_serve_engine.py) and the same weights.
(Gang speculation: tests/test_torch_spec_decode.py.)

* Fused admission over dense strips, the paged pool, the prefix cache and
  overcommit retraction: the port's fused run equals the JAX engine's
  fused run exactly (tokens, tick latencies, every counter,
  ``mixed_calls`` and ``mixed_fill_ratio``, the free lists); the port's
  split run gives the same tokens (and, with no preemption, the same
  latencies) in more calls.
* The constructor's validation errors (fused admission and gang
  speculation, the prefix cache, overcommit, the paged kernel) equal the
  reference's.
* A K = 2 multi-arch gang over 2 data shards, fused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serve_engine import staggered_trace
from test_torch_prefix_cache import to_port
from test_torch_serve_engine import (assert_oracle, assert_parity, configs,
                                     jax_engine, jax_params, torch_engine)

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.serve import ServeEngine as TEngine

torch.set_num_threads(2)
GAMMA = 3


def prefix_trace(vocab):
    """tests/test_serve_engine.py::test_fused_matches_split_prefix_cache's
    trace: a shared 8-token prefix, 4-token suffixes."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, vocab, (8,)).astype(np.int32)
    return [JRequest(i, np.concatenate(
                [base, rng.integers(0, vocab, (4,)).astype(np.int32)]),
                     3 + i % 3, arrival=2.0 * i) for i in range(6)]


def bursty(vocab):
    """The fused-under-retraction trace: six requests at t = 0."""
    rng = np.random.default_rng(7)
    shapes = [(12, 5), (11, 6), (9, 4), (12, 6), (10, 5), (11, 4)]
    return [JRequest(i, rng.integers(0, vocab, (p,)).astype(np.int32), g,
                     arrival=0.0) for i, (p, g) in enumerate(shapes)]


FUSED_CASES = {
    # name: (configs kwargs, trace, engine kwargs)
    "dense": (dict(paged=False), staggered_trace, {}),
    "paged": (dict(n_blocks=24), staggered_trace, {}),
    "prefix": (dict(n_blocks=24), prefix_trace, dict(prefix_cache=True)),
    "retract": (dict(n_blocks=6), bursty, dict(overcommit=1.5)),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_matches_reference_and_split(case):
    ckw, trace, kw = FUSED_CASES[case]
    cfg_j, cfg_t, eng_j, eng_t = configs(**ckw)
    paged = eng_j.paged
    params = jax_params(cfg_j, eng_j)
    reqs = trace(cfg_j.vocab_size)
    jeng = jax_engine(cfg_j, eng_j, params, paged, fused=True, **kw)
    jcomp = jeng.run([r.clone() for r in reqs], max_ticks=2000)
    fused = torch_engine(cfg_t, eng_t, params, paged, fused=True, **kw)
    comp_f = fused.run(to_port(reqs), max_ticks=2000)
    assert_parity(fused, jeng, comp_f, jcomp)
    assert_oracle(cfg_t, fused, to_port(reqs), comp_f)
    assert fused.stats.mixed_calls > 0
    assert 0.0 < fused.stats.mixed_fill_ratio <= 1.0
    split = torch_engine(cfg_t, eng_t, params, paged, **kw)
    comp_s = split.run(to_port(reqs), max_ticks=2000)
    # split and fused agree on tokens always, and on tick latencies when
    # nothing is preempted (the fused round preempts before its chunk)
    assert [c.tokens for c in comp_s] == [c.tokens for c in comp_f]
    if case != "retract":
        for a, b in zip(comp_s, comp_f):
            assert (a.ttft_ticks, a.finished_tick) == \
                (b.ttft_ticks, b.finished_tick), a.rid
        assert fused.stats.calls <= split.stats.calls
    if case in ("dense", "paged"):
        assert fused.stats.calls < split.stats.calls
    if case == "prefix":
        assert fused.stats.prefix_hits > 0
    if case == "retract":
        assert fused.stats.retractions > 0 and split.stats.retractions > 0
        assert fused.transfer.pending() == 0
    if paged:
        assert fused.allocator.all_free() or case == "prefix"


def test_fused_multiarch_sharded_matches_reference():
    """K = 2 trial rows × 2 data shards (four pool partitions), fused."""
    cfg_j, cfg_t, eng_j, eng_t = configs(n_trials=2, data_size=2,
                                         microbatch=1)
    params = jax_params(cfg_j, eng_j)
    reqs = staggered_trace(cfg_j.vocab_size, seed=3, n_arches=2)
    jeng = jax_engine(cfg_j, eng_j, params, fused=True)
    jcomp = jeng.run([r.clone() for r in reqs], max_ticks=2000)
    teng = torch_engine(cfg_t, eng_t, params, fused=True)
    tcomp = teng.run(to_port(reqs), max_ticks=2000)
    assert_parity(teng, jeng, tcomp, jcomp)
    assert_oracle(cfg_t, teng, to_port(reqs), tcomp)
    assert teng.allocator.n_partitions == 4
    assert {c.arch for c in tcomp} == {0, 1}
    assert teng.allocator.all_free()


# ---------------------------------------------------------------------------
# The constructor's validation
# ---------------------------------------------------------------------------


BAD = [
    # name: (arch, n_trials, paged, opts kernel, engine kwargs)
    ("spec_and_fused", "chatglm3-6b", 2, True, False,
     dict(spec_gamma=GAMMA, fused=True)),
    ("odd_default_pairing", "chatglm3-6b", 3, True, False,
     dict(spec_gamma=GAMMA)),
    ("pair_onto_itself", "chatglm3-6b", 2, True, False,
     dict(spec_gamma=GAMMA, spec_pairs={0: 0})),
    ("pair_out_of_range", "chatglm3-6b", 2, True, False,
     dict(spec_gamma=GAMMA, spec_pairs={0: 5})),
    ("shared_drafter", "chatglm3-6b", 3, True, False,
     dict(spec_gamma=GAMMA, spec_pairs={0: 2, 1: 2})),
    ("fused_recurrent", "falcon-mamba-7b", 1, False, False,
     dict(fused=True)),
    ("spec_recurrent", "falcon-mamba-7b", 2, False, False,
     dict(spec_gamma=GAMMA)),
    ("prefix_dense", "chatglm3-6b", 1, False, False,
     dict(prefix_cache=True)),
    ("overcommit_dense", "chatglm3-6b", 1, False, False,
     dict(overcommit=1.5)),
    ("kernel_dense", "chatglm3-6b", 1, False, True, {}),
]


@pytest.mark.parametrize("name,arch,k,paged,kernel,kw", BAD,
                         ids=[b[0] for b in BAD])
def test_constructor_rejects_like_reference(name, arch, k, paged, kernel,
                                            kw):
    common = dict(n_trials=k, n_microbatches=2, microbatch=1, n_stages=2,
                  max_seq=16, paged=paged, block_size=4,
                  n_blocks=8 if paged else 0)
    jeng = jpl.EngineConfig(cache_dtype=jnp.float32, **common)
    teng = tpl.EngineConfig(cache_dtype=torch.float32, **common)
    with pytest.raises(Exception) as want:
        JEngine(jget(arch).reduced(), jeng, make_test_mesh(1, 2), None,
                JOpts(use_paged_kernel=kernel), **kw)
    with pytest.raises(Exception) as got:
        TEngine(tget(arch).reduced(), teng, None,
                TOpts(use_paged_kernel=kernel), device="cpu", **kw)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)
