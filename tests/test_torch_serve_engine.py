"""PyTorch port — the continuous-batching ServeEngine (paged pool, split
admission, paged-attention kernel path) against the JAX engine on the
staggered trace of tests/test_serve_engine.py with the same weights:
per-request tokens, ``ttft_ticks``, ``finished_tick``, ``stats.calls`` and
the allocator's free lists agree exactly, and the port's tokens equal its
own single-device greedy oracle (``lm.greedy_generate``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.kernels import paged_attention as tpa
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

torch.set_num_threads(2)
MAX_SEQ = 24
SHAPES = [(9, 4), (12, 3), (7, 5), (12, 6), (5, 2), (9, 4), (7, 3)]


def staggered(req_cls, vocab, seed=1):
    """tests/test_serve_engine.py::staggered_trace, for either package."""
    rng = np.random.default_rng(seed)
    return [req_cls(i, rng.integers(0, vocab, (p,)).astype(np.int32), g,
                    arrival=0.5 * i)
            for i, (p, g) in enumerate(SHAPES)]


def build(data_size=1, n_blocks=24, kernel=True):
    cfg_j, cfg_t = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    kw = dict(n_trials=1, n_microbatches=2, microbatch=2 // data_size,
              n_stages=2, data_size=data_size, max_seq=MAX_SEQ,
              prefill_chunks=2, paged=True, block_size=4, n_blocks=n_blocks)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=MAX_SEQ)
    jeng = JEngine(cfg_j, eng_j, make_test_mesh(data_size, 2), params,
                   JOpts(use_paged_kernel=kernel))
    teng = TEngine(cfg_t, eng_t,
                   params_from_numpy(jax.tree.map(np.asarray, params)),
                   TOpts(use_paged_kernel=kernel), device="cpu")
    return cfg_t, teng, jeng


def _free_lists(alloc):
    return [list(f) for f in alloc._free]


def _assert_same_run(teng, jeng, tcomp, jcomp):
    assert [c.rid for c in tcomp] == [c.rid for c in jcomp]
    for a, b in zip(tcomp, jcomp):
        assert a.tokens == b.tokens, f"request {a.rid}: port != reference"
        assert a.ttft_ticks == b.ttft_ticks
        assert a.finished_tick == b.finished_tick
        assert a.admitted_tick == b.admitted_tick
    assert teng.stats.calls == jeng.stats.calls
    assert teng.stats.prefill_calls == jeng.stats.prefill_calls
    assert teng.stats.ticks == jeng.stats.ticks
    assert teng.stats.tokens_generated == jeng.stats.tokens_generated
    assert list(teng.stats.block_usage_samples) == \
        list(jeng.stats.block_usage_samples)
    assert _free_lists(teng.allocator) == _free_lists(jeng.allocator)
    assert teng.allocator.all_free()


def _oracle(cfg, teng, req):
    p1 = lm.layer_slice(teng.params, 0)  # trial 0, vocab padding dropped
    p1["embed"] = {"tok": p1["embed"]["tok"][:cfg.vocab_size]}
    p1["head"] = p1["head"][:, :cfg.vocab_size]
    return lm.greedy_generate(cfg, teng.opts, p1, req.prompt,
                              req.max_new_tokens, MAX_SEQ, torch.float32)


@pytest.mark.parametrize("data_size", [1, 2])
def test_engine_matches_reference_and_oracle(data_size):
    cfg, teng, jeng = build(data_size=data_size)
    jcomp = jeng.run(staggered(JRequest, cfg.vocab_size))
    launches = tpa.launches
    tcomp = teng.run(staggered(TRequest, cfg.vocab_size))
    _assert_same_run(teng, jeng, tcomp, jcomp)
    assert teng.allocator.n_partitions == data_size
    assert tpa.launches == launches  # CPU tensors: the plain version
    for r, c in zip(staggered(TRequest, cfg.vocab_size), tcomp):
        assert len(c.tokens) == r.max_new_tokens
        assert c.tokens == _oracle(cfg, teng, r), \
            f"request {r.rid}: port diverged from its single-device oracle"


def test_engine_backpressure_and_gather_path_match_reference():
    """A pool too small for the grid defers admission; the gather path
    (use_paged_kernel=False) must schedule and decode identically."""
    cfg, teng, jeng = build(n_blocks=6, kernel=False)
    jcomp = jeng.run(staggered(JRequest, cfg.vocab_size), max_ticks=2000)
    tcomp = teng.run(staggered(TRequest, cfg.vocab_size), max_ticks=2000)
    _assert_same_run(teng, jeng, tcomp, jcomp)
    assert teng.stats.peak_live < teng.batcher.n_cells


def test_engine_rejects_unported_features_and_missing_cuda():
    cfg = tget("chatglm3-6b").reduced()
    eng = tpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=1,
                           n_stages=1, max_seq=16, paged=True, block_size=4,
                           n_blocks=4, cache_dtype=torch.float32)
    plan = tpl.plan_stages(cfg, 1)
    params = tpl.init_trial_params(cfg, eng, plan, torch.Generator())
    for kw in (dict(prefix_cache=True), dict(overcommit=1.5),
               dict(fused=True), dict(spec_gamma=2)):
        with pytest.raises(NotImplementedError):
            TEngine(cfg, eng, params, device="cpu", **kw)
    # dense strips are ported: the engine resets rows instead of paging
    dense = TEngine(cfg, dataclasses.replace(eng, paged=False), params,
                    device="cpu")
    assert dense.allocator is None and dense.reset_fn is not None
    if not torch.cuda.is_available():
        # entry points default to the card and never fall back silently
        with pytest.raises(RuntimeError, match="CUDA"):
            TEngine(cfg, eng, params)


def test_launcher_smoke_on_cpu(capsys):
    launcher.main(["--arch", "chatglm3-6b", "--smoke", "--paged",
                   "--paged-kernel", "--n-model", "2", "--n-data", "2",
                   "--slots", "2", "--microbatch", "1", "--n-requests", "4",
                   "--rate", "2.0", "--prompt-len", "8", "--gen-len", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 requests" in out and "generated" in out
    # the ssm family serves through dense strips, the default
    launcher.main(["--arch", "falcon-mamba-7b", "--smoke", "--n-model", "2",
                   "--slots", "2", "--microbatch", "1", "--n-requests", "4",
                   "--rate", "2.0", "--prompt-len", "8", "--gen-len", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "continuous/dense: 4 requests" in out
    assert "0 selective-scan kernel launches" in out
