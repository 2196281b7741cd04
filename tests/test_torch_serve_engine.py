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
from repro_torch.serve import engine as tengine

torch.set_num_threads(2)
MAX_SEQ = 24
SHAPES = [(9, 4), (12, 3), (7, 5), (12, 6), (5, 2), (9, 4), (7, 3)]


def staggered(req_cls, vocab, seed=1):
    """tests/test_serve_engine.py::staggered_trace, for either package."""
    rng = np.random.default_rng(seed)
    return [req_cls(i, rng.integers(0, vocab, (p,)).astype(np.int32), g,
                    arrival=0.5 * i)
            for i, (p, g) in enumerate(SHAPES)]


def configs(n_trials=1, slots=2, microbatch=2, data_size=1, paged=True,
            n_blocks=24, block_size=4, prefill_chunks=2, max_seq=MAX_SEQ):
    """The reduced chatglm3-6b and one engine configuration, for each
    package (fp32 pools, 2 stages)."""
    cfg_j, cfg_t = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    kw = dict(n_trials=n_trials, n_microbatches=slots, microbatch=microbatch,
              n_stages=2, data_size=data_size, max_seq=max_seq,
              prefill_chunks=prefill_chunks, paged=paged,
              block_size=block_size, n_blocks=n_blocks if paged else 0)
    return (cfg_j, cfg_t, jpl.EngineConfig(cache_dtype=jnp.float32, **kw),
            tpl.EngineConfig(cache_dtype=torch.float32, **kw))


def jax_params(cfg_j, eng_j):
    return jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, eng_j.n_stages),
                                 jax.random.PRNGKey(0), max_pos=MAX_SEQ)


def jax_engine(cfg_j, eng_j, params, kernel=True, **kw):
    """The reference engine; its paged kernel path runs the default jnp
    lowering on the CPU."""
    return JEngine(cfg_j, eng_j, make_test_mesh(eng_j.data_size,
                                                eng_j.n_stages),
                   params, JOpts(use_paged_kernel=kernel), **kw)


def torch_engine(cfg_t, eng_t, params, kernel=True, **kw):
    """The port's engine on the CPU over the reference's weights."""
    return TEngine(cfg_t, eng_t,
                   params_from_numpy(jax.tree.map(np.asarray, params)),
                   TOpts(use_paged_kernel=kernel), device="cpu", **kw)


def build(data_size=1, n_blocks=24, kernel=True):
    cfg_j, cfg_t, eng_j, eng_t = configs(data_size=data_size,
                                         microbatch=2 // data_size,
                                         n_blocks=n_blocks)
    params = jax_params(cfg_j, eng_j)
    return (cfg_t, torch_engine(cfg_t, eng_t, params, kernel),
            jax_engine(cfg_j, eng_j, params, kernel))


def _free_lists(alloc):
    return [list(f) for f in alloc._free]


def _assert_same_run(teng, jeng, tcomp, jcomp):
    assert_parity(teng, jeng, tcomp, jcomp)
    assert teng.allocator.all_free()


def assert_parity(teng, jeng, tcomp, jcomp):
    """Exact agreement of two engine runs: per-request tokens and tick
    latencies, every ServeStats counter and schedule sample, every
    SpecStats field, and the allocator's free lists."""
    assert [c.rid for c in tcomp] == [c.rid for c in jcomp]
    for a, b in zip(tcomp, jcomp):
        assert a.tokens == b.tokens, f"request {a.rid}: port != reference"
        assert a.ttft_ticks == b.ttft_ticks, a.rid
        assert a.finished_tick == b.finished_tick, a.rid
        assert a.admitted_tick == b.admitted_tick, a.rid
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    for name in SAMPLES:
        assert list(getattr(teng.stats, name)) == \
            list(getattr(jeng.stats, name)), name
    assert teng.stats.mixed_fill_ratio == jeng.stats.mixed_fill_ratio
    assert dataclasses.asdict(teng.spec_stats) == \
        dataclasses.asdict(jeng.spec_stats)
    if jeng.allocator is not None:
        assert _free_lists(teng.allocator) == _free_lists(jeng.allocator)


COUNTERS = tengine._COUNTER_FIELDS
SAMPLES = ("block_usage_samples", "occupancy_samples", "decode_busy_samples",
           "mixed_fill_samples")


def _oracle(cfg, teng, req):
    """The port's single-device greedy tokens for ``req`` against its
    arch's trial row."""
    p1 = lm.layer_slice(teng.params, req.arch)  # vocab padding dropped
    p1["embed"] = {"tok": p1["embed"]["tok"][:cfg.vocab_size]}
    p1["head"] = p1["head"][:, :cfg.vocab_size]
    return lm.greedy_generate(cfg, teng.opts, p1, req.prompt,
                              req.max_new_tokens, MAX_SEQ, torch.float32)


def assert_oracle(cfg, teng, reqs, comps):
    for r, c in zip(sorted(reqs, key=lambda r: r.rid), comps):
        assert len(c.tokens) == r.max_new_tokens
        assert c.tokens == _oracle(cfg, teng, r), \
            f"request {r.rid}: port diverged from its single-device oracle"


@pytest.mark.parametrize("data_size", [1, 2])
def test_engine_matches_reference_and_oracle(data_size):
    cfg, teng, jeng = build(data_size=data_size)
    jcomp = jeng.run(staggered(JRequest, cfg.vocab_size))
    launches = tpa.launches
    tcomp = teng.run(staggered(TRequest, cfg.vocab_size))
    _assert_same_run(teng, jeng, tcomp, jcomp)
    assert teng.allocator.n_partitions == data_size
    assert tpa.launches == launches  # CPU tensors: the plain version
    assert_oracle(cfg, teng, staggered(TRequest, cfg.vocab_size), tcomp)


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
    # sliding-window serving is ported for the attention family (held to
    # the reference in test_torch_serve_window.py); recurrent families
    # keep the reference's ValueError
    windowed = TEngine(cfg, dataclasses.replace(eng, window=4), params,
                       device="cpu")
    assert windowed.eng.window == 4
    ssm = tget("falcon-mamba-7b").reduced()
    ssm_eng = dataclasses.replace(eng, paged=False, n_blocks=0, window=4)
    with pytest.raises(ValueError, match="sliding-window"):
        TEngine(ssm, ssm_eng, tpl.init_trial_params(
            ssm, ssm_eng, tpl.plan_stages(ssm, 1), torch.Generator()),
            device="cpu")
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


def test_launcher_serve_features_smoke_on_cpu(capsys):
    """The launcher's paged serve features on the CPU: the prefix cache,
    fused admission and overcommit over a host tier together, then a
    2-arch gang with a drafter row per arch."""
    common = ["--arch", "chatglm3-6b", "--smoke", "--paged", "--paged-kernel",
              "--n-model", "2", "--slots", "2", "--n-requests", "6",
              "--prompt-len", "12", "--gen-len", "6", "--block-size", "4",
              "--device", "cpu"]
    launcher.main(common + ["--prefix-cache", "--fused-admission",
                            "--overcommit", "1.5", "--host-blocks", "8",
                            "--n-blocks", "8"])
    out = capsys.readouterr().out
    assert "+fused+prefix-cache: 6 requests" in out
    assert "fused admission:" in out and "prefix cache:" in out
    assert "tiered store:" in out
    launcher.main(common + ["--arches", "2", "--spec-draft", "chatglm3-6b"])
    out = capsys.readouterr().out
    assert "+spec(gamma=3) x2-arch gang: 6 requests" in out
    assert "speculation:" in out and "tokens per arch" in out
