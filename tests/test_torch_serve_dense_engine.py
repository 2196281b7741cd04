"""PyTorch port — the dense (non-paged) continuous-batching ServeEngine
against the JAX package on ``tests/test_serve_engine.py``'s setup and
staggered trace (seed 2: seven requests over four cells, so slots are
recycled and their cache rows reset), with the same weights:

* reduced falcon-mamba-7b (recurrent SSM and conv states; the kernel
  branch of ``mamba1_mix``, the plain version on the CPU) and reduced
  chatglm3-6b (dense K/V strips): every request's greedy tokens equal the
  reference's single-device oracle (``oracle_tokens``, through JAX
  ``lm.forward``);
* ticks, calls, prefill calls and per-request admitted / first-token /
  finished ticks equal the JAX dense engine's. The schedule does not
  depend on the model, so both ports are held against one JAX run: the
  chatglm3-6b engine's (the JAX falcon-mamba-7b engine's own test is in
  the slow tier). chatglm3-6b's tokens also equal that run's."""
import jax
import numpy as np
import pytest
import torch
from test_serve_engine import MAX_SEQ, build, oracle_tokens, staggered_trace

from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.kernels import mamba_scan as tms
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

torch.set_num_threads(2)
SEED = 2


def _port_trace(jreqs):
    return [TRequest(r.rid, r.prompt.copy(), r.max_new_tokens,
                     arrival=r.arrival) for r in jreqs]


@pytest.fixture(scope="module")
def jax_chatglm_run():
    cfg, opts, mesh, eng, params = build("chatglm3-6b")
    engine = JEngine(cfg, eng, mesh, params, opts)
    comps = engine.run([r.clone() for r in staggered_trace(cfg.vocab_size,
                                                            seed=SEED)])
    return engine, comps


def _port_engine(arch):
    cfg_j, opts_j, _, eng_j, params = build(arch)
    cfg = tget(arch).reduced()
    eng = tpl.EngineConfig(
        n_trials=eng_j.n_trials, n_microbatches=eng_j.n_microbatches,
        microbatch=eng_j.microbatch, n_stages=eng_j.n_stages,
        data_size=eng_j.data_size, max_seq=eng_j.max_seq,
        cache_dtype=torch.float32, prefill_chunks=eng_j.prefill_chunks)
    engine = TEngine(cfg, eng,
                     params_from_numpy(jax.tree.map(np.asarray, params)),
                     TOpts(use_mamba_kernel=cfg.family == "ssm"),
                     device="cpu")
    return (cfg_j, opts_j, params), engine


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "chatglm3-6b"])
def test_dense_engine_matches_reference(arch, jax_chatglm_run):
    (cfg_j, opts_j, params), teng = _port_engine(arch)
    jreqs = staggered_trace(cfg_j.vocab_size, seed=SEED)
    resets, reset_fn = [], teng.reset_fn

    def counted(cache, mask):
        resets.append(np.asarray(mask).sum())
        return reset_fn(cache, mask)

    teng.reset_fn = counted
    launches = tms.launches
    tcomp = teng.run(_port_trace(jreqs))
    assert tms.launches == launches  # CPU tensors: the plain version
    assert teng.allocator is None and teng.transfer is None
    assert sum(resets) == len(jreqs) > teng.batcher.n_cells  # recycled
    for r, c in zip(jreqs, tcomp):
        assert len(c.tokens) == r.max_new_tokens
        assert c.tokens == oracle_tokens(cfg_j, opts_j, params, r), \
            f"request {r.rid}: port diverged from the reference's oracle"
    jeng, jcomp = jax_chatglm_run
    assert [c.rid for c in tcomp] == [c.rid for c in jcomp]
    for a, b in zip(tcomp, jcomp):
        assert (a.admitted_tick, a.first_token_tick, a.finished_tick) == \
            (b.admitted_tick, b.first_token_tick, b.finished_tick)
        if arch == "chatglm3-6b":
            assert a.tokens == b.tokens
    for name in ("ticks", "calls", "prefill_calls", "prefill_slot_ticks",
                 "tokens_generated", "prompt_tokens", "peak_live"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.eng.max_seq == MAX_SEQ
