"""PyTorch port — the static lockstep serving path against the JAX
reference on the same weights (carried across with ``params_from_numpy``):

* ``make_serve_step`` in ``prefill`` mode over S=4 stages and 2 data
  shards, plain (nc 1, with an ``active`` row mask: a row left out keeps
  its strips bit for bit) and chunked (``prefill_chunks`` 4, the chunk
  slots of a request group sharing one cache; the setup of
  ``tests/integration/test_chunked_prefill.py``), for chatglm3-6b (K/V
  strips) and falcon-mamba-7b (the final SSM state and conv window):
  greedy tokens equal, ``logit_max`` and every cache leaf within 2e-5;
  the port's chunked prefill equals its plain prefill in tokens and
  caches;
* ``static_serve`` against the reference's on the staggered-budget trace
  of ``tests/test_serve_engine.py::test_continuous_beats_static_occupancy_and_matches_tokens``:
  tokens, tick latencies, the stats summary and every schedule sample
  exact; the continuous engine gives the same tokens at higher occupancy;
  non-uniform prompt lengths are a ``ValueError``; a paged engine config
  cannot prefill;
* the launcher's ``--static`` and ``--trace`` (replay, and its checks)."""
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
from repro.serve import static_serve as jstatic
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.launch import serve as launcher
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import save_trace
from repro_torch.serve import static_serve as tstatic

torch.set_num_threads(2)
TOL = 2e-5
SEQ, S, DP, MB, NC = 16, 4, 2, 2, 4


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _prefill_setup(arch, nc):
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    kw = dict(n_trials=1, n_microbatches=2 * nc, microbatch=MB, n_stages=S,
              data_size=DP, max_seq=SEQ, prefill_chunks=nc)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, S),
                                   jax.random.PRNGKey(0), max_pos=SEQ)
    opts_t = TOpts(use_mamba_kernel=cfg_t.family == "ssm",
                   use_flash_kernel=cfg_t.family == "dense")
    return cfg_j, cfg_t, eng_j, eng_t, params, opts_t


def _chunked(toks, nc):
    """(1, 2, mbg, SEQ) request groups -> (1, 2·nc, mbg, SEQ/nc) chunk
    slots, chunk c of group g in slot g·nc + c."""
    mbg = toks.shape[2]
    return np.ascontiguousarray(
        toks.reshape(1, 2, mbg, nc, SEQ // nc).transpose(0, 1, 3, 2, 4)
        .reshape(1, 2 * nc, mbg, SEQ // nc))


def _torch_prefill(cfg_t, eng_t, opts_t, params_t, toks, active=None):
    cache = tpl.serve_cache_struct(cfg_t, eng_t, device="cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    if active is not None:
        batch["active"] = torch.from_numpy(active)
    step = tpl.make_serve_step(cfg_t, opts_t, eng_t, "prefill")
    return step(params_t, cache, batch)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("nc", [1, NC])
def test_prefill_step_matches_reference(arch, nc):
    cfg_j, cfg_t, eng_j, eng_t, params, opts_t = _prefill_setup(arch, nc)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params))
    mbg = MB * DP
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab_size, (1, 2, mbg, SEQ), np.int32)
    toks_in = toks if nc == 1 else _chunked(toks, nc)
    batch = {"tokens": toks_in}
    active = None
    if nc == 1:  # one row of group 1 stays out: its strips keep their state
        active = np.ones((1, 2, mbg), bool)
        active[0, 1, mbg - 1] = False
        batch["active"] = active
    mesh = make_test_mesh(DP, S)
    step_j = jpl.make_serve_step(cfg_j, JOpts(), eng_j, mesh, "prefill",
                                 with_active=active is not None)
    cache_j = jpl.serve_cache_struct(cfg_j, eng_j, dry_run=False)
    cache_j, tok_j, val_j = step_j(
        params, cache_j, {n: jnp.asarray(a) for n, a in batch.items()})
    cache_t, tok_t, val_t = _torch_prefill(cfg_t, eng_t, opts_t, params_t,
                                           toks_in, active)
    np.testing.assert_array_equal(np.asarray(tok_j), tok_t.numpy())
    assert _err(val_j, val_t) < TOL
    for n, buf in cache_t["layers"].items():
        assert _err(cache_j["layers"][n], buf) < TOL, n
    if active is not None:  # (K, G, Lp, mbg, ...): the idle row is zero
        for buf in cache_t["layers"].values():
            assert not buf[0, 1, :, mbg - 1].any()
    if nc > 1:
        # chunked prefill equals the port's own plain prefill: the last
        # chunk's token and the shared group caches
        plain = dataclasses.replace(eng_t, n_microbatches=2,
                                    prefill_chunks=1)
        cache_p, tok_p, _ = _torch_prefill(cfg_t, plain, opts_t, params_t,
                                           toks)
        last = tok_t.numpy().reshape(1, 2, nc, mbg)[:, :, -1]
        np.testing.assert_array_equal(tok_p.numpy(), last)
        for n, buf in cache_p["layers"].items():
            assert _err(buf, cache_t["layers"][n]) < 5e-4, n


def test_prefill_rejects_paged_and_keeps_dense_group_rule():
    cfg_j, cfg_t, eng_j, eng_t, params, opts_t = _prefill_setup(
        "chatglm3-6b", NC)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params))
    toks = np.zeros((1, 2 * NC, MB * DP, SEQ // NC), np.int32)
    paged = dataclasses.replace(eng_t, prefill_chunks=1, paged=True,
                                block_size=4, n_blocks=16)
    step = tpl.make_serve_step(cfg_t, opts_t, paged, "prefill")
    with pytest.raises(ValueError, match="prefill"):
        step(params_t, tpl.serve_cache_struct(cfg_t, paged, device="cpu"),
             {"tokens": torch.from_numpy(toks)})
    # append / decode still need one cache group per slot
    step = tpl.make_serve_step(cfg_t, opts_t, eng_t, "append")
    batch = {"tokens": torch.from_numpy(toks),
             "positions": torch.zeros(toks.shape[:3], dtype=torch.int32)}
    with pytest.raises(ValueError, match="prefill_chunks=1"):
        step(params_t, tpl.serve_cache_struct(cfg_t, eng_t, device="cpu"),
             batch)


# ---------------------------------------------------------------------------
# static_serve
# ---------------------------------------------------------------------------

GENS = [2, 7, 3, 6, 2, 5, 4, 7, 2, 6, 3, 5]  # staggered budgets
PLEN, MAX_SEQ = 8, 24


def _static_setup(arch="chatglm3-6b"):
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    kw = dict(n_trials=1, n_microbatches=2, microbatch=2, n_stages=2,
              max_seq=MAX_SEQ, prefill_chunks=2)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=MAX_SEQ)
    return cfg_j, cfg_t, eng_j, eng_t, params


def _trace(req_cls, vocab):
    rng = np.random.default_rng(0)
    return [req_cls(i, rng.integers(0, vocab, (PLEN,)).astype(np.int32), g)
            for i, g in enumerate(GENS)]


STAT_SAMPLES = ("occupancy_samples", "decode_busy_samples", "ttft_samples",
                "tpot_samples")


@pytest.mark.parametrize("arch", ["chatglm3-6b", "falcon-mamba-7b"])
def test_static_serve_matches_reference(arch):
    cfg_j, cfg_t, eng_j, eng_t, params = _static_setup(arch)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params))
    opts_t = TOpts(use_flash_kernel=cfg_t.family == "dense",
                   use_mamba_kernel=cfg_t.family == "ssm")
    jcomp, jst = jstatic(cfg_j, eng_j, make_test_mesh(1, 2), params,
                         _trace(JRequest, cfg_j.vocab_size), JOpts())
    tcomp, tst = tstatic(cfg_t, eng_t, params_t,
                         _trace(TRequest, cfg_t.vocab_size), opts_t,
                         device="cpu")
    assert [c.rid for c in tcomp] == [c.rid for c in jcomp]
    for a, b in zip(tcomp, jcomp):
        assert a.tokens == b.tokens, f"request {a.rid}: port != reference"
        assert (a.admitted_tick, a.first_token_tick, a.finished_tick) == \
            (b.admitted_tick, b.first_token_tick, b.finished_tick), a.rid
    drop = ("wall_s", "tokens_per_s")
    assert {k: v for k, v in tst.summary().items() if k not in drop} == \
        {k: v for k, v in jst.summary().items() if k not in drop}
    for name in STAT_SAMPLES:
        assert list(getattr(tst, name)) == list(getattr(jst, name)), name


def test_static_matches_continuous_tokens_at_lower_occupancy():
    """tests/test_serve_engine.py's comparison on the port alone: the same
    greedy tokens, and recycling slots keeps occupancy above lockstep."""
    cfg_j, cfg_t, eng_j, eng_t, params = _static_setup()
    params_t = params_from_numpy(jax.tree.map(np.asarray, params))
    reqs = _trace(TRequest, cfg_t.vocab_size)
    engine = TEngine(cfg_t, eng_t, params_t, TOpts(), device="cpu")
    cont = engine.run([r.clone() for r in reqs])
    stat, sstats = tstatic(cfg_t, eng_t, params_t, reqs,
                           TOpts(use_flash_kernel=True), device="cpu")
    for a, b in zip(cont, stat):
        assert a.tokens == b.tokens, f"request {a.rid}: continuous != static"
    assert engine.stats.slot_occupancy > sstats.slot_occupancy
    assert engine.stats.decode_occupancy > sstats.decode_occupancy
    ragged = reqs[:3] + [TRequest(99, np.zeros(PLEN + 1, np.int32), 2)]
    with pytest.raises(ValueError, match="uniform prompt"):
        tstatic(cfg_t, eng_t, params_t, ragged, device="cpu")


def test_launcher_static_and_trace_replay(tmp_path, capsys):
    common = ["--arch", "chatglm3-6b", "--smoke", "--n-model", "2",
              "--slots", "2", "--microbatch", "1", "--prompt-len", "8",
              "--gen-len", "4", "--device", "cpu"]
    launcher.main(common + ["--static", "--n-requests", "5"])
    out = capsys.readouterr().out
    assert "static: 5 requests" in out
    vocab = tget("chatglm3-6b").reduced().vocab_size
    rng = np.random.default_rng(3)
    path = str(tmp_path / "trace.jsonl")
    save_trace(path, [TRequest(i, rng.integers(0, vocab, (p,))
                               .astype(np.int32), g, arrival=0.5 * i)
                      for i, (p, g) in enumerate([(8, 3), (6, 4), (8, 2)])])
    launcher.main(common + ["--trace", path])
    assert "continuous/dense: 3 requests" in capsys.readouterr().out
    # the replay's checks: lengths against max_seq, arch ids, and the
    # static path's uniform prompt lengths per group of cells
    for extra, needle in ((["--gen-len", "1"], "exceed max_seq"),
                          (["--static"], "uniform prompt lengths")):
        with pytest.raises(SystemExit, match=needle):
            launcher.main(common + ["--trace", path] + extra)
    save_trace(path, [TRequest(0, np.zeros(4, np.int32), 2, arch=1)])
    with pytest.raises(SystemExit, match="arch ids"):
        launcher.main(common + ["--trace", path])
    for extra, needle in ((["--static", "--paged"], "drop --paged"),
                          (["--static", "--arches", "2"], "single-arch"),
                          (["--static", "--events-out", path],
                           "drop --static")):
        with pytest.raises(SystemExit, match=needle):
            launcher.main(common + extra)
