"""PyTorch port — the encoder (bert-large) and the frontend backbones
(musicgen-medium, qwen2-vl-72b) through the pipelined programs, against
the JAX reference on the same weights and batches, reduced, on the CPU:

* ``make_train_step`` on the reference exactness case
  (``tests/integration/test_pipeline_exactness.py``: K = 2, M = 3
  microbatches of 2 rows, 2 data shards, seq 16, 3 steps) at S = 4 and
  S = 2: losses within 2e-4, parameters within 5e-3, each trial's
  parameter change within 10 % of the reference's, and the first step's
  gradient norm within 5e-3 of ``jax.grad`` of the unpipelined loss (the
  reference's pipelined norm / S too; ROADMAP Queue 3). qwen2-vl-72b's
  M-RoPE positions are a grid whose three streams differ over the image,
  split over the data shards along their mbg axis (axis 3);
* ``TrainBatches``' frontend embeddings and M-RoPE positions bit-equal to
  the reference's;
* ``make_serve_step`` prefill (frontend embeddings, M-RoPE grid) then
  decode for qwen2-vl-72b and musicgen-medium, S = 2, 2 data shards:
  greedy tokens equal, caches within 2e-5, and the tokens equal the
  single-device oracle (``lm.forward`` prefill then decode);
* ``ServeEngine`` and ``static_serve`` refuse the frontend archs, and
  M-RoPE archs have no append / mixed / verify step;
* both launchers on ``--smoke`` bert-large and musicgen-medium (the serve
  launcher refuses musicgen-medium, as the reference's does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.data.pipeline import TrainBatches as JBatches
from repro.launch.mesh import make_test_mesh
from repro.models import lm as jlm
from repro.models.layers import ModelOptions as JOpts
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.data.pipeline import TrainBatches as TBatches
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm as tlm
from repro_torch.models.frontend import grid_mrope_positions
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import static_serve as tstatic
from repro_torch.serve import Request as TRequest
from test_torch_train_pipeline import _change_err, _err, _tree_err

torch.set_num_threads(2)
HP = {"lr": np.asarray([3e-3, 1e-3], np.float32),
      "wd": np.asarray([0.0, 0.01], np.float32)}
SEQ, N_STEPS = 16, 3
BERT, MUSICGEN, QWEN = "bert-large", "musicgen-medium", "qwen2-vl-72b"


def _grid(cfg, lead, mbg, seq):
    """(*lead, 3, mbg, seq) grid M-RoPE positions (numpy int32)."""
    g = grid_mrope_positions(cfg, mbg, seq).numpy().astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(g, lead + g.shape))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _train_setup(name, n_stages):
    cfg_j, cfg_t = jget(name).reduced(), tget(name).reduced()
    kw = dict(n_trials=2, n_microbatches=3, microbatch=2, n_stages=n_stages,
              data_size=2, vocab_parallel=True)
    eng_j, eng_t = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, n_stages),
                                   jax.random.PRNGKey(0), max_pos=SEQ)
    data = JBatches(cfg_j, eng_j, SEQ, seed=0)
    batches = [data.batch_for_step(s) for s in range(N_STEPS)]
    data.close()
    if cfg_j.rope == "mrope":
        for b in batches:
            b["mrope_pos"] = _grid(cfg_t, (2, 3), 4, SEQ)
    return cfg_j, cfg_t, eng_j, eng_t, params, batches


def _oracle_grad_norm(cfg, params, batch):
    """Per-trial global norm of ``jax.grad`` of the unpipelined objective:
    the mean over microbatches of the single-device CE over the global
    microbatch's rows (the data shards are equal, so this is the mean of
    the per-shard CEs)."""
    @jax.jit
    def norm(p, b):
        def f(p):
            ces = []
            for m in range(b["tokens"].shape[0]):
                sub = {n: v[m] for n, v in b.items()}
                logits, _, _ = jlm.forward(cfg, JOpts(), p, sub)
                ces.append(jlm.cross_entropy(logits, sub["labels"]))
            return jnp.mean(jnp.stack(ces))
        g = jax.grad(f)(p)
        return jnp.sqrt(sum(jnp.sum(jnp.square(x))
                            for x in jax.tree.leaves(g)))

    return [float(norm(jax.tree.map(lambda x: x[k], params),
                       {n: jnp.asarray(v[k]) for n, v in batch.items()}))
            for k in range(2)]


@pytest.mark.parametrize("name,n_stages", [(BERT, 4), (MUSICGEN, 4),
                                           (QWEN, 2)])
def test_train_step_matches_reference(name, n_stages):
    cfg_j, cfg_t, eng_j, eng_t, params, batches = _train_setup(name,
                                                               n_stages)
    mesh = make_test_mesh(2, n_stages)
    p0 = jax.tree.map(np.array, params)  # copies: params is donated
    pt = params_from_numpy(p0)
    if cfg_t.rope == "learned":
        assert pt["embed"]["pos"].shape == (2, SEQ, cfg_t.d_model)
    if cfg_t.family == "encoder":
        assert set(pt["final_norm"]) == {"w", "b"}
    opt_j, opt_t = JAdamW(grad_clip=1.0), TAdamW(grad_clip=1.0)
    step_j = jpl.make_train_step(cfg_j, JOpts(remat=True), eng_j, mesh,
                                 opt_j)
    step_t = tpl.make_train_step(cfg_t, TOpts(remat=True), eng_t, opt_t)
    oj, ot = opt_j.init(params), opt_t.init(pt)
    hp_j = {n: jnp.asarray(v) for n, v in HP.items()}
    true_norm = _oracle_grad_norm(cfg_j, params, batches[0])
    pj = params
    for s in range(N_STEPS):
        pj, oj, mj = step_j(pj, oj, jax.tree.map(jnp.asarray, batches[s]),
                            hp_j, jnp.asarray(s, jnp.int32))
        pt, ot, mt = step_t(pt, ot, batches[s], HP, s)
        assert _err(mj["loss"], mt["loss"]) < 2e-4, (s, mj["loss"],
                                                     mt["loss"])
        assert _err(np.asarray(mj["grad_norm"]) / n_stages,
                    mt["grad_norm"]) < 5e-3, s
        if s == 0:
            assert _err(true_norm, mt["grad_norm"]) < 5e-3
    pj = jax.tree.map(np.asarray, pj)
    assert _tree_err(pj, pt) < 5e-3
    for k in range(2):
        assert _change_err(p0, pj, pt, k) < 0.1, k


@pytest.mark.parametrize("name", [MUSICGEN, QWEN])
def test_train_batches_match_reference(name):
    """Frontend embeddings (``_philox(seed + 17, step)`` draws) and M-RoPE
    positions, bit for bit, at S = 2 with 2 data shards."""
    cfg_j, cfg_t = jget(name).reduced(), tget(name).reduced()
    kw = dict(n_trials=2, n_microbatches=3, microbatch=2, n_stages=2,
              data_size=2)
    jd = JBatches(cfg_j, jpl.EngineConfig(**kw), SEQ, seed=4)
    td = TBatches(cfg_t, tpl.EngineConfig(**kw), SEQ, seed=4)
    try:
        for step in (0, 7):
            want, got = jd.batch_for_step(step), td.batch_for_step(step)
            assert sorted(want) == sorted(got)
            for n in want:
                assert got[n].dtype == want[n].dtype, n
                np.testing.assert_array_equal(got[n], want[n])
        assert got["frontend_embeds"].shape == (2, 3, 4, 4, 64)
        if cfg_t.rope == "mrope":
            assert got["mrope_pos"].shape == (2, 3, 3, 4, SEQ)
        assert next(td)["tokens"].shape == (2, 3, 4, SEQ)
    finally:
        jd.close()
        td.close()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve_inputs(cfg, eng, seed=0):
    mbg = eng.microbatch * eng.data_size
    lead = (eng.n_trials, eng.n_microbatches)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    lead + (mbg, SEQ)).astype(np.int32),
             "frontend_embeds": rng.standard_normal(
                 lead + (mbg, cfg.n_frontend_tokens,
                         cfg.d_model)).astype(np.float32)}
    if cfg.rope == "mrope":
        batch["mrope_pos"] = _grid(cfg, lead, mbg, SEQ)
    return batch


@pytest.mark.parametrize("name", [QWEN, MUSICGEN])
def test_serve_steps_match_reference_and_oracle(name):
    cfg_j, cfg_t = jget(name).reduced(), tget(name).reduced()
    max_seq, n_dec = 24, 4
    kw = dict(n_trials=1, n_microbatches=2, microbatch=1, n_stages=2,
              data_size=2, max_seq=max_seq)
    eng_j = jpl.EngineConfig(cache_dtype=jnp.float32, **kw)
    eng_t = tpl.EngineConfig(cache_dtype=torch.float32, **kw)
    params = jpl.init_trial_params(cfg_j, eng_j, jplan(cfg_j, 2),
                                   jax.random.PRNGKey(0), max_pos=max_seq)
    pt = params_from_numpy(jax.tree.map(np.asarray, params))
    batch = _serve_inputs(cfg_t, eng_t)
    mesh = make_test_mesh(2, 2)
    pre_j = jpl.make_serve_step(cfg_j, JOpts(), eng_j, mesh, "prefill")
    dec_j = jpl.make_serve_step(cfg_j, JOpts(), eng_j, mesh, "decode")
    pre_t = tpl.make_serve_step(cfg_t, TOpts(), eng_t, "prefill")
    dec_t = tpl.make_serve_step(cfg_t, TOpts(), eng_t, "decode")
    cache_j = jpl.serve_cache_struct(cfg_j, eng_j, dry_run=False)
    cache_t = tpl.serve_cache_struct(cfg_t, eng_t, device="cpu")
    cache_j, tok_j, _ = pre_j(params, cache_j,
                              {n: jnp.asarray(v) for n, v in batch.items()})
    cache_t, tok_t, _ = pre_t(pt, cache_t, {n: torch.from_numpy(v)
                                            for n, v in batch.items()})
    toks = [tok_t.numpy()]
    for i in range(n_dec):
        np.testing.assert_array_equal(np.asarray(tok_j), toks[-1])
        pos = np.full(toks[-1].shape, SEQ + i, np.int32)
        cache_j, tok_j, _ = dec_j(params, cache_j, {
            "tokens": jnp.asarray(toks[-1][..., None]),
            "positions": jnp.asarray(pos)})
        cache_t, tok_t, _ = dec_t(pt, cache_t, {
            "tokens": torch.from_numpy(toks[-1][..., None]),
            "positions": torch.from_numpy(pos)})
        toks.append(tok_t.numpy())
    np.testing.assert_array_equal(np.asarray(tok_j), toks[-1])
    for n, buf in cache_t["layers"].items():
        assert _err(cache_j["layers"][n], buf) < 2e-5, n
    # the single-device oracle on row (m, r): the same embeddings and
    # positions, prefill then decode
    p1 = tlm.layer_slice(pt, 0)
    p1 = dict(p1, embed=dict(p1["embed"],
                             tok=p1["embed"]["tok"][:cfg_t.vocab_size]),
              head=p1["head"][:, :cfg_t.vocab_size])
    gen = np.stack(toks, axis=-1)[0]  # (M, mbg, 1 + n_dec)
    for m in range(2):
        sub = {n: torch.from_numpy(v[0, m]) for n, v in batch.items()}
        cache = tlm.init_cache(cfg_t, 2, max_seq, cache_dtype=torch.float32,
                               n_layers=tlm.n_stacked_layers(p1["layers"]))
        with torch.no_grad():
            logits, cache, _ = tlm.forward(cfg_t, TOpts(), p1, sub,
                                           mode="prefill", cache=cache)
            want = [logits[:, -1].argmax(-1)]
            for i in range(n_dec):
                logits, cache, _ = tlm.forward(
                    cfg_t, TOpts(), p1, {"tokens": want[-1][:, None]},
                    mode="decode", cache=cache,
                    kv_offset=torch.full((2,), SEQ + i, dtype=torch.int32))
                want.append(logits[:, 0].argmax(-1))
        np.testing.assert_array_equal(gen[m], torch.stack(want, -1).numpy())


def test_engines_refuse_frontend_archs():
    for name in (MUSICGEN, QWEN):
        cfg = tget(name).reduced()
        eng = tpl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=1,
                               n_stages=2, max_seq=24,
                               cache_dtype=torch.float32)
        params = tpl.init_trial_params(cfg, eng, tpl.plan_stages(cfg, 2),
                                       torch.Generator(), max_pos=24)
        with pytest.raises(ValueError, match="text-only"):
            TEngine(cfg, eng, params, TOpts(), device="cpu")
        req = TRequest(0, np.zeros(8, np.int32), 2)
        with pytest.raises(ValueError, match="make_serve_step"):
            tstatic(cfg, eng, params, [req], TOpts(), device="cpu")
    qwen = tget(QWEN).reduced()
    eng = tpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=1,
                           n_stages=1, max_seq=24)
    for mode in ("append", "mixed", "verify"):
        with pytest.raises(ValueError, match="mrope"):
            tpl.make_serve_step(qwen, TOpts(), eng, mode)
    with pytest.raises(ValueError, match="mlp"):
        tpl.make_serve_step(tget("mlp-1m"), TOpts(), eng, "decode")
    with pytest.raises(ValueError, match="mlp_init"):
        tlm.init_params(tget("mlp-1m"), torch.Generator())


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [BERT, MUSICGEN])
def test_train_launcher_runs(name, capsys):
    train_launcher.main(["--arch", name, "--smoke", "--trials", "2",
                         "--steps", "2", "--n-model", "2", "--n-data", "2",
                         "--n-microbatches", "2", "--seq-len", "16",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"best_trial"' in out and "nan" not in out.lower()


def test_serve_launcher_runs_bert_and_refuses_musicgen(capsys):
    serve_launcher.main(["--arch", BERT, "--smoke", "--paged",
                         "--paged-kernel", "--n-model", "2", "--slots", "2",
                         "--n-requests", "4", "--rate", "2.0",
                         "--prompt-len", "8", "--gen-len", "4",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "continuous/paged+kernel: 4 requests" in out
    common = ["--arch", MUSICGEN, "--smoke", "--n-model", "2", "--slots",
              "2", "--prompt-len", "8", "--gen-len", "4", "--device", "cpu"]
    with pytest.raises(SystemExit, match="make_serve_step"):
        serve_launcher.main(common + ["--static"])
    with pytest.raises(ValueError, match="text-only"):
        serve_launcher.main(common)
