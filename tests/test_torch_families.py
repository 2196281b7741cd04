"""PyTorch port — the remaining model families (the dense configs
yi-34b, deepseek-67b and starcoder2-15b; the audio and vision backbones
musicgen-medium and qwen2-vl-72b; the encoder bert-large) against the JAX
reference, reduced, on the same weights (``params_from_numpy``) and
numpy-seeded inputs, on the CPU:

* ``lm.forward`` logits and ``lm.loss_fn`` within 1e-4 (fp32; musicgen
  with frontend embeddings, qwen2-vl with frontend embeddings and grid
  M-RoPE positions whose three streams differ over the image);
* prefill then decode against the train-mode logits within 5e-4 (the
  reference's ``tests/test_models_smoke.py`` check) for the causal archs;
* ``apply_rope`` in its ``"mrope"`` form within 2e-5, at qwen2-vl-72b's
  head_dim 128 (16 temporal, 24 height and 24 width pairs) and reduced;
* learned positions past the table: the vocab-parallel embedding adds
  zero there, the plain one the last row, each as the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.launch.mesh import make_test_mesh
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.layers import ModelOptions as JOpts
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models.frontend import grid_mrope_positions
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.lm import params_from_numpy

torch.set_num_threads(2)
ARCHS = ["yi-34b", "deepseek-67b", "starcoder2-15b", "musicgen-medium",
         "qwen2-vl-72b", "bert-large"]
B, S = 2, 16


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _batch(cfg, s=S, seed=0):
    """numpy batch: tokens, labels, and the arch's frontend embeddings /
    grid M-RoPE positions."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
        np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.rope == "mrope":
        batch["mrope_pos"] = grid_mrope_positions(cfg, B, s).numpy().astype(
            np.int32)
    return batch


def _models(name):
    cfg_j, cfg_t = jget(name).reduced(), tget(name).reduced()
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0), max_pos=64)
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def test_grid_positions_differ_between_sections():
    """The grid layout the M-RoPE checks use really drives the three
    streams apart (text-style positions would reduce M-RoPE to 1-D
    RoPE)."""
    pos = grid_mrope_positions(tget("qwen2-vl-72b"), 1, 320)[:, 0]
    assert pos.shape == (3, 320)
    assert (pos[0, :256] == 0).all() and int(pos[1, :256].max()) == 15
    assert not torch.equal(pos[1], pos[2])
    assert torch.equal(pos[0, 256:], torch.arange(16, 80))
    assert torch.equal(pos[0, 256:], pos[2, 256:])


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_loss_match_reference(name):
    cfg_j, cfg_t, pj, pt = _models(name)
    batch = _batch(cfg_j)
    jb = {n: jnp.asarray(v) for n, v in batch.items()}
    tb = {n: torch.from_numpy(v) for n, v in batch.items()}
    want, _, _ = jlm.forward(cfg_j, JOpts(), pj, jb, mode="train")
    with torch.no_grad():
        got, _, _ = tlm.forward(cfg_t, TOpts(), pt, tb, mode="train")
        loss = tlm.loss_fn(cfg_t, TOpts(), pt, tb)
    assert got.shape == (B, S, cfg_t.vocab_size)
    assert _err(want, got) < 1e-4
    assert _err(jlm.loss_fn(cfg_j, JOpts(), pj, jb), loss) < 1e-4
    if cfg_t.frontend:  # the frontend rows really enter the model
        tb2 = dict(tb, frontend_embeds=tb["frontend_embeds"] + 1.0)
        with torch.no_grad():
            other, _, _ = tlm.forward(cfg_t, TOpts(), pt, tb2, mode="train")
        assert _err(other, got) > 1e-3


@pytest.mark.parametrize("name", [n for n in ARCHS if n != "bert-large"])
def test_prefill_decode_matches_train_logits(name):
    """Prefill the first 8 tokens, decode the rest one at a time: each
    step's logits equal the train-mode logits at that position (5e-4, the
    reference's check), and the train-mode logits equal the reference's."""
    cfg_j, cfg_t, pj, pt = _models(name)
    batch = _batch(cfg_t)
    if cfg_t.rope == "mrope":  # decode turns every stream by the depth
        batch["mrope_pos"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    tb = {n: torch.from_numpy(v) for n, v in batch.items() if n != "labels"}
    jb = {n: jnp.asarray(v) for n, v in batch.items() if n != "labels"}
    want, _, _ = jlm.forward(cfg_j, JOpts(), pj, jb, mode="train")
    sp = 8
    pre = {"tokens": tb["tokens"][:, :sp]}
    if cfg_t.frontend:
        pre["frontend_embeds"] = tb["frontend_embeds"]
    if cfg_t.rope == "mrope":
        pre["mrope_pos"] = tb["mrope_pos"][:, :, :sp]
    with torch.no_grad():
        full, _, _ = tlm.forward(cfg_t, TOpts(), pt, tb, mode="train")
        cache = tlm.init_cache(cfg_t, B, 32, cache_dtype=torch.float32)
        logits, cache, _ = tlm.forward(cfg_t, TOpts(), pt, pre,
                                       mode="prefill", cache=cache)
        errs = [_err(logits, full[:, :sp])]
        for t in range(sp, S):
            ld, cache, _ = tlm.forward(
                cfg_t, TOpts(), pt, {"tokens": tb["tokens"][:, t:t + 1]},
                mode="decode", cache=cache,
                kv_offset=torch.full((B,), t, dtype=torch.int32))
            errs.append(_err(ld[:, 0], full[:, t]))
    assert max(errs) < 5e-4, errs
    assert _err(want, full) < 1e-4


@pytest.mark.parametrize("reduced", [False, True])
def test_mrope_matches_reference(reduced):
    """``apply_rope`` with rope="mrope" on grid positions (image patches
    at t 0 and their (h, w) cells, then text), within 2e-5."""
    cfg_j, cfg_t = jget("qwen2-vl-72b"), tget("qwen2-vl-72b")
    if reduced:
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    s = cfg_t.n_frontend_tokens + 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, s, 3, cfg_t.head_dim)).astype(np.float32)
    pos = grid_mrope_positions(cfg_t, 2, s)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos.numpy()), cfg_j)
    got = TL.apply_rope(torch.from_numpy(x), pos, cfg_t)
    assert _err(want, got) < 2e-5
    # the streams differ, so M-RoPE is not 1-D RoPE at the temporal
    # positions here
    one_d = TL.apply_rope(torch.from_numpy(x), pos[0],
                          dataclasses.replace(cfg_t, rope="1d"))
    assert _err(one_d, got) > 1e-2


@pytest.mark.parametrize("name", ["bert-large", "musicgen-medium"])
def test_learned_positions_past_the_table(name):
    """Positions 0..11 against an 8-row table split over S = 2 stages: the
    vocab-parallel embedding (the reference's inside ``shard_map``) adds
    zero past the table, the plain one clamps to the last row."""
    cfg_j, cfg_t = jget(name).reduced(), tget(name).reduced()
    n_stages, max_pos = 2, 8
    eng_j = jpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=B,
                             n_stages=n_stages)
    eng_t = tpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=B,
                             n_stages=n_stages)
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(1), max_pos=max_pos)
    emb = {"tok": jnp.pad(pj["embed"]["tok"],
                          ((0, eng_j.padded_vocab(cfg_j.vocab_size)
                            - cfg_j.vocab_size), (0, 0))),
           "pos": pj["embed"]["pos"]}
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, 12)).astype(np.int32)
    positions = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12))
    mesh = make_test_mesh(1, n_stages)
    spec = P("model", None)
    vp = jax.jit(shard_map(
        lambda e, t, p: jpl.vp_embed(cfg_j, eng_j, e, t, p, jnp.float32),
        mesh=mesh, in_specs=({"tok": spec, "pos": spec}, P(), P()),
        out_specs=P(), check_vma=False))
    want_vp = vp(emb, jnp.asarray(tokens), jnp.asarray(positions))
    want_plain = jpl.plain_embed(cfg_j, eng_j, emb, jnp.asarray(tokens),
                                 jnp.asarray(positions), jnp.float32)
    te = params_from_numpy(jax.tree.map(np.asarray, emb))
    tt, tp = torch.from_numpy(tokens), torch.from_numpy(positions.copy())
    got_vp = tpl.vp_embed(cfg_t, eng_t, te, tt, tp, torch.float32)
    got_plain = tpl.plain_embed(cfg_t, eng_t, te, tt, tp, torch.float32)
    assert _err(want_vp, got_vp) < 1e-6
    assert _err(want_plain, got_plain) < 1e-6
    # inside the table they agree; past it they differ by the last row
    assert _err(got_vp[:, :max_pos], got_plain[:, :max_pos]) == 0.0
    assert torch.allclose(got_plain[:, max_pos:] - got_vp[:, max_pos:],
                          te["pos"][-1].expand(B, 12 - max_pos, -1),
                          atol=1e-6)
