"""PyTorch port — the Mamba1 (ssm) family against the JAX reference on the
same numpy-seeded inputs and weights (carried across with
``params_from_numpy``), fp32 at 2e-5 unless stated:

* ``_causal_conv1d`` with and without an incoming state;
* ``mamba1_mix`` in train / prefill (s not a multiple of the chunk size,
  nonzero incoming states: the chunked scan's masked padding), in decode
  (the s == 1 step), and through its kernel branch (``use_mamba_kernel``:
  the plain version on the CPU); bf16 compute keeps the reference's dtypes;
* the kernel branch against the chunked branch inside the model (2e-4,
  as ``tests/test_kernels_mamba.py::test_mamba_kernel_inside_model``);
* ``ssm_block`` with an in-place cache and a ``write_mask`` that leaves
  the masked row's states untouched;
* ``lm.forward`` prefill then decode on reduced falcon-mamba-7b, logits
  and caches; ``lm.greedy_generate`` against the reference's oracle;
* init: shapes and dtypes equal the reference's, and ``dt_bias`` /
  ``A_log`` / ``D`` stay fp32 under bf16 parameters, through
  ``params_from_numpy`` and ``init_trial_params`` alike."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core.partitioner import plan_stages as jplan
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.layers import ModelOptions as JOpts
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.core.partitioner import plan_stages as tplan
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.tree import tree_items

torch.set_num_threads(2)
TOL = 2e-5
ARCH = "falcon-mamba-7b"
FP32 = ("dt_bias", "A_log", "D")


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _cfgs():
    return jget(ARCH).reduced(), tget(ARCH).reduced()


def _layer(seed=0):
    """One reduced layer's reference parameters (numpy) and the port's."""
    cfg_j, _ = _cfgs()
    p = jlm.init_layer_params(cfg_j, jax.random.PRNGKey(seed), jnp.float32)
    p = jax.tree.map(np.asarray, p)
    return p, tlm.params_from_numpy(p)


def _states(seed, b):
    cfg_j, _ = _cfgs()
    s = cfg_j.ssm
    di = s.d_inner(cfg_j.d_model)
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, di, s.d_state)) * 0.5).astype(np.float32),
            rng.normal(size=(b, s.d_conv - 1, di)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 12)).astype(np.float32)
    w = rng.normal(size=(12, 4)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    yj, nj = JL._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    yt, nt = TL._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               None if st is None else torch.from_numpy(st))
    assert _err(yj, yt) < TOL and _err(nj, nt) < TOL


@pytest.mark.parametrize("s,state,kernel", [
    (19, False, False),  # train: 19 = 2 chunks of 8 + a padded third
    (19, True, False),  # prefill / append from a nonzero state
    (19, True, True),  # the kernel branch (plain version on the CPU)
    (8, True, True),
    (1, True, False),  # decode: one recurrent step
])
def test_mamba1_mix_matches_reference(s, state, kernel):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _layer(1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, cfg_j.d_model)).astype(np.float32)
    ssm, conv = _states(3, 2) if state else (None, None)
    jo, to = (JOpts(use_mamba_kernel=kernel), TOpts(use_mamba_kernel=kernel))
    outs_j = JL.mamba1_mix(
        jax.tree.map(jnp.asarray, pj["mamba"]), jnp.asarray(x), cfg_j,
        None if ssm is None else jnp.asarray(ssm),
        None if conv is None else jnp.asarray(conv), jo)
    outs_t = TL.mamba1_mix(
        pt["mamba"], torch.from_numpy(x), cfg_t,
        None if ssm is None else torch.from_numpy(ssm),
        None if conv is None else torch.from_numpy(conv), to)
    for a, b in zip(outs_j, outs_t):
        assert a.shape == tuple(b.shape)
        assert _err(a, b.detach()) < TOL


def test_mamba1_mix_bf16_keeps_reference_dtypes():
    """bf16 compute: states fp32, y + D cast to bf16 before the gate. The
    two frameworks round bf16 at different places: 3e-2 on the output
    (the bf16 tolerance of tests/test_kernels_mamba.py), 1e-2 on the fp32
    state."""
    cfg_j, cfg_t = _cfgs()
    pj, _ = _layer(4)
    pt = tlm.params_from_numpy(pj, dtype=torch.bfloat16)
    pjb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pj)
    for name in FP32:  # the reference keeps these fp32 under bf16 params
        pjb["mamba"][name] = jnp.asarray(pj["mamba"][name])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 11, cfg_j.d_model)).astype(np.float32)
    ssm, conv = _states(6, 1)
    yj, hj, cj = JL.mamba1_mix(pjb["mamba"], jnp.asarray(x, jnp.bfloat16),
                               cfg_j, jnp.asarray(ssm),
                               jnp.asarray(conv, jnp.bfloat16))
    yt, ht, ct = TL.mamba1_mix(pt["mamba"], torch.from_numpy(x).bfloat16(),
                               cfg_t, torch.from_numpy(ssm),
                               torch.from_numpy(conv).bfloat16())
    assert yt.dtype == torch.bfloat16 and ht.dtype == torch.float32
    assert ct.dtype == torch.bfloat16
    assert _err(yj, yt.float()) < 3e-2 and _err(hj, ht) < 1e-2
    assert _err(cj, ct.float()) < 3e-2


def test_kernel_branch_matches_chunked_inside_model():
    cfg_j, cfg_t = _cfgs()
    p = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tlm.params_from_numpy(jax.tree.map(np.asarray, p))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, (2, 24)).astype(np.int32))
    l1, _, _ = tlm.forward(cfg_t, TOpts(), pt, {"tokens": toks})
    l2, _, _ = tlm.forward(cfg_t, TOpts(use_mamba_kernel=True), pt,
                           {"tokens": toks})
    assert _err(l1.detach(), l2.detach()) < 2e-4


def test_ssm_block_writes_masked_rows_in_place():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _layer(7)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, cfg_j.d_model)).astype(np.float32)
    ssm, conv = _states(9, 2)
    yj, cj, _ = JB.ssm_block(
        cfg_j, JOpts(), jax.tree.map(jnp.asarray, pj), jnp.asarray(x),
        pos=None, cache={"ssm": jnp.asarray(ssm), "conv": jnp.asarray(conv)},
        mode="append")
    cache = {"ssm": torch.from_numpy(ssm.copy()),
             "conv": torch.from_numpy(conv.copy())}
    views = dict(cache)
    yt, ct, _ = TB.ssm_block(cfg_t, TOpts(), pt, torch.from_numpy(x), pos=None,
                             cache=cache, mode="append",
                             write_mask=torch.tensor([True, False]))
    assert _err(yj, yt) < TOL
    for n in ("ssm", "conv"):
        assert ct[n] is views[n]  # updated in place
        assert _err(cj[n][0], ct[n][0]) < TOL  # the writing row: new state
        np.testing.assert_array_equal(ct[n][1].numpy(),
                                      (ssm if n == "ssm" else conv)[1])


def test_forward_prefill_then_decode_matches_reference():
    cfg_j, cfg_t = _cfgs()
    p = jlm.init_params(cfg_j, jax.random.PRNGKey(2))
    pt = tlm.params_from_numpy(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 13)).astype(np.int32)
    cj = jlm.init_cache(cfg_j, 2, 32, cache_dtype=jnp.float32)
    ct = tlm.init_cache(cfg_t, 2, 32, cache_dtype=torch.float32)
    lj, cj, _ = jlm.forward(cfg_j, JOpts(), p, {"tokens": jnp.asarray(toks)},
                            mode="prefill", cache=cj)
    lt, ct, _ = tlm.forward(cfg_t, TOpts(), pt,
                            {"tokens": torch.from_numpy(toks)}, mode="prefill",
                            cache=ct)
    assert _err(lj, lt) < TOL
    for t in range(3):
        nxt = np.array(jnp.argmax(lj[:, -1], -1), np.int32)[:, None]
        off = np.full((2,), 13 + t, np.int32)
        lj, cj, _ = jlm.forward(cfg_j, JOpts(), p,
                                {"tokens": jnp.asarray(nxt)}, mode="decode",
                                cache=cj,
                                kv_offset=jnp.asarray(off))
        lt, ct, _ = tlm.forward(cfg_t, TOpts(), pt,
                                {"tokens": torch.from_numpy(nxt)}, mode="decode",
                                cache=ct, kv_offset=torch.from_numpy(off))
        assert _err(lj, lt) < TOL
    for n in ("ssm", "conv"):
        assert ct["layers"][n].dtype == torch.float32
        assert _err(cj["layers"][n], ct["layers"][n]) < TOL


def test_greedy_generate_on_ssm_matches_reference_oracle():
    """The serving oracle reads the stack depth from any layer leaf (an
    ssm layer has ``ln``, not ``ln1``)."""
    cfg_j, cfg_t = _cfgs()
    p = jlm.init_params(cfg_j, jax.random.PRNGKey(4), n_layers=5)
    pt = tlm.params_from_numpy(jax.tree.map(np.asarray, p))
    prompt = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, (9,)).astype(np.int32)
    cache = jlm.init_cache(cfg_j, 1, 16, cache_dtype=jnp.float32, n_layers=5)
    logits, cache, _ = jlm.forward(cfg_j, JOpts(), p,
                                   {"tokens": jnp.asarray(prompt[None])},
                                   mode="prefill", cache=cache)
    want = [int(jnp.argmax(logits[0, -1]))]
    for t in range(4):
        logits, cache, _ = jlm.forward(
            cfg_j, JOpts(), p, {"tokens": jnp.asarray([[want[-1]]])},
            mode="decode", cache=cache, kv_offset=jnp.asarray([9 + t]))
        want.append(int(jnp.argmax(logits[0, 0])))
    got = tlm.greedy_generate(cfg_t, TOpts(), pt, prompt, 5, 16,
                              torch.float32)
    assert got == want


def _shapes_dtypes(tree, items):
    return {path: (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
            for path, leaf in items(tree)}


def test_init_shapes_and_dtypes_match_reference():
    cfg_j, cfg_t = _cfgs()
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.bfloat16,
                         n_layers=6)
    pt = tlm.init_params(cfg_t, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, n_layers=6)
    jitems = lambda t: [(jax.tree_util.keystr(k, simple=True, separator="/"),
                         v) for k, v in jax.tree_util.tree_leaves_with_path(t)]
    assert _shapes_dtypes(pt, tree_items) == _shapes_dtypes(pj, jitems)
    m = pt["layers"]["mamba"]
    n = cfg_t.ssm.d_state
    assert torch.equal(m["A_log"][0, 0],
                       torch.log(torch.arange(1, n + 1).float()))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


def test_fp32_leaves_survive_bf16_params():
    """``params_from_numpy(..., dtype=bf16)`` and bf16 ``init_trial_params``
    keep the reference's fp32 SSM leaves fp32 and cast the rest."""
    cfg_j, cfg_t = _cfgs()
    p = jax.tree.map(np.asarray, jlm.init_params(cfg_j, jax.random.PRNGKey(0)))
    pt = tlm.params_from_numpy(p, dtype=torch.bfloat16)
    eng = tpl.EngineConfig(n_trials=2, n_microbatches=1, microbatch=1,
                           n_stages=2)
    trial = tpl.init_trial_params(cfg_t, eng, tplan(cfg_t, 2),
                                  torch.Generator().manual_seed(0),
                                  dtype=torch.bfloat16)
    ejp = jpl.EngineConfig(n_trials=2, n_microbatches=1, microbatch=1,
                           n_stages=2)
    trial_j = jpl.init_trial_params(cfg_j, ejp, jplan(cfg_j, 2),
                                    jax.random.PRNGKey(0),
                                    dtype=jnp.bfloat16)
    for tree in (pt, trial):
        for path, leaf in tree_items(tree):
            name = path.rsplit("/", 1)[-1]
            want = torch.float32 if name in FP32 else torch.bfloat16
            assert leaf.dtype == want, (path, leaf.dtype)
    for name in FP32:
        assert trial_j["layers"]["mamba"][name].dtype == jnp.float32
    assert torch.equal(pt["layers"]["mamba"]["dt_bias"],
                       torch.from_numpy(np.array(p["layers"]["mamba"]
                                                 ["dt_bias"])))
