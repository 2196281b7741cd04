"""PyTorch port — the dry-run and its analysis against the JAX reference:

* the shape cells: ``SHAPES``, ``shape_applicable`` (reasons word for
  word) and ``input_specs`` (keys, shapes, dtypes: meta tensors in the
  port) for every arch × shape;
* ``engine_for_cell`` equal to the reference's field for field (bar the
  two fields the port does not carry, ``skip_bubbles`` and
  ``layer_remat``) for every arch × shape at 16×16 and 2×16×16, with and
  without ``--set`` overrides, when both hold a stage to the same budget
  and count the same bytes per parameter (monkeypatch, as in
  ``test_torch_hydra.py``). The reference's module rewrites ``XLA_FLAGS``
  to 512 host devices when imported, so the fixture fixes this process's
  JAX devices first and restores the variable;
* ``trial_params_struct``: the reference's leaves, shapes and dtypes for
  every arch at S = 16, on ``meta``;
* the loop-aware count: the extrapolation over microbatches, layers (and
  a hybrid's shared sites) and sequence units equals a direct count at a
  third point, exactly;
* the counted matmul FLOPs of a reduced chatglm3-6b prefill cell and a
  reduced train cell against ``hlo.analyze(compiled.as_text()).flops`` of
  the reference's compiled step on a 1×1 test mesh: exactly equal (S = 1
  has no bubble ticks, whose garbage work the reference would count);
* the roofline row from known costs (H100 constants), and
  ``model_flops_for_cell`` equal to the reference's;
* the kernel wrappers refuse ``meta`` tensors with a reason, and the
  dry-run with ``use_flash_kernel=1`` writes the cell's ``.err`` with it;
* an engine with production-layout fields is refused by the steps;
* ``python -m repro_torch.launch.dryrun`` on the CPU writes a card row
  (``decode_32k``) and production rows without per-device numbers.
"""
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro.configs import ASSIGNED_ARCHS as JARCHS
from repro.configs import PAPER_ARCHS as JPAPER
from repro.configs import SHAPES as JSHAPES
from repro.configs import input_specs as jinput_specs
from repro.configs import shape_applicable as japplicable
from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro.core.partitioner import plan_stages as jplan
from repro.launch.mesh import make_test_mesh
from repro.models.layers import ModelOptions as JOpts
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.analysis import costs
from repro_torch.analysis import roofline as troof
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, SHAPES
from repro_torch.configs import input_specs, shape_applicable
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched
from repro_torch.core.partitioner import plan_stages
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_card_mesh

ARCHS = list(ASSIGNED_ARCHS) + ["bert-large"]
REF_BYTES = {"param_bytes": 2, "opt_bytes_per_param": 12}


def jcfg(name):
    return (JARCHS | JPAPER)[name]


def tcfg(name):
    return (ASSIGNED_ARCHS | PAPER_ARCHS)[name]


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported without letting its
    XLA_FLAGS rewrite reach this process's JAX (devices fixed first) or
    any later process (the variable restored)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _dtype_name(dt):
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


# ---------------------------------------------------------------------------
# shape cells
# ---------------------------------------------------------------------------


def test_shapes_match_reference():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(JSHAPES[name])
        assert s.tokens_per_step == JSHAPES[name].tokens_per_step


@pytest.mark.parametrize("arch", ARCHS + ["mlp-1m"])
def test_applicability_and_input_specs_match_reference(arch):
    for name in SHAPES:
        assert shape_applicable(tcfg(arch), SHAPES[name]) == \
            japplicable(jcfg(arch), JSHAPES[name])
        t = input_specs(tcfg(arch), SHAPES[name])
        j = jinput_specs(jcfg(arch), JSHAPES[name])
        assert list(t) == list(j)
        for key in j:
            assert t[key].device.type == "meta"
            assert tuple(t[key].shape) == tuple(j[key].shape), key
            assert _dtype_name(t[key].dtype) == _dtype_name(j[key].dtype)


# ---------------------------------------------------------------------------
# engine_for_cell
# ---------------------------------------------------------------------------

OVERRIDES = [{}, {"microbatch": "2", "fsdp": "0"},
             {"prefill_chunks": "4", "vocab_parallel": "0"},
             {"max_trials": "2"}, {"n_trials": "3"}]


def _stand_in(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_engine_for_cell_matches_reference(jdry, monkeypatch, multi_pod):
    layout = dryrun.make_production_mesh(multi_pod=multi_pod)
    monkeypatch.setattr(tsched, "HBM_BYTES_PER_CHIP",
                        jsched.HBM_BYTES_PER_CHIP * layout["model"])
    monkeypatch.setattr(tsched, "state_bytes", lambda dtype: REF_BYTES)
    dropped = {f.name for f in dataclasses.fields(jpl.EngineConfig)} - \
        {f.name for f in dataclasses.fields(tpl.EngineConfig)}
    assert dropped == {"skip_bubbles", "layer_remat"}
    for arch in ARCHS:
        for shape in SHAPES:
            for ov in OVERRIDES:
                t = dryrun.engine_for_cell(tcfg(arch), SHAPES[shape], layout,
                                           ov)
                j = jdry.engine_for_cell(jcfg(arch), JSHAPES[shape],
                                         _stand_in(layout), ov)
                for f in dataclasses.fields(t):
                    a, b = getattr(t, f.name), getattr(j, f.name)
                    if f.name == "cache_dtype":
                        a, b = _dtype_name(a), _dtype_name(b)
                    assert a == b, (arch, shape, ov, f.name, a, b)


# ---------------------------------------------------------------------------
# trial_params_struct
# ---------------------------------------------------------------------------


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: (tuple(tree.shape), _dtype_name(tree.dtype))}


@pytest.mark.parametrize("arch", ARCHS)
def test_trial_params_struct_matches_reference(arch):
    kw = dict(n_trials=2, n_microbatches=1, microbatch=1, n_stages=16)
    ej, et = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    max_pos = 4096 if tcfg(arch).rope == "learned" else 0
    j = jpl.trial_params_struct(jcfg(arch), ej, jplan(jcfg(arch), 16),
                                max_pos=max_pos)
    t = tpl.trial_params_struct(tcfg(arch), et, plan_stages(tcfg(arch), 16),
                                max_pos=max_pos)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path):
              (tuple(leaf.shape), _dtype_name(leaf.dtype))
              for path, leaf in jax.tree_util.tree_flatten_with_path(j)[0]}
    flat_t = _flat_torch(t)
    assert flat_t == flat_j
    assert all(leaf.is_meta for leaf in jax.tree_util.tree_leaves(
        t, is_leaf=lambda x: isinstance(x, torch.Tensor)))


# ---------------------------------------------------------------------------
# the loop-aware count
# ---------------------------------------------------------------------------

# (arch, reduced depth, shape, seq, global batch, overrides): each target
# lies off the count points (a third M, a depth past them, a sequence of
# 8 units)
EXTRAPOLATION_CASES = [
    ("chatglm3-6b", 4, "train_4k", 64, 3, {"max_trials": "1"}),
    ("falcon-mamba-7b", 3, "decode_32k", 128, 3, {}),
    ("zamba2-7b", 7, "decode_32k", 128, 3, {}),
    ("granite-moe-3b-a800m", 3, "prefill_32k", 64, 3, {}),
    ("chatglm3-6b", 1, "prefill_32k", 8192, 3, {}),
]


@pytest.mark.parametrize("case", range(len(EXTRAPOLATION_CASES)))
def test_loop_aware_count_is_exact(case):
    arch, depth, shape, seq, batch, ov = EXTRAPOLATION_CASES[case]
    cfg = dataclasses.replace(tcfg(arch).reduced(), n_layers=depth)
    shp = dataclasses.replace(SHAPES[shape], seq_len=seq, global_batch=batch)
    eng = dryrun.engine_for_cell(cfg, shp, make_card_mesh(), ov)
    opts = dryrun.model_options(ov)
    points, _ = dryrun.count_points(cfg, shp, opts)
    target = (eng.n_microbatches, depth, seq)
    assert target not in points and eng.n_microbatches == 3
    got = dryrun.cell_costs(cfg, shp, eng, opts)
    want = dryrun.count_at(cfg, shp, eng, opts, *target)
    assert got.scalars() == want.scalars()
    assert got.flops > 0 and got.hbm_bytes > 0
    assert got.collective_bytes == 0
    assert got.trip_counts[0]["target"] == list(target)


# ---------------------------------------------------------------------------
# counted FLOPs against the reference's compiled HLO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_matmul_flops_match_reference_hlo(jdry, monkeypatch, shape):
    """A reduced chatglm3-6b cell (seq 64, 2 rows) on a 1×1 mesh: the
    port's counted FLOPs (forward, backward and both remat recomputes in
    training) equal the matmul FLOPs of the reference's compiled step."""
    monkeypatch.setattr(tsched, "HBM_BYTES_PER_CHIP",
                        jsched.HBM_BYTES_PER_CHIP)
    monkeypatch.setattr(tsched, "state_bytes", lambda dtype: REF_BYTES)
    cj = jcfg("chatglm3-6b").reduced()
    ct = tcfg("chatglm3-6b").reduced()
    sj = dataclasses.replace(JSHAPES[shape], seq_len=64, global_batch=2)
    st = dataclasses.replace(SHAPES[shape], seq_len=64, global_batch=2)
    mesh = make_test_mesh(1, 1)
    ov = {"max_trials": "2"}
    ej = jdry.engine_for_cell(cj, sj, mesh, ov)
    et = dryrun.engine_for_cell(ct, st, make_card_mesh(), ov)
    assert (ej.n_trials, ej.n_microbatches) == (et.n_trials,
                                                et.n_microbatches)
    opts_j = JOpts(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                   remat=True, attn_q_chunk=1024, attn_kv_chunk=512,
                   moe_expert_chunk=4)
    optimizer = JAdamW(grad_clip=1.0)
    structs = jdry.cell_structs(cj, sj, ej, mesh, optimizer)
    if shape == "train_4k":
        fn = jpl.make_train_step(cj, opts_j, ej, mesh, optimizer, jit=False)
        lowered = jax.jit(fn).lower(structs["params"], structs["opt"],
                                    structs["batch"], structs["hparams"],
                                    structs["step"])
    else:
        fn = jpl.make_serve_step(cj, opts_j, ej, mesh, "prefill", jit=False)
        lowered = jax.jit(fn).lower(structs["params"], structs["cache"],
                                    structs["batch"])
    ref = jhlo.analyze(lowered.compile().as_text()).flops
    got = dryrun.count_at(ct, st, et, dryrun.model_options(ov),
                          et.n_microbatches, ct.n_layers, st.seq_len)
    assert got.flops == ref > 0, (got.flops, ref, got.flops / ref)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_model_flops_match_reference():
    for arch in ARCHS + ["mlp-1m"]:
        for name in SHAPES:
            for k in (1, 3):
                assert troof.model_flops_for_cell(tcfg(arch), SHAPES[name],
                                                  k) == \
                    jroof.model_flops_for_cell(jcfg(arch), JSHAPES[name], k)


def test_roofline_row_from_known_costs():
    cfg, shape = tcfg("chatglm3-6b"), SHAPES["prefill_32k"]
    c = costs.Costs(flops=989 * 10 ** 12, hbm_bytes=335 * 10 ** 10)
    row = troof.from_costs(cfg, shape, "card", 1, c).row()
    assert row["compute_s"] == 1.0 and row["memory_s"] == 1.0
    assert row["collective_s"] == 0.0 and row["dominant"] == "compute"
    model = jroof.model_flops_for_cell(jcfg("chatglm3-6b"),
                                       JSHAPES["prefill_32k"])
    assert row["model_flops"] == model
    assert row["useful_ratio"] == model / c.flops
    assert row["roofline_fraction"] == pytest.approx(model / 989e12)
    fp32 = troof.from_costs(cfg, shape, "card", 1, c, dtype=torch.float32)
    assert fp32.compute_s == 989e12 / 67e12 and fp32.dominant == "compute"
    mem = troof.from_costs(cfg, shape, "card", 1,
                           costs.Costs(flops=1, hbm_bytes=67 * 10 ** 12))
    assert mem.dominant == "memory" and mem.memory_s == 20.0
    table = troof.format_table([row])
    assert "chatglm3-6b" in table and "compute" in table
    assert set(jroof.Roofline(
        "a", "s", "m", 1, 1.0, 1.0, 0.0, 1.0, 1.0, {}).row()) - set(row) \
        == {"hlo_flops_device"}


def test_kernel_work_formulas():
    """The bounds' formulas: K1's pairs in closed form equal the loop's."""
    for sq, sk, causal, window, off in ((2048, 2048, True, 0, 0),
                                        (33, 33, True, 0, 0),
                                        (128, 128, True, 24, 0),
                                        (16, 48, True, 0, 32),
                                        (100, 100, False, 0, 0)):
        loop = 0
        for i in range(sq):
            qpos = i + off
            hi = min(sk, qpos + 1) if causal else sk
            lo = max(0, qpos - window + 1) if window else 0
            loop += max(0, hi - lo)
        assert costs.flash_pairs(sq, sk, causal, window, off) == loop
    q = torch.empty(1, 2048, 32, 128, device="meta")
    k = torch.empty(1, 2048, 2, 128, device="meta")
    nbytes, ops_n, pairs = costs.flash_work(q, k, k)
    assert pairs == 2048 * 2049 // 2 and ops_n == 4 * 128 * 32 * pairs
    assert nbytes == 4 * (2 * q.numel() + 2 * k.numel())
    da = torch.empty(2, 512, 8192, 16, device="meta")
    nbytes, ops_n = costs.scan_work(da, da, torch.empty(2, 512, 16,
                                                        device="meta"),
                                    torch.empty(2, 8192, 16, device="meta"))
    assert ops_n == 4 * 2 * 512 * 8192 * 16
    assert costs.bound_s(3.35e12, 1, torch.float32) == (1.0, "bytes")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_meta_tensors():
    meta = lambda *s: torch.zeros(s, device="meta")
    with pytest.raises(ValueError, match="meta tensor"):
        ops.flash_attention(meta(1, 8, 4, 16), meta(1, 8, 2, 16),
                            meta(1, 8, 2, 16))
    with pytest.raises(ValueError, match="meta tensor"):
        ops.paged_attention(meta(1, 1, 4, 16), meta(4, 16, 2, 16),
                            meta(4, 16, 2, 16),
                            torch.zeros(1, 2, dtype=torch.int32,
                                        device="meta"),
                            torch.zeros(1, dtype=torch.int32, device="meta"),
                            torch.ones(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="meta tensor"):
        ops.mamba_scan(meta(1, 4, 8, 4), meta(1, 4, 8, 4), meta(1, 4, 4),
                       meta(1, 8, 4))


def test_dryrun_with_flash_kernel_on_meta_writes_the_reason(tmp_path):
    dryrun.main(["--arch", "chatglm3-6b", "--shape", "prefill_32k",
                 "--layout", "card", "--set", "use_flash_kernel=1",
                 "--out", str(tmp_path)])
    path = tmp_path / "card" / "baseline" / "chatglm3-6b__prefill_32k.json"
    assert not path.exists()
    err = (tmp_path / "card" / "baseline"
           / "chatglm3-6b__prefill_32k.json.err").read_text()
    assert "flash_attention_kernel got a meta tensor" in err


def test_steps_refuse_production_layout_fields():
    cfg = tcfg("chatglm3-6b").reduced()
    kw = dict(n_trials=1, n_microbatches=1, microbatch=1, n_stages=1)
    for bad in (dict(pod_size=2, pod_axis="pod"),
                dict(data_size=2, fsdp=True),
                dict(data_size=2, batch_replicated=True)):
        eng = tpl.EngineConfig(**kw, **bad)
        with pytest.raises(ValueError, match="one card"):
            tpl.make_train_step(cfg, dryrun.model_options({}), eng,
                                dryrun.AdamW())
        with pytest.raises(ValueError, match="one card"):
            tpl.make_serve_step(cfg, dryrun.model_options({}), eng, "decode")
    # over one data row FSDP changes nothing: the card layout's engine runs
    tpl.make_train_step(cfg, dryrun.model_options({}),
                        tpl.EngineConfig(**kw, fsdp=True), dryrun.AdamW())


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_cli_writes_card_and_production_rows(tmp_path):
    dryrun.main(["--arch", "chatglm3-6b", "--shape", "decode_32k",
                 "--layout", "card", "--out", str(tmp_path)])
    row = json.loads((tmp_path / "card" / "baseline"
                      / "chatglm3-6b__decode_32k.json").read_text())
    assert row["mesh"] == "card" and row["layout"] == make_card_mesh()
    assert row["engine"]["n_microbatches"] == "128"
    assert row["roofline"]["dominant"] == "memory"
    assert row["costs"]["flops"] > 0 and row["costs"]["collective_bytes"] == 0
    assert row["fits_card"] is (row["modeled_bytes_per_device"]
                                < row["card_bytes"])
    assert not any("16GB" in key for key in row)
    dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "train_4k",
                 "--both-meshes", "--out", str(tmp_path)])
    for name in ("16x16", "2x16x16"):
        row = json.loads((tmp_path / name / "baseline"
                          / "falcon-mamba-7b__train_4k.json").read_text())
        assert row["per_device"].startswith("not measured")
        assert "roofline" not in row and "costs" not in row
        assert row["modeled_bytes_per_device"] > 0
    dryrun.main(["--arch", "chatglm3-6b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    row = json.loads((tmp_path / "16x16" / "baseline"
                      / "chatglm3-6b__long_500k.json").read_text())
    assert row["skipped"].startswith("pure full-attention arch")


# ---------------------------------------------------------------------------
# on the card: the kernels report their work to an open count
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_report_their_work_on_card(cuda_device):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda_device)
    q, k, v = rnd(1, 64, 4, 16), rnd(1, 64, 2, 16), rnd(1, 64, 2, 16)
    pool_k, pool_v = rnd(8, 16, 2, 16), rnd(8, 16, 2, 16)
    pq = rnd(2, 1, 4, 16)
    tables = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32,
                          device=cuda_device)
    off = torch.tensor([20, 5], dtype=torch.int32, device=cuda_device)
    da = torch.rand(2, 8, 64, 16, generator=gen, device=cuda_device)
    dbx, cm, h0 = rnd(2, 8, 64, 16), rnd(2, 8, 16), rnd(2, 64, 16)
    with costs.count() as c:
        fa.flash_attention_kernel(q, k, v)
        pa.paged_attention_kernel(pq, pool_k, pool_v, tables, off, off + 1)
        ms.mamba_scan_kernel(da, dbx, cm, h0)
        torch.cuda.synchronize()
    assert c.count_by_kind["flash_attention"] == 1
    assert c.flops_by_kind["flash_attention"] == costs.flash_work(q, k, v)[1]
    assert c.flops_by_kind["paged_attention"] == costs.paged_work(
        pq, pool_k, tables, [20, 5], None, 0)[1] == (21 + 6) * 4 * 16 * 4
    assert c.bytes_by_kind["mamba_scan"] == costs.scan_work(da, dbx, cm,
                                                            h0)[0]
