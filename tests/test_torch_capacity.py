"""PyTorch port — serving capacity planning against the JAX reference.

``scheduler.plan_serve_capacity`` is held to the reference's planner with
the memory passed explicitly, so the two packages' chip constants do not
matter: the port's card holds all S stages and splits ``hbm_bytes`` over
them, so the reference gets ``hbm_bytes / S`` (its per-chip budget of one
stage). Dense and paged plans, traffic mixes, prefix-cache hit rates,
overcommit and host tiers, at full width (the planner is arithmetic on
the configs): every returned field equal. The reference's ``ValueError``
cases, the port's 80 GB default, the trace's deadline stamping, and the
launcher's ``--slots 0`` / ``--expected-hit-rate`` / ``--deadline-slack``
on the CPU."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro.serve import poisson_trace as jtrace
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched
from repro_torch.launch import serve as launcher
from repro_torch.serve import poisson_trace as ttrace

GIB = 1024 ** 3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _engines(n_stages, dtype, data_size=1, microbatch=2, slots=1):
    jdt, tdt = DTYPES[dtype]
    kw = dict(n_trials=1, n_microbatches=slots, microbatch=microbatch,
              n_stages=n_stages, data_size=data_size, max_seq=0)
    return (jpl.EngineConfig(cache_dtype=jdt, **kw),
            tpl.EngineConfig(cache_dtype=tdt, **kw))


def _assert_same_plan(t, j):
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "cache_dtype":
            a, b = str(a).split(".")[-1], jnp.dtype(b).name
        assert a == b, (f.name, a, b)


# (arch, S, data shards, cache dtype, per-stage GiB, max_seq, keywords)
CASES = [
    ("chatglm3-6b", 2, 1, "bfloat16", 16, 4096, {}),
    ("chatglm3-6b", 2, 1, "bfloat16", 9, 4096, {}),
    ("chatglm3-6b", 1, 1, "float32", 24, 2048, {"max_slots": 6}),
    ("chatglm3-6b", 4, 2, "bfloat16", 8, 8192, {"target_bubble": 0.1}),
    ("chatglm3-6b", 2, 1, "bfloat16", 16, 1056,
     {"paged": True, "expected_seq": 600}),
    ("chatglm3-6b", 2, 2, "bfloat16", 9, 4096,
     {"paged": True, "block_size": 32}),
    ("chatglm3-6b", 2, 1, "bfloat16", 40, 1056,
     {"paged": True, "mix": [(3.0, 800), (1.0, 200)]}),
    ("chatglm3-6b", 2, 1, "bfloat16", 16, 1056,
     {"paged": True, "hit_rate": 0.5, "expected_seq": 700}),
    ("chatglm3-6b", 2, 1, "bfloat16", 16, 1056,
     {"paged": True, "overcommit": 1.5, "host_blocks": 256,
      "hit_rate": 0.25}),
    ("chatglm3-6b", 2, 1, "bfloat16", 24, 2048,
     {"mix": [(1.0, 512), (1.0, 1024)]}),
    ("falcon-mamba-7b", 2, 1, "bfloat16", 16, 1056, {}),
    ("falcon-mamba-7b", 1, 1, "bfloat16", 20, 4096, {"max_slots": 128}),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c[:5]) + ("-" + "-".join(sorted(c[6])) if c[6] else ""))
def test_plan_serve_capacity_matches_reference(case):
    arch, s, dp, dtype, gib, max_seq, kw = case
    eng_j, eng_t = _engines(s, dtype, data_size=dp)
    j = jsched.plan_serve_capacity(jget(arch), eng_j, max_seq,
                                   hbm_bytes=gib * GIB, **kw)
    t = tsched.plan_serve_capacity(tget(arch), eng_t, max_seq,
                                   hbm_bytes=gib * GIB * s, **kw)
    _assert_same_plan(t, j)


def test_plan_cases_exercise_both_limits():
    grids = []
    for arch, s, dp, dtype, gib, max_seq, kw in CASES:
        eng = _engines(s, dtype, data_size=dp)[1]
        plan = tsched.plan_serve_capacity(tget(arch), eng, max_seq,
                                          hbm_bytes=gib * GIB * s, **kw)
        grids.append((plan.n_microbatches, kw.get("max_slots", 64)))
    assert any(m == cap for m, cap in grids)  # the slot cap binds
    assert any(1 < m < cap for m, cap in grids)  # memory binds


def test_plan_serve_capacity_errors_and_card_default():
    cfg = tget("chatglm3-6b")
    eng = _engines(2, "bfloat16")[1]
    for kw in ({"hit_rate": 1.0}, {"overcommit": 0.9},
               {"host_blocks": -1, "paged": True}, {"overcommit": 1.5},
               {"host_blocks": 4}, {"mix": []}, {"mix": [(0.0, 10)]}):
        with pytest.raises(ValueError):
            tsched.plan_serve_capacity(cfg, eng, 1024, **kw)
    card = tsched.plan_serve_capacity(cfg, eng, 1056, paged=True)
    assert card == tsched.plan_serve_capacity(
        cfg, eng, 1056, paged=True, hbm_bytes=tsched.HBM_BYTES_PER_CHIP)
    # bf16 weights leave more room for the pool than fp32 ones
    fp32 = tsched.plan_serve_capacity(cfg, eng, 1056, paged=True,
                                      param_dtype=torch.float32,
                                      max_slots=4096)
    bf16 = tsched.plan_serve_capacity(cfg, eng, 1056, paged=True,
                                      max_slots=4096)
    assert bf16.n_blocks > fp32.n_blocks > 0


def test_deadline_stamps_match_reference():
    kw = dict(prompt_lens=(4, 8), gen_lens=(2, 6), seed=5,
              deadline_slack=2.5)
    j, t = jtrace(9, 1.5, 97, **kw), ttrace(9, 1.5, 97, **kw)
    assert [r.deadline for r in t] == [r.deadline for r in j]
    assert all(r.deadline is not None for r in t)


def test_launcher_capacity_plan_and_deadlines_on_cpu(capsys):
    common = ["--arch", "chatglm3-6b", "--smoke", "--n-model", "2",
              "--microbatch", "1", "--n-requests", "5", "--rate", "2.0",
              "--prompt-len", "8", "--gen-len", "4", "--device", "cpu"]
    launcher.main(common + ["--slots", "0", "--max-slots", "3"])
    out = capsys.readouterr().out
    assert "capacity plan: 1 trial row(s) x 3 slots" in out
    assert "using 3 slots/trial" in out
    launcher.main(common + ["--slots", "0", "--max-slots", "2", "--paged",
                            "--paged-kernel", "--prefix-cache",
                            "--expected-hit-rate", "0.5",
                            "--expected-seq", "10"])
    out = capsys.readouterr().out
    assert "using 2 slots/trial (pool:" in out
    assert "continuous/paged+kernel+prefix-cache: 5 requests" in out
    launcher.main(common + ["--slots", "2", "--policy", "deadline",
                            "--deadline-slack", "2.0"])
    out = capsys.readouterr().out
    assert "5 requests" in out and "[deadline]" in out
    with pytest.raises(SystemExit, match="--slots"):
        launcher.main(common + ["--slots", "-1"])


def test_planned_grid_serves():
    """A grid from the planner runs through the engine (reduced config,
    the CPU): every request completes and the pool drains."""
    from repro_torch.core.partitioner import plan_stages
    from repro_torch.serve import ServeEngine

    cfg = tget("chatglm3-6b").reduced()
    base = tpl.EngineConfig(n_trials=1, n_microbatches=1, microbatch=1,
                            n_stages=2, max_seq=24,
                            cache_dtype=torch.float32)
    plan = tsched.plan_serve_capacity(cfg, base, 24, paged=True,
                                      block_size=4, max_slots=3,
                                      param_dtype=torch.float32)
    assert plan.n_microbatches == 3 and plan.n_blocks >= 18
    params = tpl.init_trial_params(cfg, plan, plan_stages(cfg, 2),
                                   torch.Generator())
    engine = ServeEngine(cfg, plan, params, device="cpu")
    reqs = ttrace(6, 2.0, cfg.vocab_size, prompt_lens=(6, 12),
                  gen_lens=(2, 5), seed=1)
    comps = engine.run(reqs)
    assert len(comps) == 6 and engine.allocator.all_free()
