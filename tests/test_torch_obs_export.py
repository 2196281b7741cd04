"""PyTorch port — the trace exporters, the span validator and the serve
engine's event stream, against the JAX package.

* The engine's whole event stream equals the reference engine's, event
  for event (wall times dropped), ``compile`` events included, in five
  configurations on the same weights: paged split admission; overcommit
  1.5 with an 8-block host tier; the prefix cache with fused admission;
  dense strips; K = 2 gang speculation. Both streams pass
  ``validate_spans`` with the same report.
* ``obs.export`` writes the same bytes as ``repro.obs.export`` from the
  same events and metrics (JSONL events, Chrome trace JSON, metrics
  JSONL), and ``read_events`` round-trips; the port's ServeStats snapshot
  equals the reference's but for the wall clock.
* ``obs.validate`` gives the reference's report, and its violations on
  the rejection cases of ``tests/test_obs.py``; it accepts the port's
  Hydra ``span_end("gang")`` with ``restarts`` and ``steps_run``.
* The launcher's ``--trace-out`` / ``--events-out`` / ``--metrics-out``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_retract import bursty_trace
from test_serve_engine import staggered_trace
from test_spec_decode import spec_trace
from test_torch_fused_spec import prefix_trace
from test_torch_prefix_cache import to_port
from test_torch_serve_engine import (assert_parity, configs, jax_engine,
                                     jax_params, torch_engine)

from repro.obs import Tracer as JTracer
from repro.obs import TraceInvariantError as JInvariantError
from repro.obs import export as jexport
from repro.obs import validate_spans as jvalidate
from repro_torch.launch import serve as launcher
from repro_torch.obs import Tracer as TTracer
from repro_torch.obs import TraceInvariantError as TInvariantError
from repro_torch.obs import export as texport
from repro_torch.obs import read_events
from repro_torch.obs import validate_spans as tvalidate

torch.set_num_threads(2)


def _mirrored(params):
    return jax.tree.map(lambda x: jnp.concatenate([x[:1], x[:1]], 0), params)


STREAM_CASES = {
    # name: (configs kwargs, trace, engine kwargs, mirror row 0's weights)
    "paged_split": (dict(n_blocks=24), staggered_trace, {}, False),
    "overcommit_host": (dict(n_blocks=6), bursty_trace,
                        dict(overcommit=1.5, host_blocks=8), False),
    "prefix_fused": (dict(n_blocks=24), prefix_trace,
                     dict(prefix_cache=True, fused=True), False),
    "dense": (dict(paged=False), staggered_trace, {}, False),
    "spec_k2": (dict(n_trials=2, n_blocks=40),
                lambda vocab: spec_trace(vocab, seed=3),
                dict(spec_gamma=3), True),
}


def _traced_runs(case):
    ckw, trace, kw, mirror = STREAM_CASES[case]
    cfg_j, cfg_t, eng_j, eng_t = configs(**ckw)
    params = jax_params(cfg_j, eng_j)
    if mirror:
        params = _mirrored(params)
    reqs = trace(cfg_j.vocab_size)
    jtr, ttr = JTracer(), TTracer()
    jeng = jax_engine(cfg_j, eng_j, params, eng_j.paged, tracer=jtr, **kw)
    jcomp = jeng.run([r.clone() for r in reqs], max_ticks=2000)
    teng = torch_engine(cfg_t, eng_t, params, eng_t.paged, tracer=ttr, **kw)
    tcomp = teng.run(to_port(reqs), max_ticks=2000)
    assert_parity(teng, jeng, tcomp, jcomp)
    return jeng, teng, jtr.events, ttr.events


def _no_wall(events):
    return [{k: v for k, v in e.items() if k != "wall"} for e in events]


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_engine_event_stream_matches_reference(case):
    jeng, teng, jev, tev = _traced_runs(case)
    assert any(e["ev"] == "compile" for e in tev), "no compile events"
    j, t = _no_wall(jev), _no_wall(tev)
    for i, (a, b) in enumerate(zip(t, j)):
        assert a == b, f"event {i}: port {a} != reference {b}"
    assert len(t) == len(j)
    assert tvalidate(tev) == jvalidate(jev)
    rounds = [e for e in tev if e["ev"] == "round"]
    assert len(rounds) == teng.stats.ticks
    if case == "overcommit_host":
        assert teng.stats.retractions > 0
        assert {"retract", "restore", "swap_out"} <= {e["ev"] for e in tev}


def test_exports_match_reference_bytes(tmp_path):
    jeng, teng, _, events = _traced_runs("overcommit_host")
    paths = {}
    for name, mod in (("port", texport), ("ref", jexport)):
        d = tmp_path / name
        d.mkdir()
        paths[name] = d
        assert mod.write_events(events, str(d / "events.jsonl")) \
            == len(events)
        n = mod.write_perfetto(events, str(d / "trace.json"))
        assert n == len(mod.to_chrome_trace(events)["traceEvents"])
        mod.write_metrics(teng.stats.snapshot(), str(d / "metrics.jsonl"))
    for f in ("events.jsonl", "trace.json", "metrics.jsonl"):
        assert (paths["port"] / f).read_bytes() == \
            (paths["ref"] / f).read_bytes(), f
    assert texport.to_chrome_trace(events) == jexport.to_chrome_trace(events)
    assert read_events(str(paths["port"] / "events.jsonl")) == \
        json.loads(json.dumps(events))
    # the registries agree, wall clock aside
    drop = lambda snap: {k: v for k, v in snap.items() if k != "wall_s"}
    assert drop(teng.stats.snapshot()) == drop(jeng.stats.snapshot())


def _lifecycle_events(tracer):
    """tests/test_obs.py::_lifecycle_events, on either package's tracer."""
    tr = tracer
    tr.begin_tick(0)
    tr.req("enqueue", 1, arch=0, plen=8)
    tr.begin_tick(1)
    tr.req("admit", 1, k=0, m=0, b=0, plen=8)
    tr.req("prefill_chunk", 1, k=0, m=0, b=0, qlen=4, pos=0)
    tr.round(modes=["append:4"], occupied=1, occupancy=1.0, queues=[0],
             pool_blocks=2, host_depth=[1], inflight=0)
    tr.begin_tick(2)
    tr.req("first_token", 1, k=0, m=0, b=0)
    tr.begin_tick(3)
    tr.req("swap_out", 1, blocks=2)
    tr.req("retract", 1, via="swap", pos=9)
    tr.begin_tick(4)
    tr.req("restore", 1, k=0, m=0, b=0, via="swap")
    tr.begin_tick(5)
    tr.req("complete", 1, tokens=3, ttft=1.0)
    tr.compile("decode", qlen=1, table_width=0)
    tr.span_begin("gang", arch="a", n_trials=2, steps=4)
    tr.span_end("gang", arch="a")
    return tr.events


def _drop(events, name):
    return [e for e in events if e["ev"] != name]


MUTATIONS = {
    "no_enqueue": lambda evs: _drop(evs, "enqueue"),
    "no_admit": lambda evs: _drop(evs, "admit"),
    "no_swap_out": lambda evs: _drop(evs, "swap_out"),
    "no_restore": lambda evs: _drop(evs, "restore"),
    "tick_backwards": lambda evs: evs + [dict(
        next(e for e in evs if e["ev"] == "complete"), tick=0)],
    "open": lambda evs: _drop(evs, "complete"),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_validator_rejects_like_reference(name):
    events = MUTATIONS[name](_lifecycle_events(TTracer()))
    with pytest.raises(TInvariantError) as got:
        tvalidate(events)
    with pytest.raises(JInvariantError) as want:
        jvalidate(events)
    assert got.value.violations == want.value.violations
    assert str(got.value) == str(want.value)
    if name == "open":
        assert tvalidate(events, allow_open=True) == \
            jvalidate(events, allow_open=True)


def test_validator_accepts_port_gang_spans():
    """The port's Hydra gang span ends with ``restarts`` and ``steps_run``
    beside the reference's ``arch``; spans carry no request id, so the
    validator passes them over, and the exporter draws the slice."""
    events = _lifecycle_events(TTracer())
    events[-1] = dict(events[-1], restarts=1, steps_run=4)
    assert tvalidate(events) == jvalidate(events) == {
        "requests": 1, "completed": 1, "retracted_terminal": 0,
        "violations": 0}
    gang = [r for r in texport.to_chrome_trace(events)["traceEvents"]
            if r["ph"] == "X" and r["name"] == "gang a"]
    assert len(gang) == 1
    assert texport.to_chrome_trace(events) == jexport.to_chrome_trace(events)


def test_launcher_writes_trace_events_metrics(tmp_path, capsys):
    paths = {n: str(tmp_path / f) for n, f in (
        ("trace", "trace.json"), ("events", "events.jsonl"),
        ("metrics", "metrics.jsonl"))}
    launcher.main(["--arch", "chatglm3-6b", "--smoke", "--paged",
                   "--paged-kernel", "--n-model", "2", "--slots", "2",
                   "--microbatch", "1", "--n-requests", "4", "--rate", "2.0",
                   "--prompt-len", "8", "--gen-len", "4", "--device", "cpu",
                   "--trace-out", paths["trace"],
                   "--events-out", paths["events"],
                   "--metrics-out", paths["metrics"]])
    out = capsys.readouterr().out
    for p in paths.values():
        assert f"-> {p}" in out
    events = read_events(paths["events"])
    assert tvalidate(events)["completed"] == 4
    assert {"compile", "round", "admit", "complete"} <= {
        e["ev"] for e in events}
    assert json.load(open(paths["trace"]))["traceEvents"]
    metrics = {r["metric"]: r for r in map(json.loads,
                                           open(paths["metrics"]))}
    assert metrics["tokens_generated"]["value"] > 0
    assert np.isfinite(metrics["wall_s"]["value"])
