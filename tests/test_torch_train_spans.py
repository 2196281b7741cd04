"""PyTorch port — the train step's spans and counters (``obs.tracer``'s
training taxonomy) on the CPU, for a reduced dense decoder and a reduced
encoder with remat on:

* tracing changes no number: losses, gradient norms and parameters are
  bitwise equal with the tracer None, disabled and enabled;
* a disabled tracer is silent: no event, no counter, no ``repro.`` range
  under ``torch.profiler``;
* the span counts follow from the engine, on one device and on a CPU
  layout: each step phase once, a ``train.unit`` per (stage, slot) in
  each pass, a ``train.layer`` per real layer of each unit forward and
  two per recompute (PyTorch's checkpoint early stop spares the last
  layer of a unit below the last stage its run inside the unit's
  recompute), begin and end paired;
* the spans share the profiler's clock: ``t0_ns + wall`` lies within
  1 ms of its range's start (the median over spans), and each range
  inside its span's begin and end stamps;
* the placed step on a CPU layout emits one ``train.hop`` per activation
  hop and counts their bytes;
* a synchronising call's warning is counted under the span open at the
  time, and other warnings are shown as before;
* the Perfetto export draws the spans on the train track, per card.
"""
from __future__ import annotations

import collections
import statistics
import warnings

import pytest
import torch
import torch.utils.checkpoint as ckpt
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import pipeline as pl
from repro_torch.launch.mesh import layout_of
from repro_torch.models.layers import ModelOptions
from repro_torch.obs import Tracer, current, to_chrome_trace
from repro_torch.obs import tracer as obs_tracer
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves

ARCHS = ["chatglm3-6b", "bert-large"]  # the dense and encoder families
S, K, M, ROWS, SEQ = 2, 2, 2, 2, 16
PHASES = ["train.step", "train.zero_grads", "train.batch", "train.forward",
          "train.backward", "train.reduce_grads", "train.optimizer",
          "train.readback"]
HP = {"lr": torch.tensor([1e-3, 2e-3]), "wd": torch.tensor([0.0, 0.1])}


def _setup(arch, layout=None):
    cfg = get_config(arch).reduced()
    eng = pl.EngineConfig(n_trials=K, n_microbatches=M, microbatch=ROWS,
                          n_stages=S)
    gen = torch.Generator().manual_seed(0)
    params = pl.init_trial_params(cfg, eng, pl.plan_stages(cfg, S), gen,
                                  max_pos=SEQ)
    if layout is not None:
        params = pl.place_trial_params(cfg, eng, params, layout)
    tokens = torch.randint(0, cfg.vocab_size, (K, M, ROWS, SEQ),
                           generator=gen)
    return cfg, eng, params, {"tokens": tokens, "labels": tokens.roll(1, -1)}


def _run(arch, tracer, steps=2, layout=None, optimizer=None):
    """(metrics per step, final parameters) of ``steps`` steps."""
    cfg, eng, params, batch = _setup(arch, layout)
    opt = optimizer or AdamW(grad_clip=1.0)
    state = opt.init(params)
    step_fn = pl.make_train_step(cfg, ModelOptions(remat=True), eng, opt,
                                 layout=layout, tracer=tracer)
    mets = []
    for i in range(steps):
        params, state, met = step_fn(params, state, batch, HP, i)
        mets.append(met)
    return mets, params


def _begins(tracer):
    return collections.Counter(
        (e["name"], e.get("pass")) for e in tracer.events
        if e["ev"] == "span_begin")


@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_changes_no_number(arch):
    runs = [_run(arch, t) for t in (None, Tracer(enabled=False), Tracer())]
    (m0, p0), rest = runs[0], runs[1:]
    for mets, params in rest:
        for a, b in zip(m0, mets):
            assert (a["loss"] == b["loss"]).all()
            assert (a["grad_norm"] == b["grad_norm"]).all()
        for x, y in zip(tree_leaves(p0), tree_leaves(params)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_disabled_tracer_is_silent(arch):
    tr = Tracer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(arch, tr, steps=1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names and not [n for n in names if n.startswith("repro.")]
    assert tr.events == [] and tr.counters == {}
    assert current() is obs_tracer.NULL_TRACER


@pytest.mark.parametrize("early_stop, placed", [
    pytest.param(True, False, id="True"),
    pytest.param(False, False, id="False"),
    pytest.param(True, True, id="True-placed")])
@pytest.mark.parametrize("arch", ARCHS)
def test_span_counts_follow_the_engine(arch, early_stop, placed):
    """The one tick loop's counts, on one device and on a (1, 1, S) CPU
    layout alike."""
    cfg = get_config(arch).reduced()
    eng = pl.EngineConfig(n_trials=K, n_microbatches=M, microbatch=ROWS,
                          n_stages=S)
    tr = Tracer()
    layout = layout_of(["cpu"] * S, (1, 1, S)) if placed else None
    with ckpt.set_checkpoint_early_stop(early_stop):
        _run(arch, tr, steps=1, layout=layout)
    got = _begins(tr)
    for phase in PHASES:
        assert got[phase, None] == 1, phase
    units = S * eng.n_slots
    assert got["train.unit", "forward"] == units
    assert got["train.unit", "recompute"] == units
    # every slot runs every real layer once forward
    layers = eng.n_slots * cfg.n_layers
    assert got["train.layer", "forward"] == layers
    spared = eng.n_slots * (S - 1) if early_stop else 0
    assert got["train.layer", "recompute"] == 2 * layers - spared
    assert sum(got.values()) == sum(
        1 for e in tr.events if e["ev"] == "span_end")
    # begin/end pairs nest on the one thread the CPU runs
    stack = []
    for e in tr.events:
        if e["ev"] == "span_begin":
            stack.append(e)
        elif e["ev"] == "span_end":
            begin = stack.pop()
            assert begin["name"] == e["name"]
            assert begin.get("pass") == e.get("pass")
    assert stack == []
    units_seen = {(e["t"], e["s"], e["k"], e["m"], e["pass"])
                  for e in tr.events if e["ev"] == "span_begin"
                  and e["name"] == "train.unit"}
    assert len(units_seen) == 2 * units
    assert all(t == s + m * K + k for t, s, k, m, _ in units_seen)


def test_spans_are_on_the_profiler_clock():
    """Each span's ``t0_ns + wall`` lies within 1 ms of its range's start
    (the median; a host descheduled between the two reads delays one),
    and every range lies inside its span's begin and end stamps."""
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run("chatglm3-6b", tr, steps=1)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name().split(" ")[0])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("repro."))
    spans, stack = [], []
    for e in tr.events:
        if e["ev"] == "span_begin":
            stack.append(len(spans))
            spans.append([e, None])
        elif e["ev"] == "span_end":
            spans[stack.pop()][1] = e
    assert len(ranges) == len(spans)
    stamp = lambda e: tr.t0_ns + e["wall"] * 1e9
    slack = 5e5  # the events' µs rounding and the profiler's clock
    offsets = []
    for (start, end, label), (begin, finish) in zip(ranges, spans):
        want = "repro." + begin["name"] + (
            f":{begin['pass']}" if "pass" in begin else "")
        assert label == want
        assert stamp(begin) - slack <= start <= end \
            <= stamp(finish) + slack, label
        offsets.append(start - stamp(begin))
    assert statistics.median(offsets) < 1e6


def test_placed_step_hops_and_their_bytes():
    layout = layout_of(["cpu"] * S, (1, 1, S))
    cfg = get_config("chatglm3-6b").reduced()
    tr = Tracer()
    mets, _ = _run("chatglm3-6b", tr, steps=1, layout=layout)
    hops = [e for e in tr.events
            if e["ev"] == "span_begin" and e["name"] == "train.hop"]
    n_slots = K * M
    assert len(hops) == (S - 1) * n_slots
    assert all(e["src"] == e["dst"] == "cpu" for e in hops)
    each = ROWS * SEQ * cfg.d_model * 4  # fp32 activations
    assert [e["bytes"] for e in hops] == [each] * len(hops)
    assert tr.counters["hop_bytes"] == {"repro.train.hop": each * len(hops)}
    got = _begins(tr)
    for phase in PHASES:
        assert got[phase, None] == 1, phase
    assert got["train.unit", "forward"] == got["train.unit", "recompute"] \
        == S * n_slots
    # the one-device step's numbers, traced or not
    one, _ = _run("chatglm3-6b", None, steps=1)
    assert abs(one[0]["loss"] - mets[0]["loss"]).max() < 1e-5


class _PlantedSync(AdamW):
    """AdamW whose update first warns as a synchronising CUDA call does,
    then as something else."""

    def update(self, *args, **kw):
        warnings.warn(obs_tracer.SYNC_WARNING + " (planted)")
        warnings.warn("an unrelated warning", UserWarning)
        return super().update(*args, **kw)


def test_host_syncs_counted_under_the_open_span():
    tr = Tracer()
    with pytest.warns(UserWarning, match="an unrelated warning"):
        _run("chatglm3-6b", tr, steps=2, optimizer=_PlantedSync(
            grad_clip=1.0))
    assert tr.counters["host_syncs"] == {"repro.train.optimizer": 2}
    # outside a traced step the warning is an ordinary one again
    with pytest.warns(UserWarning, match=obs_tracer.SYNC_WARNING):
        _run("chatglm3-6b", None, steps=1,
             optimizer=_PlantedSync(grad_clip=1.0))


def test_perfetto_draws_train_spans_per_card():
    tr = Tracer()
    _run("bert-large", tr, steps=1)
    trace = to_chrome_trace(tr.events)["traceEvents"]
    tracks = {r["args"]["name"]: r["tid"] for r in trace
              if r["ph"] == "M" and r["pid"] == 6 and "tid" in r}
    assert set(tracks) == {"step", "cpu"}
    slices = collections.Counter((r["tid"], r["name"]) for r in trace
                                 if r["ph"] == "X" and r["pid"] == 6)
    assert slices[tracks["step"], "train.backward"] == 1
    assert slices[tracks["cpu"], "train.unit:recompute"] == S * K * M
    assert not [r for r in trace if r["ph"] == "X" and r["pid"] == 5]
