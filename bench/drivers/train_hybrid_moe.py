"""The training driver of the hybrid Mamba2 / attention MoE cells: Hydra's
multi-trial pipelined train step (``repro_torch.core.pipeline.
make_train_step``) on the program's ``hybrid_moe`` family, built as
``bench/drivers/train.py`` builds the attention families' — the
program's AdamW with clipping and a learning rate and weight decay a
trial, ``kernel_options(cfg, remat=...)`` (K1 for the attention layers),
the traffic's MoE ``capacity_factor`` — and with the program's tracer
(``repro_torch.obs.Tracer``), as ``bench/trace_program.py`` builds it, so
the program's spans and counters reach the readers. One device only (a
mixed stack takes no layout).

The configuration's keys beyond :class:`~bench.harness.sizes.Sizes` are
read from the cell's configuration file (``bench.harness.hybrid_moe``;
found through ``BENCHMARK.json`` by the sizes' name where the caller gives
only the sizes).

One run (:func:`run`), as the attention families' driver runs:

1. set-up: the K trials' weights drawn on the card from the seed, the
   optimizer state and the step, and the traffic's ``setup_steps`` steps
   with the tracer on (its counters give the dropped picks), whose losses,
   first gradients and changes the reference follows;
2. the window, the tracer off: steps on fresh batches until ``seconds``
   have passed, each ended by a synchronisation;
3. with ``trace``, one more step under the profiler with the tracer on:
   device time by program range, with each ``repro.train.mixer`` range's
   ``kind`` kept in its label (``repro.train.mixer:forward kind=mamba2``),
   and the tracer's counters for that step;
4. the peak memory, the program freed, the reference of every trial
   (``bench.reference.hybrid_moe_train``) and the comparison. A run is
   not correct if a pick of a held expert was dropped in the set-up steps
   or the traced step (check ``moe_dropped_picks``, limit 0): the
   reference routes without dropping.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from collections import defaultdict

import torch

from bench.drivers import train as dense
from bench.harness import compare, manifest
from bench.harness import hybrid_moe as H
from bench.harness import traffic as T
from bench.harness.sizes import Sizes, load_config
from bench.reference import hybrid_moe_train as ref_train
from bench.yardstick import spans as Z
from bench.yardstick import trace as Y

MIXER = "repro.train.mixer"
DROPPED = "moe_dropped_picks"
run_devices = dense.run_devices


def config_of(sizes: Sizes) -> dict:
    """The configuration file of ``BENCHMARK.json``'s configuration named
    as ``sizes``."""
    entry = next(c for c in manifest.manifest()["configs"]
                 if c["name"] == sizes.name)
    return load_config(manifest.ROOT / entry["file"])


def arch_config(hy: H.Hybrid):
    """The program's HybridMoEConfig of ``hy``."""
    from repro_torch.configs.base import HybridMoEConfig, MoEConfig, SSMConfig

    s = hy.sizes
    return HybridMoEConfig(
        name=s.name, family="hybrid_moe", n_layers=s.n_layers,
        d_model=s.d_model, n_heads=s.n_heads, n_kv_heads=s.n_kv_heads,
        d_ff=s.d_ff, vocab_size=s.vocab_size, head_dim=s.head_dim,
        rope="none", norm_eps=s.norm_eps, act="swiglu", tie_embeddings=True,
        moe=MoEConfig(n_experts=hy.n_experts, top_k=hy.top_k,
                      expert_d_ff=s.d_ff, load_balance_coef=hy.aux_coef),
        ssm=SSMConfig(kind="mamba2", d_state=hy.d_state, d_conv=hy.d_conv,
                      expand=hy.d_inner // s.d_model,
                      head_dim=hy.mamba_head_dim, n_groups=hy.n_groups,
                      chunk_size=hy.chunk),
        layer_types=hy.layer_types,
        attention_multiplier=hy.attention_multiplier,
        embedding_multiplier=hy.embedding_multiplier,
        residual_multiplier=hy.residual_multiplier,
        logits_scaling=hy.logits_scaling, shared_d_ff=hy.shared_d_ff,
        n_held_experts=hy.held[1], first_held_expert=hy.held[0])


def _get(tree, path: str):
    for name in path.split("/"):
        tree = tree[name]
    return tree


class Program:
    """The system under test, built from the seed: its parameters, AdamW
    state, per-trial hyperparameters, tracer and train step."""

    def __init__(self, sizes: Sizes, traffic: dict, seed: int, devices,
                 config: dict = None):
        from repro_torch.core import pipeline as pl
        from repro_torch.core.partitioner import plan_stages
        from repro_torch.models.layers import ModelOptions, kernel_options
        from repro_torch.obs import Tracer
        from repro_torch.optim.adamw import AdamW
        from repro_torch.tree import tree_items

        if traffic["layout"] is not None:
            raise ValueError("a mixed stack runs on one device (no layout)")
        self.hybrid = H.hybrid_of(config or config_of(sizes), sizes)
        cfg = arch_config(self.hybrid)  # before any draw: a program
        # without the family fails here, at once
        self.sizes, self.traffic, self.seed = sizes, traffic, seed
        self.devices = devices
        k, s = traffic["trials"], traffic["stages"]
        eng = pl.EngineConfig(n_trials=k,
                              n_microbatches=traffic["microbatches"],
                              microbatch=traffic["rows"], n_stages=s)
        kw = dict(remat=traffic["remat"],
                  moe_capacity_factor=traffic["capacity_factor"])
        opts = (kernel_options(cfg, **kw) if traffic["kernels"]
                else ModelOptions(**kw))
        params = H.trial_tree(self.hybrid, s, k, seed, devices[0])
        want = pl.trial_params_struct(cfg, eng, plan_stages(cfg, s),
                                      dtype=torch.float32)
        have = {n: tuple(t.shape) for n, t in tree_items(params)}
        need = {n: tuple(t.shape) for n, t in tree_items(want)}
        if have != need:
            raise ValueError(f"the benchmark's weights {have} do not fit "
                             f"the program's tree {need}")
        self.layout = None
        self.params = params
        self.opt = AdamW(b1=traffic["betas"][0], b2=traffic["betas"][1],
                         eps=traffic["eps"], grad_clip=traffic["grad_clip"])
        self.state = self.opt.init(params)
        as_vec = lambda xs: torch.tensor(xs, dtype=torch.float32,
                                         device=devices[0])
        self.hparams = {"lr": as_vec(traffic["lr"]),
                        "wd": as_vec(traffic["weight_decay"])}
        self.tracer = Tracer(enabled=False)
        self.step_fn = pl.make_train_step(cfg, opts, eng, self.opt,
                                          tracer=self.tracer)

    cards = dense.Program.cards
    sync = dense.Program.sync
    step = dense.Program.step

    # -- readings: per-leaf norms over (leaf, trial, stage) units ---------

    def _leaves(self, tree, k: int = None, start: bool = False):
        """(name, tensor) of every leaf of a parameter-shaped ``tree``, as
        the reference names them: trial ``k``'s, or (K, ...) with all
        trials; with ``start``, less the re-drawn weights (per trial)."""
        hy, n_st = self.hybrid, self.traffic["stages"]
        trials = range(self.traffic["trials"]) if k is None else [k]
        dev = self.devices[0]
        for i in range(self.sizes.n_layers):
            for path, _, _ in H.layer_leaves(hy, i):
                t = _get(tree["layers"][i], path)
                t = t if k is None else t[k:k + 1]
                if start:
                    t = t - torch.stack([H.layer_unit(
                        hy, self.seed, i, path, j, dev) for j in trials])
                yield f"layers/{i}/{path}", t
        for path, _, axis, real, _ in H.global_leaves(hy, n_st):
            t = _get(tree, path)
            t = t if k is None else t[k:k + 1]
            if start:
                t = t - torch.stack([torch.cat([H.global_unit(
                    hy, n_st, self.seed, path, j, s, dev)
                    for s in range(1 if axis is None else n_st)],
                    dim=axis or 0) for j in trials])
            yield path, (t if axis is None else t.narrow(axis + 1, 0, real))

    def trial_leaves(self, tree, k: int) -> dict:
        """Trial ``k``'s leaves of ``tree`` by the reference's names."""
        return {n: t[0] for n, t in self._leaves(tree, k)}

    @torch.no_grad()
    def leaf_norms(self, tree, start: bool = False) -> dict:
        """{leaf: [per trial]} norms of ``tree``'s leaves, named as the
        reference names them; with ``start``, of ``tree`` minus the
        re-drawn weights."""
        n_k = self.traffic["trials"]
        out = {}
        for name, t in self._leaves(tree, start=start):
            out[name] = t.reshape(n_k, -1).norm(dim=1).tolist()
        return out


def _finite(losses) -> bool:
    return all(math.isfinite(float(x)) for x in losses)


def _labelled(name: str) -> str:
    """A program range's label, a mixer's with its ``kind`` field."""
    lab = Z.label(name)
    if lab.startswith(MIXER):
        kind = [f for f in name.split(" ")[1:] if f.startswith("kind=")]
        lab = " ".join([lab] + kind)
    return lab


def program(events, lo: int, hi: int, counters: dict) -> dict:
    """``spans.program`` of a traced step, each mixer range's label with
    its kind: ``device_s`` by label (``repro.train.mixer:forward
    kind=mamba2``), ``ranges`` started in [lo, hi), ``counters``,
    ``links``. (The backward proper runs on autograd's thread outside
    every range, as for the attention families.)"""
    from torch.autograd import DeviceType

    rec = Z.launched(events)
    ranges = [(e.start_thread_id(), _labelled(e.name()), e.start_ns(),
               e.start_ns() + e.duration_ns()) for e in events
              if e.device_type() == DeviceType.CPU
              and e.is_user_annotation() and e.name().startswith(Z.PREFIX)]
    rec = dataclasses.replace(rec, ranges=ranges)
    opened = defaultdict(int)
    for _, lab, s, _ in ranges:
        if lo <= s < hi:
            opened[lab] += 1
    return {"device_s": Z.seconds_by_label(Z.attributed(rec), lo, hi),
            "ranges": dict(opened),
            "counters": {n: dict(v) for n, v in counters.items()},
            "links": rec.links}


def traced_step(prog: Program, step: int) -> dict:
    """One step under the profiler with the program's tracer on, reduced
    to the per-layer readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if prog.cards:
        acts.append(ProfilerActivity.CUDA)
    prog.sync()
    prog.tracer.clear()
    prog.tracer.enabled = True
    try:
        with profile(activities=acts) as prof, dense.annotated([]):
            with record_function("bench.window"):
                with record_function("bench.step"):
                    losses = prog.step(step)
                prog.sync()
    finally:
        prog.tracer.enabled = False
    events = prof.profiler.kineto_results.events()
    rec = Y.records(events)
    lo, hi = Y.window(rec, "bench.window")
    ranges = Z.host_ranges(rec)
    gaps = sorted(((e - s, c, s, e) for c in prog.cards
                   for s, e in Y.idle_gaps(rec, c, lo, hi)), reverse=True)
    kernels = sorted(Y.kernel_seconds(rec, lo, hi).items(),
                     key=lambda x: -x[1])
    return {
        "losses": losses,
        "window_s": (hi - lo) / 1e9,
        "busy_s": {c: Y.busy_ns(rec, c, lo, hi) / 1e9 for c in prog.cards},
        "host_ops": Y.host_ops(rec, lo, hi),
        "program": program(events, lo, hi, prog.tracer.counters),
        "breakdown": {
            "device_ops": [[n[:dense.NAME_CHARS], v]
                           for n, v in kernels[:10]],
            "idle_gaps": [[f"{Y.label_at(ranges, (s + e) // 2)} cuda:{c}",
                           d / 1e9] for d, c, s, e in gaps[:10]]},
    }


def dropped(counters: dict) -> int:
    return int(sum(counters.get(DROPPED, {}).values()))


def reference(cell, seed: int, device, **kw) -> list:
    """Every trial's reference readings over the set-up steps."""
    hy = H.hybrid_of(cell.config, cell.sizes)
    return [ref_train.run_trial(hy, cell.traffic, seed, k, device,
                                cell.traffic["setup_steps"], **kw)
            for k in range(cell.traffic["trials"])]


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device=None, plant=None) -> dict:
    """One run of a hybrid MoE training cell; the arguments and the result
    as ``bench/drivers/train.py``'s ``run``, with the check
    ``moe_dropped_picks`` beside the comparison's."""
    sizes, traffic = cell.sizes, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = run_devices(traffic, device)
    marks = {"driver": time.perf_counter()}
    prog = Program(sizes, traffic, seed, devices, cell.config)
    prog.sync()
    marks["built"] = time.perf_counter()
    if plant is not None:
        plant(prog)
    for i in prog.cards:
        torch.cuda.reset_peak_memory_stats(i)
    n_setup = traffic["setup_steps"]
    losses, attempted, failed = [], 0, 0
    grad = None
    prog.tracer.enabled = True  # for the dropped picks
    for step in range(n_setup):
        loss = prog.step(step)
        losses.append([float(x) for x in loss])
        attempted += 1
        failed += not _finite(loss)
        if step == 0:
            grad = {n: [v / (1 - traffic["betas"][0]) for v in vs]
                    for n, vs in prog.leaf_norms(prog.state["m"]).items()}
    prog.tracer.enabled = False
    drops = dropped(prog.tracer.counters)
    prog.sync()
    marks["steps"] = time.perf_counter()
    change = prog.leaf_norms(prog.params, start=True)
    prog.sync()

    t0 = time.perf_counter()
    n, step = 0, n_setup
    while True:
        loss = prog.step(step)
        prog.sync()
        n, step = n + 1, step + 1
        attempted += 1
        failed += not _finite(loss)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    traced = None
    if trace:
        traced = traced_step(prog, step)
        attempted += 1
        failed += not _finite(traced.pop("losses"))
        drops += dropped(traced["program"]["counters"])
    peak = dense.memory_peak(prog)
    chips = len(set(devices))
    kind = (torch.cuda.get_device_name(prog.cards[0]) if prog.cards
            else "cpu")
    del prog
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    refs = reference(cell, seed, devices[0])
    t_done = time.perf_counter()
    found = compare.gaps({"loss": losses, "grad": grad, "change": change},
                         refs)
    checks = {n: {"value": found[n][0], "limit": cell.limits[n],
                  "where": found[n][1]} for n in compare.NAMES}
    checks[DROPPED] = {"value": drops, "limit": 0,
                       "where": "the set-up steps" + (
                           " and the traced step" if trace else "")}
    out = {
        "end_to_end": {"train_tokens_per_s":
                       n * T.tokens_per_step(traffic) / window_s,
                       "setup_s": t0 - started},
        "run": {"sizes": sizes, "traffic": traffic, "chips": chips,
                "window_steps": n, "window_s": window_s, "trace": traced},
        "device": {"platform": "gpu" if kind != "cpu" else "cpu",
                   "kind": kind, "count": chips,
                   "memory_peak_bytes": peak},
        "timings": {"to_driver_s": marks["driver"] - started,
                    "build_s": marks["built"] - marks["driver"],
                    "setup_steps_s": marks["steps"] - marks["built"],
                    "readings_s": t0 - marks["steps"],
                    "window_s": window_s, "window_steps": n,
                    "reference_s": t_done - t_ref,
                    "host_peak_rss_gb": dense.host_peak_rss_gb()},
        "attempted": attempted, "failed": failed, "checks": checks,
        "correct": failed == 0 and drops == 0
        and compare.decide(found, cell.limits),
    }
    if traced is not None:
        out["breakdown"] = traced.pop("breakdown")
        out["device"]["busy_s"] = (sum(traced["busy_s"].values())
                                   / max(len(traced["busy_s"]), 1))
        out["device"]["window_s"] = traced["window_s"]
    return out

