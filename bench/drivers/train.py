"""The training driver: Hydra's multi-trial pipelined train step
(``repro_torch.core.pipeline.make_train_step``), built as
``core/hydra.py::run_gang`` builds it — the program's AdamW with clipping
and a learning rate and weight decay a trial, ``kernel_options(cfg,
remat=...)`` — and, for a traffic file with a ``layout``, placed on its
cards with ``place_trial_params``.

One run (:func:`run`):

1. set-up: draws the K trials' weights on the first card from the seed
   (``bench.harness.weights``), places them, builds the optimizer state
   and the step, and runs the traffic's ``setup_steps`` steps through the
   step's own call on the benchmark's batches — the warm-up, which builds
   K1, and the steps the reference follows. It reads each trial's losses,
   every leaf's first gradient from the AdamW state after one step, and
   every leaf's change after the last, against the re-drawn start;
2. the window: steps on fresh batches until ``seconds`` have passed,
   each ended by a synchronisation of every card; the rate counts whole
   steps over the whole window;
3. with ``trace``, one more step under the profiler, with the
   benchmark's ranges around the step, the batch, ``backward()``, the
   optimizer update and each K1 launch (whose work is recorded from its
   shapes);
4. the peak memory, then the program's state freed and the reference run
   for each trial (``bench.reference.train``), and the comparison
   (``bench.harness.compare``).
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from bench.harness import compare
from bench.harness import traffic as T
from bench.harness import weights as W
from bench.harness.sizes import Sizes, stage_layers
from bench.reference import train as ref_train
from bench.yardstick import costs
from bench.yardstick import flops
from bench.yardstick import trace as Y

FAMILY = {"decoder": "dense", "encoder": "encoder"}
ACT = {"swiglu": "swiglu", "gelu_tanh": "gelu"}
K1_NAME = "flash_attention"  # in the names of the program's K1 kernels
NAME_CHARS = 120  # kernel names in the breakdown are cut to this


def arch_config(sizes: Sizes):
    """The program's ArchConfig of ``sizes``."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(
        name=sizes.name, family=FAMILY[sizes.family],
        n_layers=sizes.n_layers, d_model=sizes.d_model,
        n_heads=sizes.n_heads, n_kv_heads=sizes.n_kv_heads,
        d_ff=sizes.d_ff, vocab_size=sizes.vocab_size,
        head_dim=sizes.head_dim, rope=sizes.rope,
        rope_theta=sizes.rope_theta, norm_eps=sizes.norm_eps,
        act=ACT[sizes.act])


def run_devices(traffic: dict, device=None) -> list:
    """The devices of a run: cuda:0 .. n-1 for the traffic's layout, or
    ``device`` (for tests on the CPU) in every place."""
    lay = traffic["layout"]
    n = 1 if lay is None else lay["data"] * lay["model"]
    if device is not None:
        return [torch.device(device)] * n
    return [torch.device("cuda", i) for i in range(n)]


def _get(tree, path: str):
    for name in path.split("/"):
        tree = tree[name]
    return tree


class Program:
    """The system under test, built from the seed: its parameters,
    AdamW state, per-trial hyperparameters and train step."""

    def __init__(self, sizes: Sizes, traffic: dict, seed: int, devices):
        from repro_torch.core import pipeline as pl
        from repro_torch.core.partitioner import plan_stages
        from repro_torch.launch.mesh import layout_of
        from repro_torch.models.layers import ModelOptions, kernel_options
        from repro_torch.optim.adamw import AdamW
        from repro_torch.tree import tree_items

        self.sizes, self.traffic, self.seed = sizes, traffic, seed
        self.devices = devices
        cfg = arch_config(sizes)
        lay = traffic["layout"]
        k, s = traffic["trials"], traffic["stages"]
        if lay is not None and (lay["model"] != s or lay["data"] != 1):
            raise ValueError("a layout is data 1 x model <stages>")
        eng = pl.EngineConfig(n_trials=k,
                              n_microbatches=traffic["microbatches"],
                              microbatch=traffic["rows"], n_stages=s)
        opts = (kernel_options(cfg, remat=traffic["remat"])
                if traffic["kernels"] else
                ModelOptions(remat=traffic["remat"]))
        params = W.trial_tree(sizes, s, k, seed, devices[0])
        want = pl.trial_params_struct(
            cfg, eng, plan_stages(cfg, s), dtype=torch.float32,
            max_pos=sizes.max_positions if sizes.rope == "learned" else 0)
        have = {n: tuple(t.shape) for n, t in tree_items(params)}
        need = {n: tuple(t.shape) for n, t in tree_items(want)}
        if have != need:
            raise ValueError(f"the benchmark's weights {have} do not fit "
                             f"the program's tree {need}")
        self.layout = None
        if lay is not None:
            self.layout = layout_of(devices, (1, 1, s))
            placed = pl.place_trial_params(cfg, eng, params, self.layout)
            del params
            params = placed
            gc.collect()
            if self.cards:
                torch.cuda.empty_cache()
        self.params = params
        self.opt = AdamW(b1=traffic["betas"][0], b2=traffic["betas"][1],
                         eps=traffic["eps"], grad_clip=traffic["grad_clip"])
        self.state = self.opt.init(params)
        as_vec = lambda xs: torch.tensor(xs, dtype=torch.float32,
                                         device=devices[0])
        self.hparams = {"lr": as_vec(traffic["lr"]),
                        "wd": as_vec(traffic["weight_decay"])}
        self.step_fn = pl.make_train_step(cfg, opts, eng, self.opt,
                                          layout=self.layout)

    @property
    def cards(self) -> list:
        """CUDA indices in use (empty on the CPU)."""
        return sorted({d.index for d in self.devices if d.type == "cuda"})

    def sync(self) -> None:
        for i in self.cards:
            torch.cuda.synchronize(i)

    def step(self, step: int):
        """One step on step ``step``'s batch; returns the (K,) losses."""
        b = T.batch(self.traffic, self.sizes.vocab_size, self.seed, step,
                    self.devices[0])
        self.params, self.state, met = self.step_fn(
            self.params, self.state, b, self.hparams, step)
        return met["loss"]

    # -- readings: per-leaf norms over (leaf, trial, stage) units ---------

    def unit(self, tree, path: str, k: int, s: int, axis):
        """The program's tensor for weights unit (path, k, s) of a
        parameter-shaped ``tree`` (parameters or an AdamW moment)."""
        ls = stage_layers(self.sizes, self.traffic["stages"])
        layer = path.startswith("layers/")
        if self.layout is not None:
            here = tree[0][0][0 if axis is None and not layer else s]
            return _get(here, path)[k]
        leaf = _get(tree, path)[k]
        if layer:
            return leaf[s * ls:(s + 1) * ls]
        if axis is None:
            return leaf
        w = leaf.shape[axis] // self.traffic["stages"]
        return leaf.narrow(axis, s * w, w)

    def trial_leaves(self, tree, k: int) -> dict:
        """Trial ``k``'s leaves of ``tree`` by the reference's names
        (views, or the stage slices joined), its padding left out."""
        sz, n_st = self.sizes, self.traffic["stages"]
        ls = stage_layers(sz, n_st)
        out = {}
        for path, _, _ in W.layer_leaves(sz):
            for s in range(n_st):
                block = self.unit(tree, "layers/" + path, k, s, None)
                for i in range(ls):
                    if s * ls + i < sz.n_layers:
                        out[f"layers/{s * ls + i}/{path}"] = block[i]
        for path, _, axis, real, _ in W.global_leaves(sz, n_st):
            if axis is None:
                out[path] = self.unit(tree, path, k, 0, None)
                continue
            parts = [self.unit(tree, path, k, s, axis).to(self.devices[0])
                     for s in range(n_st)]
            out[path] = torch.cat(parts, dim=axis).narrow(axis, 0, real)
        return out

    @torch.no_grad()
    def leaf_norms(self, tree, start: bool = False) -> dict:
        """{leaf: [per trial]} norms of ``tree``'s leaves, named as the
        reference names them; with ``start``, of ``tree`` minus the
        re-drawn weights."""
        sz, n_st, n_k = self.sizes, self.traffic["stages"], \
            self.traffic["trials"]
        ls = stage_layers(sz, n_st)
        out = {}
        for path, _, _ in W.layer_leaves(sz):
            for k in range(n_k):
                for s in range(n_st):
                    t = self.unit(tree, "layers/" + path, k, s, None)
                    if start:  # drawn where the weights were drawn
                        t = t - W.layer_unit(sz, n_st, self.seed, path, k, s,
                                             self.devices[0]).to(t.device)
                    norms = t.reshape(ls, -1).norm(dim=1).tolist()
                    for i, v in enumerate(norms):
                        layer = s * ls + i
                        if layer < sz.n_layers:
                            out.setdefault(f"layers/{layer}/{path}",
                                           [0.0] * n_k)[k] = v
        for path, _, axis, _, _ in W.global_leaves(sz, n_st):
            for k in range(n_k):
                sq = 0.0
                for s in range(1 if axis is None else n_st):
                    t = self.unit(tree, path, k, s, axis)
                    if start:
                        t = t - W.global_unit(sz, n_st, self.seed, path, k,
                                              s, self.devices[0]).to(t.device)
                    sq += float(t.norm()) ** 2
                out.setdefault(path, [0.0] * n_k)[k] = math.sqrt(sq)
        return out


def _finite(losses) -> bool:
    return all(math.isfinite(float(x)) for x in losses)


@contextlib.contextmanager
def annotated(k1_work: list):
    """The benchmark's ranges inside a step: ``bench.backward``,
    ``bench.optimizer`` and ``bench.k1`` (each K1 launch, its (bytes,
    operations, precision) appended to ``k1_work``)."""
    from torch.profiler import record_function
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim.adamw import AdamW

    kernel, update, backward = (fa.flash_attention_kernel, AdamW.update,
                                torch.Tensor.backward)

    def k1(q, k, v, *, causal=True, window=0, kv_offset=0):
        nbytes, ops, _ = costs.flash_work(
            tuple(q.shape), tuple(k.shape), tuple(v.shape),
            q.element_size(), causal, window, kv_offset)
        k1_work.append((nbytes, ops, str(q.dtype).split(".")[-1]))
        with record_function("bench.k1"):
            return kernel(q, k, v, causal=causal, window=window,
                          kv_offset=kv_offset)

    def traced_update(self, *a, **kw):
        with record_function("bench.optimizer"):
            return update(self, *a, **kw)

    def traced_backward(self, *a, **kw):
        with record_function("bench.backward"):
            return backward(self, *a, **kw)

    fa.flash_attention_kernel = k1
    AdamW.update = traced_update
    torch.Tensor.backward = traced_backward
    try:
        yield
    finally:
        fa.flash_attention_kernel = kernel
        AdamW.update = update
        torch.Tensor.backward = backward


def traced_step(prog: Program, step: int) -> dict:
    """One step under the profiler, reduced to the per-layer readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if prog.cards:
        acts.append(ProfilerActivity.CUDA)
    k1_work: list = []
    prog.sync()
    with profile(activities=acts) as prof, annotated(k1_work):
        with record_function("bench.window"):
            with record_function("bench.step"):
                losses = prog.step(step)
            prog.sync()
    rec = Y.records(prof.profiler.kineto_results.events())
    lo, hi = Y.window(rec, "bench.window")
    busy = {c: Y.busy_ns(rec, c, lo, hi) / 1e9 for c in prog.cards}
    k1 = [d for d in rec.device if K1_NAME in d[1] and d[3] > lo
          and d[2] < hi]
    spans = Y.ranges(rec)
    gaps = sorted(((e - s, c, s, e) for c in prog.cards
                   for s, e in Y.idle_gaps(rec, c, lo, hi)), reverse=True)
    kernels = sorted(Y.kernel_seconds(rec, lo, hi).items(),
                     key=lambda x: -x[1])
    return {
        "losses": losses,
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy,
        "host_ops": Y.host_ops(rec, lo, hi),
        "k1_work": k1_work,
        "k1_records": len(k1),
        "k1_device_s": sum(e - s for _, _, s, e in k1) / 1e9,
        "breakdown": {
            "device_ops": [[n[:NAME_CHARS], v] for n, v in kernels[:10]],
            "idle_gaps": [[f"{Y.label_at(spans, (s + e) // 2)} cuda:{c}",
                           d / 1e9] for d, c, s, e in gaps[:10]]},
    }


def host_peak_rss_gb() -> float:
    """This process's peak resident memory on the host, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def memory_peak(prog: Program) -> int:
    return max((torch.cuda.max_memory_allocated(i) for i in prog.cards),
               default=0)


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device=None, plant=None) -> dict:
    """One run of a training cell. ``started``: ``time.perf_counter()``
    at process start; ``device``: None (the cards) or a device for every
    place (tests); ``plant``: a callable given the built Program before
    set-up (tests plant faults with it). Returns {"end_to_end",
    "run" (what the per-layer readers read), "breakdown", "device",
    "timings" (set-up's parts, the window and the reference, in s),
    "attempted", "failed", "checks", "correct"}."""
    sizes, traffic = cell.sizes, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = run_devices(traffic, device)
    marks = {"driver": time.perf_counter()}
    prog = Program(sizes, traffic, seed, devices)
    prog.sync()
    marks["built"] = time.perf_counter()
    if plant is not None:
        plant(prog)
    for i in prog.cards:
        torch.cuda.reset_peak_memory_stats(i)
    n_setup = traffic["setup_steps"]
    losses, attempted, failed = [], 0, 0
    grad = change = None
    for step in range(n_setup):
        loss = prog.step(step)
        losses.append([float(x) for x in loss])
        attempted += 1
        failed += not _finite(loss)
        if step == 0:
            grad = {n: [v / (1 - traffic["betas"][0]) for v in vs]
                    for n, vs in prog.leaf_norms(prog.state["m"]).items()}
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
    per_step = T.tokens_per_step(traffic)
    traced = None
    if trace:
        traced = traced_step(prog, step)
        attempted += 1
        failed += not _finite(traced.pop("losses"))
    peak = memory_peak(prog)
    chips = len(set(devices))
    kind = (torch.cuda.get_device_name(prog.cards[0]) if prog.cards
            else "cpu")
    del prog
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    refs = [ref_train.run_trial(sizes, traffic, seed, k, devices,
                                devices[0], n_setup)
            for k in range(traffic["trials"])]
    t_done = time.perf_counter()
    found = compare.gaps({"loss": losses, "grad": grad, "change": change},
                         refs)
    checks = {n: {"value": found[n][0], "limit": cell.limits[n],
                  "where": found[n][1]} for n in compare.NAMES}
    out = {
        "end_to_end": {"train_tokens_per_s": n * per_step / window_s,
                       "setup_s": t0 - started},
        "run": {"sizes": sizes, "traffic": traffic, "chips": chips,
                "window_steps": n, "window_s": window_s,
                "model_flops_per_step": flops.model_flops_per_step(
                    sizes, traffic["trials"], traffic["microbatches"],
                    traffic["rows"], traffic["seq"]),
                "trace": traced},
        "device": {"platform": "gpu" if kind != "cpu" else "cpu",
                   "kind": kind, "count": chips,
                   "memory_peak_bytes": peak},
        "timings": {"to_driver_s": marks["driver"] - started,
                    "build_s": marks["built"] - marks["driver"],
                    "setup_steps_s": marks["steps"] - marks["built"],
                    "readings_s": t0 - marks["steps"],
                    "window_s": window_s, "window_steps": n,
                    "reference_s": t_done - t_ref,
                    "host_peak_rss_gb": host_peak_rss_gb()},
        "attempted": attempted, "failed": failed, "checks": checks,
        "correct": failed == 0 and compare.decide(found, cell.limits),
    }
    if traced is not None:
        out["breakdown"] = traced.pop("breakdown")
        out["device"]["busy_s"] = (sum(traced["busy_s"].values())
                                   / max(len(traced["busy_s"]), 1))
        out["device"]["window_s"] = traced["window_s"]
    return out
