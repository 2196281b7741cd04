"""Dry-run of every (architecture × input-shape) cell on a layout — the
port's counterpart of ``repro/launch/dryrun.py``.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    python -m repro_torch.launch.dryrun --all --layout card [--paper-archs]
    python -m repro_torch.launch.dryrun --all --both-meshes
    ... --set microbatch=2 --variant mb2        # engine / option overrides

Each cell writes ``<out>/<layout>/<variant>/<arch>__<shape>.json``. Cells
already present are skipped unless ``--force``; a cell that fails writes
the traceback to ``<path>.err`` instead (never a zero row).

Layouts (``launch/mesh.py``): the reference's production meshes 16×16 and
2×16×16, and ``card``, the one H100 the port runs on. Every row carries
the engine the cell runs (``engine_for_cell``: the reference's, field for
field), ``modeled_bytes_per_device`` (``per_chip_bytes`` × K, the port's
training state in bf16) and the model FLOPs. On the card layout the
row also holds the whole step's counted costs (``analysis/costs.py``, on
the ``meta`` device, extrapolated over microbatches and layers), its
H100 roofline row and ``fits_card`` against the card's memory. On a
production layout the per-device costs are those of a many-device mesh,
which one process cannot measure; the row says so in ``per_device``.

The kernels are off by default, as in the reference's dry-run:
``--set use_flash_kernel=1`` on ``meta`` fails the cell with the wrappers'
reason (a kernel needs data on the card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch

from repro_torch.analysis import costs as costs_lib
from repro_torch.analysis import roofline as roof
from repro_torch.configs import (ASSIGNED_ARCHS, EXTRA_ARCHS, PAPER_ARCHS,
                                 SHAPES, shape_applicable)
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import pipeline as pl
from repro_torch.core import scheduler as sched
from repro_torch.core.partitioner import plan_stages
from repro_torch.launch.mesh import (CARD_LAYOUT_NAME, layout_name,
                                     make_card_mesh, make_production_mesh,
                                     mesh_axis_sizes, n_devices)
from repro_torch.models import lm
from repro_torch.models.layers import DIRECT_ATTENTION_SCORES, ModelOptions
from repro_torch.optim.adamw import AdamW

DTYPE = torch.bfloat16  # parameters and compute, as the reference's cells
# a sequence count point is a whole number of these tokens at least: MoE
# capacities int(factor · tokens · k / E) stay exact at every assigned arch
SEQ_UNIT = 64


def engine_for_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    overrides: dict) -> pl.EngineConfig:
    """The engine of one cell on ``mesh`` (a layout), as the reference
    builds it: one trial row per data replica's microbatch stream, K
    trials for training (as many as fit, capped at ``max_trials``), FSDP
    and vocab parallelism on unless overridden."""
    sizes = mesh_axis_sizes(mesh)
    n_stages = sizes["model"]
    data = sizes["data"]
    pods = sizes.get("pod", 1)
    dp = data * pods
    train = shape.kind == "train"
    replicated = shape.global_batch < dp
    mb = int(overrides.get("microbatch", 1))
    rows_per_replica = (shape.global_batch if replicated
                        else shape.global_batch // dp)
    n_micro = max(1, rows_per_replica // mb)
    base = pl.EngineConfig(
        n_trials=1, n_microbatches=n_micro, microbatch=mb,
        n_stages=n_stages, data_size=data, pod_size=pods,
        pod_axis="pod" if pods > 1 else None,
        fsdp=bool(int(overrides.get("fsdp", 1))),
        vocab_parallel=bool(int(overrides.get("vocab_parallel", 1))),
        batch_replicated=replicated,
        window=(cfg.sliding_window if shape.name == "long_500k" else 0),
        max_seq=shape.seq_len if shape.kind != "train" else 0,
    )
    chunks = int(overrides.get("prefill_chunks", 1))
    if shape.kind == "prefill" and chunks > 1 and cfg.frontend is None \
            and cfg.rope != "mrope":
        # sequence chunks become extra pipeline slots (Hydra slot-filling)
        base = dataclasses.replace(
            base, n_microbatches=base.n_microbatches * chunks,
            prefill_chunks=chunks)
    if train:
        k_cap = int(overrides.get("max_trials", 4))
        k = min(sched.max_concurrent_trials(cfg, base, shape.seq_len,
                                            train=True, param_dtype=DTYPE),
                k_cap)
        k = max(int(overrides.get("n_trials", k)), 1)
        base = dataclasses.replace(base, n_trials=k)
    return base


def model_options(overrides: dict) -> ModelOptions:
    """The reference's dry-run options: bf16, remat on, its attention
    chunks, expert chunks of 4, the kernels off."""
    return ModelOptions(
        compute_dtype=DTYPE,
        remat=bool(int(overrides.get("remat", 1))),
        attn_q_chunk=int(overrides.get("attn_q_chunk", 1024)),
        attn_kv_chunk=int(overrides.get("attn_kv_chunk", 512)),
        moe_expert_chunk=int(overrides.get("moe_expert_chunk", 4)),
        use_mamba_kernel=bool(int(overrides.get("use_mamba_kernel", 0))),
        use_flash_kernel=bool(int(overrides.get("use_flash_kernel", 0))))


def cell_structs(cfg: ArchConfig, shape: ShapeConfig, eng: pl.EngineConfig,
                 optimizer, device="meta", seed: int = 0) -> dict:
    """Every input of the cell's step as tensors on ``device`` (``meta``:
    no allocation; elsewhere random weights from ``seed`` and zero
    tokens): the trial-stacked parameters, the batch, and the optimizer
    state and hyperparameters (train) or the serve cache."""
    plan = plan_stages(cfg, eng.n_stages)
    max_pos = shape.seq_len if cfg.rope == "learned" else 0
    if torch.device(device).type == "meta":
        params = pl.trial_params_struct(cfg, eng, plan, dtype=DTYPE,
                                        max_pos=max_pos)
    else:  # random weights from a seed
        gen = torch.Generator(device=device).manual_seed(seed)
        params = pl.init_trial_params(cfg, eng, plan, gen, dtype=DTYPE,
                                      device=device, max_pos=max_pos)
    mbg = eng.microbatch * (1 if eng.batch_replicated
                            else eng.data_size * eng.pod_size)
    K, M = eng.n_trials, eng.n_microbatches
    qlen = shape.seq_len if shape.kind != "decode" else 1
    if shape.kind == "prefill" and eng.prefill_chunks > 1:
        qlen = shape.seq_len // eng.prefill_chunks
    new = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    batch = {"tokens": new((K, M, mbg, qlen), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = new((K, M, mbg, qlen), torch.int32)
    elif shape.kind == "decode":
        batch["positions"] = new((K, M, mbg), torch.int32)
    if cfg.frontend is not None and shape.kind != "decode":
        batch["frontend_embeds"] = new(
            (K, M, mbg, cfg.n_frontend_tokens, cfg.d_model), DTYPE)
    if cfg.rope == "mrope" and shape.kind != "decode":
        batch["mrope_pos"] = new((K, M, 3, mbg, qlen), torch.int32)
    out = {"params": params, "batch": batch}
    if shape.kind == "train":
        out["opt"] = optimizer.init(params)
        out["hparams"] = {"lr": new((K,), torch.float32),
                          "wd": new((K,), torch.float32)}
        out["step"] = 0
    else:
        out["cache"] = pl.serve_cache_struct(cfg, eng, device=device)
    return out


def step_fn(cfg: ArchConfig, shape: ShapeConfig, eng: pl.EngineConfig,
            opts: ModelOptions):
    """() -> runs the cell's step once on fresh ``meta`` inputs (built
    outside the returned call, so a count around it sees the step
    alone)."""
    optimizer = AdamW(grad_clip=1.0)
    s = cell_structs(cfg, shape, eng, optimizer)
    if shape.kind == "train":
        fn = pl.make_train_step(cfg, opts, eng, optimizer)
        return lambda: fn(s["params"], s["opt"], s["batch"], s["hparams"],
                          s["step"])
    mode = "prefill" if shape.kind == "prefill" else "decode"
    fn = pl.make_serve_step(cfg, opts, eng, mode)
    return lambda: fn(s["params"], s["cache"], s["batch"])


def count_at(cfg: ArchConfig, shape: ShapeConfig, eng: pl.EngineConfig,
             opts: ModelOptions, n_microbatches: int, n_layers: int,
             seq_len: int) -> costs_lib.Costs:
    """Counted costs of the cell's step with ``n_microbatches`` slots a
    trial, the stack cut to ``n_layers`` and sequences (or, in decode,
    caches) of ``seq_len``."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = dataclasses.replace(shape, seq_len=seq_len)
    eng = dataclasses.replace(eng, n_microbatches=n_microbatches,
                              max_seq=seq_len if eng.max_seq else 0)
    run = step_fn(cfg, shape, eng, opts)
    with costs_lib.count() as c:
        run()
    return c


def count_points(cfg: ArchConfig, shape: ShapeConfig, opts: ModelOptions):
    """(points, features) of the loop-aware count, points being
    (microbatches, layers, seq_len). A count is linear in 1, L and M·L for
    a homogeneous stack, plus the shared-block sites for a hybrid one (its
    layer points hold one, one and two sites). A long prefill or train
    sequence (8 or more units of the scan chunks and, where the arch
    attends, of the attention chunks, a unit long enough that attention
    is chunked) is also counted at 1, 2 and 3 units, the count being
    quadratic in the sequence over whole units (the chunked attention's
    blocks grow with its square, everything else with its length)."""
    if cfg.hybrid is None:
        layers = (1, 2)
        feats = lambda m, n: (1, n, m, m * n)
    else:
        a = cfg.hybrid.attn_every
        layers = (a + 1, a + 2, 2 * a + 1)
        sites = lambda n: sum(lm.shared_site_flags(
            dataclasses.replace(cfg, n_layers=n), 0, n)[0])
        feats = lambda m, n: (1, n, sites(n), m, m * n, m * sites(n))
    if cfg.attention_free:
        unit = math.lcm(SEQ_UNIT, cfg.ssm.chunk_size)
    else:
        unit = math.lcm(opts.attn_q_chunk, opts.attn_kv_chunk, SEQ_UNIT,
                        cfg.ssm.chunk_size if cfg.ssm is not None else 1)
        while unit * unit <= DIRECT_ATTENTION_SCORES:  # chunked everywhere
            unit *= 2
    seq = shape.seq_len
    if shape.kind == "decode" or seq < 8 * unit or seq % unit:
        return ([(m, n, seq) for m in (1, 2) for n in layers],
                lambda p: feats(p[0], p[1]))
    return ([(m, n, s) for m in (1, 2) for n in layers
             for s in (unit, 2 * unit, 3 * unit)],
            lambda p: tuple(f * p[2] ** e for f in feats(p[0], p[1])
                            for e in (0, 1, 2)))


def cell_costs(cfg: ArchConfig, shape: ShapeConfig, eng: pl.EngineConfig,
               opts: ModelOptions, counted=None) -> costs_lib.Costs:
    """The whole step's costs at the engine's M, the config's depth and the
    shape's sequence, extrapolated exactly from small counts
    (:func:`count_points`) — the counterpart of the reference's loop trip
    counts. ``counted`` maps points to counts made elsewhere (a worker
    pool's, :func:`count_grid`); missing points are counted here."""
    if eng.n_stages != 1:
        raise ValueError("the loop-aware count runs on the card layout "
                         "(one stage)")
    if cfg.layer_types:
        raise ValueError(f"{cfg.name}: the loop-aware count extrapolates a "
                         f"stack of one layer kind; a mixed stack's card "
                         f"cell is not counted")
    counted = counted or {}

    def at(p):
        c = counted.get(p) or count_at(cfg, shape, eng, opts, *p)
        if isinstance(c, BaseException):
            raise c
        return c

    points, feats = count_points(cfg, shape, opts)
    return costs_lib.extrapolate(
        at, points, feats, (eng.n_microbatches, cfg.n_layers, shape.seq_len))


def _count_task(arch: str, shape_name: str, overrides: dict, point):
    """One count of a card-layout cell (a worker process's task)."""
    cfg = (ASSIGNED_ARCHS | PAPER_ARCHS | EXTRA_ARCHS)[arch]
    shape = SHAPES[shape_name]
    eng = engine_for_cell(cfg, shape, make_card_mesh(), overrides)
    return count_at(cfg, shape, eng, model_options(overrides), *point)


def count_grid(cells, overrides: dict, workers: int) -> dict:
    """Every count of the card-layout ``cells`` ((cfg, shape) pairs), over
    ``workers`` spawned processes: {(arch, shape): {point: Costs, or the
    exception the count raised}}. The workers touch no card."""
    tasks = [(cfg.name, shape.name, p) for cfg, shape in cells
             for p in count_points(cfg, shape, model_options(overrides))[0]]
    # the longest counts first (more slots, layers and tokens), so the
    # pool's tail is short
    tasks.sort(key=lambda t: -t[2][0] * t[2][1] * (
        1 if SHAPES[t[1]].kind == "decode" else t[2][2]))
    out = {(a, s): {} for a, s, _ in tasks}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = {pool.submit(_count_task, a, s, overrides, p): (a, s, p)
                for a, s, p in tasks}
        for fut, (a, s, p) in futs.items():
            try:
                out[(a, s)][p] = fut.result()
            except Exception as e:  # the cell records it; the grid goes on
                out[(a, s)][p] = e
    return out


def card_bytes() -> tuple:
    """(the card's memory in bytes, where the number comes from)."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                "torch.cuda.get_device_properties")
    return roof.HBM_BYTES, "H100 SXM data sheet (no card present)"


def run_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
             overrides: dict, counted=None) -> dict:
    t0 = time.time()
    eng = engine_for_cell(cfg, shape, mesh, overrides)
    name = layout_name(mesh)
    modeled = sched.per_chip_bytes(
        cfg, eng, shape.seq_len, train=shape.kind == "train",
        **sched.state_bytes(DTYPE)).total * eng.n_trials
    row = {
        "arch": cfg.name, "shape": shape.name, "mesh": name,
        "layout": mesh_axis_sizes(mesh),
        "engine": {f.name: str(getattr(eng, f.name))
                   for f in dataclasses.fields(eng)},
        "n_chips": n_devices(mesh),
        "modeled_bytes_per_device": int(modeled),
        "model_flops": roof.model_flops_for_cell(cfg, shape, eng.n_trials),
    }
    if name != CARD_LAYOUT_NAME:
        row["per_device"] = (
            f"not measured: the per-device costs of a {n_devices(mesh)}-"
            f"device mesh, which one card cannot measure; see the card "
            f"layout")
        return row
    costs = cell_costs(cfg, shape, eng, model_options(overrides), counted)
    cap, source = card_bytes()
    rl = roof.from_costs(cfg, shape, name, n_chips=1, costs=costs,
                         n_trials=eng.n_trials, dtype=DTYPE)
    row.update({
        "timings_s": {"count": round(time.time() - t0, 1)},
        "card_bytes": int(cap), "card_bytes_source": source,
        "fits_card": bool(modeled < cap),
        "costs": costs.to_json(),
        "roofline": rl.row(),
    })
    return row


def run_grid(archs: dict, shapes: list, meshes: list, out: str,
             variant: str = "baseline", overrides: dict | None = None,
             force: bool = False, workers: int = 1) -> list:
    """Every (arch × shape) cell on each layout: writes
    ``<out>/<layout>/<variant>/<arch>__<shape>.json`` (a row or a recorded
    skip) or, for a cell that fails, its traceback in ``.json.err``.
    Returns the results, each with its ``path`` ({"cached": True} for a
    cell already written, unless ``force``; {"error": ...} for a failure).
    ``workers`` > 1 counts the card layout's cells in that many
    processes."""
    overrides = overrides or {}
    results = []
    for mesh in meshes:
        name = layout_name(mesh)
        os.makedirs(os.path.join(out, name, variant), exist_ok=True)
        todo = []
        for cfg in archs.values():
            for shape in shapes:
                path = os.path.join(out, name, variant,
                                    f"{cfg.name}__{shape.name}.json")
                ok, why = shape_applicable(cfg, shape)
                if os.path.exists(path) and not force:
                    results.append({"arch": cfg.name, "shape": shape.name,
                                    "mesh": name, "cached": True,
                                    "path": path})
                elif not ok:
                    res = {"arch": cfg.name, "shape": shape.name,
                           "mesh": name, "skipped": why}
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    results.append(dict(res, path=path))
                else:
                    todo.append((cfg, shape, path))
        counted = {}
        if name == CARD_LAYOUT_NAME and workers > 1 and todo:
            counted = count_grid([(c, s) for c, s, _ in todo], overrides,
                                 workers)
        for cfg, shape, path in todo:
            try:
                res = run_cell(cfg, shape, mesh, overrides,
                               counted.get((cfg.name, shape.name)))
            except Exception as e:  # the grid goes on; the cell records why
                with open(path + ".err", "w") as f:
                    f.write("".join(traceback.format_exception(e)))
                res = {"arch": cfg.name, "shape": shape.name, "mesh": name,
                       "error": f"{type(e).__name__}: {e}"}
            else:
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
            results.append(dict(res, path=path))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--layout", choices=("production", CARD_LAYOUT_NAME),
                    default="production",
                    help="production: 16x16 (2x16x16 with --multi-pod, "
                    "both with --both-meshes); card: one H100")
    ap.add_argument("--paper-archs", action="store_true",
                    help="also run bert-large (paper workload)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--set", action="append", default=[],
                    help="engine / option override key=val (fsdp, "
                    "microbatch, use_flash_kernel, ...)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes counting the card layout's cells")
    args = ap.parse_args(argv)

    overrides = dict(kv.split("=", 1) for kv in args.set)
    archs = dict(ASSIGNED_ARCHS)
    if args.paper_archs:
        archs["bert-large"] = PAPER_ARCHS["bert-large"]
    if args.arch:
        archs = {args.arch:
                 (ASSIGNED_ARCHS | PAPER_ARCHS | EXTRA_ARCHS)[args.arch]}
    shapes = [SHAPES[args.shape]] if args.shape else list(SHAPES.values())
    if args.layout == CARD_LAYOUT_NAME:
        meshes = [make_card_mesh()]
    elif args.both_meshes:
        meshes = [make_production_mesh(multi_pod=False),
                  make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]

    for res in run_grid(archs, shapes, meshes, args.out, args.variant,
                        overrides, args.force, args.workers):
        tag = f"{res['mesh']} {res['arch']} {res['shape']}"
        if "cached" in res:
            line = f"[skip-cached] {tag}"
        elif "skipped" in res:
            line = f"[skip] {tag}: {res['skipped']}"
        elif "error" in res:
            line = f"[FAIL] {tag}: {res['error']}"
        else:
            line = (f"[ ok ] {tag} modeled="
                    f"{res['modeled_bytes_per_device'] / 1e9:.2f}GB")
            if "roofline" in res:
                r = res["roofline"]
                line += (f" fits_card={res['fits_card']} "
                         f"dom={r['dominant']} "
                         f"roofline={r['roofline_fraction']:.4f}")
        print(line, flush=True)  # noqa: T201


if __name__ == "__main__":
    main()
