"""Hydra's pipelined multi-trial programs — training and serving — run by
one process (PyTorch port of ``repro/core/pipeline.py``).

The reference compiles one SPMD program over a (data × model) or (pod ×
data × model) device mesh. The port keeps the schedule's semantics
exactly — the tests compare losses, gradients, tokens, ticks and call
counts with the reference — and runs it in one of two ways:

* **one device** (no layout, the default): the mesh is structure inside
  one process on one device;
* **a device layout** (``layout=`` to ``make_train_step``,
  ``make_serve_step``, ``make_slot_reset`` and ``make_transfer_kernels``):
  stage ``s`` of data replica ``(p, d)`` runs on device ``(p, d, s)`` of a
  ``launch.mesh.DeviceLayout``, each device holding its own shard of the
  parameters (:func:`place_trial_params`, the counterpart of
  ``param_pspecs``) and, in serving, its stage's layers of its shard's
  cache (:func:`place_serve_cache`, the counterpart of
  ``serve_cache_pspecs``). One process issues every (stage, replica) unit
  on its own device; activations hop with ``.to``, the vocab-parallel
  partials are added on stage 0 and stage S−1 (the reference's psums),
  and FSDP gathers each layer's full weights on the unit's device. In
  training the FSDP join's autograd is the reduce-scatter, replicated
  leaves get their gradients summed over replicas
  (:func:`reduce_placed_grads`), and one ``backward()`` runs through all
  devices. In serving each unit indexes its own shard's pool with the
  tables' shard-local ids, and the greedy head's per-stage (max, argmax)
  pairs meet on the layout's root.

What the one-device form does with the mesh:

  * **stages.** Each tick ``t`` advances stage ``s`` on slot ``t - s`` in the
    reference's tick order; activations hop stage to stage through a Python
    list. A (stage, tick) pair whose slot is out of range (pipeline fill and
    drain bubbles) is skipped outright: in the reference its writes are
    masked and its outputs never reach ``tok_out``.
  * **slots.** The slot stream interleaves (trial k, microbatch m) pairs
    round-robin, ``k = slot % K``; the K trial rows index params, pools and
    block tables, so one call advances cells of K model variants.
  * **vocab shards.** The embedding and LM head stay padded to a multiple
    of S and the greedy head reproduces the reference's vocab-parallel
    argmax over S logical shards, tie rule included.
  * **data shards.** Row ``r`` of the global microbatch belongs to shard
    ``r // microbatch``; its block table holds *shard-local* ids into the
    pool slice ``[shard·n_blocks/dp, (shard+1)·n_blocks/dp)``, and the
    program adds that offset before touching the pool. In training the
    shards are equal row blocks of one global microbatch, so the mean over
    all its rows is the reference's psum of per-shard means divided by the
    data-parallel degree. The MoE FFN couples the rows of a call
    (capacity, drops, the load-balance term), so every call routes each
    shard's rows on their own (``n_shards`` through ``lm.stack_apply``),
    as the reference does inside ``shard_map``.
  * **gradients.** The reference differentiates *through* the scanned
    pipeline; here one ``backward()`` runs through the tick loop, so each
    trial's gradient is exactly the unpipelined one (paper desideratum D3).

Pools, caches, parameters and optimizer state are updated in place (the
reference donates them).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partitioner import StagePlan, plan_stages
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models.layers import ModelOptions
from repro_torch.obs import tracer as obs_tracer
from repro_torch.tree import tree_leaves, tree_map, tree_paths


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of one Hydra gang (same-architecture trials).

    In serving the K trial rows double as the co-serving axis: each row
    holds one model variant's weights and cache, and the serve engine
    routes per-arch request streams into the matching rows.

    The layout fields after ``vocab_parallel`` are the reference's for a
    device mesh (the axis names, the pod axis, FSDP, a batch replicated
    over the data axis). The placed train step runs them on a device
    layout; the dry-run records them for its production layouts, and the
    memory model (``core/scheduler.py``) counts them as the reference
    does. Without a layout the train and serve steps refuse an engine
    whose fields need one (:func:`check_runnable`).
    """

    n_trials: int  # K — concurrent model variants
    n_microbatches: int  # M — slots per trial per call
    microbatch: int  # rows per (slot × data (× pod) replica)
    n_stages: int  # S — pipeline stages
    data_size: int = 1  # logical data shards (pool partitions per trial)
    max_seq: int = 0  # per-request token capacity
    cache_dtype: torch.dtype = torch.bfloat16
    window: int = 0  # sliding attention window in serving (0 = full); the
    # caches keep their absolute max_seq layout
    paged: bool = False  # KV in a shared block pool; False = dense per-slot
    # cache strips (the only layout for the ssm family)
    block_size: int = 16  # tokens per block
    n_blocks: int = 0  # pool size PER TRIAL; each data shard owns an equal
    # slice of n_blocks / data_size blocks
    host_blocks: int = 0  # host-memory spill tier PER POOL PARTITION (serve
    # BlockStore): evicted prefix-cache blocks and retracted requests' KV
    # swap out here instead of being destroyed; 0 = no host tier
    prefill_chunks: int = 1  # admission chunks per prompt (serve engine)
    vocab_parallel: bool = True  # train loss over S logical vocab shards
    # (per-shard max / sum-exp, as the reference's psum form) and the
    # embedding's learned positions split over the stages (zero past the
    # table); False = one plain CE over the full head, clamped positions
    pod_size: int = 1  # size of the pod axis (1 = single pod)
    stage_axis: str = "model"
    data_axis: str = "data"
    pod_axis: Optional[str] = None
    fsdp: bool = False  # layer weights sharded over the data axis
    batch_replicated: bool = False  # batch too small to shard (long_500k)

    @property
    def n_slots(self) -> int:
        return self.n_trials * self.n_microbatches

    @property
    def n_ticks(self) -> int:
        return self.n_slots + self.n_stages - 1

    @property
    def dp_degree(self) -> int:
        """Data-parallel replicas: the data axis times the pod axis."""
        return self.data_size * self.pod_size

    @property
    def mb_global(self) -> int:
        """Rows of one global microbatch: every replica's ``microbatch``
        rows, or one replica's when the batch is replicated."""
        return self.microbatch * (1 if self.batch_replicated
                                  else self.dp_degree)

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.n_ticks

    @property
    def cache_groups(self) -> int:
        """Distinct dense caches per trial in serving: chunked prefill
        (``prefill`` mode) shares one cache per request group across its
        sequence-chunk slots (the serve engine sets ``prefill_chunks`` to
        1, so each of its microbatch slots owns one)."""
        if self.prefill_chunks > 1:
            return self.n_microbatches // self.prefill_chunks
        return self.n_microbatches

    def padded_vocab(self, vocab: int) -> int:
        s = self.n_stages
        return -(-vocab // s) * s


def check_runnable(eng: EngineConfig) -> None:
    """Refuse, for the one-device steps, an engine whose layout fields
    need a device layout: FSDP over several data rows and the pod axis
    place shards on several devices, and so does a batch replicated over
    data rows (over one data row these fields change nothing). The
    placed steps run them (``layout=`` to ``make_train_step`` or
    ``make_serve_step``)."""
    if eng.pod_size > 1 or (eng.data_size > 1
                            and (eng.fsdp or eng.batch_replicated)):
        raise ValueError(
            "without a device layout the port runs on one card: pod_size "
            "> 1, and fsdp or a replicated batch over data rows, need the "
            "placed steps (make_train_step(..., layout=), "
            "make_serve_step(..., layout=))")


def check_layout(eng: EngineConfig, layout, cfg=None) -> None:
    """The layout's (pod, data, model) grid must be the engine's, and the
    stack's layers all of one kind (a mixed stack's layers are a list,
    which the placement's stage slices do not split)."""
    if cfg is not None and cfg.layer_types:
        raise ValueError(f"{cfg.name}: a stack of mixed layer kinds runs on "
                         f"one device (no layout)")
    want = (eng.pod_size, eng.data_size, eng.n_stages)
    if tuple(layout.devices.shape) != want:
        raise ValueError(f"the engine's (pod, data, model) sizes {want} do "
                         f"not match the layout's "
                         f"{tuple(layout.devices.shape)}")


# ---------------------------------------------------------------------------
# Parameters: trial-stacked, vocab padded to a multiple of S
# ---------------------------------------------------------------------------


def init_trial_params(cfg: ArchConfig, eng: EngineConfig, plan: StagePlan,
                      gen: torch.Generator, dtype=torch.float32, device=None,
                      max_pos: int = 0):
    """K trials' parameters stacked on a leading K axis: layer leaves
    (K, Lp, ...) over the stage-padded stack, embed (K, Vp, D) and head
    (K, D, Vp) zero-padded to a multiple of S; ``rope="learned"`` archs
    get the position table embed/pos (K, max_pos, D)."""
    trials = [lm.init_params(cfg, gen, dtype=dtype,
                             n_layers=plan.padded_layers, device=device,
                             max_pos=max_pos)
              for _ in range(eng.n_trials)]

    params = tree_map(lambda *leaves: (leaves[0][None] if len(leaves) == 1
                                       else torch.stack(leaves)), *trials)
    del trials
    pad = eng.padded_vocab(cfg.vocab_size) - cfg.vocab_size
    if pad:
        params["embed"]["tok"] = F.pad(params["embed"]["tok"],
                                       (0, 0, 0, pad))
        if "head" in params:
            params["head"] = F.pad(params["head"], (0, pad))
    return params


def trial_params_struct(cfg: ArchConfig, eng: EngineConfig, plan: StagePlan,
                        dtype=torch.bfloat16, max_pos: int = 0):
    """The trial-stacked parameter tree on the ``meta`` device (the
    dry-run's stand-in for the reference's ShapeDtypeStructs): built by
    :func:`init_trial_params` itself, so it has that function's leaves,
    shapes and dtypes, and nothing is allocated."""
    return init_trial_params(cfg, eng, plan, torch.Generator(), dtype=dtype,
                             device="meta", max_pos=max_pos)


# ---------------------------------------------------------------------------
# Placement on a device layout: the counterpart of ``param_pspecs``
# ---------------------------------------------------------------------------


def fsdp_dim(layer_leaf_shape, data_size: int) -> Optional[int]:
    """The dim of one layer's leaf that FSDP splits over the data axis (the
    reference's ``_fsdp_dim``): the first dim divisible by the data size;
    vectors stay replicated."""
    if len(layer_leaf_shape) < 2:
        return None
    for d, size in enumerate(layer_leaf_shape):
        if size % data_size == 0 and size >= data_size:
            return d
    return None


@dataclasses.dataclass(frozen=True)
class Split:
    """How one trial-stacked leaf lies on a device layout: the axis split
    over the stages and the axis split over the data rows (None = that
    axis replicates the leaf)."""

    stage: Optional[int] = None
    data: Optional[int] = None


@functools.lru_cache(maxsize=64)
def param_splits(cfg: ArchConfig, eng: EngineConfig):
    """A :class:`Split` per parameter leaf, as the reference's
    ``param_pspecs`` places it (cached: its ``meta`` build of the tree
    takes seconds at full width, and every placed step reads it; callers
    only read the tree):

    layers/*   : (K, Lp, ...)   -> stage axis 1, FSDP dim over data
    embed/tok  : (K, Vp, D)     -> stage axis 1      [vocab-parallel]
    embed/pos  : (K, maxpos, D) -> stage axis 1      [position-parallel]
    head       : (K, D, Vp)     -> stage axis 2      [vocab-parallel]
    final_norm, shared/*        -> replicated
    """
    struct = trial_params_struct(cfg, eng, plan_stages(cfg, eng.n_stages),
                                 max_pos=eng.n_stages)

    def split(leaf, name):
        if name.startswith("layers/"):
            d = fsdp_dim(leaf.shape[2:], eng.data_size) if eng.fsdp else None
            return Split(1, None if d is None else d + 2)
        if name in ("embed/tok", "embed/pos") and eng.vocab_parallel:
            return Split(1)
        if name == "head" and eng.vocab_parallel:
            return Split(2)
        return Split()

    return tree_map(split, struct, tree_paths(struct))


def _local_slice(x, sp: Split, d: int, s: int, n_data: int, n_stages: int):
    """Device (·, d, s)'s slice of the stacked leaf ``x`` (a view)."""
    for axis, i, n in ((sp.stage, s, n_stages), (sp.data, d, n_data)):
        if axis is None:
            continue
        if x.shape[axis] % n:
            raise ValueError(f"leaf dim {axis} of shape {tuple(x.shape)} "
                             f"does not split into {n}")
        w = x.shape[axis] // n
        x = x.narrow(axis, i * w, w)
    return x


def _grid(layout, fn):
    """``fn(p, d, s)`` over the layout, as nested lists [p][d][s]."""
    n_pod, n_data, n_st = layout.devices.shape
    return [[[fn(p, d, s) for s in range(n_st)] for d in range(n_data)]
            for p in range(n_pod)]


def place_trial_params(cfg: ArchConfig, eng: EngineConfig, params, layout):
    """The trial-stacked tree split over a device layout: nested lists
    ``[p][d][s]`` of device ``(p, d, s)``'s own tree (its leaves the local
    shards of :func:`param_splits`, each a fresh contiguous tensor on that
    device, so replicas never alias). ``params`` is left as it was."""
    check_layout(eng, layout, cfg)
    splits = param_splits(cfg, eng)

    def local(p, d, s):
        dev = layout.device(p, d, s)

        def one(sp, x):
            x = _local_slice(x, sp, d, s, eng.data_size, eng.n_stages)
            return torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)

        return tree_map(one, splits, params)

    with torch.no_grad():
        return _grid(layout, local)


def gather_trial_params(cfg: ArchConfig, eng: EngineConfig, placed, layout,
                        device=None):
    """The inverse of :func:`place_trial_params`, bit for bit: the
    trial-stacked tree on ``device`` (default the layout's root; ``meta``
    gives shapes and dtypes only), from pod 0's shards. Also gathers any
    tree of the same placement, such as the optimizer's moments."""
    dev = layout.root if device is None else torch.device(device)
    n_data, n_st = eng.data_size, eng.n_stages
    shards = [placed[0][d][s] for d in range(n_data) for s in range(n_st)]

    def one(sp, *ls):
        def at(d, s):
            return ls[d * n_st + s]

        def column(s):  # stage s's shard, its data rows joined
            if sp.data is None:
                return at(0, s).to(dev)
            return torch.cat([at(d, s).to(dev) for d in range(n_data)],
                             dim=sp.data)

        if sp.stage is None:
            return at(0, 0).to(dev, copy=True)
        return torch.cat([column(s) for s in range(n_st)], dim=sp.stage)

    with torch.no_grad():
        return tree_map(one, param_splits(cfg, eng), *shards)


def scatter_trial_params_(cfg: ArchConfig, eng: EngineConfig, placed, tree,
                          layout):
    """Copy a trial-stacked tree (any device) into every shard of
    ``placed``, in place (a checkpoint's restore); returns ``placed``."""
    splits = param_splits(cfg, eng)

    def fill(p, d, s):
        tree_map(lambda sp, full, loc: loc.copy_(_local_slice(
            full, sp, d, s, eng.data_size, eng.n_stages)),
            splits, tree, placed[p][d][s])

    with torch.no_grad():
        _grid(layout, fill)
    return placed


# ---------------------------------------------------------------------------
# Vocab-parallel embedding / greedy head over S logical shards
# ---------------------------------------------------------------------------


def vp_embed(cfg: ArchConfig, eng: EngineConfig, embed_k, tokens,
             positions=None, compute_dtype=torch.float32):
    """Vocab-parallel embedding. The reference gathers each token's row on
    the one stage owning it and psums S−1 exact zeros onto it, so the
    result equals a plain gather from the padded table bit for bit. Its
    learned position table (``rope="learned"``) is split over the stages
    the same way, so a position past the table is owned by no stage and
    adds zero (:func:`plain_embed` clamps it to the last row instead)."""
    x = lm.embed_tokens(cfg, embed_k, tokens, compute_dtype=compute_dtype)
    if cfg.rope == "learned" and positions is not None:
        tab = embed_k["pos"]
        pos = positions.long()
        rows = tab[pos.clamp(max=tab.shape[0] - 1)].to(x.dtype)
        x = x + torch.where((pos < tab.shape[0])[..., None], rows,
                            torch.zeros_like(rows))
    return x


def vp_greedy_tokens(cfg: ArchConfig, eng: EngineConfig, norm_p, head_k, y):
    """Greedy argmax at every position, y (b, s, D) -> ((b, s) int32
    winners, (b, s) float32 max logits): each of the S vocab shards takes
    its own max and first argmax, and an exact tie between shards returns
    the lowest tied id, which is what one argmax over the whole vocabulary
    returns. (The reference returns the mean of the tied argmaxes,
    ``psum(where(lmax >= gmax, larg)) // count``: a token that is neither.
    In bf16 the logits are rounded before the argmax and such ties occur
    every few hundred tokens.)"""
    x = lm.final_norm_apply(cfg, norm_p, y)
    logits = (x @ head_k).float()  # (b, s, Vp)
    vp, S = logits.shape[-1], eng.n_stages
    v_s = vp // S
    gid = torch.arange(vp, device=logits.device)
    logits = logits.masked_fill(gid >= cfg.vocab_size, -1e30)
    sh = logits.reshape(*logits.shape[:-1], S, v_s)
    lmax = sh.amax(dim=-1)  # (b, s, S)
    larg = sh.argmax(dim=-1) + torch.arange(S, device=sh.device) * v_s
    gmax = lmax.amax(dim=-1, keepdim=True)
    winner = torch.where(lmax >= gmax, larg, vp).amin(dim=-1)
    return winner.to(torch.int32), gmax[..., 0]


def vp_greedy_token(cfg: ArchConfig, eng: EngineConfig, norm_p, head_k, y):
    """Greedy next token, y (b, 1, D) -> ((b,) int32, (b,) float32)."""
    tok, gmax = vp_greedy_tokens(cfg, eng, norm_p, head_k, y)
    return tok[:, 0], gmax[:, 0]


# ---------------------------------------------------------------------------
# Embedding and loss heads of the train program
# ---------------------------------------------------------------------------


def plain_embed(cfg: ArchConfig, eng: EngineConfig, embed_k, tokens,
                positions=None, compute_dtype=torch.float32):
    """Embedding from the full (padded) table of one trial; learned
    positions past the table clamp to its last row."""
    return lm.embed_tokens(cfg, embed_k, tokens, positions=positions,
                           compute_dtype=compute_dtype)


def vp_loss(cfg: ArchConfig, eng: EngineConfig, norm_p, head_k, y, labels):
    """Vocab-parallel cross-entropy (mean over tokens) over S logical vocab
    shards of one trial's padded head (D, Vp): each shard's logits, the
    global max from the per-shard maxima (a pure stabilizer: detached, as
    the reference's stop_gradient), per-shard sums of exp summed over the
    shards, and the label's logit from the shard that owns it."""
    x = lm.final_norm_apply(cfg, norm_p, y)
    logits = lm.head_logits(cfg, x, head_k).float()  # (b, s, Vp)
    vp, S = logits.shape[-1], eng.n_stages
    gid = torch.arange(vp, device=logits.device)
    logits = logits.masked_fill(gid >= cfg.vocab_size, -1e30)
    sh = logits.reshape(*logits.shape[:-1], S, vp // S)
    lmax = sh.detach().amax(dim=-1).amax(dim=-1)  # (b, s)
    sumexp = torch.exp(sh - lmax[..., None, None]).sum(dim=-1).sum(dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = torch.log(sumexp) + lmax - ll
    return nll.mean()


def plain_loss(cfg: ArchConfig, eng: EngineConfig, norm_p, head_k, y,
               labels):
    x = lm.final_norm_apply(cfg, norm_p, y)
    return lm.cross_entropy(lm.head_logits(cfg, x, head_k), labels)


# ---------------------------------------------------------------------------
# Training: the pipelined multi-trial loss, run tick by tick
# ---------------------------------------------------------------------------


def unstack_trials(params):
    """The trial-stacked parameter dict -> a list over K of per-trial dicts
    whose ``"layers"`` is a list of per-layer dicts (all views; a mixed
    stack's layers are a list already, each leaf trial-stacked)."""
    n_k = params["embed"]["tok"].shape[0]
    out = []
    for k in range(n_k):
        p_k = lm.layer_slice({n: v for n, v in params.items()
                              if n != "layers"}, k)
        p_k["layers"] = lm.layer_list(lm.layer_slice(params["layers"], k))
        out.append(p_k)
    return out


def _hop(x, dst):
    """An activation's ``.to`` between stages of the placed step: a
    ``train.hop`` span and its bytes counted under the current tracer."""
    tr = obs_tracer.current()
    if not tr.enabled:
        return x.to(dst, non_blocking=True)
    nbytes = x.numel() * x.element_size()
    with tr.span("train.hop", src=str(x.device), dst=str(dst),
                 bytes=nbytes):
        tr.count("hop_bytes", nbytes)
        return x.to(dst, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class _Placement:
    """Where one call's tick loop runs unit (replica ``r``, stage ``s``)
    and what it finds there: :func:`_one_device` or :func:`_on_layout`."""

    replicas: list  # (p, d) of each data-parallel replica
    device: Callable  # (r, s) -> the unit's device
    rows: dict  # (r, s) -> replica r's batch rows there, and their "pos"
    views: dict  # (r, s) -> per-trial dicts of the parameters there
    grads: Optional[dict]  # (r, s) -> the gradient buffer's, or None
    split_vocab: bool  # each stage's device holds a vocab slice
    fsdp: bool  # each data row's device holds a shard of the layers
    n_shards: int  # MoE routing shards of a unit's rows
    hop: bool  # an activation crosses each stage boundary with _hop
    divisor: int  # the objective is the replicas' sum over it
    reduce: Callable  # grads -> (grads, per-trial grad norm)
    root: torch.device  # where the objective and the metrics are gathered


def _one_device(cfg: ArchConfig, eng: EngineConfig, params, grads,
                batch) -> _Placement:
    """One replica on the parameters' device over the whole global
    microbatch, whose rows route as ``eng.data_size`` MoE shards (so its
    loss already is the reference's mean over them); stage s sees each
    trial's views with its own layers."""
    S, l_s = eng.n_stages, plan_stages(cfg, eng.n_stages).layers_per_stage
    dev = params["embed"]["tok"].device
    rows = {n: v.to(dev) for n, v in batch.items()}
    mbg, seq = rows["tokens"].shape[-2:]
    rows["pos"] = torch.arange(seq, device=dev).expand(mbg, seq)

    def by_stage(tree):
        trials = unstack_trials(tree)
        return {((0, 0), s): [dict(p, layers=p["layers"][s * l_s:
                                                         (s + 1) * l_s])
                              for p in trials] for s in range(S)}

    return _Placement(
        [(0, 0)], lambda r, s: dev, {((0, 0), s): rows for s in range(S)},
        by_stage(params), None if grads is None else by_stage(grads),
        split_vocab=False, fsdp=False, n_shards=eng.data_size, hop=False,
        divisor=1, reduce=functools.partial(reduce_grads, cfg, eng),
        root=dev)


def _on_layout(cfg: ArchConfig, eng: EngineConfig, layout, params, grads,
               batch) -> _Placement:
    """A replica per (pod, data) row of ``layout``: unit (s, slot) of
    replica (p, d) runs on device (p, d, s) over that replica's rows (its
    MoE rows one shard) and the views of that device's shards, and the
    objective is the replicas' sum over ``eng.dp_degree`` (the
    reference's)."""
    reps = [(p, d) for p in range(eng.pod_size)
            for d in range(eng.data_size)]
    units = [(r, s) for r in reps for s in range(eng.n_stages)]
    dev = lambda r, s: layout.device(*r, s)
    seq = batch["tokens"].shape[-1]
    rows = {(r, s): dict(_replica_rows(eng, batch, *r, dev(r, s)),
                         pos=torch.arange(seq, device=dev(r, s)).expand(
                             eng.microbatch, seq)) for r, s in units}
    views = lambda tree: {(r, s): unstack_trials(tree[r[0]][r[1]][s])
                          for r, s in units}
    return _Placement(
        reps, dev, rows, views(params),
        None if grads is None else views(grads),
        split_vocab=eng.vocab_parallel, fsdp=eng.fsdp, n_shards=1, hop=True,
        divisor=eng.dp_degree,
        reduce=functools.partial(reduce_placed_grads, cfg, eng, layout),
        root=layout.root)


def _unit_leaves(p, g, names):
    """One unit's own autograd leaves of the entries ``names`` of a
    per-trial dict of views ``p``, each ``.grad`` preset to the matching
    view in ``g`` (the gradient buffer's dict; None: ``p``'s views, a loss
    differentiated through the parameters). A leaf that several units
    shared would have one AccumulateGrad node, and autograd would hold
    the sum of the gradients that reach it until the last use's arrived:
    a gradient-sized buffer for each leaf still awaited (up to the whole
    model's gradient). A leaf per unit adds each gradient into the buffer
    when it is computed, in the same order, so the sums are the same.
    (Views of the stacked leaves, not slices taken inside autograd: those
    would materialize a zero-filled full-size gradient per use.)"""
    pick = lambda t: {n: t[n] for n in names}  # a name twice: one entry
    if g is None:
        return pick(p)

    def leaf(v, gv):
        t = v.detach().requires_grad_()
        t.grad = gv
        return t

    return tree_map(leaf, pick(p), pick(g))


def _train_loss(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                place: _Placement):
    """The tick loop of :func:`pipeline_train_loss` and of the train step,
    on either placement, over every replica. Returns (losses, auxes),
    lists over the replicas of their (K,) per-trial losses and MoE aux
    (see :func:`pipeline_train_loss`) on their last-stage devices."""
    S, K, M = eng.n_stages, eng.n_trials, eng.n_microbatches
    l_s = plan_stages(cfg, S).layers_per_stage
    rows, dev, cdt = place.rows, place.device, opts.compute_dtype

    def unit_params(r, s, k):
        """Unit (r, s, k)'s leaves: its layers (with FSDP every data row's
        shard, joined by ``"gather"``), the hybrid's shared block where
        the stage has a site, and ``"ends"``: the embedding at stage 0,
        the final norm and the head (or the tied embedding) at the last
        stage, from every stage's device where the vocab is split."""
        def take(rep, j, names):  # from replica rep's stage-j device
            g = None if place.grads is None else place.grads[rep, j][k]
            return _unit_leaves(place.views[rep, j][k], g, names)

        # lists, not sets: the same order of leaves in every process
        own, ends = ["layers"], ["embed"] if s == 0 else []
        if cfg.hybrid is not None and any(
                lm.shared_site_flags(cfg, s * l_s, l_s)[0]):
            own.append("shared")
        if s == S - 1:
            ends += ["final_norm",
                     "head" if "head" in place.views[r, s][k] else "embed"]
        q = take(r, s, own)
        q["gather"] = None
        if place.fsdp:
            peers = [q["layers"] if e == r[1] else
                     take((r[0], e), s, ["layers"])["layers"]
                     for e in range(eng.data_size)]
            q["gather"] = _layer_gather(cfg, eng, dev(r, s), r[1], peers)
        q["ends"] = [take(r, j, ends) for j in (
            range(S) if place.split_vocab else [s])]
        return q

    def embed(q, r, k, m):
        if not place.split_vocab:
            here = rows[r, 0]
            return (vp_embed if eng.vocab_parallel else plain_embed)(
                cfg, eng, q["ends"][0]["embed"], here["tokens"][k, m],
                here["pos"], cdt)
        parts = [_vp_embed_part(cfg, e["embed"], rows[r, j]["tokens"][k, m],
                                rows[r, j]["pos"], j, cdt).to(dev(r, 0))
                 for j, e in enumerate(q["ends"])]
        return sum(parts[1:], parts[0])

    def loss(q, r, k, m, y):
        if not place.split_vocab:
            e = q["ends"][0]
            return (vp_loss if eng.vocab_parallel else plain_loss)(
                cfg, eng, e["final_norm"], lm.head_of(e), y,
                rows[r, S - 1]["labels"][k, m])
        return _vp_loss_placed(
            cfg, q["ends"], y, [rows[r, j]["labels"][k, m] for j in range(S)],
            [dev(r, j) for j in range(S)])

    def unit(x, q, r, s, k, m):
        """One (stage, slot) pair of replica ``r``: embed at stage 0, the
        stage's layers, the loss at the last stage."""
        tr = obs_tracer.current()
        with (tr.span("train.unit", tr.train_pass, t=s + m * K + k, s=s,
                      k=k, m=m, dev=str(dev(r, s)))
              if tr.enabled else obs_tracer.NO_SPAN):
            here = rows[r, s]
            if s == 0:
                x = embed(q, r, k, m)
                if "frontend_embeds" in here:
                    x = lm.replace_frontend_rows(
                        x, here["frontend_embeds"][k, m])
            lo = s * l_s
            # a hybrid trial's one shared block serves every stage's sites:
            # its gradients from all stages add up in the one backward()
            # and in one buffer (the reference's psum over the stage axis)
            x, _, aux = lm.stack_apply(
                cfg, opts, q["layers"], x,
                pos=here["mrope_pos"][k, m] if "mrope_pos" in here
                else here["pos"], mode="train",
                shared_params=q.get("shared"),
                layer_mask=[lo + i < cfg.n_layers for i in range(l_s)],
                layer_offset=lo, n_shards=place.n_shards,
                layer_param_fn=q["gather"])
            if s == S - 1:
                return loss(q, r, k, m, x), aux
            return x, aux

    # the reference's tick-level remat: each (stage, slot) pair keeps only
    # its input and is recomputed in backward
    remat = opts.remat and torch.is_grad_enabled()
    losses = {r: [[] for _ in range(K)] for r in place.replicas}
    auxes = {r: [[] for _ in range(K)] for r in place.replicas}
    acts = {}  # (r, s) -> stage s's output of the previous tick
    for t in range(eng.n_ticks):
        nxt = {}
        for s in range(S):
            slot = t - s
            if not 0 <= slot < eng.n_slots:
                continue  # fill/drain bubble: masked in the reference
            k, m = slot % K, slot // K
            for r in place.replicas:
                x = acts[r, s - 1] if s else None
                if s and place.hop:
                    x = _hop(x, dev(r, s))
                q = unit_params(r, s, k)
                out, aux = (checkpoint(unit, x, q, r, s, k, m,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
                            if remat else unit(x, q, r, s, k, m))
                auxes[r][k].append(aux)
                if s == S - 1:
                    losses[r][k].append(out)
                else:
                    nxt[r, s] = out
        acts = nxt
    return ([torch.stack([sum(ls) for ls in losses[r]]) / M
             for r in place.replicas],
            [torch.stack([sum(a.to(dev(r, S - 1)) for a in ax)
                          for ax in auxes[r]]) / M for r in place.replicas])


def pipeline_train_loss(cfg: ArchConfig, opts: ModelOptions,
                        eng: EngineConfig, params, batch, layout=None):
    """Runs the multi-trial pipelined forward; returns per-trial (loss, aux)
    (K,) tensors: each trial's mean loss over its M slots, and its MoE
    load-balance term, each (stage, slot) pair's sum over its real layers
    of the mean over data shards, summed over stages and slots and divided
    by M (the reference's psum over stages of the per-shard accumulator;
    zero for the other families).

    params: the trial-stacked dict (layers (K, Lp, ...), embed/tok
    (K, Vp, D), head (K, D, Vp), final_norm (K, D)). batch: tokens / labels
    (K, M, mb_global, seq), tensors or numpy, plus the frontend archs'
    ``frontend_embeds`` (K, M, mb_global, nf, d), which replace the first
    nf embedded rows of every slot, and the M-RoPE archs' ``mrope_pos``
    (K, M, 3, mb_global, seq). Each tick ``t`` advances stage ``s`` on
    slot ``t - s`` (trial ``slot % K``, microbatch ``slot // K``); bubble
    pairs are skipped. Differentiable w.r.t. ``params``.

    With ``layout``, ``params`` is the placed tree of
    :func:`place_trial_params` and the (loss, aux) come back as the means
    over the replicas, on the layout's root device.
    """
    batch = _train_batch(batch)
    place = (_one_device(cfg, eng, params, None, batch) if layout is None
             else _on_layout(cfg, eng, layout, params, None, batch))
    losses, auxes = _train_loss(cfg, opts, eng, place)
    return _replica_mean(place.root, losses), _replica_mean(place.root, auxes)


def _train_batch(batch):
    """tokens / labels and any frontend_embeds / mrope_pos (tensors or
    numpy) as tensors: tensors stay where they are, numpy arrays come to
    the CPU."""
    out = {}
    for n in ("tokens", "labels", "frontend_embeds", "mrope_pos"):
        if n in batch:
            v = batch[n]
            out[n] = v if torch.is_tensor(v) else torch.from_numpy(
                np.ascontiguousarray(v))
    return out


def reduce_grads(cfg: ArchConfig, eng: EngineConfig, grads):
    """Per-trial global gradient norm (K,) over the stacked gradient tree.
    (On one device there is nothing to reduce across shards: the mean over
    the global microbatch already is the data-parallel reduction.) Returns
    (grads, grad_norm)."""
    leaves = tree_leaves(grads)
    k = leaves[0].shape[0]
    sq = sum(torch.linalg.vector_norm(g.reshape(k, -1).float(), dim=1)
             .square() for g in leaves)
    return grads, torch.sqrt(sq)


# ---------------------------------------------------------------------------
# Training on a device layout: every (stage, replica) unit on its device
# ---------------------------------------------------------------------------


def _vp_embed_part(cfg: ArchConfig, embed_local, tokens, positions, s_idx,
                   compute_dtype):
    """Stage ``s_idx``'s share of the vocab-parallel embedding (the
    reference's masked local gather): its vocab slice's rows, zero for a
    token another stage owns; learned positions split the same way."""
    def part(tab, ids):
        n = tab.shape[0]
        local = ids.long() - s_idx * n
        rows = tab[local.clamp(0, n - 1)]
        return torch.where(((local >= 0) & (local < n))[..., None], rows,
                           torch.zeros_like(rows)).to(compute_dtype)

    x = part(embed_local["tok"], tokens)
    if cfg.rope == "learned" and positions is not None:
        x = x + part(embed_local["pos"], positions)
    return x


def _vp_loss_placed(cfg: ArchConfig, stage_params, y, labels, devices):
    """Vocab-parallel CE (mean over tokens) with each stage's vocab slice
    on its own device: ``stage_params[s]`` holds stage s's final_norm and
    head slice (D, Vp/S), ``labels[s]`` the labels on ``devices[s]``. y
    (on the last stage) goes to every stage; the per-stage maxima, sums of
    exp and owned label logits come back to the last stage and add up
    there (the reference's all_gather / psums)."""
    last = devices[-1]
    logits = []
    for s, (p, dev) in enumerate(zip(stage_params, devices)):
        x = lm.final_norm_apply(cfg, p["final_norm"], y.to(dev))
        lg = (x @ p["head"]).float()  # (b, seq, Vp / S)
        v_s = lg.shape[-1]
        gid = s * v_s + torch.arange(v_s, device=dev)
        logits.append(lg.masked_fill(gid >= cfg.vocab_size, -1e30))
    lmax = torch.stack([lg.detach().amax(dim=-1).to(last)
                        for lg in logits]).amax(dim=0)  # (b, seq)
    sumexp, ll = 0, 0
    for s, (lg, lab) in enumerate(zip(logits, labels)):
        sumexp = sumexp + torch.exp(
            lg - lmax.to(lg.device)[..., None]).sum(dim=-1).to(last)
        v_s = lg.shape[-1]
        local = lab.long() - s * v_s
        own = torch.gather(lg, -1, local.clamp(0, v_s - 1)[..., None])[..., 0]
        ll = ll + torch.where((local >= 0) & (local < v_s), own,
                              torch.zeros_like(own)).to(last)
    return (torch.log(sumexp) + lmax - ll).mean()


def _replica_rows(eng: EngineConfig, batch, p: int, d: int, device):
    """Replica (p, d)'s rows of the batch on ``device``: block ``p·D + d``
    of ``microbatch`` rows (pod-major, as the reference shards the batch
    over ``("pod", "data")``), or every row when the batch is
    replicated."""
    lo = 0 if eng.batch_replicated else (p * eng.data_size + d) \
        * eng.microbatch
    return {n: v.narrow(3 if n == "mrope_pos" else 2, lo, eng.microbatch)
            .to(device, non_blocking=True) for n, v in batch.items()}


def _layer_gather(cfg: ArchConfig, eng: EngineConfig, here, d: int, peers):
    """The ``layer_param_fn`` of a unit of data row ``d`` on device
    ``here``: local layer i's leaves joined over the data rows' shards
    ``peers[r][i]`` (the reference's ``make_layer_gather``)."""
    splits = param_splits(cfg, eng)["layers"]

    def gather(i, p_i):
        return tree_map(
            lambda sp, *ls: ls[d] if sp.data is None else torch.cat(
                [x.to(here) for x in ls], dim=sp.data - 2),
            splits, *(layers[i] for layers in peers))

    return gather


def _fsdp_gather(cfg: ArchConfig, eng: EngineConfig, layout, local):
    """fn(p, d, s, k) -> :func:`_layer_gather` for unit (p, d, s) on trial
    k (None without FSDP). ``local[p][d][s]``: device (p, d, s)'s
    per-trial dicts."""
    if not eng.fsdp:
        return lambda p, d, s, k: None
    return lambda p, d, s, k: _layer_gather(
        cfg, eng, layout.device(p, d, s), d,
        [local[p][r][s][k]["layers"] for r in range(eng.data_size)])


def _replica_mean(root, vecs):
    """The mean over replicas of (K,) tensors, on ``root`` (the
    reference's pmean over the data and pod axes)."""
    return torch.stack([v.to(root) for v in vecs]).mean(dim=0)


def reduce_placed_grads(cfg: ArchConfig, eng: EngineConfig, layout, grads):
    """The reference's ``reduce_grads`` on a device layout. Every shard
    held by several devices (a replicated leaf, a layer shard of several
    data rows without FSDP, every shard over the pod axis) gets the sum of
    its replicas' gradients, in place on each; a leaf split over an axis
    already carries that axis' sum (autograd of the FSDP join and of the
    vocab-parallel partials). The per-trial norm (K,) weights each
    distinct shard's square-sum once, gathered on the layout's root: the
    true norm (the reference's is S times it, ROADMAP). Returns (grads,
    grad_norm)."""
    specs = tree_leaves(param_splits(cfg, eng))
    flat = _grid(layout, lambda p, d, s: tree_leaves(grads[p][d][s]))
    n_pod, n_data, n_st = layout.devices.shape
    sq = torch.zeros((eng.n_trials,), dtype=torch.float32,
                     device=layout.root)
    for i, sp in enumerate(specs):
        groups = {}
        for p in range(n_pod):
            for d in range(n_data):
                for s in range(n_st):
                    key = (None if sp.data is None else d,
                           None if sp.stage is None else s)
                    groups.setdefault(key, []).append(flat[p][d][s][i])
        for g0, *rest in groups.values():
            for g in rest:
                g0.add_(g.to(g0.device))
            for g in rest:
                g.copy_(g0)
            sq += torch.linalg.vector_norm(
                g0.reshape(eng.n_trials, -1).float(), dim=1).square() \
                .to(layout.root)
    return grads, torch.sqrt(sq)


def _traced(step_fn, tracer):
    """``step_fn(tr, *args)`` as fn(*args) under ``tracer`` (None: the
    disabled one): the current tracer for the call, host syncs counted
    while it is enabled, the ``train.step`` span around the call."""
    tr = obs_tracer.resolve(tracer)

    def traced(*args):
        with obs_tracer.using(tr), tr.watch_syncs(), tr.span("train.step"):
            return step_fn(tr, *args)

    return traced


def make_train_step(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                    optimizer, layout=None, tracer=None) -> Callable:
    """The multi-trial pipelined train step.

    Returns fn(params, opt_state, batch, hparams, step) -> (params,
    opt_state, metrics): one ``backward()`` through the whole tick
    schedule, the per-trial global grad norm, then the optimizer's
    per-trial update — params and opt_state are updated in place and
    returned. The objective is ``Σ_k (loss_k + coef · aux_k)`` for the moe
    family (the reference's: no ``/ n_layers`` here, unlike
    ``lm.loss_fn``), the CE alone otherwise; ``metrics["loss"]`` is the CE
    alone, as in the reference. ``hparams`` holds (K,) per-trial
    hyperparameters (Hydra's model-selection axis); metrics {"loss",
    "grad_norm"} are (K,) numpy arrays. The gradient buffer (one per
    parameter leaf) is allocated at the first call and reused; each
    (stage, slot) unit adds into it through leaves of its own
    (:func:`_unit_leaves`).

    With ``layout`` (a ``launch.mesh.DeviceLayout`` of the engine's (pod,
    data, model) sizes) the step takes and updates the placed tree of
    :func:`place_trial_params` and an optimizer state made from it: unit
    (s, slot) of replica (p, d) runs on device (p, d, s) over that
    replica's rows, FSDP (``eng.fsdp``) gathers each layer on the unit's
    device, a replicated batch (``eng.batch_replicated``) gives every
    replica the whole microbatch, the objective is the replicas' sum
    divided by ``eng.dp_degree``, replicated leaves get their gradients
    summed over replicas (:func:`reduce_placed_grads`), and
    ``metrics["loss"]`` is the mean over replicas, as the reference's
    ``make_train_step`` on a mesh of those sizes.

    ``tracer`` (a ``repro_torch.obs.Tracer``, checked at each call, so it
    may be switched on and off between calls): while it is enabled each
    call emits the training spans and counters of ``obs.tracer`` (step
    phases, units and layers by pass, placed hops, host syncs) and their
    ``repro.train.*`` profiler ranges. None or a disabled tracer changes
    nothing the step computes.
    """
    if layout is None:
        check_runnable(eng)
    else:
        check_layout(eng, layout, cfg)
    grads = None

    def step_fn(tr, params, opt_state, batch, hparams, step):
        nonlocal grads
        with tr.span("train.zero_grads"):
            if grads is None:
                grads = tree_map(torch.zeros_like, params)
            for g in tree_leaves(grads):
                g.zero_()
        with tr.span("train.batch"):
            batch = _train_batch(batch)
        with tr.span("train.forward"):
            place = (_one_device(cfg, eng, params, grads, batch)
                     if layout is None else
                     _on_layout(cfg, eng, layout, params, grads, batch))
            losses, auxes = _train_loss(cfg, opts, eng, place)
            totals = []
            for loss_vec, aux_vec in zip(losses, auxes):
                total = loss_vec.sum()
                if cfg.moe is not None:
                    total = total + cfg.moe.load_balance_coef * aux_vec.sum()
                totals.append(total.to(place.root))
        with tr.span("train.backward"):
            (sum(totals) / place.divisor).backward()
        with tr.span("train.reduce_grads"):
            grads, gnorm = place.reduce(grads)
        with tr.span("train.optimizer"):
            params, opt_state = optimizer.update(
                params, grads, opt_state, hparams, step, grad_norm=gnorm)
        with tr.span("train.readback"):
            loss = _replica_mean(place.root, [v.detach() for v in losses])
            # (on ``meta`` — the dry-run's counting pass — there is
            # nothing to read back: the metrics stay tensors)
            host = (lambda t: t) if gnorm.is_meta else tr.read_back
            met = {"loss": host(loss), "grad_norm": host(gnorm)}
        return params, opt_state, met

    return _traced(step_fn, tracer)


# ---------------------------------------------------------------------------
# Serving: pipelined decode / append over dense strips or the paged pool
# ---------------------------------------------------------------------------


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family == "mlp":
        raise ValueError("the mlp workload has no serving path (no "
                         "sequence, no cache)")
    if cfg.family == "hybrid_moe":
        raise ValueError(f"{cfg.name}: the hybrid_moe family trains only "
                         f"(no serving path)")


def shared_slots_per_stage(cfg: ArchConfig, plan: StagePlan) -> int:
    """Shared-attention site slots per stage (hybrid archs): the most any
    stage holds (at least 1), so every stage's strips have one shape."""
    if cfg.hybrid is None:
        return 0
    return max(lm.n_shared_sites(cfg, plan.layer_offset(s),
                                 plan.layers_per_stage)
               for s in range(plan.n_stages))


def _check_paged_support(cfg: ArchConfig, eng: EngineConfig) -> None:
    if cfg.family in ("ssm", "hybrid") or cfg.hybrid is not None:
        raise ValueError(
            "paged KV-cache supports attention-family archs only (SSM/conv "
            "states are O(1) per row and have nothing to page)")
    if eng.n_blocks < 1:
        raise ValueError("paged serving needs n_blocks >= 1")
    n_parts = pool_partitions(eng)
    if eng.n_blocks % n_parts:
        raise ValueError(f"n_blocks={eng.n_blocks} must divide evenly over "
                         f"the {n_parts} data-parallel pool partitions")


def pool_partitions(eng: EngineConfig) -> int:
    """Cache shards per trial: one per data-parallel replica (the data axis
    times the pod axis), or one shared by every replica when the batch is
    replicated (the reference's ``serve_cache_pspecs``)."""
    return 1 if eng.batch_replicated else eng.dp_degree


def serve_cache_struct(cfg: ArchConfig, eng: EngineConfig, device=None,
                       layout=None):
    """The serving caches, zero-filled (with ``layout``: placed, as
    :func:`place_serve_cache` places them, each device's shard allocated
    on it).

    Dense layout: layer leaves (K, cache_groups, Lp, mb_global, ...) — one
    strip per (trial, slot group, layer, row): K/V (max_seq, h_kv, hd) for
    the attention family, the fp32 SSM state and the conv window for the
    ssm and hybrid families; the hybrid family adds shared-site leaves
    (K, cache_groups, S · slots, mb_global, seq, h_kv, hd), stage ``s``
    owning sites ``[s · slots, (s + 1) · slots)`` (``seq`` is
    ``min(max_seq, window)`` under ``eng.window``). Paged layout (``eng.paged``): one
    pool per (trial, layer), shared by every slot cell — leaves (K, Lp,
    n_blocks, block_size, h_kv, hd); data shard ``i`` owns blocks
    ``[i·n_blocks/dp, (i+1)·n_blocks/dp)``."""
    if layout is not None:
        full = serve_cache_struct(cfg, eng, device="meta")
        check_layout(eng, layout)
        return _grid(layout, lambda p, d, s: _map_cache(
            lambda x: torch.zeros(_cache_local(eng, x, p, d, s).shape,
                                  dtype=x.dtype,
                                  device=layout.device(p, d, s)), full))
    _check_family(cfg)
    plan = plan_stages(cfg, eng.n_stages)
    if eng.paged:
        _check_paged_support(cfg, eng)
        shape = (eng.n_trials, plan.padded_layers, eng.n_blocks,
                 eng.block_size, cfg.n_kv_heads, cfg.head_dim)
        return {"layers": {n: torch.zeros(shape, dtype=eng.cache_dtype,
                                          device=device)
                           for n in ("k", "v")},
                "shared": None}
    one = B.layer_cache_shape(cfg, eng.mb_global, eng.max_seq,
                              eng.cache_dtype)
    lead = (eng.n_trials, eng.cache_groups, plan.padded_layers)
    shared = None
    if cfg.hybrid is not None:
        s_lead = (eng.n_trials, eng.cache_groups,
                  eng.n_stages * shared_slots_per_stage(cfg, plan))
        shared = {n: torch.zeros(s_lead + shape, dtype=dt, device=device)
                  for n, (shape, dt) in B.shared_cache_shape(
                      cfg, eng.mb_global, eng.max_seq, eng.cache_dtype,
                      eng.window).items()}
    return {"layers": {n: torch.zeros(lead + shape, dtype=dt, device=device)
                       for n, (shape, dt) in one.items()},
            "shared": shared}


def global_block_tables(eng: EngineConfig, tables):
    """(..., mb_global, width) shard-local ids -> global pool ids: row r
    belongs to shard r // microbatch, whose slice starts at
    shard · n_blocks / data_size; -1 (unallocated) stays -1. The one-device
    form only: a placed unit indexes its own shard's pool with the local
    ids (an idle row's -1 then reads local block 0, as in the
    reference)."""
    mbg = tables.shape[-2]
    per_shard = eng.n_blocks // eng.data_size
    off = ((torch.arange(mbg, device=tables.device) // eng.microbatch)
           * per_shard).to(tables.dtype)
    return torch.where(tables >= 0, tables + off[:, None],
                       torch.full_like(tables, -1))


# ---------------------------------------------------------------------------
# The serving cache on a device layout: the counterpart of
# ``serve_cache_pspecs``
# ---------------------------------------------------------------------------


def _map_cache(fn, cache, *rest):
    """``fn`` over a serving cache tree's leaves (a ``shared`` of None, the
    families without shared sites, stays None)."""
    return tree_map(lambda x, *r: None if x is None else fn(x, *r), cache,
                    *rest)


def _cache_axes(eng: EngineConfig):
    """(stage axis, shard axis) of every serving cache leaf: the pool's
    layer and block axes (K, Lp, n_blocks, ...), or the dense strips'
    layer (site) and row axes (K, G, Lp | sites, mb_global, ...)."""
    return (1, 2) if eng.paged else (2, 3)


def _shard(eng: EngineConfig, p: int, d: int) -> Optional[int]:
    """Replica (p, d)'s cache shard (pod-major, as the reference shards
    over ``("pod", "data")``); None when every replica holds all of it."""
    return None if eng.batch_replicated else p * eng.data_size + d


def _cache_local(eng: EngineConfig, x, p: int, d: int, s: int):
    """Device (p, d, s)'s slice of a serving cache leaf (a view): stage
    s's layers (or shared sites) and replica (p, d)'s blocks (or rows)."""
    st, sh = _cache_axes(eng)
    parts = ((st, s, eng.n_stages),
             (sh, _shard(eng, p, d), pool_partitions(eng)))
    for axis, i, n in parts:
        if i is None:
            continue
        if x.shape[axis] % n:
            raise ValueError(f"cache dim {axis} of shape {tuple(x.shape)} "
                             f"does not split into {n}")
        w = x.shape[axis] // n
        x = x.narrow(axis, i * w, w)
    return x


def place_serve_cache(cfg: ArchConfig, eng: EngineConfig, cache, layout):
    """A serving cache tree (:func:`serve_cache_struct`, any device) split
    over a device layout: nested lists ``[p][d][s]`` of device (p, d, s)'s
    own tree, each leaf a fresh contiguous tensor on it. The paged pool
    goes as (K, Lp / S, n_blocks / dp, bs, h_kv, hd): stage s's layers of
    replica (p, d)'s pool partition; dense strips (and the hybrid shared
    sites) as stage s's layers (sites) of the replica's rows. A replicated
    batch replicates the whole pool (or all rows) over the replicas."""
    check_layout(eng, layout)

    def local(p, d, s):
        dev = layout.device(p, d, s)

        def one(x):
            x = _cache_local(eng, x, p, d, s)
            return torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)

        return _map_cache(one, cache)

    with torch.no_grad():
        return _grid(layout, local)


def gather_serve_cache(cfg: ArchConfig, eng: EngineConfig, placed, layout,
                       device=None):
    """The inverse of :func:`place_serve_cache`, bit for bit: the one-device
    cache tree on ``device`` (default the layout's root), from each
    shard's first holder."""
    dev = layout.root if device is None else torch.device(device)
    st, sh = _cache_axes(eng)
    n_pod, n_data, n_st = layout.devices.shape
    reps = ([(0, 0)] if eng.batch_replicated else
            [(p, d) for p in range(n_pod) for d in range(n_data)])

    def one(*leaves):  # leaves in (p, d, s) order
        def at(p, d, s):
            return leaves[(p * n_data + d) * n_st + s].to(dev)

        return torch.cat([torch.cat([at(p, d, s) for p, d in reps], dim=sh)
                          for s in range(n_st)], dim=st)

    flat = [placed[p][d][s] for p in range(n_pod) for d in range(n_data)
            for s in range(n_st)]
    with torch.no_grad():
        return _map_cache(one, *flat)


SERVE_MODES = ("prefill", "decode", "append", "mixed", "verify")


def _check_mrope_mode(cfg: ArchConfig, mode: str) -> None:
    if mode in ("append", "mixed", "verify") and cfg.rope == "mrope":
        raise ValueError("append mode (continuous batching) does not "
                         "support mrope archs; use the static prefill path")


def pipeline_serve(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                   params, cache, batch, mode: str, layout=None):
    """One pipelined serving call over dense strips or the paged pool.

    prefill (dense only): batch = {tokens (K,M,mbg,seq)} — each slot's
    rows fill their strips from position 0 (the tail zeroed) and emit the
    first generated token; the static lockstep path. A frontend arch's
    ``frontend_embeds`` (K,M,mbg,nf,d) replace each slot's first nf
    embedded rows, and an M-RoPE arch's ``mrope_pos`` (K,M,3,mbg,seq) are
    its rotary positions (prefill only: decode turns all three streams by
    the row's depth, and M-RoPE archs have no append, mixed or verify
    mode, as in the reference). With
    ``eng.prefill_chunks`` = nc > 1 the M slots are nc sequence chunks per
    request group: slot m carries chunk ``m % nc`` at positions
    ``(m % nc) · seq + arange(seq)``, and the nc chunk-slots of group
    ``m // nc`` share one cache (each stage runs slots in order, so chunk
    c's write lands before chunk c+1 reads it).
    decode: batch = {tokens (K,M,mbg,1), positions (K,M,mbg)} — one new token
    per row at its cache depth. append: tokens (K,M,mbg,qlen) inserted per
    row starting at ``positions`` (chunked prefill at ragged depths).
    mixed: append plus ``qlens`` (K,M,mbg) int32, each row's real query
    count (chunk width for a prefilling row, 1 for a decoding row, 0 for an
    idle one): one call advances prefill and decode rows together, and the
    head reads each row at its own last real position ``qlens - 1``.
    verify: mixed's ragged append with the head at EVERY position —
    tokens_out / logit_max come back (K,M,mbg,qlen), position i holding
    what decode at that depth would emit (the speculative target scores a
    drafter's proposals and its own bonus token in one call); positions at
    or past a row's ``qlens`` are padding the caller discards. In ragged
    calls a row's padded positions are clamped to its last real one (they
    compute but never write). An optional ``active`` (K,M,mbg) bool row
    mask: inactive rows compute but never write their cache (the
    reference's ``put_cache`` row mask), so idle and decoding rows ride
    along in another row's call untouched. Paged (``eng.paged``): the batch
    also carries ``block_tables`` (K,M,mbg,width) shard-local ids into the
    pool. Dense: slot (k, m) reads and writes its own strips ``cache[k, m]``
    (or its group's, in chunked prefill). ``eng.window`` > 0 restricts
    every query to the trailing window. Returns (cache, tokens_out
    (K,M,mbg) int32, logit_max (K,M,mbg) float32); the cache is updated in
    place.

    With ``layout``, ``params`` is the placed tree of
    :func:`place_trial_params` and ``cache`` the placed cache of
    :func:`place_serve_cache`: unit (s, slot) of replica (p, d) runs on
    device (p, d, s) over the replica's rows of the batch (every row when
    the batch is replicated), its block tables indexing its own shard's
    pool with the shard-local ids; the outputs come back on the layout's
    root.
    """
    if mode not in SERVE_MODES:
        raise ValueError(f"unknown serve mode {mode!r} (one of "
                         f"{SERVE_MODES})")
    _check_family(cfg)
    _check_mrope_mode(cfg, mode)
    if eng.paged:
        if mode == "prefill":
            raise ValueError("paged serving supports append/decode/mixed/"
                             "verify only, got mode='prefill'")
        _check_paged_support(cfg, eng)
    elif mode != "prefill" and eng.cache_groups != eng.n_microbatches:
        raise ValueError("dense append/decode index one cache group per "
                         "slot: run with prefill_chunks=1 (as the serve "
                         "engine does)")
    if layout is not None:
        return cache, *_placed_serve(cfg, opts, eng, layout, params, cache,
                                     batch, mode)
    S, K = eng.n_stages, eng.n_trials
    nc = eng.prefill_chunks if mode == "prefill" else 1
    plan = plan_stages(cfg, S)
    l_s = plan.layers_per_stage
    tokens = batch["tokens"]
    positions = None if mode == "prefill" else batch["positions"]
    active = batch.get("active")
    qlens = batch.get("qlens") if mode in ("mixed", "verify") else None
    if mode == "decode" or (mode == "prefill" and nc == 1):
        stack_mode = mode
    else:  # appends, ragged waves and prefill chunks write at offsets
        stack_mode = "append"
    tables = (global_block_tables(eng, batch["block_tables"]) if eng.paged
              else None)
    n_sh = shared_slots_per_stage(cfg, plan)
    mbg, qlen = tokens.shape[-2], tokens.shape[-1]
    dev = tokens.device
    steps = torch.arange(qlen, device=dev)
    out_shape = tokens.shape if mode == "verify" else tokens.shape[:3]
    tok_out = torch.zeros(out_shape, dtype=torch.int32, device=dev)
    val_out = torch.zeros(out_shape, dtype=torch.float32, device=dev)
    fe = batch.get("frontend_embeds") if mode == "prefill" else None
    mrope = (torch.as_tensor(batch["mrope_pos"], device=dev)
             if mode == "prefill" and cfg.rope == "mrope" else None)
    embed = vp_embed if eng.vocab_parallel else plain_embed
    trials = unstack_trials(params)
    acts = [None] * S  # stage s's output of the previous tick
    for t in range(eng.n_ticks):
        nxt = [None] * S
        for s in range(S):
            slot = t - s
            if not 0 <= slot < eng.n_slots:
                continue  # fill/drain bubble: masked in the reference
            k, m = slot % K, slot // K
            lo = s * l_s
            p_layers = trials[k]["layers"][lo:lo + l_s]
            cell = (k,) if eng.paged else (k, m // nc)
            c = {"layers": {n: v[cell][lo:lo + l_s]
                            for n, v in cache["layers"].items()},
                 "shared": None if cache["shared"] is None else
                 {n: v[cell][s * n_sh:(s + 1) * n_sh]
                  for n, v in cache["shared"].items()}}
            if mode == "prefill":
                # chunk m % nc of its request group (always 0 when nc = 1)
                start = torch.full((mbg,), (m % nc) * qlen, dtype=torch.int32,
                                   device=dev)
            else:
                start = positions[k, m]
            pos = start[:, None] + steps[None, :]
            ql = None if qlens is None else qlens[k, m]
            if ql is not None:
                # padded positions clamp to the row's last real one: they
                # compute (writes dropped, outputs discarded) but stay
                # inside the rope range
                pos = torch.minimum(pos, (start + (ql - 1).clamp(min=0))
                                    [:, None])
            if s == 0:
                x = embed(cfg, eng, trials[k]["embed"], tokens[k, m], pos,
                          opts.compute_dtype)
                if fe is not None:  # the prefill's frontend rows
                    x = lm.replace_frontend_rows(
                        x, torch.as_tensor(fe[k, m], device=dev))
            else:
                x = acts[s - 1]
            if mrope is not None:
                pos = mrope[k, m]  # (3, mbg, qlen)
            elif cfg.rope == "mrope":  # decode: every stream at the depth
                pos = pos.expand(3, mbg, qlen)
            y, _, _ = lm.stack_apply(
                cfg, opts, p_layers, x, pos=pos, mode=stack_mode, cache=c,
                shared_params=trials[k].get("shared"),
                layer_mask=[lo + i < cfg.n_layers for i in range(l_s)],
                layer_offset=lo,
                kv_offset=None if stack_mode == "prefill" else start,
                window=eng.window,
                block_tables=None if tables is None else tables[k, m],
                write_mask=None if active is None else active[k, m],
                q_lens=ql, n_shards=eng.data_size)
            nxt[s] = y
            if s == S - 1:  # the slot drains: greedy head
                norm_k = trials[k]["final_norm"]
                head_k = trials[k]["head"]
                if mode == "verify":
                    tok_out[k, m], val_out[k, m] = vp_greedy_tokens(
                        cfg, eng, norm_k, head_k, y)
                    continue
                if ql is not None:
                    # a ragged row's chunk ends at its own qlens - 1, not
                    # at the padded trailing column
                    sel = (ql.long() - 1).clamp(0, qlen - 1)
                    y_head = y[torch.arange(mbg, device=dev), sel][:, None]
                else:
                    y_head = y[:, -1:]
                tok_out[k, m], val_out[k, m] = vp_greedy_token(
                    cfg, eng, norm_k, head_k, y_head)
        acts = nxt
    return cache, tok_out, val_out


def _serve_batch(batch, mode: str) -> dict:
    """The entries of a serving batch that ``mode`` reads, as tensors."""
    names = ["tokens", "active", "block_tables"]
    names += (["frontend_embeds", "mrope_pos"] if mode == "prefill"
              else ["positions"])
    if mode in ("mixed", "verify"):
        names.append("qlens")
    return {n: torch.as_tensor(batch[n]) for n in names
            if batch.get(n) is not None}


def _vp_greedy_placed(cfg: ArchConfig, stage_params, y, devices, root):
    """:func:`vp_greedy_tokens` with each stage's vocab slice on its own
    device: ``stage_params[s]`` holds stage s's final_norm and head slice
    (D, Vp/S). y (b, q, D) goes to every stage, each takes its slice's
    max and first argmax, and the pairs meet on ``root``, where the lowest
    tied id wins (the reference's psum over the stages)."""
    maxes, args = [], []
    for s, (p, dev) in enumerate(zip(stage_params, devices)):
        x = lm.final_norm_apply(cfg, p["final_norm"], y.to(dev))
        lg = (x @ p["head"]).float()  # (b, q, Vp / S)
        v_s = lg.shape[-1]
        gid = s * v_s + torch.arange(v_s, device=dev)
        lg = lg.masked_fill(gid >= cfg.vocab_size, -1e30)
        maxes.append(lg.amax(dim=-1).to(root))
        args.append((lg.argmax(dim=-1) + s * v_s).to(root))
    lmax, larg = torch.stack(maxes), torch.stack(args)  # (S, b, q)
    gmax = lmax.amax(dim=0)
    winner = torch.where(lmax >= gmax, larg,
                         len(devices) * v_s).amin(dim=0)
    return winner.to(torch.int32), gmax


def _placed_serve(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                  layout, params, cache, batch, mode: str):
    """The tick loop of :func:`pipeline_serve` on a device layout; returns
    (tokens_out, logit_max) on the layout's root. Unit (s, slot) of
    replica (p, d) runs on device (p, d, s): its rows of every batch entry
    are moved there first (the kernels launch on the one device of their
    inputs), its MoE rows route as one shard, and with FSDP each layer is
    gathered over the data rows there."""
    S, K = eng.n_stages, eng.n_trials
    nc = eng.prefill_chunks if mode == "prefill" else 1
    plan = plan_stages(cfg, S)
    l_s = plan.layers_per_stage
    n_pod, n_data = eng.pod_size, eng.data_size
    dev, root = layout.device, layout.root
    if mode == "decode" or (mode == "prefill" and nc == 1):
        stack_mode = mode
    else:  # appends, ragged waves and prefill chunks write at offsets
        stack_mode = "append"
    batch = _serve_batch(batch, mode)
    tokens = batch["tokens"]
    qlen, mb = tokens.shape[-1], eng.microbatch
    reps = [(p, d) for p in range(n_pod) for d in range(n_data)]
    units = [(p, d, s) for p, d in reps for s in range(S)]
    rows = {u: _replica_rows(eng, batch, u[0], u[1], dev(*u)) for u in units}
    steps = {u: torch.arange(qlen, device=dev(*u)) for u in units}
    local = _grid(layout, lambda p, d, s: unstack_trials(params[p][d][s]))
    layer_gather = _fsdp_gather(cfg, eng, layout, local)
    out_shape = tokens.shape if mode == "verify" else tokens.shape[:3]
    tok_out = torch.zeros(out_shape, dtype=torch.int32, device=root)
    val_out = torch.zeros(out_shape, dtype=torch.float32, device=root)

    def positions(u, k, m):
        """(start (mb,), pos (mb, qlen), q_lens or None) of unit u's rows
        of slot (k, m), on its device."""
        r = rows[u]
        if mode == "prefill":
            # chunk m % nc of its request group (always 0 when nc = 1)
            start = torch.full((r["tokens"].shape[2],), (m % nc) * qlen,
                               dtype=torch.int32, device=dev(*u))
        else:
            start = r["positions"][k, m]
        pos = start[:, None] + steps[u][None, :]
        ql = r["qlens"][k, m] if "qlens" in r else None
        if ql is not None:  # padded positions clamp to the last real one
            pos = torch.minimum(pos, (start + (ql - 1).clamp(min=0))[:, None])
        return start, pos, ql

    def embed(p, d, k, m):
        first = dev(p, d, 0)
        if not eng.vocab_parallel:
            _, pos, _ = positions((p, d, 0), k, m)
            return plain_embed(cfg, eng, local[p][d][0][k]["embed"],
                               rows[p, d, 0]["tokens"][k, m], pos,
                               opts.compute_dtype)
        parts = [_vp_embed_part(cfg, local[p][d][s][k]["embed"],
                                rows[p, d, s]["tokens"][k, m],
                                positions((p, d, s), k, m)[1], s,
                                opts.compute_dtype).to(first)
                 for s in range(S)]
        return sum(parts[1:], parts[0])

    def head(p, d, k, m, y, ql):
        """The greedy head of slot (k, m) on replica (p, d)'s last-stage
        output y: (tokens, maxima) on the root."""
        if mode != "verify":
            if ql is not None:
                # a ragged row's chunk ends at its own qlens - 1
                sel = (ql.long() - 1).clamp(0, qlen - 1)
                y = y[torch.arange(y.shape[0], device=y.device), sel][:, None]
            else:
                y = y[:, -1:]
        if eng.vocab_parallel:
            tok, gmax = _vp_greedy_placed(
                cfg, [local[p][d][s][k] for s in range(S)], y,
                [dev(p, d, s) for s in range(S)], root)
        else:
            q = local[p][d][S - 1][k]
            tok, gmax = vp_greedy_tokens(cfg, eng, q["final_norm"],
                                         q["head"], y)
        if mode != "verify":
            tok, gmax = tok[:, 0], gmax[:, 0]
        return tok.to(root), gmax.to(root)

    def unit(x, p, d, s, k, m):
        u = (p, d, s)
        r = rows[u]
        start, pos, ql = positions(u, k, m)
        if s == 0:
            x = embed(p, d, k, m)
            if "frontend_embeds" in r:  # the prefill's frontend rows
                x = lm.replace_frontend_rows(x, r["frontend_embeds"][k, m])
        if "mrope_pos" in r:
            pos = r["mrope_pos"][k, m]  # (3, mb, qlen)
        elif cfg.rope == "mrope":  # decode: every stream at the depth
            pos = pos.expand(3, pos.shape[0], qlen)
        lo = s * l_s
        q = local[p][d][s][k]
        c_u = cache[p][d][s]
        cell = (k,) if eng.paged else (k, m // nc)
        c = {"layers": {n: v[cell] for n, v in c_u["layers"].items()},
             "shared": None if c_u["shared"] is None else
             {n: v[cell] for n, v in c_u["shared"].items()}}
        y, _, _ = lm.stack_apply(
            cfg, opts, q["layers"], x, pos=pos, mode=stack_mode, cache=c,
            shared_params=q.get("shared"),
            layer_mask=[lo + i < cfg.n_layers for i in range(l_s)],
            layer_offset=lo,
            kv_offset=None if stack_mode == "prefill" else start,
            window=eng.window,
            block_tables=(r["block_tables"][k, m] if eng.paged else None),
            write_mask=r["active"][k, m] if "active" in r else None,
            q_lens=ql, n_shards=1, layer_param_fn=layer_gather(p, d, s, k))
        return y, ql

    acts = {}  # (p, d, s) -> stage s's output of the previous tick
    for t in range(eng.n_ticks):
        nxt = {}
        for s in range(S):
            slot = t - s
            if not 0 <= slot < eng.n_slots:
                continue  # fill/drain bubble: masked in the reference
            k, m = slot % K, slot // K
            for p, d in reps:
                x = (acts[p, d, s - 1].to(dev(p, d, s), non_blocking=True)
                     if s else None)
                y, ql = unit(x, p, d, s, k, m)
                nxt[p, d, s] = y
                if s < S - 1 or (eng.batch_replicated and (p, d) != (0, 0)):
                    continue  # a replicated batch's rows come from (0, 0)
                tok, gmax = head(p, d, k, m, y, ql)
                lo = _shard(eng, p, d) or 0
                tok_out[k, m, lo * mb:lo * mb + tok.shape[0]] = tok
                val_out[k, m, lo * mb:lo * mb + tok.shape[0]] = gmax
        acts = nxt
    return tok_out, val_out


def make_serve_step(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                    mode: str, tracer=None, layout=None) -> Callable:
    """fn(params, cache, batch) -> (cache, tokens, logit_max) running
    :func:`pipeline_serve` in ``mode`` (prefill | decode | append | mixed |
    verify). The reference's ``with_active`` flag is implied by an
    ``active`` batch entry.

    ``tracer`` (an enabled ``repro_torch.obs.Tracer``) wraps the step to
    emit a ``compile`` event at the first call of each (token qlen,
    block-table width) signature, as the reference does where XLA
    retraces. PyTorch runs eagerly and compiles nothing, but the event
    stream stays the reference's. With None or a disabled tracer the bare
    step comes back.

    With ``layout`` (a ``launch.mesh.DeviceLayout`` of the engine's (pod,
    data, model) sizes) the step takes the placed parameters and cache
    (:func:`place_trial_params`, :func:`place_serve_cache`) and runs each
    (stage, replica) unit on its own device (see :func:`pipeline_serve`);
    FSDP, the pod axis and a replicated batch run there, as on the
    reference's mesh of those sizes."""
    _check_mrope_mode(cfg, mode)
    if mode in ("mixed", "verify") and cfg.family in ("ssm", "hybrid"):
        raise ValueError("mixed-tick/verify serving is attention-family "
                         "only: ragged padded tokens would advance "
                         "recurrent SSM state")
    if mode not in SERVE_MODES:
        raise ValueError(f"unknown serve mode {mode!r} (one of "
                         f"{SERVE_MODES})")
    _check_family(cfg)
    if layout is None:
        check_runnable(eng)
    else:
        check_layout(eng, layout)
    if eng.paged:
        _check_paged_support(cfg, eng)

    def step(params, cache, batch):
        return pipeline_serve(cfg, opts, eng, params, cache, batch, mode,
                              layout=layout)

    if tracer is None or not tracer.enabled:
        return step
    seen: set = set()

    def traced(params, cache, batch):
        bt = batch.get("block_tables")
        key = (int(batch["tokens"].shape[-1]),
               int(bt.shape[-1]) if bt is not None else 0)
        if key not in seen:
            seen.add(key)
            tracer.compile(mode, qlen=key[0], table_width=key[1])
        return step(params, cache, batch)

    return traced


def make_slot_reset(cfg: ArchConfig, eng: EngineConfig,
                    layout=None) -> Callable:
    """fn(cache, mask) zeroing the dense cache rows of recycled slots, in
    place. ``mask``: (K, cache_groups, mb_global) bool (numpy or tensor) —
    True rows are cleared before a queued request is admitted into the
    freed slot. KV rows beyond kv_len are never attended, but SSM/conv
    states are recurrent and MUST restart from zero for the next request.
    (Paged engines never call this: stale pool blocks are masked by
    kv_len, and freed blocks return to the allocator host-side.) With
    ``layout`` the cache is placed, and each device zeroes its own rows
    of the mask on its own strips."""
    if eng.paged:
        raise ValueError("paged caches need no slot reset (no recurrent "
                         "state; stale blocks are masked via kv_len)")

    def zero(cache, rows):
        bufs = list(cache["layers"].values())
        if cache["shared"] is not None:  # the hybrid shared-site strips
            bufs += list(cache["shared"].values())
        for buf in bufs:
            for k, g, b in rows:  # leaves (K, G, Lp | sites, mb, ...)
                buf[k, g, :, b].zero_()

    def reset(cache, mask):
        zero(cache, torch.as_tensor(mask).nonzero().tolist())
        return cache

    if layout is None:
        return reset
    check_layout(eng, layout)

    def placed_reset(cache, mask):
        rows = torch.as_tensor(mask).nonzero().tolist()
        mb = eng.mb_global // pool_partitions(eng)
        for p, d in np.ndindex(*layout.devices.shape[:2]):
            lo = (_shard(eng, p, d) or 0) * mb
            mine = [(k, g, b - lo) for k, g, b in rows if lo <= b < lo + mb]
            for s in range(eng.n_stages):
                zero(cache[p][d][s], mine)
        return cache

    return placed_reset


# ---------------------------------------------------------------------------
# Block movement behind serve.transfer.TransferEngine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TransferKernels:
    """The three block-movement primitives consumed by
    ``serve.transfer.TransferEngine``."""

    copy: Callable  # (cache, src, dst) -> cache; batched pool copy
    extract: Callable  # (cache, k, shard, local_ids) -> [payload, ...]
    inject: Callable  # (cache, k, shard, local_ids, payloads) -> cache


def make_transfer_kernels(cfg: ArchConfig, eng: EngineConfig,
                          layout=None) -> TransferKernels:
    """Pool copy / extract / inject on the pool tensors (in place).

    **copy(cache, src, dst)** — dst := src for every layer, ``src``/``dst``
    (K, dp, n) shard-local ids, -1 = no-op padding (the copy-on-write half
    of prefix sharing). **extract(cache, k, shard, ids)** — device → host:
    one CPU payload (2, Lp, block_size, h_kv, hd) stacking K and V per id.
    **inject(cache, k, shard, ids, payloads)** — host → device, the inverse
    of extract (round-trips bit-exactly). Local ids are offset by the
    shard's pool slice before indexing. With ``layout`` (a placed cache)
    each shard's pool is its own tensors, indexed with the local ids
    as they are: see :func:`_placed_transfer_kernels`.
    """
    _check_paged_support(cfg, eng)
    if layout is not None:
        return _placed_transfer_kernels(eng, layout)
    per_shard = eng.n_blocks // eng.data_size

    def gids(shard, ids, device):
        return torch.as_tensor([shard * per_shard + int(i) for i in ids],
                               dtype=torch.long, device=device)

    def copy(cache, src, dst):
        src, dst = torch.as_tensor(src), torch.as_tensor(dst)
        for k in range(src.shape[0]):
            for sh in range(src.shape[1]):
                ok = (src[k, sh] >= 0) & (dst[k, sh] >= 0)
                if not bool(ok.any()):
                    continue
                for buf in cache["layers"].values():
                    gs = gids(sh, src[k, sh][ok].tolist(), buf.device)
                    gd = gids(sh, dst[k, sh][ok].tolist(), buf.device)
                    buf[k].index_copy_(1, gd, buf[k].index_select(1, gs))
        return cache

    def extract(cache, k, shard, local_ids):
        kv = [cache["layers"][n][k].index_select(
            1, gids(shard, local_ids, cache["layers"][n].device)).cpu()
            for n in ("k", "v")]  # each (Lp, n, bs, h_kv, hd)
        return [torch.stack([kv[0][:, j], kv[1][:, j]])
                for j in range(len(local_ids))]

    def inject(cache, k, shard, local_ids, payloads):
        for i, n in enumerate(("k", "v")):
            buf = cache["layers"][n]
            vals = torch.stack([p[i] for p in payloads], dim=1)
            buf[k].index_copy_(1, gids(shard, local_ids, buf.device),
                               vals.to(buf.device, buf.dtype))
        return cache

    return TransferKernels(copy=copy, extract=extract, inject=inject)


def _placed_transfer_kernels(eng: EngineConfig, layout) -> TransferKernels:
    """The transfer kernels on a placed pool. **copy** runs per (k, shard)
    on every stage device of every replica holding the shard (all of them
    when the batch is replicated). **extract** reads the shard's blocks
    from each stage's device (of its first holder) and joins the stages'
    layers into one host payload (2, Lp, block_size, h_kv, hd) per id;
    **inject** writes a payload's layers back to every holder's stage
    devices, bit for bit."""
    check_layout(eng, layout)
    n_pod, n_data, n_st = layout.devices.shape
    reps = [(p, d) for p in range(n_pod) for d in range(n_data)]

    def holders(shard):
        return [r for r in reps if _shard(eng, *r) in (None, shard)]

    def ids_on(ids, buf):
        return torch.as_tensor([int(i) for i in ids], dtype=torch.long,
                               device=buf.device)

    def copy(cache, src, dst):
        src, dst = torch.as_tensor(src), torch.as_tensor(dst)
        for k in range(src.shape[0]):
            for sh in range(src.shape[1]):
                ok = (src[k, sh] >= 0) & (dst[k, sh] >= 0)
                if not bool(ok.any()):
                    continue
                gs, gd = src[k, sh][ok].tolist(), dst[k, sh][ok].tolist()
                for p, d in holders(sh):
                    for s in range(n_st):
                        for buf in cache[p][d][s]["layers"].values():
                            buf[k].index_copy_(1, ids_on(gd, buf),
                                               buf[k].index_select(
                                                   1, ids_on(gs, buf)))
        return cache

    def extract(cache, k, shard, local_ids):
        p, d = holders(shard)[0]
        kv = [torch.cat([cache[p][d][s]["layers"][n][k].index_select(
            1, ids_on(local_ids, cache[p][d][s]["layers"][n])).cpu()
            for s in range(n_st)]) for n in ("k", "v")]  # (Lp, n, ...)
        return [torch.stack([kv[0][:, j], kv[1][:, j]])
                for j in range(len(local_ids))]

    def inject(cache, k, shard, local_ids, payloads):
        for i, n in enumerate(("k", "v")):
            vals = torch.stack([pay[i] for pay in payloads], dim=1)
            for p, d in holders(shard):
                lo = 0
                for s in range(n_st):
                    buf = cache[p][d][s]["layers"][n]
                    l_s = buf.shape[1]
                    buf[k].index_copy_(1, ids_on(local_ids, buf),
                                       vals[lo:lo + l_s].to(buf.device,
                                                            buf.dtype))
                    lo += l_s
        return cache

    return TransferKernels(copy=copy, extract=extract, inject=inject)
