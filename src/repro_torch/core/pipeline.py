"""Hydra's pipelined multi-trial programs — training and serving — run in
one process (PyTorch port of ``repro/core/pipeline.py``).

The reference compiles one SPMD program over a (data × model) device mesh;
the port keeps the schedule's semantics exactly — the tests compare losses,
gradients, tokens, ticks and call counts with the reference — and runs the
mesh as structure inside one process on one device:

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
    data-parallel degree.
  * **gradients.** The reference differentiates *through* the scanned
    pipeline; here one ``backward()`` runs through the tick loop, so each
    trial's gradient is exactly the unpipelined one (paper desideratum D3).

Pools, caches, parameters and optimizer state are updated in place (the
reference donates them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partitioner import StagePlan, plan_stages
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models.layers import ModelOptions
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of one Hydra gang (same-architecture trials).

    In serving the K trial rows double as the co-serving axis: each row
    holds one model variant's weights and cache, and the serve engine
    routes per-arch request streams into the matching rows. The reference's
    mesh-axis names, pod axis, FSDP and the host spill tier are not ported;
    ``window`` exists so the serve engine can reject it as the reference
    does (sliding-window serving itself is not ported yet).
    """

    n_trials: int  # K — concurrent model variants
    n_microbatches: int  # M — slots per trial per call
    microbatch: int  # rows per (slot × data shard)
    n_stages: int  # S — pipeline stages
    data_size: int = 1  # logical data shards (pool partitions per trial)
    max_seq: int = 0  # per-request token capacity
    cache_dtype: torch.dtype = torch.bfloat16
    window: int = 0  # sliding attention window in serving (not ported)
    paged: bool = False  # KV in a shared block pool; False = dense per-slot
    # cache strips (the only layout for the ssm family)
    block_size: int = 16  # tokens per block
    n_blocks: int = 0  # pool size PER TRIAL; each data shard owns an equal
    # slice of n_blocks / data_size blocks
    prefill_chunks: int = 1  # admission chunks per prompt (serve engine)
    vocab_parallel: bool = True  # train loss over S logical vocab shards
    # (per-shard max / sum-exp, as the reference's psum form); False = one
    # plain CE over the full head

    @property
    def n_slots(self) -> int:
        return self.n_trials * self.n_microbatches

    @property
    def n_ticks(self) -> int:
        return self.n_slots + self.n_stages - 1

    @property
    def mb_global(self) -> int:
        return self.microbatch * self.data_size

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.n_ticks

    @property
    def cache_groups(self) -> int:
        """Distinct dense caches per trial in serving: chunked prefill
        shares one cache per request group across its sequence-chunk
        slots (the serve engine sets ``prefill_chunks`` to 1, so each of
        its microbatch slots owns one)."""
        if self.prefill_chunks > 1:
            return self.n_microbatches // self.prefill_chunks
        return self.n_microbatches

    def padded_vocab(self, vocab: int) -> int:
        s = self.n_stages
        return -(-vocab // s) * s


# ---------------------------------------------------------------------------
# Parameters: trial-stacked, vocab padded to a multiple of S
# ---------------------------------------------------------------------------


def init_trial_params(cfg: ArchConfig, eng: EngineConfig, plan: StagePlan,
                      gen: torch.Generator, dtype=torch.float32, device=None):
    """K trials' parameters stacked on a leading K axis: layer leaves
    (K, Lp, ...) over the stage-padded stack, embed (K, Vp, D) and head
    (K, D, Vp) zero-padded to a multiple of S."""
    trials = [lm.init_params(cfg, gen, dtype=dtype,
                             n_layers=plan.padded_layers, device=device)
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


# ---------------------------------------------------------------------------
# Vocab-parallel embedding / greedy head over S logical shards
# ---------------------------------------------------------------------------


def vp_embed(cfg: ArchConfig, eng: EngineConfig, embed_k, tokens,
             compute_dtype=torch.float32):
    """Vocab-parallel embedding. The reference gathers each token's row on
    the one stage owning it and psums S−1 exact zeros onto it, so the
    result equals a plain gather from the padded table bit for bit."""
    return lm.embed_tokens(cfg, embed_k, tokens, compute_dtype=compute_dtype)


def vp_greedy_tokens(cfg: ArchConfig, eng: EngineConfig, norm_p, head_k, y):
    """Greedy argmax at every position, y (b, s, D) -> ((b, s) int32
    winners, (b, s) float32 max logits), with the reference's cross-shard
    rule: each of the S vocab shards takes its own max and first argmax,
    and an exact tie between shards returns the mean of the tied argmaxes
    (integer division), as ``psum(where(lmax >= gmax, larg)) // count``."""
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
    win = lmax >= gmax
    winner = (larg * win).sum(-1) // win.sum(-1).clamp(min=1)
    return winner.to(torch.int32), gmax[..., 0]


def vp_greedy_token(cfg: ArchConfig, eng: EngineConfig, norm_p, head_k, y):
    """Greedy next token, y (b, 1, D) -> ((b,) int32, (b,) float32)."""
    tok, gmax = vp_greedy_tokens(cfg, eng, norm_p, head_k, y)
    return tok[:, 0], gmax[:, 0]


# ---------------------------------------------------------------------------
# Embedding and loss heads of the train program
# ---------------------------------------------------------------------------


def plain_embed(cfg: ArchConfig, eng: EngineConfig, embed_k, tokens,
                compute_dtype=torch.float32):
    """Embedding from the full (padded) table of one trial."""
    return lm.embed_tokens(cfg, embed_k, tokens, compute_dtype=compute_dtype)


def vp_loss(cfg: ArchConfig, eng: EngineConfig, norm_p, head_k, y, labels):
    """Vocab-parallel cross-entropy (mean over tokens) over S logical vocab
    shards of one trial's padded head (D, Vp): each shard's logits, the
    global max from the per-shard maxima (a pure stabilizer: detached, as
    the reference's stop_gradient), per-shard sums of exp summed over the
    shards, and the label's logit from the shard that owns it."""
    x = lm.final_norm_apply(cfg, norm_p, y)
    logits = (x @ head_k).float()  # (b, s, Vp)
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
    return lm.cross_entropy(x @ head_k, labels)


# ---------------------------------------------------------------------------
# Training: the pipelined multi-trial loss, run tick by tick
# ---------------------------------------------------------------------------


def unstack_trials(params):
    """The trial-stacked parameter dict -> a list over K of per-trial dicts
    whose ``"layers"`` is a list of per-layer dicts (all views)."""
    n_k = params["final_norm"].shape[0]
    n_l = tree_leaves(params["layers"])[0].shape[1]
    out = []
    for k in range(n_k):
        p_k = lm.layer_slice({n: v for n, v in params.items()
                              if n != "layers"}, k)
        layers_k = lm.layer_slice(params["layers"], k)
        p_k["layers"] = [lm.layer_slice(layers_k, i) for i in range(n_l)]
        out.append(p_k)
    return out


def _train_loss(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                trials, batch):
    """The tick loop of :func:`pipeline_train_loss` over per-trial
    parameter dicts (see :func:`unstack_trials`). batch: tokens / labels
    (K, M, mb_global, seq) tensors on the parameters' device. Returns the
    (K,) per-trial losses, each the mean over its M slots."""
    S, K, M = eng.n_stages, eng.n_trials, eng.n_microbatches
    l_s = plan_stages(cfg, S).layers_per_stage
    tokens, labels = batch["tokens"], batch["labels"]
    mbg, seq = tokens.shape[-2], tokens.shape[-1]
    pos = torch.arange(seq, device=tokens.device).expand(mbg, seq)
    loss_fn = vp_loss if eng.vocab_parallel else plain_loss

    def unit(x, s, k, m):
        """One (stage, slot) pair: embed at stage 0, the stage's layers,
        the loss at the last stage."""
        p = trials[k]
        if s == 0:
            x = plain_embed(cfg, eng, p["embed"], tokens[k, m],
                            opts.compute_dtype)
        lo = s * l_s
        x, _ = lm.stack_apply(
            cfg, opts, p["layers"][lo:lo + l_s], x, pos=pos, mode="train",
            layer_mask=[lo + i < cfg.n_layers for i in range(l_s)])
        if s == S - 1:
            return loss_fn(cfg, eng, p["final_norm"], p["head"], x,
                           labels[k, m])
        return x

    # the reference's tick-level remat: each (stage, slot) pair keeps only
    # its input and is recomputed in backward
    remat = opts.remat and torch.is_grad_enabled()
    losses = [[] for _ in range(K)]
    acts = [None] * S  # stage s's output of the previous tick
    for t in range(eng.n_ticks):
        nxt = [None] * S
        for s in range(S):
            slot = t - s
            if not 0 <= slot < eng.n_slots:
                continue  # fill/drain bubble: masked in the reference
            k, m = slot % K, slot // K
            out = (checkpoint(unit, acts[s - 1] if s else None, s, k, m,
                              use_reentrant=False, preserve_rng_state=False)
                   if remat else unit(acts[s - 1] if s else None, s, k, m))
            if s == S - 1:
                losses[k].append(out)
            else:
                nxt[s] = out
        acts = nxt
    return torch.stack([sum(ls) for ls in losses]) / M


def pipeline_train_loss(cfg: ArchConfig, opts: ModelOptions,
                        eng: EngineConfig, params, batch):
    """Runs the multi-trial pipelined forward; returns per-trial (loss, aux)
    (K,) tensors (aux: the MoE term, zero for the dense family).

    params: the trial-stacked dict (layers (K, Lp, ...), embed/tok
    (K, Vp, D), head (K, D, Vp), final_norm (K, D)). batch: tokens / labels
    (K, M, mb_global, seq), tensors or numpy. Each tick ``t`` advances stage
    ``s`` on slot ``t - s`` (trial ``slot % K``, microbatch ``slot // K``);
    bubble pairs are skipped. Differentiable w.r.t. ``params``.
    """
    batch = _train_batch(batch, params["final_norm"].device)
    loss = _train_loss(cfg, opts, eng, unstack_trials(params), batch)
    return loss, torch.zeros_like(loss)


def _train_batch(batch, device):
    """tokens / labels (tensors or numpy) as tensors on ``device``."""
    return {n: (batch[n] if torch.is_tensor(batch[n])
                else torch.from_numpy(np.ascontiguousarray(batch[n])))
            .to(device) for n in ("tokens", "labels")}


def _grad_leaves(params, grads):
    """Per-trial (and per-layer) leaf tensors that alias ``params`` and
    accumulate their gradients straight into the matching views of
    ``grads``: slicing a stacked leaf inside autograd would materialize a
    zero-filled full-size gradient per use (1.8 GB for the largest leaf at
    full width)."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    return tree_map(leaf, unstack_trials(params), unstack_trials(grads))


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


def make_train_step(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                    optimizer) -> Callable:
    """The multi-trial pipelined train step.

    Returns fn(params, opt_state, batch, hparams, step) -> (params,
    opt_state, metrics): one ``backward()`` through the whole tick
    schedule, the per-trial global grad norm, then the optimizer's
    per-trial update — params and opt_state are updated in place and
    returned. ``hparams`` holds (K,) per-trial hyperparameters (Hydra's
    model-selection axis); metrics {"loss", "grad_norm"} are (K,) numpy
    arrays. The gradient buffer (one per parameter leaf) is allocated at
    the first call and reused.
    """
    bufs = {}

    def step_fn(params, opt_state, batch, hparams, step):
        if "grads" not in bufs:
            bufs["grads"] = tree_map(torch.zeros_like, params)
        grads = bufs["grads"]
        for g in tree_leaves(grads):
            g.zero_()
        batch = _train_batch(batch, params["final_norm"].device)
        loss_vec = _train_loss(cfg, opts, eng, _grad_leaves(params, grads),
                               batch)
        loss_vec.sum().backward()
        grads, gnorm = reduce_grads(cfg, eng, grads)
        params, opt_state = optimizer.update(params, grads, opt_state,
                                             hparams, step, grad_norm=gnorm)
        return params, opt_state, {
            "loss": loss_vec.detach().cpu().numpy(),
            "grad_norm": gnorm.cpu().numpy()}

    return step_fn


# ---------------------------------------------------------------------------
# Serving: pipelined decode / append over dense strips or the paged pool
# ---------------------------------------------------------------------------


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def _check_paged_support(cfg: ArchConfig, eng: EngineConfig) -> None:
    if cfg.family in ("ssm", "hybrid") or cfg.hybrid is not None:
        raise ValueError(
            "paged KV-cache supports attention-family archs only (SSM/conv "
            "states are O(1) per row and have nothing to page)")
    if eng.n_blocks < 1:
        raise ValueError("paged serving needs n_blocks >= 1")
    if eng.n_blocks % eng.data_size:
        raise ValueError(f"n_blocks={eng.n_blocks} must divide evenly over "
                         f"the {eng.data_size} data-parallel pool partitions")


def serve_cache_struct(cfg: ArchConfig, eng: EngineConfig, device=None):
    """The serving caches, zero-filled.

    Dense layout: layer leaves (K, cache_groups, Lp, mb_global, ...) — one
    strip per (trial, slot group, layer, row): K/V (max_seq, h_kv, hd) for
    the attention family, the fp32 SSM state (di, n) and the conv window
    (d_conv-1, di) for the ssm family. Paged layout (``eng.paged``): one
    pool per (trial, layer), shared by every slot cell — leaves (K, Lp,
    n_blocks, block_size, h_kv, hd); data shard ``i`` owns blocks
    ``[i·n_blocks/dp, (i+1)·n_blocks/dp)``."""
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
    return {"layers": {n: torch.zeros(lead + shape, dtype=dt, device=device)
                       for n, (shape, dt) in one.items()},
            "shared": None}


def global_block_tables(eng: EngineConfig, tables):
    """(..., mb_global, width) shard-local ids -> global pool ids: row r
    belongs to shard r // microbatch, whose slice starts at
    shard · n_blocks / data_size; -1 (unallocated) stays -1."""
    mbg = tables.shape[-2]
    per_shard = eng.n_blocks // eng.data_size
    off = ((torch.arange(mbg, device=tables.device) // eng.microbatch)
           * per_shard).to(tables.dtype)
    return torch.where(tables >= 0, tables + off[:, None],
                       torch.full_like(tables, -1))


def pipeline_serve(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                   params, cache, batch, mode: str):
    """One pipelined serving call over dense strips or the paged pool.

    decode: batch = {tokens (K,M,mbg,1), positions (K,M,mbg)} — one new token
    per row at its cache depth. append: tokens (K,M,mbg,qlen) inserted per
    row starting at ``positions`` (chunked prefill at ragged depths). An
    optional ``active`` (K,M,mbg) bool row mask: inactive rows compute but
    never write their cache (the reference's ``put_cache`` row mask), so
    idle and decoding rows ride along in another row's call untouched.
    Paged (``eng.paged``): the batch also carries ``block_tables``
    (K,M,mbg,width) shard-local ids into the pool. Dense: slot (k, m)
    reads and writes its own strips ``cache[k, m]`` (the engine runs with
    one cache group per slot). Returns (cache, tokens_out (K,M,mbg) int32,
    logit_max (K,M,mbg) float32); the cache is updated in place.
    """
    if mode not in ("decode", "append"):
        raise NotImplementedError(f"serve mode {mode!r} is not ported yet "
                                  f"(decode/append only)")
    _check_family(cfg)
    if eng.paged:
        _check_paged_support(cfg, eng)
    elif eng.cache_groups != eng.n_microbatches:
        raise ValueError("dense append/decode index one cache group per "
                         "slot: run with prefill_chunks=1 (as the serve "
                         "engine does)")
    S, K = eng.n_stages, eng.n_trials
    plan = plan_stages(cfg, S)
    l_s = plan.layers_per_stage
    tokens, positions = batch["tokens"], batch["positions"]
    active = batch.get("active")
    tables = (global_block_tables(eng, batch["block_tables"]) if eng.paged
              else None)
    mbg, qlen = tokens.shape[-2], tokens.shape[-1]
    dev = tokens.device
    steps = torch.arange(qlen, device=dev)
    tok_out = torch.zeros(tokens.shape[:3], dtype=torch.int32, device=dev)
    val_out = torch.zeros(tokens.shape[:3], dtype=torch.float32, device=dev)
    trials = unstack_trials(params)
    acts = [None] * S  # stage s's output of the previous tick
    for t in range(eng.n_ticks):
        nxt = [None] * S
        for s in range(S):
            slot = t - s
            if not 0 <= slot < eng.n_slots:
                continue  # fill/drain bubble: masked in the reference
            k, m = slot % K, slot // K
            if s == 0:
                x = vp_embed(cfg, eng, {"tok": params["embed"]["tok"][k]},
                             tokens[k, m], opts.compute_dtype)
            else:
                x = acts[s - 1]
            lo = s * l_s
            p_layers = trials[k]["layers"][lo:lo + l_s]
            cell = (k,) if eng.paged else (k, m)
            c = {"layers": {n: v[cell][lo:lo + l_s]
                            for n, v in cache["layers"].items()},
                 "shared": None}
            y, _ = lm.stack_apply(
                cfg, opts, p_layers, x,
                pos=positions[k, m][:, None] + steps[None, :], mode=mode,
                cache=c, layer_mask=[lo + i < cfg.n_layers
                                     for i in range(l_s)],
                kv_offset=positions[k, m],
                block_tables=None if tables is None else tables[k, m],
                write_mask=None if active is None else active[k, m])
            nxt[s] = y
            if s == S - 1:  # the slot drains: greedy head
                tok_out[k, m], val_out[k, m] = vp_greedy_token(
                    cfg, eng, params["final_norm"][k], params["head"][k],
                    y[:, -1:])
        acts = nxt
    return cache, tok_out, val_out


def make_serve_step(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                    mode: str) -> Callable:
    """fn(params, cache, batch) -> (cache, tokens, logit_max) running
    :func:`pipeline_serve` in ``mode`` (decode | append). PyTorch runs
    eagerly, so there is nothing to compile; the reference's
    ``with_active`` flag is implied by an ``active`` batch entry."""
    if mode in ("mixed", "verify") and cfg.family in ("ssm", "hybrid"):
        raise ValueError("mixed-tick/verify serving is attention-family "
                         "only: ragged padded tokens would advance "
                         "recurrent SSM state")
    if mode not in ("decode", "append"):
        raise NotImplementedError(f"serve mode {mode!r} is not ported yet "
                                  f"(decode/append only)")
    _check_family(cfg)
    if eng.paged:
        _check_paged_support(cfg, eng)

    def step(params, cache, batch):
        return pipeline_serve(cfg, opts, eng, params, cache, batch, mode)

    return step


def make_slot_reset(cfg: ArchConfig, eng: EngineConfig) -> Callable:
    """fn(cache, mask) zeroing the dense cache rows of recycled slots, in
    place. ``mask``: (K, cache_groups, mb_global) bool (numpy or tensor) —
    True rows are cleared before a queued request is admitted into the
    freed slot. KV rows beyond kv_len are never attended, but SSM/conv
    states are recurrent and MUST restart from zero for the next request.
    (Paged engines never call this: stale pool blocks are masked by
    kv_len, and freed blocks return to the allocator host-side.)"""
    if eng.paged:
        raise ValueError("paged caches need no slot reset (no recurrent "
                         "state; stale blocks are masked via kv_len)")

    def reset(cache, mask):
        rows = torch.as_tensor(mask).nonzero().tolist()
        for buf in cache["layers"].values():
            for k, g, b in rows:  # leaves (K, G, Lp, mbg, ...)
                buf[k, g, :, b].zero_()
        return cache

    return reset


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


def make_transfer_kernels(cfg: ArchConfig, eng: EngineConfig
                          ) -> TransferKernels:
    """Pool copy / extract / inject on the pool tensors (in place).

    **copy(cache, src, dst)** — dst := src for every layer, ``src``/``dst``
    (K, dp, n) shard-local ids, -1 = no-op padding (the copy-on-write half
    of prefix sharing). **extract(cache, k, shard, ids)** — device → host:
    one CPU payload (2, Lp, block_size, h_kv, hd) stacking K and V per id.
    **inject(cache, k, shard, ids, payloads)** — host → device, the inverse
    of extract (round-trips bit-exactly). Local ids are offset by the
    shard's pool slice before indexing.
    """
    _check_paged_support(cfg, eng)
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
