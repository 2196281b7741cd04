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
    mesh-axis names, pod axis and FSDP are not ported.
    """

    n_trials: int  # K — concurrent model variants
    n_microbatches: int  # M — slots per trial per call
    microbatch: int  # rows per (slot × data shard)
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
        (``prefill`` mode) shares one cache per request group across its
        sequence-chunk slots (the serve engine sets ``prefill_chunks`` to
        1, so each of its microbatch slots owns one)."""
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
    n_k = params["embed"]["tok"].shape[0]
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
    (K, M, mb_global, seq) tensors on the parameters' device, plus
    ``frontend_embeds`` (K, M, mb_global, nf, d), which replace the first
    nf embedded rows of every slot, and the M-RoPE archs' ``mrope_pos``
    (K, M, 3, mb_global, seq). Returns the
    (K,) per-trial losses, each the mean over its M slots, and the (K,)
    per-trial MoE aux: each (stage, slot) pair's sum over its real layers
    of the mean over data shards, summed over stages and slots and
    divided by M (the reference's psum over stages of the per-shard
    accumulator; zero for the other families)."""
    S, K, M = eng.n_stages, eng.n_trials, eng.n_microbatches
    l_s = plan_stages(cfg, S).layers_per_stage
    tokens, labels = batch["tokens"], batch["labels"]
    mbg, seq = tokens.shape[-2], tokens.shape[-1]
    pos = torch.arange(seq, device=tokens.device).expand(mbg, seq)
    loss_fn = vp_loss if eng.vocab_parallel else plain_loss
    embed = vp_embed if eng.vocab_parallel else plain_embed
    fe, mrope = batch.get("frontend_embeds"), batch.get("mrope_pos")

    def unit(x, s, k, m):
        """One (stage, slot) pair: embed at stage 0, the stage's layers,
        the loss at the last stage."""
        p = trials[k]
        if s == 0:
            x = embed(cfg, eng, p["embed"], tokens[k, m], pos,
                      opts.compute_dtype)
            if fe is not None:
                x = lm.replace_frontend_rows(x, fe[k, m])
        lo = s * l_s
        # a hybrid trial's one shared block serves every stage's sites: its
        # gradients from all stages add up in the one backward() (the
        # reference's psum over the stage axis)
        x, _, aux = lm.stack_apply(
            cfg, opts, p["layers"][lo:lo + l_s], x,
            pos=pos if mrope is None else mrope[k, m], mode="train",
            shared_params=p.get("shared"),
            layer_mask=[lo + i < cfg.n_layers for i in range(l_s)],
            layer_offset=lo, n_shards=eng.data_size)
        if s == S - 1:
            return loss_fn(cfg, eng, p["final_norm"], p["head"], x,
                           labels[k, m]), aux
        return x, aux

    # the reference's tick-level remat: each (stage, slot) pair keeps only
    # its input and is recomputed in backward
    remat = opts.remat and torch.is_grad_enabled()
    losses = [[] for _ in range(K)]
    auxes = [[] for _ in range(K)]
    acts = [None] * S  # stage s's output of the previous tick
    for t in range(eng.n_ticks):
        nxt = [None] * S
        for s in range(S):
            slot = t - s
            if not 0 <= slot < eng.n_slots:
                continue  # fill/drain bubble: masked in the reference
            k, m = slot % K, slot // K
            out, aux = (checkpoint(unit, acts[s - 1] if s else None, s, k,
                                   m, use_reentrant=False,
                                   preserve_rng_state=False)
                        if remat else unit(acts[s - 1] if s else None, s, k,
                                           m))
            auxes[k].append(aux)
            if s == S - 1:
                losses[k].append(out)
            else:
                nxt[s] = out
        acts = nxt
    return (torch.stack([sum(ls) for ls in losses]) / M,
            torch.stack([sum(a) for a in auxes]) / M)


def pipeline_train_loss(cfg: ArchConfig, opts: ModelOptions,
                        eng: EngineConfig, params, batch):
    """Runs the multi-trial pipelined forward; returns per-trial (loss, aux)
    (K,) tensors (aux: the MoE load-balance term, summed over the real
    layers of every stage, the mean over data shards, averaged over the M
    microbatches; zero for the other families).

    params: the trial-stacked dict (layers (K, Lp, ...), embed/tok
    (K, Vp, D), head (K, D, Vp), final_norm (K, D)). batch: tokens / labels
    (K, M, mb_global, seq), tensors or numpy, with the frontend archs'
    ``frontend_embeds`` and the M-RoPE archs' ``mrope_pos`` (see
    :func:`_train_loss`). Each tick ``t`` advances stage
    ``s`` on slot ``t - s`` (trial ``slot % K``, microbatch ``slot // K``);
    bubble pairs are skipped. Differentiable w.r.t. ``params``.
    """
    batch = _train_batch(batch, params["embed"]["tok"].device)
    return _train_loss(cfg, opts, eng, unstack_trials(params), batch)


def _train_batch(batch, device):
    """tokens / labels and any frontend_embeds / mrope_pos (tensors or
    numpy) as tensors on ``device``."""
    return {n: (batch[n] if torch.is_tensor(batch[n])
                else torch.from_numpy(np.ascontiguousarray(batch[n])))
            .to(device) for n in ("tokens", "labels", "frontend_embeds",
                                  "mrope_pos") if n in batch}


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
    returned. The objective is ``Σ_k (loss_k + coef · aux_k)`` for the moe
    family (the reference's: no ``/ n_layers`` here, unlike
    ``lm.loss_fn``), the CE alone otherwise; ``metrics["loss"]`` is the CE
    alone, as in the reference. ``hparams`` holds (K,) per-trial
    hyperparameters (Hydra's model-selection axis); metrics {"loss",
    "grad_norm"} are (K,) numpy arrays. The gradient buffer (one per
    parameter leaf) is allocated at the first call and reused.
    """
    bufs = {}

    def step_fn(params, opt_state, batch, hparams, step):
        if "grads" not in bufs:
            bufs["grads"] = tree_map(torch.zeros_like, params)
        grads = bufs["grads"]
        for g in tree_leaves(grads):
            g.zero_()
        batch = _train_batch(batch, params["embed"]["tok"].device)
        loss_vec, aux_vec = _train_loss(cfg, opts, eng,
                                        _grad_leaves(params, grads), batch)
        total = loss_vec.sum()
        if cfg.moe is not None:
            total = total + cfg.moe.load_balance_coef * aux_vec.sum()
        total.backward()
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
    if cfg.family == "mlp":
        raise ValueError("the mlp workload has no serving path (no "
                         "sequence, no cache)")


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
    if eng.n_blocks % eng.data_size:
        raise ValueError(f"n_blocks={eng.n_blocks} must divide evenly over "
                         f"the {eng.data_size} data-parallel pool partitions")


def serve_cache_struct(cfg: ArchConfig, eng: EngineConfig, device=None):
    """The serving caches, zero-filled.

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
    shard · n_blocks / data_size; -1 (unallocated) stays -1."""
    mbg = tables.shape[-2]
    per_shard = eng.n_blocks // eng.data_size
    off = ((torch.arange(mbg, device=tables.device) // eng.microbatch)
           * per_shard).to(tables.dtype)
    return torch.where(tables >= 0, tables + off[:, None],
                       torch.full_like(tables, -1))


SERVE_MODES = ("prefill", "decode", "append", "mixed", "verify")


def _check_mrope_mode(cfg: ArchConfig, mode: str) -> None:
    if mode in ("append", "mixed", "verify") and cfg.rope == "mrope":
        raise ValueError("append mode (continuous batching) does not "
                         "support mrope archs; use the static prefill path")


def pipeline_serve(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                   params, cache, batch, mode: str):
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


def make_serve_step(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                    mode: str, tracer=None) -> Callable:
    """fn(params, cache, batch) -> (cache, tokens, logit_max) running
    :func:`pipeline_serve` in ``mode`` (prefill | decode | append | mixed |
    verify). The reference's ``with_active`` flag is implied by an
    ``active`` batch entry.

    ``tracer`` (an enabled ``repro_torch.obs.Tracer``) wraps the step to
    emit a ``compile`` event at the first call of each (token qlen,
    block-table width) signature, as the reference does where XLA
    retraces. PyTorch runs eagerly and compiles nothing, but the event
    stream stays the reference's. With None or a disabled tracer the bare
    step comes back."""
    _check_mrope_mode(cfg, mode)
    if mode in ("mixed", "verify") and cfg.family in ("ssm", "hybrid"):
        raise ValueError("mixed-tick/verify serving is attention-family "
                         "only: ragged padded tokens would advance "
                         "recurrent SSM state")
    if mode not in SERVE_MODES:
        raise ValueError(f"unknown serve mode {mode!r} (one of "
                         f"{SERVE_MODES})")
    _check_family(cfg)
    if eng.paged:
        _check_paged_support(cfg, eng)

    def step(params, cache, batch):
        return pipeline_serve(cfg, opts, eng, params, cache, batch, mode)

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
        bufs = list(cache["layers"].values())
        if cache["shared"] is not None:  # the hybrid shared-site strips
            bufs += list(cache["shared"].values())
        for buf in bufs:
            for k, g, b in rows:  # leaves (K, G, Lp | sites, mbg, ...)
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
