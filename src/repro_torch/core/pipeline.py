"""Hydra's pipelined serving program, run in one process (PyTorch port).

Port of the serve half of ``repro/core/pipeline.py``. The reference
compiles one SPMD program over a (data × model) device mesh; the port keeps
the schedule's semantics exactly — the tests compare tokens, ticks and call
counts with the reference — and runs the mesh as structure inside one
process on one device:

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
    program adds that offset before touching the pool.

Pools and caches are updated in place (the reference donates them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partitioner import StagePlan, plan_stages
from repro_torch.models import lm
from repro_torch.models.layers import ModelOptions


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of one Hydra serving gang (same-arch trials).

    The K trial rows double as the co-serving axis: each row holds one
    model variant's weights and pool, and the serve engine routes per-arch
    request streams into the matching rows. The reference's mesh-axis
    names, pod axis, FSDP and training knobs, sliding-window serving and
    the host spill tier are not ported.
    """

    n_trials: int  # K — concurrent model variants
    n_microbatches: int  # M — slots per trial per call
    microbatch: int  # rows per (slot × data shard)
    n_stages: int  # S — pipeline stages
    data_size: int = 1  # logical data shards (pool partitions per trial)
    max_seq: int = 0  # per-request token capacity
    cache_dtype: torch.dtype = torch.bfloat16
    paged: bool = False  # KV in a shared block pool (the only ported mode)
    block_size: int = 16  # tokens per block
    n_blocks: int = 0  # pool size PER TRIAL; each data shard owns an equal
    # slice of n_blocks / data_size blocks
    prefill_chunks: int = 1  # admission chunks per prompt (serve engine)

    @property
    def n_slots(self) -> int:
        return self.n_trials * self.n_microbatches

    @property
    def n_ticks(self) -> int:
        return self.n_slots + self.n_stages - 1

    @property
    def mb_global(self) -> int:
        return self.microbatch * self.data_size

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

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return leaves[0][None] if len(leaves) == 1 else torch.stack(leaves)

    params = stack(*trials)
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
# Serving: pipelined decode / append over the paged pool
# ---------------------------------------------------------------------------


def _check_paged_support(cfg: ArchConfig, eng: EngineConfig) -> None:
    if not eng.paged:
        raise NotImplementedError("dense (non-paged) serving is not ported "
                                  "yet; set EngineConfig.paged")
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if eng.n_blocks < 1:
        raise ValueError("paged serving needs n_blocks >= 1")
    if eng.n_blocks % eng.data_size:
        raise ValueError(f"n_blocks={eng.n_blocks} must divide evenly over "
                         f"the {eng.data_size} data-parallel pool partitions")


def serve_cache_struct(cfg: ArchConfig, eng: EngineConfig, device=None):
    """The serving pools: one per (trial, layer), shared by every slot cell
    — leaves (K, Lp, n_blocks, block_size, h_kv, hd), zero-filled; data
    shard ``i`` owns blocks ``[i·n_blocks/dp, (i+1)·n_blocks/dp)``."""
    _check_paged_support(cfg, eng)
    plan = plan_stages(cfg, eng.n_stages)
    shape = (eng.n_trials, plan.padded_layers, eng.n_blocks, eng.block_size,
             cfg.n_kv_heads, cfg.head_dim)
    return {"layers": {n: torch.zeros(shape, dtype=eng.cache_dtype,
                                      device=device) for n in ("k", "v")},
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
    """One pipelined serving call over the paged pool.

    decode: batch = {tokens (K,M,mbg,1), positions (K,M,mbg)} — one new token
    per row at its cache depth. append: tokens (K,M,mbg,qlen) inserted per
    row starting at ``positions`` (chunked prefill at ragged depths). Both
    carry ``block_tables`` (K,M,mbg,width) shard-local ids and an optional
    ``active`` (K,M,mbg) bool row mask: inactive rows compute but never
    write the pool. Returns (cache, tokens_out (K,M,mbg) int32,
    logit_max (K,M,mbg) float32); the pool is updated in place.
    """
    if mode not in ("decode", "append"):
        raise NotImplementedError(f"serve mode {mode!r} is not ported yet "
                                  f"(decode/append only)")
    _check_paged_support(cfg, eng)
    S, K = eng.n_stages, eng.n_trials
    plan = plan_stages(cfg, S)
    l_s = plan.layers_per_stage
    tokens, positions = batch["tokens"], batch["positions"]
    active = batch.get("active")
    tables = global_block_tables(eng, batch["block_tables"])
    mbg, qlen = tokens.shape[-2], tokens.shape[-1]
    dev = tokens.device
    steps = torch.arange(qlen, device=dev)
    tok_out = torch.zeros(tokens.shape[:3], dtype=torch.int32, device=dev)
    val_out = torch.zeros(tokens.shape[:3], dtype=torch.float32, device=dev)
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
            p_layers = _rows(lm.layer_slice(params["layers"], k), lo, l_s)
            c = {"layers": {n: v[k, lo:lo + l_s]
                            for n, v in cache["layers"].items()},
                 "shared": None}
            y, _ = lm.stack_apply(
                cfg, opts, p_layers, x,
                pos=positions[k, m][:, None] + steps[None, :], mode=mode,
                cache=c, layer_mask=[lo + i < cfg.n_layers
                                     for i in range(l_s)],
                kv_offset=positions[k, m],
                block_tables=tables[k, m],
                write_mask=None if active is None else active[k, m])
            nxt[s] = y
            if s == S - 1:  # the slot drains: greedy head
                tok_out[k, m], val_out[k, m] = vp_greedy_token(
                    cfg, eng, params["final_norm"][k], params["head"][k],
                    y[:, -1:])
        acts = nxt
    return cache, tok_out, val_out


def _rows(tree, lo: int, n: int):
    """Layers [lo, lo+n) of a layer-stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _rows(v, lo, n) for k, v in tree.items()}
    return tree[lo:lo + n]


def make_serve_step(cfg: ArchConfig, opts: ModelOptions, eng: EngineConfig,
                    mode: str) -> Callable:
    """fn(params, cache, batch) -> (cache, tokens, logit_max) running
    :func:`pipeline_serve` in ``mode`` (decode | append). PyTorch runs
    eagerly, so there is nothing to compile; the reference's
    ``with_active`` flag is implied by an ``active`` batch entry."""
    if mode not in ("decode", "append"):
        raise NotImplementedError(f"serve mode {mode!r} is not ported yet "
                                  f"(decode/append only)")
    _check_paged_support(cfg, eng)

    def step(params, cache, batch):
        return pipeline_serve(cfg, opts, eng, params, cache, batch, mode)

    return step


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
