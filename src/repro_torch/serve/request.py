"""Request/completion datatypes and arrival traces for the serve engine.

A *trace* is a list of :class:`Request` with monotone ``arrival`` times in
engine-tick units; ``poisson_trace`` synthesizes the open-loop arrival
process the benchmarks replay, and ``save_trace``/``load_trace`` round-trip
traces through JSONL so a measured production stream can be replayed with
``python -m repro_torch.launch.serve --trace path.jsonl``.

Multi-architecture co-serving: every request names the model variant it is
addressed to via ``arch`` — the trial row k of the gang's (k, m, b) slot
grid. A single-arch trace is simply one where every ``arch`` is 0.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a greedy-generation budget.

    ``arch`` routes the request to one model variant of the co-serving gang
    (trial row k); ``deadline`` is an absolute engine tick the deadline-aware
    batcher policy orders by (None = best-effort).
    """

    rid: int
    prompt: np.ndarray  # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0  # engine tick at which the request becomes visible
    arch: int = 0  # trial row (model variant) this request is addressed to
    deadline: Optional[float] = None  # absolute tick for the deadline policy

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: prompt must be a non-empty "
                             f"1-d token array, got shape {self.prompt.shape}")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >=1")
        if self.arch < 0:
            raise ValueError(f"request {self.rid}: arch must be >= 0")

    def clone(self) -> "Request":
        """Independent copy for replaying one trace through several engines
        (engines never mutate requests, but the prompt array is shared state
        a caller should not have to reason about)."""
        return Request(self.rid, self.prompt.copy(), self.max_new_tokens,
                       self.arrival, self.arch, self.deadline)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        """Cache rows the request needs: prompt + generated (the final token
        is emitted by the head and never written back)."""
        return self.prompt_len + self.max_new_tokens - 1

    @property
    def draft_total_len(self) -> int:
        """Max cache depth a paired drafter row reaches for this request
        (gang speculation — the batcher reserves this many positions of
        drafter capacity at admission). The drafter catches up to the
        target's committed stream and proposes at most gamma_eff =
        remaining - 1 tokens ahead, so its depth is bounded by
        ``total_len - 1``: it never drafts past the position whose token
        would be the request's final (never-verified) output."""
        return max(self.total_len - 1, 1)


@dataclasses.dataclass
class Completion:
    """Per-request result + scheduling timestamps (engine ticks)."""

    rid: int
    prompt_len: int
    tokens: list  # generated token ids (greedy), len == max_new_tokens
    arrival: float
    admitted_tick: int
    finished_tick: int
    arch: int = 0
    first_token_tick: int = -1  # tick the head emitted the first token

    @property
    def latency_ticks(self) -> float:
        return self.finished_tick - self.arrival

    @property
    def queue_ticks(self) -> float:
        return self.admitted_tick - self.arrival

    @property
    def ttft_ticks(self) -> float:
        """Time to first token: arrival -> first head emission."""
        if self.first_token_tick < 0:
            return self.latency_ticks
        return self.first_token_tick - self.arrival

    @property
    def tpot_ticks(self) -> float:
        """Mean time per output token after the first (decode cadence)."""
        n = len(self.tokens)
        if n <= 1 or self.first_token_tick < 0:
            return 0.0
        return (self.finished_tick - self.first_token_tick) / (n - 1)


def poisson_trace(n_requests: int, rate: float, vocab: int,
                  prompt_lens: Sequence[int] = (8, 12, 16),
                  gen_lens: Sequence[int] = (4, 8, 12),
                  seed: int = 0, n_arches: int = 1,
                  arch_weights: Optional[Sequence[float]] = None,
                  deadline_slack: float = 0.0) -> list:
    """Open-loop Poisson arrivals with staggered prompt/gen lengths.

    ``rate`` is requests per engine tick. Prompt/gen lengths are drawn
    uniformly from the given sets — small sets on purpose, so the engine
    compiles few distinct chunk shapes (production would bucket lengths
    the same way). ``n_arches`` > 1 draws each request's target model
    variant from ``arch_weights`` (uniform when omitted) — the mixed
    request stream a co-serving gang routes across its trial rows.
    ``deadline_slack`` > 0 stamps each request with
    ``arrival + slack * (prompt_len + gen_len)`` for the deadline policy.
    """
    rng = np.random.default_rng(seed)
    if arch_weights is not None:
        w = np.asarray(arch_weights, np.float64)
        if w.shape[0] != n_arches or (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"arch_weights must be {n_arches} non-negative "
                             f"weights with a positive sum, got {arch_weights}")
        w = w / w.sum()
    else:
        w = None
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        pl = int(rng.choice(list(prompt_lens)))
        gl = int(rng.choice(list(gen_lens)))
        arch = int(rng.choice(n_arches, p=w)) if n_arches > 1 else 0
        dl = t + deadline_slack * (pl + gl) if deadline_slack > 0 else None
        prompt = rng.integers(0, vocab, (pl,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gl,
                            arrival=t, arch=arch, deadline=dl))
    return reqs


def save_trace(path: str, requests: Sequence[Request]) -> None:
    with open(path, "w") as f:
        for r in requests:
            rec = {"rid": r.rid, "prompt": r.prompt.tolist(),
                   "max_new_tokens": r.max_new_tokens, "arrival": r.arrival}
            if r.arch:
                rec["arch"] = r.arch
            if r.deadline is not None:
                rec["deadline"] = r.deadline
            f.write(json.dumps(rec) + "\n")


def load_trace(path: str) -> list:
    reqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            dl = d.get("deadline")
            reqs.append(Request(rid=int(d["rid"]),
                                prompt=np.asarray(d["prompt"], np.int32),
                                max_new_tokens=int(d["max_new_tokens"]),
                                arrival=float(d.get("arrival", 0.0)),
                                arch=int(d.get("arch", 0)),
                                deadline=float(dl) if dl is not None else None))
    return reqs
