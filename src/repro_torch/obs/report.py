"""Human-readable report rendering for the serve launcher.

The launch scripts used to interleave ``print`` calls with engine access;
now every report block is a pure function from stats/completions to a
list of lines, and only the launcher (exempt from ruff's T201 wall)
actually prints. Library code stays print-free, and the same lines can be
logged, asserted on, or dropped into a trace without terminal I/O.

Formatting is kept byte-compatible with the historical launcher output —
these lines are the de-facto smoke-test interface people grep.
"""
from __future__ import annotations


def render_capacity_plan(planned, slots: int, paged: bool) -> list:
    line = (f"capacity plan: {planned.n_trials} trial row(s) x "
            f"{planned.n_microbatches} slots fit the HBM budget; "
            f"using {slots} slots/trial")
    if paged:
        line += (f" (pool: {planned.n_blocks} x {planned.block_size}-token "
                 f"blocks per trial")
        if planned.host_blocks:
            line += f" + {planned.host_blocks} host blocks/partition"
        line += ")"
    return [line]


def render_completions(completions, multi_arch: bool = False,
                       limit: int = 8) -> list:
    lines = []
    for c in completions[:limit]:
        arch = f" arch={c.arch}" if multi_arch else ""
        lines.append(f"  req[{c.rid}]{arch} plen={c.prompt_len} "
                     f"queue={c.queue_ticks:.1f} ttft={c.ttft_ticks:.1f} "
                     f"latency={c.latency_ticks:.1f} generated {c.tokens}")
    if len(completions) > limit:
        lines.append(f"  ... {len(completions) - limit} more")
    return lines


def render_summary(mode: str, n_completions: int, s: dict,
                   policy: str = "fcfs") -> list:
    lines = [
        f"{mode}: {n_completions} requests, "
        f"{s['tokens_generated']} tokens generated in {s['ticks']} ticks "
        f"({s['tokens_per_s']} tok/s on this host)",
        f"slot occupancy {s['slot_occupancy']}, "
        f"decode occupancy {s['decode_occupancy']}",
    ]
    if "mixed_calls" in s:
        lines.append(f"fused admission: {s['mixed_calls']} mixed calls out "
                     f"of {s['calls']}, wave fill ratio "
                     f"{s['mixed_fill_ratio']}")
    if "ttft_p50" in s:
        lines.append(
            f"TTFT p50/p95 {s['ttft_p50']}/{s['ttft_p95']} ticks, "
            f"TPOT p50/p95 {s.get('tpot_p50', 0)}/{s.get('tpot_p95', 0)} "
            f"ticks/token [{policy}]")
    if "tokens_per_arch" in s:
        per = ", ".join(f"arch{k}={v}"
                        for k, v in s["tokens_per_arch"].items())
        lines.append(f"tokens per arch: {per}")
    return lines


def render_paged(s: dict, n_blocks: int, block_size: int, host_blocks: int,
                 overcommit: float) -> list:
    lines = [f"block pool: {n_blocks} x {block_size}-token blocks "
             f"per trial, peak in use {s.get('peak_blocks_in_use', 0)}, "
             f"pool stalls {s.get('pool_stalls', 0)}"]
    if overcommit > 1.0 or host_blocks > 0:
        lines.append(f"tiered store: {s.get('retractions', 0)} retractions, "
                     f"{s.get('restored', 0)} restored, "
                     f"{s.get('swap_out_blocks', 0)} blocks swapped out, "
                     f"{s.get('swap_in_blocks', 0)} swapped in "
                     f"(host tier {host_blocks} blocks/partition)")
    return lines


def render_spec(s: dict, sp: dict) -> list:
    ticks_base = s["calls"] / max(s["tokens_generated"], 1)
    ticks_spec = ((s["prefill_calls"] + sp["spec_verify_calls"])
                  / max(s["tokens_generated"], 1))
    return [f"speculation: {sp['spec_accepted']}/{sp['spec_proposed']} "
            f"drafts accepted (rate {sp['acceptance_rate']}), "
            f"{sp['spec_bonus_tokens']} bonus tokens, "
            f"{sp['spec_draft_calls']} draft calls / "
            f"{sp['spec_verify_calls']} verify calls, "
            f"{sp['spec_rollback_blocks']} blocks rolled back; "
            f"target ticks/token {ticks_spec:.3f} "
            f"(vs {ticks_base:.3f} counting drafter ticks)"]


def render_prefix(s: dict) -> list:
    return [f"prefix cache: {s.get('prefix_hits', 0)} hits "
            f"({s.get('prefix_hit_tokens', 0)} tokens, "
            f"{s.get('host_hit_tokens', 0)} via host restores), "
            f"{s.get('prefix_inserts', 0)} blocks cached, "
            f"{s.get('prefix_spills', 0)} spilled to host, "
            f"{s.get('prefix_evictions', 0)} evicted, "
            f"{s.get('cow_forks', 0)} CoW forks"]


__all__ = ["render_capacity_plan", "render_completions", "render_summary",
           "render_paged", "render_spec", "render_prefix"]
