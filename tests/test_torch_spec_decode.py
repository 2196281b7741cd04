"""PyTorch port — gang speculation, against the JAX engine on the
reference's traces (tests/test_spec_decode.py) and the same weights.

K = 2: row 0 the target, row 1 its drafter, gamma 3; a perfect drafter
(the target's weights mirrored onto row 1), a mixed drafter (its own
weights, so rejected drafts roll blocks back), dense strips, and overcommit
retraction. Every SpecStats field, tokens, tick latencies, every counter
and the free lists equal the reference's; the tokens equal the port's own
oracle; with a perfect drafter the target runs fewer calls per token than
it does alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from test_spec_decode import spec_trace
from test_torch_prefix_cache import to_port
from test_torch_serve_engine import (assert_oracle, assert_parity, configs,
                                     jax_engine, jax_params, torch_engine)

torch.set_num_threads(2)
GAMMA = 3


def mirrored(params):
    """Row 0's weights on both trial rows: the drafter proposes exactly
    the target's tokens (acceptance 1.0)."""
    return jax.tree.map(lambda x: jnp.concatenate([x[:1], x[:1]], 0),
                        params)


SPEC_CASES = {
    # name: (configs kwargs, perfect drafter, trace kwargs, engine kwargs)
    "perfect": (dict(n_blocks=40), True, dict(seed=3), {}),
    "mixed": (dict(n_blocks=40), False, dict(seed=4), {}),
    "dense": (dict(paged=False), True, dict(n=4), {}),
    "overcommit": (dict(n_blocks=7), True, dict(seed=5, n=6),
                   dict(overcommit=1.5, host_blocks=16)),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_matches_reference_and_oracle(case):
    ckw, perfect, tkw, kw = SPEC_CASES[case]
    cfg_j, cfg_t, eng_j, eng_t = configs(n_trials=2, **ckw)
    paged = eng_j.paged
    params = jax_params(cfg_j, eng_j)
    if perfect:
        params = mirrored(params)
    reqs = spec_trace(cfg_j.vocab_size, **tkw)
    if case == "overcommit":
        for r in reqs:
            r.arrival = 0.0  # all at once: admission overcommits at once
    jeng = jax_engine(cfg_j, eng_j, params, paged, spec_gamma=GAMMA, **kw)
    jcomp = jeng.run([r.clone() for r in reqs], max_ticks=2000)
    teng = torch_engine(cfg_t, eng_t, params, paged, spec_gamma=GAMMA, **kw)
    tcomp = teng.run(to_port(reqs), max_ticks=2000)
    assert_parity(teng, jeng, tcomp, jcomp)
    assert_oracle(cfg_t, teng, to_port(reqs), tcomp)
    sp = teng.spec_stats
    assert sp.verify_calls > 0 and sp.draft_calls > 0
    if perfect:
        assert sp.acceptance_rate == 1.0
    else:
        assert sp.acceptance_rate < 1.0 and sp.rollback_blocks > 0
        assert teng.store.rollbacks == sp.rollback_blocks
    if case == "overcommit":
        assert teng.stats.retractions > 0
    if paged:
        assert teng.allocator.all_free()
    if case == "perfect":
        # fewer target-row calls per token than the target alone
        base = torch_engine(cfg_t, dataclasses.replace(eng_t, n_trials=1),
                            jax.tree.map(lambda x: x[:1], params))
        base.run(to_port(reqs))
        s = teng.stats
        assert (s.prefill_calls + sp.verify_calls) / s.tokens_generated \
            < base.stats.calls / base.stats.tokens_generated
