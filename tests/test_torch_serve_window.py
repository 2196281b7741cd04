"""PyTorch port — sliding-window serving (``eng.window`` > 0) against the
JAX engine on the same weights, and against the windowed single-device
oracle (``lm.greedy_generate(..., window=)``): the cases of
``tests/test_serve_engine.py``'s sliding-window section on its staggered
trace (prompts up to 12 tokens, window 6), through dense strips and the
paged pool (gather path and the paged-attention kernel's plain version).
Per-request tokens and tick latencies, every ServeStats counter and
sample and the allocator's free lists equal the reference's; the window
bites (some request's tokens differ from unwindowed decoding); recurrent
families are rejected with the reference's ``ValueError``; the launcher
serves with ``--window``."""
import dataclasses

import pytest
import torch

from repro.serve import Request as JRequest
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.serve import Request as TRequest

from test_torch_serve_engine import (MAX_SEQ, assert_parity, configs,
                                     jax_engine, jax_params, staggered,
                                     torch_engine)

torch.set_num_threads(2)
WINDOW = 6


def _oracle(cfg, teng, req, window):
    p1 = lm.layer_slice(teng.params, 0)
    p1["embed"] = {"tok": p1["embed"]["tok"][:cfg.vocab_size]}
    p1["head"] = p1["head"][:, :cfg.vocab_size]
    return lm.greedy_generate(cfg, teng.opts, p1, req.prompt,
                              req.max_new_tokens, MAX_SEQ, torch.float32,
                              window=window)


@pytest.mark.parametrize("layout", ["dense", "paged_gather", "paged_kernel"])
def test_windowed_engine_matches_reference_and_windowed_oracle(layout):
    paged = layout != "dense"
    kernel = layout == "paged_kernel"
    cfg_j, cfg_t, eng_j, eng_t = configs(paged=paged)
    eng_j = dataclasses.replace(eng_j, window=WINDOW)
    eng_t = dataclasses.replace(eng_t, window=WINDOW)
    params = jax_params(cfg_j, eng_j)
    jeng = jax_engine(cfg_j, eng_j, params, kernel)
    teng = torch_engine(cfg_t, eng_t, params, kernel)
    jcomp = jeng.run(staggered(JRequest, cfg_j.vocab_size))
    reqs = staggered(TRequest, cfg_t.vocab_size)
    tcomp = teng.run([r.clone() for r in reqs])
    assert_parity(teng, jeng, tcomp, jcomp)
    if paged:
        assert teng.allocator.all_free()
    for r, c in zip(reqs, tcomp):
        assert c.tokens == _oracle(cfg_t, teng, r, WINDOW), \
            f"request {r.rid}: windowed engine diverged from the oracle"
    # the window must bite: some request's tokens differ from unwindowed
    # greedy decoding
    full = [_oracle(cfg_t, teng, r, 0) for r in reqs]
    assert any(c.tokens != f for c, f in zip(tcomp, full)), \
        "window never masked anything — lengths too short for the test"


def test_windowed_serving_rejects_recurrent_families():
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline as tpl
    from repro_torch.serve import ServeEngine

    cfg = get_config("falcon-mamba-7b").reduced()
    eng = tpl.EngineConfig(n_trials=1, n_microbatches=2, microbatch=2,
                           n_stages=2, max_seq=MAX_SEQ, window=WINDOW,
                           cache_dtype=torch.float32)
    params = tpl.init_trial_params(cfg, eng, tpl.plan_stages(cfg, 2),
                                   torch.Generator())
    with pytest.raises(ValueError, match="sliding-window"):
        ServeEngine(cfg, eng, params, device="cpu")


def test_launcher_window_on_cpu(capsys):
    common = ["--arch", "chatglm3-6b", "--smoke", "--n-model", "2",
              "--slots", "2", "--microbatch", "1", "--n-requests", "4",
              "--rate", "2.0", "--prompt-len", "12", "--gen-len", "4",
              "--window", "6", "--device", "cpu"]
    launcher.main(common)
    assert "continuous/dense window=6: 4 requests" in capsys.readouterr().out
    launcher.main(common + ["--paged", "--paged-kernel"])
    out = capsys.readouterr().out
    assert "continuous/paged+kernel window=6: 4 requests" in out
    launcher.main(common + ["--static"])
    assert "static window=6: 4 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="sliding-window"):
        launcher.main(common[:1] + ["falcon-mamba-7b"] + common[2:])
