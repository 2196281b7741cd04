"""PyTorch port — the data pipeline and the optimizer against the JAX
reference:

* ``TrainBatches`` / ``SyntheticTokenSource`` / ``HostShard``: bit-equal
  batches and row ranges for the same seed and engine shape;
* the three LR schedules: equal to fp32 rounding (1e-6);
* ``AdamW.update`` on K-stacked leaves with per-trial lr / wd, with and
  without clip-by-global-norm and under each schedule, for 4 steps from
  the same numpy gradients: parameters and both moments within 1e-6
  (fp32; the two frameworks round the same elementwise formula at
  slightly different places), the step count exact. The update is in
  place in the port, and the test checks that it returns the same
  objects.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpl
from repro.configs import get_config as jget
from repro.data import pipeline as jdata
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.data import pipeline as tdata
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(2)


@pytest.mark.parametrize("k,m,mb,dp,seq,seed", [(2, 3, 2, 2, 16, 0),
                                                (1, 2, 1, 1, 33, 7),
                                                (3, 1, 1, 4, 8, 123)])
def test_train_batches_bit_equal(k, m, mb, dp, seq, seed):
    kw = dict(n_trials=k, n_microbatches=m, microbatch=mb, n_stages=2,
              data_size=dp)
    cfg_j, cfg_t = jget("chatglm3-6b").reduced(), tget("chatglm3-6b").reduced()
    dj = jdata.TrainBatches(cfg_j, jpl.EngineConfig(**kw), seq, seed=seed)
    dt = tdata.TrainBatches(cfg_t, tpl.EngineConfig(**kw), seq, seed=seed)
    try:
        for step in (0, 1, 10_000_000):
            bj, bt = dj.batch_for_step(step), dt.batch_for_step(step)
            assert sorted(bj) == sorted(bt) == ["labels", "tokens"]
            for n in bj:
                assert bj[n].dtype == bt[n].dtype == np.int32
                np.testing.assert_array_equal(bj[n], bt[n])
        # the prefetching iterator yields the same stream
        np.testing.assert_array_equal(next(dj)["tokens"], next(dt)["tokens"])
    finally:
        dj.close()
        dt.close()


def test_token_source_and_host_shard_match():
    sj = jdata.SyntheticTokenSource(1000, 64, seed=3)
    st = tdata.SyntheticTokenSource(1000, 64, seed=3)
    for coords in [(0, 0, 0, 0), (1, 5, 2, 3), (7, 99, 0, 11)]:
        np.testing.assert_array_equal(sj.sequence(*coords),
                                      st.sequence(*coords))
    for idx in range(3):
        assert (jdata.HostShard(idx, 3).rows(10)
                == tdata.HostShard(idx, 3).rows(10))


SCHEDULES = {
    "constant": (jadamw.constant_schedule, tadamw.constant_schedule),
    "warmup_cosine": (jadamw.warmup_cosine_schedule(2, 6, 0.1),
                      tadamw.warmup_cosine_schedule(2, 6, 0.1)),
    "warmup_linear": (jadamw.warmup_linear_schedule(2, 6),
                      tadamw.warmup_linear_schedule(2, 6)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match(name):
    fj, ft = SCHEDULES[name]
    for step in range(9):
        assert abs(float(fj(jnp.asarray(step, jnp.int32))) - ft(step)) < 1e-6


@pytest.mark.parametrize("sched,clip", [("constant", 0.0),
                                        ("constant", 1.0),
                                        ("warmup_cosine", 1.0),
                                        ("warmup_linear", 0.5)])
def test_adamw_update_matches_reference(sched, clip):
    rng = np.random.default_rng(1)
    K = 2
    shapes = {"a": (K, 3, 5), "b": {"c": (K, 7), "d": (K, 2, 2, 3)}}

    def make(s):
        if isinstance(s, dict):
            return {n: make(v) for n, v in s.items()}
        return rng.normal(size=s).astype(np.float32)

    params = make(shapes)
    grads = [make(shapes) for _ in range(4)]
    hp = {"lr": np.asarray([3e-2, 1e-2], np.float32),
          "wd": np.asarray([0.0, 0.1], np.float32)}
    fj, ft = SCHEDULES[sched]
    oj, ot = (jadamw.AdamW(grad_clip=clip, schedule=fj),
              tadamw.AdamW(grad_clip=clip, schedule=ft))
    pj = jax.tree.map(jnp.asarray, params)
    pt = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    sj, st = oj.init(pj), ot.init(pt)

    def norm(g):
        return np.sqrt(sum(np.sum(np.square(x).reshape(K, -1), axis=1)
                           for x in jax.tree.leaves(g))).astype(np.float32)

    for step, g in enumerate(grads):
        gn = norm(g)
        pj, sj = oj.update(pj, jax.tree.map(jnp.asarray, g), sj,
                           {n: jnp.asarray(v) for n, v in hp.items()},
                           jnp.asarray(step, jnp.int32),
                           grad_norm=jnp.asarray(gn))
        out_p, out_s = ot.update(
            pt, jax.tree.map(lambda a: torch.from_numpy(a.copy()), g), st,
            hp, step, grad_norm=torch.from_numpy(gn))
        assert out_p is pt and out_s is st  # in place
    for a, b in ((pj, pt), (sj["m"], st["m"]), (sj["v"], st["v"])):
        jax.tree.map(lambda x, y: np.testing.assert_allclose(
            np.asarray(x), y.numpy(), atol=1e-6, rtol=1e-5), a, b)
    assert int(sj["count"]) == int(st["count"]) == len(grads)
