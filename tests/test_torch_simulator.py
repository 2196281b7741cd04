"""PyTorch port — the schedule simulator (the paper's Fig. 2 as a
discrete-event simulation) against the JAX package's: every
``simulate_*`` and ``theoretical_shard_parallel_makespan`` on a grid of
(K models, S shards, M microbatches, backward ratio), and
``figure2_table()`` at its defaults, exactly equal (plain Python floats
in both packages)."""
import dataclasses
import itertools

import pytest

from repro.core import simulator as jsim
from repro_torch.core import simulator as tsim

GRID = list(itertools.product((1, 2, 3, 5), (1, 2, 4), (1, 3), (1.0, 2.0)))


def _same(a, b):
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


@pytest.mark.parametrize("k,s,m,bwd", GRID)
def test_simulations_match_reference(k, s, m, bwd):
    _same(tsim.simulate_shard_parallel(k, s, m, bwd_ratio=bwd),
          jsim.simulate_shard_parallel(k, s, m, bwd_ratio=bwd))
    for pipelined in (False, True):
        _same(tsim.simulate_model_parallel(k, s, m, bwd_ratio=bwd,
                                           pipelined=pipelined),
              jsim.simulate_model_parallel(k, s, m, bwd_ratio=bwd,
                                           pipelined=pipelined))
    _same(tsim.simulate_task_parallel(k, s, s, m, bwd_ratio=bwd),
          jsim.simulate_task_parallel(k, s, s, m, bwd_ratio=bwd))
    assert tsim.theoretical_shard_parallel_makespan(k, s, m, bwd_ratio=bwd) \
        == jsim.theoretical_shard_parallel_makespan(k, s, m, bwd_ratio=bwd)
    a = tsim.simulate_shard_parallel(k, s, m, bwd_ratio=bwd)
    b = tsim.simulate_model_parallel(k, s, m, bwd_ratio=bwd)
    assert a.speedup_over(b) == jsim.simulate_shard_parallel(
        k, s, m, bwd_ratio=bwd).speedup_over(
        jsim.simulate_model_parallel(k, s, m, bwd_ratio=bwd))


def test_figure2_table_matches_reference():
    assert tsim.figure2_table() == jsim.figure2_table()


def test_cyclic_graph_raises_in_both():
    tasks = [(0, 1.0, [1]), (0, 1.0, [0])]
    for mod in (jsim, tsim):
        with pytest.raises(RuntimeError, match="cyclic"):
            mod._simulate(tasks, 1)
