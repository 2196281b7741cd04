"""The benchmark's frozen yardsticks start equal to the functions they
were copied from: ``chip_smoke.py``'s model FLOPs and host-op rule,
``repro_torch/analysis/costs.py``'s K1 work and bound, and the H100
peaks of ``repro_torch/analysis/roofline.py``."""
from __future__ import annotations

import dataclasses

import pytest
import torch

import chip_smoke
from bench.drivers import train as drv
from bench.tests.tiny import config_sizes, tiny_cell
from bench.yardstick import costs, flops, peaks
from bench.yardstick import trace as Y
from repro_torch.analysis import costs as port_costs
from repro_torch.analysis import roofline
from repro_torch.core.pipeline import EngineConfig

SHAPES = [  # (config, trials, microbatches, rows, seq)
    ("chatglm3-6b-l4", 2, 5, 1, 2048),
    ("chatglm3-6b", 2, 4, 1, 2048),
    ("bert-large", 4, 4, 8, 512),
    ("bert-large", 2, 3, 2, 128),
]


@pytest.mark.parametrize("name,k,m,rows,seq", SHAPES)
def test_model_flops_as_chip_smoke(name, k, m, rows, seq):
    sizes = config_sizes(name)
    eng = EngineConfig(n_trials=k, n_microbatches=m, microbatch=rows,
                       n_stages=2)
    want = chip_smoke.model_flops_per_step(drv.arch_config(sizes), eng, seq)
    assert flops.model_flops_per_step(sizes, k, m, rows, seq) == want


K1_CASES = [  # q shape, k shape, causal, window, kv_offset, dtype
    ((1, 2048, 32, 128), (1, 2048, 2, 128), True, 0, 0, torch.float32),
    ((8, 512, 16, 64), (8, 512, 16, 64), False, 0, 0, torch.float32),
    ((2, 512, 16, 64), (2, 512, 16, 64), False, 0, 0, torch.bfloat16),
    ((1, 300, 8, 64), (1, 700, 2, 64), True, 128, 400, torch.bfloat16),
]


@pytest.mark.parametrize("qs,ks,causal,window,off,dtype", K1_CASES)
def test_k1_work_and_bound_as_the_port(qs, ks, causal, window, off, dtype):
    q = torch.empty(qs, dtype=dtype, device="meta")
    k = torch.empty(ks, dtype=dtype, device="meta")
    want = port_costs.flash_work(q, k, k, causal, window, off)
    got = costs.flash_work(qs, ks, ks, q.element_size(), causal, window,
                           off)
    assert got == want
    precision = str(dtype).split(".")[-1]
    assert costs.bound_s(*got[:2], precision) == port_costs.bound_s(
        *want[:2], dtype)


def test_peaks_as_the_port():
    assert peaks.PEAK_FLOPS == {"bfloat16": roofline.PEAK_FLOPS_BF16,
                                "float32": roofline.PEAK_FLOPS_FP32}
    assert peaks.HBM_BW == roofline.HBM_BW
    assert peaks.HBM_BYTES == roofline.HBM_BYTES


@pytest.mark.parametrize("name", ["chatglm3-6b-l4.hydra-k2",
                                  "bert-large.hydra-k4"])
def test_host_ops_as_chip_smoke(name):
    """The raw-record count of top-level aten calls equals
    ``chip_smoke.host_ops`` on the event tree, over one train step (its
    backward on autograd's own thread) inside a benchmark range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cell = tiny_cell(name, seq=8)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  microbatches=2))
    prog = drv.Program(cell.sizes, cell.traffic, 3,
                       drv.run_devices(cell.traffic, "cpu"))
    prog.step(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            prog.step(1)
    rec = Y.records(prof.profiler.kineto_results.events())
    lo, hi = Y.window(rec, "bench.window")
    assert Y.host_ops(rec, lo, hi) == chip_smoke.host_ops(prof.events())


def test_union_and_gaps():
    rec = Y.Records(device=[(0, "a", 10, 20), (0, "b", 15, 30),
                            (0, "c", 40, 50), (1, "a", 0, 100)],
                    host=[(1, "bench.step", 0, 100, True),
                          (1, "bench.k1", 30, 45, True)])
    assert Y.busy_ns(rec, 0, 0, 60) == 30
    assert Y.busy_ns(rec, 1, 0, 60) == 60
    assert Y.idle_gaps(rec, 0, 0, 60) == [(0, 10), (30, 40), (50, 60)]
    spans = Y.ranges(rec)
    assert Y.label_at(spans, 35) == "bench.k1"
    assert Y.label_at(spans, 55) == "bench.step"
    assert Y.label_at(spans, 150) == "outside"
