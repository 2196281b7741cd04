"""The program's ranges in a trace (``bench/yardstick/spans.py``), the
readers of ``recompute_share.train``, ``optimizer_ms.train`` and
``host_syncs_per_step.train`` on synthetic records, and
``bench/trace_program.py`` on a tiny cell on the CPU."""
from __future__ import annotations

import dataclasses

import pytest
from torch.autograd import DeviceType

from bench import trace_program
from bench.harness import manifest
from bench.tests.tiny import PLACED, tiny_cell
from bench.yardstick import spans as Z
from bench.yardstick import trace as Y

MAIN, AUTOGRAD = 1, 2  # host threads


@dataclasses.dataclass
class Ev:
    """A raw profiler record with the accessors the yardstick reads."""
    kind: str
    nm: str
    start: int
    end: int
    thread: int = MAIN
    card: int = 0
    corr: int = 0
    linked: int = 0

    def device_type(self):
        return DeviceType.CUDA if self.kind in ("kernel", "gpu_memcpy") \
            else DeviceType.CPU

    def is_user_annotation(self):
        return self.kind == "user_annotation"

    def name(self):
        return self.nm

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def start_thread_id(self):
        return self.thread

    def device_index(self):
        return self.card

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def ann(name, start, end, thread=MAIN):
    return Ev("user_annotation", name, start, end, thread)


EVENTS = [
    ann("bench.window", 0, 1000),
    ann("repro.train.step", 0, 900),
    ann("repro.train.forward", 10, 300),
    ann("repro.train.unit:forward t=0 s=0 k=0 m=0 dev=cuda:0", 20, 200),
    ann("repro.train.layer:forward layer=0 dev=cuda:0", 30, 100),
    Ev("cpu_op", "aten::mm", 40, 50, corr=11),
    Ev("kernel", "gemm", 60, 160, card=0, linked=11),
    ann("repro.train.backward", 300, 700),
    # autograd's thread recomputes a unit and its layer
    ann("repro.train.unit:recompute t=0 s=0 k=0 m=0 dev=cuda:0", 310, 400,
        AUTOGRAD),
    ann("repro.train.layer:recompute layer=0 dev=cuda:0", 320, 390,
        AUTOGRAD),
    Ev("cpu_op", "aten::mm", 330, 340, AUTOGRAD, corr=12),
    Ev("kernel", "gemm", 350, 450, card=0, linked=12),
    # a backward op on autograd's thread outside every recompute range
    Ev("cpu_op", "aten::mm", 420, 430, AUTOGRAD, corr=13),
    Ev("kernel", "gemm", 450, 500, card=0, linked=13),
    ann("repro.train.optimizer", 700, 800),
    Ev("cuda_runtime", "cudaLaunchKernel", 710, 720, corr=99),
    Ev("kernel", "adam", 720, 790, card=0, corr=99),  # runtime link only
    Ev("kernel", "stray", 950, 960, card=0),  # links to nothing
    ann("repro.train.readback", 800, 900),
]


def test_work_is_attributed_through_its_launch_on_its_thread():
    rec = Z.launched(EVENTS)
    got = [labels for _, _, _, labels in Z.attributed(rec)]
    assert got == [
        ("repro.train.step", "repro.train.forward",
         "repro.train.unit:forward", "repro.train.layer:forward"),
        ("repro.train.unit:recompute", "repro.train.layer:recompute"),
        (),  # launched on autograd's thread: main's ranges do not hold it
        ("repro.train.step", "repro.train.optimizer"),
        None,
    ]
    assert rec.links == {"op": 3, "runtime": 1, "none": 1}
    sec = Z.seconds_by_label(Z.attributed(rec), 0, 1000)
    assert sec["recompute"] == {0: 100e-9}
    assert sec["repro.train.optimizer"] == {0: 70e-9}
    assert sec["repro.train.step"] == {0: 170e-9}
    assert sec["unlinked"] == {0: 10e-9}
    assert "repro.train.backward" not in sec


def test_program_counts_ranges_and_keeps_counters():
    counters = {"host_syncs": {"repro.train.readback": 2}}
    prog = Z.program(EVENTS, 0, 1000, counters)
    assert prog["ranges"]["repro.train.layer:recompute"] == 1
    assert prog["ranges"]["repro.train.step"] == 1
    assert "bench.window" not in prog["ranges"]
    assert prog["counters"] == counters


def test_gap_labels_take_the_innermost_bench_or_program_range():
    rec = Y.records(EVENTS)
    ranges = Z.host_ranges(rec)
    assert Y.label_at(ranges, 850) == "repro.train.readback"
    assert Y.label_at(ranges, 395) \
        == "repro.train.unit:recompute t=0 s=0 k=0 m=0 dev=cuda:0"
    assert Y.label_at(ranges, 650) == "repro.train.backward"
    assert Y.label_at(ranges, 950) == "bench.window"
    # the benchmark's own labels, unchanged
    assert Y.label_at(Y.ranges(rec), 850) == "bench.window"


def _run_of(busy, prog):
    return {"trace": {"busy_s": busy, "program": prog}}


PROG = {"ranges": {"repro.train.optimizer": 1,
                   "repro.train.layer:recompute": 8},
        "device_s": {"recompute": {0: 0.3, 1: 0.1},
                     "repro.train.optimizer": {0: 0.05, 1: 0.07}},
        "counters": {"host_syncs": {"repro.train.readback": 2,
                                    "repro.train.backward": 1}}}


def test_readers_read_the_program():
    run = _run_of({0: 1.0, 1: 0.5}, PROG)
    read = {n: manifest.reader(n).read(run)
            for n in trace_program.READERS}
    assert read["recompute_share.train"] == pytest.approx(25.0)
    assert read["optimizer_ms.train"] == pytest.approx(120.0)
    assert read["host_syncs_per_step.train"] == 3.0


@pytest.mark.parametrize("run", [
    {"trace": None},  # no traced step
    {"trace": {"busy_s": {0: 1.0}}},  # a program without its ranges
    _run_of({0: 1.0}, dict(PROG, ranges={})),  # its tracer off
    _run_of({}, PROG),  # the CPU: no card
])
def test_readers_find_nothing(run):
    for name in trace_program.READERS:
        assert manifest.reader(name).read(run) is None, name


@pytest.mark.parametrize("name", ["chatglm3-6b-l4.hydra-k2", PLACED[0]])
def test_tiny_cell_carries_the_programs_ranges_and_counters(name):
    cell = tiny_cell(name, seq=8)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  microbatches=2,
                                                  setup_steps=1))
    out = trace_program.run(cell, 2 ** 31 + 7, repeats=1, device="cpu")
    t = cell.traffic
    slots = t["trials"] * t["microbatches"]
    ranges = out["program"]["ranges"]
    assert ranges["repro.train.step"] == ranges["repro.train.optimizer"] == 1
    assert ranges["repro.train.unit:forward"] == t["stages"] * slots
    assert ranges["repro.train.unit:recompute"] == t["stages"] * slots
    assert ranges["repro.train.layer:forward"] \
        == slots * cell.sizes.n_layers
    hops = (t["stages"] - 1) * slots if t["layout"] else 0
    assert ranges.get("repro.train.hop", 0) == hops
    counters = out["program"]["counters"]  # the CPU syncs nothing
    assert set(counters) == ({"hop_bytes"} if hops else set())
    assert out["host_ops"]["on"] == out["host_ops"]["off"]
    assert set(out["readings"]) == set(trace_program.READERS)
    assert all(v is None for v in out["readings"].values())
    assert out["device"] == "cpu"
