"""``BENCHMARK.json`` and the files it names, found by name:

* a configuration: the ``file`` of its ``configs`` entry;
* a traffic mix: ``bench/traffic/<traffic>.json``, whose ``driver``
  names ``bench/drivers/<driver>.py``;
* a cell: ``bench/workloads/<cell>.json`` (the limits of its
  comparison, with the readings they were set from);
* a per-layer metric: its reader ``bench/metrics/<metric>.py``, a module
  with ``read(run) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from bench.harness.sizes import Sizes, load_config, sizes_of
from bench.harness.traffic import load_traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    sizes: Sizes
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """Workload ``name`` of BENCHMARK.json."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    return cell_of(name, root / conf["file"], entry["traffic"],
                   entry["chips"], man, root)


def cell_of(name: str, config_file: Path, traffic: str, chips: int,
            man: dict, root: Path = ROOT) -> Cell:
    """A cell from its files (BENCHMARK.json's entries, or a cell's files
    that no entry names yet)."""
    config = load_config(config_file)
    limits = json.loads((root / "bench" / "workloads"
                         / f"{name}.json").read_text())["limits"]
    return Cell(name=name, chips=chips, config=config,
                sizes=sizes_of(config),
                traffic=load_traffic(root / "bench" / "traffic"
                                     / f"{traffic}.json"),
                limits=limits,
                end_to_end=[m for m in man["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in man["per_layer"] if _reports(m, name)])


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(traffic: dict, root: Path = ROOT):
    return _load(root / "bench" / "drivers" / f"{traffic['driver']}.py")


def reader(metric: str, root: Path = ROOT):
    return _load(root / "bench" / "metrics" / f"{metric}.py")
