"""``BENCHMARK.json`` keeps to its contract, and every file it implies is
found by name."""
from __future__ import annotations

import json
import re

import pytest

from bench.harness import compare, manifest
from bench.harness.sizes import sizes_of

ROOT = manifest.ROOT
MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# a width may never be cut: hidden, intermediate, latent, state or
# projection sizes, *_dim / *_rank, head sizes, expansion factors, experts
# per token (and this family's names for them)
WIDTH = re.compile(r"hidden_size|intermediate|latent|state|proj|_dim$|"
                   r"_rank$|head|expan|per_tok|kv_channels|ffn_hidden|"
                   r"multi_query_group|num_attention")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", *KEYS}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])
            assert (ROOT / word).exists()


def test_run_seconds_fit_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = MAN[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and not (section in ("end_to_end", "per_layer")
                                 and key == "source"):
                assert line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
            assert e["source"] in SOURCES


def test_metric_names_are_distinct():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf
            assert not WIDTH.search(key), f"{key} is a width"
        sizes_of(conf)  # every size is read from a published key


def test_cells_and_their_files():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        cell = manifest.cell(w["name"])
        assert set(cell.limits) == set(compare.NAMES)
        assert manifest.driver(cell.traffic).run
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_end_to_end_bounds():
    names = [m["name"] for m in MAN["end_to_end"]]
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_per_layer_metric(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    assert callable(manifest.reader(metric).read)
    moves = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for name in cells:
        assert "workloads" not in moves or name in moves["workloads"]
        assert name in {w["name"] for w in MAN["workloads"]}


def test_layer_names_agree():
    """Metrics of one layer give the same ``layer``, letter for letter."""
    by_prefix = {}
    for m in MAN["per_layer"]:
        by_prefix.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


def test_files_under_paths_are_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel


def test_test_files_are_not_named_as_the_repository_tests():
    ours = {f.name for f in (ROOT / "bench" / "tests").glob("test_*.py")}
    theirs = {f.name for f in (ROOT / "tests").rglob("test_*.py")}
    assert ours and not ours & theirs
