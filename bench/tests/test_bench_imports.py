"""The import guard: nothing a run loads has the top-level module name
``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package), compared
whole, so the port ``repro_torch`` passes; and the reference imports
nothing of the program. Each check runs in a fresh interpreter (this
test process may hold JAX from the repository's other tests)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_TINY = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from bench.harness import manifest
from bench.tests.tiny import tiny_cell
cell = tiny_cell({name!r})
out = manifest.driver(cell.traffic).run(cell, 5, 0.0, True,
                                        time.perf_counter(), device="cpu")
for m in cell.per_layer:
    manifest.reader(m["name"]).read(out["run"])
import bench.run, bench.calibrate
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import bench.reference.model, bench.reference.adamw, bench.reference.train
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str, **kw) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           src=str(ROOT / "src"), **kw)],
        capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    found = top_level_modules(RUN_TINY, name="chatglm3-6b-l4.hydra-k2")
    assert "repro_torch" in found  # the port is what ran
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    found = top_level_modules(REFERENCE)
    assert not found & (FORBIDDEN | {"repro_torch"})


def test_the_run_checks_whole_names():
    sys.path.insert(0, str(ROOT))
    from bench import run

    removed = {n: m for n, m in sys.modules.items()
               if n.split(".")[0] in FORBIDDEN}
    try:
        for name in removed:
            del sys.modules[name]
        sys.modules["repro_torch_like"] = sys
        assert run.loaded_forbidden() == []
        sys.modules["repro.core"] = sys
        assert run.loaded_forbidden() == ["repro"]
    finally:
        sys.modules.pop("repro_torch_like", None)
        sys.modules.pop("repro.core", None)
        sys.modules.update(removed)
