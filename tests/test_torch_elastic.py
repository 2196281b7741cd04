"""PyTorch port — elastic re-meshing against the JAX reference:

* ``MeshHealth`` (fresh, cordons of one row, of a whole pod, of rows in
  two pods; the usable box) equal to the reference's, and its raise when
  no row is left;
* ``shrink_engine`` equal field by field, with and without a pod axis;
* ``elastic_replan`` equal to the reference's re-plan (same budget and
  bytes per parameter, set with monkeypatch as in
  ``test_torch_cost_model.py``);
* ``rebuild_mesh``'s counterpart: the logical axis sizes of the
  reference's ``Mesh`` built on the conftest's 8 host devices, and the
  same "need N devices, have M" raise;
* the logical layouts of ``launch/mesh.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as jget
from repro.core import pipeline as jpl
from repro.core import scheduler as jsched
from repro.runtime import elastic as jel
from repro_torch.configs import get_config as tget
from repro_torch.core import pipeline as tpl
from repro_torch.core import scheduler as tsched
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import elastic as tel
from test_torch_cost_model import (SCHED_POPULATION, _equal_budget,
                                   _population, assert_same_gangs)


def _healths():
    """(reference, port) MeshHealth pairs after the same cordons."""
    out = []
    for n_pods, n_data, cordons in ((1, 4, [(0, 1)]),
                                    (2, 4, [(0, 0), (0, 3)]),
                                    (2, 4, [(1, d) for d in range(4)]),
                                    (2, 3, [(0, 2), (1, 0)]),
                                    (1, 2, [])):
        j, t = jel.MeshHealth.fresh(n_pods, n_data), \
            tel.MeshHealth.fresh(n_pods, n_data)
        for p, d in cordons:
            j, t = j.cordon(p, d), t.cordon(p, d)
        out.append((j, t))
    return out


def test_mesh_health_matches_reference():
    for j, t in _healths():
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert t.usable_data_rows == j.usable_data_rows
        assert t.usable_pods == j.usable_pods


def test_cordoning_every_row_raises_in_both():
    for mod in (jel, tel):
        h = mod.MeshHealth.fresh(1, 2).cordon(0, 0)
        with pytest.raises(RuntimeError, match="no healthy rows"):
            h.cordon(0, 1)


@pytest.mark.parametrize("pod_axis", [None, "pod"])
def test_shrink_engine_matches_reference(pod_axis):
    kw = dict(n_trials=2, n_microbatches=3, microbatch=1, n_stages=4,
              data_size=4, pod_size=2 if pod_axis else 1, pod_axis=pod_axis)
    ej, et = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    for j, t in _healths():
        sj, st = jel.shrink_engine(ej, j), tel.shrink_engine(et, t)
        for f in dataclasses.fields(st):
            a, b = getattr(st, f.name), getattr(sj, f.name)
            if f.name == "cache_dtype":
                a, b = str(a).split(".")[-1], jnp.dtype(b).name
            assert a == b, (f.name, a, b)


def test_elastic_replan_matches_reference(monkeypatch):
    _equal_budget(monkeypatch, 4)
    cj = {a: jget(a).reduced() for a, _ in SCHED_POPULATION}
    ct = {a: tget(a).reduced() for a, _ in SCHED_POPULATION}
    kw = dict(n_trials=1, n_microbatches=1, microbatch=2, n_stages=4,
              data_size=4)
    ej, et = jpl.EngineConfig(**kw), tpl.EngineConfig(**kw)
    gj = jsched.plan_gangs(_population(jsched, SCHED_POPULATION), ej, cj, 128)
    gt = tsched.plan_gangs(_population(tsched, SCHED_POPULATION), et, ct, 128)
    hj = jel.MeshHealth.fresh(1, 4).cordon(0, 2)
    ht = tel.MeshHealth.fresh(1, 4).cordon(0, 2)
    assert_same_gangs(tel.elastic_replan(gt, et, ct, 128, ht),
                      jel.elastic_replan(gj, ej, cj, 128, hj))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("n_stages", [1, 2])
def test_rebuild_mesh_matches_reference(multi_pod, n_stages):
    devices = jax.devices()
    assert len(devices) == 8
    for j, t in _healths():
        need = (j.usable_pods if multi_pod else 1) * j.usable_data_rows \
            * n_stages
        if need > len(devices):
            for fn, h, devs in ((jel.rebuild_mesh, j, devices),
                                (tel.rebuild_mesh, t, devices),
                                (tel.rebuild_mesh, t, len(devices))):
                with pytest.raises(RuntimeError,
                                   match=f"need {need} devices, have 8"):
                    fn(devs, h, n_stages, multi_pod)
            continue
        mesh = jel.rebuild_mesh(devices, j, n_stages, multi_pod)
        want = dict(zip(mesh.axis_names, mesh.devices.shape))
        assert tel.rebuild_mesh(devices, t, n_stages, multi_pod) == want
        assert tel.rebuild_mesh(len(devices), t, n_stages, multi_pod) == want
        assert tmesh.mesh_axis_sizes(mesh) == want


def test_layouts():
    assert tmesh.make_production_mesh() == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}
    assert tmesh.make_test_mesh(2, 4) == {"data": 2, "model": 4}
    assert tmesh.make_test_mesh(1, 2, multi_pod=True) == \
        {"pod": 2, "data": 1, "model": 2}
    assert tmesh.make_card_mesh() == {"data": 1, "model": 1}
    assert [tmesh.layout_name(m) for m in (
        tmesh.make_production_mesh(), tmesh.make_production_mesh(
            multi_pod=True), tmesh.make_card_mesh())] == \
        ["16x16", "2x16x16", "card"]
    assert tmesh.n_devices(tmesh.make_production_mesh(multi_pod=True)) == 512
