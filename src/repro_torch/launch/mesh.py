"""Device selection and logical layouts — the port's counterpart of
``repro/launch/mesh.py``.

The reference builds a (data × model) device mesh; the port runs that mesh
as structure inside one process (see ``core/pipeline.py``), so a layout is
its axis sizes and nothing more: a dict such as ``{"data": 16, "model":
16}`` ('model' is Hydra's pipeline-stage axis). The production layouts are
the reference's deployment meshes, which the dry-run plans for; the card
layout is the one H100 the port runs on. Entry points run on CUDA unless
the caller asks for the CPU, and they never fall back to the CPU silently.
"""
from __future__ import annotations

import torch

CARD_LAYOUT_NAME = "card"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's deployment layout: 16×16 (data × model), or two
    pods 2×16×16 (pod × data × model)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_test_mesh(n_data: int = 2, n_model: int = 4,
                   multi_pod: bool = False) -> dict:
    """The small layout of the reference's CPU integration tests."""
    if multi_pod:
        return {"pod": 2, "data": n_data, "model": n_model}
    return {"data": n_data, "model": n_model}


def make_card_mesh() -> dict:
    """One card: every stage and data shard in one process on one H100."""
    return {"data": 1, "model": 1}


def mesh_axis_sizes(mesh) -> dict:
    """Axis name -> size of a layout dict, or of any mesh-like object with
    ``axis_names`` and ``devices.shape`` (the reference's ``Mesh``)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def layout_name(mesh) -> str:
    """'16x16', '2x16x16' — or 'card' for the one-card layout."""
    sizes = mesh_axis_sizes(mesh)
    if sizes == make_card_mesh():
        return CARD_LAYOUT_NAME
    return "x".join(str(v) for v in sizes.values())


def n_devices(mesh) -> int:
    n = 1
    for v in mesh_axis_sizes(mesh).values():
        n *= v
    return n
