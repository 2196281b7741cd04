"""Device selection, logical layouts and device layouts — the port's
counterpart of ``repro/launch/mesh.py``.

The reference builds a (data × model) or (pod × data × model) device mesh
('model' is Hydra's pipeline-stage axis). The port has two forms of it:

* a **logical layout** is the axis sizes and nothing more, a dict such as
  ``{"data": 16, "model": 16}``. The production layouts are the
  reference's deployment meshes, which the dry-run plans for; the card
  layout is one H100 running every stage and data shard as structure
  inside one process (``core/pipeline.py`` without a layout);
* a **device layout** (:class:`DeviceLayout`) adds the devices: a grid of
  ``torch.device`` indexed by (pod, data, model), on which the placed
  train and serve steps (``core/pipeline.py`` with ``layout=``) run stage
  ``s`` of data replica ``(p, d)`` on device ``(p, d, s)``. One process
  drives the whole grid. An explicit device list may repeat a device
  (four entries of ``cuda:0`` on one card, or of ``cpu`` in the tests).

Entry points run on CUDA unless the caller asks for the CPU, and they
never fall back to another device silently: a layout that asks for more
CUDA devices than exist raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


# ---------------------------------------------------------------------------
# Device layouts: a (pod, data, model) grid of torch devices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceLayout:
    """A (pod, data, model) grid of ``torch.device`` (numpy object array
    ``devices``), in the reference's axis order; ``multi_pod`` says whether
    the pod axis is one of the layout's axes (the reference's
    ``("pod", "data", "model")`` mesh) or a size-1 leading axis."""

    devices: np.ndarray
    multi_pod: bool = False

    @property
    def pod_size(self) -> int:
        return self.devices.shape[0]

    @property
    def data_size(self) -> int:
        return self.devices.shape[1]

    @property
    def n_stages(self) -> int:
        return self.devices.shape[2]

    @property
    def axis_sizes(self) -> dict:
        """The logical layout: ``{"data", "model"}`` sizes, with "pod"
        first when ``multi_pod``."""
        sizes = {"data": self.data_size, "model": self.n_stages}
        return {"pod": self.pod_size, **sizes} if self.multi_pod else sizes

    def device(self, p: int, d: int, s: int) -> torch.device:
        return self.devices[p, d, s]

    @property
    def root(self) -> torch.device:
        """Device (0, 0, 0): where the step gathers its metrics."""
        return self.devices[0, 0, 0]

    def describe(self) -> dict:
        """JSON-ready: the axis sizes and the device grid as strings."""
        return {"axes": self.axis_sizes,
                "devices": np.vectorize(str, otypes=[object])(
                    self.devices).tolist()}


def _card(dev: torch.device) -> torch.device:
    """A CUDA device with its index, checked against the visible cards."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{dev} asked for, but CUDA is not available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} asked for, but only "
                           f"{torch.cuda.device_count()} CUDA device(s) "
                           f"exist")
    return torch.device("cuda", index)


def make_device_layout(n_data: int, n_model: int, multi_pod: bool = False,
                       devices=None) -> DeviceLayout:
    """A (pod, data, model) device layout: pod 2 with ``multi_pod`` (as the
    reference's ``make_test_mesh``), else 1. ``devices=None`` takes
    ``cuda:0 … cuda:n-1`` and raises when fewer CUDA devices exist;
    an explicit list (strings or ``torch.device``, C order over (pod,
    data, model)) may repeat a device, and its CUDA entries must exist.
    Nothing maps a layout onto fewer devices unless the list says so."""
    n_pod = 2 if multi_pod else 1
    n = n_pod * n_data * n_model
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {n_pod}x{n_data}x{n_model} layout needs {n} CUDA "
                f"devices, {have} exist; pass an explicit device list "
                f"(which may repeat a device) to run it on fewer")
        devices = [f"cuda:{i}" for i in range(n)]
    return layout_of(devices, (n_pod, n_data, n_model), multi_pod)


def layout_of(devices, shape, multi_pod: bool = False) -> DeviceLayout:
    """The (pod, data, model) layout of ``shape`` holding ``devices``
    (strings or ``torch.device``, exactly as many, in C order); CUDA
    entries must exist."""
    devs = [torch.device(x) for x in devices]
    n = int(np.prod(shape))
    if len(devs) != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} layout takes {n} "
                         f"devices, got {len(devs)}")
    devs = [_card(x) if x.type == "cuda" else x for x in devs]
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return DeviceLayout(grid.reshape(shape), multi_pod)
