"""Device selection — the port's counterpart of ``repro/launch/mesh.py``.

The reference builds a (data × model) device mesh; the port runs that mesh
as structure inside one process (see ``core/pipeline.py``), so all it needs
here is the one device. Entry points run on CUDA unless the caller asks
for the CPU, and they never fall back to the CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev
