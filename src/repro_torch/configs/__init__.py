"""Config registry of the PyTorch port: only the archs the port runs.

``get_config(name)`` / ``list_archs()`` mirror ``repro.configs``; the
registry grows as model families are ported (see ROADMAP.md).
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    HybridConfig,
    MoEConfig,
    SSMConfig,
)

from repro_torch.configs import chatglm3_6b

REGISTRY = {cfg.name: cfg for cfg in (chatglm3_6b.CONFIG,)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def list_archs():
    return sorted(REGISTRY)
