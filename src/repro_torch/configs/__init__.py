"""Config registry of the PyTorch port: the 10 assigned architectures and
the paper's own workloads, as ``repro.configs`` has them.

``get_config(name)`` / ``list_archs()`` / ``REGISTRY`` / ``MLP_CONFIG``
are the public entry points used by the launchers, tests and
``chip_smoke.py``.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    HybridConfig,
    MoEConfig,
    SSMConfig,
)

from repro_torch.configs import (
    bert_large,
    chatglm3_6b,
    deepseek_67b,
    falcon_mamba_7b,
    granite_moe_3b_a800m,
    llama4_scout_17b_a16e,
    mlp_1m,
    musicgen_medium,
    qwen2_vl_72b,
    starcoder2_15b,
    yi_34b,
    zamba2_7b,
)

# The ten assigned architectures.
ASSIGNED_ARCHS = {
    cfg.name: cfg
    for cfg in (
        yi_34b.CONFIG,
        starcoder2_15b.CONFIG,
        deepseek_67b.CONFIG,
        chatglm3_6b.CONFIG,
        musicgen_medium.CONFIG,
        falcon_mamba_7b.CONFIG,
        zamba2_7b.CONFIG,
        qwen2_vl_72b.CONFIG,
        granite_moe_3b_a800m.CONFIG,
        llama4_scout_17b_a16e.CONFIG,
    )
}

# The paper's own evaluation workloads.
PAPER_ARCHS = {
    bert_large.CONFIG.name: bert_large.CONFIG,
    mlp_1m.ARCH_VIEW.name: mlp_1m.ARCH_VIEW,
}

REGISTRY = {**ASSIGNED_ARCHS, **PAPER_ARCHS}

MLP_CONFIG = mlp_1m.CONFIG


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def list_archs(assigned_only: bool = False):
    return sorted(ASSIGNED_ARCHS if assigned_only else REGISTRY)
