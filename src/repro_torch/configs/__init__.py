"""Config registry of the PyTorch port: the 10 assigned architectures and
the paper's own workloads, as ``repro.configs`` has them, and the
architectures the port adds (``EXTRA_ARCHS``).

``get_config(name)`` / ``list_archs()`` / ``REGISTRY`` / ``MLP_CONFIG`` /
``SHAPES`` / ``input_specs`` are the public entry points used by the
launchers, the dry-run, tests and ``chip_smoke.py``.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    HybridConfig,
    HybridMoEConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
    input_specs,
    shape_applicable,
)

from repro_torch.configs import (
    bert_large,
    chatglm3_6b,
    deepseek_67b,
    falcon_mamba_7b,
    granite_4_0_h_small,
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

# Architectures the port runs beyond the reference's registry (the
# benchmark's): found by ``get_config``, outside ``list_archs``.
EXTRA_ARCHS = {granite_4_0_h_small.CONFIG.name: granite_4_0_h_small.CONFIG}

MLP_CONFIG = mlp_1m.CONFIG


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name] if name in REGISTRY else EXTRA_ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: "
            f"{sorted(REGISTRY) + sorted(EXTRA_ARCHS)}") from None


def list_archs(assigned_only: bool = False):
    return sorted(ASSIGNED_ARCHS if assigned_only else REGISTRY)
