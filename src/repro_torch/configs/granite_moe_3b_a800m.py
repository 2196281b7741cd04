"""Granite-MoE 3B-a800m — MoE decoder, 40 experts top-8, GQA.
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,  # per-expert FFN width
    vocab_size=49155,
    head_dim=64,
    rope="1d",
    act="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512),
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)
