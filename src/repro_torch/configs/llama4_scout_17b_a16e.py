"""Llama-4-Scout-17B-16E — MoE decoder, 16 experts top-1, early fusion.

The reference's spec line exactly (16 experts, top-1, d_ff 8192); the
production model's extra shared expert is omitted, as in the reference.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,  # per-expert FFN width
    vocab_size=202048,
    head_dim=128,
    rope="1d",
    rope_theta=500_000.0,
    act="swiglu",
    moe=MoEConfig(n_experts=16, top_k=1, expert_d_ff=8192),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
