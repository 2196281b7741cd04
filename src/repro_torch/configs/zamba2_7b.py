"""Zamba2-7B — hybrid: Mamba2 backbone + *shared* attention block.
[arXiv:2411.15242; unverified]

The shared attention+MLP block (weights shared across applications) is applied
after every 6th backbone layer. For long_500k the shared block uses a 4096
sliding window so the cache stays O(window), keeping the arch sub-quadratic.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,  # shared block is MHA
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    rope="1d",
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                  head_dim=64, n_groups=2, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_d_ff=14336),
    sliding_window=4096,  # used for long_500k only (see models/blocks.py)
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-7B",
)
