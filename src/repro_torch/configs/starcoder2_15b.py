"""StarCoder2-15B — dense decoder, GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope="1d",
    rope_theta=100_000.0,
    act="gelu",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-15b",
)
