"""Yi-34B — llama-arch dense decoder with GQA. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope="1d",
    rope_theta=5_000_000.0,
    act="swiglu",
    source="arXiv:2403.04652; hf:01-ai/Yi-34B",
)
