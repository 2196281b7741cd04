"""Falcon-Mamba-7B — attention-free Mamba1 architecture.
[arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,  # attention-free, no FFN sub-block (mamba block is the mixer+ffn)
    vocab_size=65024,
    rope="none",
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2, dt_rank=256),
    source="arXiv:2410.05355; hf:tiiuae/falcon-mamba-7b",
)
