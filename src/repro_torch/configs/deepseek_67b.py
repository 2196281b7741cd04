"""DeepSeek-67B — llama-arch dense decoder, GQA. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    rope="1d",
    rope_theta=10_000.0,
    act="swiglu",
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
)
