"""Qwen2-VL-72B — VLM; transformer BACKBONE only, M-RoPE.

The vision tower is a STUB: precomputed patch embeddings
(``models.frontend``) replace the first ``n_frontend_tokens`` positions, and
3-section M-RoPE position ids (temporal/height/width) drive the rotary.
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    rope="mrope",
    rope_theta=1_000_000.0,
    act="swiglu",
    frontend="vision",
    n_frontend_tokens=256,  # stubbed patch embeddings (dynamic-res upstream)
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B",
)
