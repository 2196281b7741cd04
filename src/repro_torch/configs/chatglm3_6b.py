"""ChatGLM3-6B — dense decoder, 2d (interleaved-half) RoPE, GQA kv=2.
[arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    rope="2d",  # ChatGLM applies rotary to half the head dims (2d scheme)
    rope_theta=10_000.0,
    act="swiglu",
    source="arXiv:2406.12793; hf:THUDM/chatglm3-6b",
)
