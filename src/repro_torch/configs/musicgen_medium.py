"""MusicGen-medium — decoder-only transformer over EnCodec audio tokens.

Backbone only: the EnCodec/conditioning frontend is a STUB —
precomputed frame embeddings (``models.frontend.synth_frontend_embeds``)
replace the conditioning prefix; the sequence itself is EnCodec codes
(vocab 2048).
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,  # MHA (GQA with kv == heads)
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    rope="learned",  # musicgen uses sinusoidal/learned positions, not rotary
    act="gelu",
    frontend="audio",
    n_frontend_tokens=64,  # stubbed conditioning frames
    source="arXiv:2306.05284; hf:facebook/musicgen-medium",
)
