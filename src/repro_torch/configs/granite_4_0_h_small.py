"""Granite-4.0-H-Small (32B-A9B) — hybrid MoE: 40 layers, 36 Mamba2 and 4
NoPE GQA attention (layers 5, 15, 25, 35), each followed by a 72-expert
top-10 MoE with a shared expert. [hf:ibm-granite/granite-4.0-h-small,
config.json; model_type granitemoehybrid]

Held whole: every routed expert (``n_held_experts`` 0). A card's share
under expert parallelism is a ``dataclasses.replace`` of
``n_held_experts`` / ``first_held_expert``."""
from repro_torch.configs.base import HybridMoEConfig, MoEConfig, SSMConfig

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,  # per-expert width (intermediate_size)
    vocab_size=100352,
    head_dim=128,  # hidden_size / num_attention_heads
    rope="none",  # position_embedding_type "nope"
    norm_eps=1e-5,
    act="swiglu",
    tie_embeddings=True,
    # router_aux_loss_coef: GraniteMoeHybridConfig's default (the published
    # config.json carries none)
    moe=MoEConfig(n_experts=72, top_k=10, expert_d_ff=768,
                  load_balance_coef=0.001),
    ssm=SSMConfig(kind="mamba2", d_state=128, d_conv=4, expand=2,
                  head_dim=64, n_groups=1, chunk_size=256),
    layer_types=tuple("attention" if i % 10 == 5 else "mamba"
                      for i in range(40)),
    attention_multiplier=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    shared_d_ff=1536,
    source="hf:ibm-granite/granite-4.0-h-small",
)
