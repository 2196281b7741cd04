"""BERT-Large — the paper's own heavy workload (§4: SQuAD fine-tune, 4×V100).

Encoder-only (layer norms with biases, learned positions, non-causal
attention); the JAX package's ``benchmarks/bench_memory.py`` uses it for the
paper's "3× per-device memory reduction under 4-way model parallelism".
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bert-large",
    family="encoder",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    head_dim=64,
    rope="learned",
    act="gelu",
    source="arXiv:1810.04805 (paper workload)",
)
