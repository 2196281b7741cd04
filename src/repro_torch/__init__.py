"""PyTorch/CUDA port of the Hydra model-selection system.

A second package beside ``repro`` (the JAX reference, which it never
imports). It trains K trials of ``chatglm3-6b`` stacked and pipelined over
S stages in one step (``core.hydra.run_model_selection``), with attention
through a hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), and serves the model through the
continuous-batching engine with a paged KV pool read by a hand-written
CUDA kernel (``csrc/paged_attention.cu``); it serves the attention-free
``falcon-mamba-7b`` through the engine's dense strips, its prefill scans
in a hand-written CUDA selective-scan kernel (``csrc/mamba_scan.cu``).
Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, where every kernel wrapper
takes its plain PyTorch version.
"""
