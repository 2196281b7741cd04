"""PyTorch/CUDA port of the Hydra model-selection system.

A second package beside ``repro`` (the JAX reference, which it never
imports). It serves ``chatglm3-6b`` through the continuous-batching engine
with a paged KV pool; attention reads the pool through a hand-written CUDA
kernel (``csrc/paged_attention.cu``). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, where every kernel wrapper takes its
plain PyTorch version.
"""
