"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates
without sparsity, at the 700 W limit)."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # FLOP/s
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80 * 1000 ** 3
