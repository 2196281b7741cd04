"""The plain reference the benchmark holds the program to: fp32 PyTorch,
TF32 off, one trial at a time, unpipelined. It imports nothing of the
program; it re-draws its weights and batches from the seed."""
