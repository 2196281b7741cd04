"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA
H100s: one run of one cell is ``python3 bench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the root
of the repository lists the cells."""
