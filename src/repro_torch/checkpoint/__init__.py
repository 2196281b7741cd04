from repro_torch.checkpoint import ckpt  # noqa: F401
