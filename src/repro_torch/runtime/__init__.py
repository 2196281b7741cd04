from repro_torch.runtime import fault_tolerance  # noqa: F401
