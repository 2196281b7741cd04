from repro_torch.optim.adamw import (  # noqa: F401
    AdamW, constant_schedule, warmup_cosine_schedule, warmup_linear_schedule)
