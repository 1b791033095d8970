from repro_torch.optim.optimizers import (adam, apply_updates,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedules import cosine_schedule, warmup_linear

__all__ = [
    "adam",
    "apply_updates",
    "clip_by_global_norm",
    "cosine_schedule",
    "sgd",
    "warmup_linear",
]
