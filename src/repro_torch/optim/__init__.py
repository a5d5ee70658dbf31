from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    sgd,
    warmup_cosine,
)

__all__ = [
    "AdamState",
    "Optimizer",
    "adamw",
    "sgd",
    "clip_by_global_norm",
    "warmup_cosine",
]
