from repro_torch.checkpoint.store import (
    CheckpointStore,
    latest_step,
    restore_pytree,
    save_pytree,
)

__all__ = ["CheckpointStore", "save_pytree", "restore_pytree", "latest_step"]
