from repro_torch.checkpoint.store import (
    CheckpointStore,
    MeshCheckpointStore,
    latest_step,
    restore_pytree,
    save_pytree,
)

__all__ = ["CheckpointStore", "MeshCheckpointStore", "save_pytree",
           "restore_pytree", "latest_step"]
