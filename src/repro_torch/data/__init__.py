from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticLMStream,
    batch_for_step,
)

__all__ = ["DataConfig", "SyntheticLMStream", "batch_for_step"]
