from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import build_model

__all__ = ["ArchConfig", "build_model"]
