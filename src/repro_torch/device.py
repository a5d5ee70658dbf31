"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card.

    With no device named and no CUDA device present this raises: the port
    never drops to the CPU on its own, the caller asks for it."""

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
