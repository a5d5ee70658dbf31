"""Dispatch for flash attention: the Hopper forward kernel on the card, its
plain PyTorch version on the CPU.  Forward only; the backward kernels and
the ``torch.autograd.Function`` around them are ROADMAP B3/B4."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_fwd
from repro_torch.kernels.flash_attention.ref import attention_reference

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise attention.  q:[B,H,Sq,D], k/v:[B,KH,Skv,D] -> [B,H,Sq,D].

    A CPU tensor gets the plain version; a CUDA tensor gets the kernel,
    which raises on what it does not take (and on inputs that require
    grad: forward only)."""

    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale)
    out, _, _ = flash_fwd(q, k, v, causal=causal, window=window,
                          sm_scale=sm_scale, layout="bhsd")
    return out
