"""Dispatch for the sorted segment combine: the Hopper kernel on the card,
its plain PyTorch version on the CPU."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.monoid import generic_segment_combine, get_monoid
from repro_torch.kernels.segment_combine.kernel import segment_combine_cuda
from repro_torch.kernels.segment_combine.ref import segment_combine_reference

__all__ = ["segment_combine", "kernel_eligible"]

_FAST_OPS = ("sum", "max", "min")


def kernel_eligible(values: torch.Tensor, op: str = "sum") -> bool:
    """True when the kernel takes this combine: a CUDA tensor with an f32
    or bf16 payload (the kernel accumulates in f32 and casts back, so wider
    or integer payloads would be narrowed), and ``op`` sum/max/min directly
    or as a registered monoid's ``kernel_op``."""

    if op not in _FAST_OPS and get_monoid(op).kernel_op is None:
        return False
    return values.is_cuda and values.dtype in (torch.float32, torch.bfloat16)


def segment_combine(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    n_segments: int,
    op: str = "sum",
    *,
    edge_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Combine ``values[E, F]`` by sorted ``segment_ids``; ``edge_active``
    (bool[E]) excludes rows outside the frontier.  A CPU tensor gets the
    plain version; a CUDA tensor gets the kernel, which raises on what it
    does not take.  Monoids without a ``kernel_op`` take the generic
    segmented-scan path on either device."""

    monoid = get_monoid(op)
    if monoid.kernel_op is None:
        return generic_segment_combine(
            values, segment_ids, n_segments, monoid,
            edge_active=edge_active, presorted=True,
        )
    op = monoid.kernel_op
    if values.device.type == "cpu":
        return segment_combine_reference(
            values, segment_ids, n_segments, op, edge_active=edge_active
        )
    return segment_combine_cuda(
        values, segment_ids, n_segments, op, edge_active=edge_active
    )
