"""Error-feedback gradient compression (the planner's codec ``int8_ef``).

A stateful wrapper around the int8 codec of
:mod:`repro_torch.core.physical`: residuals carry the quantization error
into the next step (1-bit-SGD-style error feedback), which keeps the long
run's updates unbiased.  The IMRU executor applies it when the plan picks
the codec.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.parallel import collectives as C

__all__ = ["ErrorFeedbackState", "ef_int8_allreduce", "init_ef_state"]


class ErrorFeedbackState(NamedTuple):
    residuals: Any  # a tree mirroring the gradients


def init_ef_state(grads_like: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residuals=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def ef_int8_allreduce(
    grads: Any,
    state: ErrorFeedbackState,
    axes: Tuple[str, ...],
) -> Tuple[Any, ErrorFeedbackState]:
    """Quantize, ``psum`` over the named axes, dequantize, with error
    feedback.  Runs under ``collectives.bind``.  The int8 codes are what
    the payload carries (summed as int32, exact); the scale is shared, a
    ``pmax`` of each rank's largest ``|g + r|``, so that every rank
    quantizes on the same grid."""

    def one(g, r):
        local_max = torch.max(torch.abs(g + r))
        gmax = C.pmax(local_max, axes) if axes else local_max
        scale = torch.clamp(gmax / 127.0, min=1e-12)
        y = g.to(torch.float32) + r
        q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
        new_r = y - q.to(torch.float32) * scale
        summed = C.psum(q.to(torch.int32), axes) if axes else q
        return (summed.to(torch.float32) * scale).to(g.dtype), new_r

    pairs = [one(g, r) for g, r in
             zip(tree_leaves(grads), tree_leaves(state.residuals))]
    outs, residuals = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(outs), grads),
            ErrorFeedbackState(tree_map(lambda _: next(residuals), grads)))
