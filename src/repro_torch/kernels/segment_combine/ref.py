"""Plain PyTorch version of the sorted segment combine kernel.

Contract (the same as ``csrc/segment_combine.cu``): ``values`` [E, F] f32 or
bf16, ``segment_ids`` int32[E], ``op`` in {sum, max, min}, optional
``edge_active`` bool[E].  ``out[s]`` combines the rows with id ``s`` that are
active; rows with a negative id or an id >= ``n_segments`` are dropped.
Accumulation is in f32 and the result is cast back to ``values.dtype``.
max/min start from the identity -1e30 / +1e30 and a result equal to it reads
0, so empty segments read 0 (and so does a real max/min of -1e30 / +1e30):
the kernel's exact semantics, which makes max/min bit-equal between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_combine_reference", "IDENTITY"]

IDENTITY = {"sum": 0.0, "max": -1e30, "min": 1e30}


def segment_combine_reference(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    n_segments: int,
    op: str = "sum",
    *,
    edge_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if op not in IDENTITY:
        raise ValueError(op)
    ids = segment_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < n_segments)
    if edge_active is not None:
        valid = valid & edge_active
    idx = torch.where(valid, ids, n_segments)  # spill row n_segments
    vals = values.to(torch.float32)
    F = vals.shape[1]
    out = torch.full((n_segments + 1, F), IDENTITY[op], dtype=torch.float32,
                     device=values.device)
    if op == "sum":
        out.index_add_(0, idx, torch.where(valid[:, None], vals, 0.0))
    else:
        out.scatter_reduce_(0, idx[:, None].expand(-1, F), vals,
                            reduce="amax" if op == "max" else "amin",
                            include_self=True)
    out = out[:n_segments]
    if op != "sum":
        out = torch.where(out == IDENTITY[op], 0.0, out)
    return out.to(values.dtype)
