"""Carry a graph given as numpy arrays (the arrays behind a JAX ``Graph``)
into the port's :class:`~repro_torch.core.pregel.Graph`.

Ids become int32 and floating data float32 on ``device``; nested tuples,
lists and dicts of arrays keep their structure.  The differential tests
build the JAX graph and the port's graph from the same arrays through this.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core.pregel import Graph
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device

__all__ = ["graph_from_numpy"]


def _tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """One array as a tensor: floating -> float32, integer -> int32, bool
    stays bool."""

    a = np.asarray(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.as_tensor(a, device=device).to(dtype)


def graph_from_numpy(
    n_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    vertex_data: Any,
    edge_data: Any = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Graph:
    device = resolve_device(device)
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src and dst must be equal-length 1-D arrays, got "
                         f"{src.shape} and {dst.shape}")
    return Graph(
        n_vertices=int(n_vertices),
        src=_tensor_from_numpy(src.astype(np.int32), device),
        dst=_tensor_from_numpy(dst.astype(np.int32), device),
        vertex_data=tree_map(lambda a: _tensor_from_numpy(a, device),
                             vertex_data),
        edge_data=tree_map(lambda a: _tensor_from_numpy(a, device), edge_data),
    )
