"""Carry data given as numpy arrays (the arrays behind the JAX package's
objects) into the port's.

* :func:`graph_from_numpy`: a graph into the port's
  :class:`~repro_torch.core.pregel.Graph`.  Ids become int32 and floating
  data float32 on ``device``; nested tuples, lists and dicts of arrays keep
  their structure.
* :func:`lm_params_from_numpy`: an LM parameter tree
  (``jax.tree_util.tree_map(np.asarray, params)``) into the port's, with
  each leaf's dtype kept.
* :func:`train_state_from_numpy`: a training state ``{"params", "opt",
  "step"}`` likewise: the params as above, the optimizer state (AdamW's m
  and v, SGD's momentum, or none) leaf for leaf with dtypes kept, the step
  as an int32 scalar tensor.
* :func:`shard_state` / :func:`gather_state`: a training state (or any
  tree) cut into this rank's blocks by the mesh train step's
  ``state_specs``, and joined back into the global tree on every rank;
  :func:`sharded_zeros`: zeros at a tree's blocks (an optimizer state made
  on the ranks without its global tree).
* :func:`shard_cache` / :func:`gather_cache`: a decode cache given as
  numpy arrays (the JAX package's) cut into this rank's blocks by the
  mesh decode step's cache specs, and joined back into numpy arrays.
* :func:`relation_from_numpy`: a dense-grid relation (the reference
  ``Relation``'s ``present`` and value grids) into the port's
  :class:`~repro_torch.core.executor.Relation`.
* :func:`row_relation_from_numpy`: a row-table relation (the reference
  ``RowRelation``'s ``rows`` and value arrays) into the port's
  :class:`~repro_torch.core.executor.RowRelation`.
* :func:`imru_records_from_numpy`: IMRU training records (nested
  containers of arrays with a common leading dimension) into tensors.

The differential tests build the JAX objects and the port's from the same
arrays through these.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core.executor import Relation, RowRelation
from repro_torch.core.pregel import Graph
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models.common import ArchConfig

__all__ = ["graph_from_numpy", "lm_params_from_numpy",
           "train_state_from_numpy", "shard_state", "gather_state",
           "sharded_zeros", "shard_cache", "gather_cache",
           "relation_from_numpy",
           "row_relation_from_numpy", "imru_records_from_numpy"]


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


_NUMPY_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


def _leaf_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """One parameter array as a tensor of the same dtype.  bf16 arrays
    (``ml_dtypes.bfloat16``, which ``torch.as_tensor`` refuses) go through
    float32, which holds every bf16 value exactly."""

    a = np.asarray(a)
    dtype = _NUMPY_DTYPES.get(a.dtype.name)
    if dtype is None:
        raise TypeError(f"unsupported parameter dtype {a.dtype}")
    return torch.from_numpy(np.array(a, np.float32)).to(device, dtype)


def lm_params_from_numpy(
    cfg: ArchConfig,
    tree: Any,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Any:
    """The port's parameter tree for ``cfg`` from the JAX package's, given
    as numpy arrays.  Every leaf's shape is checked against the port's
    specs (stacked ``[L, ...]`` for the layers, ``[enc_layers, ...]`` for
    an encoder's)."""

    from repro_torch.models import lm

    device = resolve_device(device)
    specs = lm.model_specs(cfg)

    def carry(spec_tree, leaf_tree, stacked, path):
        if isinstance(spec_tree, dict):
            if not isinstance(leaf_tree, dict) or \
                    set(leaf_tree) != set(spec_tree):
                raise ValueError(f"parameter tree at {path or '/'} has keys "
                                 f"{sorted(leaf_tree)}, the specs "
                                 f"{sorted(spec_tree)}")
            return {k: carry(spec_tree[k], leaf_tree[k], stacked,
                             f"{path}/{k}") for k in spec_tree}
        t = _leaf_from_numpy(leaf_tree, device)
        want = ((stacked,) if stacked else ()) + spec_tree.shape
        if tuple(t.shape) != want:
            raise ValueError(f"parameter {path} has shape {tuple(t.shape)}, "
                             f"the specs {want}")
        return t

    return {k: carry(sub, tree[k], lm.n_stack(cfg, k), k)
            for k, sub in specs.items()}


def train_state_from_numpy(
    cfg: ArchConfig,
    state: Any,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Any:
    """The port's training state from the JAX package's, given as numpy
    arrays: ``{"params": tree, "opt": AdamState(m, v) | momentum tree | (),
    "step": int}``.  Each moment tree is carried like the params (shapes
    checked, bf16 kept via float32)."""

    from repro_torch.optim import AdamState

    device = resolve_device(device)
    opt = state["opt"]
    if isinstance(opt, tuple) and len(opt) == 0:
        new_opt: Any = ()
    elif hasattr(opt, "m") and hasattr(opt, "v"):
        new_opt = AdamState(
            m=lm_params_from_numpy(cfg, opt.m, device=device),
            v=lm_params_from_numpy(cfg, opt.v, device=device))
    else:
        new_opt = lm_params_from_numpy(cfg, opt, device=device)
    return {
        "params": lm_params_from_numpy(cfg, state["params"], device=device),
        "opt": new_opt,
        "step": torch.tensor(int(np.asarray(state["step"])),
                             dtype=torch.int32, device=device),
    }


def shard_state(state: Any, state_specs: Any, mesh) -> Any:
    """This rank's blocks of the global ``state`` (a tree parallel to
    ``state_specs``, e.g. ``train_state_from_numpy``'s), as contiguous
    tensors on the mesh's device."""

    from repro_torch.parallel.sharding import local_block

    return tree_map(lambda x, spec: local_block(x, spec, mesh).to(
        mesh.device, memory_format=torch.contiguous_format, copy=True),
        state, state_specs)


def sharded_zeros(like: Any, specs: Any, mesh) -> Any:
    """Zeros at this rank's block of every leaf of ``like`` (tensors of
    the global shapes, e.g. on the ``meta`` device), dtypes kept, on the
    mesh's device."""

    from repro_torch.parallel.sharding import local_shape

    return tree_map(lambda x, spec: torch.zeros(
        local_shape(tuple(x.shape), spec, mesh), dtype=x.dtype,
        device=mesh.device), like, specs)


def gather_state(state: Any, state_specs: Any, mesh) -> Any:
    """The global tree from every rank's blocks ``state`` (every rank of
    the mesh calls it and gets the whole)."""

    from repro_torch.parallel.sharding import join_blocks

    return tree_map(lambda x, spec: join_blocks(x, spec, mesh), state,
                    state_specs)


def shard_cache(tree: Any, cache_specs: Any, mesh) -> Any:
    """This rank's blocks of a decode cache given as numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, cache)``), dtypes kept (bf16 via
    float32), cut by ``cache_specs`` (``launch.serve.cache_specs_on``), as
    contiguous tensors on the mesh's device."""

    cpu = torch.device("cpu")
    return shard_state(tree_map(lambda a: _leaf_from_numpy(a, cpu), tree),
                       cache_specs, mesh)


def gather_cache(cache: Any, cache_specs: Any, mesh) -> Any:
    """The global cache as numpy arrays from every rank's blocks (every
    rank of the mesh calls it and gets the whole); bf16 leaves come back
    as float32, which holds them exactly."""

    def host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    return tree_map(host, gather_state(cache, cache_specs, mesh))


def relation_from_numpy(
    n: int,
    key_positions,
    present: Any,
    values: Optional[dict] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Relation:
    """The port's dense-grid relation from the reference's parts: the bool
    ``present`` grid ``[n]^k`` and ``{position: value grid}`` (float32)."""

    device = resolve_device(device)
    present = np.asarray(present, dtype=bool)
    if present.shape != (n,) * len(key_positions):
        raise ValueError(f"present has shape {present.shape}, a relation "
                         f"with {len(key_positions)} keys over [0, {n}) "
                         f"needs {(n,) * len(key_positions)}")
    vals = {}
    for p, g in (values or {}).items():
        g = np.asarray(g, dtype=np.float32)
        if g.shape != present.shape:
            raise ValueError(f"value column {p} has shape {g.shape}, "
                             f"present {present.shape}")
        vals[int(p)] = torch.from_numpy(g.copy()).to(device)
    return Relation(n=int(n), key_positions=tuple(key_positions),
                    present=torch.from_numpy(present.copy()).to(device),
                    values=vals)


def row_relation_from_numpy(
    n: int,
    key_positions,
    rows: Any,
    values: Optional[dict] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> RowRelation:
    """The port's row-table relation from the reference's parts: the
    distinct key tuples ``rows`` ``[count, k]`` in lexicographic order and
    ``{position: value array}`` aligned with them.  Ids become int32 and
    values float32 on ``device``; ids outside ``[0, n)``, a width other
    than ``len(key_positions)``, unsorted or repeated rows and misaligned
    values raise."""

    device = resolve_device(device)
    rows = np.asarray(rows)
    k = len(key_positions)
    if rows.ndim != 2 or rows.shape[1] != k:
        raise ValueError(f"rows has shape {rows.shape}, a relation with {k} "
                         f"keys needs [count, {k}]")
    if rows.size and (rows.min() < 0 or rows.max() >= n):
        raise ValueError(f"rows hold ids outside the domain [0, {n})")
    if rows.shape[0] > 1:
        step = np.diff(rows.astype(np.int64), axis=0)
        first = step[np.arange(step.shape[0]), (step != 0).argmax(axis=1)]
        if not (first > 0).all():
            raise ValueError("rows must be distinct and in lexicographic "
                             "order (as RowRelation.from_columns makes them)")
    vals = {}
    for p, v in (values or {}).items():
        v = np.asarray(v, dtype=np.float32)
        if v.shape != (rows.shape[0],):
            raise ValueError(f"value column {p} has shape {v.shape}, rows "
                             f"{rows.shape}")
        vals[int(p)] = torch.from_numpy(v.copy()).to(device)
    return RowRelation(n=int(n), key_positions=tuple(key_positions),
                       rows=torch.from_numpy(rows.astype(np.int32)).to(device),
                       values=vals)


def imru_records_from_numpy(
    records: Any,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Any:
    """IMRU records as tensors on ``device``, structure kept: floating
    arrays become float32, integer int32, bool stays bool.  Every leaf
    needs the same leading (record) dimension."""

    device = resolve_device(device)
    out = tree_map(lambda a: _tensor_from_numpy(a, device), records)
    lead = {int(t.shape[0]) for t in tree_leaves(out)}
    if len(lead) != 1:
        raise ValueError(f"records' leaves disagree on the record count: "
                         f"{sorted(lead)}")
    return out
