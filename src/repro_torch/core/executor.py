"""The unified logical-plan executor (Fig. 4), on one device.

The port of :mod:`repro.core.executor`'s single-device paths:

* :func:`compile_program` runs any XY-stratified program (transitive
  closure, connected components, same-generation, multi-stratum pipelines)
  by interpreting the algebra DAG per fixpoint phase on the dense-grid
  backend, under :func:`~repro_torch.core.fixpoint.device_fixpoint` or the
  :class:`~repro_torch.core.fixpoint.HostFixpointDriver`.  Listing 1 and 2
  programs with a vectorized binding go to ``compile_pregel`` /
  ``compile_imru``.
* :func:`build_pregel_steps` materializes the planned Listing-1 superstep
  pipeline (index-join gather, message UDF, connector combine,
  ``_apply_and_merge``) and the factory of frontier-compacted sparse
  supersteps that the adaptive driver swaps in.
* :func:`build_imru_step` materializes the planned Listing-2 step: map with
  sender-side early aggregation over microbatches, then update.

Each predicate lives in the storage the planner selects for it.  On a
dense vertex-domain grid ``[0, n)``, a predicate with ``k`` key columns is
a bool presence grid ``[n]^k`` plus one float32 grid per value column:
joins are broadcast ``n^k`` grids, Project an ``any`` over the eliminated
axes, GroupBy a masked ``sum``/``amax``/``amin`` (``dense-reduce``) or the
sorted segment combine (``segment-scan``, which the planner picks for a
sum/max/min only on grids of at most 21 cells).  In a row table
(:class:`RowRelation` for an EDB), it is a fixed-capacity slab of int32
id columns, a validity mask and float32 value columns: joins are
sort-merges on int64 row codes, AntiJoin an exact set-difference, and
GroupBys past ``2^20`` grid cells and the union merges of value-carrying
predicates run the sorted segment combine.  The segment combine reaches
the segment-combine kernel on the card; every other operator of the
generic engine, and IMRU's step, is plain tensor code.  A row-table run
whose slabs overflow their capacity runs again on dense grids
(``FixpointResult.storage_fallback``).

Out of core: a row-table EDB whose slab the planner splits (``chunks=``,
``hbm_budget=``, or a slab over half the spec's memory) is held as
identically shaped chunks in pinned host memory and streamed through two
device buffers each iteration (:class:`_ChunkStream`); the rules that scan
it fire once a chunk and fold their partial outs through the head's merge
monoid.  Fault tolerance: ``run(checkpoint_dir=, resume=, injector=)``
checkpoints the carried state and the materialized views with the phase
cursor (:mod:`repro_torch.checkpoint`) and restores and replays after a
host-raised failure.

Online serving: ``run(params=)`` rebinds dense EDB relations for one
run, and :meth:`GenericExecutable.run_batched` runs k parameterized
queries through one fixpoint under ``torch.func.vmap`` (the segment
combine batches through its operator's batching rule, one combine for the
k queries).  Not ported yet, and raising ``NotImplementedError`` with the
queue item: the sharded layouts and explicit row exchanges (``mesh=``,
``exchange=``, ``remesh``: A10).
"""

from __future__ import annotations

import ast
import functools
import time
from dataclasses import dataclass, field, replace
from typing import (
    Any, Callable, Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple,
    Union,
)

import numpy as np
import torch

from repro_torch.core import algebra, stratify
from repro_torch.core.datalog import Const, Program
from repro_torch.core.fixpoint import (
    DriverConfig,
    FixpointResult,
    HostFixpointDriver,
    device_fixpoint,
)
from repro_torch.core.hardware import MeshSpec, TPU_V5E, HardwareSpec
from repro_torch.core.monoid import MonoidError, get_monoid
from repro_torch.core.physical import (
    compact_active_edges,
    dense_psum_exchange,
    difference_row_codes,
    fused_got_exchange,
    grid_to_rows,
    hash_sort_exchange,
    join_row_codes,
    merging_exchange,
    row_codes,
    row_linear_index,
    rows_to_grid,
    segment_combine_sorted,
    sort_row_codes,
    sparse_hash_sort_exchange,
    sparse_merging_exchange,
    unique_row_runs,
)
from repro_torch.core.planner import GroupBySpec, plan_program
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device

__all__ = [
    "ExecutorError",
    "Relation",
    "RowRelation",
    "GenericExecutable",
    "compile_program",
    "PregelStepBundle",
    "build_pregel_steps",
    "build_imru_step",
    "microbatch_slices",
]


class ExecutorError(Exception):
    """A program cannot be executed by the generic dense-grid backend."""


class _RowCapacityOverflow(Exception):
    """A row-table slab overflowed its static capacity mid-run; the caller
    falls back to the (lossless) dense-grid storage."""


# ---------------------------------------------------------------------------
# Dense-grid relations
# ---------------------------------------------------------------------------


@dataclass
class Relation:
    """A dense-grid relation instance over the vertex domain ``[0, n)``.

    ``key_positions`` lists the argument positions (after dropping any
    temporal argument) that index the grid; every other position is a value
    column stored as a float32 grid of the same shape.  ``present`` (bool)
    marks the tuples that exist.
    """

    n: int
    key_positions: Tuple[int, ...]
    present: torch.Tensor
    values: Dict[int, torch.Tensor] = field(default_factory=dict)

    @property
    def arity(self) -> int:
        return len(self.key_positions) + len(self.values)

    def count(self) -> int:
        return int(self.present.sum())

    def tuples(self) -> np.ndarray:
        """The present key tuples as an int array [count, n_keys]."""

        return np.argwhere(self.present.cpu().numpy())

    @classmethod
    def from_columns(
        cls, n: int, *cols,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "Relation":
        """Build a relation from positional tuple columns (numpy arrays)
        on ``device`` (default: the card; with none present this raises).

        Integer-dtype columns are vertex-domain keys; floating columns are
        values.  Duplicate key tuples keep the last value row (EDB inputs
        with value columns should be key-unique).
        """

        device = resolve_device(device)
        arrs = [np.asarray(c) for c in cols]
        key_positions = tuple(
            i for i, c in enumerate(arrs)
            if np.issubdtype(c.dtype, np.integer)
        )
        keys = [arrs[i].astype(np.int64) for i in key_positions]
        _check_vertex_ids(n, key_positions, keys)
        k = len(keys)
        idx = tuple(keys)
        present = np.zeros((n,) * k, bool)
        if k:
            present[idx] = True
        else:
            present = np.asarray(bool(len(arrs) == 0 or arrs[0].size))
        values: Dict[int, Any] = {}
        for i, c in enumerate(arrs):
            if i in key_positions:
                continue
            grid = np.zeros((n,) * k, np.float32)
            if k:
                grid[idx] = c.astype(np.float32)
            else:
                grid = np.asarray(c[-1], np.float32) if c.size else grid
            values[i] = grid
        return cls(
            n=n,
            key_positions=key_positions,
            present=torch.as_tensor(present, device=device),
            values={i: torch.as_tensor(g, device=device)
                    for i, g in values.items()},
        )


def _check_vertex_ids(n: int, key_positions, key_cols) -> None:
    """Fail loudly on out-of-domain / negative vertex ids (they would
    silently index-wrap into the dense grid or corrupt row codes)."""

    for pos, col in zip(key_positions, key_cols):
        if col.size == 0:
            continue
        lo, hi = int(col.min()), int(col.max())
        if lo < 0 or hi >= n:
            raise ExecutorError(
                f"key column {pos}: vertex id {lo if lo < 0 else hi} is "
                f"outside the domain [0, {n})"
            )


@dataclass
class RowRelation:
    """A sparse row-table relation: explicit key-tuple rows over ``[0, n)``.

    The row-table counterpart of :class:`Relation`, for an EDB whose dense
    ``n^k`` grid would be infeasible (e.g. 64k-vertex sparse edges).
    ``rows`` holds the distinct key tuples ``int32 [count, k]`` in
    lexicographic order; each value column is a ``float32 [count]`` tensor
    aligned with ``rows``, on the same device.  The planner keeps
    predicates bound to a ``RowRelation`` on ``row-table`` storage.
    """

    n: int
    key_positions: Tuple[int, ...]
    rows: torch.Tensor
    values: Dict[int, torch.Tensor] = field(default_factory=dict)

    @property
    def arity(self) -> int:
        return len(self.key_positions) + len(self.values)

    def count(self) -> int:
        return int(self.rows.shape[0])

    def tuples(self) -> np.ndarray:
        """The key tuples as an int array [count, n_keys] (lex-sorted, the
        same order :meth:`Relation.tuples` produces)."""

        return self.rows.cpu().numpy().copy()

    @classmethod
    def from_columns(
        cls, n: int, *cols,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "RowRelation":
        """Build a row-table relation from positional tuple columns (numpy
        arrays) on ``device`` (default: the card; with none present this
        raises).

        Same column typing as :meth:`Relation.from_columns` (integer dtype =
        key, floating = value); rows are deduplicated on the host (last
        value row wins) and out-of-domain ids fail loudly.
        """

        device = resolve_device(device)
        arrs = [np.asarray(c) for c in cols]
        key_positions = tuple(
            i for i, c in enumerate(arrs)
            if np.issubdtype(c.dtype, np.integer)
        )
        if not key_positions:
            raise ExecutorError(
                "RowRelation needs at least one integer key column (use "
                "Relation for arity-0 / pure-value predicates)"
            )
        keys = [arrs[i].astype(np.int64) for i in key_positions]
        _check_vertex_ids(n, key_positions, keys)
        rows = np.stack(keys, axis=-1).astype(np.int32) if keys[0].size \
            else np.zeros((0, len(keys)), np.int32)
        # Keep-last dedupe: unique over the reversed rows keeps the last
        # occurrence of each key tuple, then re-sorts lexicographically.
        uniq, idx_rev = np.unique(rows[::-1], axis=0, return_index=True)
        src = rows.shape[0] - 1 - idx_rev
        return cls(
            n=n,
            key_positions=key_positions,
            rows=torch.as_tensor(uniq, device=device),
            values={
                i: torch.as_tensor(np.asarray(arrs[i], np.float32)[src],
                                   device=device)
                for i in range(len(arrs)) if i not in key_positions
            },
        )

    def to_dense(self) -> Relation:
        """Materialize onto the dense grid, on this relation's device
        (differential-test helper; only feasible for small domains)."""

        rows = self.rows.cpu().numpy()
        cols: List[np.ndarray] = []
        j = 0
        for i in range(self.arity):
            if i in self.key_positions:
                cols.append(rows[:, j].astype(np.int64))
                j += 1
            else:
                cols.append(self.values[i].cpu().numpy())
        return Relation.from_columns(self.n, *cols, device=self.rows.device)


# Raw tuple arrays whose dense grid would exceed this many cells route to
# RowRelation automatically (the planner then keeps the predicate on
# row-table storage).
_DENSE_REL_CELL_LIMIT = 1 << 24

# Row-table GroupBy lowers through the dense grid-reduce (bit-identical to
# the dense engine) while the child's grid stays at most this many cells;
# beyond it the segmented sorted-combine path runs instead.
_GROUPBY_GRID_CELLS = 1 << 20


def _as_relation(name: str, value, domain: Optional[int], device):
    if isinstance(value, (Relation, RowRelation)):
        return value
    arr = np.asarray(value)
    if domain is None:
        raise ExecutorError(
            f"relation {name!r} given as a raw array needs an explicit "
            "domain= (or pass a Relation built with Relation.from_columns)"
        )
    if arr.ndim == 2 and np.issubdtype(arr.dtype, np.integer):
        cols = tuple(arr[:, i] for i in range(arr.shape[1]))
        if arr.shape[1] and \
                float(domain) ** arr.shape[1] > _DENSE_REL_CELL_LIMIT:
            return RowRelation.from_columns(domain, *cols, device=device)
        return Relation.from_columns(domain, *cols, device=device)
    raise ExecutorError(
        f"relation {name!r}: pass a Relation or an int tuple array "
        "[rows, arity]"
    )


# ---------------------------------------------------------------------------
# Operator interpreter — intermediates and helpers
# ---------------------------------------------------------------------------


@dataclass
class _Inter:
    """An intermediate result: a presence grid over ``dims`` (variable
    names, one grid axis each) plus full-shape value columns."""

    dims: Tuple[str, ...]
    present: torch.Tensor
    cols: Dict[str, torch.Tensor]


def _align(a: torch.Tensor, dims: Tuple[str, ...],
           out_dims: Tuple[str, ...]) -> torch.Tensor:
    """Permute + reshape a grid with axes ``dims`` into the axis order of
    ``out_dims`` (size-1 axes for dims the grid does not carry)."""

    a = a.permute([dims.index(d) for d in out_dims if d in dims])
    shape: List[int] = []
    i = 0
    for d in out_dims:
        if d in dims:
            shape.append(a.shape[i])
            i += 1
        else:
            shape.append(1)
    return a.reshape(shape)


def _dim_grid(n: int, out_dims: Tuple[str, ...], d: str, device):
    shape = [1] * len(out_dims)
    shape[out_dims.index(d)] = n
    return torch.arange(n, dtype=torch.int32, device=device).reshape(shape)


_CMP = {
    "==": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}

# The dtype jnp.asarray gives a Python constant (32-bit, as the reference).
_CONST_DTYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}

_DENSE_REDUCE = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}


def _monoid_for(agg: str):
    try:
        return get_monoid(agg)
    except MonoidError as err:
        raise ExecutorError(
            f"aggregate {agg!r} is not a registered CombineMonoid — the "
            "generic executor resolves head aggregates through the monoid "
            "registry (repro_torch.core.monoid.register_monoid)"
        ) from err


@dataclass
class _Ctx:
    """Evaluation context for one rule firing."""

    program: Program
    n: int
    device: torch.device
    sigs: Mapping[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]
    relations: Mapping[str, Relation]
    state: Mapping[str, Mapping[str, Any]]
    views: Dict[str, Dict[str, Any]]
    materialized: Mapping[str, Dict[str, Any]]
    connectors: Mapping[str, str]
    j: Any
    label: str = ""
    # CSE support: ids of canonical shared subtrees (from the rewrite pass)
    # and the per-context memo of their evaluated grids.  Sound because only
    # EDB-pure subtrees are shared — their inputs never change within a step.
    shared: FrozenSet[int] = frozenset()
    memo: Dict[int, Any] = field(default_factory=dict)
    # Row-table storage: the shared intermediate capacity, the row-table
    # EDB slabs, and the overflow flags (device bools) this firing
    # accumulated, which the overflow policy reads.
    row_cap: int = 0
    row_edb: Mapping[str, Dict[str, Any]] = field(default_factory=dict)
    overflow: List[torch.Tensor] = field(default_factory=list)
    # Out-of-core streaming: EDB predicates held as host chunk lists —
    # their scans may only fire under a chunk overlay (``row_edb`` rebound
    # to one chunk inside the streaming loop).
    chunked: FrozenSet[str] = frozenset()


def _read_pred(ctx: _Ctx, name: str) -> Dict[str, Any]:
    if name in ctx.state:
        return ctx.state[name]
    if name in ctx.views:
        return ctx.views[name]
    if name in ctx.materialized:
        return ctx.materialized[name]
    raise ExecutorError(
        f"rule {ctx.label or '?'}: predicate {name!r} read before any rule "
        "materialized it (check the fixpoint-phase ordering)"
    )


def _scan_inter(columns, key_positions, present, values_by_pos) -> _Inter:
    dims = tuple(columns[p] for p in key_positions)
    cols = {}
    for p, grid in values_by_pos.items():
        cols[columns[int(p)]] = grid
    return _Inter(dims, present, cols)


def _scan_rows(columns, key_positions, ids, valid, values_by_pos):
    dims = tuple(columns[p] for p in key_positions)
    cols = {}
    for p, col in values_by_pos.items():
        cols[columns[int(p)]] = col
    return _Rows(dims, ids, valid, cols)


def _operand(inter: _Inter, x, ctx: _Ctx):
    if isinstance(x, Const):
        if not isinstance(x.value, (int, float, bool)):
            raise ExecutorError(
                f"non-numeric constant {x.value!r} is not executable on the "
                "dense-grid backend"
            )
        return torch.tensor(x.value, dtype=_CONST_DTYPES[type(x.value)],
                            device=ctx.device)
    if x in inter.cols:
        return inter.cols[x]
    if x in inter.dims:
        return _dim_grid(ctx.n, inter.dims, x, ctx.device)
    if x == "J":
        return ctx.j
    raise ExecutorError(f"unbound column {x!r} in comparison/UDF input")


def _join(l: _Inter, r: _Inter, keys: Tuple[str, ...], ctx: _Ctx) -> _Inter:
    n = ctx.n
    out_dims = l.dims + tuple(d for d in r.dims if d not in l.dims)
    shape = (n,) * len(out_dims)

    def al(g, dims):
        return _align(g, dims, out_dims).broadcast_to(shape)

    def dim(key):
        return _dim_grid(n, out_dims, key, ctx.device)

    present = al(l.present, l.dims) & al(r.present, r.dims)
    for key in keys:
        l_dim, r_dim = key in l.dims, key in r.dims
        if l_dim and r_dim:
            continue  # shared grid axis: equality is structural
        lv, rv = l.cols.get(key), r.cols.get(key)
        if l_dim and rv is not None:
            present = present & (al(rv, r.dims) == dim(key))
        elif r_dim and lv is not None:
            present = present & (al(lv, l.dims) == dim(key))
        elif lv is not None and rv is not None:
            present = present & (al(lv, l.dims) == al(rv, r.dims))
    cols: Dict[str, torch.Tensor] = {}
    for c, g in l.cols.items():
        if c not in out_dims:
            cols[c] = al(g, l.dims)
    for c, g in r.cols.items():
        if c not in cols and c not in out_dims:
            cols[c] = al(g, r.dims)
    return _Inter(out_dims, present, cols)


# ---------------------------------------------------------------------------
# Row-table operators (the sparse storage backend)
# ---------------------------------------------------------------------------


@dataclass
class _Rows:
    """A row-table intermediate: padded id columns ``int32[cap, k]`` (one
    column per dim), a slot validity mask, and per-row value columns.
    Invariant: valid rows are unique by their dim tuple (scans read deduped
    tables; join/select/project preserve or restore uniqueness), so value
    scatters and representative-first merges are exact."""

    dims: Tuple[str, ...]
    ids: torch.Tensor
    valid: torch.Tensor
    cols: Dict[str, torch.Tensor]


def _id_cols(rows: _Rows, dims: Tuple[str, ...]) -> torch.Tensor:
    """The id columns of ``dims``, in that order (``[cap, 0]`` for none)."""

    return rows.ids[:, [rows.dims.index(d) for d in dims]]


def _codes(ids: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`row_codes`, its code-space error raised as an
    :class:`ExecutorError`."""

    try:
        return row_codes(ids, n)
    except ValueError as err:
        raise ExecutorError(str(err)) from err


def _codes_for(rows: _Rows, dims: Tuple[str, ...], n: int) -> torch.Tensor:
    """int64 row codes of a dim subset (shared-key encoding for joins)."""

    return _codes(_id_cols(rows, dims), n)


def _operand_rows(rows: _Rows, x, ctx: _Ctx):
    if isinstance(x, Const):
        if not isinstance(x.value, (int, float, bool)):
            raise ExecutorError(
                f"non-numeric constant {x.value!r} is not executable on the "
                "row-table backend"
            )
        return torch.tensor(x.value, dtype=_CONST_DTYPES[type(x.value)],
                            device=ctx.device)
    if x in rows.cols:
        return rows.cols[x]
    if x in rows.dims:
        return rows.ids[:, rows.dims.index(x)]
    if x == "J":
        return ctx.j
    raise ExecutorError(f"unbound column {x!r} in comparison/UDF input")


def _inter_to_rows(inter: _Inter, ctx: _Ctx) -> _Rows:
    """``to_rows`` boundary converter: compact a dense intermediate into a
    row table (inserted automatically where mixed-storage operators meet)."""

    cells = int(ctx.n) ** len(inter.dims)
    cap = cells if 0 < cells <= max(ctx.row_cap, 1) else max(ctx.row_cap, 1)
    ids, valid, lin, ov = grid_to_rows(inter.present, cap)
    ctx.overflow.append(ov)
    cols = {c: g.reshape(-1)[lin] for c, g in inter.cols.items()}
    return _Rows(inter.dims, ids, valid, cols)


def _rows_to_inter(rows: _Rows, ctx: _Ctx) -> _Inter:
    """``to_grid`` boundary converter: scatter a row table back onto the
    dense vertex-domain grid (only at dense-stored materialization sites,
    where the planner already approved the grid size).  Invalid rows land
    in a spill cell past the grid, which is sliced off."""

    n, k = ctx.n, len(rows.dims)
    present = rows_to_grid(rows.ids, rows.valid, n)
    if k == 0:
        cols = {
            c: torch.where(rows.valid, g, torch.zeros_like(g)).sum()
            for c, g in rows.cols.items()
        }
        return _Inter((), present, cols)
    size = n ** k
    cap = rows.ids.shape[0]
    lin = row_linear_index(rows.ids, rows.valid, n)
    cols = {}
    for c, g in rows.cols.items():
        g = torch.as_tensor(g, device=ctx.device).broadcast_to((cap,))
        grid = torch.zeros(size + 1, dtype=g.dtype, device=ctx.device)
        grid[lin] = g
        cols[c] = grid[:size].reshape((n,) * k)
    return _Inter(rows.dims, present, cols)


def _coerce_pair(l, r, ctx: _Ctx):
    """Promote a mixed dense/row operand pair to row tables (the converter
    goes dense→rows: the row side may have no feasible grid)."""

    if isinstance(l, _Rows) or isinstance(r, _Rows):
        if not isinstance(l, _Rows):
            l = _inter_to_rows(l, ctx)
        if not isinstance(r, _Rows):
            r = _inter_to_rows(r, ctx)
        return l, r, True
    return l, r, False


def _residual_valid(l: _Rows, r: _Rows, keys, li, ri, valid):
    """Apply the non-structural join key conditions (value-column equality)
    per output slot: the row analogue of the dense `_join` masks."""

    for key in keys:
        l_dim, r_dim = key in l.dims, key in r.dims
        if l_dim and r_dim:
            continue  # shared id column: equality is in the row codes
        lv, rv = l.cols.get(key), r.cols.get(key)
        if l_dim and rv is not None:
            valid = valid & (rv[ri] == l.ids[:, l.dims.index(key)][li])
        elif r_dim and lv is not None:
            valid = valid & (lv[li] == r.ids[:, r.dims.index(key)][ri])
        elif lv is not None and rv is not None:
            valid = valid & (lv[li] == rv[ri])
    return valid


def _join_rows(l: _Rows, r: _Rows, keys, ctx: _Ctx) -> _Rows:
    """Sort-merge equi-join on the shared dims' row codes; pairs expand
    into the plan's intermediate capacity (overflow-flagged)."""

    n = ctx.n
    shared = tuple(d for d in l.dims if d in r.dims)
    out_dims = l.dims + tuple(d for d in r.dims if d not in l.dims)
    li, ri, valid, ov = join_row_codes(
        _codes_for(l, shared, n), l.valid,
        _codes_for(r, shared, n), r.valid, max(ctx.row_cap, 1),
    )
    ctx.overflow.append(ov)
    valid = _residual_valid(l, r, keys, li, ri, valid)
    ids = torch.cat([l.ids[li], _id_cols(r, out_dims[len(l.dims):])[ri]],
                    dim=1)
    cols: Dict[str, torch.Tensor] = {}
    for c, g in l.cols.items():
        if c not in out_dims:
            cols[c] = g[li]
    for c, g in r.cols.items():
        if c not in cols and c not in out_dims:
            cols[c] = g[ri]
    return _Rows(out_dims, ids, valid, cols)


def _antijoin_rows(l: _Rows, r: _Rows, keys, ctx: _Ctx) -> _Rows:
    """Exact set-difference on row tables: left rows whose shared-dim
    projection (plus any residual key conditions) has NO right match keep
    their slots; everything else is invalidated."""

    n = ctx.n
    shared = tuple(d for d in l.dims if d in r.dims)
    residual = any(
        not (key in l.dims and key in r.dims) for key in keys
    )
    lc, rc = _codes_for(l, shared, n), _codes_for(r, shared, n)
    if not residual:
        keep = difference_row_codes(lc, l.valid, rc, r.valid)
        return _Rows(l.dims, l.ids, keep, l.cols)
    # Residual value conditions: probe via the pair expansion, then mark
    # left rows with any surviving match (unmatched slots spill past the
    # mask, which is sliced off).
    cap_l = lc.shape[0]
    li, ri, valid, ov = join_row_codes(
        lc, l.valid, rc, r.valid, max(ctx.row_cap, 1)
    )
    ctx.overflow.append(ov)
    valid = _residual_valid(l, r, keys, li, ri, valid)
    matched = torch.zeros(cap_l + 1, dtype=torch.bool, device=ctx.device)
    matched[torch.where(valid, li, cap_l)] = True
    return _Rows(l.dims, l.ids, l.valid & ~matched[:cap_l], l.cols)


def _project_rows(op: algebra.Project, child: _Rows, ctx: _Ctx) -> _Rows:
    cols = {c: child.cols[c] for c in op.columns if c in child.cols}
    keep = tuple(d for d in child.dims if d in op.columns)
    if len(keep) == len(child.dims):
        return _Rows(child.dims, child.ids, child.valid, cols)
    if cols:
        raise ExecutorError(
            f"rule {ctx.label or '?'}: projecting away grid dimensions "
            "under value columns requires a head aggregate"
        )
    # Dropping dims can alias rows: dedupe by sorting the projected codes
    # and keeping first occurrences (set semantics restored).
    kept_ids = _id_cols(child, keep)
    perm, skey, n_valid = sort_row_codes(_codes(kept_ids, ctx.n),
                                         child.valid)
    is_new, _ = unique_row_runs(skey, n_valid)
    return _Rows(keep, kept_ids[perm], is_new, {})


def _groupby_rows(op: algebra.GroupBy, child: _Rows, ctx: _Ctx) -> _Rows:
    n = ctx.n
    for k in op.keys:
        if k not in child.dims:
            raise ExecutorError(
                f"rule {ctx.label or '?'}: group key {k!r} must be a "
                "vertex-domain column"
            )
    monoid = _monoid_for(op.agg)
    if monoid.structured:
        raise ExecutorError(
            f"structured monoid {op.agg!r} needs width-typed payload slabs; "
            "the row-table backend aggregates scalar cells"
        )
    if monoid.finalize is not None:
        raise ExecutorError(
            f"monoid {op.agg!r} carries a finalize step; the row-table "
            "backend only supports plain accumulator monoids"
        )
    cells = float(n) ** len(child.dims)
    if 0 < cells <= _GROUPBY_GRID_CELLS:
        # Lower through the dense grid-reduce when the child's grid is
        # small: rows are unique-by-dims so the scatter is exact, and the
        # reduction then performs the same adds in the same order as the
        # dense engine, so forced-row runs match dense bit for bit.  Large
        # domains take the segmented path below.
        return _inter_to_rows(
            _groupby(op, _rows_to_inter(child, ctx), ctx), ctx
        )
    cap = child.ids.shape[0]
    vals = torch.as_tensor(_operand_rows(child, op.agg_col, ctx),
                           device=ctx.device).broadcast_to((cap,))
    if not vals.dtype.is_floating_point:
        vals = vals.to(torch.float32)
    key_ids = _id_cols(child, tuple(op.keys))
    perm, skey, n_valid = sort_row_codes(_codes(key_ids, n), child.valid)
    is_new, seg = unique_row_runs(skey, n_valid)
    in_valid = torch.arange(cap, dtype=torch.int32,
                            device=ctx.device) < n_valid
    # Pre-clustered segmented path: rows arrive sorted by group code, so
    # segment ids are sorted and the combine is one scan (the
    # segment-combine kernel on the card).  Only valid runs are read back
    # (``red[seg]`` under ``is_new``), so an empty segment's value, which
    # differs by path, never reaches an output.
    red = segment_combine_sorted(
        vals[perm], seg, cap, op.agg, edge_active=in_valid
    )
    return _Rows(
        tuple(op.keys), key_ids[perm], is_new, {op.out_col: red[seg]}
    )


def _eval(op: algebra.LogicalOp, ctx: _Ctx) -> _Inter:
    if ctx.shared and id(op) in ctx.shared:
        hit = ctx.memo.get(id(op))
        if hit is None:
            hit = _eval_inner(op, ctx)
            ctx.memo[id(op)] = hit
        return hit
    return _eval_inner(op, ctx)


def _eval_inner(op: algebra.LogicalOp, ctx: _Ctx):
    n = ctx.n
    shape_of = lambda dims: (n,) * len(dims)  # noqa: E731
    if isinstance(op, algebra.ScanEDB):
        if op.relation == "__unit__":
            return _Inter((), torch.tensor(True, device=ctx.device), {})
        rel = ctx.relations[op.relation]
        if op.relation in ctx.row_edb:
            tbl = ctx.row_edb[op.relation]
            dims = tuple(op.columns[p] for p in rel.key_positions)
            cols = {op.columns[int(p)]: g for p, g in tbl["values"].items()}
            return _Rows(dims, tbl["ids"], tbl["valid"], cols)
        if op.relation in ctx.chunked:
            raise ExecutorError(
                f"chunked EDB {op.relation!r} scanned outside a chunk "
                "overlay — out-of-core slabs stream through the host chunk "
                "loop only (fail closed)"
            )
        if isinstance(rel, RowRelation):
            raise ExecutorError(
                f"EDB {op.relation!r} is a RowRelation but was planned onto "
                "dense-grid storage (its grid is infeasible) — leave its "
                "storage selection to the planner"
            )
        return _scan_inter(op.columns, rel.key_positions, rel.present,
                           rel.values)
    if isinstance(op, algebra.Delta):
        entry = _read_pred(ctx, op.relation)
        keys, _ = ctx.sigs[op.relation]
        present = entry.get("delta", entry["present"])
        if "ids" in entry:
            return _scan_rows(op.columns, keys, entry["ids"], present,
                              entry["values"])
        return _scan_inter(op.columns, keys, present, entry["values"])
    if isinstance(op, (algebra.ScanState, algebra.ScanView, algebra.Frontier)):
        entry = _read_pred(ctx, op.relation)
        keys, _ = ctx.sigs[op.relation]
        if "ids" in entry:
            return _scan_rows(op.columns, keys, entry["ids"],
                              entry["present"], entry["values"])
        return _scan_inter(op.columns, keys, entry["present"],
                           entry["values"])
    if isinstance(op, (algebra.Join, algebra.Cross)):
        keys = op.keys if isinstance(op, algebra.Join) else ()
        l, r, rowmode = _coerce_pair(
            _eval(op.left, ctx), _eval(op.right, ctx), ctx
        )
        if rowmode:
            return _join_rows(l, r, keys, ctx)
        return _join(l, r, keys, ctx)
    if isinstance(op, algebra.AntiJoin):
        l, r, rowmode = _coerce_pair(
            _eval(op.left, ctx), _eval(op.right, ctx), ctx
        )
        if rowmode:
            return _antijoin_rows(l, r, op.keys, ctx)
        joined = _join(
            _Inter(l.dims, torch.ones_like(l.present), l.cols), r, op.keys,
            ctx,
        )
        extra = tuple(
            joined.dims.index(d) for d in joined.dims if d not in l.dims
        )
        match = torch.any(joined.present, dim=extra) if extra \
            else joined.present
        return _Inter(l.dims, l.present & ~match, l.cols)
    if isinstance(op, algebra.Select):
        child = _eval(op.child, ctx)
        if isinstance(child, _Rows):
            mask = _CMP[op.op](_operand_rows(child, op.lhs, ctx),
                               _operand_rows(child, op.rhs, ctx))
            return _Rows(child.dims, child.ids, child.valid & mask,
                         child.cols)
        lhs = _operand(child, op.lhs, ctx)
        rhs = _operand(child, op.rhs, ctx)
        mask = _CMP[op.op](lhs, rhs)
        return _Inter(child.dims, child.present & mask, child.cols)
    if isinstance(op, algebra.Project):
        child = _eval(op.child, ctx)
        if isinstance(child, _Rows):
            return _project_rows(op, child, ctx)
        cols = {c: child.cols[c] for c in op.columns if c in child.cols}
        keep = tuple(d for d in child.dims if d in op.columns)
        drop = tuple(child.dims.index(d) for d in child.dims if d not in keep)
        if drop and cols:
            raise ExecutorError(
                f"rule {ctx.label or '?'}: projecting away grid dimensions "
                "under value columns requires a head aggregate"
            )
        present = torch.any(child.present, dim=drop) if drop \
            else child.present
        if drop:
            cols = {}
        return _Inter(keep, present, cols)
    if isinstance(op, algebra.Extend):
        child = _eval(op.child, ctx)
        if not isinstance(op.value, (int, float, bool)):
            raise ExecutorError(
                f"non-numeric head constant {op.value!r} is not executable "
                "on the dense-grid backend"
            )
        cols = dict(child.cols)
        if isinstance(child, _Rows):
            cols[op.column] = torch.full(
                (child.ids.shape[0],), op.value, dtype=torch.float32,
                device=ctx.device,
            )
            return _Rows(child.dims, child.ids, child.valid, cols)
        cols[op.column] = torch.tensor(
            op.value, dtype=torch.float32, device=ctx.device,
        ).broadcast_to(shape_of(child.dims))
        return _Inter(child.dims, child.present, cols)
    if isinstance(op, algebra.Apply):
        child = _eval(op.child, ctx)
        udf = ctx.program.udfs.get(op.fn)
        if udf is None or udf.fn is None:
            raise ExecutorError(f"UDF {op.fn!r} has no bound implementation")
        rowmode = isinstance(child, _Rows)
        args = []
        for c in op.in_cols:
            if isinstance(c, str) and c.startswith("lit:"):
                args.append(ast.literal_eval(c[4:]))
            elif rowmode:
                args.append(_operand_rows(child, c, ctx))
            else:
                args.append(_operand(child, c, ctx))
        outs = udf.fn(*args)
        if not isinstance(outs, tuple):
            outs = (outs,)
        if len(outs) != len(op.out_cols):
            raise ExecutorError(
                f"UDF {op.fn!r} returned {len(outs)} outputs, rule binds "
                f"{len(op.out_cols)}"
            )
        shape = (child.ids.shape[0],) if rowmode else shape_of(child.dims)
        cols = dict(child.cols)
        for name, o in zip(op.out_cols, outs):
            cols[name] = torch.as_tensor(o, device=ctx.device).broadcast_to(
                shape)
        if rowmode:
            return _Rows(child.dims, child.ids, child.valid, cols)
        return _Inter(child.dims, child.present, cols)
    if isinstance(op, algebra.GroupBy):
        child = _eval(op.child, ctx)
        if isinstance(child, _Rows):
            return _groupby_rows(op, child, ctx)
        return _groupby(op, child, ctx)
    if isinstance(op, algebra.Unnest):
        raise ExecutorError(
            "set-valued unnesting (rule L8) is a Listing-1 construct: bind "
            "the vectorized VertexProgram front-end (compile_program with "
            "binding=) instead of the generic dense-grid backend"
        )
    raise ExecutorError(f"unsupported logical operator {type(op).__name__}")


def _groupby(op: algebra.GroupBy, child: _Inter, ctx: _Ctx) -> _Inter:
    n = ctx.n
    for k in op.keys:
        if k not in child.dims:
            raise ExecutorError(
                f"rule {ctx.label or '?'}: group key {k!r} must be a "
                "vertex-domain column"
            )
    monoid = _monoid_for(op.agg)
    if monoid.structured:
        raise ExecutorError(
            f"structured monoid {op.agg!r} needs width-typed payload slabs; "
            "the dense-grid backend aggregates scalar cells"
        )
    if monoid.finalize is not None:
        # Fail closed: the grid backend has no single finalize seam (rule
        # outputs for one target union-merge across rules), so a
        # finalize-bearing accumulator would leak unfinalized values.
        raise ExecutorError(
            f"monoid {op.agg!r} carries a finalize step; the dense-grid "
            "backend only supports plain accumulator monoids"
        )
    elim = tuple(d for d in child.dims if d not in op.keys)
    vals = _operand(child, op.agg_col, ctx)
    vals = torch.as_tensor(vals, device=ctx.device).broadcast_to(
        (n,) * len(child.dims))
    if not vals.dtype.is_floating_point:
        vals = vals.to(torch.float32)
    ident = torch.tensor(float(monoid.identity), dtype=vals.dtype,
                         device=ctx.device)
    masked = torch.where(child.present, vals, ident)
    perm = tuple(child.dims.index(k) for k in op.keys) + tuple(
        child.dims.index(e) for e in elim
    )
    m = masked.permute(perm)
    p = child.present.permute(perm)
    ax = tuple(range(len(op.keys), len(child.dims)))
    strategy = ctx.connectors.get(
        ctx.label, "dense-reduce" if monoid.kernel_op else "segment-scan"
    )
    if not ax:
        red = m
    elif strategy == "dense-reduce" and monoid.kernel_op is not None:
        red = _DENSE_REDUCE[monoid.kernel_op](m, dim=ax)
    else:
        segments = n ** len(op.keys)
        rows = m.numel() // max(segments, 1)
        ids = torch.repeat_interleave(
            torch.arange(segments, dtype=torch.int32, device=ctx.device),
            rows,
        )
        red = segment_combine_sorted(
            m.reshape(-1), ids, segments, op.agg,
        ).reshape((n,) * len(op.keys))
    pres = torch.any(p, dim=ax) if ax else p
    return _Inter(tuple(op.keys), pres, {op.out_col: red})


# ---------------------------------------------------------------------------
# Signature inference (key vs value columns per predicate)
# ---------------------------------------------------------------------------


class _Unresolved(Exception):
    pass


def _op_types(
    op: algebra.LogicalOp,
    sigs: Mapping[str, Tuple[Tuple[int, ...], Tuple[int, ...]]],
    relations: Mapping[str, Relation],
) -> Dict[str, str]:
    """Column name -> ``"k"`` (vertex-domain grid dim) or ``"v"`` (value)."""

    if isinstance(op, algebra.ScanEDB):
        if op.relation == "__unit__":
            return {}
        rel = relations.get(op.relation)
        if rel is None:
            raise ExecutorError(f"missing EDB relation {op.relation!r}")
        if rel.arity != len(op.columns):
            raise ExecutorError(
                f"EDB {op.relation!r}: relation has arity {rel.arity}, "
                f"program uses {len(op.columns)}"
            )
        return {
            c: ("k" if i in rel.key_positions else "v")
            for i, c in enumerate(op.columns)
        }
    if isinstance(op, (algebra.ScanState, algebra.ScanView,
                       algebra.Frontier, algebra.Delta)):
        sig = sigs.get(op.relation)
        if sig is None:
            raise _Unresolved(op.relation)
        keys, _ = sig
        return {
            c: ("k" if i in keys else "v") for i, c in enumerate(op.columns)
        }
    if isinstance(op, (algebra.Join, algebra.Cross)):
        lt = _op_types(op.left, sigs, relations)
        rt = _op_types(op.right, sigs, relations)
        out = dict(rt)
        out.update(lt)
        for c in set(lt) & set(rt):
            if lt[c] == "k" or rt[c] == "k":
                out[c] = "k"
        return out
    if isinstance(op, algebra.AntiJoin):
        # the right side must still be resolvable (raises _Unresolved)
        _op_types(op.right, sigs, relations)
        return _op_types(op.left, sigs, relations)
    if isinstance(op, algebra.Select):
        return _op_types(op.child, sigs, relations)
    if isinstance(op, algebra.Project):
        t = _op_types(op.child, sigs, relations)
        return {c: t[c] for c in op.columns if c in t}
    if isinstance(op, algebra.Extend):
        t = _op_types(op.child, sigs, relations)
        t[op.column] = "v"
        return t
    if isinstance(op, algebra.Apply):
        t = _op_types(op.child, sigs, relations)
        for c in op.out_cols:
            t[c] = "v"
        return t
    if isinstance(op, algebra.GroupBy):
        t = _op_types(op.child, sigs, relations)
        out = {k: t.get(k, "k") for k in op.keys}
        out[op.out_col] = "v"
        return out
    if isinstance(op, algebra.Unnest):
        raise ExecutorError(
            "set-valued unnesting is a Listing-1 construct (use the "
            "VertexProgram binding)"
        )
    raise ExecutorError(f"unsupported logical operator {type(op).__name__}")


def _infer_signatures(
    dataflows: Sequence[algebra.RuleDataflow],
    relations: Mapping[str, Relation],
) -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    sigs: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
    pending = list(dataflows)
    while pending:
        progress, deferred = False, []
        for df in pending:
            try:
                t = _op_types(df.op, sigs, relations)
            except _Unresolved:
                deferred.append(df)
                continue
            schema = df.op.schema()
            keys = tuple(
                i for i, c in enumerate(schema) if t.get(c) == "k"
            )
            vals = tuple(
                i for i in range(len(schema)) if i not in keys
            )
            sig = (keys, vals)
            old = sigs.get(df.target)
            if old is not None and old != sig:
                raise ExecutorError(
                    f"predicate {df.target!r}: rules disagree on its "
                    f"key/value signature ({old} vs {sig})"
                )
            sigs[df.target] = sig
            progress = True
        if not progress:
            missing = sorted({
                err_pred
                for df in deferred
                for err_pred in _unresolved_preds(df.op, sigs, relations)
            })
            raise ExecutorError(
                "cannot infer key/value signatures for predicates "
                f"{missing} — every recursive predicate needs an "
                "initialization rule grounding it from the EDB"
            )
        pending = deferred
    return sigs


def _unresolved_preds(op, sigs, relations):
    try:
        _op_types(op, sigs, relations)
        return []
    except _Unresolved as err:
        return [err.args[0]]
    except ExecutorError:
        return []


# ---------------------------------------------------------------------------
# Generic executable: phase-sequenced fixpoints over the grid backend
# ---------------------------------------------------------------------------


@dataclass
class _Phase:
    index: int                      # 1-based phase number
    carried: Tuple[str, ...]        # recursive predicates updated here
    init: Tuple[algebra.RuleDataflow, ...]
    body: Tuple[algebra.RuleDataflow, ...]
    # View rules nothing in the body reads (e.g. a frontier view consumed
    # only by post-stratum rules): evaluated once at the fixpoint, not per
    # iteration.
    finals: Tuple[algebra.RuleDataflow, ...]
    post: Tuple[algebra.RuleDataflow, ...]


def _referenced_preds(op: algebra.LogicalOp) -> set:
    preds = set()
    if isinstance(op, (algebra.ScanEDB, algebra.ScanState, algebra.ScanView,
                       algebra.Frontier, algebra.Delta)):
        preds.add(op.relation)
    for child in op.children():
        preds |= _referenced_preds(child)
    return preds


class _ShiftedInjector:
    """Adapter making a :class:`~repro_torch.ft.FailureInjector` count in
    *global* iterations across a multi-phase run (the driver hands it the
    phase-local index): crash-at-iteration-N then targets the same step the
    checkpoint numbering uses, so a chaos test can aim at a specific phase.
    """

    def __init__(self, inner: Any, base: int) -> None:
        self.inner, self.base = inner, base

    def maybe_fail(self, j: int) -> None:
        self.inner.maybe_fail(self.base + j)

    def maybe_fail_chunk(self, j: int, chunk: int) -> None:
        """Chunk-granular crash point of the out-of-core streaming loop
        (no-op for injectors without a chunk schedule)."""

        hook = getattr(self.inner, "maybe_fail_chunk", None)
        if hook is not None:
            hook(self.base + j, chunk)


class _ChunkStream:
    """One chunked EDB's host chunks, streamed through the device.

    On the card the chunks lie in pinned host memory (allocated once, at
    compile) and two device buffers of a chunk's shape take turns: while
    the compute stream fires the rules on one buffer, a side stream copies
    the next chunk into the other (``non_blocking``).  Two events per
    buffer are the whole guard: the compute stream waits on ``copied``
    before it reads a buffer, and a copy into a buffer waits on
    ``consumed``, recorded on the compute stream after the firing that read
    it.  The host never waits.  On the CPU the chunks are plain tensors and
    each is read in place."""

    def __init__(self, chunks: List[Dict[str, Any]],
                 device: torch.device) -> None:
        self.chunks = chunks
        self.device = device
        self._bufs: Optional[List[Dict[str, Any]]] = None

    def __len__(self) -> int:
        return len(self.chunks)

    def _issue(self, c: int) -> None:
        b = c % 2
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._consumed[b])
            for dst, src in zip(tree_leaves(self._bufs[b]),
                                tree_leaves(self.chunks[c])):
                dst.copy_(src, non_blocking=True)
            self._copied[b].record(self._copy_stream)

    def __iter__(self):
        """``(c, overlay)`` for every chunk in order; the overlay is valid
        on the current stream until the next item is asked for."""

        if self.device.type != "cuda":
            yield from enumerate(self.chunks)
            return
        if self._bufs is None:
            self._bufs = [
                tree_map(lambda t: torch.empty_like(t, device=self.device),
                         self.chunks[0])
                for _ in range(2)
            ]
            self._copy_stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._consumed = [torch.cuda.Event() for _ in range(2)]
        compute = torch.cuda.current_stream(self.device)
        self._issue(0)
        for c in range(len(self.chunks)):
            b = c % 2
            if c + 1 < len(self.chunks):
                self._issue(c + 1)
            compute.wait_event(self._copied[b])
            try:
                yield c, self._bufs[b]
            finally:
                self._consumed[b].record(compute)


@dataclass
class GenericExecutable:
    """A compiled generic program: logical plan + grid/row backend +
    drivers."""

    program: Program
    logical: algebra.LogicalPlan
    plan: Any                        # planner.ProgramPlan
    relations: Dict[str, Union[Relation, RowRelation]]
    sigs: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]
    phases: Tuple[_Phase, ...]
    prelude: Tuple[algebra.RuleDataflow, ...]
    domain: int
    device: torch.device
    semi_naive: bool = False
    merge_monoids: Dict[str, Optional[str]] = field(default_factory=dict)
    # Canonical shared-subtree ids from the rewrite pass (CSE): _eval
    # memoizes these nodes once per evaluation context.
    shared_ids: FrozenSet[int] = frozenset()
    # The compile options the lossless dense fallback recompiles with.
    _compile_kwargs: Dict[str, Any] = field(default_factory=dict, repr=False)
    # Physical storage per predicate ("dense-grid" / "row-table"), the
    # row-table slab capacities, the shared intermediate capacity, and the
    # row-table EDB slabs (planner storage selection).
    storage: Dict[str, str] = field(default_factory=dict)
    row_caps: Dict[str, int] = field(default_factory=dict)
    row_cap: int = 0
    row_edb: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # Out-of-core streaming: per-predicate host chunk lists (row slabs, all
    # chunks of a predicate identically shaped; pinned on the card) for EDB
    # scans whose slab exceeds the planner's memory budget, and the
    # double-buffered stream of each.
    chunked_edb: Dict[str, List[Dict[str, Any]]] = field(default_factory=dict)
    _streams: Dict[str, _ChunkStream] = field(default_factory=dict,
                                              repr=False)
    # The vmapped stages of run_batched, built once an executable.
    _step_cache: Dict[Any, Callable] = field(default_factory=dict,
                                             repr=False)

    # -- state plumbing -----------------------------------------------------

    @property
    def _any_row(self) -> bool:
        return any(s == "row-table" for s in self.storage.values())

    def _is_row(self, pred: str) -> bool:
        return self.storage.get(pred) == "row-table"

    def _empty_out(self, pred: str) -> Dict[str, Any]:
        keys, vals = self.sigs[pred]
        dev = self.device
        if self._is_row(pred):
            cap = self.row_caps[pred]
            return {
                "ids": torch.zeros((cap, len(keys)), dtype=torch.int32,
                                   device=dev),
                "present": torch.zeros(cap, dtype=torch.bool, device=dev),
                "values": {p: torch.zeros(cap, dtype=torch.float32,
                                          device=dev) for p in vals},
            }
        shape = (self.domain,) * len(keys)
        return {
            "present": torch.zeros(shape, dtype=torch.bool, device=dev),
            "values": {p: torch.zeros(shape, dtype=torch.float32,
                                      device=dev) for p in vals},
        }

    def _empty_entry(self, pred: str) -> Dict[str, Any]:
        entry = self._init_entry(self._empty_out(pred))
        entry["delta"] = torch.zeros_like(entry["present"])
        return entry

    def _init_entry(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Promote a materialized out into a carried entry: everything is
        new at J=0, so the delta mask starts as the presence mask.  With
        any row-table predicate, every carried entry also carries the
        overflow flag (ORed each step) so capacity flags always have a
        home, even when this predicate is dense in a mixed plan."""

        entry = dict(out)
        entry["delta"] = out["present"]
        if self._any_row:
            entry["overflow"] = torch.zeros((), dtype=torch.bool,
                                            device=self.device)
        return entry

    def _ctx(self, state, views, materialized, j, label="",
             relations=None) -> _Ctx:
        """A firing's context; ``relations`` overrides the EDB (a run's
        parameter bindings, :meth:`_bind_params`)."""

        return _Ctx(
            program=self.program,
            n=self.domain,
            device=self.device,
            sigs=self.sigs,
            relations=self.relations if relations is None else relations,
            state=state,
            views=views,
            materialized=materialized,
            connectors=self.plan.connectors,
            j=j,
            label=label,
            shared=self.shared_ids,
            row_cap=self.row_cap,
            row_edb=self.row_edb,
            chunked=frozenset(self.chunked_edb),
        )

    def _materialize(self, df, inter, ctx: _Ctx) -> Dict[str, Any]:
        """Lower a rule-body intermediate into the head predicate's storage
        (dense grid or row table), inserting the boundary converter when the
        body evaluated on the other representation.  Returns an *out* dict:
        ``{present, values}`` (dense) or ``{ids, present, values}`` (rows,
        ``present`` doubling as the slot validity mask)."""

        if self._is_row(df.target):
            rows = inter if isinstance(inter, _Rows) \
                else _inter_to_rows(inter, ctx)
            return self._materialize_rows(df, rows, ctx)
        if isinstance(inter, _Rows):
            inter = _rows_to_inter(inter, ctx)
        schema = df.op.schema()
        keys, vals = self.sigs[df.target]
        key_dims = tuple(schema[p] for p in keys)
        for d in key_dims:
            if d not in inter.dims:
                raise ExecutorError(
                    f"rule {df.label}: key column {d!r} of {df.target!r} is "
                    "not a grid dimension of the rule body"
                )
        perm = tuple(inter.dims.index(d) for d in key_dims)
        shape = (self.domain,) * len(key_dims)
        present = inter.present.permute(perm).broadcast_to(shape)
        values = {}
        for p in vals:
            col = schema[p]
            if col not in inter.cols:
                raise ExecutorError(
                    f"rule {df.label}: value column {col!r} missing"
                )
            g = inter.cols[col].permute(perm)
            values[p] = g.to(torch.float32).broadcast_to(shape)
        return {"present": present, "values": values}

    def _materialize_rows(self, df, rows: _Rows, ctx: _Ctx) -> Dict[str, Any]:
        schema = df.op.schema()
        keys, vals = self.sigs[df.target]
        key_dims = tuple(schema[p] for p in keys)
        for d in key_dims:
            if d not in rows.dims:
                raise ExecutorError(
                    f"rule {df.label}: key column {d!r} of {df.target!r} is "
                    "not a grid dimension of the rule body"
                )
        cap = rows.ids.shape[0]
        ids = _id_cols(rows, key_dims)
        values = {}
        for p in vals:
            col = schema[p]
            if col not in rows.cols:
                raise ExecutorError(
                    f"rule {df.label}: value column {col!r} missing"
                )
            values[p] = torch.as_tensor(
                rows.cols[col], device=self.device
            ).broadcast_to((cap,)).to(torch.float32)
        return self._resize_rows(
            {"ids": ids, "present": rows.valid, "values": values},
            self.row_caps[df.target], ctx,
        )

    def _resize_rows(self, out, new_cap: int, ctx: _Ctx) -> Dict[str, Any]:
        """Re-slab a row out to the predicate's capacity: pad when growing,
        compact (overflow-flagged) when shrinking."""

        cap = out["ids"].shape[0]
        if cap == new_cap:
            return out
        if cap < new_cap:
            pad = new_cap - cap
            return {
                "ids": torch.nn.functional.pad(out["ids"], (0, 0, 0, pad)),
                "present": torch.nn.functional.pad(out["present"], (0, pad)),
                "values": {
                    p: torch.nn.functional.pad(v, (0, pad))
                    for p, v in out["values"].items()
                },
            }
        idx, valid = compact_active_edges(out["present"], new_cap)
        ctx.overflow.append(
            out["present"].sum(dtype=torch.int64) > new_cap
        )
        take = torch.clamp(idx, max=cap - 1)
        return {
            "ids": out["ids"][take],
            "present": valid,
            "values": {p: v[take] for p, v in out["values"].items()},
        }

    def _merge(self, pred: str, outs, ctx: _Ctx) -> Dict[str, Any]:
        if not outs:
            return self._empty_out(pred)
        if self._is_row(pred):
            return self._merge_rows(pred, outs, ctx)
        present = functools.reduce(
            torch.logical_or, [o["present"] for o in outs]
        )
        _, vals = self.sigs[pred]
        if not vals:
            return {"present": present, "values": {}}
        agg = self.merge_monoids.get(pred)
        if agg is None:
            if len(outs) > 1:
                raise ExecutorError(
                    f"predicate {pred!r}: multiple rules derive value "
                    "columns without a combining head aggregate"
                )
            return {"present": present, "values": dict(outs[0]["values"])}
        monoid = _monoid_for(agg)
        ident = torch.tensor(float(monoid.identity), dtype=torch.float32,
                             device=self.device)
        values = {}
        for p in vals:
            parts = [
                torch.where(o["present"], o["values"][p], ident)
                for o in outs
            ]
            values[p] = functools.reduce(monoid.combine, parts)
        return {"present": present, "values": values}

    def _merge_rows(self, pred: str, outs, ctx: _Ctx) -> Dict[str, Any]:
        """Union-merge row outs: concatenate the slabs in rule order (which
        fixes the f32 sum order), dedupe by row code (representative-first),
        and fold duplicate values through the merge monoid, then re-slab to
        the predicate capacity."""

        if len(outs) == 1:
            return outs[0]
        _, vals = self.sigs[pred]
        agg = self.merge_monoids.get(pred)
        if vals and agg is None:
            raise ExecutorError(
                f"predicate {pred!r}: multiple rules derive value "
                "columns without a combining head aggregate"
            )
        ids = torch.cat([o["ids"] for o in outs], dim=0)
        valid = torch.cat([o["present"] for o in outs], dim=0)
        cap = ids.shape[0]
        perm, skey, n_valid = sort_row_codes(_codes(ids, self.domain), valid)
        is_new, seg = unique_row_runs(skey, n_valid)
        in_valid = torch.arange(cap, dtype=torch.int32,
                                device=self.device) < n_valid
        values = {}
        for p in vals:
            cat = torch.cat([o["values"][p] for o in outs], dim=0)
            red = segment_combine_sorted(
                cat[perm], seg, cap, agg, edge_active=in_valid
            )
            values[p] = red[seg]
        merged = {"ids": ids[perm], "present": is_new, "values": values}
        return self._resize_rows(merged, self.row_caps[pred], ctx)

    @staticmethod
    def _diff(old, present, values):
        diff = old["present"] != present
        both = old["present"] & present
        for p, v in values.items():
            diff = diff | (both & (old["values"][p] != v))
        return diff

    def _diff_rows(self, old, new):
        """Row-diff: ``(delta_mask_over_new, changed_scalar)``: a new row
        is delta when its key tuple is absent from the old table or any
        value column changed; ``changed`` also catches rows that
        disappeared (the presence-count check)."""

        operm, oskey, onv = sort_row_codes(_codes(old["ids"], self.domain),
                                           old["present"])
        new_codes = _codes(new["ids"], self.domain)
        pos = torch.searchsorted(oskey, new_codes, side="left")
        posc = torch.clamp(pos, max=oskey.shape[0] - 1)
        member = (pos < onv) & (oskey[posc] == new_codes)
        changed_val = torch.zeros_like(member)
        for p, v in new["values"].items():
            changed_val = changed_val | (old["values"][p][operm][posc] != v)
        delta = new["present"] & (~member | (member & changed_val))
        shrunk = old["present"].sum() != new["present"].sum()
        return delta, delta.any() | shrunk

    def _rows_to_relation(self, pred: str, entry) -> RowRelation:
        """Pack a row entry into a lex-sorted RowRelation (the same tuple
        order :meth:`Relation.tuples` produces), on the device."""

        keys, vals = self.sigs[pred]
        present = entry["present"]
        rows = entry["ids"][present]
        order = torch.argsort(_codes(rows, self.domain), stable=True)
        return RowRelation(
            n=self.domain,
            key_positions=keys,
            rows=rows[order],
            values={p: entry["values"][p][present][order] for p in vals},
        )

    # -- per-phase step -----------------------------------------------------

    def _apply_body(self, phase: _Phase, ctx: _Ctx, state, dataflows, acc,
                    of_extra: Optional[torch.Tensor] = None):
        """Fire a phase's body dataflows and seal the carried entries.
        ``acc`` pre-seeds per-target out lists (the chunked streaming loop
        passes its accumulated partials) and ``of_extra`` folds overflow
        flags raised outside this firing (per-chunk firings) into the
        carried overflow flags."""

        views = ctx.views
        for df in dataflows:
            ctx.label = df.label
            out = self._materialize(df, _eval(df.op, ctx), ctx)
            if df.next_state:
                acc.setdefault(df.target, []).append(out)
            elif df.target in views:
                views[df.target] = self._merge(
                    df.target, [views[df.target], out], ctx
                )
            else:
                views[df.target] = out
        new_state = dict(state)
        for pred in phase.carried:
            out = self._merge(pred, acc.get(pred, []), ctx)
            entry = dict(out)
            if self._is_row(pred):
                entry["delta"], _ = self._diff_rows(state[pred], out)
            else:
                entry["delta"] = out["present"] & self._diff(
                    state[pred], out["present"], out["values"]
                )
            if self._any_row:
                # Fold every capacity flag this step raised (the merges
                # above included) into the carried overflow flag.
                flags = ctx.overflow if of_extra is None \
                    else ctx.overflow + [of_extra]
                entry["overflow"] = functools.reduce(
                    torch.logical_or, flags, state[pred]["overflow"]
                )
            new_state[pred] = entry
        return new_state

    def _phase_step(self, phase: _Phase, materialized,
                    relations=None) -> Callable:
        def step(state, j):
            views: Dict[str, Dict[str, Any]] = {}
            ctx = self._ctx(state, views, materialized, j,
                            relations=relations)
            return self._apply_body(phase, ctx, state, phase.body, {})

        return step

    def _phase_converged(self, phase: _Phase) -> Callable:
        def conv(prev, new):
            same = torch.ones((), dtype=torch.bool, device=self.device)
            for pred in phase.carried:
                if self._is_row(pred):
                    _, changed = self._diff_rows(prev[pred], new[pred])
                    same = same & ~changed
                else:
                    diff = self._diff(
                        prev[pred], new[pred]["present"], new[pred]["values"]
                    )
                    same = same & ~torch.any(diff)
            return same

        return conv

    @staticmethod
    def _raise_on_overflow(flags) -> None:
        """Host-side overflow check: one read of the ORed flags."""

        if flags and bool(functools.reduce(torch.logical_or, flags)):
            raise _RowCapacityOverflow()

    def _run_rules_once(self, dataflows, state, materialized, j,
                        relations=None):
        """Fire a rule group once (init / final-view / post rules), merging
        multi-rule targets, and return {target: entry}.  Its capacity flags
        are read here, as the group's results are consumed at once."""

        acc: Dict[str, list] = {}
        order: List[str] = []
        views: Dict[str, Dict[str, Any]] = {}
        ctx = self._ctx(state, views, materialized, j, relations=relations)
        base_edb = ctx.row_edb
        for df in dataflows:
            ctx.label = df.label
            refs = self._chunk_refs(df)
            if refs:
                # Out-of-core scan in a once-fired rule group: copy the
                # chunks to the device one by one and fold the partials
                # through the merge monoid (chunk-count-invariant by monoid
                # associativity).
                pred = refs[0]
                outs = []
                for chunk in self.chunked_edb[pred]:
                    ctx.row_edb = dict(base_edb)
                    ctx.row_edb[pred] = self._put_chunk(chunk)
                    outs.append(
                        self._materialize(df, _eval(df.op, ctx), ctx)
                    )
                ctx.row_edb = base_edb
                out = self._merge(df.target, outs, ctx) \
                    if len(outs) > 1 else outs[0]
            else:
                out = self._materialize(df, _eval(df.op, ctx), ctx)
            if df.target not in acc:
                order.append(df.target)
            acc.setdefault(df.target, []).append(out)
            # make the target readable by later rules in this group
            views[df.target] = self._merge(df.target, acc[df.target], ctx)
        self._raise_on_overflow(ctx.overflow)
        return {t: views[t] for t in order}

    # -- out-of-core chunked streaming (host-resident EDB slabs) ------------

    def _chunk_refs(self, df) -> Tuple[str, ...]:
        """The chunked EDB predicates a dataflow's body scans (compile-time
        validation guarantees at most one)."""

        if not self.chunked_edb:
            return ()
        return tuple(sorted(
            _referenced_preds(df.op) & set(self.chunked_edb)
        ))

    def _put_chunk(self, chunk) -> Dict[str, Any]:
        """A device copy of one host chunk, as a row-EDB overlay table."""

        return tree_map(
            lambda t: t.to(self.device, non_blocking=True), chunk
        )

    def _chunk_fire_fn(self, pred: str, dfs, relations=None) -> Callable:
        """The firing of the body rules scanning one chunked predicate:
        ``fire(state, acc, materialized, overlay, j) -> (acc, overflow)``
        evaluates them against a chunk overlay and folds the outs into the
        running per-target accumulators through the merge monoids.  The
        overflow flag stays a device bool."""

        m = len(self.chunked_edb[pred])

        def fire(state, acc, materialized, overlay, j):
            ctx = self._ctx(state, {}, materialized, j, relations=relations)
            ctx.row_edb = dict(self.row_edb)
            ctx.row_edb[pred] = overlay
            # Chunk-proportional intermediates: the planner's join /
            # convert cap carries 4x headroom over the largest slab, and a
            # firing that scans 1/m of the chunked slab expects ~1/m of the
            # join pairs — so the per-chunk intermediate keeps the same
            # headroom at 1/m the sort/gather cost.  Skew beyond it trips
            # the usual lossless overflow path.
            if ctx.row_cap and m > 1:
                per = -(-ctx.row_cap // m)
                ctx.row_cap = max(256, 1 << max(per - 1, 0).bit_length())
            out_acc = dict(acc)
            for df in dfs:
                ctx.label = df.label
                out = self._materialize(df, _eval(df.op, ctx), ctx)
                out_acc[df.target] = self._merge(
                    df.target, [out_acc[df.target], out], ctx
                )
            of = functools.reduce(
                torch.logical_or, ctx.overflow,
                torch.zeros((), dtype=torch.bool, device=self.device),
            )
            return out_acc, of

        return fire

    def _chunk_finish_fn(self, phase: _Phase, plain_dfs, chunk_targets,
                         relations=None) -> Callable:
        """The tail of a chunked phase step: fires the non-chunked body
        rules and seals the carried entries, seeding the per-target
        accumulators with the streamed partials (and folding the chunk
        loop's overflow flags into the carried flags)."""

        def finish(state, acc, of_chunks, materialized, j):
            ctx = self._ctx(state, {}, materialized, j, relations=relations)
            accs = {t: [acc[t]] for t in chunk_targets}
            return self._apply_body(phase, ctx, state, plain_dfs, accs,
                                    of_chunks)

        return finish

    def _chunked_phase_step(self, phase: _Phase, materialized,
                            injector=None, relations=None) -> Callable:
        """The per-iteration step of a phase whose body scans chunked
        (out-of-core) EDB predicates: each such predicate's chunks stream
        through the ``fire`` stage (:class:`_ChunkStream`: the next chunk's
        copy overlaps this chunk's firing), then ``finish`` fires the
        remaining rules and seals the carried state.  Partial accumulators
        live only inside one step, so a mid-chunk crash
        (``injector.maybe_fail_chunk``) discards them and the driver's
        restore+replay recomputes the step from checkpointed state — chunk
        cursors never need checkpointing."""

        chunk_dfs: Dict[str, List] = {}
        for df in phase.body:
            refs = self._chunk_refs(df)
            if refs:
                chunk_dfs.setdefault(refs[0], []).append(df)
        plain = tuple(df for df in phase.body if not self._chunk_refs(df))
        targets = tuple(dict.fromkeys(
            df.target for dfs in chunk_dfs.values() for df in dfs
        ))
        fire_fns = {pred: self._chunk_fire_fn(pred, tuple(dfs), relations)
                    for pred, dfs in chunk_dfs.items()}
        finish = self._chunk_finish_fn(phase, plain, targets, relations)

        def step(state, j):
            acc = {t: self._empty_out(t) for t in targets}
            of = torch.zeros((), dtype=torch.bool, device=self.device)
            for pred, fire in fire_fns.items():
                for c, overlay in self._stream(pred):
                    if injector is not None:
                        injector.maybe_fail_chunk(j, c)
                    acc, ov = fire(state, acc, materialized, overlay, j)
                    of = of | ov
            return finish(state, acc, of, materialized, j)

        return step

    def _stream(self, pred: str) -> _ChunkStream:
        stream = self._streams.get(pred)
        if stream is None:
            stream = _ChunkStream(self.chunked_edb[pred], self.device)
            self._streams[pred] = stream
        return stream

    def _first_state(self, relations=None):
        """The carried state before any rule fires, and the prelude's
        materialized views."""

        state = {pred: self._empty_entry(pred)
                 for phase in self.phases for pred in phase.carried}
        return state, dict(self._run_rules_once(self.prelude, state, {}, 0,
                                                relations=relations))

    def phase_step_fn(self) -> Tuple[Callable, Dict[str, Dict[str, Any]]]:
        """Benchmark hook: the per-iteration step of the FIRST fixpoint
        phase plus its initialized state — one rule firing of the recursive
        stratum, the unit the drivers repeat."""

        if any(self._chunk_refs(df) for df in self.phases[0].body):
            raise ExecutorError(
                "phase_step_fn cannot time a chunked phase: the out-of-core "
                "chunk stream is a host loop, not one jitted step"
            )
        state, materialized = self._first_state()
        phase = self.phases[0]
        inits = self._run_rules_once(phase.init, state, materialized, 0)
        for pred in phase.carried:
            entry = inits.get(pred)
            if entry is not None:
                state[pred] = self._init_entry(entry)
        return self._phase_step(phase, materialized), state

    # -- durable checkpoints (fault tolerance) ------------------------------

    @staticmethod
    def _phase_views(phase: _Phase) -> Tuple[algebra.RuleDataflow, ...]:
        """The rules whose results a phase leaves in the materialized views:
        its body's view rules, its finals and its post-stratum rules."""

        return (tuple(df for df in phase.body if not df.next_state)
                + phase.finals + phase.post)

    def _mat_targets(self) -> Tuple[str, ...]:
        """Every predicate the run materializes outside the carried state,
        in a deterministic order — the checkpoint's ``mat`` leaves.  The set
        is a pure function of the compiled program, so the checkpoint tree
        structure is constant across phases (targets a resumed run has not
        reached yet are stored as zero grids and recomputed)."""

        order: List[str] = []
        for group in [self.prelude] + [self._phase_views(ph)
                                       for ph in self.phases]:
            for df in group:
                if df.target not in order:
                    order.append(df.target)
        return tuple(order)

    def _ckpt_tree(self, state, materialized) -> Dict[str, Any]:
        """The durable snapshot of an in-flight run: all carried state plus
        every materialized view (zero-padded for targets not yet computed),
        in the JAX package's checkpoint layout."""

        mat = {
            t: (
                dict(e, values=dict(e["values"]))
                if (e := materialized.get(t)) is not None
                else self._empty_out(t)
            )
            for t in self._mat_targets()
        }
        return {"state": {p: dict(e) for p, e in state.items()},
                "mat": mat}

    def _ckpt_like(self) -> Dict[str, Any]:
        """A zero template of :meth:`_ckpt_tree`'s structure on this
        executable's device (the ``like`` of a restore, which puts the
        restored leaves there)."""

        state = {
            pred: self._empty_entry(pred)
            for ph in self.phases for pred in ph.carried
        }
        return self._ckpt_tree(state, {})

    def remesh(self, mesh) -> "GenericExecutable":
        raise NotImplementedError(
            "remesh is not ported yet: ROADMAP A10 (multi-GPU)"
        )

    # -- parameterized query bindings (online serving) ----------------------

    def _param_grids(self, params) -> Dict[str, Dict[str, Any]]:
        """Validate a per-query parameter binding ``{name: Relation}`` and
        lower it to its grids on this executable's device.  Fail closed: a
        parameter may only rebind a dense EDB relation of the compiled
        program, on the same signature."""

        grids: Dict[str, Dict[str, Any]] = {}
        for name, rel in (params or {}).items():
            base = self.relations.get(name)
            if base is None:
                raise ExecutorError(
                    f"parameter {name!r} is not an EDB relation of the "
                    "compiled program"
                )
            if (isinstance(base, RowRelation) or isinstance(rel, RowRelation)
                    or name in self.row_edb or self._is_row(name)):
                raise ExecutorError(
                    f"parameter {name!r} is row-table-stored; parameterized "
                    "bindings need dense-grid storage (fail closed)"
                )
            if rel.n != self.domain:
                raise ExecutorError(
                    f"parameter {name!r}: domain {rel.n} != compiled "
                    f"domain {self.domain}"
                )
            if (tuple(rel.key_positions) != tuple(base.key_positions)
                    or set(rel.values) != set(base.values)):
                raise ExecutorError(
                    f"parameter {name!r} does not match the compiled "
                    "relation signature (key/value positions differ)"
                )
            grids[name] = {
                "present": rel.present.to(self.device),
                "values": {p: g.to(self.device)
                           for p, g in rel.values.items()},
            }
        return grids

    def _bind_params(self, grids) -> Optional[Dict[str, Relation]]:
        """An EDB view with the parameter grids swapped in (the shared
        graph relations stay the compile-time grids on the device)."""

        if not grids:
            return None
        rels = dict(self.relations)
        for name, entry in grids.items():
            rels[name] = Relation(
                n=self.domain,
                key_positions=self.relations[name].key_positions,
                present=entry["present"],
                values=dict(entry["values"]),
            )
        return rels

    def _batched_fn(self, kind: str, phase: Optional[_Phase] = None):
        """A stage of a batched run, vmapped over a leading query axis of
        (state, materialized, params) with the iteration ``j`` shared, and
        built once an executable: the prelude, a phase's init, its step,
        its finals and post rules, and its convergence test (every
        query's no-new-facts test)."""

        key = (kind, None if phase is None else phase.index)
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        vmap = torch.func.vmap
        if kind == "prelude":
            def one(params):
                return self._first_state(self._bind_params(params))

            fn = vmap(one)
        elif kind == "init":
            def one(state, mat, params, _phase=phase):
                inits = self._run_rules_once(
                    _phase.init, state, mat, 0,
                    relations=self._bind_params(params),
                )
                out = dict(state)
                for pred in _phase.carried:
                    entry = inits.get(pred)
                    if entry is not None:
                        out[pred] = self._init_entry(entry)
                return out

            fn = vmap(one)
        elif kind == "step":
            def one(state, mat, params, j, _phase=phase):
                return self._phase_step(
                    _phase, mat, self._bind_params(params)
                )(state, j)

            fn = vmap(one, in_dims=(0, 0, 0, None))
        elif kind == "finals":
            def one(state, mat, params, j, _phase=phase):
                rels = self._bind_params(params)
                m = dict(mat)
                m.update(self._run_rules_once(
                    tuple(df for df in _phase.body if not df.next_state)
                    + _phase.finals, state, m, j, relations=rels,
                ))
                m.update(self._run_rules_once(
                    _phase.post, state, m, j, relations=rels
                ))
                return m

            fn = vmap(one, in_dims=(0, 0, 0, None))
        elif kind == "conv":
            each = vmap(self._phase_converged(phase))

            def fn(prev, new, _each=each):
                return torch.all(_each(prev, new))
        else:
            raise ExecutorError(f"unknown batched stage {kind!r}")
        self._step_cache[key] = fn
        return fn

    def run_batched(
        self,
        param_sets,
        max_iters: int,
        on_device: bool = False,
    ) -> List[FixpointResult]:
        """Run k parameterized queries through ONE shared fixpoint.

        ``param_sets`` is a sequence of per-query bindings ``{name:
        Relation}``, every set binding the same parameter relations.  Each
        stage is vmapped over a leading query axis (:meth:`_batched_fn`);
        a phase iterates until *every* query's no-new-facts test holds
        (extra iterations leave a converged query where it is: a converged
        state is a fixed point of the step).  One result a query, each
        with the shared iteration count, ``converged`` and
        ``phase_iterations``; the answers are k sequential
        ``run(..., params=...)`` calls' up to the sum order of the segment
        combine at the batched width.

        Fail closed: batching needs all-dense storage (row-table slabs
        carry overflow flags the host reads, and chunked EDBs stream
        through a host loop); admission routes such plans to sequential
        dispatch (``repro_torch.core.planner.serving_admission``).
        """

        if not param_sets:
            raise ExecutorError("run_batched needs at least one param set")
        if self._any_row or self.row_edb or self.chunked_edb:
            raise ExecutorError(
                "query batching needs all-dense storage: row-table slabs "
                "carry capacity-overflow flags the vmapped fixpoint cannot "
                "check host-side, and chunked EDB streams need the host "
                "chunk loop (fail closed; dispatch sequentially)"
            )
        grids = [self._param_grids(ps) for ps in param_sets]
        names = set(grids[0])
        if any(set(g) != names for g in grids[1:]):
            raise ExecutorError(
                "every batched param set must bind the same relations"
            )
        if not names:
            raise ExecutorError(
                "run_batched needs parameterized bindings (identical "
                "queries batch trivially — dispatch one run instead)"
            )
        k = len(grids)
        stacked = tree_map(lambda *xs: torch.stack(xs), *grids)

        t0 = time.perf_counter()
        state_b, mat_b = self._batched_fn("prelude")(stacked)
        total, phase_iters, all_conv = 0, [], True
        for phase in self.phases:
            state_b = self._batched_fn("init", phase)(state_b, mat_b, stacked)
            bstep = self._batched_fn("step", phase)
            bconv = self._batched_fn("conv", phase)

            def body(s, j, _b=bstep, _m=mat_b):
                return _b(s, _m, stacked, j)

            if on_device:
                res = device_fixpoint(body, bconv, state_b, max_iters)
            else:
                res = HostFixpointDriver(
                    step=body, converged=bconv,
                    config=DriverConfig(max_iters=max_iters),
                ).run(state_b)
            state_b = res.state
            total += res.iterations
            phase_iters.append(res.iterations)
            all_conv = all_conv and res.converged
            mat_b = self._batched_fn("finals", phase)(
                state_b, mat_b, stacked, res.iterations
            )

        seconds = time.perf_counter() - t0
        entries = list(mat_b.items()) + [
            (p, state_b[p]) for ph in self.phases for p in ph.carried
        ]
        results: List[FixpointResult] = []
        for q in range(k):
            out: Dict[str, Any] = {}
            for pred, entry in entries:
                keys, _ = self.sigs[pred]
                out[pred] = Relation(
                    n=self.domain,
                    key_positions=keys,
                    present=entry["present"][q],
                    values={p: v[q] for p, v in entry["values"].items()},
                )
            results.append(FixpointResult(
                state=out,
                iterations=total,
                converged=all_conv,
                seconds=seconds,
                phase_iterations=tuple(phase_iters),
            ))
        return results

    # -- fixpoint entry point ----------------------------------------------

    def run(
        self,
        max_iters: int,
        on_device: bool = False,
        *,
        params: Optional[Mapping[str, Relation]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        injector: Optional[Any] = None,
        max_restarts: int = 3,
        keep_checkpoints: int = 3,
    ) -> FixpointResult:
        """Run every fixpoint phase in sequence to the no-new-facts
        fixpoint (``max_iters`` bounds each phase), under
        :func:`device_fixpoint` (``on_device=True``) or the host driver.

        Returns a :class:`FixpointResult` whose ``state`` maps every
        materialized predicate to its final :class:`Relation` (or
        :class:`RowRelation` for a row-table predicate).

        ``params`` rebinds dense EDB relations for THIS run only (online
        serving: per-query seed/source/target bindings), moved to this
        executable's device; the compiled plan is reused as it is.

        Fault tolerance (host driver only): ``checkpoint_dir`` plugs a
        :class:`~repro_torch.checkpoint.CheckpointStore` into the driver's
        save/restore hooks — carried state + materialized views are written
        host-side every ``checkpoint_every`` iterations (default 8) along
        with the phase cursor, so a crashed run restarts mid-phase and a
        ``resume=True`` run continues from disk without re-running completed
        phases.  ``injector`` threads a
        :class:`~repro_torch.ft.FailureInjector` into the step boundary
        (and, in a chunked phase, into the chunk stream).  Restored state
        lands on this executable's device.

        Overflow policy (lossless): when any row-table slab overflows its
        static capacity mid-run, the run is abandoned and run again on
        dense-grid storage (``storage_fallback=True`` on the result).  The
        flags stay on the device inside a phase and are read once after
        it, and once after each group of rules fired outside the loop.
        The fallback run does not checkpoint: its tree structure differs
        from the row run's.
        """

        relations = self._bind_params(self._param_grids(params))
        try:
            return self._run_phases(
                max_iters, on_device, relations=relations,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                injector=injector, max_restarts=max_restarts,
                keep_checkpoints=keep_checkpoints,
            )
        except _RowCapacityOverflow:
            return self._dense_fallback_run(max_iters, on_device, params)

    def _dense_fallback_run(
        self, max_iters: int, on_device: bool,
        params: Optional[Mapping[str, Relation]] = None,
    ) -> FixpointResult:
        for name, rel in self.relations.items():
            if isinstance(rel, RowRelation):
                raise ExecutorError(
                    f"row-table capacity overflow, and EDB {name!r} is a "
                    "RowRelation whose dense grid is infeasible — raise "
                    "compile_program(row_cap=) instead"
                )
        dense = compile_program(
            self.program, self.relations, semi_naive=self.semi_naive,
            domain=self.domain, storage="dense-grid", device=self.device,
            **self._compile_kwargs,
        )
        res = dense.run(max_iters, on_device, params=params)
        return replace(res, storage_fallback=True)

    def _run_phases(
        self,
        max_iters: int,
        on_device: bool,
        *,
        relations: Optional[Dict[str, Relation]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        injector: Optional[Any] = None,
        max_restarts: int = 3,
        keep_checkpoints: int = 3,
    ) -> FixpointResult:
        if (checkpoint_dir or injector) and on_device:
            raise ExecutorError(
                "fault tolerance (checkpoint_dir/injector) needs the host "
                "driver: pass on_device=False"
            )
        if resume and not checkpoint_dir:
            raise ExecutorError("resume=True needs checkpoint_dir=")
        store = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointStore, latest_step

            store = CheckpointStore(checkpoint_dir, keep=keep_checkpoints)
            if checkpoint_every <= 0:
                checkpoint_every = 8

        t0 = time.perf_counter()
        state, materialized = self._first_state(relations)

        # Resume cursor: phase to continue in (1-based), iteration within it
        # (checkpoints are written post-init, so a restored state never needs
        # the init stratum re-fired), and completed phases' iteration counts.
        start_phase, start_iter = 1, 0
        done_iters: List[int] = []
        restored_from_disk = False
        if store is not None and resume and \
                latest_step(checkpoint_dir) is not None:
            restored_from_disk = True
            tree, _, extra = store.restore(self._ckpt_like())
            state = tree["state"]
            start_phase = int(extra.get("phase", 1))
            start_iter = int(extra.get("iteration", 0))
            done_iters = [int(x) for x in extra.get("phase_iterations", [])]
            # Materialized views of completed phases come from the
            # checkpoint (their fixpoints are sealed); the current and later
            # phases recompute theirs.
            for ph in self.phases[: start_phase - 1]:
                for df in self._phase_views(ph):
                    materialized[df.target] = tree["mat"][df.target]

        total = sum(done_iters)
        phase_iters, all_conv = list(done_iters), True
        restarts = stragglers = 0
        for phase in self.phases:
            k = phase.index
            if k < start_phase:
                continue
            resumed = restored_from_disk and k == start_phase
            if not resumed:
                inits = self._run_rules_once(phase.init, state,
                                             materialized, 0,
                                             relations=relations)
                for pred in phase.carried:
                    entry = inits.get(pred)
                    if entry is not None:
                        state[pred] = self._init_entry(entry)
            chunked_phase = any(self._chunk_refs(df) for df in phase.body)
            conv = self._phase_converged(phase)
            if on_device:
                if chunked_phase:
                    raise ExecutorError(
                        "chunked streaming needs the host driver: the chunk "
                        "loop issues host-to-device transfers inside every "
                        "iteration (pass on_device=False)"
                    )
                res = device_fixpoint(
                    self._phase_step(phase, materialized, relations),
                    conv, state, max_iters)
            else:
                shifted = None if injector is None \
                    else _ShiftedInjector(injector, total)
                if chunked_phase:
                    step = self._chunked_phase_step(
                        phase, materialized, injector=shifted,
                        relations=relations)
                else:
                    step = self._phase_step(phase, materialized, relations)
                save_hook = restore_hook = None
                if store is not None:
                    base = total  # global step counter offset for this phase
                    completed = list(phase_iters)

                    def save_hook(s, jj, _k=k, _b=base, _c=completed):
                        # "chunk" is the out-of-core stream cursor: chunk
                        # partials live only inside one step (never
                        # checkpointed), so a restored step always replays
                        # its chunk stream from 0.
                        store.save(
                            _b + jj, self._ckpt_tree(s, materialized),
                            extra={"phase": _k, "iteration": jj,
                                   "phase_iterations": _c, "chunk": 0},
                        )

                    def restore_hook(_k=k):
                        tr, _, ex = store.restore(self._ckpt_like())
                        if int(ex.get("phase", -1)) != _k:
                            raise RuntimeError(
                                f"latest checkpoint belongs to phase "
                                f"{ex.get('phase')}; cannot rewind into "
                                f"phase {_k} mid-driver"
                            )
                        return tr["state"], int(ex.get("iteration", 0))

                    # Phase-entry restore point (post-init, iteration 0):
                    # the current phase always has a checkpoint a mid-phase
                    # crash can rewind to.
                    if not resumed:
                        save_hook(state, 0)
                driver = HostFixpointDriver(
                    step=step,
                    converged=conv,
                    config=DriverConfig(
                        max_iters=max_iters,
                        checkpoint_every=checkpoint_every if store else 0,
                        max_restarts=max_restarts,
                    ),
                    save=save_hook,
                    restore=restore_hook,
                    injector=shifted,
                )
                try:
                    res = driver.run(
                        state, start_iter=start_iter if resumed else 0
                    )
                except BaseException:
                    # The failure is already propagating: drain the async
                    # writer so it cannot race a successor run (or resume)
                    # over the same checkpoint directory.
                    if store is not None:
                        store.quiesce()
                    raise
                restarts += res.restarts
                stragglers += res.straggler_events
            state = res.state
            # Lossless overflow policy: any capacity flag raised inside the
            # fixpoint surfaces here, before the phase's results are used.
            if self._any_row:
                self._raise_on_overflow(
                    [state[pred]["overflow"] for pred in phase.carried]
                )
            it = (start_iter if resumed else 0) + res.iterations
            total += res.iterations
            phase_iters.append(it)
            all_conv = all_conv and res.converged
            # Final views of this phase (frontier reads at the fixpoint),
            # then the post-stratum rules gated on its convergence.
            materialized.update(self._run_rules_once(
                tuple(df for df in phase.body if not df.next_state)
                + phase.finals,
                state, materialized, it, relations=relations,
            ))
            materialized.update(self._run_rules_once(
                phase.post, state, materialized, it, relations=relations,
            ))
        if store is not None:
            store.wait()  # surface any pending async-save failure

        out: Dict[str, Union[Relation, RowRelation]] = {}
        for pred, entry in list(materialized.items()) + [
            (p, state[p]) for ph in self.phases for p in ph.carried
        ]:
            keys, _ = self.sigs[pred]
            if self._is_row(pred):
                out[pred] = self._rows_to_relation(pred, entry)
            else:
                out[pred] = Relation(
                    n=self.domain,
                    key_positions=keys,
                    present=entry["present"],
                    values=dict(entry["values"]),
                )
        return FixpointResult(
            state=out,
            iterations=total,
            converged=all_conv,
            seconds=time.perf_counter() - t0,
            restarts=restarts,
            phase_iterations=tuple(phase_iters),
            straggler_events=stragglers,
        )


# ---------------------------------------------------------------------------
# compile_program — the unified entry point
# ---------------------------------------------------------------------------


def _listing_shape(program: Program) -> Optional[str]:
    labels = tuple(r.label for r in program.rules)
    if program.name == "pregel" and labels == (
        "L1", "L2", "L3", "L4", "L5", "L6", "L7", "L8"
    ):
        return "pregel"
    if program.name == "imru" and labels == ("G1", "G2", "G3"):
        return "imru"
    return None


def compile_program(
    program: Program,
    relations: Mapping[str, Any],
    *,
    mesh: Any = None,
    binding: Any = None,
    semi_naive: bool = False,
    domain: Optional[int] = None,
    hw: HardwareSpec = TPU_V5E,
    force_connector: Optional[str] = None,
    rewrite: bool = False,
    storage: Any = None,
    row_cap: Optional[int] = None,
    exchange: Any = None,
    hbm_budget: Optional[int] = None,
    chunks: Any = None,
    device: Optional[Union[str, torch.device]] = None,
    **frontend_kwargs,
):
    """Compile ANY XY-stratified program onto the unified executor, on
    ``device`` (default: the card; with none present this raises).

    ``relations`` binds the EDB: for generic programs, dense-grid
    :class:`Relation` or :class:`RowRelation` instances on ``device`` (or
    raw int tuple arrays with ``domain=``); for the paper's listings, the
    front-end physical inputs (Listing 1: ``{"data": Graph}``; Listing 2:
    ``{"training_data": records}``) with ``binding`` the vectorized UDF
    bundle (:class:`~repro_torch.core.pregel.VertexProgram` or
    :class:`~repro_torch.core.imru.IMRUTask`), which go to
    ``compile_pregel`` / ``compile_imru``.  Everything else runs on the
    grid/row interpreter with sequential fixpoint phases.

    ``rewrite=True`` runs the :mod:`repro_torch.core.rewrite` optimizer
    pass (join reordering, select pushdown, cross-rule CSE) over the
    logical plan; its decisions are recorded in ``plan.notes``.

    ``storage=`` overrides the planner's per-predicate physical storage
    selection: a string (``"dense-grid"`` / ``"row-table"``) forces every
    predicate, a mapping forces individual predicates (the rest stay
    cost-selected).  Predicates bound to a :class:`RowRelation` EDB are
    always row-table (their dense grid is infeasible); raw arrays whose
    grid would pass ``2^24`` cells become one.  ``row_cap=`` pins the
    row-table intermediate slab capacity.  The selection is recorded in
    ``plan.notes`` as the ``storage-selection(...)`` entry, as the
    reference's.

    Out of core: ``chunks=`` (a count for every row-table EDB, or a
    mapping ``{pred: m}``) splits an EDB's row slab into ``m`` identically
    shaped host chunks that every iteration streams through the device
    (pinned host memory and two device buffers on the card, see
    :class:`_ChunkStream`); ``hbm_budget=`` (bytes) lets the planner split
    every row-table EDB slab larger than it (default: half the spec's
    memory).  The split is recorded as the ``chunking(...)`` note, and
    :func:`_check_chunk_soundness` refuses a program whose rules do not
    decompose over chunks.  A chunked EDB's :class:`RowRelation` may lie on
    the CPU when the executable is on the card: its rows never need to be
    on the device at once.  ``mesh=`` and ``exchange=`` raise (A10).
    """

    if mesh is not None or exchange is not None:
        raise NotImplementedError(
            "mesh= and exchange= are not ported yet: ROADMAP A10 (multi-GPU)"
        )
    shape = _listing_shape(program)
    if shape == "pregel" and binding is not None:
        from repro_torch.core.pregel import compile_pregel

        return compile_pregel(
            binding, relations["data"], semi_naive=semi_naive,
            force_connector=force_connector, hw=hw, device=device,
            **frontend_kwargs,
        )
    if shape == "imru" and binding is not None:
        from repro_torch.core.imru import compile_imru

        return compile_imru(
            binding, relations["training_data"], hw=hw, device=device,
            **frontend_kwargs,
        )
    if shape is not None:
        raise ExecutorError(
            f"Listing program {program.name!r} needs its vectorized "
            "front-end binding (binding=VertexProgram(...) or "
            "binding=IMRUTask(...)): its set-valued message slabs have no "
            "dense-grid encoding"
        )
    device = resolve_device(device)

    program.validate()
    schedule = stratify.iteration_schedule(program)
    logical = algebra.translate(program)
    sn_notes: Tuple[str, ...] = ()
    if semi_naive:
        logical, sn_notes = algebra.semi_naive_rewrite(logical, program)

    rels: Dict[str, Union[Relation, RowRelation]] = {}
    # RowRelations left on the CPU for a card executable: allowed only for
    # the EDBs the plan streams in chunks (checked once the plan is made).
    host_rows: Dict[str, torch.device] = {}
    for name, value in relations.items():
        rel = _as_relation(name, value, domain, device)
        lead = rel.rows if isinstance(rel, RowRelation) else rel.present
        for t in [lead] + list(rel.values.values()):
            if t.device.type == device.type:
                continue
            if isinstance(rel, RowRelation) and t.device.type == "cpu":
                host_rows[name] = t.device
                continue
            _wrong_device(name, t.device, device)
        rels[name] = rel
    if domain is None:
        domains = {r.n for r in rels.values()}
        if len(domains) != 1:
            raise ExecutorError(
                "pass domain= (EDB relations disagree on the vertex domain)"
            )
        domain = domains.pop()
    for name in program.edb:
        if name not in rels:
            raise ExecutorError(f"missing EDB relation {name!r}")

    # Rewrite-rule optimizer pass (join reorder, select pushdown, CSE) —
    # runs on the logical DAG before signatures/phases/planning so the
    # rewritten operator trees are what the interpreter executes.
    rw_notes: Tuple[str, ...] = ()
    shared_ids: FrozenSet[int] = frozenset()
    if rewrite:
        from repro_torch.core.rewrite import rewrite_plan

        rewritten = rewrite_plan(logical, program, rels, domain)
        logical = rewritten.plan
        rw_notes = rewritten.notes
        shared_ids = rewritten.shared_ids

    sigs = _infer_signatures(
        tuple(logical.init) + tuple(logical.body), rels
    )

    # Sequential fixpoint phases: recursive SCCs in topological order; every
    # other rule is scheduled around them by the deepest phase it reads.
    phase_groups = stratify.fixpoint_phases(program)
    pred_phase: Dict[str, int] = {}
    for i, group in enumerate(phase_groups):
        for p in group:
            pred_phase[p] = i + 1

    def deepest_read(rule) -> int:
        dep = 0
        for lit in rule.body:
            atom = getattr(lit, "atom", lit)
            pred = getattr(atom, "pred", None)
            if pred is not None:
                dep = max(dep, pred_phase.get(pred, 0))
        return dep

    changed = True
    while changed:
        changed = False
        for rule in program.rules:
            head = rule.head.pred
            if any(head in g for g in phase_groups):
                continue  # recursive predicates keep their SCC phase
            dep = deepest_read(rule)
            if pred_phase.get(head, -1) < dep:
                pred_phase[head] = dep
                changed = True

    init_dfs = list(logical.init)
    body_dfs = list(logical.body)
    carried_set = set(schedule.carried)

    prelude: List[algebra.RuleDataflow] = []
    phase_init: Dict[int, List] = {}
    phase_body: Dict[int, List] = {}
    phase_post: Dict[int, List] = {}
    # translate() emits one dataflow per schedule rule, in order — zip
    # positionally (labels may repeat or be empty).
    for df, rule in zip(init_dfs, schedule.init_rules):
        dep = deepest_read(rule)
        if df.target in carried_set:
            k = pred_phase[df.target]
            if dep >= k:
                raise ExecutorError(
                    f"rule {df.label}: initialization of phase-{k} "
                    f"predicate {df.target!r} reads a phase-{dep} result"
                )
            phase_init.setdefault(k, []).append(df)
        elif dep == 0:
            prelude.append(df)
        else:
            phase_post.setdefault(dep, []).append(df)
    for df in body_dfs:
        k = pred_phase.get(df.target)
        if k is None or k == 0:
            raise ExecutorError(
                f"per-iteration rule {df.label} targets non-recursive "
                f"predicate {df.target!r}"
            )
        phase_body.setdefault(k, []).append(df)

    phases: List[_Phase] = []
    for i, group in enumerate(phase_groups):
        k = i + 1
        body = list(phase_body.get(k, ()))
        # Views nothing in this phase's body reads run once at the
        # fixpoint instead of every iteration (e.g. P4's rankF frontier
        # view, consumed only by the post-stratum threshold rule).
        reads = set()
        for df in body:
            reads |= _referenced_preds(df.op)
        phases.append(_Phase(
            index=k,
            carried=tuple(sorted(group)),
            init=tuple(phase_init.get(k, ())),
            body=tuple(df for df in body
                       if df.next_state or df.target in reads),
            finals=tuple(df for df in body
                         if not df.next_state and df.target not in reads),
            post=tuple(phase_post.get(k, ())),
        ))

    # Merge monoids: the combining aggregate for targets derived by
    # several rules (union semantics resolved through the monoid registry).
    merge_monoids: Dict[str, Optional[str]] = {}
    for rule in program.rules:
        aggs = rule.head_aggregates()
        if not aggs:
            continue
        name = aggs[0].agg
        prev = merge_monoids.get(rule.head.pred)
        if prev is not None and prev != name:
            raise ExecutorError(
                f"predicate {rule.head.pred!r} is aggregated with both "
                f"{prev!r} and {name!r}"
            )
        merge_monoids[rule.head.pred] = name

    # GroupBy sites for the planner's connector selection.
    specs: List[GroupBySpec] = []
    for df in init_dfs + body_dfs:
        specs.extend(_collect_groupbys(df, sigs, rels, domain))

    # Storage selection inputs: (key arity, estimated row count) for every
    # predicate — EDB counts are exact, derived predicates come from the
    # optimizer's iterated cardinality model.
    from repro_torch.core.rewrite import estimate_program_cardinalities

    ests = estimate_program_cardinalities(
        tuple(logical.init) + tuple(logical.body), rels, domain
    )
    predicates: Dict[str, Tuple[int, float]] = {}
    for name, rel in rels.items():
        predicates[name] = (len(rel.key_positions), float(rel.count()))
    for pred, (keys_pos, _) in sigs.items():
        predicates[pred] = (
            len(keys_pos),
            float(ests.get(pred, float(domain) ** len(keys_pos))),
        )
    forced: Dict[str, str] = {}
    if isinstance(storage, str):
        forced = {p: storage for p in predicates}
    elif storage:
        forced = dict(storage)
    for name, rel in rels.items():
        if isinstance(rel, RowRelation):
            if forced.get(name, "row-table") != "row-table":
                raise ExecutorError(
                    f"EDB {name!r} is a RowRelation: its dense grid is "
                    "infeasible, storage cannot be forced to dense-grid"
                )
            forced[name] = "row-table"

    exchange_ops: Dict[str, Optional[str]] = {}
    for pred, agg in merge_monoids.items():
        if agg is not None:
            try:
                exchange_ops[pred] = get_monoid(agg).kernel_op
            except MonoidError:
                exchange_ops[pred] = None

    plan = plan_program(
        tuple(tuple(sorted(g)) for g in phase_groups),
        tuple(specs), domain, MeshSpec((("data", 1),)), hw,
        semi_naive=semi_naive, extra_notes=sn_notes + rw_notes,
        predicates=predicates, storage=forced or None, row_cap=row_cap,
        exchange_ops=exchange_ops,
        edb=tuple(sorted(rels)),
        hbm_budget=hbm_budget, chunks=chunks,
        row_value_cols={
            name: len(rel.values) for name, rel in rels.items()
        },
    )
    for name, where in host_rows.items():
        if int(plan.chunks.get(name, 0)) <= 1:
            _wrong_device(name, where, device)
    ex = GenericExecutable(
        program=program,
        logical=logical,
        plan=plan,
        relations=rels,
        sigs=sigs,
        phases=tuple(phases),
        prelude=tuple(prelude),
        domain=domain,
        device=device,
        semi_naive=semi_naive,
        merge_monoids=merge_monoids,
        shared_ids=shared_ids,
        _compile_kwargs={"hw": hw, "force_connector": force_connector,
                         "rewrite": rewrite},
        storage=dict(plan.storage),
        row_caps=dict(plan.row_caps),
        row_cap=plan.row_cap,
    )
    # Row-table EDB slabs (loop-invariant caching, sparse storage): the
    # tuples compacted once, padded to the planned capacity, on the device.
    for name, rel in rels.items():
        if plan.storage.get(name) != "row-table":
            continue
        cap = plan.row_caps[name]
        if isinstance(rel, RowRelation):
            rows, raw_vals = rel.rows, rel.values
        else:
            rows = torch.nonzero(rel.present).to(torch.int32)
            raw_vals = {p: g[tuple(rows.long().T)]
                        for p, g in rel.values.items()}
        count = rows.shape[0]
        m = int(plan.chunks.get(name, 0))
        if m > 1:
            ex.chunked_edb[name] = _host_chunks(rows, raw_vals, m, device)
            continue
        if count > cap:
            raise ExecutorError(
                f"EDB {name!r}: {count} rows exceed its row-table "
                f"capacity {cap}"
            )
        ids = torch.zeros((cap, len(rel.key_positions)), dtype=torch.int32,
                          device=device)
        ids[:count] = rows
        valid = torch.zeros(cap, dtype=torch.bool, device=device)
        valid[:count] = True
        values = {}
        for p, v in raw_vals.items():
            col = torch.zeros(cap, dtype=torch.float32, device=device)
            col[:count] = v
            values[p] = col
        ex.row_edb[name] = {"ids": ids, "valid": valid, "values": values}
    if ex.chunked_edb:
        _check_chunk_soundness(ex)
    return ex


def _wrong_device(name: str, where, device: torch.device) -> None:
    raise ValueError(
        f"relation {name!r} lies on {where}, compile_program was asked for "
        f"{device}: build it there (Relation.from_columns(..., device=) or "
        "repro_torch.carry.relation_from_numpy)"
    )


def _host_chunks(rows: torch.Tensor, raw_vals, m: int,
                 device: torch.device) -> List[Dict[str, Any]]:
    """An EDB's row slab split into ``m`` identically shaped host chunks
    (``ceil(count / m)`` rows each, padded to a power of two; the last may
    hold fewer valid rows): int32 ids, a validity mask and float32 value
    columns, in pinned memory when ``device`` is the card, allocated once."""

    rows = rows.cpu()
    vals = {p: v.cpu() for p, v in raw_vals.items()}
    count, k = rows.shape[0], rows.shape[1]
    per = max(-(-count // m), 1)
    ccap = 1 << max(per - 1, 0).bit_length()
    pin = device.type == "cuda"
    chunks: List[Dict[str, Any]] = []
    for c in range(m):
        lo, hi = min(c * per, count), min((c + 1) * per, count)
        ids = torch.zeros((ccap, k), dtype=torch.int32, pin_memory=pin)
        ids[:hi - lo] = rows[lo:hi]
        valid = torch.zeros(ccap, dtype=torch.bool, pin_memory=pin)
        valid[:hi - lo] = True
        values = {}
        for p, v in vals.items():
            col = torch.zeros(ccap, dtype=torch.float32, pin_memory=pin)
            col[:hi - lo] = v[lo:hi]
            values[p] = col
        chunks.append({"ids": ids, "valid": valid, "values": values})
    return chunks


def _check_chunk_soundness(ex: GenericExecutable) -> None:
    """Fail-closed validation that streaming a predicate's chunks through
    the fixpoint is chunk-count-invariant: a rule scanning a chunked EDB
    fires once per chunk and its partial outs fold through the
    CombineMonoid registry, which is only sound when the rule decomposes
    over a disjoint union of those scan rows."""

    chunked = set(ex.chunked_edb)
    body_views = {
        ph.index: {df.target for df in ph.body if not df.next_state}
        for ph in ex.phases
    }

    def check_df(df, phase: Optional[_Phase] = None,
                 is_body: bool = False) -> None:
        refs = _referenced_preds(df.op) & chunked
        if not refs:
            return
        if len(refs) > 1:
            raise ExecutorError(
                f"rule {df.label}: scans {len(refs)} chunked EDBs "
                f"({', '.join(sorted(refs))}) — the streaming loop "
                "decomposes one chunked scan per rule (fail closed)"
            )
        pred = next(iter(refs))
        if is_body and not df.next_state:
            raise ExecutorError(
                f"rule {df.label}: per-iteration view rule scans chunked "
                f"EDB {pred!r} — only carried-state rules stream through "
                "the chunk loop (fail closed)"
            )
        if is_body and phase is not None:
            read_views = _referenced_preds(df.op) & body_views[phase.index]
            if read_views:
                raise ExecutorError(
                    f"rule {df.label}: chunked rule reads same-phase view "
                    f"{sorted(read_views)[0]!r}, which the streaming loop "
                    "fires after the chunk partials (fail closed)"
                )

        def no_anti(op) -> None:
            if isinstance(op, algebra.AntiJoin) and (
                _referenced_preds(op.right) & chunked
            ):
                raise ExecutorError(
                    f"rule {df.label}: chunked EDB {pred!r} on the negated "
                    "side of an AntiJoin — set difference against a "
                    "partial chunk is not chunk-invariant (fail closed)"
                )
            for child in op.children():
                no_anti(child)

        def check_gb(op, root: bool) -> None:
            if isinstance(op, algebra.GroupBy) and (
                _referenced_preds(op) & chunked
            ):
                if not root or ex.merge_monoids.get(df.target) != op.agg:
                    raise ExecutorError(
                        f"rule {df.label}: aggregation over chunked EDB "
                        f"{pred!r} must be the rule's head aggregate (its "
                        "per-chunk partials fold through the head monoid; "
                        "fail closed)"
                    )
            for child in op.children():
                check_gb(child, False)

        no_anti(df.op)
        check_gb(df.op, True)
        _, vals = ex.sigs[df.target]
        if vals and ex.merge_monoids.get(df.target) is None:
            raise ExecutorError(
                f"rule {df.label}: target {df.target!r} carries value "
                f"columns but no merge monoid — per-chunk partials from "
                f"chunked EDB {pred!r} cannot combine (fail closed)"
            )

    for df in ex.prelude:
        check_df(df)
    for ph in ex.phases:
        for df in ph.init + ph.finals + ph.post:
            check_df(df, phase=ph)
        for df in ph.body:
            check_df(df, phase=ph, is_body=True)


def _collect_groupbys(df, sigs, relations, domain) -> List[GroupBySpec]:
    found: List[GroupBySpec] = []

    def walk(op):
        for child in op.children():
            walk(child)
        if isinstance(op, algebra.GroupBy):
            try:
                t = _op_types(op.child, sigs, relations)
            except (_Unresolved, ExecutorError):
                return
            n_dims = sum(1 for v in t.values() if v == "k")
            monoid = _monoid_for(op.agg)
            found.append(GroupBySpec(
                label=df.label,
                agg=op.agg,
                rows=int(domain ** n_dims),
                segments=int(domain ** len(op.keys)),
                kernel_op=monoid.kernel_op,
            ))

    walk(df.op)
    return found


# ---------------------------------------------------------------------------
# Listing fast paths: the Pregel superstep builders
# ---------------------------------------------------------------------------


_EXCHANGES = {
    "dense_psum": dense_psum_exchange,
    "merging": merging_exchange,
    "hash_sort": hash_sort_exchange,
}

# Frontier-compacted connector variants (dense_psum has none: its masked
# path keeps the N-sized combine but runs edge work on the compacted slab).
_SPARSE_EXCHANGES = {
    "merging": sparse_merging_exchange,
    "hash_sort": sparse_hash_sort_exchange,
}


def _rows_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask[E]`` shaped to broadcast over ``like[E, ...]``."""

    return mask.reshape((mask.shape[0],) + (1,) * (like.ndim - 1))


def _compact_and_gather(prog, j, state, active, src, dst, cap: int, *,
                        edge_data=None):
    """Sparse-superstep prologue: mask the edge slab by source activity,
    compact the frontier into ``cap`` slots, gather the compacted endpoints,
    state and edge data, and run the message UDF.  Returns ``(dst_c,
    payload, valid)``.  Empty slots carry a clamped in-range index: their
    payload is computed from real state but excluded via ``valid``."""

    if src.shape[0] == 0:
        # Zero-edge slab: one inert edge, masked off, so every gather below
        # has a real row (the clamp would otherwise wrap to -1).
        device = src.device
        src = torch.zeros(1, dtype=torch.int32, device=device)
        dst = torch.zeros(1, dtype=torch.int32, device=device)
        edge_data = tree_map(
            lambda e: torch.zeros((1,) + tuple(e.shape[1:]), dtype=e.dtype,
                                  device=device),
            edge_data,
        )
        mask = torch.zeros(1, dtype=torch.bool, device=device)
    else:
        mask = torch.index_select(active, 0, src)
    idx, valid = compact_active_edges(mask, cap)
    idx_c = torch.clamp(idx, max=src.shape[0] - 1)
    src_c = torch.index_select(src, 0, idx_c)
    dst_c = torch.index_select(dst, 0, idx_c)
    edata_c = tree_map(lambda e: torch.index_select(e, 0, idx_c), edge_data)
    src_state = tree_map(lambda s: torch.index_select(s, 0, src_c), state)
    payload = prog.message(j, src_state, edata_c)
    return dst_c, payload, valid


def _apply_and_merge(prog, j, state, inbox, got):
    """Superstep epilogue (O8..O10 + L7): finalize the inbox (``mean``),
    run the apply UDF, keep the old state wherever no message arrived, and
    halt those vertices.  Every superstep variant shares this merge."""

    monoid = get_monoid(prog.combine)
    if monoid.finalize is not None:
        inbox = monoid.finalize(inbox)
    new_state, new_active = prog.apply(j, state, inbox, got)
    merged = tree_map(
        lambda old, new: torch.where(_rows_mask(got, new), new, old),
        state, new_state,
    )
    return merged, new_active & got


@dataclass
class PregelStepBundle:
    """The steps ``compile_pregel`` wraps: the dense superstep, the
    frontier-compacted sparse factory (per static capacity), and the edge
    slab size (a capacity at or above it cannot win)."""

    superstep: Callable
    sparse_step_factory: Callable[[int], Callable]
    local_edge_cap: int
    # Failure injection threaded from the compile call: the executable
    # hands it to its host driver, which fires ``maybe_fail(j)`` at the
    # step boundary.
    injector: Optional[Any] = None


def build_pregel_steps(prog, graph, plan, mesh=None,
                       injector=None) -> PregelStepBundle:
    """Materialize the planned Listing-1 superstep pipeline on one
    device.  ``injector`` rides along on the bundle: failures fire at the
    host step boundary between supersteps, never inside one."""

    if mesh is not None:
        raise NotImplementedError(
            "sharded Pregel (mesh=) is not ported yet: ROADMAP A10 "
            "(multi-GPU)"
        )
    connector = _EXCHANGES[plan.connector]
    op = prog.combine
    monoid = get_monoid(op)
    n = graph.n_vertices

    def superstep(carry, j):
        """One superstep (Fig. 4's O7..O15 pipeline)."""

        state, active = carry
        # O7 index join: probe source state by gather.
        src_state = tree_map(
            lambda s: torch.index_select(s, 0, graph.src), state
        )
        src_active = torch.index_select(active, 0, graph.src)
        payload = prog.message(j, src_state, graph.edge_data)
        # Vote-to-halt: inactive sources contribute the combine identity.
        payload = torch.where(
            _rows_mask(src_active, payload), payload,
            monoid.identity_like(payload),
        )
        # O15 sender combine + connector + O14 receiver combine.
        inbox = connector(graph.dst, payload, n, (), op)
        got = connector(
            graph.dst, torch.where(src_active, 1.0, 0.0), n, (), "sum",
        ) > 0
        # O8 apply + O9/O10 masked state update (the L7 non-null check).
        return _apply_and_merge(prog, j, state, inbox, got)

    sparse_ex = _SPARSE_EXCHANGES.get(plan.connector)

    def sparse_step_factory(cap: int) -> Callable:
        """Frontier-compacted superstep: gather, message UDF, combine and
        exchange run over a ``cap``-sized slab of the active edges."""

        def step(carry, j):
            state, active = carry
            dst_c, payload, valid = _compact_and_gather(
                prog, j, state, active, graph.src, graph.dst, cap,
                edge_data=graph.edge_data,
            )
            if sparse_ex is None:
                ex = lambda fused: dense_psum_exchange(
                    dst_c, fused, n, (), op, edge_mask=valid, flag_cols=1,
                )
            else:
                ex = lambda fused: sparse_ex(
                    dst_c, fused, valid, n, (), op, flag_cols=1,
                )
            inbox, got = fused_got_exchange(ex, payload, valid, op)
            return _apply_and_merge(prog, j, state, inbox, got)

        return step

    return PregelStepBundle(
        superstep=superstep,
        sparse_step_factory=sparse_step_factory,
        local_edge_cap=graph.n_edges,
        injector=injector,
    )


# ---------------------------------------------------------------------------
# Listing 2: the IMRU step
# ---------------------------------------------------------------------------


def microbatch_slices(n_records: int, microbatches: int):
    """The ``(start, stop)`` record ranges one IMRU iteration maps, in the
    order their statistics are added: slices of ``n_records //
    microbatches`` records (at least 1), then the remainder as a last,
    shorter slice.  The reference runs only the whole slices and so skips
    the last ``n_records mod`` slice-size records (ROADMAP C8); here every
    record counts."""

    if microbatches <= 1:
        return [(0, n_records)]
    mb = max(1, n_records // microbatches)
    return [(s, min(s + mb, n_records)) for s in range(0, n_records, mb)]


def build_imru_step(task, records, plan, mesh, mesh_spec):
    """Materialize the planned Listing-2 step (Fig. 5) on one device: map
    with sender-side early aggregation over the planned microbatches (one
    accumulator, added to in a fixed order), then the update UDF.  On one
    device the planned reduce is the identity.  Returns ``(step,
    records)``; the records stay where they are (loop-invariant caching).
    """

    if mesh is not None:
        raise NotImplementedError(
            "sharded IMRU (mesh=) is not ported yet: ROADMAP A10 (multi-GPU)"
        )
    n_records = int(tree_leaves(records)[0].shape[0])
    slices = microbatch_slices(n_records, plan.microbatches)

    def local_partial(model: Any) -> Any:
        """map + sender-side early aggregation over the records (Fig. 5
        O5+O6), one microbatch at a time."""

        acc = None
        for start, stop in slices:
            batch = tree_map(lambda x: x[start:stop], records)
            stat = task.map(batch, model)
            acc = stat if acc is None else tree_map(torch.add, acc, stat)
        return acc

    def step(model, j):
        return task.update(j, model, local_partial(model))

    return step, records
