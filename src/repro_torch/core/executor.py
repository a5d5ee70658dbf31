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

Relations live on a dense vertex-domain grid ``[0, n)``: a predicate with
``k`` key columns is a bool presence grid ``[n]^k`` plus one float32 grid
per value column.  Joins are broadcast ``n^k`` grids, Project an ``any``
over the eliminated axes, GroupBy a masked ``sum``/``amax``/``amin``
(``dense-reduce``) or the sorted segment combine (``segment-scan``).  The
planner picks the segment scan for a sum/max/min only on grids of at most
21 cells, and that route reaches the segment-combine kernel on the card;
every other operator of the generic engine, and IMRU's step, is plain
tensor code.

Not ported yet, and raising ``NotImplementedError`` with the queue item:
row-table storage (ROADMAP A9), the sharded layouts (``mesh=``,
``exchange=``, ``remesh``: A10), checkpoints and failure injection (A11),
out-of-core chunks (``chunks=``, ``hbm_budget=``: A12) and per-query
parameters (``params=``, ``run_batched``: A13).
"""

from __future__ import annotations

import ast
import functools
import time
from dataclasses import dataclass, field
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
    fused_got_exchange,
    hash_sort_exchange,
    merging_exchange,
    segment_combine_sorted,
    sparse_hash_sort_exchange,
    sparse_merging_exchange,
)
from repro_torch.core.planner import GroupBySpec, plan_program
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device

__all__ = [
    "ExecutorError",
    "Relation",
    "GenericExecutable",
    "compile_program",
    "PregelStepBundle",
    "build_pregel_steps",
    "build_imru_step",
    "microbatch_slices",
]


class ExecutorError(Exception):
    """A program cannot be executed by the generic dense-grid backend."""


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
    silently index-wrap into the dense grid)."""

    for pos, col in zip(key_positions, key_cols):
        if col.size == 0:
            continue
        lo, hi = int(col.min()), int(col.max())
        if lo < 0 or hi >= n:
            raise ExecutorError(
                f"key column {pos}: vertex id {lo if lo < 0 else hi} is "
                f"outside the domain [0, {n})"
            )


# Raw tuple arrays whose dense grid would exceed this many cells need
# row-table storage (the reference routes them to a RowRelation).
_DENSE_REL_CELL_LIMIT = 1 << 24


def _as_relation(name: str, value, domain: Optional[int], device):
    if isinstance(value, Relation):
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
            raise NotImplementedError(
                f"relation {name!r}: its dense grid of {domain}^"
                f"{arr.shape[1]} cells needs row-table storage, which is "
                "not ported yet: ROADMAP A9 (row-table storage)"
            )
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


def _eval(op: algebra.LogicalOp, ctx: _Ctx) -> _Inter:
    if ctx.shared and id(op) in ctx.shared:
        hit = ctx.memo.get(id(op))
        if hit is None:
            hit = _eval_inner(op, ctx)
            ctx.memo[id(op)] = hit
        return hit
    return _eval_inner(op, ctx)


def _eval_inner(op: algebra.LogicalOp, ctx: _Ctx) -> _Inter:
    n = ctx.n
    shape_of = lambda dims: (n,) * len(dims)  # noqa: E731
    if isinstance(op, algebra.ScanEDB):
        if op.relation == "__unit__":
            return _Inter((), torch.tensor(True, device=ctx.device), {})
        rel = ctx.relations[op.relation]
        return _scan_inter(op.columns, rel.key_positions, rel.present,
                           rel.values)
    if isinstance(op, algebra.Delta):
        entry = _read_pred(ctx, op.relation)
        keys, _ = ctx.sigs[op.relation]
        return _scan_inter(
            op.columns, keys, entry.get("delta", entry["present"]),
            entry["values"],
        )
    if isinstance(op, (algebra.ScanState, algebra.ScanView, algebra.Frontier)):
        entry = _read_pred(ctx, op.relation)
        keys, _ = ctx.sigs[op.relation]
        return _scan_inter(op.columns, keys, entry["present"],
                           entry["values"])
    if isinstance(op, algebra.Join):
        return _join(_eval(op.left, ctx), _eval(op.right, ctx), op.keys, ctx)
    if isinstance(op, algebra.Cross):
        return _join(_eval(op.left, ctx), _eval(op.right, ctx), (), ctx)
    if isinstance(op, algebra.AntiJoin):
        l, r = _eval(op.left, ctx), _eval(op.right, ctx)
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
        lhs = _operand(child, op.lhs, ctx)
        rhs = _operand(child, op.rhs, ctx)
        mask = _CMP[op.op](lhs, rhs)
        return _Inter(child.dims, child.present & mask, child.cols)
    if isinstance(op, algebra.Project):
        child = _eval(op.child, ctx)
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
        cols[op.column] = torch.tensor(
            op.value, dtype=torch.float32, device=ctx.device,
        ).broadcast_to(shape_of(child.dims))
        return _Inter(child.dims, child.present, cols)
    if isinstance(op, algebra.Apply):
        child = _eval(op.child, ctx)
        udf = ctx.program.udfs.get(op.fn)
        if udf is None or udf.fn is None:
            raise ExecutorError(f"UDF {op.fn!r} has no bound implementation")
        args = []
        for c in op.in_cols:
            if isinstance(c, str) and c.startswith("lit:"):
                args.append(ast.literal_eval(c[4:]))
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
        cols = dict(child.cols)
        for name, o in zip(op.out_cols, outs):
            cols[name] = torch.as_tensor(o, device=ctx.device).broadcast_to(
                shape_of(child.dims))
        return _Inter(child.dims, child.present, cols)
    if isinstance(op, algebra.GroupBy):
        return _groupby(op, _eval(op.child, ctx), ctx)
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


@dataclass
class GenericExecutable:
    """A compiled generic program: logical plan + grid backend + drivers."""

    program: Program
    logical: algebra.LogicalPlan
    plan: Any                        # planner.ProgramPlan
    relations: Dict[str, Relation]
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

    # -- state plumbing -----------------------------------------------------

    def _empty_out(self, pred: str) -> Dict[str, Any]:
        keys, vals = self.sigs[pred]
        shape = (self.domain,) * len(keys)
        return {
            "present": torch.zeros(shape, dtype=torch.bool,
                                   device=self.device),
            "values": {p: torch.zeros(shape, dtype=torch.float32,
                                      device=self.device) for p in vals},
        }

    def _empty_entry(self, pred: str) -> Dict[str, Any]:
        entry = self._empty_out(pred)
        entry["delta"] = torch.zeros_like(entry["present"])
        return entry

    def _ctx(self, state, views, materialized, j, label="") -> _Ctx:
        return _Ctx(
            program=self.program,
            n=self.domain,
            device=self.device,
            sigs=self.sigs,
            relations=self.relations,
            state=state,
            views=views,
            materialized=materialized,
            connectors=self.plan.connectors,
            j=j,
            label=label,
            shared=self.shared_ids,
        )

    def _materialize(self, df, inter: _Inter, ctx: _Ctx) -> Dict[str, Any]:
        """Lower a rule-body intermediate into the head predicate's dense
        grid: an *out* dict ``{present, values}``."""

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

    def _merge(self, pred: str, outs, ctx: _Ctx) -> Dict[str, Any]:
        if not outs:
            return self._empty_out(pred)
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

    @staticmethod
    def _diff(old, present, values):
        diff = old["present"] != present
        both = old["present"] & present
        for p, v in values.items():
            diff = diff | (both & (old["values"][p] != v))
        return diff

    # -- per-phase step -----------------------------------------------------

    def _apply_body(self, phase: _Phase, ctx: _Ctx, state, dataflows, acc):
        """Fire a phase's body dataflows and seal the carried entries."""

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
            entry["delta"] = out["present"] & self._diff(
                state[pred], out["present"], out["values"]
            )
            new_state[pred] = entry
        return new_state

    def _phase_step(self, phase: _Phase, materialized) -> Callable:
        def step(state, j):
            views: Dict[str, Dict[str, Any]] = {}
            ctx = self._ctx(state, views, materialized, j)
            return self._apply_body(phase, ctx, state, phase.body, {})

        return step

    def _phase_converged(self, phase: _Phase) -> Callable:
        def conv(prev, new):
            same = torch.ones((), dtype=torch.bool, device=self.device)
            for pred in phase.carried:
                diff = self._diff(
                    prev[pred], new[pred]["present"], new[pred]["values"]
                )
                same = same & ~torch.any(diff)
            return same

        return conv

    def _run_rules_once(self, dataflows, state, materialized, j):
        """Fire a rule group once (init / final-view / post rules), merging
        multi-rule targets, and return {target: entry}."""

        acc: Dict[str, list] = {}
        order: List[str] = []
        views: Dict[str, Dict[str, Any]] = {}
        ctx = self._ctx(state, views, materialized, j)
        for df in dataflows:
            ctx.label = df.label
            out = self._materialize(df, _eval(df.op, ctx), ctx)
            if df.target not in acc:
                order.append(df.target)
            acc.setdefault(df.target, []).append(out)
            # make the target readable by later rules in this group
            views[df.target] = self._merge(df.target, acc[df.target], ctx)
        return {t: views[t] for t in order}

    def _init_entry(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Promote a materialized out into a carried entry: everything is
        new at J=0, so the delta mask starts as the presence mask."""

        entry = dict(out)
        entry["delta"] = out["present"]
        return entry

    def phase_step_fn(self) -> Tuple[Callable, Dict[str, Dict[str, Any]]]:
        """Benchmark hook: the per-iteration step of the FIRST fixpoint
        phase plus its initialized state — one rule firing of the recursive
        stratum, the unit the drivers repeat."""

        state = {pred: self._empty_entry(pred)
                 for phase in self.phases for pred in phase.carried}
        materialized = dict(self._run_rules_once(self.prelude, state, {}, 0))
        phase = self.phases[0]
        inits = self._run_rules_once(phase.init, state, materialized, 0)
        for pred in phase.carried:
            entry = inits.get(pred)
            if entry is not None:
                state[pred] = self._init_entry(entry)
        return self._phase_step(phase, materialized), state

    def remesh(self, mesh) -> "GenericExecutable":
        raise NotImplementedError(
            "remesh is not ported yet: ROADMAP A10 (multi-GPU)"
        )

    def run_batched(self, *args, **kwargs):
        raise NotImplementedError(
            "run_batched is not ported yet: ROADMAP A13 (serving)"
        )

    # -- fixpoint entry point ----------------------------------------------

    def run(
        self,
        max_iters: int,
        on_device: bool = False,
        *,
        params: Optional[Mapping[str, Relation]] = None,
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,
        injector: Optional[Any] = None,
    ) -> FixpointResult:
        """Run every fixpoint phase in sequence to the no-new-facts
        fixpoint (``max_iters`` bounds each phase), under
        :func:`device_fixpoint` (``on_device=True``) or the host driver.

        Returns a :class:`FixpointResult` whose ``state`` maps every
        materialized predicate to its final :class:`Relation`.
        ``params=`` raises (ROADMAP A13), and so do ``checkpoint_dir=``,
        ``resume=`` and ``injector=`` (A11).
        """

        if params is not None:
            raise NotImplementedError(
                "params= is not ported yet: ROADMAP A13 (serving)"
            )
        if checkpoint_dir is not None or injector is not None or resume:
            raise NotImplementedError(
                "checkpoint_dir=, resume= and injector= are not ported yet: "
                "ROADMAP A11 (fault tolerance)"
            )
        t0 = time.perf_counter()
        state: Dict[str, Dict[str, Any]] = {
            pred: self._empty_entry(pred)
            for phase in self.phases for pred in phase.carried
        }
        materialized: Dict[str, Dict[str, Any]] = dict(
            self._run_rules_once(self.prelude, state, {}, 0)
        )
        total, phase_iters, all_conv, stragglers = 0, [], True, 0
        for phase in self.phases:
            inits = self._run_rules_once(phase.init, state, materialized, 0)
            for pred in phase.carried:
                entry = inits.get(pred)
                if entry is not None:
                    state[pred] = self._init_entry(entry)
            step = self._phase_step(phase, materialized)
            conv = self._phase_converged(phase)
            if on_device:
                res = device_fixpoint(step, conv, state, max_iters)
            else:
                res = HostFixpointDriver(
                    step=step, converged=conv,
                    config=DriverConfig(max_iters=max_iters),
                ).run(state)
                stragglers += res.straggler_events
            state = res.state
            total += res.iterations
            phase_iters.append(res.iterations)
            all_conv = all_conv and res.converged
            # Final views of this phase (frontier reads at the fixpoint),
            # then the post-stratum rules gated on its convergence.
            materialized.update(self._run_rules_once(
                tuple(df for df in phase.body if not df.next_state)
                + phase.finals,
                state, materialized, res.iterations,
            ))
            materialized.update(self._run_rules_once(
                phase.post, state, materialized, res.iterations,
            ))

        out: Dict[str, Relation] = {}
        for pred, entry in list(materialized.items()) + [
            (p, state[p]) for ph in self.phases for p in ph.carried
        ]:
            keys, _ = self.sigs[pred]
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
    :class:`Relation` instances on ``device`` (or raw int tuple arrays with
    ``domain=``); for the paper's listings, the front-end physical inputs
    (Listing 1: ``{"data": Graph}``; Listing 2: ``{"training_data":
    records}``) with ``binding`` the vectorized UDF bundle
    (:class:`~repro_torch.core.pregel.VertexProgram` or
    :class:`~repro_torch.core.imru.IMRUTask`), which go to
    ``compile_pregel`` / ``compile_imru``.  Everything else runs on the
    dense-grid interpreter with sequential fixpoint phases.

    ``rewrite=True`` runs the :mod:`repro_torch.core.rewrite` optimizer
    pass (join reordering, select pushdown, cross-rule CSE) over the
    logical plan; its decisions are recorded in ``plan.notes``.  The
    planner's ``storage-selection(...)`` note is computed as the
    reference's; a predicate it (or ``storage=`` / ``row_cap=``) puts on
    row-table storage raises (ROADMAP A9), as do ``mesh=`` and
    ``exchange=`` (A10) and ``chunks=`` / ``hbm_budget=`` (A12).
    """

    if mesh is not None or exchange is not None:
        raise NotImplementedError(
            "mesh= and exchange= are not ported yet: ROADMAP A10 (multi-GPU)"
        )
    if chunks is not None or hbm_budget is not None:
        raise NotImplementedError(
            "chunks= and hbm_budget= are not ported yet: ROADMAP A12 "
            "(out-of-core chunk streaming)"
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

    rels: Dict[str, Relation] = {}
    for name, value in relations.items():
        rel = _as_relation(name, value, domain, device)
        for t in [rel.present] + list(rel.values.values()):
            if t.device.type != device.type:
                raise ValueError(
                    f"relation {name!r} lies on {t.device}, compile_program "
                    f"was asked for {device}: build it there "
                    "(Relation.from_columns(..., device=) or "
                    "repro_torch.carry.relation_from_numpy)"
                )
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
    if row_cap is not None or "row-table" in forced.values():
        raise NotImplementedError(
            "row-table storage (storage=, row_cap=) is not ported yet: "
            "ROADMAP A9 (row-table storage)"
        )

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
        predicates=predicates, storage=forced or None,
        exchange_ops=exchange_ops,
        edb=tuple(sorted(rels)),
        row_value_cols={
            name: len(rel.values) for name, rel in rels.items()
        },
    )
    rows = sorted(p for p, s in plan.storage.items() if s == "row-table")
    if rows:
        raise NotImplementedError(
            f"the planner put {rows} on row-table storage, which is not "
            "ported yet: ROADMAP A9 (row-table storage); its note: "
            f"{plan.notes[0]}"
        )
    return GenericExecutable(
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
    )


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


def build_pregel_steps(prog, graph, plan, mesh=None) -> PregelStepBundle:
    """Materialize the planned Listing-1 superstep pipeline on one
    device."""

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
