"""Rewrite-rule plan optimizer: an explicit pass over the algebra DAG.

Runs between :func:`repro_torch.core.algebra.translate` (and the semi-naive
rewrite) and :func:`repro_torch.core.planner.plan_program`, mirroring raco's
``fromDatalog -> LogicalAlgebra -> optimize(...) -> backend`` pipeline.
Three classical rewrites, each recorded in ``ProgramPlan.notes`` as one
golden-pinnable entry::

    rewrite(join-reorder: T2, pushdown: 1 select, cse: 0 shared)

* **Join reordering by estimated cardinality.**  Every maximal Join/Cross
  region is flattened to its leaves and rebuilt left-deep by a greedy
  smallest-intermediate heuristic: start from the cheapest leaf, repeatedly
  join the connected leaf (sharing a schema column) that minimizes the
  estimated intermediate size.  Estimates come from real EDB row counts
  (``Relation.count()``) and dense-grid domain sizes for recursive state --
  the same quantities the physical planner costs.  Sound because the whole
  executor is name-based: joins align on column names and
  ``GenericExecutable._materialize`` permutes dims to the rule schema.

* **Select pushdown through Join/Cross/Project/Apply/Extend.**  Selections
  sink toward their scans so comparisons filter *before* joins instead of
  after.  Pushdown never enters the right (negated) side of an
  :class:`~repro_torch.core.algebra.AntiJoin` -- filtering the negation witness
  set would change stratified-negation semantics (a row is excluded when
  *any* matching negated fact exists, filtered or not).  A select whose
  columns would require crossing that boundary raises :class:`RewriteError`
  (fail closed), and a structural guard re-verifies after the pass that no
  AntiJoin right subtree was touched by any rewrite.

* **Common-subexpression elimination across rules.**  Structurally equal
  subtrees that read only EDB relations (loop-invariant by definition --
  recursive state mutates between rule firings, EDB grids never do) are
  replaced by one canonical node.  The executor memoizes those shared nodes
  per evaluation context, so a ``ScanEDB`` chain feeding two rules is
  evaluated once per step.

:func:`plan_to_dot` renders any :class:`~repro_torch.core.algebra.LogicalPlan`
(optimized or not) as graphviz text for visual plan inspection.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.algebra import (
    AntiJoin,
    Apply,
    Cross,
    Delta,
    Extend,
    Frontier,
    GroupBy,
    Join,
    LogicalOp,
    LogicalPlan,
    Project,
    RuleDataflow,
    ScanEDB,
    ScanState,
    ScanView,
    Select,
    Union,
    Unnest,
)
from repro_torch.core.datalog import Const, Program

__all__ = [
    "RewriteError",
    "RewriteResult",
    "rewrite_plan",
    "estimate_cardinality",
    "estimate_program_cardinalities",
    "plan_to_dot",
]


class RewriteError(Exception):
    """A rewrite that would change program semantics (fail closed)."""


# Assumed density of a Δ-frontier read relative to the full state grid.
DELTA_DENSITY = 0.125


# ---------------------------------------------------------------------------
# Cardinality estimation
# ---------------------------------------------------------------------------


def estimate_cardinality(
    op: LogicalOp,
    relations: Mapping[str, object],
    domain: int,
    state_estimates: Optional[Mapping[str, float]] = None,
) -> float:
    """Estimated output rows of ``op`` under the dense-grid model.

    EDB scans use the real materialized row count; recursive-state reads
    assume a full ``domain**k`` grid (the dense backend's worst case) unless
    ``state_estimates`` supplies real per-predicate row counts (from
    :func:`estimate_program_cardinalities` — predicates absent from the map
    are treated as empty, the fixpoint iteration's starting point); joins
    divide by ``domain`` per shared key (uniform-independence, the textbook
    System-R estimate).
    """

    def est(node: LogicalOp) -> float:
        if isinstance(node, ScanEDB):
            if node.relation == "__unit__":
                return 1.0
            rel = relations.get(node.relation)
            if rel is not None:
                try:
                    return float(max(1, int(rel.count())))
                except (TypeError, ValueError, AttributeError):
                    pass
            return float(domain) ** len(node.columns)
        if isinstance(node, Delta):
            if state_estimates is not None:
                return max(
                    1.0,
                    state_estimates.get(node.relation, 0.0) * DELTA_DENSITY,
                )
            return max(1.0, (float(domain) ** len(node.columns)) * DELTA_DENSITY)
        if isinstance(node, (ScanState, ScanView, Frontier)):
            if state_estimates is not None:
                return max(1.0, state_estimates.get(node.relation, 0.0))
            return float(domain) ** len(node.columns)
        if isinstance(node, Select):
            return 0.5 * est(node.child)
        if isinstance(node, (Project, Apply, Extend)):
            return est(node.child)
        if isinstance(node, Unnest):
            return 4.0 * est(node.child)
        if isinstance(node, AntiJoin):
            return est(node.left)
        if isinstance(node, GroupBy):
            return float(domain) ** len(node.keys) if node.keys else 1.0
        if isinstance(node, Join):
            denom = float(domain) ** len(node.keys) or 1.0
            return est(node.left) * est(node.right) / denom
        if isinstance(node, Cross):
            return est(node.left) * est(node.right)
        if isinstance(node, Union):
            return float(sum(est(i) for i in node.inputs))
        return float(domain)

    return est(op)


def estimate_program_cardinalities(
    dataflows: Sequence[RuleDataflow],
    relations: Mapping[str, object],
    domain: int,
    rounds: int = 4,
) -> Dict[str, float]:
    """Iterated per-predicate row-count estimates (real cardinalities).

    Starts every derived predicate at zero rows and replays the rule set
    ``rounds`` times: each round re-estimates every rule body against the
    current per-predicate counts (recursive reads no longer assume the full
    ``domain**k`` grid) and folds rule outputs into their targets
    monotonically.  Estimates are capped at the predicate's schema universe.
    The result feeds the planner's storage selection and gives join
    reordering real row counts on recursive predicates.
    """

    ests: Dict[str, float] = {}
    schema_cap: Dict[str, float] = {}
    for df in dataflows:
        schema_cap[df.target] = float(domain) ** len(df.op.schema())
    for _ in range(max(1, rounds)):
        totals: Dict[str, float] = {}
        for df in dataflows:
            e = estimate_cardinality(
                df.op, relations, domain, state_estimates=ests
            )
            totals[df.target] = totals.get(df.target, 0.0) + e
        for target, total in totals.items():
            ests[target] = min(
                max(ests.get(target, 0.0), total), schema_cap[target]
            )
    return ests


# ---------------------------------------------------------------------------
# Join reordering
# ---------------------------------------------------------------------------


def _flatten_join_region(op: LogicalOp) -> List[LogicalOp]:
    if isinstance(op, (Join, Cross)):
        return _flatten_join_region(op.left) + _flatten_join_region(op.right)
    return [op]


def _greedy_order(
    leaves: List[LogicalOp], relations: Mapping[str, object], domain: int,
    state_estimates: Optional[Mapping[str, float]] = None,
) -> List[int]:
    """Greedy smallest-intermediate join order (ties keep source order)."""

    ests = [
        estimate_cardinality(l, relations, domain, state_estimates)
        for l in leaves
    ]
    schemas = [set(l.schema()) for l in leaves]
    remaining = list(range(len(leaves)))
    start = min(remaining, key=lambda i: (ests[i], i))
    order = [start]
    remaining.remove(start)
    bound = set(schemas[start])
    current = ests[start]
    while remaining:
        connected = [i for i in remaining if bound & schemas[i]]
        pool = connected or remaining  # cross product only as a last resort

        def joined_est(i: int) -> float:
            shared = len(bound & schemas[i])
            return current * ests[i] / (float(domain) ** shared or 1.0)

        nxt = min(pool, key=lambda i: (joined_est(i), i))
        current = joined_est(nxt)
        order.append(nxt)
        bound |= schemas[nxt]
        remaining.remove(nxt)
    return order


def _rebuild_left_deep(leaves: List[LogicalOp], order: List[int]) -> LogicalOp:
    tree = leaves[order[0]]
    for i in order[1:]:
        leaf = leaves[i]
        shared = tuple(c for c in tree.schema() if c in leaf.schema())
        tree = Join(tree, leaf, shared) if shared else Cross(tree, leaf)
    return tree


def _reorder_joins(
    op: LogicalOp, relations: Mapping[str, object], domain: int,
    state_estimates: Optional[Mapping[str, float]] = None,
) -> Tuple[LogicalOp, bool]:
    """Reorder every maximal Join/Cross region below ``op`` (top-down).

    AntiJoin right subtrees are never entered: the negation witness set is
    kept byte-identical through the whole pass.
    """

    if isinstance(op, (Join, Cross)):
        raw_leaves = _flatten_join_region(op)
        fired = False
        leaves = []
        for leaf in raw_leaves:
            new_leaf, f = _reorder_joins(leaf, relations, domain,
                                         state_estimates)
            fired = fired or f
            leaves.append(new_leaf)
        order = _greedy_order(leaves, relations, domain, state_estimates)
        if order == list(range(len(leaves))) and not fired:
            return op, False
        reordered = order != list(range(len(leaves)))
        return _rebuild_left_deep(leaves, order), fired or reordered
    if isinstance(op, AntiJoin):
        new_left, fired = _reorder_joins(op.left, relations, domain,
                                         state_estimates)
        if fired:
            return dataclasses.replace(op, left=new_left), True
        return op, False
    # Generic single/multi-child recursion (right side of AntiJoin excluded
    # above; Union inputs and all ``child`` fields included).
    changes = {}
    fired = False
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, LogicalOp):
            nv, fv = _reorder_joins(v, relations, domain, state_estimates)
            if fv:
                changes[f.name] = nv
                fired = True
        elif isinstance(v, tuple) and v and all(isinstance(x, LogicalOp) for x in v):
            nvs = [_reorder_joins(x, relations, domain, state_estimates)
                   for x in v]
            if any(fv for _, fv in nvs):
                changes[f.name] = tuple(nv for nv, _ in nvs)
                fired = True
    if changes:
        return dataclasses.replace(op, **changes), fired
    return op, False


# ---------------------------------------------------------------------------
# Select pushdown
# ---------------------------------------------------------------------------


def _select_columns(sel: Select) -> FrozenSet[str]:
    cols = set()
    for side in (sel.lhs, sel.rhs):
        if isinstance(side, str) and side != "J":
            cols.add(side)
    return frozenset(cols)


def _sink_select(sel: Select) -> Tuple[LogicalOp, bool]:
    """Sink one Select as deep as possible; True if it moved >= 1 level."""

    child = sel.child
    cols = _select_columns(sel)

    def retarget(new_child: LogicalOp) -> LogicalOp:
        inner, _ = _sink_select(
            Select(new_child, sel.op, sel.lhs, sel.rhs)
        )
        return inner

    if isinstance(child, (Join, Cross)):
        if cols <= set(child.left.schema()):
            return dataclasses.replace(child, left=retarget(child.left)), True
        if cols <= set(child.right.schema()):
            return dataclasses.replace(child, right=retarget(child.right)), True
        return sel, False
    if isinstance(child, AntiJoin):
        if cols <= set(child.left.schema()):
            return dataclasses.replace(child, left=retarget(child.left)), True
        # AntiJoin.schema() == left.schema(), so a well-formed Select above an
        # AntiJoin always references left columns; anything else would have to
        # filter the negation witness set.  Refuse rather than mis-plan.
        raise RewriteError(
            f"select pushdown of [{sel.lhs} {sel.op} {sel.rhs}] would cross "
            f"the stratified-negation boundary of AntiJoin[{', '.join(child.keys)}] "
            f"(columns {sorted(cols)} not all in the positive side)"
        )
    if isinstance(child, Select):
        # Only hop over a sibling Select if we can sink strictly below it.
        inner, sunk = _sink_select(Select(child.child, sel.op, sel.lhs, sel.rhs))
        if not sunk:
            return sel, False
        return dataclasses.replace(child, child=inner), True
    if isinstance(child, Project):
        return dataclasses.replace(child, child=retarget(child.child)), True
    if isinstance(child, Apply):
        if cols & set(child.out_cols):
            return sel, False
        return dataclasses.replace(child, child=retarget(child.child)), True
    if isinstance(child, Extend):
        if child.column in cols:
            return sel, False
        return dataclasses.replace(child, child=retarget(child.child)), True
    if isinstance(child, Union):
        if all(cols <= set(i.schema()) for i in child.inputs):
            return dataclasses.replace(
                child, inputs=tuple(retarget(i) for i in child.inputs)
            ), True
        return sel, False
    # GroupBy, Unnest, scans: stop (pushing below a GroupBy would change the
    # aggregated multiset; below an Unnest the set column does not exist yet).
    return sel, False


def _pushdown_selects(op: LogicalOp) -> Tuple[LogicalOp, int]:
    """Bottom-up pass sinking every Select; returns (tree, #selects moved)."""

    moved = 0
    if isinstance(op, AntiJoin):
        new_left, n = _pushdown_selects(op.left)
        moved += n
        if new_left is not op.left:
            op = dataclasses.replace(op, left=new_left)
    else:
        changes = {}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, LogicalOp):
                nv, n = _pushdown_selects(v)
                moved += n
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, tuple) and v and all(
                isinstance(x, LogicalOp) for x in v
            ):
                nvs = []
                changed = False
                for x in v:
                    nx, n = _pushdown_selects(x)
                    moved += n
                    changed = changed or nx is not x
                    nvs.append(nx)
                if changed:
                    changes[f.name] = tuple(nvs)
        if changes:
            op = dataclasses.replace(op, **changes)
    if isinstance(op, Select):
        new_op, sunk = _sink_select(op)
        if sunk:
            return new_op, moved + 1
    return op, moved


# ---------------------------------------------------------------------------
# Common-subexpression elimination (EDB-pure subtrees)
# ---------------------------------------------------------------------------


def _is_edb_pure(op: LogicalOp, edb: FrozenSet[str]) -> bool:
    if isinstance(op, (ScanState, ScanView, Frontier, Delta)):
        return False
    if isinstance(op, ScanEDB):
        return op.relation == "__unit__" or op.relation in edb
    return all(_is_edb_pure(c, edb) for c in op.children())


def _count_subtrees(op: LogicalOp, counts: Dict[LogicalOp, int]) -> None:
    counts[op] = counts.get(op, 0) + 1
    for child in op.children():
        _count_subtrees(child, counts)


def _cse_plan(
    dataflows: List[RuleDataflow], edb: FrozenSet[str]
) -> Tuple[List[RuleDataflow], int, FrozenSet[int]]:
    counts: Dict[LogicalOp, int] = {}
    for df in dataflows:
        _count_subtrees(df.op, counts)
    candidates = {
        op for op, n in counts.items() if n >= 2 and _is_edb_pure(op, edb)
    }
    if not candidates:
        return dataflows, 0, frozenset()

    canon: Dict[LogicalOp, LogicalOp] = {}
    uses: Dict[LogicalOp, int] = {}

    def rebuild(op: LogicalOp) -> LogicalOp:
        if op in candidates:
            got = canon.get(op)
            if got is None:
                got = _map_children(op, rebuild)
                canon[op] = got
            uses[op] = uses.get(op, 0) + 1
            return got
        return _map_children(op, rebuild)

    new_dataflows = [
        RuleDataflow(df.label, df.target, rebuild(df.op), df.next_state)
        for df in dataflows
    ]
    # Maximal shared subtrees only: a candidate nested inside another shared
    # subtree is rebuilt once (during its parent's canonicalization) and so
    # never reaches two uses unless it is also shared *outside* that parent.
    shared = [op for op, n in uses.items() if n >= 2]
    shared_ids = frozenset(id(canon[op]) for op in shared)
    return new_dataflows, len(shared), shared_ids


def _map_children(op: LogicalOp, fn) -> LogicalOp:
    changes = {}
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, LogicalOp):
            nv = fn(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and all(isinstance(x, LogicalOp) for x in v):
            nvs = tuple(fn(x) for x in v)
            if any(a is not b for a, b in zip(nvs, v)):
                changes[f.name] = nvs
    if changes:
        return dataclasses.replace(op, **changes)
    return op


# ---------------------------------------------------------------------------
# Negation-boundary guard
# ---------------------------------------------------------------------------


def _negation_right_signatures(dataflows) -> List[Tuple[str, tuple]]:
    """Structure of every AntiJoin right subtree, in traversal order."""

    sigs: List[Tuple[str, tuple]] = []

    def walk(op: LogicalOp) -> None:
        if isinstance(op, AntiJoin):
            sigs.append((",".join(op.keys), op.right.structure()))
        for child in op.children():
            walk(child)

    for df in dataflows:
        walk(df.op)
    return sigs


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RewriteResult:
    plan: LogicalPlan
    notes: Tuple[str, ...]
    shared_ids: FrozenSet[int]


def rewrite_plan(
    plan: LogicalPlan,
    program: Program,
    relations: Optional[Mapping[str, object]] = None,
    domain: int = 64,
) -> RewriteResult:
    """Run join-reorder, select-pushdown, and CSE over a logical plan.

    Returns the rewritten plan, a one-entry notes tuple for
    ``ProgramPlan.notes`` (``rewrite(join-reorder: ..., pushdown: ...,
    cse: n shared)``), and the ``id()`` set of canonical shared subtrees
    (consumed by the executor's per-step memo).

    Raises :class:`RewriteError` if any rewrite would cross a
    stratified-negation boundary (and double-checks structurally that no
    AntiJoin right subtree changed).
    """

    relations = relations or {}
    dataflows = list(plan.init) + list(plan.body)
    guard_before = _negation_right_signatures(dataflows)

    # Real row counts for recursive predicates (iterated fixpoint of the
    # estimate equations) — join reordering sees actual cardinalities
    # instead of full-grid worst cases.
    state_estimates = estimate_program_cardinalities(
        dataflows, relations, domain
    )

    reordered: List[str] = []
    pushed = 0
    new_dataflows: List[RuleDataflow] = []
    for df in dataflows:
        op, fired = _reorder_joins(df.op, relations, domain, state_estimates)
        if fired:
            reordered.append(df.label)
        op, n_moved = _pushdown_selects(op)
        pushed += n_moved
        new_dataflows.append(RuleDataflow(df.label, df.target, op, df.next_state))

    edb = frozenset(program.edb)
    new_dataflows, n_shared, shared_ids = _cse_plan(new_dataflows, edb)

    guard_after = _negation_right_signatures(new_dataflows)
    if guard_after != guard_before:
        raise RewriteError(
            "rewrite pass altered an AntiJoin right (negated) subtree — "
            "stratified-negation semantics would change; refusing the plan"
        )

    n_init = len(plan.init)
    new_plan = LogicalPlan(
        name=plan.name,
        init=tuple(new_dataflows[:n_init]),
        body=tuple(new_dataflows[n_init:]),
        carried=plan.carried,
    )
    parts = [
        "join-reorder: " + ("+".join(reordered) if reordered else "none"),
        "pushdown: " + (f"{pushed} select{'s' if pushed != 1 else ''}"
                        if pushed else "none"),
        f"cse: {n_shared} shared",
    ]
    note = "rewrite(" + ", ".join(parts) + ")"
    return RewriteResult(new_plan, (note,), shared_ids)


# ---------------------------------------------------------------------------
# Visualization
# ---------------------------------------------------------------------------


def plan_to_dot(
    plan: LogicalPlan, storage: Optional[Mapping[str, str]] = None
) -> str:
    """Render a LogicalPlan as graphviz dot text (one cluster per rule).

    Shared (CSE'd) subtrees appear once with fan-in edges, because node
    identity follows Python object identity.  When ``storage`` is given (a
    predicate -> {"dense-grid", "row-table"} map, e.g.
    ``ProgramPlan.storage``), nodes that read or write a row-table predicate
    are drawn filled (``box3d``/filled ellipse) so mixed-storage plans are
    visually auditable; ``storage=None`` output is byte-identical to before.
    """

    storage = storage or {}
    _ROW_SCAN_ATTRS = ", shape=box3d, style=filled, fillcolor=lightsteelblue"
    _ROW_SINK_ATTRS = ", style=filled, fillcolor=lightsteelblue"

    lines = [
        "digraph logical_plan {",
        "  rankdir=BT;",
        '  node [shape=box, fontname="monospace", fontsize=10];',
    ]
    node_ids: Dict[int, str] = {}
    emitted = set()
    counter = [0]

    def node_id(op: LogicalOp) -> str:
        key = id(op)
        if key not in node_ids:
            node_ids[key] = f"n{counter[0]}"
            counter[0] += 1
        return node_ids[key]

    def _node_storage_attrs(op: LogicalOp) -> str:
        if isinstance(op, (ScanEDB, ScanState, ScanView, Delta, Frontier)):
            if storage.get(op.relation) == "row-table":
                return _ROW_SCAN_ATTRS
        return ""

    def emit(op: LogicalOp) -> str:
        nid = node_id(op)
        if id(op) in emitted:
            return nid
        emitted.add(id(op))
        label = op._describe().replace("\\", "\\\\").replace('"', '\\"')
        lines.append(f'  {nid} [label="{label}"{_node_storage_attrs(op)}];')
        for child in op.children():
            cid = emit(child)
            lines.append(f"  {cid} -> {nid};")
        return nid

    for section, dataflows in (("init", plan.init), ("body", plan.body)):
        for df in dataflows:
            root = emit(df.op)
            sink = f"rule_{df.label}".replace("?", "q")
            arrow = "=> next" if df.next_state else "=>"
            extra = (
                _ROW_SINK_ATTRS
                if storage.get(df.target) == "row-table"
                else ""
            )
            lines.append(
                f'  {sink} [shape=ellipse, label="{df.label} {arrow} '
                f'{df.target} [{section}]"{extra}];'
            )
            lines.append(f"  {root} -> {sink};")
    lines.append("}")
    return "\n".join(lines)
