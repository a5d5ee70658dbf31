"""Datalog → extended relational algebra (paper Section 3.3, Figures 2–3).

Translates an XY-stratified :class:`~repro_torch.core.datalog.Program` into a
*logical plan*: a DAG of relational operators with an explicit fixpoint
structure.  The translation follows the standard deductive-database
construction the paper references [Ramakrishnan & Ullman 1993]:

* body atoms become scans, natural-joined on shared variables (a join with no
  shared variables is a **cross product** — e.g. broadcasting the model to
  every training record in rule G2, the ⨯ of Figure 2);
* function predicates become **Apply** (UDF call) operators once their input
  variables are bound;
* comparisons become **Select** operators;
* negated goals become **AntiJoin** operators;
* set-valued patterns become **Unnest** (rule L8 flattening outbound
  messages);
* head aggregation becomes **GroupBy** (group-all when the head has no plain
  variables, like G2's global ``reduce``);
* the paper's frontier rules (L4/L5) become **Frontier** operators — reads of
  the most recent materialized state.  The physical planner implements them
  as direct reads of the carried state array, which is precisely the paper's
  "Storage Selection" optimization (the B-tree "avoids the logical max
  aggregation in Figure 3").

The output :class:`LogicalPlan` is consumed by :mod:`repro_torch.core.planner`
and — since the unified-executor refactor — **executed** by
:mod:`repro_torch.core.executor`: ``compile_program`` interprets this DAG
per-stratum on the dense-grid backend, so the logical plan is the actual
execution contract rather than a decorative artifact.  Golden tests assert
that translating Listings 1/2 reproduces the operator structure of the
paper's Figures 2 and 3, and pin the operator skeletons of the generic
example programs (transitive closure, connected components, the
multi-stratum pipeline).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.datalog import (
    AggExpr,
    Atom,
    Comparison,
    Const,
    FunctionAtom,
    Negation,
    Program,
    Rule,
    SetTerm,
    TempSucc,
    TempVar,
    TempZero,
    Var,
    fresh_var,
)
from repro_torch.core import stratify

__all__ = [
    "LogicalOp",
    "ScanEDB",
    "ScanState",
    "ScanView",
    "Frontier",
    "Delta",
    "Apply",
    "Join",
    "Cross",
    "AntiJoin",
    "Select",
    "Project",
    "Extend",
    "Unnest",
    "GroupBy",
    "Union",
    "RuleDataflow",
    "LogicalPlan",
    "translate",
    "semi_naive_rewrite",
    "rewrite_ops",
    "TranslationError",
]


class TranslationError(Exception):
    pass


# ---------------------------------------------------------------------------
# Logical operators.  Schemas are tuples of variable names; natural joins
# operate on shared names.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LogicalOp:
    def schema(self) -> Tuple[str, ...]:  # pragma: no cover - abstract
        raise NotImplementedError

    def children(self) -> Tuple["LogicalOp", ...]:
        return ()

    def structure(self):
        """Nested (opname, ...) tuples — the shape asserted by golden tests."""

        name = type(self).__name__
        kids = tuple(c.structure() for c in self.children())
        return (name,) + kids if kids else (name,)

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = f"{pad}{self._describe()}"
        return "\n".join(
            [line] + [c.pretty(indent + 1) for c in self.children()]
        )

    def _describe(self) -> str:  # pragma: no cover - debugging aid
        return type(self).__name__


@dataclass(frozen=True)
class ScanEDB(LogicalOp):
    """Scan of an extensional relation (training_data, data/graph)."""

    relation: str
    columns: Tuple[str, ...]

    def schema(self):
        return self.columns

    def _describe(self):
        return f"ScanEDB[{self.relation}]({', '.join(self.columns)})"


@dataclass(frozen=True)
class ScanState(LogicalOp):
    """Scan of carried recursive state from the previous iteration
    (the loop-carried frontier: ``model``@J, ``send``@J, ...)."""

    relation: str
    columns: Tuple[str, ...]

    def schema(self):
        return self.columns

    def _describe(self):
        return f"ScanState[{self.relation}]({', '.join(self.columns)})"


@dataclass(frozen=True)
class ScanView(LogicalOp):
    """Scan of an intra-iteration view produced by an earlier rule in the
    schedule (``collect``@J feeding L6/G3, ``superstep``@J feeding L7/L8)."""

    relation: str
    columns: Tuple[str, ...]

    def schema(self):
        return self.columns

    def _describe(self):
        return f"ScanView[{self.relation}]({', '.join(self.columns)})"


@dataclass(frozen=True)
class Frontier(LogicalOp):
    """Most-recent-state view of a recursive predicate (rules L4/L5).

    Physically a direct read of the carried state array — the paper's B-tree
    storage selection makes the ``max``-over-temporal aggregation vanish.
    """

    relation: str
    columns: Tuple[str, ...]

    def schema(self):
        return self.columns

    def _describe(self):
        return f"Frontier[{self.relation}]({', '.join(self.columns)})"


@dataclass(frozen=True)
class Delta(LogicalOp):
    """Semi-naive read of a recursive predicate: only the facts derived in
    the *previous* iteration (Δpred@J), not the full materialization.

    The classic delta-relation rewrite of recursive query evaluation:
    when every aggregate consuming this read is idempotent (max/min — stale
    redelivery is absorbed) or rebuilt from scratch each iteration (Pregel's
    per-superstep ``collect``), restricting the scan to the changed frontier
    preserves the fixpoint while shrinking per-iteration work to O(Δ).
    Physically this becomes the frontier-compacted edge scan + sparse
    exchange of :mod:`repro_torch.core.physical`.
    """

    relation: str
    columns: Tuple[str, ...]

    def schema(self):
        return self.columns

    def _describe(self):
        return f"Delta[{self.relation}]({', '.join(self.columns)})"


@dataclass(frozen=True)
class Apply(LogicalOp):
    """UDF application (function predicate): map over child rows."""

    fn: str
    child: LogicalOp
    in_cols: Tuple[str, ...]
    out_cols: Tuple[str, ...]

    def schema(self):
        return tuple(self.child.schema()) + self.out_cols

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Apply[{self.fn}]({', '.join(self.in_cols)} -> {', '.join(self.out_cols)})"


@dataclass(frozen=True)
class Join(LogicalOp):
    """Natural join on shared variable names."""

    left: LogicalOp
    right: LogicalOp
    keys: Tuple[str, ...]

    def schema(self):
        right_extra = tuple(
            c for c in self.right.schema() if c not in self.left.schema()
        )
        return tuple(self.left.schema()) + right_extra

    def children(self):
        return (self.left, self.right)

    def _describe(self):
        return f"Join[{', '.join(self.keys)}]"


@dataclass(frozen=True)
class Cross(LogicalOp):
    """Cross product — broadcast of a (small) relation to every row of the
    other (Figure 2's ⨯ of the model with the training data)."""

    left: LogicalOp
    right: LogicalOp

    def schema(self):
        return tuple(self.left.schema()) + tuple(self.right.schema())

    def children(self):
        return (self.left, self.right)


@dataclass(frozen=True)
class AntiJoin(LogicalOp):
    """Negated goal: rows of ``left`` with no match in ``right``."""

    left: LogicalOp
    right: LogicalOp
    keys: Tuple[str, ...]

    def schema(self):
        return self.left.schema()

    def children(self):
        return (self.left, self.right)

    def _describe(self):
        return f"AntiJoin[{', '.join(self.keys)}]"


@dataclass(frozen=True)
class Select(LogicalOp):
    """Comparison selection (``M != NewM``, ``State != null``)."""

    child: LogicalOp
    op: str
    lhs: object  # column name (str) or Const
    rhs: object

    def schema(self):
        return self.child.schema()

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Select[{self.lhs} {self.op} {self.rhs}]"


@dataclass(frozen=True)
class Project(LogicalOp):
    columns: Tuple[str, ...] = ()
    child: LogicalOp = None  # type: ignore[assignment]

    def schema(self):
        return self.columns

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Project({', '.join(self.columns)})"


@dataclass(frozen=True)
class Extend(LogicalOp):
    """Append a constant column (head constants, e.g. ACTIVATION_MSG)."""

    child: LogicalOp
    column: str
    value: object

    def schema(self):
        return tuple(self.child.schema()) + (self.column,)

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Extend[{self.column} := {self.value!r}]"


@dataclass(frozen=True)
class Unnest(LogicalOp):
    """Flatten a set-valued column into one row per member (rule L8)."""

    child: LogicalOp
    set_col: str
    elem_cols: Tuple[str, ...]

    def schema(self):
        keep = tuple(c for c in self.child.schema() if c != self.set_col)
        return keep + self.elem_cols

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Unnest[{self.set_col} -> ({', '.join(self.elem_cols)})]"


@dataclass(frozen=True)
class GroupBy(LogicalOp):
    """Group-by aggregation; empty ``keys`` is the paper's group-all
    (rule G2's global ``reduce``)."""

    child: LogicalOp
    keys: Tuple[str, ...]
    agg: str
    agg_col: str
    out_col: str

    def schema(self):
        return self.keys + (self.out_col,)

    def children(self):
        return (self.child,)

    def _describe(self):
        keyspec = ", ".join(self.keys) if self.keys else "ALL"
        return f"GroupBy[{keyspec}; {self.agg}<{self.agg_col}> -> {self.out_col}]"


@dataclass(frozen=True)
class Union(LogicalOp):
    inputs: Tuple[LogicalOp, ...]

    def schema(self):
        return self.inputs[0].schema()

    def children(self):
        return self.inputs


# ---------------------------------------------------------------------------
# Per-rule dataflow and program-level plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RuleDataflow:
    """The dataflow of one rule: ``op`` feeding the ``target`` dataset.

    ``next_state`` marks Y-rules (the output becomes iteration J+1 state).
    """

    label: str
    target: str
    op: LogicalOp
    next_state: bool = False

    def structure(self):
        return (self.label, self.target, self.op.structure())

    def pretty(self) -> str:
        arrow = "=> NEXT" if self.next_state else "=>"
        return f"-- {self.label} {arrow} {self.target}\n{self.op.pretty(1)}"


@dataclass(frozen=True)
class LogicalPlan:
    """The complete iterative logical plan of an XY-stratified program.

    ``init`` fires once (J=0); ``body`` fires per iteration in schedule
    order; ``carried`` is the loop state (recursive predicate frontiers).
    Termination: the fixpoint is reached when no Y-rule derives new facts —
    e.g. G3's ``M != NewM`` selection yields nothing, or L8's message set is
    empty (Section 3.2 / Appendix B.2).
    """

    name: str
    init: Tuple[RuleDataflow, ...]
    body: Tuple[RuleDataflow, ...]
    carried: Tuple[str, ...]

    def structure(self):
        return {
            "init": tuple(r.structure() for r in self.init),
            "body": tuple(r.structure() for r in self.body),
            "carried": self.carried,
        }

    def pretty(self) -> str:
        parts = [f"== LogicalPlan {self.name} (carried: {', '.join(self.carried)})"]
        parts.append("-- initialization --")
        parts += [r.pretty() for r in self.init]
        parts.append("-- per-iteration --")
        parts += [r.pretty() for r in self.body]
        return "\n".join(parts)


# ---------------------------------------------------------------------------
# Translation
# ---------------------------------------------------------------------------


def _var_name(term, hint: str) -> str:
    if isinstance(term, Var):
        return term.name
    raise TranslationError(f"expected variable in {hint}, got {term!r}")


def _atom_scan(
    atom: Atom,
    kind: str,
    selections: List[Tuple[str, str, object]],
    unnests: List[Tuple[str, Tuple[str, ...]]],
) -> LogicalOp:
    """Build the scan for a body atom, collecting constant/duplicate-variable
    selections and set-pattern unnests to apply on top."""

    cols: List[str] = []
    seen: Dict[str, str] = {}
    for i, term in enumerate(atom.data_args if atom.temporal else atom.args):
        if isinstance(term, Var):
            if term.name in seen:
                alias = f"{term.name}${i}"
                cols.append(alias)
                selections.append((term.name, "==", alias))
            else:
                seen[term.name] = term.name
                cols.append(term.name)
        elif isinstance(term, Const):
            alias = fresh_var(f"{atom.pred}${i}").name
            cols.append(alias)
            selections.append((alias, "==", Const(term.value)))
        elif isinstance(term, SetTerm):
            alias = fresh_var(f"{atom.pred}${i}.set").name
            cols.append(alias)
            unnests.append((alias, tuple(v.name for v in term.elem)))
        elif isinstance(term, (TempVar, TempSucc, TempZero)):
            raise TranslationError(
                f"unexpected temporal term in data position of {atom!r}"
            )
        else:
            raise TranslationError(f"unsupported term {term!r} in {atom!r}")
    columns = tuple(cols)
    if kind == "edb":
        return ScanEDB(atom.pred, columns)
    if kind == "state":
        return ScanState(atom.pred, columns)
    if kind == "view":
        return ScanView(atom.pred, columns)
    if kind == "frontier":
        return Frontier(atom.pred, columns)
    raise TranslationError(f"unknown scan kind {kind!r}")


def _join_or_cross(left: LogicalOp, right: LogicalOp) -> LogicalOp:
    shared = tuple(c for c in left.schema() if c in right.schema())
    if shared:
        return Join(left, right, shared)
    return Cross(left, right)


def _translate_rule(
    rule: Rule,
    program: Program,
    view_producers: Mapping[str, str],
    frontier_preds: frozenset,
    is_init: bool,
) -> RuleDataflow:
    """Translate one rule into an operator tree.

    ``view_producers`` maps predicate → "view" for predicates produced earlier
    in the same iteration; everything else recursive reads carried state.
    """

    # Frontier rules (L4/L5): direct read of the newest materialized state.
    if rule.frontier:
        state_atom = next(
            (
                lit
                for lit in rule.body
                if isinstance(lit, Atom) and lit.temporal
            ),
            None,
        )
        frontier_of = state_atom.pred if state_atom else rule.head.pred
        cols: List[str] = []
        for t in rule.head.args:
            if isinstance(t, AggExpr):
                cols.append(t.var.name)  # e.g. max<J> -> the iteration counter
            elif isinstance(t, Var):
                cols.append(t.name)
        op = Frontier(frontier_of, tuple(cols))
        return RuleDataflow(rule.label or "?", rule.head.pred, op)

    selections: List[Tuple[str, str, object]] = []

    tree: Optional[LogicalOp] = None
    pending: List[object] = list(rule.body)
    progress = True
    while pending and progress:
        progress = False
        deferred: List[object] = []
        for lit in pending:
            if isinstance(lit, Atom):
                if lit.pred in program.edb:
                    kind = "edb"
                elif lit.pred in frontier_preds:
                    kind = "frontier"
                elif view_producers.get(lit.pred) == "view":
                    kind = "view"
                else:
                    kind = "state"
                atom_unnests: List[Tuple[str, Tuple[str, ...]]] = []
                scan = _atom_scan(lit, kind, selections, atom_unnests)
                # Apply set-pattern unnests local to this atom before joining.
                for set_col, elem_cols in atom_unnests:
                    scan = Unnest(scan, set_col, elem_cols)
                tree = scan if tree is None else _join_or_cross(tree, scan)
                progress = True
            elif isinstance(lit, Negation):
                if tree is None:
                    deferred.append(lit)
                    continue
                sub_sel: List[Tuple[str, str, object]] = []
                sub_un: List[Tuple[str, Tuple[str, ...]]] = []
                kind = "edb" if lit.atom.pred in program.edb else (
                    "view" if view_producers.get(lit.atom.pred) == "view" else "state"
                )
                right = _atom_scan(lit.atom, kind, sub_sel, sub_un)
                keys = tuple(
                    c for c in tree.schema() if c in right.schema()
                )
                if not keys:
                    raise TranslationError(
                        f"negation without shared variables in {rule.label!r}"
                    )
                tree = AntiJoin(tree, right, keys)
                progress = True
            elif isinstance(lit, FunctionAtom):
                bound = tree.schema() if tree is not None else ()
                in_cols = []
                ok = True
                for t in lit.inputs:
                    if isinstance(t, Var):
                        if t.name in bound or t.name == "J":
                            in_cols.append(t.name)
                        else:
                            ok = False
                            break
                    elif isinstance(t, Const):
                        in_cols.append(f"lit:{t.value!r}")
                    else:
                        ok = False
                        break
                if not ok:
                    deferred.append(lit)
                    continue
                out_cols = tuple(
                    _var_name(t, f"output of {lit.fn}") for t in lit.outputs
                )
                if tree is None:
                    # Zero-input UDF (init_model): a singleton generator.
                    tree = Apply(lit.fn, ScanEDB("__unit__", ()), (), out_cols)
                else:
                    tree = Apply(lit.fn, tree, tuple(in_cols), out_cols)
                progress = True
            elif isinstance(lit, Comparison):
                bound = tree.schema() if tree is not None else ()

                def resolved(t):
                    if isinstance(t, Var):
                        return t.name if t.name in bound else None
                    return t  # Const

                lhs, rhs = resolved(lit.lhs), resolved(lit.rhs)
                if lhs is None or rhs is None:
                    deferred.append(lit)
                    continue
                tree = Select(tree, lit.op, lhs, rhs)
                progress = True
            else:
                raise TranslationError(f"unsupported literal {lit!r}")
        pending = deferred
    if pending:
        raise TranslationError(
            f"rule {rule.label or rule!r}: could not bind literals {pending!r}"
        )
    if tree is None:
        raise TranslationError(f"rule {rule.label or rule!r} has empty body")

    # Duplicate-variable / constant selections collected from scans.
    for lhs, op, rhs in selections:
        tree = Select(tree, op, lhs, rhs)

    # Head construction.
    head = rule.head
    head_t = head.args[0] if head.temporal else None
    aggs = rule.head_aggregates()
    plain_terms = [
        t for t in (head.data_args if head.temporal else head.args)
        if not isinstance(t, AggExpr)
    ]
    if aggs:
        if len(aggs) != 1:
            raise TranslationError("at most one head aggregate is supported")
        agg = aggs[0]
        keys = tuple(_var_name(t, "group key") for t in plain_terms)
        tree = GroupBy(tree, keys, agg.agg, agg.var.name, agg.var.name)
    else:
        out_cols: List[str] = []
        for i, t in enumerate(plain_terms):
            if isinstance(t, Var):
                out_cols.append(t.name)
            elif isinstance(t, Const):
                col = f"const${i}"
                tree = Extend(tree, col, t.value)
                out_cols.append(col)
            else:
                raise TranslationError(f"unsupported head term {t!r}")
        tree = Project(tuple(out_cols), tree)

    next_state = isinstance(head_t, TempSucc)
    return RuleDataflow(rule.label or "?", head.pred, tree, next_state=next_state)


# ---------------------------------------------------------------------------
# Semi-naive rewrite (delta-frontier evaluation)
# ---------------------------------------------------------------------------


def _rewrite_ops(op: LogicalOp, fn) -> LogicalOp:
    """Bottom-up rewrite over the operator tree (frozen dataclasses)."""

    import dataclasses as _dc

    changes = {}
    for f in _dc.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, LogicalOp):
            new = _rewrite_ops(v, fn)
            if new is not v:
                changes[f.name] = new
        elif isinstance(v, tuple) and v and all(
            isinstance(x, LogicalOp) for x in v
        ):
            new_t = tuple(_rewrite_ops(x, fn) for x in v)
            if any(a is not b for a, b in zip(new_t, v)):
                changes[f.name] = new_t
    if changes:
        op = _dc.replace(op, **changes)
    return fn(op)


#: Public bottom-up rewriter over operator trees — the primitive that
#: :mod:`repro_torch.core.rewrite` (the optimizer pass) and the semi-naive delta
#: rewrite below are both built on.
rewrite_ops = _rewrite_ops


def semi_naive_rewrite(
    plan: LogicalPlan, program: Program
) -> Tuple[LogicalPlan, Tuple[str, ...]]:
    """Rewrite eligible per-iteration rules to read delta frontiers.

    For every body rule that :func:`~repro_torch.core.stratify.delta_rewritable_rules`
    proves safe, replace its :class:`ScanState` reads of carried recursive
    predicates with :class:`Delta` reads (Δpred@J).  Returns the rewritten
    plan plus planner notes naming each applied rewrite, e.g.
    ``semi-naive(L3: send -> Δsend)`` — the notes surface in
    ``PregelPhysicalPlan.explain()`` and are asserted by tests.
    """

    eligible = stratify.delta_rewritable_rules(program)
    carried = frozenset(plan.carried)
    notes: List[str] = []
    new_body: List[RuleDataflow] = []
    for df in plan.body:
        if df.label not in eligible:
            new_body.append(df)
            continue
        swapped: List[str] = []

        def swap(op: LogicalOp) -> LogicalOp:
            if isinstance(op, ScanState) and op.relation in carried:
                swapped.append(op.relation)
                return Delta(op.relation, op.columns)
            return op

        new_op = _rewrite_ops(df.op, swap)
        if swapped:
            notes.append(
                f"semi-naive({df.label}: "
                + ", ".join(f"{r} -> Δ{r}" for r in dict.fromkeys(swapped))
                + ")"
            )
            df = RuleDataflow(df.label, df.target, new_op, df.next_state)
        new_body.append(df)
    new_plan = LogicalPlan(
        name=plan.name,
        init=plan.init,
        body=tuple(new_body),
        carried=plan.carried,
    )
    return new_plan, tuple(notes)


def translate(program: Program) -> LogicalPlan:
    """Translate an XY-stratified program into its iterative logical plan."""

    schedule = stratify.iteration_schedule(program)
    frontier_preds = stratify.frontier_predicates(program)

    init: List[RuleDataflow] = []
    view_producers: Dict[str, str] = {}
    for rule in schedule.init_rules:
        init.append(
            _translate_rule(rule, program, {}, frontier_preds, is_init=True)
        )

    body: List[RuleDataflow] = []
    produced_this_iter: Dict[str, str] = {}
    for rule in schedule.body_rules:
        df = _translate_rule(
            rule, program, produced_this_iter, frontier_preds, is_init=False
        )
        body.append(df)
        cls = schedule.rule_classes.get(rule.label, "")
        if not df.next_state:
            produced_this_iter[rule.head.pred] = "view"

    return LogicalPlan(
        name=program.name,
        init=tuple(init),
        body=tuple(body),
        carried=schedule.carried,
    )
