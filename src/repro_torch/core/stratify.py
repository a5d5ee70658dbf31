"""Stratification and XY-stratification (paper Appendix B).

Implements the semantic machinery that makes the paper's recursive programs
well-defined:

1. **Ordinary stratification** — partition predicates into strata such that
   negated/aggregated dependencies strictly increase the stratum.  Fails on
   the paper's listings (cycles through aggregation), motivating:

2. **XY-stratification** [Zaniolo, Arni, Ong 1993] — Definition 2 of the
   paper.  Every recursive predicate carries a distinguished temporal
   argument; every recursive rule is an *X-rule* (all temporal args = ``J``)
   or a *Y-rule* (head = ``J+1``, some positive goal = ``J``, the rest ``J``
   or ``J+1``).

3. The **new_/old_ construction** (Appendix B.1): rename recursive predicates
   sharing the head's temporal argument to ``new_p``, all others to
   ``old_p``, drop temporal arguments, and check that the residual program is
   stratified.  If so, the original program is locally stratified (Theorems
   2–3) and its fixpoint is computed by an initialization stratum followed by
   per-iteration rule firings — the *iteration schedule* consumed by the
   algebra translator and the fixpoint driver.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.datalog import (
    Atom,
    Comparison,
    FunctionAtom,
    Negation,
    Program,
    Rule,
    TempSucc,
    TempVar,
    TempZero,
    rule_body_predicates,
)

__all__ = [
    "DependencyGraph",
    "dependency_graph",
    "recursive_predicates",
    "stratify",
    "StratificationError",
    "XYError",
    "classify_rule",
    "xy_validate",
    "xy_transform",
    "IterationSchedule",
    "iteration_schedule",
    "delta_rewritable_rules",
    "fixpoint_phases",
]


class StratificationError(Exception):
    """The program cannot be (ordinarily) stratified."""


class XYError(Exception):
    """The program violates the XY-stratification conditions."""


# ---------------------------------------------------------------------------
# Dependency graph + SCCs
# ---------------------------------------------------------------------------


@dataclass
class DependencyGraph:
    """Predicate-level rule/goal graph with edge polarity.

    ``edges[p]`` holds ``(q, negated_or_aggregated)`` for every body
    dependency of a rule defining ``p``.
    """

    nodes: Tuple[str, ...]
    edges: Dict[str, List[Tuple[str, bool]]] = field(default_factory=dict)

    def successors(self, p: str) -> List[Tuple[str, bool]]:
        return self.edges.get(p, [])


def dependency_graph(program: Program) -> DependencyGraph:
    nodes = list(dict.fromkeys(
        list(program.edb) + [r.head.pred for r in program.rules]
    ))
    edges: Dict[str, List[Tuple[str, bool]]] = {}
    for rule in program.rules:
        head = rule.head.pred
        for pred, negated, through_agg in rule_body_predicates(rule):
            edges.setdefault(head, []).append((pred, negated or through_agg))
            if pred not in nodes:
                nodes.append(pred)
    return DependencyGraph(tuple(nodes), edges)


def _sccs(graph: DependencyGraph) -> List[FrozenSet[str]]:
    """Tarjan's strongly-connected components (iterative)."""

    index: Dict[str, int] = {}
    lowlink: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    result: List[FrozenSet[str]] = []
    counter = [0]

    for root in graph.nodes:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, child_i = work[-1]
            if child_i == 0:
                index[node] = lowlink[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            recurse = False
            succs = graph.successors(node)
            for i in range(child_i, len(succs)):
                succ, _ = succs[i]
                if succ not in index:
                    work[-1] = (node, i + 1)
                    work.append((succ, 0))
                    recurse = True
                    break
                elif on_stack.get(succ):
                    lowlink[node] = min(lowlink[node], index[succ])
            if recurse:
                continue
            if lowlink[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                result.append(frozenset(comp))
            work.pop()
            if work:
                parent, _ = work[-1]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
    return result


def recursive_predicates(program: Program) -> FrozenSet[str]:
    """Predicates participating in a dependency cycle (incl. self-loops)."""

    graph = dependency_graph(program)
    recursive: set[str] = set()
    for comp in _sccs(graph):
        if len(comp) > 1:
            recursive |= comp
        else:
            (p,) = comp
            if any(q == p for q, _ in graph.successors(p)):
                recursive.add(p)
    return frozenset(recursive)


# ---------------------------------------------------------------------------
# Ordinary stratification
# ---------------------------------------------------------------------------


def stratify(program: Program) -> Dict[str, int]:
    """Assign strata; raise :class:`StratificationError` on negative cycles.

    Uses the classic iterate-to-fixpoint algorithm: stratum(p) >= stratum(q)
    for positive edges, > for negative/aggregated edges; a predicate pushed
    past ``len(nodes)`` proves a cycle through negation/aggregation.
    """

    graph = dependency_graph(program)
    strata = {p: 0 for p in graph.nodes}
    n = len(graph.nodes)
    changed = True
    while changed:
        changed = False
        for rule in program.rules:
            head = rule.head.pred
            for pred, negated, through_agg in rule_body_predicates(rule):
                need = strata[pred] + (1 if (negated or through_agg) else 0)
                if strata[head] < need:
                    strata[head] = need
                    if strata[head] > n:
                        raise StratificationError(
                            f"{program.name}: cycle through "
                            f"negation/aggregation at {head!r}"
                        )
                    changed = True
    return strata


# ---------------------------------------------------------------------------
# XY-stratification (Definition 2)
# ---------------------------------------------------------------------------


def _temporal_of(atom: Atom):
    if not atom.temporal:
        return None
    return atom.args[0]


def classify_rule(
    rule: Rule,
    recursive: FrozenSet[str],
    frontier_preds: FrozenSet[str] = frozenset(),
) -> str:
    """Classify a rule as ``"base"``, ``"x"``, ``"y"``, or ``"frontier"``.

    * base — head not recursive, or the head's temporal argument is the
      constant 0 (initialization rules L1/L2/G1).
    * X-rule — every recursive predicate's temporal argument is the current
      state ``J``.
    * Y-rule — head temporal argument is ``J+1``; at least one positive goal
      at ``J``; remaining recursive goals at ``J`` or ``J+1``.
    * frontier — the paper's L4/L5 "most recent state" rules: non-temporal
      head selecting the latest version via ``max`` over the temporal
      argument.  They behave as X-stratum rules (Appendix B, Figure 10).
    """

    if rule.frontier:
        # Frontier rules may only read recursive goals at the current state
        # or other frontier predicates; they never derive future facts.
        for lit in rule.body:
            atom = lit.atom if isinstance(lit, Negation) else lit
            if isinstance(atom, Atom) and atom.pred in recursive:
                t = _temporal_of(atom)
                if t is not None and not isinstance(t, TempVar):
                    raise XYError(
                        f"frontier rule {rule.label or rule!r} reads "
                        f"non-current state of {atom.pred!r}"
                    )
        return "frontier"

    head_t = _temporal_of(rule.head)
    if rule.head.pred not in recursive or head_t is None:
        return "base"
    if isinstance(head_t, TempZero):
        return "base"

    body_temporals = []
    for lit in rule.body:
        atom = lit.atom if isinstance(lit, Negation) else lit
        if isinstance(atom, Atom) and atom.pred in recursive:
            if atom.pred in frontier_preds:
                continue  # frontier views are implicitly current-state
            t = _temporal_of(atom)
            if t is None:
                raise XYError(
                    f"recursive predicate {atom.pred!r} lacks a temporal "
                    f"argument in rule {rule.label or rule!r}"
                )
            body_temporals.append((atom, t, isinstance(lit, Negation)))

    if isinstance(head_t, TempVar):
        # X-rule: all recursive goals must reference the current state J.
        for atom, t, _ in body_temporals:
            if not isinstance(t, TempVar):
                raise XYError(
                    f"X-rule {rule.label or rule!r} references non-current "
                    f"temporal state in {atom.pred!r}"
                )
        return "x"

    if isinstance(head_t, TempSucc):
        # Y-rule conditions (Definition 2).
        has_current_positive = any(
            isinstance(t, TempVar) and not negated
            for _, t, negated in body_temporals
        )
        if not has_current_positive:
            raise XYError(
                f"Y-rule {rule.label or rule!r} has no positive goal at the "
                "current temporal state"
            )
        for atom, t, _ in body_temporals:
            if not isinstance(t, (TempVar, TempSucc)):
                raise XYError(
                    f"Y-rule {rule.label or rule!r} goal {atom.pred!r} must "
                    "reference J or J+1"
                )
        return "y"

    raise XYError(
        f"rule {rule.label or rule!r} head temporal argument must be "
        "J, J+1, or 0"
    )


def frontier_predicates(program: Program) -> FrozenSet[str]:
    """Head predicates of rules marked ``frontier`` (paper's L4/L5)."""

    return frozenset(r.head.pred for r in program.rules if r.frontier)


def xy_validate(program: Program) -> Dict[str, str]:
    """Check Definition 2 for the whole program.

    Returns ``{rule_label: class}``.  Raises :class:`XYError` when any
    recursive rule is neither an X-rule nor a Y-rule (nor a declared frontier
    view), or when a recursive predicate lacks the distinguished temporal
    argument.
    """

    recursive = recursive_predicates(program)
    frontier = frontier_predicates(program)
    # Condition 1: every recursive predicate has a temporal first argument
    # (frontier views are exempt: they denote the latest materialized state).
    for rule in program.rules:
        atoms = [rule.head] + [
            l.atom if isinstance(l, Negation) else l
            for l in rule.body
            if isinstance(l, (Atom, Negation))
        ]
        for atom in atoms:
            if isinstance(atom, Atom) and atom.pred in recursive:
                if not atom.temporal and atom.pred not in frontier:
                    raise XYError(
                        f"{program.name}: recursive predicate {atom.pred!r} "
                        f"lacks temporal argument (rule {rule.label or rule!r})"
                    )
    # Condition 2: every recursive rule is an X-rule or a Y-rule.
    classes: Dict[str, str] = {}
    for i, rule in enumerate(program.rules):
        label = rule.label or f"rule{i}"
        classes[label] = classify_rule(rule, recursive, frontier)
    return classes


# ---------------------------------------------------------------------------
# new_/old_ construction (Appendix B.1) and residual stratification
# ---------------------------------------------------------------------------


def _strip_temporal(atom: Atom, prefix: str) -> Atom:
    return Atom(prefix + atom.pred, atom.args[1:], temporal=False)


def xy_transform(program: Program) -> Program:
    """Apply the paper's construction: rename recursive predicates sharing the
    head's temporal argument to ``new_*``, others to ``old_*``, and drop the
    temporal arguments.  The original program is locally stratified iff the
    result is stratified (Theorems 2 and 3).

    Frontier rules (L4/L5) are renamed entirely into the ``new_`` stratum,
    matching Figure 10 of the paper (``new_local`` derived from
    ``new_vertex``).
    """

    recursive = recursive_predicates(program)
    frontier = frontier_predicates(program)
    new_rules: List[Rule] = []
    for rule in program.rules:
        head = rule.head
        head_t = _temporal_of(head)
        if head.pred not in recursive or (head_t is None and not rule.frontier):
            new_rules.append(rule)
            continue

        def rename(atom: Atom) -> Atom:
            if atom.pred not in recursive:
                return atom
            if atom.pred in frontier:
                return Atom("new_" + atom.pred, atom.args, temporal=False)
            if not atom.temporal:
                return atom
            t = _temporal_of(atom)
            if rule.frontier or isinstance(head_t, (TempVar, TempZero)):
                # X/frontier/base rules reason within the current state:
                # current-state goals are new_, nothing is older.
                same = isinstance(t, (TempVar, TempZero))
            else:
                # Y-rules: goals at J+1 share the head's successor state;
                # goals at J reference the closed (old) state.
                same = isinstance(t, TempSucc)
            return _strip_temporal(atom, "new_" if same else "old_")

        if rule.frontier:
            new_head = Atom("new_" + head.pred, head.args, temporal=False)
        else:
            new_head = _strip_temporal(head, "new_")
        body: List[object] = []
        for lit in rule.body:
            if isinstance(lit, Atom):
                body.append(rename(lit))
            elif isinstance(lit, Negation):
                body.append(Negation(rename(lit.atom)))
            else:
                body.append(lit)
        new_rules.append(
            Rule(new_head, tuple(body), label=rule.label, frontier=rule.frontier)
        )

    edb = dict(program.edb)
    # old_* predicates act as EDB in the residual program (prior iteration).
    for rule in new_rules:
        for lit in rule.body:
            atom = lit.atom if isinstance(lit, Negation) else lit
            if isinstance(atom, Atom) and atom.pred.startswith("old_"):
                edb.setdefault(atom.pred, len(atom.args))
    return Program(
        rules=new_rules,
        edb=edb,
        udfs=program.udfs,
        aggregates=program.aggregates,
        name=program.name + "::xy",
    )


# ---------------------------------------------------------------------------
# Sequential fixpoint phases (multi-stratum programs)
# ---------------------------------------------------------------------------


def fixpoint_phases(program: Program) -> Tuple[Tuple[str, ...], ...]:
    """Recursive-predicate groups in sequential evaluation order.

    The recursive predicates of a multi-stratum program partition into the
    strongly-connected components of the dependency graph; a component that
    (transitively) depends on another must see that component's *converged*
    fixpoint, so the components execute as **sequential fixpoint phases** in
    topological order — e.g. a PageRank stratum runs to convergence before a
    downstream reachability stratum that reads its thresholded result.

    Tarjan's algorithm (see :func:`_sccs`) emits a component only after
    every component it depends on, so the emission order *is* the phase
    order.  Single-phase programs (the paper's Listings 1/2, transitive
    closure, ...) return one group; non-recursive predicates belong to no
    phase — the executor schedules their rules around the phases by the
    deepest phase they read.
    """

    recursive = recursive_predicates(program)
    graph = dependency_graph(program)
    phases: List[Tuple[str, ...]] = []
    for comp in _sccs(graph):
        members = tuple(sorted(p for p in comp if p in recursive))
        if members:
            phases.append(members)
    return tuple(phases)


# ---------------------------------------------------------------------------
# Semi-naive (delta-frontier) rule classification
# ---------------------------------------------------------------------------


def delta_rewritable_rules(program: Program) -> FrozenSet[str]:
    """Labels of per-iteration rules whose recursive body reads may be
    restricted to the *delta* frontier (semi-naive evaluation).

    A rule qualifies when all of the following hold:

    * it is an X- or Y-rule (per-iteration stratum — init rules run once and
      frontier views must stay full reads of the materialized state);
    * it reads *exactly one* recursive predicate at the current state ``J``
      (there is a frontier to restrict, and restricting it is sound:
      :func:`~repro_torch.core.algebra.semi_naive_rewrite` swaps every carried
      recursive read in the rule to its delta, which for a rule joining two
      or more recursive reads would drop the changed×unchanged derivation
      pairs — that needs the classic delta-union expansion
      ``Δa ⋈ b ∪ a ⋈ Δb``, which is not implemented, so such rules keep
      their full reads);
    * it folds its derivations through a head aggregate, and every such
      aggregate is *delta-safe*: idempotent (``combine(x, x) == x``, so
      re-deliveries from stale frontiers are absorbed — max/min) or
      recomputed from scratch every iteration (Pregel's per-superstep
      ``collect``) — see :class:`~repro_torch.core.datalog.Aggregate.delta_safe`.

    Rules that project recursive reads without aggregation must keep the full
    read: dropping unchanged facts there would shrink the derived relation
    itself, not just skip redundant re-derivations.

    The result is matched against :class:`~repro_torch.core.algebra.RuleDataflow`
    labels by :func:`~repro_torch.core.algebra.semi_naive_rewrite`, so the
    classification fails closed on anything label-matching cannot address
    precisely: unlabeled rules are never eligible, a label shared by several
    rules is eligible only if *every* bearer qualifies, and an aggregate name
    missing from ``program.aggregates`` disqualifies its rule.
    """

    recursive = recursive_predicates(program)
    frontier = frontier_predicates(program)
    qualifying: set[str] = set()
    disqualified: set[str] = set()
    for rule in program.rules:
        label = rule.label
        if not label:
            continue

        def _qualifies() -> bool:
            cls = classify_rule(rule, recursive, frontier)
            if cls not in ("x", "y"):
                return False
            aggs = rule.head_aggregates()
            if not aggs:
                return False
            if not all(
                a.agg in program.aggregates
                and program.aggregates[a.agg].delta_safe
                for a in aggs
            ):
                return False
            carried_reads = sum(
                1
                for lit in rule.body
                if isinstance(lit, Atom)
                and lit.pred in recursive
                and lit.pred not in frontier
                and isinstance(lit.temporal_arg, TempVar)
            )
            return carried_reads == 1

        if _qualifies():
            qualifying.add(label)
        else:
            disqualified.add(label)
    return frozenset(qualifying - disqualified)


# ---------------------------------------------------------------------------
# Iteration schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IterationSchedule:
    """The executable decomposition of an XY-stratified program.

    ``init_rules`` fire once at J=0; ``body_rules`` fire every iteration in
    stratum order (X-rules before the Y-rules they feed — e.g. Pregel's
    L3..L8 ordering from Section 3.3); ``carried`` lists the recursive
    predicates whose frontier is carried across iterations (the loop state).
    """

    init_rules: Tuple[Rule, ...]
    body_rules: Tuple[Rule, ...]
    carried: Tuple[str, ...]
    rule_classes: Mapping[str, str]
    residual_strata: Mapping[str, int]


def _topo_order_body_rules(
    body_rules: List[Rule], frontier: FrozenSet[str]
) -> List[Rule]:
    """Order per-iteration rules by intra-iteration data dependencies.

    Rule B depends on rule A when B's body references A's head predicate *at
    the current state* — references to ``J+1`` heads come from the previous
    iteration and do not constrain the order.  Frontier predicates are
    current-state by construction.  This reproduces the paper's firing order
    (L3, L4, L5, L6, L7, L8 / G2, G3) from first principles.
    """

    producers: Dict[str, List[int]] = {}
    for i, rule in enumerate(body_rules):
        head = rule.head
        if rule.frontier or isinstance(_temporal_of(head), TempVar):
            producers.setdefault(head.pred, []).append(i)

    deps: Dict[int, set] = {i: set() for i in range(len(body_rules))}
    for i, rule in enumerate(body_rules):
        for lit in rule.body:
            atom = lit.atom if isinstance(lit, Negation) else lit
            if not isinstance(atom, Atom):
                continue
            t = _temporal_of(atom)
            current = isinstance(t, TempVar) or (
                t is None and atom.pred in frontier
            )
            if current:
                for j in producers.get(atom.pred, []):
                    if j != i:
                        deps[i].add(j)

    # Kahn's algorithm, stable (prefer original order).
    order: List[int] = []
    remaining = set(range(len(body_rules)))
    while remaining:
        ready = sorted(i for i in remaining if deps[i] <= set(order))
        if not ready:
            labels = [body_rules[i].label or str(i) for i in sorted(remaining)]
            raise XYError(
                "cyclic intra-iteration dependency among rules: "
                + ", ".join(labels)
            )
        for i in ready:
            order.append(i)
            remaining.discard(i)
    return [body_rules[i] for i in order]


def iteration_schedule(program: Program) -> IterationSchedule:
    """Validate XY-stratification and derive the iteration schedule.

    This is "Theorem 1 as code": it (a) proves membership in the XY class via
    :func:`xy_validate`, (b) proves local stratifiability by stratifying the
    new_/old_ residual program, and (c) orders the per-iteration rules by
    intra-iteration data dependencies, yielding exactly the paper's
    L3..L8 / G2-G3 firing order.
    """

    program.validate()
    classes = xy_validate(program)
    residual = xy_transform(program)
    residual_strata = stratify(residual)  # raises if not stratifiable

    recursive = recursive_predicates(program)
    frontier = frontier_predicates(program)
    init_rules: List[Rule] = []
    body_rules: List[Rule] = []
    for i, rule in enumerate(program.rules):
        label = rule.label or f"rule{i}"
        if classes[label] == "base":
            init_rules.append(rule)
        else:
            body_rules.append(rule)

    body_rules = _topo_order_body_rules(body_rules, frontier)
    carried = tuple(sorted(p for p in recursive))
    return IterationSchedule(
        init_rules=tuple(init_rules),
        body_rules=tuple(body_rules),
        carried=carried,
        rule_classes=classes,
        residual_strata=residual_strata,
    )
