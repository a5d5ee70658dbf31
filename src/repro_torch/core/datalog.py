"""Datalog intermediate representation.

This module implements the declarative core of the paper: a Datalog AST rich
enough to express the two programming-model encodings of Section 3 —

* Listing 1: the Pregel programming model (local models / graph analytics),
* Listing 2: Iterative Map-Reduce-Update (global models / convex optimization),

plus arbitrary user programs for tests.  The dialect matches the paper:

* **Extensional predicates** (EDB) map to existing relations.
* **Intensional predicates** (IDB) are rule heads (views).
* **Function predicates** wrap UDFs: the first ``n_in`` arguments are inputs,
  the rest bind outputs (Section 3, "function predicate" convention).
* **Aggregation in the head**: ``p(Y, agg<Z>) :- body`` groups by the plain
  head variables and folds ``Z`` with a commutative/associative aggregate
  (``reduce``/``combine`` are themselves UDF aggregates in the paper).
* **Set-valued variables + unnesting**: ``send(J+1, Id, M) :- superstep(J, _,
  _, {(Id, M)})`` iterates members of a set attribute (rule L8).
* **Temporal argument**: every recursive predicate carries a distinguished
  first argument ranging over a discrete monotone time domain; rules reference
  ``J`` or ``J+1`` only.  This is what makes the programs XY-stratifiable
  (Appendix B) and is checked in :mod:`repro_torch.core.stratify`.

The AST is deliberately plain (frozen dataclasses, no magic) so that the
stratifier and the algebra translator can pattern-match on it.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Var",
    "Const",
    "TempVar",
    "TempSucc",
    "TempZero",
    "Term",
    "TemporalTerm",
    "SetTerm",
    "Atom",
    "FunctionAtom",
    "Comparison",
    "Negation",
    "AggExpr",
    "Rule",
    "UDF",
    "Aggregate",
    "Program",
    "fresh_var",
]


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Var:
    """A logic variable, e.g. ``Id`` or ``State``.

    The anonymous variable ``_`` is modelled as a Var with a unique generated
    name (see :func:`fresh_var`), matching standard Datalog semantics where
    every ``_`` is distinct.
    """

    name: str

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return self.name


@dataclass(frozen=True)
class Const:
    """A constant term (number, string, or sentinel such as ACTIVATION_MSG)."""

    value: object

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{self.value!r}"


@dataclass(frozen=True)
class TempVar:
    """The temporal argument referencing the *current* state, e.g. ``J``."""

    name: str = "J"

    def __repr__(self) -> str:  # pragma: no cover
        return self.name


@dataclass(frozen=True)
class TempSucc:
    """The temporal argument referencing the *successor* state, ``J+1``."""

    name: str = "J"

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.name}+1"


@dataclass(frozen=True)
class TempZero:
    """The temporal constant ``0`` (initialization rules L1/L2/G1)."""

    def __repr__(self) -> str:  # pragma: no cover
        return "0"


Term = object  # Var | Const | TempVar | TempSucc | TempZero | SetTerm
TemporalTerm = (TempVar, TempSucc, TempZero)


@dataclass(frozen=True)
class SetTerm:
    """A set-valued pattern ``{(Id, M)}`` that unnests a set attribute.

    ``elem`` is the tuple of variables bound to each member of the set
    (rule L8 in the paper binds ``(Id, M)`` to every outbound message).
    """

    elem: Tuple[Var, ...]

    def __repr__(self) -> str:  # pragma: no cover
        inner = ", ".join(v.name for v in self.elem)
        return "{(" + inner + ")}"


_fresh_counter = itertools.count()


def fresh_var(prefix: str = "_") -> Var:
    """Generate a unique anonymous variable (each ``_`` is distinct)."""

    return Var(f"{prefix}#{next(_fresh_counter)}")


# ---------------------------------------------------------------------------
# Body literals
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Atom:
    """A predicate atom ``p(t1, ..., tn)``.

    ``temporal`` marks whether argument 0 is the distinguished temporal
    argument (true for every recursive predicate in the paper's listings).
    """

    pred: str
    args: Tuple[Term, ...]
    temporal: bool = False

    @property
    def temporal_arg(self) -> Optional[Term]:
        return self.args[0] if self.temporal and self.args else None

    @property
    def data_args(self) -> Tuple[Term, ...]:
        return self.args[1:] if self.temporal else self.args

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.pred}({', '.join(map(repr, self.args))})"


@dataclass(frozen=True)
class FunctionAtom:
    """A function predicate ``f(in..., out...)`` wrapping a UDF.

    Per the paper's convention the first ``n_in`` arguments are the inputs and
    the remaining arguments bind the outputs of applying ``f``.  Examples:
    ``init_vertex(Id, Datum, State)`` (2 in / 1 out), ``update(J, Id, InState,
    InMsgs, OutState, OutMsgs)`` (4 in / 2 out), ``map(M, R, S)`` (2 in / 1
    out).
    """

    fn: str
    args: Tuple[Term, ...]
    n_in: int

    @property
    def inputs(self) -> Tuple[Term, ...]:
        return self.args[: self.n_in]

    @property
    def outputs(self) -> Tuple[Term, ...]:
        return self.args[self.n_in:]

    def __repr__(self) -> str:  # pragma: no cover
        ins = ", ".join(map(repr, self.inputs))
        outs = ", ".join(map(repr, self.outputs))
        return f"{self.fn}({ins} -> {outs})"


@dataclass(frozen=True)
class Comparison:
    """A built-in comparison literal, e.g. ``M != NewM`` or ``State != null``.

    ``op`` is one of ``==, !=, <, <=, >, >=``.  Either side may be a Var or a
    Const.  Comparisons act as selections in the logical plan.
    """

    op: str
    lhs: Term
    rhs: Term

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.lhs!r} {self.op} {self.rhs!r}"


@dataclass(frozen=True)
class Negation:
    """A negated goal ``not p(...)``.

    The paper's listings only use negation implicitly (through aggregation and
    the convergence test), but the stratifier supports explicit negation so
    that generic Datalog programs can be checked.
    """

    atom: Atom

    def __repr__(self) -> str:  # pragma: no cover
        return f"not {self.atom!r}"


BodyLiteral = object  # Atom | FunctionAtom | Comparison | Negation


# ---------------------------------------------------------------------------
# Head aggregation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AggExpr:
    """A head aggregate ``agg<Z>`` (e.g. ``combine<Msg>``, ``reduce<S>``,
    ``max<J>``).

    ``agg`` names a registered :class:`Aggregate`; ``var`` is the aggregated
    body variable.  All plain head terms form the group-by key (group-all when
    there are none, as in rule G2's global reduce).
    """

    agg: str
    var: Var

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.agg}<{self.var!r}>"


# ---------------------------------------------------------------------------
# Rules and programs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    """A Datalog rule ``head :- body``.

    ``label`` is a human-readable tag (``"L6"``, ``"G2"``) used in plans,
    error messages, and golden tests against the paper's listings.

    ``frontier`` marks the paper's "most recent state" view rules (L4/L5):
    their heads carry no temporal argument, and they select the latest
    materialized version of a recursive predicate via ``max`` aggregation
    over the temporal argument.  Appendix B (Figure 10) treats them as
    ordinary X-stratum members of the residual program (``new_local`` is
    derived from ``new_vertex``), which is exactly how the stratifier and
    runtime handle them: under XY evaluation the carried frontier *is* the
    most recent state, so these rules read the frontier directly.
    """

    head: Atom
    body: Tuple[BodyLiteral, ...]
    label: str = ""
    frontier: bool = False

    def body_atoms(self) -> Tuple[Atom, ...]:
        return tuple(l for l in self.body if isinstance(l, Atom))

    def body_functions(self) -> Tuple[FunctionAtom, ...]:
        return tuple(l for l in self.body if isinstance(l, FunctionAtom))

    def body_negations(self) -> Tuple[Negation, ...]:
        return tuple(l for l in self.body if isinstance(l, Negation))

    def body_comparisons(self) -> Tuple[Comparison, ...]:
        return tuple(l for l in self.body if isinstance(l, Comparison))

    def head_aggregates(self) -> Tuple[AggExpr, ...]:
        return tuple(t for t in self.head.args if isinstance(t, AggExpr))

    def has_aggregation(self) -> bool:
        return bool(self.head_aggregates())

    def __repr__(self) -> str:  # pragma: no cover
        body = ", ".join(map(repr, self.body))
        tag = f"{self.label}: " if self.label else ""
        return f"{tag}{self.head!r} :- {body}."


@dataclass(frozen=True)
class UDF:
    """A registered user-defined function for function predicates.

    ``fn`` maps ``n_in`` positional inputs to a tuple of ``n_out`` outputs
    (a 1-tuple is unwrapped by callers when convenient).  UDFs are opaque to
    the logical layer; the physical layer calls them on torch tensors.
    """

    name: str
    fn: Callable
    n_in: int
    n_out: int


@dataclass(frozen=True)
class Aggregate:
    """A commutative/associative aggregate usable in rule heads.

    ``zero`` is the identity element factory and ``combine`` folds two partial
    aggregates.  Commutativity + associativity is exactly the property the
    paper's planner exploits for early (sender-side) aggregation, and what the
    property-based tests verify for every registered aggregate.

    ``idempotent`` marks combines where ``combine(x, x) == x`` (max/min):
    re-delivering an old contribution cannot change the aggregate, so rules
    folding with it may read the *delta* frontier (only changed facts) instead
    of the full frontier — the semi-naive rewrite of classic Datalog
    evaluation.  ``recomputable`` marks combines whose aggregate is rebuilt
    from scratch every iteration by the executing plan (Pregel's per-superstep
    inboxes: ``collect``@J is derived solely from ``send``@J, never folded
    into ``collect``@J-1), which makes delta reads safe even for
    non-idempotent combines like ``sum``.  Both default False: delta safety
    is a soundness claim, so front-ends must opt in explicitly — an
    unannotated aggregate keeps the full (naive) read.
    """

    name: str
    zero: Callable
    combine: Callable[[object, object], object]
    # Optional element->accumulator lift (defaults to identity).
    lift: Optional[Callable] = None
    idempotent: bool = False
    recomputable: bool = False

    @property
    def delta_safe(self) -> bool:
        """True when rules aggregating with this combine may read the delta
        frontier (semi-naive evaluation) without changing the fixpoint."""

        return self.idempotent or self.recomputable


@dataclass
class Program:
    """A Datalog program: rules + EDB schema + UDF/aggregate registry."""

    rules: Sequence[Rule]
    edb: Mapping[str, int] = field(default_factory=dict)  # name -> arity
    udfs: Mapping[str, UDF] = field(default_factory=dict)
    aggregates: Mapping[str, Aggregate] = field(default_factory=dict)
    name: str = "program"

    # -- classification ----------------------------------------------------

    def idb_predicates(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(r.head.pred for r in self.rules))

    def edb_predicates(self) -> Tuple[str, ...]:
        return tuple(self.edb)

    def rules_for(self, pred: str) -> Tuple[Rule, ...]:
        return tuple(r for r in self.rules if r.head.pred == pred)

    def is_recursive_pred(self, pred: str) -> bool:
        """A predicate is recursive if it participates in a dependency cycle."""

        from repro_torch.core import stratify  # local import to avoid cycle

        return pred in stratify.recursive_predicates(self)

    def validate(self) -> None:
        """Sanity-check arities, UDF references, and aggregate references."""

        arities: dict[str, int] = dict(self.edb)
        for rule in self.rules:
            pred = rule.head.pred
            arity = len(rule.head.args)
            if pred in arities and arities[pred] != arity:
                raise ValueError(
                    f"{self.name}: predicate {pred!r} used with arity "
                    f"{arity} and {arities[pred]}"
                )
            arities.setdefault(pred, arity)
        for rule in self.rules:
            for lit in rule.body:
                if isinstance(lit, Atom):
                    arity = len(lit.args)
                    if lit.pred in arities and arities[lit.pred] != arity:
                        raise ValueError(
                            f"{self.name}: predicate {lit.pred!r} used with "
                            f"arity {arity} and {arities[lit.pred]} "
                            f"(rule {rule.label or rule})"
                        )
                    arities.setdefault(lit.pred, arity)
                elif isinstance(lit, FunctionAtom):
                    udf = self.udfs.get(lit.fn)
                    if udf is None:
                        raise ValueError(
                            f"{self.name}: unregistered UDF {lit.fn!r} "
                            f"(rule {rule.label or rule})"
                        )
                    if len(lit.args) != udf.n_in + udf.n_out:
                        raise ValueError(
                            f"{self.name}: UDF {lit.fn!r} expects "
                            f"{udf.n_in}+{udf.n_out} args, got {len(lit.args)}"
                        )
                    if lit.n_in != udf.n_in:
                        raise ValueError(
                            f"{self.name}: UDF {lit.fn!r} arity split mismatch"
                        )
            for agg in rule.head_aggregates():
                if agg.agg not in self.aggregates:
                    raise ValueError(
                        f"{self.name}: unregistered aggregate {agg.agg!r} "
                        f"(rule {rule.label or rule})"
                    )

    # -- convenience -------------------------------------------------------

    def pretty(self) -> str:
        lines = [f"% program {self.name}"]
        for rule in self.rules:
            lines.append(repr(rule))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Helpers used by the stratifier
# ---------------------------------------------------------------------------


def rule_body_predicates(rule: Rule) -> Iterable[Tuple[str, bool, bool]]:
    """Yield ``(pred, negated, through_aggregation)`` per body dependency.

    A head with aggregation makes *every* positive body dependency an
    aggregation edge (the head only sees folded values), which is how
    stratification treats aggregates — like negation, they require the source
    stratum to be fully evaluated first [Zaniolo et al. 1993].
    """

    aggregated = rule.has_aggregation()
    for lit in rule.body:
        if isinstance(lit, Atom):
            yield lit.pred, False, aggregated
        elif isinstance(lit, Negation):
            yield lit.atom.pred, True, aggregated


def substitute(term: Term, env: Mapping[Var, Term]) -> Term:
    """Substitute variables in a term using ``env`` (used by the evaluator)."""

    if isinstance(term, Var):
        return env.get(term, term)
    return term
