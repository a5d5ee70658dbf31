"""The paper's Datalog programs (Listings 1 and 2), as AST constructors.

These are the ground truth for the whole stack: the stratifier proves they
are XY-stratified (Theorem 1), the algebra translator turns them into the
Figure 2/3 logical plans, and the planner lowers those to physical plans.
UDFs are registered by name here; concrete implementations are bound by the
programming-model front-ends (:mod:`repro_torch.core.imru`, :mod:`repro_torch.core.pregel`).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

from repro_torch.core.datalog import (
    AggExpr,
    Aggregate,
    Atom,
    Comparison,
    Const,
    FunctionAtom,
    Negation,
    Program,
    Rule,
    TempSucc,
    TempVar,
    TempZero,
    SetTerm,
    UDF,
    Var,
    fresh_var,
)

__all__ = [
    "pregel_program",
    "imru_program",
    "transitive_closure_program",
    "connected_components_program",
    "same_generation_program",
    "pagerank_threshold_program",
    "negated_reach_program",
    "ACTIVATION_MSG",
    # Text-form equivalents (the Datalog frontend's ground truth)
    "PREGEL_TEXT",
    "IMRU_TEXT",
    "TRANSITIVE_CLOSURE_TEXT",
    "CONNECTED_COMPONENTS_TEXT",
    "SAME_GENERATION_TEXT",
    "NEGATED_REACH_TEXT",
    "pagerank_threshold_text",
    "parsed_pregel_program",
    "parsed_imru_program",
    "parsed_transitive_closure_program",
    "parsed_connected_components_program",
    "parsed_same_generation_program",
    "parsed_pagerank_threshold_program",
    "parsed_negated_reach_program",
]

ACTIVATION_MSG = "__ACTIVATION__"


def pregel_program(
    udfs: Optional[Mapping[str, Callable]] = None,
    aggregates: Optional[Mapping[str, Aggregate]] = None,
) -> Program:
    """Listing 1 — the Pregel programming model.

    Rules (labels match the paper):

    * L1  vertex(0, Id, State)      :- data(Id, Datum), init_vertex(Id, Datum, State).
    * L2  send(0, Id, ACTIVATION)   :- vertex(0, Id, _).
    * L3  collect(J, Id, combine<M>):- send(J, Id, M).
    * L4  maxVertexJ(Id, max<J>)    :- vertex(J, Id, State).
    * L5  local(Id, State)          :- maxVertexJ(Id, J), vertex(J, Id, State).
    * L6  superstep(J, Id, OutState, OutMsgs)
                                    :- collect(J, Id, InMsgs), local(Id, InState),
                                       update(J, Id, InState, InMsgs, OutState, OutMsgs).
    * L7  vertex(J+1, Id, State)    :- superstep(J, Id, State, _), State != null.
    * L8  send(J+1, Id, M)          :- superstep(J, _, _, {(Id, M)}).
    """

    J, Jp1, J0 = TempVar("J"), TempSucc("J"), TempZero()
    Id, Datum, State = Var("Id"), Var("Datum"), Var("State")
    Msg, InMsgs = Var("Msg"), Var("InMsgs")
    InState, OutState, OutMsgs = Var("InState"), Var("OutState"), Var("OutMsgs")
    M = Var("M")

    rules = (
        Rule(
            Atom("vertex", (J0, Id, State), temporal=True),
            (
                Atom("data", (Id, Datum)),
                FunctionAtom("init_vertex", (Id, Datum, State), n_in=2),
            ),
            label="L1",
        ),
        Rule(
            Atom("send", (J0, Id, Const(ACTIVATION_MSG)), temporal=True),
            (Atom("vertex", (J0, Id, fresh_var()), temporal=True),),
            label="L2",
        ),
        Rule(
            Atom("collect", (J, Id, AggExpr("combine", Msg)), temporal=True),
            (Atom("send", (J, Id, Msg), temporal=True),),
            label="L3",
        ),
        Rule(
            Atom("maxVertexJ", (Id, AggExpr("max", Var("J")))),
            (Atom("vertex", (J, Id, State), temporal=True),),
            label="L4",
            frontier=True,
        ),
        Rule(
            Atom("local", (Id, State)),
            (
                Atom("maxVertexJ", (Id, Var("J"))),
                Atom("vertex", (J, Id, State), temporal=True),
            ),
            label="L5",
            frontier=True,
        ),
        Rule(
            Atom("superstep", (J, Id, OutState, OutMsgs), temporal=True),
            (
                Atom("collect", (J, Id, InMsgs), temporal=True),
                Atom("local", (Id, InState)),
                FunctionAtom(
                    "update",
                    (Var("J"), Id, InState, InMsgs, OutState, OutMsgs),
                    n_in=4,
                ),
            ),
            label="L6",
        ),
        Rule(
            Atom("vertex", (Jp1, Id, State), temporal=True),
            (
                Atom("superstep", (J, Id, State, fresh_var()), temporal=True),
                Comparison("!=", State, Const(None)),
            ),
            label="L7",
        ),
        Rule(
            Atom("send", (Jp1, Id, M), temporal=True),
            (
                Atom(
                    "superstep",
                    (J, fresh_var(), fresh_var(), SetTerm((Id, M))),
                    temporal=True,
                ),
            ),
            label="L8",
        ),
    )

    udfs = dict(udfs or {})
    registry = {
        "init_vertex": UDF("init_vertex", udfs.get("init_vertex"), n_in=2, n_out=1),
        "update": UDF("update", udfs.get("update"), n_in=4, n_out=2),
    }
    aggs = dict(aggregates or {})
    aggs.setdefault(
        "max",
        Aggregate("max", zero=lambda: float("-inf"), combine=max),
    )
    if "combine" not in aggs:
        raise ValueError("Pregel program requires a 'combine' aggregate")
    return Program(
        rules=rules,
        edb={"data": 2},
        udfs=registry,
        aggregates=aggs,
        name="pregel",
    )


def imru_program(
    udfs: Optional[Mapping[str, Callable]] = None,
    aggregates: Optional[Mapping[str, Aggregate]] = None,
) -> Program:
    """Listing 2 — the Iterative Map-Reduce-Update programming model.

    * G1  model(0, M)            :- init_model(M).
    * G2  collect(J, reduce<S>)  :- model(J, M), training_data(Id, R), map(R, M, S).
    * G3  model(J+1, NewM)       :- collect(J, AggrS), model(J, M),
                                    update(J, M, AggrS, NewM), M != NewM.
    """

    J, Jp1, J0 = TempVar("J"), TempSucc("J"), TempZero()
    M, NewM, R, S, AggrS = Var("M"), Var("NewM"), Var("R"), Var("S"), Var("AggrS")
    Id = Var("Id")

    rules = (
        Rule(
            Atom("model", (J0, M), temporal=True),
            (FunctionAtom("init_model", (M,), n_in=0),),
            label="G1",
        ),
        Rule(
            Atom("collect", (J, AggExpr("reduce", S)), temporal=True),
            (
                Atom("model", (J, M), temporal=True),
                Atom("training_data", (Id, R)),
                FunctionAtom("map", (R, M, S), n_in=2),
            ),
            label="G2",
        ),
        Rule(
            Atom("model", (Jp1, NewM), temporal=True),
            (
                Atom("collect", (J, AggrS), temporal=True),
                Atom("model", (J, M), temporal=True),
                FunctionAtom("update", (Var("J"), M, AggrS, NewM), n_in=3),
                Comparison("!=", M, NewM),
            ),
            label="G3",
        ),
    )

    udfs = dict(udfs or {})
    registry = {
        "init_model": UDF("init_model", udfs.get("init_model"), n_in=0, n_out=1),
        "map": UDF("map", udfs.get("map"), n_in=2, n_out=1),
        "update": UDF("update", udfs.get("update"), n_in=3, n_out=1),
    }
    aggs = dict(aggregates or {})
    if "reduce" not in aggs:
        raise ValueError("IMRU program requires a 'reduce' aggregate")
    return Program(
        rules=rules,
        edb={"training_data": 2},
        udfs=registry,
        aggregates=aggs,
        name="imru",
    )


# ---------------------------------------------------------------------------
# Generic recursive programs for the unified executor
# ---------------------------------------------------------------------------
#
# The workloads the related Datalog systems target (BigDatalog's TC / SG,
# Myria/SociaLite's CC, and aggregates-in-recursion pipelines): arbitrary
# XY-stratified programs the two listing front-ends cannot express, executed
# by :func:`repro_torch.core.executor.compile_program` on the dense-grid backend.
# Aggregates resolve through the CombineMonoid registry, so their
# delta-safety metadata (min/max idempotent, sum not) feeds the semi-naive
# rewrite exactly as in the listing programs.


def _monoid_aggregate(name: str) -> Aggregate:
    from repro_torch.core.monoid import get_monoid

    return get_monoid(name).as_aggregate()


def transitive_closure_program() -> Program:
    """Transitive closure over ``edge(X, Y)``.

    * T1  tc(0, X, Y)   :- edge(X, Y).
    * T2  tc(J+1, X, Y) :- tc(J, X, Z), edge(Z, Y).
    * T3  tc(J+1, X, Y) :- tc(J, X, Y).              (facts persist)

    Fixpoint when T2 derives nothing new (tc stops growing).
    """

    J, Jp1, J0 = TempVar("J"), TempSucc("J"), TempZero()
    X, Y, Z = Var("X"), Var("Y"), Var("Z")
    rules = (
        Rule(Atom("tc", (J0, X, Y), temporal=True),
             (Atom("edge", (X, Y)),), label="T1"),
        Rule(Atom("tc", (Jp1, X, Y), temporal=True),
             (Atom("tc", (J, X, Z), temporal=True), Atom("edge", (Z, Y))),
             label="T2"),
        Rule(Atom("tc", (Jp1, X, Y), temporal=True),
             (Atom("tc", (J, X, Y), temporal=True),), label="T3"),
    )
    return Program(rules=rules, edb={"edge": 2}, name="transitive-closure")


def connected_components_program() -> Program:
    """Connected components by min-label propagation over ``edge``/``node``.

    * C1  cc(0, X, L)        :- node(X, L).           (own label, L = id)
    * C2  cc(J+1, X, min<L>) :- cc(J, Y, L), edge(Y, X).
    * C3  cc(J+1, X, L)      :- cc(J, X, L).          (keep own label)

    The ``min`` aggregate is idempotent, so C2 is delta-rewritable: under
    ``semi_naive=True`` it reads only the labels that changed last
    iteration (the classic semi-naive CC evaluation).
    """

    J, Jp1, J0 = TempVar("J"), TempSucc("J"), TempZero()
    X, Y, L = Var("X"), Var("Y"), Var("L")
    rules = (
        Rule(Atom("cc", (J0, X, L), temporal=True),
             (Atom("node", (X, L)),), label="C1"),
        Rule(Atom("cc", (Jp1, X, AggExpr("min", L)), temporal=True),
             (Atom("cc", (J, Y, L), temporal=True), Atom("edge", (Y, X))),
             label="C2"),
        Rule(Atom("cc", (Jp1, X, L), temporal=True),
             (Atom("cc", (J, X, L), temporal=True),), label="C3"),
    )
    return Program(
        rules=rules, edb={"edge": 2, "node": 2},
        aggregates={"min": _monoid_aggregate("min")},
        name="connected-components",
    )


def same_generation_program() -> Program:
    """Same-generation over ``parent(P, C)`` — the classic mutually-joined
    recursion (two recursive-adjacent joins per derivation).

    * S1  sg(0, X, Y)   :- parent(P, X), parent(P, Y).       (siblings)
    * S2  sg(J+1, X, Y) :- parent(P, X), sg(J, P, Q), parent(Q, Y).
    * S3  sg(J+1, X, Y) :- sg(J, X, Y).
    """

    J, Jp1, J0 = TempVar("J"), TempSucc("J"), TempZero()
    X, Y, Pp, Q = Var("X"), Var("Y"), Var("P"), Var("Q")
    rules = (
        Rule(Atom("sg", (J0, X, Y), temporal=True),
             (Atom("parent", (Pp, X)), Atom("parent", (Pp, Y))), label="S1"),
        Rule(Atom("sg", (Jp1, X, Y), temporal=True),
             (Atom("parent", (Pp, X)),
              Atom("sg", (J, Pp, Q), temporal=True),
              Atom("parent", (Q, Y))),
             label="S2"),
        Rule(Atom("sg", (Jp1, X, Y), temporal=True),
             (Atom("sg", (J, X, Y), temporal=True),), label="S3"),
    )
    return Program(rules=rules, edb={"parent": 2}, name="same-generation")


def pagerank_threshold_program(
    damping: float = 0.85, tau: float = 0.001
) -> Program:
    """A sequential multi-stratum pipeline no listing front-end can express:
    a PageRank fixpoint, a threshold selection over its *converged* result,
    and a second reachability fixpoint seeded from the hot vertices.

    Phase 1 (PageRank over ``edge`` and ``node(X, R0, D, B)`` — initial
    rank, out-degree, base rank):

    * P1  rank(0, X, R)        :- node(X, R, _, _).
    * P2  rank(J+1, X, sum<C>) :- rank(J, Y, R), node(Y, _, D, _),
                                  edge(Y, X), scale(R, D, C).
    * P3  rank(J+1, X, B)      :- rank(J, X, _), node(X, _, _, B).

    (P2 and P3 union under the ``sum`` monoid: damped in-rank plus base.)

    Post-stratum over the converged ranks (frontier view, L4/L5-style):

    * P4  rankF(X, R)          :- rank(J, X, R).         [frontier]
    * P5  hot(X)               :- rankF(X, R), R > tau.

    Phase 2 (reachability through hot vertices — runs only after phase 1
    converged, because ``hot`` reads rank's final frontier):

    * H1  reach(0, X)          :- hot(X).
    * H2  reach(J+1, Y)        :- reach(J, X), edge(X, Y), hot(Y).
    * H3  reach(J+1, X)        :- reach(J, X).
    """

    import torch

    J, Jp1, J0 = TempVar("J"), TempSucc("J"), TempZero()
    X, Y, R, D, C, B = (Var("X"), Var("Y"), Var("R"), Var("D"), Var("C"),
                        Var("B"))
    rules = (
        Rule(Atom("rank", (J0, X, R), temporal=True),
             (Atom("node", (X, R, fresh_var(), fresh_var())),), label="P1"),
        Rule(Atom("rank", (Jp1, X, AggExpr("sum", C)), temporal=True),
             (Atom("rank", (J, Y, R), temporal=True),
              Atom("node", (Y, fresh_var(), D, fresh_var())),
              Atom("edge", (Y, X)),
              FunctionAtom("scale", (R, D, C), n_in=2)),
             label="P2"),
        Rule(Atom("rank", (Jp1, X, B), temporal=True),
             (Atom("rank", (J, X, fresh_var()), temporal=True),
              Atom("node", (X, fresh_var(), fresh_var(), B))),
             label="P3"),
        Rule(Atom("rankF", (X, R)),
             (Atom("rank", (J, X, R), temporal=True),),
             label="P4", frontier=True),
        Rule(Atom("hot", (X,)),
             (Atom("rankF", (X, R)), Comparison(">", R, Const(tau))),
             label="P5"),
        Rule(Atom("reach", (J0, X), temporal=True),
             (Atom("hot", (X,)),), label="H1"),
        Rule(Atom("reach", (Jp1, Y), temporal=True),
             (Atom("reach", (J, X), temporal=True),
              Atom("edge", (X, Y)),
              Atom("hot", (Y,))),
             label="H2"),
        Rule(Atom("reach", (Jp1, X), temporal=True),
             (Atom("reach", (J, X), temporal=True),), label="H3"),
    )
    scale = UDF(
        "scale",
        lambda r, d: (damping * r / torch.clamp(d, min=1.0),),
        n_in=2, n_out=1,
    )
    return Program(
        rules=rules,
        edb={"edge": 2, "node": 4},
        udfs={"scale": scale},
        aggregates={"sum": _monoid_aggregate("sum")},
        name="pagerank-threshold",
    )


def negated_reach_program() -> Program:
    """Guarded reachability with stratified negation and a comparison guard.

    * N1  reach(0, X)   :- source(X, S), S > 0.
    * N2  reach(J+1, Y) :- reach(J, X), edge(X, Y), node(Y, W),
                           !blocked(Y), W < 3.
    * N3  reach(J+1, X) :- reach(J, X).

    N2's body order puts the negation *before* the comparison, so the
    translator stacks the ``W < 3`` Select on top of the AntiJoin — the
    shape the rewrite pass's Select-pushdown (and its stratified-negation
    fail-closed guard) is exercised against.
    """

    J, Jp1, J0 = TempVar("J"), TempSucc("J"), TempZero()
    X, Y, S, W = Var("X"), Var("Y"), Var("S"), Var("W")
    rules = (
        Rule(Atom("reach", (J0, X), temporal=True),
             (Atom("source", (X, S)), Comparison(">", S, Const(0))),
             label="N1"),
        Rule(Atom("reach", (Jp1, Y), temporal=True),
             (Atom("reach", (J, X), temporal=True),
              Atom("edge", (X, Y)),
              Atom("node", (Y, W)),
              Negation(Atom("blocked", (Y,))),
              Comparison("<", W, Const(3))),
             label="N2"),
        Rule(Atom("reach", (Jp1, X), temporal=True),
             (Atom("reach", (J, X), temporal=True),), label="N3"),
    )
    return Program(
        rules=rules,
        edb={"source": 2, "edge": 2, "node": 2, "blocked": 1},
        name="negated-reach",
    )


# ---------------------------------------------------------------------------
# Text-form equivalents (the Datalog frontend's ground truth)
# ---------------------------------------------------------------------------
#
# One text constant per shipped listing, plus ``parsed_*`` constructors that
# run them through :func:`repro_torch.core.parser.parse` with the same UDF/aggregate
# registries as the hand-built AST constructors above.  The parser/optimizer
# test battery pins these against the hand-built programs: TC/CC/SG/negated-
# reach parse to *identical* rule tuples; pregel/imru/pagerank use fresh
# variables in the hand-built form, so equivalence is pinned on the translated
# algebra (``translate(parsed).structure() == translate(hand).structure()``)
# and on byte-identical plan notes.

TRANSITIVE_CLOSURE_TEXT = """\
% Transitive closure over edge(X, Y).
T1: tc(0, X, Y)   :- edge(X, Y).
T2: tc(J+1, X, Y) :- tc(J, X, Z), edge(Z, Y).
T3: tc(J+1, X, Y) :- tc(J, X, Y).
"""

CONNECTED_COMPONENTS_TEXT = """\
% Connected components by min-label propagation.
C1: cc(0, X, L)        :- node(X, L).
C2: cc(J+1, X, min<L>) :- cc(J, Y, L), edge(Y, X).
C3: cc(J+1, X, L)      :- cc(J, X, L).
"""

SAME_GENERATION_TEXT = """\
% Same-generation over parent(P, C).
S1: sg(0, X, Y)   :- parent(P, X), parent(P, Y).
S2: sg(J+1, X, Y) :- parent(P, X), sg(J, P, Q), parent(Q, Y).
S3: sg(J+1, X, Y) :- sg(J, X, Y).
"""

NEGATED_REACH_TEXT = """\
% Guarded reachability with stratified negation.
N1: reach(0, X)   :- source(X, S), S > 0.
N2: reach(J+1, Y) :- reach(J, X), edge(X, Y), node(Y, W), !blocked(Y), W < 3.
N3: reach(J+1, X) :- reach(J, X).
"""

PREGEL_TEXT = """\
% Listing 1 -- the Pregel programming model.
L1: vertex(0, Id, State) :- data(Id, Datum), init_vertex(Id, Datum -> State).
L2: send(0, Id, '__ACTIVATION__') :- vertex(0, Id, _).
L3: collect(J, Id, combine<Msg>) :- send(J, Id, Msg).
L4: @frontier maxVertexJ(Id, max<J>) :- vertex(J, Id, State).
L5: @frontier local(Id, State) :- maxVertexJ(Id, J), vertex(J, Id, State).
L6: superstep(J, Id, OutState, OutMsgs) :-
        collect(J, Id, InMsgs), local(Id, InState),
        update(J, Id, InState, InMsgs -> OutState, OutMsgs).
L7: vertex(J+1, Id, State) :- superstep(J, Id, State, _), State != null.
L8: send(J+1, Id, M) :- superstep(J, _, _, {(Id, M)}).
"""

IMRU_TEXT = """\
% Listing 2 -- Iterative Map-Reduce-Update.
G1: model(0, M) :- init_model(-> M).
G2: collect(J, reduce<S>) :- model(J, M), training_data(Id, R), map(R, M -> S).
G3: model(J+1, NewM) :- collect(J, AggrS), model(J, M),
        update(J, M, AggrS -> NewM), M != NewM.
"""


def pagerank_threshold_text(tau: float = 0.001) -> str:
    """Text form of :func:`pagerank_threshold_program` (tau is inlined as a
    literal; the damping factor lives in the ``scale`` UDF binding)."""

    return f"""\
% PageRank fixpoint, threshold stratum, hot-vertex reachability.
P1: rank(0, X, R)        :- node(X, R, _, _).
P2: rank(J+1, X, sum<C>) :- rank(J, Y, R), node(Y, _, D, _), edge(Y, X),
        scale(R, D -> C).
P3: rank(J+1, X, B)      :- rank(J, X, _), node(X, _, _, B).
P4: @frontier rankF(X, R) :- rank(J, X, R).
P5: hot(X)               :- rankF(X, R), R > {tau!r}.
H1: reach(0, X)          :- hot(X).
H2: reach(J+1, Y)        :- reach(J, X), edge(X, Y), hot(Y).
H3: reach(J+1, X)        :- reach(J, X).
"""


def _parse(text: str, **kwargs):
    from repro_torch.core.parser import parse

    return parse(text, **kwargs)


def parsed_transitive_closure_program() -> Program:
    """``TRANSITIVE_CLOSURE_TEXT`` parsed; rules compare equal to
    :func:`transitive_closure_program`."""

    return _parse(TRANSITIVE_CLOSURE_TEXT, name="transitive-closure")


def parsed_connected_components_program() -> Program:
    return _parse(
        CONNECTED_COMPONENTS_TEXT,
        name="connected-components",
        aggregates={"min": _monoid_aggregate("min")},
    )


def parsed_same_generation_program() -> Program:
    return _parse(SAME_GENERATION_TEXT, name="same-generation")


def parsed_negated_reach_program() -> Program:
    return _parse(NEGATED_REACH_TEXT, name="negated-reach")


def parsed_pagerank_threshold_program(
    damping: float = 0.85, tau: float = 0.001
) -> Program:
    import torch

    scale = UDF(
        "scale",
        lambda r, d: (damping * r / torch.clamp(d, min=1.0),),
        n_in=2, n_out=1,
    )
    return _parse(
        pagerank_threshold_text(tau),
        name="pagerank-threshold",
        udfs={"scale": scale},
        aggregates={"sum": _monoid_aggregate("sum")},
    )


def parsed_pregel_program(
    udfs: Optional[Mapping[str, Callable]] = None,
    aggregates: Optional[Mapping[str, Aggregate]] = None,
) -> Program:
    """``PREGEL_TEXT`` parsed with the same registries as
    :func:`pregel_program` — same ValueError contract on a missing
    'combine' aggregate."""

    impls = dict(udfs or {})
    registry = {
        "init_vertex": UDF("init_vertex", impls.get("init_vertex"),
                           n_in=2, n_out=1),
        "update": UDF("update", impls.get("update"), n_in=4, n_out=2),
    }
    aggs = dict(aggregates or {})
    aggs.setdefault(
        "max",
        Aggregate("max", zero=lambda: float("-inf"), combine=max),
    )
    if "combine" not in aggs:
        raise ValueError("Pregel program requires a 'combine' aggregate")
    return _parse(
        PREGEL_TEXT, name="pregel", udfs=registry, aggregates=aggs,
        edb={"data": 2},
    )


def parsed_imru_program(
    udfs: Optional[Mapping[str, Callable]] = None,
    aggregates: Optional[Mapping[str, Aggregate]] = None,
) -> Program:
    impls = dict(udfs or {})
    registry = {
        "init_model": UDF("init_model", impls.get("init_model"),
                          n_in=0, n_out=1),
        "map": UDF("map", impls.get("map"), n_in=2, n_out=1),
        "update": UDF("update", impls.get("update"), n_in=3, n_out=1),
    }
    aggs = dict(aggregates or {})
    if "reduce" not in aggs:
        raise ValueError("IMRU program requires a 'reduce' aggregate")
    return _parse(
        IMRU_TEXT, name="imru", udfs=registry, aggregates=aggs,
        edb={"training_data": 2},
    )
