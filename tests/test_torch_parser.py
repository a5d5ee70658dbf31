"""The port's Datalog text front end against the JAX package's.

Every ``*_TEXT`` listing parses in both packages to programs whose
``to_text()`` is equal, round-trips through ``parse(p.to_text())``, and
compiles to byte-equal plan notes (the generic programs through
``compile_program``, Listings 1 and 2 through their bindings).  The
programs of ``tests/test_parser.py`` that must fail raise ``ParseError`` in
both, with the same message and span.  Parsed programs run on the port's
engine to the same fixpoint as the hand-built ones (exact for set-valued
results, <= 1e-8 for values: the same operators in the same order).
"""

import numpy as np
import pytest
import torch

from repro.core import algebra as jax_algebra
from repro.core import listings as JL
from repro.core import parser as JP
from repro.core.executor import Relation as JaxRelation
from repro.core.executor import compile_program as jax_compile_program
from repro_torch.core import algebra
from repro_torch.core import listings as TL
from repro_torch.core import parser as TP
from repro_torch.core.datalog import Aggregate
from repro_torch.core.executor import Relation, compile_program
from repro_torch.core.imru import IMRUTask, compile_imru
from repro_torch.core.monoid import get_monoid
from repro_torch.core.pregel import VertexProgram, compile_pregel
from repro_torch.carry import graph_from_numpy, imru_records_from_numpy

N = 64


def _sum_agg(name):
    return Aggregate(name, zero=lambda: 0.0, combine=lambda a, b: a + b)


def _listing_pairs():
    """(name, reference program, port program) of every parsed listing."""

    return [
        ("tc", JL.parsed_transitive_closure_program(),
         TL.parsed_transitive_closure_program()),
        ("cc", JL.parsed_connected_components_program(),
         TL.parsed_connected_components_program()),
        ("sg", JL.parsed_same_generation_program(),
         TL.parsed_same_generation_program()),
        ("negated-reach", JL.parsed_negated_reach_program(),
         TL.parsed_negated_reach_program()),
        ("pagerank-threshold", JL.parsed_pagerank_threshold_program(),
         TL.parsed_pagerank_threshold_program()),
        ("pregel",
         JL.parsed_pregel_program(aggregates={"combine":
                                              _sum_agg("combine")}),
         TL.parsed_pregel_program(aggregates={"combine":
                                              _sum_agg("combine")})),
        ("imru",
         JL.parsed_imru_program(aggregates={"reduce": _sum_agg("reduce")}),
         TL.parsed_imru_program(aggregates={"reduce": _sum_agg("reduce")})),
    ]


@pytest.mark.parametrize("i", range(7))
def test_parsed_listing_text_matches_jax(i):
    name, want, got = _listing_pairs()[i]
    assert got.to_text() == want.to_text() == JP.to_text(want), name
    assert TP.to_text(got) == got.to_text()
    assert got.edb == want.edb and got.name == want.name
    assert (algebra.translate(got).structure()
            == jax_algebra.translate(want).structure())
    back = TP.parse(got.to_text(), name=got.name, udfs=got.udfs,
                    aggregates=got.aggregates, edb=got.edb)
    assert back.to_text() == got.to_text()


def test_text_constants_are_the_references():
    for name in ("TRANSITIVE_CLOSURE_TEXT", "CONNECTED_COMPONENTS_TEXT",
                 "SAME_GENERATION_TEXT", "NEGATED_REACH_TEXT", "PREGEL_TEXT",
                 "IMRU_TEXT"):
        assert getattr(TL, name) == getattr(JL, name), name
    assert TL.pagerank_threshold_text(0.25) == JL.pagerank_threshold_text(0.25)


def test_parsed_forms_match_hand_built_rules():
    for hand, parsed in (
        (TL.transitive_closure_program(),
         TL.parsed_transitive_closure_program()),
        (TL.connected_components_program(),
         TL.parsed_connected_components_program()),
        (TL.same_generation_program(), TL.parsed_same_generation_program()),
        (TL.negated_reach_program(), TL.parsed_negated_reach_program()),
    ):
        assert parsed.rules == hand.rules, hand.name
        assert parsed.edb == hand.edb, hand.name


def test_parsed_listing_constructors_fail_closed_like_jax():
    for make in ("parsed_pregel_program", "parsed_imru_program"):
        with pytest.raises(ValueError) as want:
            getattr(JL, make)()
        with pytest.raises(ValueError) as got:
            getattr(TL, make)()
        assert str(got.value) == str(want.value)


BAD_PROGRAMS = {
    "unbound-head": "R1: p(0, X, Y) :- e(X).",
    "unbound-negation":
        "R1: p(0, X) :- e(X), !q(Y).\nR2: p(J+1, X) :- p(J, X).",
    "unbound-comparison":
        "R1: p(0, X) :- e(X), Y > 1.\nR2: p(J+1, X) :- p(J, X).",
    "anonymous-head": "R1: p(0, X, _) :- e(X).",
    "unregistered-aggregate":
        "C1: cc(0, X, L) :- node(X, L).\n"
        "C2: cc(J+1, X, frob<L>) :- cc(J, Y, L), edge(Y, X).\n"
        "C3: cc(J+1, X, L) :- cc(J, X, L).\n",
    "unregistered-udf": "R1: p(0, X, Y) :- e(X), f(X -> Y).\n"
                        "R2: p(J+1, X, Y) :- p(J, X, Y).",
    "bad-successor": "R1: p(0, X) :- e(X).\nR2: p(J+2, X) :- p(J, X).",
    "never-derived": "R1: p(0, X) :- q(J, X).",
    "syntax": "R1: p(0 X) :- e(X).",
    "negation-cycle": "B1: p(X) :- e(X), !q(X).\nB3: q(X) :- e(X), !p(X).",
    "sibling-negation":
        "A1: p(0, X) :- e(X).\n"
        "A2: p(J+1, X) :- p(J, X), !q(X).\n"
        "A3: q(X) :- p(J, X), marked(X).\n",
    "empty": "% nothing but comments\n",
}


@pytest.mark.parametrize("case", sorted(BAD_PROGRAMS))
def test_bad_programs_fail_like_jax(case):
    text = BAD_PROGRAMS[case]
    with pytest.raises(JP.ParseError) as want:
        JP.parse(text)
    with pytest.raises(TP.ParseError) as got:
        TP.parse(text)
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)
    if want.value.span is None:
        assert got.value.span is None
    else:
        assert (got.value.span.line, got.value.span.col) == \
            (want.value.span.line, want.value.span.col)


def test_registered_monoids_resolve_and_annotations_parse():
    prog = TP.parse(
        "C1: cc(0, X, L) :- node(X, L).\n"
        "C2: cc(J+1, X, min<L>) :- cc(J, Y, L), edge(Y, X).\n"
        "C3: cc(J+1, X, L) :- cc(J, X, L).\n", name="cc")
    assert prog.aggregates["min"].idempotent
    assert prog.aggregates["min"].combine is get_monoid("min").combine
    text = ("% leading comment\n"
            "R1: p(0, X, 'it\\'s') :- e(X).  % trailing\n"
            "@frontier F1: q(X) :- p(J, X, S).\n"
            "F2: @frontier r(X) :- p(J, X, S).\n")
    assert TP.parse(text, name="syntax").to_text() == \
        JP.parse(text, name="syntax").to_text()


# ---------------------------------------------------------------------------
# Parsed programs compile to the reference's notes and run like hand-built
# ---------------------------------------------------------------------------


def _cols():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, 96), rng.integers(0, N, 96)
    deg = np.bincount(src, minlength=N).astype(np.float32)
    return {
        "edge": (src, dst),
        "node2": (np.arange(N), np.arange(N, dtype=np.float32)),
        "node4": (np.arange(N), np.full(N, 1.0 / N, np.float32), deg,
                  np.full(N, 0.15 / N, np.float32)),
        "source": (np.arange(8),
                   np.array([1, 0, 1, 1, 0, 1, 0, 1], np.float32)),
        "blocked": (np.array([3, 9, 27]),),
        "nodew": (np.arange(N), (np.arange(N) % 5).astype(np.float32)),
    }


CASES = {
    "transitive-closure": ("transitive_closure_program",
                           {"edge": "edge"}, False),
    "connected-components": ("connected_components_program",
                             {"edge": "edge", "node": "node2"}, False),
    "connected-components/semi-naive": ("connected_components_program",
                                        {"edge": "edge", "node": "node2"},
                                        True),
    "same-generation": ("same_generation_program", {"parent": "edge"}, False),
    "pagerank-threshold": ("pagerank_threshold_program",
                           {"edge": "edge", "node": "node4"}, False),
    "negated-reach": ("negated_reach_program",
                      {"source": "source", "edge": "edge", "node": "nodew",
                       "blocked": "blocked"}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parsed_program_runs_like_hand_built_with_jax_notes(case):
    name, pick, semi_naive = CASES[case]
    cols = _cols()
    rels = {p: Relation.from_columns(N, *cols[c], device="cpu")
            for p, c in pick.items()}
    jax_rels = {p: JaxRelation.from_columns(N, *cols[c])
                for p, c in pick.items()}
    hand = compile_program(getattr(TL, name)(), rels, semi_naive=semi_naive,
                           device="cpu")
    parsed = compile_program(getattr(TL, f"parsed_{name}")(), rels,
                             semi_naive=semi_naive, device="cpu")
    want = jax_compile_program(getattr(JL, f"parsed_{name}")(), jax_rels,
                               semi_naive=semi_naive)
    assert parsed.plan.notes == hand.plan.notes == want.plan.notes
    a, b = hand.run(max_iters=80), parsed.run(max_iters=80)
    assert a.converged and b.converged and a.iterations == b.iterations
    for pred, rel in a.state.items():
        assert torch.equal(b.state[pred].present, rel.present), pred
        for p, g in rel.values.items():
            assert float((b.state[pred].values[p] - g).abs().max()) <= 1e-8


def _pagerank_vp():
    return VertexProgram(
        init_vertex=lambda ids, vd: torch.stack(
            [torch.full((N,), 1.0 / N), vd], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / N + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool)),
        combine="sum",
    )


def test_parsed_pregel_text_rides_fast_path():
    rng = np.random.default_rng(5)
    src = np.repeat(np.arange(N), 4).astype(np.int32)
    dst = rng.integers(0, N, 4 * N).astype(np.int32)
    g = graph_from_numpy(N, src, dst,
                         np.bincount(src, minlength=N).astype(np.float32),
                         device="cpu")
    vp = _pagerank_vp()
    parsed = TL.parsed_pregel_program(
        udfs={"init_vertex": vp.init_vertex, "update": vp.apply},
        aggregates={"combine":
                    get_monoid("sum").as_aggregate(recomputable=True)},
    )
    spec = compile_pregel(vp, g, device="cpu")
    gen = compile_program(parsed, {"data": g}, binding=vp, device="cpu")
    assert type(gen).__name__ == "PregelExecutable"
    assert gen.plan.notes == spec.plan.notes
    a, b = spec.run(max_iters=12), gen.run(max_iters=12)
    assert a.iterations == b.iterations
    assert float((a.state[0] - b.state[0]).abs().max()) <= 1e-8


def test_parsed_imru_text_rides_fast_path():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = X @ rng.normal(size=8).astype(np.float32)
    task = IMRUTask(
        init_model=lambda: torch.zeros(8),
        map=lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"],
        update=lambda j, m, g: m - 1e-3 * g,
        tol=1e-9,
    )
    recs = imru_records_from_numpy({"x": X, "y": y}, device="cpu")
    parsed = TL.parsed_imru_program(
        udfs={"init_model": task.init_model, "map": task.map,
              "update": task.update},
        aggregates={"reduce": task.reduce},
    )
    spec = compile_imru(task, recs, device="cpu")
    gen = compile_program(parsed, {"training_data": recs}, binding=task,
                          device="cpu")
    assert type(gen).__name__ == "IMRUExecutable"
    assert gen.plan.notes == spec.plan.notes
    a, b = spec.run(max_iters=80), gen.run(max_iters=80)
    assert a.iterations == b.iterations
    assert float((a.state - b.state).abs().max()) <= 1e-8
