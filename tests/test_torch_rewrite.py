"""The port's rewrite-rule optimizer (join reordering, select pushdown,
cross-rule CSE) against the JAX package's.

With ``compile_program(..., rewrite=True)`` the plan notes, the rewritten
logical plans and the ``rewrite(...)`` decision are byte-equal to the
reference's, and the results equal the reference's and the port's own
un-rewritten run (exact for set-valued results; values within 1e-6
relative of the reference's, sums taken in another order, and <= 1e-8 of
the un-rewritten run).  The pass's units (cardinality estimates, the
stratified-negation guard, CSE by identity, the dot rendering) are pinned
on the same inputs as ``tests/test_rewrite.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import listings as JL
from repro.core import rewrite as JR
from repro.core.executor import Relation as JaxRelation
from repro.core.executor import compile_program as jax_compile_program
from repro_torch.core import listings as TL
from repro_torch.core import rewrite as TR
from repro_torch.core.algebra import AntiJoin, ScanEDB, Select
from repro_torch.core.datalog import Const
from repro_torch.core.executor import Relation, compile_program

N = 64
RTOL = 1e-6


def _cols(seed=0, edges=96):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, edges), rng.integers(0, N, edges)
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
    "transitive-closure": ("transitive_closure_program", {"edge": "edge"}),
    "connected-components": ("connected_components_program",
                             {"edge": "edge", "node": "node2"}),
    "same-generation": ("same_generation_program", {"parent": "edge"}),
    "pagerank-threshold": ("pagerank_threshold_program",
                           {"edge": "edge", "node": "node4"}),
    "negated-reach": ("negated_reach_program",
                      {"source": "source", "edge": "edge", "node": "nodew",
                       "blocked": "blocked"}),
}


@pytest.mark.parametrize("parsed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rewrite_matches_jax_and_the_unrewritten_run(case, parsed):
    name, pick = CASES[case]
    make = f"parsed_{name}" if parsed else name
    cols = _cols()
    rels = {p: Relation.from_columns(N, *cols[c], device="cpu")
            for p, c in pick.items()}
    jax_rels = {p: JaxRelation.from_columns(N, *cols[c])
                for p, c in pick.items()}
    want = jax_compile_program(getattr(JL, make)(), jax_rels, rewrite=True)
    ex = compile_program(getattr(TL, make)(), rels, rewrite=True,
                         device="cpu")
    plain = compile_program(getattr(TL, make)(), rels, device="cpu")
    assert ex.plan.notes == want.plan.notes
    assert any(n.startswith("rewrite(") for n in ex.plan.notes)
    assert ex.logical.structure() == want.logical.structure()
    assert len(ex.shared_ids) == len(want.shared_ids)
    w = want.run(max_iters=80)
    a, b = plain.run(max_iters=80), ex.run(max_iters=80)
    assert a.converged and b.converged and w.converged
    assert b.iterations == a.iterations == w.iterations
    for pred, rel in w.state.items():
        present = np.asarray(rel.present)
        assert (b.state[pred].present.numpy() == present).all(), pred
        assert torch.equal(b.state[pred].present, a.state[pred].present)
        for p, g in rel.values.items():
            got = b.state[pred].values[p].numpy()[present]
            np.testing.assert_allclose(
                got, a.state[pred].values[p].numpy()[present], rtol=0,
                atol=1e-8)
            np.testing.assert_allclose(got, np.asarray(g)[present],
                                       rtol=RTOL)


def test_negated_reach_pushdown_stays_on_positive_side():
    cols = _cols()
    pick = CASES["negated-reach"][1]
    rels = {p: Relation.from_columns(N, *cols[c], device="cpu")
            for p, c in pick.items()}
    ex = compile_program(TL.parsed_negated_reach_program(), rels,
                         rewrite=True, device="cpu")
    assert [n for n in ex.plan.notes if n.startswith("rewrite(")] == [
        "rewrite(join-reorder: none, pushdown: 1 select, cse: 0 shared)"]
    (n2,) = [df for df in ex.logical.body if df.label == "N2"]
    assert n2.structure() == (
        "N2", "reach",
        ("Project",
         ("AntiJoin",
          ("Join",
           ("Join", ("ScanState",), ("ScanEDB",)),
           ("Select", ("ScanEDB",))),
          ("ScanEDB",))),
    )


def test_select_crossing_antijoin_boundary_raises_like_jax():
    from repro.core.algebra import AntiJoin as JAntiJoin
    from repro.core.algebra import ScanEDB as JScanEDB
    from repro.core.algebra import Select as JSelect
    from repro.core.datalog import Const as JConst

    want_sel = JSelect(JAntiJoin(JScanEDB("e", ("X", "Y")),
                                 JScanEDB("b", ("Y", "W")), keys=("Y",)),
                       "<", "W", JConst(3))
    sel = Select(AntiJoin(ScanEDB("e", ("X", "Y")),
                          ScanEDB("b", ("Y", "W")), keys=("Y",)),
                 "<", "W", Const(3))
    with pytest.raises(JR.RewriteError) as want:
        JR._pushdown_selects(want_sel)
    with pytest.raises(TR.RewriteError) as got:
        TR._pushdown_selects(sel)
    assert str(got.value) == str(want.value)
    assert "stratified-negation boundary" in str(got.value)


def test_cse_shares_subtree_by_identity_like_jax():
    cols = _cols()
    rels = {"parent": Relation.from_columns(N, *cols["edge"], device="cpu")}
    jax_rels = {"parent": JaxRelation.from_columns(N, *cols["edge"])}
    want = jax_compile_program(JL.same_generation_program(), jax_rels,
                               rewrite=True)
    ex = compile_program(TL.same_generation_program(), rels, rewrite=True,
                         device="cpu")
    assert ex.plan.notes == want.plan.notes
    assert len(ex.shared_ids) == len(want.shared_ids) >= 1


def test_cardinality_estimates_and_dot_match_jax():
    cols = _cols()
    pick = CASES["pagerank-threshold"][1]
    rels = {p: Relation.from_columns(N, *cols[c], device="cpu")
            for p, c in pick.items()}
    jax_rels = {p: JaxRelation.from_columns(N, *cols[c])
                for p, c in pick.items()}
    ex = compile_program(TL.pagerank_threshold_program(), rels, device="cpu")
    want = jax_compile_program(JL.pagerank_threshold_program(), jax_rels)
    dfs = tuple(ex.logical.init) + tuple(ex.logical.body)
    jdfs = tuple(want.logical.init) + tuple(want.logical.body)
    assert TR.estimate_program_cardinalities(dfs, rels, N) == \
        JR.estimate_program_cardinalities(jdfs, jax_rels, N)
    # The dot text names variables, and the listings with fresh variables
    # number them from each package's own counter: compare on one without.
    pick = CASES["negated-reach"][1]
    ex = compile_program(TL.negated_reach_program(), {
        p: Relation.from_columns(N, *cols[c], device="cpu")
        for p, c in pick.items()}, rewrite=True, device="cpu")
    want = jax_compile_program(JL.negated_reach_program(), {
        p: JaxRelation.from_columns(N, *cols[c]) for p, c in pick.items()},
        rewrite=True)
    assert TR.plan_to_dot(ex.logical, ex.plan.storage) == \
        JR.plan_to_dot(want.logical, want.plan.storage)
