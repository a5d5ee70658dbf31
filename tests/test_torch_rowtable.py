"""The port's row-table storage (ROADMAP A9) against the JAX package.

The battery of ``tests/test_rowtable.py`` on the port's API, each program
compiled by both packages from the same numpy columns:

1. **Forced row-table == dense, and == the reference's row run**: the six
   shipped generic programs compiled with ``storage="row-table"`` match the
   port's own dense run (sets exact, values <= 1e-8, the reference test's
   bar) and the JAX package's forced-row run (sets exact, values <= 1e-6
   relative), on the host driver and on ``device_fixpoint``; plan notes,
   ``storage-selection(...)`` included, byte-equal under ``TPU_V5E``.
2. **Past the dense wall**: transitive closure over 8,192 chains on 65,536
   vertices, on planner-selected row tables, equals its closed form
   exactly; connected components and PageRank -> threshold -> reach at
   n = 2048 take the segmented GroupBy (grids past 2^20 cells) and the
   row union merge, and match the reference and numpy/scipy oracles.
3. **AntiJoin is exact set-difference** over the whole 32-bit code range.
4. **Lossless overflow fallback** (``storage_fallback``), and the raise
   with a ``RowRelation`` EDB, which has no dense grid to fall back to.
5. **Input hardening**: ``RowRelation.from_columns`` dedupes keep-last and
   rejects out-of-domain ids as the reference does, round-trips to dense,
   and ``carry.row_relation_from_numpy`` carries a reference relation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import executor as JE
from repro.core import listings as JL
from repro.core.physical import difference_row_codes as jax_difference
from repro_torch.carry import row_relation_from_numpy
from repro_torch.core import executor as TE
from repro_torch.core import listings as TL
from repro_torch.core.physical import difference_row_codes

N = 32
RTOL = 1e-6


def _edges(seed=0, m=48, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


def _sets(rel):
    """``(rows, {position: values})`` of any relation of either package:
    the key tuples in lexicographic order and the values aligned."""

    if isinstance(rel, (JE.RowRelation, TE.RowRelation)):
        rows = np.asarray(rel.tuples())
        vals = {p: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                for p, v in rel.values.items()}
        return rows, vals
    present = np.asarray(rel.present.cpu() if isinstance(
        rel.present, torch.Tensor) else rel.present)
    rows = np.argwhere(present)
    vals = {}
    for p, g in rel.values.items():
        g = np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g)
        vals[p] = g[tuple(rows.T)]
    return rows, vals


def _assert_same_sets(want, got, preds, rtol=None, atol=None):
    for p in preds:
        wr, wv = _sets(want.state[p])
        gr, gv = _sets(got.state[p])
        np.testing.assert_array_equal(gr, wr, err_msg=p)
        assert set(gv) == set(wv), p
        for k in wv:
            np.testing.assert_allclose(gv[k], wv[k], rtol=rtol or 0,
                                       atol=atol or 0, err_msg=(p, k))


def _compile_both(program_name, cols_by_pred, n, *, row_preds=(), prog_kw=None,
                  **kw):
    """Compile ``listings.<program_name>()`` in both packages over
    relations of the same columns (``row_preds`` as RowRelations); the
    plan notes must be byte-equal."""

    prog_kw = prog_kw or {}
    jrels, trels = {}, {}
    for p, cols in cols_by_pred.items():
        jcls = JE.RowRelation if p in row_preds else JE.Relation
        tcls = TE.RowRelation if p in row_preds else TE.Relation
        jrels[p] = jcls.from_columns(n, *cols)
        trels[p] = tcls.from_columns(n, *cols, device="cpu")
    j = JE.compile_program(getattr(JL, program_name)(**prog_kw), jrels, **kw)
    t = TE.compile_program(getattr(TL, program_name)(**prog_kw), trels,
                           device="cpu", **kw)
    assert t.plan.notes == j.plan.notes
    assert t.storage == j.storage and t.row_caps == j.row_caps
    assert t.row_cap == j.row_cap
    return j, t


# ---------------------------------------------------------------------------
# 1. Forced row-table vs dense and vs the reference, six programs, drivers
# ---------------------------------------------------------------------------


def _tc_setup():
    return ("transitive_closure_program", {"edge": _edges()}, N, ("tc",),
            {}, {})


def _cc_setup(semi_naive):
    src, dst = _edges(seed=1, m=40)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    return ("connected_components_program", {
        "edge": (s2, d2),
        "node": (np.arange(N), np.arange(N, dtype=np.float32)),
    }, N, ("cc",), {"semi_naive": semi_naive}, {})


def _sg_setup():
    return ("same_generation_program", {"parent": _edges(seed=4, m=36)}, N,
            ("sg",), {}, {})


def _nr_setup():
    n = 64
    return ("negated_reach_program", {
        "edge": _edges(seed=0, m=96, n=n),
        "source": (np.arange(8),
                   np.array([1, 0, 1, 1, 0, 1, 0, 1], np.float32)),
        "blocked": (np.array([3, 9, 27]),),
        "node": (np.arange(n), (np.arange(n) % 5).astype(np.float32)),
    }, n, ("reach",), {}, {})


def _pr_setup():
    n = 256
    rng = np.random.default_rng(2)
    src = np.repeat(np.arange(n), 3)
    dst = rng.integers(0, n, 3 * n)
    deg = np.bincount(src, minlength=n).astype(np.float32)
    return ("pagerank_threshold_program", {
        "edge": (src, dst),
        "node": (np.arange(n), np.full(n, 1.0 / n, np.float32), deg,
                 np.full(n, 0.15 / n, np.float32)),
    }, n, ("rank", "hot", "reach"), {"iters": 30}, {"tau": 1.5 / n})


_PROGRAMS = {
    "tc": _tc_setup,
    "cc-naive": lambda: _cc_setup(False),
    "cc-semi-naive": lambda: _cc_setup(True),
    "sg": _sg_setup,
    "negated-reach": _nr_setup,
    "pagerank-pipeline": _pr_setup,
}


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
@pytest.mark.parametrize("on_device", [False, True])
def test_forced_row_table_matches_dense_and_jax(name, on_device):
    program, cols, n, preds, kw, prog_kw = _PROGRAMS[name]()
    iters = kw.pop("iters", 100)
    j, t = _compile_both(program, cols, n, prog_kw=prog_kw,
                         storage="row-table", **kw)
    assert all(s == "row-table" for s in t.storage.values())
    _, t_dense = _compile_both(program, cols, n, prog_kw=prog_kw, **kw)
    want = j.run(max_iters=iters, on_device=on_device)
    got = t.run(max_iters=iters, on_device=on_device)
    dense = t_dense.run(max_iters=iters, on_device=on_device)
    assert got.converged == want.converged == dense.converged
    assert got.iterations == want.iterations
    assert got.phase_iterations == tuple(want.phase_iterations)
    assert not got.storage_fallback and not want.storage_fallback
    for p in preds:
        assert isinstance(got.state[p], TE.RowRelation)
    _assert_same_sets(want, got, preds, rtol=RTOL)
    _assert_same_sets(dense, got, preds, atol=1e-8)


# ---------------------------------------------------------------------------
# 2. Past the dense wall: planner-selected row tables, segmented GroupBys
# ---------------------------------------------------------------------------


def test_tc_64k_sparse_matches_closure_oracle_exactly():
    n, block = 65536, 8
    src = np.concatenate(
        [np.arange(s, s + block - 1) for s in range(0, n, block)])
    dst = src + 1
    ex = TE.compile_program(
        TL.transitive_closure_program(),
        {"edge": TE.RowRelation.from_columns(n, src, dst, device="cpu")},
        device="cpu")
    ref = JE.compile_program(
        JL.transitive_closure_program(),
        {"edge": JE.RowRelation.from_columns(n, src, dst)})
    # The planner picks row tables on its own: the dense n^2 grid would be
    # 4 GiB of bool.
    assert ex.storage == {"edge": "row-table", "tc": "row-table"}
    assert ex.plan.notes == ref.plan.notes

    res = ex.run(max_iters=16)
    assert res.converged and not res.storage_fallback
    tc = res.state["tc"]
    assert isinstance(tc, TE.RowRelation)
    # The closed form of the chains: (i, j) for i < j within a block.
    i, j = np.triu_indices(block, 1)
    starts = np.arange(0, n, block)[:, None]
    want = np.stack([(starts + i).ravel(), (starts + j).ravel()], axis=1)
    want = want[np.lexsort(want.T[::-1])]
    np.testing.assert_array_equal(tc.tuples(), want)


def _spy_combines(monkeypatch):
    """The (rows, op) of every segment combine the executor runs."""

    calls = []
    real = TE.segment_combine_sorted

    def spy(values, ids, n, op="sum", **kw):
        calls.append((int(values.shape[0]), op))
        return real(values, ids, n, op, **kw)

    monkeypatch.setattr(TE, "segment_combine_sorted", spy)
    return calls


def _hub_graph(n, seed, hubs=16, spokes=1200, chords=200):
    """An undirected graph of ``spokes`` vertices each joined to one of
    ``hubs`` hubs, plus ``chords`` random edges: hundreds of components
    and a small diameter (a few fixpoint iterations), on a slab small
    enough that the reference compiles it quickly."""

    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.choice(n, spokes, replace=False),
                        rng.integers(0, n, chords)])
    b = np.concatenate([rng.integers(0, hubs, spokes) * (n // hubs),
                        rng.integers(0, n, chords)])
    return np.concatenate([a, b]), np.concatenate([b, a])


@pytest.mark.parametrize("on_device", [False, True])
def test_segmented_min_groupby_connected_components(on_device, monkeypatch):
    """CC at n = 2048 with a RowRelation edge set and a dense node: the
    join is on rows, its min GroupBy over 2048^2 grid cells takes the
    segmented sorted combine (once an iteration), and ``cc`` stays
    dense.  Held against scipy, and on the host driver against the
    reference."""

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = 2048
    s2, d2 = _hub_graph(n, seed=5)
    j, t = _compile_both("connected_components_program", {
        "edge": (s2, d2),
        "node": (np.arange(n), np.arange(n, dtype=np.float32)),
    }, n, row_preds=("edge",), semi_naive=True)
    assert t.storage == {"edge": "row-table", "node": "dense-grid",
                         "cc": "dense-grid"}
    calls = _spy_combines(monkeypatch)
    got = t.run(max_iters=100, on_device=on_device)
    assert got.converged
    assert [op for _, op in calls].count("min") >= got.iterations
    if not on_device:
        want = j.run(max_iters=100)
        assert got.iterations == want.iterations
        _assert_same_sets(want, got, ("cc",))
    k, labels = connected_components(
        coo_matrix((np.ones(len(s2)), (s2, d2)), shape=(n, n)),
        directed=False)
    low = np.full(k, n, np.int64)
    np.minimum.at(low, labels, np.arange(n))
    np.testing.assert_array_equal(got.state["cc"].values[1].numpy(),
                                  low[labels].astype(np.float32))


def test_segmented_sum_groupby_and_row_merge_pagerank_pipeline(monkeypatch):
    """PageRank -> threshold -> reach on row tables at n = 2048: P2's sum
    GroupBy (2048^2 grid cells) is segmented and P2 + P3 union-merge by
    the row merge's segmented sum.  Ranks within 1e-6 relative of the
    reference's and of a float64 oracle; hot and reach exact."""

    n, iters, deg_out = 2048, 20, 2
    rng = np.random.default_rng(7)
    src = np.repeat(np.arange(n), deg_out)
    dst = rng.integers(0, n, deg_out * n)
    keep = np.unique(np.stack([src, dst], 1), axis=0)
    src, dst = keep[:, 0], keep[:, 1]
    deg = np.bincount(src, minlength=n).astype(np.float32)
    adj = np.zeros((n, n))
    adj[src, dst] = 1.0
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = 0.85 * adj.T @ (r / np.maximum(deg, 1.0)) + 0.15 / n
    srt = np.sort(r)
    gi = int(np.argmax(np.diff(srt)[n // 2:])) + n // 2
    tau = float((srt[gi] + srt[gi + 1]) / 2)
    j, t = _compile_both("pagerank_threshold_program", {
        "edge": (src, dst),
        "node": (np.arange(n), np.full(n, 1.0 / n, np.float32), deg,
                 np.full(n, 0.15 / n, np.float32)),
    }, n, prog_kw={"tau": tau}, storage="row-table")
    want = j.run(max_iters=iters)
    calls = _spy_combines(monkeypatch)
    got = t.run(max_iters=iters)
    assert got.phase_iterations == tuple(want.phase_iterations)
    # Each PageRank iteration: the segmented GroupBy, then the row merge
    # of P2 and P3 (two slabs of rank's capacity).
    cap = t.row_caps["rank"]
    assert calls[:2 * iters] == [(t.row_cap, "sum"), (2 * cap, "sum")] * iters
    _assert_same_sets(want, got, ("rank", "hot", "reach"), rtol=RTOL)
    rank = got.state["rank"].values[1].numpy()
    np.testing.assert_allclose(rank, r, rtol=RTOL, atol=0)
    hot = r > tau
    np.testing.assert_array_equal(got.state["hot"].tuples()[:, 0],
                                  np.flatnonzero(hot))
    reach = hot.copy()
    while True:
        new = reach | (((adj.T @ reach) > 0) & hot)
        if (new == reach).all():
            break
        reach = new
    np.testing.assert_array_equal(got.state["reach"].tuples()[:, 0],
                                  np.flatnonzero(reach))


def test_planner_row_table_choice_matches_the_reference():
    # 2048^2 cells is past the planner's dense minimum and the edges are
    # sparse, so the planner (the reference's too) picks row-table for
    # them, with the reference's storage-selection note.
    n = 2048
    j, t = _compile_both("transitive_closure_program",
                         {"edge": _edges(0, 300, n)}, n)
    assert "row-table" in t.plan.notes[0]
    _assert_same_sets(j.run(max_iters=64), t.run(max_iters=64), ("tc",))


def test_raw_array_past_the_dense_limit_becomes_a_row_relation():
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    n = 1 << 13
    t = TE.compile_program(TL.transitive_closure_program(), {"edge": edges},
                           domain=n, device="cpu")
    j = JE.compile_program(JL.transitive_closure_program(), {"edge": edges},
                           domain=n)
    assert isinstance(t.relations["edge"], TE.RowRelation)
    assert t.plan.notes == j.plan.notes
    _assert_same_sets(j.run(max_iters=8), t.run(max_iters=8), ("tc",))


# ---------------------------------------------------------------------------
# 3. AntiJoin == exact set-difference (no dense mask possible)
# ---------------------------------------------------------------------------


def test_difference_row_codes_is_exact_set_difference():
    rng = np.random.default_rng(7)
    # Codes across the whole 32-bit range: a dense mask over this key
    # space would be 4 Gi entries, so only a true set-difference works.
    left = rng.integers(0, 2**32, 512, dtype=np.uint32)
    right = rng.integers(0, 2**32, 256, dtype=np.uint32)
    right[:128] = left[:128]  # guarantee overlap
    left[-1] = right[-1] = 2**32 - 1  # the largest code, valid on both
    lv = rng.random(512) < 0.9
    rv = rng.random(256) < 0.9
    rv[-1] = lv[-1] = True

    keep = difference_row_codes(
        torch.from_numpy(left.astype(np.int64)), torch.from_numpy(lv),
        torch.from_numpy(right.astype(np.int64)), torch.from_numpy(rv),
    ).numpy()

    rset = set(right[rv].tolist())
    expect = lv & np.array([c not in rset for c in left.tolist()])
    np.testing.assert_array_equal(keep, expect)
    np.testing.assert_array_equal(keep, np.asarray(jax_difference(
        jnp.asarray(left), jnp.asarray(lv), jnp.asarray(right),
        jnp.asarray(rv))))
    assert not keep[-1]


def test_negated_reach_row_antijoin_excludes_blocked():
    program, cols, n, _, _, _ = _nr_setup()
    _, t = _compile_both(program, cols, n, storage="row-table")
    reach = t.run(max_iters=64).state["reach"]
    assert isinstance(reach, TE.RowRelation)
    got = set(reach.tuples()[:, 0].tolist())
    # Node 3 is blocked AND a source: N1 (no negation) admits it, but N2's
    # AntiJoin never extends reach INTO a blocked node.
    assert got & {9, 27} == set()
    assert 3 in got


# ---------------------------------------------------------------------------
# 4. Capacity overflow: lossless dense fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on_device", [False, True])
def test_row_cap_overflow_falls_back_to_dense_losslessly(on_device):
    j, t = _compile_both("transitive_closure_program", {"edge": _edges()},
                         N, storage="row-table", row_cap=64)
    _, dense = _compile_both("transitive_closure_program",
                             {"edge": _edges()}, N)
    want = dense.run(max_iters=64, on_device=on_device)
    res = t.run(max_iters=64, on_device=on_device)
    assert res.storage_fallback
    assert j.run(max_iters=64, on_device=on_device).storage_fallback
    assert isinstance(res.state["tc"], TE.Relation)
    assert res.iterations == want.iterations
    assert torch.equal(res.state["tc"].present, want.state["tc"].present)


def _raises_like(make_ref, make_port, match):
    with pytest.raises(Exception, match=match) as want:
        make_ref()
    with pytest.raises(Exception, match=match) as got:
        make_port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_row_cap_overflow_with_row_edb_raises():
    src, dst = _edges()
    _raises_like(
        lambda: JE.compile_program(
            JL.transitive_closure_program(),
            {"edge": JE.RowRelation.from_columns(N, src, dst)},
            storage="row-table", row_cap=64).run(max_iters=64),
        lambda: TE.compile_program(
            TL.transitive_closure_program(),
            {"edge": TE.RowRelation.from_columns(N, src, dst,
                                                 device="cpu")},
            storage="row-table", row_cap=64, device="cpu").run(max_iters=64),
        "row-table capacity overflow")


def test_row_edb_rejects_forced_dense():
    src, dst = _edges()
    _raises_like(
        lambda: JE.compile_program(
            JL.transitive_closure_program(),
            {"edge": JE.RowRelation.from_columns(N, src, dst)},
            storage="dense-grid"),
        lambda: TE.compile_program(
            TL.transitive_closure_program(),
            {"edge": TE.RowRelation.from_columns(N, src, dst,
                                                 device="cpu")},
            storage="dense-grid", device="cpu"),
        "dense")


# ---------------------------------------------------------------------------
# 5. from_columns hardening, the dense round trip, the carry helper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [99, -1])
def test_row_relation_rejects_out_of_domain_ids(bad):
    _raises_like(
        lambda: JE.RowRelation.from_columns(8, np.array([0, bad]),
                                            np.array([1, 2])),
        lambda: TE.RowRelation.from_columns(8, np.array([0, bad]),
                                            np.array([1, 2]), device="cpu"),
        "outside the domain")


def test_row_relation_needs_a_key_column():
    _raises_like(
        lambda: JE.RowRelation.from_columns(8, np.ones(2, np.float32)),
        lambda: TE.RowRelation.from_columns(8, np.ones(2, np.float32),
                                            device="cpu"),
        "integer key column")


def test_row_relation_deduplicates_keep_last():
    keys = np.array([1, 1, 2])
    vals = np.array([10.0, 20.0, 30.0], np.float32)
    row = TE.RowRelation.from_columns(8, keys, np.array([3, 3, 4]), vals,
                                      device="cpu")
    assert row.count() == 2 and row.arity == 3
    assert row.tuples().tolist() == [[1, 3], [2, 4]]
    assert row.values[2].tolist() == [20.0, 30.0]
    assert row.rows.dtype == torch.int32
    empty = TE.RowRelation.from_columns(8, np.zeros(0, np.int64),
                                        np.zeros(0, np.int64), device="cpu")
    assert empty.count() == 0 and empty.tuples().shape == (0, 2)


def test_row_relation_round_trips_to_dense():
    src, dst = _edges(seed=9, m=20)
    w = np.arange(20, dtype=np.float32)
    row = TE.RowRelation.from_columns(N, src, dst, w, device="cpu")
    dense = TE.Relation.from_columns(N, src, dst, w, device="cpu")
    back = row.to_dense()
    assert torch.equal(back.present, dense.present)
    assert torch.equal(back.values[2], dense.values[2])
    ref = JE.RowRelation.from_columns(N, src, dst, w)
    np.testing.assert_array_equal(row.tuples(), ref.rows)
    np.testing.assert_array_equal(row.values[2].numpy(), ref.values[2])


def test_row_relation_from_numpy_carries_a_reference_relation():
    src, dst = _edges(seed=3, m=30)
    w = np.arange(30, dtype=np.float32)
    ref = JE.RowRelation.from_columns(N, src, dst, w)
    mine = row_relation_from_numpy(ref.n, ref.key_positions, ref.rows,
                                   ref.values, device="cpu")
    assert mine.key_positions == (0, 1) and mine.arity == 3
    np.testing.assert_array_equal(mine.tuples(), ref.rows)
    np.testing.assert_array_equal(mine.values[2].numpy(), ref.values[2])
    with pytest.raises(ValueError, match="lexicographic"):
        row_relation_from_numpy(N, (0, 1), ref.rows[::-1], device="cpu")
    with pytest.raises(ValueError, match="outside the domain"):
        row_relation_from_numpy(4, (0, 1), ref.rows, device="cpu")
    with pytest.raises(ValueError, match="value column"):
        row_relation_from_numpy(N, (0, 1), ref.rows, {2: w[:3]},
                                device="cpu")
