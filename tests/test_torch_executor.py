"""The port's generic dense-grid engine against the JAX package.

The programs of ``tests/test_executor.py`` go through ``compile_program`` of
both packages on relations built from the same numpy arrays (the port's
through ``Relation.from_columns`` or ``carry.relation_from_numpy``), on the
host driver and on ``device_fixpoint``.  Required: plan notes byte-equal
(``hw`` the TPU model, the default of both); set-valued results (TC, CC,
same-generation, reachability) exactly equal to the reference's and to a
numpy oracle; f32 values within 1e-6 relative of the reference's (sums
taken in another order).  Listing 1 through ``compile_program(binding=)``
matches the port's ``compile_pregel`` to <= 1e-8 (the same operators).
The fail-closed errors raise the same exception types with the same
messages (up to the package name in a module path), and every option of
a later queue item raises ``NotImplementedError`` naming it.  Per-query
parameters and query batching are held in ``tests/test_torch_serving.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import executor as JE
from repro.core import listings as JL
from repro_torch.carry import graph_from_numpy, relation_from_numpy
from repro_torch.core import executor as TE
from repro_torch.core import listings as TL
from repro_torch.core.datalog import Aggregate
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.pregel import VertexProgram, compile_pregel

CONNECTORS = ("dense_psum", "merging", "hash_sort")
N = 32
RTOL = 1e-6


def _both(*cols):
    """(reference Relation, port Relation) of the same columns."""

    return (JE.Relation.from_columns(N, *cols),
            TE.Relation.from_columns(N, *cols, device="cpu"))


def _compile(name, cols_by_pred, **kw):
    """Compile ``listings.<name>()`` in both packages over relations of the
    same numpy columns; the plan notes must be byte-equal."""

    rels = {p: _both(*cols) for p, cols in cols_by_pred.items()}
    prog_kw = kw.pop("prog_kw", {})
    j = JE.compile_program(getattr(JL, name)(**prog_kw),
                           {p: r[0] for p, r in rels.items()}, **kw)
    t = TE.compile_program(getattr(TL, name)(**prog_kw),
                           {p: r[1] for p, r in rels.items()},
                           device="cpu", **kw)
    assert t.plan.notes == j.plan.notes
    return j, t


def _edges(seed=0, m=48):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N, m), rng.integers(0, N, m)


def _tc_oracle(src, dst):
    adj = np.zeros((N, N), bool)
    adj[src, dst] = True
    tc = adj.copy()
    while True:
        new = tc | (tc @ adj)
        if (new == tc).all():
            return tc
        tc = new


def _assert_same(want, got, exact=True):
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert got.phase_iterations == tuple(want.phase_iterations)
    assert set(got.state) == set(want.state)
    for pred, rel in want.state.items():
        mine = got.state[pred]
        present = np.asarray(rel.present)
        np.testing.assert_array_equal(mine.present.numpy(), present)
        assert set(mine.values) == set(rel.values)
        for p, g in rel.values.items():
            a, b = mine.values[p].numpy()[present], np.asarray(g)[present]
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("semi_naive", [False, True])
def test_transitive_closure_matches_jax_and_oracle(semi_naive, on_device):
    src, dst = _edges(seed=3 if on_device else 0)
    j, t = _compile("transitive_closure_program", {"edge": (src, dst)},
                    semi_naive=semi_naive)
    want = j.run(max_iters=64, on_device=on_device)
    got = t.run(max_iters=64, on_device=on_device)
    assert got.converged
    _assert_same(want, got)
    assert (got.state["tc"].present.numpy() == _tc_oracle(src, dst)).all()


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("semi_naive", [False, True])
def test_connected_components_matches_jax_and_oracle(semi_naive, on_device):
    src, dst = _edges(seed=1, m=40)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    j, t = _compile("connected_components_program", {
        "edge": (s2, d2),
        "node": (np.arange(N), np.arange(N, dtype=np.float32)),
    }, semi_naive=semi_naive)
    if semi_naive:
        assert "semi-naive(C2: cc -> Δcc)" in t.plan.notes
    want = j.run(max_iters=100, on_device=on_device)
    got = t.run(max_iters=100, on_device=on_device)
    _assert_same(want, got)  # min labels: exact in any order
    lab = np.arange(N, dtype=np.float32)
    while True:
        new = lab.copy()
        for y, x in zip(s2, d2):
            new[x] = min(new[x], lab[y])
        if (new == lab).all():
            break
        lab = new
    assert got.state["cc"].present.numpy().all()
    assert (got.state["cc"].values[1].numpy() == lab).all()


@pytest.mark.parametrize("on_device", [False, True])
def test_same_generation_matches_jax_and_oracle(on_device):
    rng = np.random.default_rng(4)
    par_p, par_c = rng.integers(0, N, 36), rng.integers(0, N, 36)
    j, t = _compile("same_generation_program", {"parent": (par_p, par_c)})
    want = j.run(max_iters=100, on_device=on_device)
    got = t.run(max_iters=100, on_device=on_device)
    _assert_same(want, got)
    par = np.zeros((N, N), bool)
    par[par_p, par_c] = True
    sg = (par.T @ par) > 0
    while True:
        new = sg | (par.T @ sg @ par)
        if (new == sg).all():
            break
        sg = new
    assert (got.state["sg"].present.numpy() == sg).all()


@pytest.mark.parametrize("on_device", [False, True])
def test_multi_stratum_pipeline_matches_jax_and_oracle(on_device):
    """PageRank -> threshold over the converged ranks -> reachability: the
    ranks within 1e-6 relative of the reference's and of a numpy oracle,
    the hot set and the reachable set exact."""

    rng = np.random.default_rng(2)
    src = np.repeat(np.arange(N), 3)
    dst = rng.integers(0, N, 3 * N)
    deg = np.bincount(src, minlength=N).astype(np.float32)
    iters = 40
    adj = np.zeros((N, N), np.float32)
    adj[src, dst] = 1.0
    r = np.full(N, 1.0 / N, np.float32)
    for _ in range(iters):
        r = (0.85 * (adj.T @ (r / np.maximum(deg, 1.0)))
             + 0.15 / N).astype(np.float32)
    srt = np.sort(r)
    gi = int(np.argmax(np.diff(srt)))
    tau = float((srt[gi] + srt[gi + 1]) / 2)
    j, t = _compile("pagerank_threshold_program", {
        "edge": (src, dst),
        "node": (np.arange(N), np.full(N, 1.0 / N, np.float32), deg,
                 np.full(N, 0.15 / N, np.float32)),
    }, prog_kw={"tau": tau})
    want = j.run(max_iters=iters, on_device=on_device)
    got = t.run(max_iters=iters, on_device=on_device)
    _assert_same(want, got, exact=False)
    assert got.phase_iterations[0] == iters
    rank = got.state["rank"].values[1].numpy()
    np.testing.assert_allclose(rank, r, rtol=RTOL, atol=0)
    hot = r > tau
    assert (got.state["hot"].present.numpy() == hot).all()
    reach = hot.copy()
    while True:
        new = reach | ((((adj > 0).T @ reach) > 0) & hot)
        if (new == reach).all():
            break
        reach = new
    assert (got.state["reach"].present.numpy() == reach).all()


@pytest.mark.parametrize("on_device", [False, True])
def test_segment_scan_groupby_on_a_tiny_grid_matches_jax(on_device):
    """On a grid of at most 21 cells the planner picks the segment scan
    even for a sum (the route that reaches the segment-combine kernel on
    the card): PageRank -> threshold -> reach on 4 vertices.  Notes
    byte-equal, ranks within 1e-6 relative of the reference's, sets
    exact."""

    n, iters = 4, 30
    src = np.repeat(np.arange(n), 2)
    dst = np.array([1, 2, 2, 3, 1, 2, 0, 2])
    deg = np.bincount(src, minlength=n).astype(np.float32)
    cols = {"edge": (src, dst),
            "node": (np.arange(n), np.full(n, 1.0 / n, np.float32), deg,
                     np.full(n, 0.15 / n, np.float32))}
    j = JE.compile_program(
        JL.pagerank_threshold_program(tau=0.25),
        {p: JE.Relation.from_columns(n, *c) for p, c in cols.items()})
    t = TE.compile_program(
        TL.pagerank_threshold_program(tau=0.25),
        {p: TE.Relation.from_columns(n, *c, device="cpu")
         for p, c in cols.items()}, device="cpu")
    assert t.plan.notes == j.plan.notes
    assert t.plan.connectors["P2"] == "segment-scan"
    want = j.run(max_iters=iters, on_device=on_device)
    got = t.run(max_iters=iters, on_device=on_device)
    _assert_same(want, got, exact=False)
    assert got.state["hot"].present.any()


def test_plan_records_phases_and_groupby_connectors():
    src, dst = _edges()
    deg = np.bincount(src, minlength=N).astype(np.float32)
    cols = {"edge": (src, dst),
            "node": (np.arange(N), np.full(N, 1.0 / N, np.float32), deg,
                     np.full(N, 0.15 / N, np.float32))}
    _, t = _compile("pagerank_threshold_program", cols)
    assert "fixpoint-phases(rank -> reach)" in t.plan.notes
    assert f"groupby(P2: sum via dense-reduce, {N * N} rows -> {N})" \
        in t.plan.notes
    assert t.plan.connectors["P2"] == "dense-reduce"
    # Golden notes under the H100 model (the plan does not depend on the
    # hardware at this size).
    rels = {p: TE.Relation.from_columns(N, *c, device="cpu")
            for p, c in cols.items()}
    h100 = TE.compile_program(TL.pagerank_threshold_program(), rels,
                              hw=H100_SXM, device="cpu")
    assert h100.plan.notes == (
        f"storage-selection(dense-grid[n={N}])",
        "loop-invariant-caching(edb-grids)",
        "fixpoint-phases(rank -> reach)",
        f"groupby(P2: sum via dense-reduce, {N * N} rows -> {N})",
    )


def test_relation_from_numpy_carries_a_reference_relation():
    src, dst = _edges()
    deg = np.bincount(src, minlength=N).astype(np.float32)
    ref = JE.Relation.from_columns(N, np.arange(N), deg)
    mine = relation_from_numpy(
        ref.n, ref.key_positions, np.asarray(ref.present),
        {p: np.asarray(g) for p, g in ref.values.items()}, device="cpu")
    assert mine.key_positions == (0,) and mine.arity == 2
    np.testing.assert_array_equal(mine.values[1].numpy(), deg)
    edge = relation_from_numpy(N, (0, 1), _tc_oracle(src, dst) & False,
                               device="cpu")
    assert edge.count() == 0
    with pytest.raises(ValueError, match="present has shape"):
        relation_from_numpy(N, (0, 1), np.zeros(N, bool), device="cpu")


def test_relation_from_columns_splits_keys_and_values():
    rel = TE.Relation.from_columns(
        8, np.array([1, 3]), np.array([0.5, 2.5], np.float32), device="cpu"
    )
    assert rel.key_positions == (0,)
    assert rel.arity == 2
    assert rel.count() == 2
    assert float(rel.values[1][3]) == 2.5
    assert rel.tuples().tolist() == [[1], [3]]


def test_zero_edge_transitive_closure_matches_jax():
    # The semi-naive Delta scans of an empty EDB stay empty: one iteration.
    empty = np.zeros(0, np.int64)
    for semi_naive in (False, True):
        j, t = _compile("transitive_closure_program", {"edge": (empty, empty)},
                        semi_naive=semi_naive)
        want, got = j.run(max_iters=8), t.run(max_iters=8)
        _assert_same(want, got)
        assert got.state["tc"].count() == 0


# ---------------------------------------------------------------------------
# Listing 1 through compile_program vs the port's compile_pregel
# ---------------------------------------------------------------------------


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


def _sssp_vp():
    return VertexProgram(
        init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, 1e9),
        message=lambda j, s, ed: s + 1.0,
        apply=lambda j, s, inbox, got: (
            torch.minimum(s, inbox), torch.minimum(s, inbox) < s),
        combine="min",
    )


def _graph(seed=5):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(N), 4).astype(np.int32)
    dst = rng.integers(0, N, 4 * N).astype(np.int32)
    outdeg = np.bincount(src, minlength=N).astype(np.float32)
    return graph_from_numpy(N, src, dst, outdeg, device="cpu")


@pytest.mark.parametrize("semi_naive", [False, True])
@pytest.mark.parametrize("connector", CONNECTORS)
@pytest.mark.parametrize("make_vp,iters", [(_pagerank_vp, 12),
                                           (_sssp_vp, 40)])
def test_listing1_via_compile_program_matches_compile_pregel(
    make_vp, iters, connector, semi_naive
):
    vp, g = make_vp(), _graph(seed=6 if semi_naive else 5)
    spec = compile_pregel(vp, g, force_connector=connector,
                          semi_naive=semi_naive, device="cpu")
    gen = TE.compile_program(vp.program(), {"data": g}, binding=vp,
                             force_connector=connector,
                             semi_naive=semi_naive, device="cpu")
    assert type(gen).__name__ == "PregelExecutable"
    assert gen.plan.notes == spec.plan.notes
    a, b = spec.run(max_iters=iters), gen.run(max_iters=iters)
    assert a.iterations == b.iterations and a.modes == b.modes
    assert float((a.state[0] - b.state[0]).abs().max()) <= 1e-8


# ---------------------------------------------------------------------------
# Fail-closed surfaces: the reference's exception types and messages
# ---------------------------------------------------------------------------


def _raises_like(make_ref, make_port):
    """Both calls raise the same exception type with the same message (a
    message that names a module names each package's own)."""

    with pytest.raises(Exception) as want:
        make_ref()
    with pytest.raises(Exception) as got:
        make_port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)
    return got.value


def test_listing_program_without_binding_is_rejected():
    from repro.core.pregel import Graph as JaxGraph
    import jax.numpy as jnp

    g = _graph()
    jg = JaxGraph(N, jnp.asarray(g.src.numpy()), jnp.asarray(g.dst.numpy()),
                  jnp.asarray(g.vertex_data.numpy()))
    err = _raises_like(
        lambda: JE.compile_program(JL.pregel_program(aggregates={
            "combine": Aggregate("combine", zero=lambda: 0.0,
                                 combine=lambda a, b: a + b)}),
            {"data": jg}),
        lambda: TE.compile_program(_pagerank_vp().program(), {"data": g},
                                   device="cpu"),
    )
    assert isinstance(err, TE.ExecutorError) and "binding" in str(err)


def test_missing_edb_relation_is_rejected():
    err = _raises_like(
        lambda: JE.compile_program(JL.transitive_closure_program(), {},
                                   domain=N),
        lambda: TE.compile_program(TL.transitive_closure_program(), {},
                                   domain=N, device="cpu"),
    )
    assert isinstance(err, TE.ExecutorError) and "edge" in str(err)


def _mystery(prog):
    bogus = Aggregate("mystery", zero=lambda: 0.0, combine=min)
    rules = tuple(
        dataclasses.replace(r, head=dataclasses.replace(r.head, args=tuple(
            dataclasses.replace(a, agg="mystery") if hasattr(a, "agg")
            else a for a in r.head.args)))
        for r in prog.rules
    )
    return dataclasses.replace(prog, rules=rules,
                               aggregates={"mystery": bogus})


def test_unregistered_aggregate_is_rejected():
    src, dst = _edges()
    rels = {"edge": _both(src, dst),
            "node": _both(np.arange(N), np.arange(N, dtype=np.float32))}
    err = _raises_like(
        lambda: JE.compile_program(
            _mystery(JL.connected_components_program()),
            {p: r[0] for p, r in rels.items()}),
        lambda: TE.compile_program(
            _mystery(TL.connected_components_program()),
            {p: r[1] for p, r in rels.items()}, device="cpu"),
    )
    assert isinstance(err, TE.ExecutorError) and "monoid" in str(err)


def test_out_of_domain_vertex_id_is_rejected():
    _raises_like(
        lambda: JE.Relation.from_columns(4, np.array([0, 4])),
        lambda: TE.Relation.from_columns(4, np.array([0, 4]), device="cpu"),
    )


def test_raw_array_without_domain_is_rejected():
    edges = np.stack(_edges(), axis=1)
    _raises_like(
        lambda: JE.compile_program(JL.transitive_closure_program(),
                                   {"edge": edges}),
        lambda: TE.compile_program(TL.transitive_closure_program(),
                                   {"edge": edges}, device="cpu"),
    )


def test_compile_program_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    src, dst = _edges()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.Relation.from_columns(N, src, dst)
    rel = TE.Relation.from_columns(N, src, dst, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.compile_program(TL.transitive_closure_program(), {"edge": rel})


# ---------------------------------------------------------------------------
# Options of later queue items raise, naming the item
# ---------------------------------------------------------------------------


def _tc(**kw):
    src, dst = _edges()
    rel = TE.Relation.from_columns(N, src, dst, device="cpu")
    return TE.compile_program(TL.transitive_closure_program(), {"edge": rel},
                              device="cpu", **kw)


@pytest.mark.parametrize("kw,item", [
    ({"storage": {"tc": "row-table"}, "mesh": object()}, "A10"),
    ({"row_cap": 64, "exchange": "bucket-a2a"}, "A10"),
    ({"mesh": object()}, "A10"),
    ({"exchange": "bucket-a2a"}, "A10"),
])
def test_unported_compile_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _tc(**kw)


def test_forced_dense_storage_runs():
    ex = _tc(storage="dense-grid")
    assert ex.run(max_iters=64).converged


def test_run_with_empty_params_equals_run():
    # params={} runs as no params, in both packages.
    src, dst = _edges()
    j = JE.compile_program(JL.transitive_closure_program(),
                           {"edge": JE.Relation.from_columns(N, src, dst)})
    want = np.asarray(j.run(max_iters=64, params={}).state["tc"].present)
    assert np.array_equal(
        want, np.asarray(j.run(max_iters=64).state["tc"].present))
    ex = _tc()
    got = ex.run(max_iters=64, params={})
    assert got.converged
    assert np.array_equal(got.state["tc"].present.numpy(), want)
    assert np.array_equal(ex.run(max_iters=64).state["tc"].present.numpy(),
                          want)


def test_remesh_and_run_batched_raise():
    ex = _tc()
    with pytest.raises(NotImplementedError, match="A10"):
        ex.remesh(None)
    src, dst = _edges()
    j = JE.compile_program(JL.transitive_closure_program(),
                           {"edge": JE.Relation.from_columns(N, src, dst)})
    err = _raises_like(lambda: j.run_batched([{}], max_iters=4),
                       lambda: ex.run_batched([{}], max_iters=4))
    assert isinstance(err, TE.ExecutorError) \
        and "parameterized bindings" in str(err)


def test_raw_array_past_the_dense_limit_raises():
    # A raw array whose grid would pass 2^24 cells becomes a RowRelation,
    # which cannot be forced onto a dense grid: the reference's error.
    edges = np.array([[0, 1], [1, 2]])
    err = _raises_like(
        lambda: JE.compile_program(JL.transitive_closure_program(),
                                   {"edge": edges}, domain=1 << 13,
                                   storage="dense-grid"),
        lambda: TE.compile_program(TL.transitive_closure_program(),
                                   {"edge": edges}, domain=1 << 13,
                                   storage="dense-grid", device="cpu"),
    )
    assert isinstance(err, TE.ExecutorError) and "RowRelation" in str(err)
