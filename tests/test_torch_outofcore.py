"""The port's out-of-core chunk streaming (ROADMAP A12) against the JAX
package: ``compile_program(chunks=, hbm_budget=)`` splits a row-table EDB
slab into identically shaped host chunks that every iteration streams
through the device, folding each chunk's partial outs through the head's
merge monoid.

Required, on the same numpy inputs through both packages:

* chunked transitive closure for m in {1, 2, 7} (7 does not divide the
  slab) exactly equal to the unchunked run and to the JAX package's
  chunked run (at 2 chunks, run once: the reference's answer does not
  depend on the count), with the chunk layout and the ``chunking(...)``
  and ``storage-selection(...)`` notes byte-equal to the reference's at
  every m;
* the PageRank -> threshold -> reach pipeline chunked within 1e-6 relative
  of the unchunked run and of the reference's chunked run (f32 sums folded
  in another order), sets exact;
* a crash in the middle of a chunk stream restores from the last
  checkpoint and lands on the uncrashed answer bit for bit, with the same
  fired events as the reference;
* the fail-closed refusals of the reference, word for word.
"""

import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

from repro.core import algebra as JA
from repro.core import executor as JE
from repro.core import listings as JL
from repro.core import parser as JP
from repro.ft import FailureInjector as JaxInjector
from repro_torch.core import algebra
from repro_torch.core import executor as TE
from repro_torch.core import listings as TL
from repro_torch.core import parser as TP
from repro_torch.ft import FailureInjector

N = 64
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its row-table runs are
    many small ops, which several test processes sharing the cores turn
    into a contention of thread pools (a hundredfold slowdown); the
    results compared are the same."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tc(pkg, **kw):
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, N, 96), rng.integers(0, N, 96)
    if pkg == "jax":
        return JE.compile_program(
            JL.transitive_closure_program(),
            {"edge": JE.Relation.from_columns(N, src, dst)},
            storage="row-table", **kw)
    return TE.compile_program(
        TL.transitive_closure_program(),
        {"edge": TE.Relation.from_columns(N, src, dst, device="cpu")},
        storage="row-table", device="cpu", **kw)


def _pipeline(pkg, n=256, **kw):
    rng = np.random.default_rng(3)
    src = np.repeat(np.arange(n), 3)
    dst = rng.integers(0, n, 3 * n)
    deg = np.bincount(src, minlength=n).astype(np.float32)
    cols = (np.arange(n), np.full(n, 1.0 / n, np.float32), deg,
            np.full(n, 0.15 / n, np.float32))
    E, L, dev = (JE, JL, {}) if pkg == "jax" else (TE, TL, {"device": "cpu"})
    rels = {"edge": E.Relation.from_columns(n, src, dst, **dev),
            "node": E.Relation.from_columns(n, *cols, **dev)}
    return E.compile_program(L.pagerank_threshold_program(tau=1.5 / n), rels,
                             storage="row-table", semi_naive=True, **kw,
                             **dev)


@functools.lru_cache(maxsize=None)
def _jax_chunked_run(program, m):
    """The reference's chunked run at ``m`` chunks, run once a module (its
    answer is the same at every chunk count: sets exactly, values within
    1e-6)."""

    make = _tc if program == "tc" else _pipeline
    return make("jax", chunks={"edge": m}).run(
        max_iters=64 if program == "tc" else 60)


def _sets(rel):
    """(key tuples in lexicographic order, {position: aligned values})."""

    if isinstance(rel, (TE.RowRelation, JE.RowRelation)):
        rel = rel.to_dense()
    present = np.asarray(rel.present)
    return np.argwhere(present), {p: np.asarray(v)[present]
                                  for p, v in rel.values.items()}


def _assert_same(a, b, preds, rtol=0.0):
    for p in preds:
        (ar, av), (br, bv) = _sets(a.state[p]), _sets(b.state[p])
        np.testing.assert_array_equal(ar, br, err_msg=p)
        for k in av:
            if rtol == 0.0:
                np.testing.assert_array_equal(av[k], bv[k], err_msg=p)
            else:
                np.testing.assert_allclose(av[k], bv[k], rtol=rtol, atol=0,
                                           err_msg=p)


@pytest.mark.parametrize("m", (1, 2, 7))
def test_chunked_tc_matches_unchunked_and_jax_exactly(m):
    base = _tc("port")
    chunked = _tc("port", chunks={"edge": m})
    assert chunked.plan.notes == _tc("jax", chunks={"edge": m}).plan.notes
    if m > 1:
        assert f"chunking(edge: {m} chunks" in "".join(chunked.plan.notes)
        assert set(chunked.chunked_edb) == {"edge"}
        assert len(chunked.chunked_edb["edge"]) == m
        assert "edge" not in chunked.row_edb
    else:
        assert not chunked.chunked_edb
    a, b = base.run(max_iters=64), chunked.run(max_iters=64)
    r = _jax_chunked_run("tc", 2)
    assert not a.storage_fallback and not b.storage_fallback
    assert b.iterations == a.iterations == r.iterations
    _assert_same(a, b, ("tc",))
    _assert_same(r, b, ("tc",))


@pytest.mark.parametrize("m", (2, 3, 7))
def test_host_chunks_are_the_references(m):
    """Chunk count, padded capacity, ids, validity and values of every
    chunk equal the reference's host chunks."""

    port = _pipeline("port", chunks={"edge": m}).chunked_edb["edge"]
    ref = _pipeline("jax", chunks={"edge": m}).chunked_edb["edge"]
    assert len(port) == len(ref) == m
    for p, r in zip(port, ref):
        assert p["ids"].dtype == torch.int32 and p["valid"].dtype == torch.bool
        np.testing.assert_array_equal(p["ids"].numpy(), r["ids"])
        np.testing.assert_array_equal(p["valid"].numpy(), r["valid"])
        assert set(p["values"]) == set(r["values"]) == set()
        assert not p["ids"].is_pinned()      # pinned only for the card


@pytest.mark.parametrize("m", (2, 7))
def test_chunked_pipeline_matches_unchunked_and_jax(m):
    base = _pipeline("port").run(max_iters=60)
    chunked = _pipeline("port", chunks={"edge": m}).run(max_iters=60)
    ref = _jax_chunked_run("pipeline", 2)
    for r in (base, chunked, ref):
        assert not r.storage_fallback
    assert chunked.phase_iterations == base.phase_iterations \
        == tuple(ref.phase_iterations)
    _assert_same(base, chunked, ("rank", "hot", "reach"), rtol=RTOL)
    _assert_same(ref, chunked, ("rank", "hot", "reach"), rtol=RTOL)


@pytest.mark.parametrize("budget", (256, 1024))
def test_auto_chunking_from_hbm_budget(budget):
    """A budget smaller than the EDB slab splits the scan automatically,
    with the reference's plan notes, and the streamed fixpoint equals the
    in-memory one exactly."""

    auto = _tc("port", hbm_budget=budget)
    ref = _tc("jax", hbm_budget=budget)
    assert auto.plan.notes == ref.plan.notes
    assert len(auto.chunked_edb["edge"]) == len(ref.chunked_edb["edge"]) > 1
    assert any(n.startswith("chunking(edge:") and f"budget={budget}B" in n
               for n in auto.plan.notes), auto.plan.notes
    assert any(n.startswith("storage-selection(") for n in auto.plan.notes)
    _assert_same(_tc("port").run(max_iters=64), auto.run(max_iters=64),
                 ("tc",))


def test_chunked_crash_mid_chunk_restores_and_converges(tmp_path):
    """A crash part-way through the chunk stream — some chunk partials
    already folded — discards the partial step; the driver restores from
    the last checkpoint and the replay lands on the uninterrupted answer
    exactly, firing the same events as the reference."""

    clean = _tc("port", chunks={"edge": 3}).run(max_iters=64)
    inj = FailureInjector(chunk_crashes=((3, 1), (6, 2)))
    faulted = _tc("port", chunks={"edge": 3}).run(
        max_iters=64, checkpoint_dir=str(tmp_path / "t"),
        checkpoint_every=2, injector=inj)
    ref_inj = JaxInjector(chunk_crashes=((3, 1), (6, 2)))
    _tc("jax", chunks={"edge": 3}).run(
        max_iters=64, checkpoint_dir=str(tmp_path / "j"),
        checkpoint_every=2, injector=ref_inj)
    assert faulted.restarts == 2
    fired = [(e.step, e.kind, e.detail) for e in inj.fired]
    assert fired == [(e.step, e.kind, e.detail) for e in ref_inj.fired]
    assert [d for _, k, d in fired if k == "crash"] == ["chunk 1", "chunk 2"]
    _assert_same(clean, faulted, ("tc",))


def test_chunked_pipeline_crash_is_bit_equal(tmp_path):
    """A crash mid-stream in the value-carrying rank phase: the replayed
    ranks equal the uncrashed chunked run's bit for bit."""

    clean = _pipeline("port", chunks={"edge": 4}).run(max_iters=60)
    inj = FailureInjector(chunk_crashes=((5, 2),))
    res = _pipeline("port", chunks={"edge": 4}).run(
        max_iters=60, checkpoint_dir=str(tmp_path), checkpoint_every=4,
        injector=inj)
    assert res.restarts == 1
    assert [e.detail for e in inj.fired] == ["chunk 2"]
    assert res.phase_iterations == clean.phase_iterations
    _assert_same(clean, res, ("rank", "hot", "reach"))


def test_chunk_fold_runs_the_segment_combine(monkeypatch):
    """Every chunk's partial ranks fold into the accumulator through the
    row merge's segment combine (B1 on the card): at least m combines a
    rank iteration."""

    calls = []
    real = TE.segment_combine_sorted

    def record(*a, **kw):
        calls.append(_caller_names())
        return real(*a, **kw)

    monkeypatch.setattr(TE, "segment_combine_sorted", record)
    res = _pipeline("port", chunks={"edge": 4}).run(max_iters=10)
    folds = sum(1 for names in calls if "fire" in names)
    assert folds >= 4 * res.phase_iterations[0]


def _caller_names(depth=6):
    """The functions on the stack above the combine's caller."""

    f, names = sys._getframe(2), []
    for _ in range(depth):
        if f is None:
            break
        names.append(f.f_code.co_name)
        f = f.f_back
    return names


@pytest.mark.parametrize("m", (2, 7))
def test_per_chunk_intermediate_caps_are_the_references(m, monkeypatch):
    """Inside a chunk firing the shared intermediate cap shrinks to the
    reference's chunk-proportional value."""

    def spy(module, seen):
        real = module.GenericExecutable._materialize

        def wrapped(self, df, inter, ctx):
            seen.add((df.label, ctx.row_cap))
            return real(self, df, inter, ctx)

        monkeypatch.setattr(module.GenericExecutable, "_materialize", wrapped)

    port, ref = set(), set()
    spy(TE, port)
    spy(JE, ref)
    _pipeline("port", chunks={"edge": m}).run(max_iters=3)
    _pipeline("jax", chunks={"edge": m}).run(max_iters=3)
    assert port == ref
    assert len({cap for label, cap in port if label == "P2"}) == 1


def test_chunked_fails_closed_on_device_batched_and_phase_step():
    ex = _tc("port", chunks={"edge": 2})
    with pytest.raises(TE.ExecutorError, match="host"):
        ex.run(max_iters=4, on_device=True)
    with pytest.raises(TE.ExecutorError, match="chunk"):
        ex.run_batched([{}], max_iters=4)
    with pytest.raises(TE.ExecutorError, match="chunked"):
        ex.phase_step_fn()


# ---------------------------------------------------------------------------
# _check_chunk_soundness: every refusal, with the reference's words
# ---------------------------------------------------------------------------

SOUNDNESS = {
    "two-chunked-scans": ("""\
A1: p(0, X, Y) :- edge(X, Y).
A2: p(J+1, X, Y) :- p(J, X, Z), edge(Z, W), e2(W, Y).
A3: p(J+1, X, Y) :- p(J, X, Y).
""", {"edge": 2, "e2": 2}, None),
    "reads-same-phase-view": ("""\
C1: r(0, X) :- src(X, Z).
C2: @frontier f(X) :- r(J, X).
C3: r(J+1, Y) :- f(X), r(J, X), edge(X, Y).
C4: r(J+1, X) :- r(J, X).
""", {"edge": 2}, None),
    "negated-chunked-scan": ("""\
D1: r(0, X) :- src(X, Z).
D2: r(J+1, Y) :- r(J, X), src(Y, W), !edge(X, Y).
D3: r(J+1, X) :- r(J, X).
""", {"edge": 2}, None),
    "values-without-monoid": ("""\
E1: w(0, X, V) :- wedge(X, Y, V).
E2: w(J+1, X, V) :- w(J, X, V).
""", {"wedge": 2}, None),
    # The translator never emits these two shapes; the check must still
    # refuse them (the executable is altered after a sound compile).
    "per-iteration-view": ("""\
B1: r(0, X) :- src(X, Z).
B2: r(J+1, Y) :- r(J, X), edge(X, Y).
B3: r(J+1, X) :- r(J, X).
""", {"edge": 2}, "view"),
    "aggregate-not-the-head-monoid": ("""\
F1: c(0, X, L) :- src(X, L).
F2: c(J+1, X, min<L>) :- c(J, Y, L), edge(Y, X).
F3: c(J+1, X, L) :- c(J, X, L).
""", {"edge": 2}, "monoid"),
}


def _soundness_error(pkg, text, chunks, alter):
    P, E, dev = (JP, JE, {}) if pkg == "jax" else (TP, TE, {"device": "cpu"})
    rng = np.random.default_rng(0)
    s, d = rng.integers(0, 16, 30), rng.integers(0, 16, 30)
    prog = P.parse(text)
    rels = {
        "edge": E.Relation.from_columns(16, s, d, **dev),
        "e2": E.Relation.from_columns(16, d, s, **dev),
        "src": E.Relation.from_columns(
            16, np.arange(4), np.arange(4).astype(np.float32), **dev),
        "wedge": E.Relation.from_columns(
            16, s, d, rng.random(30).astype(np.float32), **dev),
    }
    rels = {k: v for k, v in rels.items() if k in prog.edb}
    with pytest.raises(E.ExecutorError) as err:
        ex = E.compile_program(prog, rels, storage="row-table",
                               chunks=chunks, **dev)
        if alter == "view":
            ph = ex.phases[0]
            body = tuple(dataclasses.replace(df, next_state=False)
                         if df.label == "B2" else df for df in ph.body)
            ex.phases = (dataclasses.replace(ph, body=body),)
        elif alter == "monoid":
            ex.merge_monoids["c"] = "max"
        E._check_chunk_soundness(ex)
    return str(err.value)


@pytest.mark.parametrize("case", sorted(SOUNDNESS))
def test_soundness_refusal_is_the_references(case):
    text, chunks, alter = SOUNDNESS[case]
    msg = _soundness_error("port", text, chunks, alter)
    assert msg == _soundness_error("jax", text, chunks, alter)
    assert msg.endswith("(fail closed)") or "fail closed" in msg


def test_scan_outside_a_chunk_overlay_refuses():
    msgs = []
    for E, A, pkg in ((TE, algebra, "port"), (JE, JA, "jax")):
        ex = _tc(pkg, chunks={"edge": 2})
        scan = A.ScanEDB("edge", ("X", "Y"))
        ctx = ex._ctx({}, {}, {}, 0)
        with pytest.raises(E.ExecutorError) as err:
            E._eval(scan, ctx)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "scanned outside a chunk overlay" in msgs[0]
