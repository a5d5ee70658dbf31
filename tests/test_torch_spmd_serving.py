"""Serving on a mesh (ROADMAP A10d) in the port, against its own unmeshed
server and against the JAX package's server on one device.

One module fixture launches 8 ``gloo`` ranks of the port once
(``launch_ranks``, a FileStore under ``tmp_path``) and meanwhile runs the
JAX package's side in process; each rank serves the
battery of the JAX package's sharded serving program
(``spmd_serving_program.py``: personalized PageRank from 4 seed sets and 4
reachability probes on its 64-vertex graph) first on the ``(8,)`` data
mesh, then on a ``(2, 4)`` ``("pod", "data")`` mesh, and on the data mesh
also the segment-scan programs of ``chip_smoke.py``'s serve part (e), a
row-table program, the request loop and an index audit
(``_spmd_serving_workloads.py``).  The JAX package answers in process on
one device; no 8-device JAX subprocess runs: ``test_spmd_serving.py``
holds the JAX package's 8-device answers within 1e-8 of its one-device
answers.

Bars, on both meshes (``test_spmd_serving.py``'s where it has one):
batched PageRank within 1e-8 of sequential on the mesh, sequential within
1e-8 of the port's unmeshed server, and within 1e-6 relative of the JAX
package's server; reachability's hit and reach sets equal on every path;
a warm batched request hits the plan cache with no compile and places no
shared relation again (the executables read the EDB cache's blocks as
they are); plan keys the reference's digests, different on each mesh and
off it; plan and admission notes the reference's for the mesh's shape; a
batched request of 4 queries makes as many collective calls as one
query's sequential request; each rank's EDB entry holds ``n / 8`` rows.
On the data mesh: the segment-scan programs batched within
``kernel.sum_depth``'s bar of sequential (max/min bit-equal) and within
1e-6 relative of the JAX package's batched answers; a row-table program
admitted sequentially, ``force="batched"`` refused with the reference's
words; the request loop's answers in arrival order, the same on every
rank and equal to one-by-one dispatch; every segment id the batched
combines receive in range and sorted (C1, C2).
"""

from __future__ import annotations

import types
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

import _spmd_serving_workloads as W
from repro_torch.launch.mesh import launch_ranks

MESH_TOL = 1e-8          # test_spmd_serving.py's bar
REL_TOL = 1e-6           # against the JAX package's f32 sums
LAUNCH_TIMEOUT = 600.0
TAGS = tuple(W.MESHES)
F32_UNIT = 2.0 ** -24


def _mesh_spec(tag):
    from repro.core.hardware import MeshSpec

    shape, axes = W.MESHES[tag]
    return MeshSpec(tuple(zip(axes, shape)))


def _jax_on(tag):
    """A context in which the JAX package plans on ``tag``'s mesh shape."""

    from repro.core import executor as JE

    real = JE.plan_program

    def planned(groups, specs, domain, _spec, *a, **kw):
        return real(groups, specs, domain, _mesh_spec(tag), *a, **kw)

    return mock.patch.object(JE, "plan_program", planned)


def _jax_side():
    """The JAX package's server on one device: the answers, the notes it
    plans for each mesh shape, and its row-table refusal."""

    J = W.Pkg(False)
    ppr = J.S.personalized_pagerank_program()
    reach = J.S.point_reachability_program()
    batch = [J.seed(vs) for vs in W.SEED_SETS]
    server = J.S.FixpointServer(J.shared())
    out = {
        "ppr": W.ranks_of(server.query(ppr, batch, max_iters=W.PPR_ITERS,
                                       force="sequential")),
        "rows": W.ranks_of(server.query(
            ppr, [J.seed(vs) for vs in W.ROW_SEEDS], max_iters=W.PPR_ITERS,
            force="sequential")),
        "reach": {p: W.hits_of(server.query(
            reach, [J.probe(a, t) for a, t in W.PROBES], max_iters=W.N,
            force="sequential"), p) for p in ("hit", "reach")},
        "notes": {}, "keys": {},
    }
    for tag in TAGS:
        with _jax_on(tag):
            s = J.S.FixpointServer(J.shared())
            out["notes"][tag] = {
                "batched": list(s.query(ppr, batch, max_iters=W.PPR_ITERS,
                                        force="batched").notes),
                "admitted": list(s.query(ppr, batch,
                                         max_iters=W.PPR_ITERS).notes),
                "one": list(s.query(ppr, batch[:1], max_iters=W.PPR_ITERS,
                                    force="sequential").notes)}
        shape, axes = W.MESHES[tag]
        out["keys"][tag] = J.S.plan_cache_key(
            ppr, J.shared(), param_names=("seed",),
            mesh=types.SimpleNamespace(axis_names=axes,
                                       devices=np.empty(shape, object)))
    out["keys"]["single"] = server.plan_key(ppr, ("seed",))
    try:
        J.S.FixpointServer(J.shared(), storage="row-table").query(
            ppr, [J.seed(vs) for vs in W.ROW_SEEDS], max_iters=W.PPR_ITERS,
            force="batched")
        out["row_refusal"] = None
    except J.E.ExecutorError as err:
        out["row_refusal"] = str(err)
    scan = J.S.FixpointServer(J.shared(W.SCAN_N, W.SCAN_SRC, W.SCAN_DST))
    seeds, labs = J.scan_batches()
    out["scan"] = {}
    for tag, prog, params, preds in (("sum", ppr, seeds, ("rank",)),
                                     ("max/min", J.spread(), labs,
                                      ("hi", "lo"))):
        res = scan.query(prog, params, max_iters=W.SCAN_ITERS,
                         force="batched")
        out["scan"][tag] = {p: [W.grid(a[p]) for a in res.answers]
                            for p in preds}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 8 ranks' answers, the JAX package's), the JAX package's made
    while the ranks run."""

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch_ranks, W.rank_main, 8,
                            store_dir=str(tmp_path_factory.mktemp("serving")),
                            timeout=LAUNCH_TIMEOUT)
        jax = _jax_side()
        return ranks.result(), jax


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_side(runs):
    return runs[1]


def _gap(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _rel_gap(got, want):
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The sharded serving program's bars, on both meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_ppr_batched_matches_sequential_on_the_mesh(ranks, tag):
    for r in ranks:
        got = r[tag]
        assert got["dispatch"] == (True, False)   # ppr_batched_dispatch
        assert _gap(got["ppr"]["batched"], got["ppr"]["sequential"]) \
            <= MESH_TOL


@pytest.mark.parametrize("tag", TAGS)
def test_ppr_on_the_mesh_matches_the_unmeshed_server(ranks, tag):
    for r in ranks:
        assert _gap(r[tag]["ppr"]["sequential"], r[tag]["ppr"]["single"]) \
            <= MESH_TOL


@pytest.mark.parametrize("tag", TAGS)
def test_ppr_matches_the_jax_server(ranks, jax_side, tag):
    for r in ranks:
        for path in ("batched", "sequential"):
            assert _rel_gap(r[tag]["ppr"][path], jax_side["ppr"]) <= REL_TOL


@pytest.mark.parametrize("tag", TAGS)
def test_reachability_hit_sets_agree(ranks, jax_side, tag):
    for r in ranks:
        for pred in ("hit", "reach"):
            want = jax_side["reach"][pred]
            assert any(h.any() for h in want) or pred == "hit"
            for path in ("batched", "sequential", "single"):
                got = r[tag]["reach"][path][pred]
                assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("tag", TAGS)
def test_warm_request_hits_both_caches(ranks, tag):
    """``meshed_warm_hit``, and the warm request places nothing: the EDB
    cache's counters do not move, and the executables compiled against it
    read its entries as they are (the reachability plan's cold compile hit
    the cached edge block)."""

    for r in ranks:
        got = r[tag]
        assert got["warm"]["hit"] and got["warm"]["compile_seconds"] == 0.0
        before, after = got["warm"]["edb"]
        assert before == after == {"hits": 1, "misses": 2, "size": 2}
        assert got["edb"]["counters"][0] == {"hits": 0, "misses": 2,
                                             "size": 2}
        assert got["edb"]["shared"]


def test_plan_keys_are_the_reference_digests(ranks, jax_side):
    """``mesh_changes_key``: the meshed key differs from the unmeshed one
    and the two meshes' keys differ; each is the reference's digest for a
    mesh of the same axes and sizes."""

    for r in ranks:
        keys = {tag: r[tag]["keys"]["meshed"] for tag in TAGS}
        for tag in TAGS:
            assert keys[tag] == jax_side["keys"][tag]
            assert r[tag]["keys"]["single"] == jax_side["keys"]["single"]
        assert len(set(keys.values()) | {jax_side["keys"]["single"]}) == 3


@pytest.mark.parametrize("tag", TAGS)
def test_admission_notes_equal_the_reference(ranks, jax_side, tag):
    for r in ranks:
        assert r[tag]["notes"] == jax_side["notes"][tag]


@pytest.mark.parametrize("tag", TAGS)
def test_batched_request_shares_each_collective(ranks, tag):
    """A batched request of 4 queries makes as many collective calls as
    one query's sequential request of as many iterations: every
    collective of an iteration carries the 4 queries, and the 4
    convergence flags are agreed in one all-reduce an iteration."""

    for r in ranks:
        got = r[tag]
        iters = got["iterations"][0]
        assert got["iterations"] == (iters, iters)
        assert got["calls"]["batched"] == got["calls"]["one"]
        assert got["calls"]["batched"]["pmax"] == iters
        assert got["calls"]["batched"]["all_gather"] > iters


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_edb_entry_holds_a_block(ranks, tag):
    rows = W.N // 8
    for r in ranks:
        got = r[tag]["edb"]
        assert got["edge"] == (rows, W.N) and got["deg"] == (rows,)
        assert got["sharded"] == ["deg", "edge", "rank", "seed"]


def test_every_rank_answers_alike(ranks):
    for tag in TAGS:
        for r in ranks[1:]:
            for path in ("batched", "sequential"):
                assert all(np.array_equal(a, b) for a, b in zip(
                    r[tag]["ppr"][path], ranks[0][tag]["ppr"][path]))


# ---------------------------------------------------------------------------
# On the data mesh: segment scans, row tables, the request loop, the audit
# ---------------------------------------------------------------------------


def _sum_bar(iterations):
    """``iterations`` times the two combines' rounding (the batched one at
    width 16, a query's own at width 1) as ``kernel.sum_depth`` bounds it,
    relative to a rank mass of at most 1 (the walk contracts in L1)."""

    from repro_torch.kernels.segment_combine import kernel

    segments = W.SCAN_N
    ids = torch.repeat_interleave(torch.arange(segments, dtype=torch.int32),
                                  W.SCAN_N)

    def gamma(d):
        return d * F32_UNIT / (1.0 - d * F32_UNIT)

    d1 = float(kernel.summation_depths(ids, segments, 1).max())
    d2 = float(kernel.summation_depths(ids, segments, W.SCAN_K).max())
    return iterations * (gamma(d1) + gamma(d2))


@pytest.mark.parametrize("tag", ["sum", "max/min"])
def test_segment_scan_program_batched_on_the_mesh(ranks, jax_side, tag):
    for r in ranks:
        got = r["scan"][tag]
        assert got["connectors"] == ["segment-scan"]
        bar = _sum_bar(got["iterations"][0])
        for pred, answers in got["batched"].items():
            seq = got["sequential"][pred]
            for (bp, bv), (sp, sv), (jp, jv) in zip(
                    answers, seq, jax_side["scan"][tag][pred]):
                assert np.array_equal(bp, sp) and np.array_equal(bp, jp)
                b, s, j = (np.where(p, v[1], 0.0).astype(np.float64)
                           for p, v in ((bp, bv), (sp, sv), (jp, jv)))
                if tag == "sum":
                    assert np.abs(b - s).sum() <= bar
                else:
                    assert np.array_equal(b, s)
                assert np.abs(b - j).max() <= REL_TOL * max(
                    np.abs(j).max(), 1e-30)


def test_row_table_program_is_served_sequentially(ranks, jax_side):
    for r in ranks:
        got = r["rows"]
        assert got["refusal"] == jax_side["row_refusal"] is not None
        assert not got["batched"]
        assert "sequential" in got["note"] and "row-table" in got["note"]
        assert _rel_gap(got["ranks"], jax_side["rows"]) <= REL_TOL


def test_request_loop_answers_alike_on_every_rank(ranks):
    kinds = [k for k, count in W.LOOP_RUNS for _ in range(count)]
    for r in ranks:
        got = r["loop"]
        assert got["tags"] == [f"{k}{i}" for i, k in enumerate(kinds)]
        assert max(got["batches"]) == W.LOOP_MAX_BATCH
        for kind, a, solo in zip(kinds, got["answers"], got["solo"]):
            if kind == "ppr":
                assert np.abs(a - solo).max() <= MESH_TOL
            else:
                assert np.array_equal(a, solo)
        assert got["batches"] == ranks[0]["loop"]["batches"]
        assert all(np.array_equal(a, b) for a, b in zip(
            got["answers"], ranks[0]["loop"]["answers"]))


def test_batched_segment_ids_stay_in_range(ranks):
    """C1 and C2 at the batched combines: ids in range and sorted, and the
    batching rule's one call a firing carries the 16 queries."""

    for r in ranks:
        got = r["audit"]
        assert got["calls"] > 0 and got["bad"] == []
        assert W.SCAN_K in got["widths"]
