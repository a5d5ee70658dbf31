"""The port's online serving layer (ROADMAP A13) against the JAX package.

The battery of ``tests/test_serving.py`` on the port's API, at its size
(N = 24, the same graph, seed sets and probes), each relation built by
both packages from the same numpy arrays:

1. **Plan-cache keys** are the reference's sha256 hex digests: hits on
   text that differs in whitespace and comments, misses on a changed rule,
   monoid, storage, rewrite or epoch; LRU order and counters.
2. **Answers**: personalized PageRank batched, sequential and through
   ``run(params=)`` within 1e-6 * max|ref| of the reference's,
   reachability ``reach``/``hit`` exactly equal, on the host driver and
   on ``device_fixpoint``; batched within 1e-8 of sequential inside the
   port (the reference test's bar).
3. **Fail closed**: every refusal raises the reference's exception with
   the reference's message.
4. **Admission**: decisions and ``serving(...)`` notes byte-equal, the
   memory guard included.
5. **Caches and the front door**: warm requests, the EDB cache's
   counters, the epoch bump, ``top_k``, ``serve_request_loop``.
6. **The segment combine under vmap** (its batching rule, on the plain
   version): each query equal to its own call; and a program whose
   GroupBys take the segment scan (4 vertices, 16-cell grids), batched
   against the reference's ``run_batched``.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.configs import pagerank as JPR
from repro.core import executor as JE
from repro.core import serving as JS
from repro.core.monoid import get_monoid as j_get_monoid
from repro.core.parser import parse as j_parse
from repro.core.planner import serving_admission as j_admission
from repro.launch import query_serve as JQ
from repro_torch.configs import pagerank as TPR
from repro_torch.core import executor as TE
from repro_torch.core import serving as TS
from repro_torch.core.monoid import get_monoid as t_get_monoid
from repro_torch.core.parser import parse as t_parse
from repro_torch.core.physical import segment_combine_sorted
from repro_torch.core.planner import serving_admission as t_admission
from repro_torch.launch import query_serve as TQ

N = 24
DAMPING = 0.85
SEED_SETS = ([0], [3, 5], [7], [1, 9])
PROBES = ((0, 9), (3, 3), (11, 2), (5, 20))


def _graph(seed=0, m=70):
    rng = np.random.default_rng(seed)
    pairs = sorted(set(zip(
        rng.integers(0, N, m).tolist(), rng.integers(0, N, m).tolist()
    )))
    pairs = [(a, b) for a, b in pairs if a != b]
    src = np.array([p[0] for p in pairs])
    dst = np.array([p[1] for p in pairs])
    deg = np.bincount(src, minlength=N).astype(np.float32)
    return src, dst, deg


SRC, DST, DEG = _graph()


class _Pkg:
    """One package's side of a comparison: its relation builder, programs
    and server, over the same numpy arrays."""

    def __init__(self, port: bool):
        self.port = port
        self.E = TE if port else JE
        self.S = TS if port else JS
        self.Q = TQ if port else JQ
        self.kw = {"device": "cpu"} if port else {}

    def rel(self, *cols, n=N):
        return self.E.Relation.from_columns(n, *cols, **self.kw)

    def shared(self):
        return {"edge": self.rel(SRC, DST),
                "deg": self.rel(np.arange(N), DEG)}

    def seed(self, vertices):
        vs = np.asarray(vertices)
        return self.rel(vs, np.full(len(vs), 1.0 / len(vs), np.float32))

    def unary(self, vertices):
        return self.rel(np.asarray(vertices))

    def server(self, **kw):
        return self.S.FixpointServer(self.shared(), **self.kw, **kw)

    def ppr(self):
        return self.S.personalized_pagerank_program(DAMPING)

    def reach(self):
        return self.S.point_reachability_program()

    def seeds(self):
        return [{"seed": self.seed(vs)} for vs in SEED_SETS]

    def probes(self):
        return [{"src": self.unary([a]), "dst": self.unary([b])}
                for a, b in PROBES]

    def compile(self, program, rels, **kw):
        return self.E.compile_program(program, rels, **self.kw, **kw)


J, T = _Pkg(False), _Pkg(True)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rank_vec(answers):
    rank = answers["rank"]
    return np.where(_np(rank.present), _np(rank.values[1]), 0.0)


def _close_to_ref(got, want):
    bar = 1e-6 * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= bar


def _raises_like(make_ref, make_port):
    """Both calls raise the same exception type with the same message."""

    with pytest.raises(Exception) as want:
        make_ref()
    with pytest.raises(Exception) as got:
        make_port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return got.value


# ---------------------------------------------------------------------------
# 1. Plan-cache keys: the reference's digests
# ---------------------------------------------------------------------------

_REFORMATTED = (
    "% a completely different comment\n\n"
    + JS.POINT_REACHABILITY_TEXT.replace(
        "Q2: reach(J+1, Y) :- reach(J, X), edge(X, Y).",
        "Q2:   reach(J+1,   Y)   :-   reach(J, X),  edge(X, Y)."
    )
)
_CHANGED = JS.POINT_REACHABILITY_TEXT.replace(
    "Q2: reach(J+1, Y) :- reach(J, X), edge(X, Y).",
    "Q2: reach(J+1, Y) :- reach(J, X), edge(Y, X)."
)
_CC = """\
C1: cc(0, X, L)        :- node(X, L).
C2: cc(J+1, X, min<L>) :- cc(J, Y, L), edge(Y, X).
C3: cc(J+1, X, L)      :- cc(J, X, L).
"""

# (name, text or None for the PPR program, key kwargs, hit on the base key)
KEY_CASES = [
    ("base", JS.POINT_REACHABILITY_TEXT, {}, True),
    ("whitespace-and-comments", _REFORMATTED, {}, True),
    ("changed-rule", _CHANGED, {}, False),
    ("storage", JS.POINT_REACHABILITY_TEXT, {"storage": "row-table"}, False),
    ("rewrite", JS.POINT_REACHABILITY_TEXT, {"rewrite": True}, False),
    ("epoch", JS.POINT_REACHABILITY_TEXT, {"epoch": 1}, False),
    ("none-override", JS.POINT_REACHABILITY_TEXT, {"storage": None}, True),
    ("param-names", JS.POINT_REACHABILITY_TEXT,
     {"param_names": ("src", "dst")}, False),
    ("ppr", None, {"param_names": ("seed",)}, False),
]


@pytest.mark.parametrize("name,text,kw,hit", KEY_CASES,
                         ids=[c[0] for c in KEY_CASES])
def test_plan_cache_key_is_the_reference_digest(name, text, kw, hit):
    keys = {}
    for pkg in (J, T):
        prog = pkg.ppr() if text is None else text
        base = pkg.S.plan_cache_key(pkg.S.POINT_REACHABILITY_TEXT,
                                    pkg.shared())
        key = pkg.S.plan_cache_key(prog, pkg.shared(), **kw)
        assert (key == base) == hit
        keys[pkg.port] = key
    assert keys[True] == keys[False]


@pytest.mark.parametrize("agg", ["min", "max"])
def test_plan_cache_key_misses_on_a_changed_monoid(agg):
    keys = {}
    for pkg, parse, monoid in ((J, j_parse, j_get_monoid),
                               (T, t_parse, t_get_monoid)):
        rels = {"edge": pkg.rel(SRC, DST), "node": pkg.rel(np.arange(N),
                                                           DEG)}
        progs = {a: parse(_CC.replace("min<L>", f"{a}<L>"),
                          aggregates={a: monoid(a).as_aggregate()})
                 for a in ("min", "max")}
        keys[pkg.port] = {a: pkg.S.plan_cache_key(p, rels)
                          for a, p in progs.items()}
        assert keys[pkg.port]["min"] != keys[pkg.port]["max"]
    assert keys[True][agg] == keys[False][agg]


def test_server_plan_key_equals_the_reference_server_key():
    for prog in ("reach", "ppr"):
        names = ("src", "dst") if prog == "reach" else ("seed",)
        j = J.server().plan_key(getattr(J, prog)(), names)
        assert T.server().plan_key(getattr(T, prog)(), names) == j
        t = T.server(storage="row-table")
        assert t.plan_key(getattr(T, prog)(), names) == \
            J.server(storage="row-table").plan_key(getattr(J, prog)(), names)


def test_lru_eviction_order_and_counters():
    counters = []
    for S in (JS, TS):
        cache = S.PlanCache(capacity=2)
        cache.put("a", "exe_a")
        cache.put("b", "exe_b")
        assert cache.get("a") == "exe_a"      # refreshes a over b
        cache.put("c", "exe_c")               # evicts b (LRU)
        assert cache.keys() == ("a", "c")
        assert "b" not in cache
        assert cache.get("b") is None
        counters.append(cache.counters())
    assert counters[1] == counters[0] == {
        "hits": 1, "misses": 1, "evictions": 1, "size": 2,
    }
    with pytest.raises(ValueError, match="capacity"):
        TS.PlanCache(capacity=0)


# ---------------------------------------------------------------------------
# 2. Answers against the reference, batched against sequential
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on_device", [False, True])
def test_ppr_batched_and_sequential_match_the_reference(on_device):
    out = {}
    for pkg in (J, T):
        server = pkg.server()
        for force in ("batched", "sequential"):
            res = server.query(pkg.ppr(), pkg.seeds(), max_iters=6,
                               on_device=on_device, force=force)
            assert res.batched == (force == "batched")
            out[pkg.port, force] = res
    for force in ("batched", "sequential"):
        j, t = out[False, force], out[True, force]
        assert (t.iterations, t.converged) == (j.iterations, j.converged)
        assert t.notes == j.notes
        for a, b in zip(j.answers, t.answers):
            _close_to_ref(_rank_vec(b), _rank_vec(a))
            assert np.array_equal(_np(b["rank"].present),
                                  _np(a["rank"].present))
    for b, s in zip(out[True, "batched"].answers,
                    out[True, "sequential"].answers):
        assert np.abs(_rank_vec(b) - _rank_vec(s)).max() <= 1e-8


@pytest.mark.parametrize("on_device", [False, True])
def test_reachability_batched_and_sequential_match_the_reference(on_device):
    out = {}
    for pkg in (J, T):
        server = pkg.server()
        for force in ("batched", "sequential"):
            out[pkg.port, force] = server.query(
                pkg.reach(), pkg.probes(), max_iters=N, on_device=on_device,
                force=force)
    for force in ("batched", "sequential"):
        for a, b in zip(out[False, force].answers, out[True, force].answers):
            for pred in ("reach", "hit"):
                assert np.array_equal(_np(b[pred].present),
                                      _np(a[pred].present))
    for b, s in zip(out[True, "batched"].answers,
                    out[True, "sequential"].answers):
        for pred in ("reach", "hit"):
            assert torch.equal(b[pred].present, s[pred].present)


@pytest.mark.parametrize("on_device", [False, True])
def test_run_params_matches_the_reference_and_a_fresh_compile(on_device):
    got = {}
    for pkg in (J, T):
        ex = pkg.compile(pkg.reach(), dict(pkg.shared(), src=pkg.unary([0]),
                                           dst=pkg.unary([1])))
        got[pkg.port] = ex.run(
            N, on_device, params={"src": pkg.unary([3]),
                                  "dst": pkg.unary([9])}).state
    fresh = T.compile(T.reach(), dict(T.shared(), src=T.unary([3]),
                                      dst=T.unary([9]))).run(N).state
    for pred in ("reach", "hit"):
        assert np.array_equal(_np(got[True][pred].present),
                              _np(got[False][pred].present))
        assert torch.equal(got[True][pred].present, fresh[pred].present)


def test_run_params_ppr_matches_the_reference():
    for vs in SEED_SETS:
        ranks = []
        for pkg in (J, T):
            ex = pkg.compile(pkg.ppr(), dict(pkg.shared(),
                                             seed=pkg.seed([0])))
            ranks.append(_rank_vec(
                ex.run(6, params={"seed": pkg.seed(vs)}).state))
        _close_to_ref(ranks[1], ranks[0])


@pytest.mark.parametrize("probe", [(5, 40), (9, 9)])
def test_run_params_through_a_chunked_phase_matches_the_reference(probe):
    # Dense parameters beside a row-table EDB streamed in chunks: the
    # rebound relations reach the chunk loop's firings.
    n = 64
    rng = np.random.default_rng(5)
    src, dst = np.repeat(np.arange(n), 3), rng.integers(0, n, 3 * n)
    got = []
    for pkg in (J, T):
        rel = lambda *c: pkg.rel(*c, n=n)  # noqa: E731
        ex = pkg.compile(pkg.reach(), {
            "edge": rel(src, dst), "src": rel(np.array([0])),
            "dst": rel(np.array([1]))},
            storage={"edge": "row-table", "reach": "row-table"},
            chunks={"edge": 3})
        assert len(ex.chunked_edb["edge"]) == 3
        res = ex.run(n, params={"src": rel(np.array([probe[0]])),
                                "dst": rel(np.array([probe[1]]))})
        got.append([np.asarray(res.state[p].tuples()) for p in
                    ("reach", "hit")])
    for a, b in zip(*got):
        assert np.array_equal(b, a)
    assert got[1][1].tolist() == [[probe[1]]]


def test_run_batched_results_carry_the_shared_counts():
    ex = T.compile(T.reach(), dict(T.shared(), src=T.unary([0]),
                                   dst=T.unary([1])))
    results = ex.run_batched(T.probes(), max_iters=N)
    jex = J.compile(J.reach(), dict(J.shared(), src=J.unary([0]),
                                    dst=J.unary([1])))
    want = jex.run_batched(J.probes(), max_iters=N)
    assert len(results) == len(want) == len(PROBES)
    for r, w in zip(results, want):
        assert (r.iterations, r.converged, r.phase_iterations) == \
            (w.iterations, w.converged, w.phase_iterations)


# ---------------------------------------------------------------------------
# 3. Fail closed, with the reference's words
# ---------------------------------------------------------------------------


def _reach_exe(pkg, **kw):
    return pkg.compile(pkg.reach(), dict(pkg.shared(), src=pkg.unary([0]),
                                         dst=pkg.unary([1])), **kw)


def _bad_domain(pkg):
    return {"src": pkg.E.Relation.from_columns(N * 2, np.array([0]),
                                               **pkg.kw)}


def _bad_signature(pkg):
    return {"src": pkg.rel(np.array([0]), np.array([1.0], np.float32))}


FAIL_CASES = {
    "not-an-edb-relation": lambda p, ex: ex.run(
        4, params={"nope": p.unary([0])}),
    "domain": lambda p, ex: ex.run(4, params=_bad_domain(p)),
    "signature": lambda p, ex: ex.run(4, params=_bad_signature(p)),
    "row-stored-parameter": lambda p, ex: ex.run(4, params={
        "src": p.E.RowRelation.from_columns(N, np.array([0]), **p.kw)}),
    "batch-binds-different-names": lambda p, ex: ex.run_batched(
        [{"src": p.unary([0])}, {"dst": p.unary([1])}], max_iters=4),
    "empty-batch": lambda p, ex: ex.run_batched([], max_iters=4),
    "batch-binds-no-names": lambda p, ex: ex.run_batched(
        [{}, {}], max_iters=4),
    "batched-bad-domain": lambda p, ex: ex.run_batched(
        [_bad_domain(p)], max_iters=4),
}


@pytest.mark.parametrize("case", sorted(FAIL_CASES))
def test_parameter_refusals_match_the_reference(case):
    err = _raises_like(lambda: FAIL_CASES[case](J, _reach_exe(J)),
                       lambda: FAIL_CASES[case](T, _reach_exe(T)))
    assert isinstance(err, TE.ExecutorError)


def test_row_storage_rejects_run_batched():
    err = _raises_like(
        lambda: _reach_exe(J, storage="row-table").run_batched(
            [{"src": J.unary([0]), "dst": J.unary([1])}], max_iters=4),
        lambda: _reach_exe(T, storage="row-table").run_batched(
            [{"src": T.unary([0]), "dst": T.unary([1])}], max_iters=4),
    )
    assert "row-table" in str(err)


def test_row_storage_server_dispatches_sequentially():
    out = []
    for pkg in (J, T):
        server = pkg.server(storage="row-table")
        batch = [{"src": pkg.unary([0]), "dst": pkg.unary([9])},
                 {"src": pkg.unary([3]), "dst": pkg.unary([2])}]
        res = server.query(pkg.reach(), batch, max_iters=8)
        assert not res.batched
        assert "sequential" in res.notes[-1]
        out.append(res)
        with pytest.raises(pkg.E.ExecutorError,
                           match="cannot force batched"):
            server.query(pkg.reach(), batch, max_iters=8, force="batched")
    assert out[1].notes == out[0].notes
    for a, b in zip(out[0].answers, out[1].answers):
        for pred in ("reach", "hit"):
            assert np.array_equal(b[pred].tuples(), np.asarray(
                a[pred].tuples()))


SERVER_FAIL_CASES = {
    "bad-force": lambda p, s: s.query(p.reach(), p.probes(), force="fast"),
    "empty-batch": lambda p, s: s.query(p.reach(), [], max_iters=4),
    "mixed-names": lambda p, s: s.query(
        p.reach(), [{"src": p.unary([0])}, {"dst": p.unary([1])}]),
    "unbound-edb": lambda p, s: s.query(p.reach(), {"src": p.unary([0])}),
    "force-batched-without-params": lambda p, s: s.query(
        p.reach(), None, force="batched"),
    "domains-disagree": lambda p, s: p.S.FixpointServer(
        {"edge": p.rel(SRC, DST), "x": p.rel(np.array([0]), n=2 * N)},
        **p.kw),
}


@pytest.mark.parametrize("case", sorted(SERVER_FAIL_CASES))
def test_server_refusals_match_the_reference(case):
    _raises_like(lambda: SERVER_FAIL_CASES[case](J, J.server()),
                 lambda: SERVER_FAIL_CASES[case](T, T.server()))


def test_mesh_raises_naming_a10(tmp_path):
    """``mesh=`` runs (A10d): the plan key of a mesh is the reference's
    digest for a mesh of the same axes and sizes (its ``_mesh_topology``
    reads ``axis_names`` and the ``devices`` array's shape), and the
    server and the request loop's front door take a one-rank mesh."""

    import types

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_data_mesh

    def digests(shape, axes):
        port = types.SimpleNamespace(axis_names=axes, sizes=shape)
        ref = types.SimpleNamespace(axis_names=axes,
                                    devices=np.empty(shape, object))
        return (TS.plan_cache_key(T.ppr(), T.shared(), param_names=("seed",),
                                  mesh=port),
                JS.plan_cache_key(J.ppr(), J.shared(), param_names=("seed",),
                                  mesh=ref))

    keys = set()
    for shape, axes in (((8,), ("data",)), ((2, 4), ("pod", "data")),
                        ((1,), ("data",))):
        got, want = digests(shape, axes)
        assert got == want
        keys.add(got)
    keys.add(TS.plan_cache_key(T.ppr(), T.shared(), param_names=("seed",)))
    assert len(keys) == 4
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_data_mesh(device="cpu")
        for server in (T.server(mesh=mesh),
                       TQ.build_query_server(T.shared(), mesh=mesh)):
            assert server.mesh is mesh and server.device == mesh.device
            assert server.plan_key(T.ppr(), ("seed",)) \
                == digests((1,), ("data",))[1]
    finally:
        dist.destroy_process_group()


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.FixpointServer(T.shared())


# ---------------------------------------------------------------------------
# 4. Admission: decisions and notes byte-equal
# ---------------------------------------------------------------------------


def _two_servers(**kw):
    return J.server(**kw), T.server(**kw)


@pytest.mark.parametrize("prog,batch", [
    ("reach", 1), ("reach", 3), ("ppr", 1), ("ppr", 4),
])
def test_admission_notes_equal_the_reference(prog, batch):
    res = []
    for pkg, server in zip((J, T), _two_servers()):
        params = pkg.probes()[:batch] if prog == "reach" \
            else pkg.seeds()[:batch]
        res.append(server.query(getattr(pkg, prog)(), params, max_iters=8))
    j, t = res
    assert vars(t.decision) == vars(j.decision)
    assert t.notes == j.notes
    assert t.batched == (batch > 1)
    assert t.notes[-1].startswith(
        f"serving(batch={batch}: {'batched' if batch > 1 else 'sequential'}")


def test_admission_keeps_the_compiled_plan_pristine():
    server = T.server()
    res = server.query(T.reach(), T.probes()[:3], max_iters=8)
    exe = server.plan_cache.get(res.plan_key)
    assert not any(n.startswith("serving(") for n in exe.plan.notes)


@pytest.mark.parametrize("batch,state_bytes", [
    (1024, 1 << 24), (8, 1 << 24), (2, 1 << 40), (1, 1 << 40),
])
def test_memory_guard_matches_the_reference(batch, state_bytes):
    j = _reach_exe(J).plan
    t = _reach_exe(T).plan
    want = j_admission(j, batch=batch, state_bytes=state_bytes)
    got = t_admission(t, batch=batch, state_bytes=state_bytes)
    assert vars(got) == vars(want) and got.note() == want.note()
    if batch == 1024:
        assert not got.batched and "memory guard" in got.reason


def test_batch_below_one_rejected():
    with pytest.raises(ValueError, match="batch"):
        t_admission(_reach_exe(T).plan, batch=0, state_bytes=1024)


def test_state_bytes_equals_the_reference():
    for prog in ("reach", "ppr"):
        rels = {"reach": dict(src=None, dst=None), "ppr": dict(seed=None)}
        sizes = []
        for pkg in (J, T):
            extra = {"src": pkg.unary([0]), "dst": pkg.unary([1]),
                     "seed": pkg.seed([0])}
            ex = pkg.compile(getattr(pkg, prog)(), dict(
                pkg.shared(), **{k: extra[k] for k in rels[prog]}))
            sizes.append(pkg.S._state_bytes(ex))
        assert sizes[0] == sizes[1] > 0


# ---------------------------------------------------------------------------
# 5. Caches across requests, invalidation, the front door
# ---------------------------------------------------------------------------


def test_warm_request_skips_compile():
    caches = []
    for pkg in (J, T):
        server = pkg.server()
        cold = server.query(pkg.ppr(), {"seed": pkg.seed([0])}, max_iters=4)
        warm = server.query(pkg.ppr(), {"seed": pkg.seed([5])}, max_iters=4)
        assert not cold.cache_hit and cold.compile_seconds > 0
        assert warm.cache_hit and warm.compile_seconds == 0.0
        assert warm.plan_key == cold.plan_key
        caches.append((cold.cache, warm.cache))
    assert caches[1] == caches[0]
    assert caches[1][1]["plan_hits"] == 1


def test_update_relation_bumps_epoch_and_invalidates():
    hits, keys = [], []
    for pkg in (J, T):
        server = pkg.server()
        params = {"src": pkg.unary([0]), "dst": pkg.unary([9])}
        first = server.query(pkg.reach(), params, max_iters=8)
        server.update_relation("edge", pkg.rel(np.array([], np.int64),
                                               np.array([], np.int64)))
        assert server.epoch == 1
        second = server.query(pkg.reach(), params, max_iters=8)
        assert not second.cache_hit
        assert second.plan_key != first.plan_key
        hits.append([int(_np(r.answers[0]["hit"].count()))
                     for r in (first, second)])
        keys.append((first.plan_key, second.plan_key, second.cache))
    assert hits[1] == hits[0] == [1, 0]
    assert keys[1] == keys[0]


def test_edb_cache_counts_hits_and_copies_once():
    counters = []
    for pkg in (J, T):
        cache = pkg.S.EDBCache()
        edge = pkg.rel(SRC, DST)
        where = ("cpu",) if pkg.port else ()
        a = cache.place("edge", edge, *where)
        b = cache.place("edge", edge, *where)
        assert a is b
        c = cache.place("edge", pkg.rel(SRC, DST), *where)  # a new object
        assert c is not a
        counters.append(cache.counters())
        cache.invalidate("edge")
        assert cache.counters()["size"] == 0
        row = pkg.E.RowRelation.from_columns(N, SRC, DST, **pkg.kw)
        assert cache.place("edge", row, *where) is row
    assert counters[1] == counters[0] == {"hits": 1, "misses": 2, "size": 1}
    # On the device it already lies on, a relation's tensors are not copied.
    edge = T.rel(SRC, DST)
    placed = TS.EDBCache().place("edge", edge, "cpu")
    assert placed.present is edge.present
    assert placed.values == edge.values


def test_top_k_matches_the_reference():
    out = []
    for pkg in (J, T):
        res = pkg.server().query(pkg.ppr(), {"seed": pkg.seed([0, 4])},
                                 max_iters=6)
        rank = res.answers[0]["rank"]
        ids, scores = pkg.S.top_k(rank, 5)
        ref = np.where(_np(rank.present), _np(rank.values[1]), -np.inf)
        np.testing.assert_allclose(scores, np.sort(ref)[::-1][:5], rtol=0,
                                   atol=0)
        assert np.array_equal(ref[ids], scores)
        out.append((ids, scores))
    assert np.array_equal(out[1][0], out[0][0])
    _close_to_ref(out[1][1], out[0][1])
    with pytest.raises(TE.ExecutorError, match="unary-key"):
        TS.top_k(T.rel(SRC, DST), 3)


def test_request_loop_groups_and_preserves_order():
    got = {}
    for pkg in (J, T):
        server = pkg.Q.build_query_server(pkg.shared(), **pkg.kw)
        ppr, reach = pkg.ppr(), pkg.reach()
        requests = (
            [pkg.Q.QueryRequest(ppr, {"seed": pkg.seed([v])}, max_iters=4,
                                tag=f"ppr{v}") for v in (0, 3, 7)]
            + [pkg.Q.QueryRequest(reach, {"src": pkg.unary([0]),
                                          "dst": pkg.unary([9])},
                                  max_iters=8, tag="probe")]
            + [pkg.Q.QueryRequest(ppr, {"seed": pkg.seed([11])},
                                  max_iters=4, tag="late")]
        )
        responses = pkg.Q.serve_request_loop(server, requests, max_batch=2)
        assert [r.request.tag for r in responses] \
            == ["ppr0", "ppr3", "ppr7", "probe", "late"]
        assert [r.result.batch for r in responses] == [2, 2, 1, 1, 1]
        assert responses[0].batched and not responses[2].batched
        solo = server.query(ppr, {"seed": pkg.seed([3])}, max_iters=4,
                            force="sequential")
        assert np.abs(_rank_vec(responses[1].answers)
                      - _rank_vec(solo.answers[0])).max() <= 1e-8
        got[pkg.port] = responses
    for a, b in zip(got[False], got[True]):
        if "rank" in a.answers:
            _close_to_ref(_rank_vec(b.answers), _rank_vec(a.answers))
        else:
            assert np.array_equal(_np(b.answers["hit"].present),
                                  _np(a.answers["hit"].present))
    with pytest.raises(ValueError, match="max_batch"):
        TQ.serve_request_loop(T.server(), [], max_batch=0)


def test_request_loop_dispatches_unparameterized_requests_alone():
    tc = ("T1: tc(0, X, Y) :- edge(X, Y).\n"
          "T2: tc(J+1, X, Y) :- tc(J, X, Z), edge(Z, Y).\n"
          "T3: tc(J+1, X, Y) :- tc(J, X, Y).\n")
    server = TQ.build_query_server(T.shared(), device="cpu")
    prog = t_parse(tc)
    reqs = [TQ.QueryRequest(prog, None, max_iters=N, tag=str(i))
            for i in range(3)]
    out = TQ.serve_request_loop(server, reqs)
    assert [r.result.batch for r in out] == [1, 1, 1]
    assert all(not r.batched for r in out)
    assert out[2].result.cache_hit


# ---------------------------------------------------------------------------
# 6. The segment combine under vmap
# ---------------------------------------------------------------------------


def _combine_case(op, F, k, with_active, seed=0):
    g = torch.Generator().manual_seed(seed)
    E, S = 57, 9
    ids = torch.sort(torch.randint(-1, S + 1, (E,), generator=g)).values
    vals = torch.randn(k, E, F, generator=g)
    act = (torch.rand(E, generator=g) < 0.6) if with_active else None
    return vals, ids.to(torch.int32), S, act


@pytest.mark.parametrize(
    "op,F,k,with_active",
    list(itertools.product(["sum", "max", "min"], [1, 3], [1, 5],
                           [False, True])))
def test_vmapped_combine_equals_each_query_alone(op, F, k, with_active):
    vals, ids, S, act = _combine_case(op, F, k, with_active)
    got = torch.func.vmap(lambda v: segment_combine_sorted(
        v, ids, S, op, edge_active=act))(vals)
    assert got.shape == (k, S, F)
    for q in range(k):
        assert torch.equal(got[q], segment_combine_sorted(
            vals[q], ids, S, op, edge_active=act))


@pytest.mark.parametrize("by_query", ["ids", "edge_active"])
def test_vmapped_combine_refuses_ids_by_query(by_query):
    vals, ids, S, act = _combine_case("sum", 1, 3, True)
    ids_b, act_b = ids.expand(3, -1), act.expand(3, -1)
    with pytest.raises(ValueError, match="payload only"):
        if by_query == "ids":
            torch.func.vmap(lambda v, i: segment_combine_sorted(
                v, i, S, "sum", edge_active=act))(vals, ids_b)
        else:
            torch.func.vmap(lambda v, a: segment_combine_sorted(
                v, ids, S, "sum", edge_active=a))(vals, act_b)


def test_vmapped_combine_counts_one_plain_call_a_batch(monkeypatch):
    from repro_torch.core import physical

    calls = []
    real = physical._plain_scatter

    def spy(values, *a, **kw):
        calls.append(tuple(values.shape))
        return real(values, *a, **kw)

    monkeypatch.setattr(physical, "_plain_scatter", spy)
    vals, ids, S, act = _combine_case("sum", 3, 5, True)
    torch.func.vmap(lambda v: segment_combine_sorted(
        v, ids, S, "sum", edge_active=act))(vals)
    assert calls == [(57, 15)]


# A parameterized program on 4 vertices: every GroupBy grid has 16 cells,
# so the planner gives each the segment scan (the segment combine), for a
# sum (personalized PageRank) and for max and min (label spreading from a
# per-query label).
SCAN_N = 4
_SPREAD = """\
M1: hi(0, X, L)        :- lab(X, L).
M2: hi(J+1, X, max<L>) :- hi(J, Y, L), edge(Y, X).
M3: hi(J+1, X, L)      :- hi(J, X, L).
M4: lo(0, X, L)        :- lab(X, L).
M5: lo(J+1, X, min<L>) :- lo(J, Y, L), edge(Y, X).
M6: lo(J+1, X, L)      :- lo(J, X, L).
"""
_SCAN_SRC = np.array([0, 0, 1, 2, 2, 3])
_SCAN_DST = np.array([1, 2, 2, 0, 3, 1])


def _scan_exe(pkg, prog):
    rel = lambda *c: pkg.rel(*c, n=SCAN_N)  # noqa: E731
    deg = np.bincount(_SCAN_SRC, minlength=SCAN_N).astype(np.float32)
    rels = {"edge": rel(_SCAN_SRC, _SCAN_DST)}
    if prog == "ppr":
        program = pkg.ppr()
        rels["deg"] = rel(np.arange(SCAN_N), deg)
        rels["seed"] = rel(np.array([0]), np.array([1.0], np.float32))
    else:
        parse, monoid = (t_parse, t_get_monoid) if pkg.port \
            else (j_parse, j_get_monoid)
        program = parse(_SPREAD, aggregates={
            a: monoid(a).as_aggregate() for a in ("max", "min")})
        rels["lab"] = rel(np.arange(SCAN_N),
                          np.zeros(SCAN_N, np.float32))
    return pkg.compile(program, rels)


def _scan_params(pkg, prog, k=4):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(k):
        if prog == "ppr":
            vs = np.sort(rng.choice(SCAN_N, rng.integers(1, 3),
                                    replace=False))
            out.append({"seed": pkg.rel(vs, np.full(len(vs), 1.0 / len(vs),
                                                    np.float32),
                                        n=SCAN_N)})
        else:
            vs = np.sort(rng.choice(SCAN_N, 3, replace=False))
            out.append({"lab": pkg.rel(vs, rng.normal(size=3).astype(
                np.float32), n=SCAN_N)})
    return out


@pytest.mark.parametrize("prog", ["ppr", "spread"])
def test_segment_scan_program_batched_matches_the_reference(prog):
    t, j = _scan_exe(T, prog), _scan_exe(J, prog)
    assert t.plan.notes == j.plan.notes
    assert all(v == "segment-scan" for v in t.plan.connectors.values())
    preds = ("rank",) if prog == "ppr" else ("hi", "lo")
    got = t.run_batched(_scan_params(T, prog), max_iters=12)
    want = j.run_batched(_scan_params(J, prog), max_iters=12)
    seq = [t.run(12, params=ps) for ps in _scan_params(T, prog)]
    for g, w, s in zip(got, want, seq):
        assert g.iterations == w.iterations
        for p in preds:
            gv = np.where(_np(g.state[p].present), _np(g.state[p].values[1]),
                          0.0)
            wv = np.where(_np(w.state[p].present), _np(w.state[p].values[1]),
                          0.0)
            sv = np.where(_np(s.state[p].present), _np(s.state[p].values[1]),
                          0.0)
            assert np.array_equal(_np(g.state[p].present),
                                  _np(w.state[p].present))
            _close_to_ref(gv, wv)
            if prog == "ppr":
                assert np.abs(gv - sv).max() <= 1e-8
            else:
                assert np.array_equal(gv, sv)   # max/min: bit-equal


# ---------------------------------------------------------------------------
# The paper's PageRank workload description
# ---------------------------------------------------------------------------


def test_pagerank_config_equals_the_reference():
    assert TPR.CONFIG is TPR.STATS and vars(TPR.STATS) == vars(JPR.STATS)
