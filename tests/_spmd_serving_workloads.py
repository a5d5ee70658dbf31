"""Serving on a mesh, in both packages: shared inputs and the rank program
of ``test_torch_spmd_serving.py``.

The graph, seed sets and probes are those of the JAX package's sharded
serving program (``spmd_serving_program.py``), copied here rather than
imported (that file sets ``XLA_FLAGS`` when it is imported): 64 vertices,
4 draws of an out-edge a vertex from seed 2.  :func:`rank_main` is one of
8 ``gloo`` ranks of the port (``launch_ranks``).  It serves the battery of
:func:`serve_on` first on the ``(8,)`` data mesh, then on a ``(2, 4)``
``("pod", "data")`` mesh, and beside them, on the data mesh: the
segment-scan program of ``chip_smoke.py``'s serve part (e), a row-table
program, the request loop, and the index audit of the batched segment
scans.  Every
answer comes back as numpy arrays of the global state.
"""

from __future__ import annotations

import time

import numpy as np

N = 64
SEED_SETS = ([0], [5, 9], [17], [3, 40, 41])
PROBES = ((0, 33), (7, 7), (21, 2), (12, 63))
PPR_ITERS = 8
MESHES = {"data": ((8,), ("data",)), "pod-data": ((2, 4), ("pod", "data"))}

# chip_smoke.py's serve part (e): 4 vertices, 16-cell grids, whose
# GroupBys take the segment scan.
SCAN_N = 4
SCAN_K = 16
SCAN_ITERS = 20
SCAN_SRC = np.array([0, 0, 1, 2, 2, 3])
SCAN_DST = np.array([1, 2, 2, 0, 3, 1])
SPREAD_TEXT = (
    "M1: hi(0, X, L)        :- lab(X, L).\n"
    "M2: hi(J+1, X, max<L>) :- hi(J, Y, L), edge(Y, X).\n"
    "M3: hi(J+1, X, L)      :- hi(J, X, L).\n"
    "M4: lo(0, X, L)        :- lab(X, L).\n"
    "M5: lo(J+1, X, min<L>) :- lo(J, Y, L), edge(Y, X).\n"
    "M6: lo(J+1, X, L)      :- lo(J, X, L).\n")

ROW_SEEDS = ([0], [5, 9])
# The request loop: runs of PageRank and reachability requests.
LOOP_RUNS = (("ppr", 5), ("reach", 3), ("ppr", 4), ("reach", 4))
LOOP_MAX_BATCH = 4


def graph(n=N, deg=4, seed=2):
    """``(src, dst, out-degree)`` of the serving program's graph."""

    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    keep = src != dst
    pairs = sorted(set(zip(src[keep].tolist(), dst[keep].tolist())))
    src = np.array([p[0] for p in pairs])
    dst = np.array([p[1] for p in pairs])
    return src, dst, np.bincount(src, minlength=n).astype(np.float32)


def scan_params():
    """The (e) queries' columns: 16 seed sets of 1-2 vertices and 16 label
    vectors, drawn from one seed."""

    rng = np.random.default_rng(7)
    seeds = [np.sort(rng.choice(SCAN_N, int(rng.integers(1, 3)),
                                replace=False)) for _ in range(SCAN_K)]
    labs = [rng.normal(size=SCAN_N).astype(np.float32)
            for _ in range(SCAN_K)]
    return seeds, labs


def loop_requests():
    """``(kind, columns)`` of each request of the loop, in arrival order."""

    rng = np.random.default_rng(3)
    out = []
    for kind, count in LOOP_RUNS:
        for _ in range(count):
            if kind == "ppr":
                out.append(("ppr", np.sort(rng.choice(
                    N, int(rng.integers(1, 4)), replace=False))))
            else:
                out.append(("reach", rng.integers(0, N, 2)))
    return out


class Pkg:
    """One package's relation builders and programs over numpy columns."""

    def __init__(self, port: bool):
        if port:
            from repro_torch.core import executor as E
            from repro_torch.core import serving as S
            from repro_torch.core.monoid import get_monoid
            from repro_torch.core.parser import parse
        else:
            from repro.core import executor as E
            from repro.core import serving as S
            from repro.core.monoid import get_monoid
            from repro.core.parser import parse
        self.E, self.S = E, S
        self.kw = {"device": "cpu"} if port else {}
        self._parse, self._monoid = parse, get_monoid

    def rel(self, n, *cols):
        return self.E.Relation.from_columns(n, *cols, **self.kw)

    def shared(self, n=N, src=None, dst=None):
        if src is None:
            src, dst, _ = graph()
        deg = np.bincount(src, minlength=n).astype(np.float32)
        return {"edge": self.rel(n, src, dst),
                "deg": self.rel(n, np.arange(n), deg)}

    def seed(self, vertices, n=N):
        vs = np.asarray(vertices)
        return {"seed": self.rel(n, vs, np.full(len(vs), 1.0 / len(vs),
                                                np.float32))}

    def probe(self, a, b):
        return {"src": self.rel(N, np.array([a])),
                "dst": self.rel(N, np.array([b]))}

    def spread(self):
        return self._parse(SPREAD_TEXT, aggregates={
            a: self._monoid(a).as_aggregate() for a in ("max", "min")})

    def scan_batches(self):
        seeds, labs = scan_params()
        return ([self.seed(vs, SCAN_N) for vs in seeds],
                [{"lab": self.rel(SCAN_N, np.arange(SCAN_N), lab)}
                 for lab in labs])


def grid(rel):
    """``(presence, {position: values})`` of an answer, dense, numpy."""

    if hasattr(rel, "to_dense"):
        rel = rel.to_dense()
    present = rel.present
    present = present.cpu().numpy() if hasattr(present, "cpu") \
        else np.asarray(present)
    return present, {int(k): (v.cpu().numpy() if hasattr(v, "cpu")
                              else np.asarray(v))
                     for k, v in rel.values.items()}


def ranks_of(res, pred="rank"):
    """Each query's values of ``pred`` with absent vertices 0."""

    out = []
    for ans in res.answers:
        present, values = grid(ans[pred])
        out.append(np.where(present, values[1], 0.0))
    return out


def hits_of(res, pred="hit"):
    return [grid(ans[pred])[0] for ans in res.answers]


def _peek(server, key):
    """The cached executable of ``key`` (not counted as a hit)."""

    return server.plan_cache._entries[key]


def serve_on(mesh):
    """The sharded serving program's battery on ``mesh``, with the port's
    unmeshed server beside it, and the caches, keys, admission notes and
    collective calls the test holds."""

    from repro_torch.core.serving import (
        FixpointServer,
        _mesh_topology,
        personalized_pagerank_program,
        point_reachability_program,
    )

    T = Pkg(True)
    meshed = FixpointServer(T.shared(), mesh=mesh)
    single = FixpointServer(T.shared(), device="cpu")
    ppr = personalized_pagerank_program()
    reach = point_reachability_program()
    batch = [T.seed(vs) for vs in SEED_SETS]
    mesh.stats.reset()
    b = meshed.query(ppr, batch, max_iters=PPR_ITERS, force="batched")
    calls_b = dict(mesh.stats.calls)
    mesh.stats.reset()
    one = meshed.query(ppr, batch[:1], max_iters=PPR_ITERS,
                       force="sequential")
    calls_one = dict(mesh.stats.calls)
    s = meshed.query(ppr, batch, max_iters=PPR_ITERS, force="sequential")
    solo = single.query(ppr, batch, max_iters=PPR_ITERS, force="sequential")
    admitted = meshed.query(ppr, batch, max_iters=PPR_ITERS)
    topo = _mesh_topology(mesh)
    entry = {name: meshed.edb_cache._entries[(name, topo, "cpu")][1]
             for name in ("edge", "deg")}
    ppr_exe = _peek(meshed, b.plan_key)
    edb_before = dict(meshed.edb_cache.counters())
    probes = [T.probe(a, t) for a, t in PROBES]
    rb = meshed.query(reach, probes, max_iters=N, force="batched")
    rs = meshed.query(reach, probes, max_iters=N, force="sequential")
    rsolo = single.query(reach, probes, max_iters=N, force="sequential")
    reach_exe = _peek(meshed, rb.plan_key)
    before_warm = dict(meshed.edb_cache.counters())
    warm = meshed.query(ppr, batch, max_iters=PPR_ITERS, force="batched")
    return {
        "ppr": {"batched": ranks_of(b), "sequential": ranks_of(s),
                "single": ranks_of(solo)},
        "dispatch": (bool(b.batched), bool(s.batched)),
        "iterations": (b.iterations, one.iterations),
        "calls": {"batched": calls_b, "one": calls_one},
        "notes": {"batched": list(b.notes), "admitted": list(admitted.notes),
                  "one": list(one.notes)},
        "reach": {path: {"hit": hits_of(r), "reach": hits_of(r, "reach")}
                  for path, r in (("batched", rb), ("sequential", rs),
                                  ("single", rsolo))},
        "warm": {"hit": warm.cache_hit,
                 "compile_seconds": warm.compile_seconds,
                 "edb": (before_warm, {k: warm.cache[f"edb_{k}"]
                                       for k in before_warm})},
        "edb": {
            "edge": tuple(entry["edge"].present.shape),
            "deg": tuple(entry["deg"].values[1].shape),
            "counters": (edb_before, dict(meshed.edb_cache.counters())),
            # The executables read the cached layout as it is: no copy.
            "shared": all(ex.local_relations[name].present
                          is entry[name].present
                          for ex, names in ((ppr_exe, ("edge", "deg")),
                                            (reach_exe, ("edge",)))
                          for name in names),
            "sharded": sorted(ppr_exe.sharded),
        },
        "keys": {"meshed": meshed.plan_key(ppr, ("seed",)),
                 "single": single.plan_key(ppr, ("seed",))},
    }


def scan_on(mesh):
    """(e): the sum program (PageRank) and the max/min program on 4
    vertices, 16 queries batched and sequential on ``mesh``."""

    from repro_torch.core.serving import (
        FixpointServer,
        personalized_pagerank_program,
    )

    T = Pkg(True)
    server = FixpointServer(T.shared(SCAN_N, SCAN_SRC, SCAN_DST), mesh=mesh)
    seeds, labs = T.scan_batches()
    out = {}
    for tag, prog, batch, preds in (
            ("sum", personalized_pagerank_program(), seeds, ("rank",)),
            ("max/min", T.spread(), labs, ("hi", "lo"))):
        b = server.query(prog, batch, max_iters=SCAN_ITERS, force="batched")
        s = server.query(prog, batch, max_iters=SCAN_ITERS,
                         force="sequential")
        out[tag] = {
            "connectors": sorted(set(_peek(server, b.plan_key)
                                     .plan.connectors.values())),
            "iterations": (b.iterations, s.iterations),
            "batched": {p: [grid(a[p]) for a in b.answers] for p in preds},
            "sequential": {p: [grid(a[p]) for a in s.answers]
                           for p in preds}}
    return out


def rows_on(mesh):
    """A row-table program served on ``mesh``: admitted sequentially (each
    query compiled with its bindings), ``force="batched"`` refused."""

    from repro_torch.core.executor import ExecutorError
    from repro_torch.core.serving import (
        FixpointServer,
        personalized_pagerank_program,
    )

    T = Pkg(True)
    ppr = personalized_pagerank_program()
    server = FixpointServer(T.shared(), mesh=mesh, storage="row-table")
    batch = [T.seed(vs) for vs in ROW_SEEDS]
    try:
        server.query(ppr, batch, max_iters=PPR_ITERS, force="batched")
        refusal = None
    except ExecutorError as err:
        refusal = str(err)
    res = server.query(ppr, batch, max_iters=PPR_ITERS)
    return {"refusal": refusal, "batched": res.batched,
            "note": res.notes[-1], "ranks": ranks_of(res)}


def loop_on(mesh):
    """The request loop (``max_batch=4``) over the mixed requests, and the
    same requests dispatched one by one."""

    from repro_torch.core.serving import (
        personalized_pagerank_program,
        point_reachability_program,
    )
    from repro_torch.launch.query_serve import (
        QueryRequest,
        build_query_server,
        serve_request_loop,
    )

    T = Pkg(True)
    server = build_query_server(T.shared(), mesh=mesh)
    programs = {"ppr": personalized_pagerank_program(),
                "reach": point_reachability_program()}
    requests = [
        QueryRequest(programs[kind],
                     T.seed(cols) if kind == "ppr" else T.probe(*cols),
                     max_iters=PPR_ITERS if kind == "ppr" else N,
                     tag=f"{kind}{i}")
        for i, (kind, cols) in enumerate(loop_requests())]

    def answer(answers):
        if "rank" in answers:
            present, values = grid(answers["rank"])
            return np.where(present, values[1], 0.0)
        return grid(answers["hit"])[0]

    responses = serve_request_loop(server, requests,
                                   max_batch=LOOP_MAX_BATCH)
    solo = [server.query(r.program, r.params, max_iters=r.max_iters)
            for r in requests]
    return {"tags": [r.request.tag for r in responses],
            "batches": [r.result.batch for r in responses],
            "batched": [r.batched for r in responses],
            "answers": [answer(r.answers) for r in responses],
            "solo": [answer(r.answers[0]) for r in solo]}


def audited(run):
    """``(run(), audit)``: C1 and C2 at the one operator the batched mesh
    step hands integer indices to (the dense step itself only broadcasts,
    narrows and gathers).  Every plain call of the sorted combine in
    ``run()``, the one call its batching rule makes for the k queries
    included, must get segment ids in ``[0, num_segments]`` (an id equal
    to the count spills: the plain version sends it to a row sliced off,
    the kernel drops it), sorted ascending, the kernel's precondition."""

    from torch._C._functorch import is_batchedtensor

    from repro_torch.core import physical

    real, seen, bad = physical._sorted_combine, [], []

    def record(values, ids, n, op, active):
        if not any(is_batchedtensor(t) for t in (values, ids)):
            seen.append(int(values.shape[1]))
            lo, hi = int(ids.min()), int(ids.max())
            if lo < 0 or hi > n or bool((ids[1:] < ids[:-1]).any()):
                bad.append((lo, hi, n))
        return real(values, ids, n, op, active)

    physical._sorted_combine = record
    try:
        out = run()
    finally:
        physical._sorted_combine = real
    return out, {"widths": sorted(set(seen)), "calls": len(seen),
                 "bad": bad}


def rank_main(rank, world):
    """One rank: the battery on each mesh of :data:`MESHES`, then (e) under
    the index audit, the row-table program and the request loop on the
    data mesh; with each part's seconds."""

    from repro_torch.launch.mesh import make_mesh

    out, seconds = {}, {}
    meshes = {tag: make_mesh(shape, axes, device="cpu")
              for tag, (shape, axes) in MESHES.items()}
    data = meshes["data"]
    parts = [(tag, lambda m=mesh: serve_on(m)) for tag, mesh in meshes.items()]
    parts += [("scan", lambda: audited(lambda: scan_on(data))),
              ("rows", lambda: rows_on(data)), ("loop", lambda: loop_on(data))]
    for name, run in parts:
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
    out["scan"], out["audit"] = out["scan"]
    out["seconds"] = seconds
    return out
