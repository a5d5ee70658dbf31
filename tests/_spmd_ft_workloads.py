"""Fault tolerance on a mesh, in both packages: shared inputs and the rank
program of ``test_torch_spmd_ft.py``.

The workloads are those of the JAX package's chaos program
(``spmd_ft_program.py``) on the same numpy inputs, from the same seeds:
transitive closure, semi-naive connected components and the PageRank ->
threshold -> reach pipeline on the generic engine, weighted SSSP on
Pregel, at N = 32.  :func:`rank_main` is one of 8 ``gloo`` ranks of the
port (``launch_ranks``).  Each workload runs, as the reference's does,
uninterrupted, crashed and restored, and crashed past its restarts then
remeshed 8 -> 4 onto ranks 4-7 (rank 0, the old writer, is among the lost
ranks) and resumed from the same checkpoints; and beside them: a crash
scheduled on one rank only, a remesh 4 -> 1 (``remesh(None)``) on rank 4
from the crashed-out run's checkpoint, and a resume of a checkpoint the
JAX package wrote on one device.  IMRU BGD runs uninterrupted, crashed
and restored, and with one rank straggling.  Every answer comes back as
numpy arrays of the global state.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

N = 32
ITERS = {"tc": 40, "cc_semi_naive": 40, "pipeline": 20, "sssp_weighted": 40}
# The predicates each generic workload's answer holds.
PREDS = {"tc": ("tc",), "cc_semi_naive": ("cc",),
         "pipeline": ("rank", "hot", "reach")}
GENERIC = tuple(PREDS)
WORKLOADS = GENERIC + ("sssp_weighted",)
# The workloads a JAX one-device checkpoint resumes on the ranks.
FROM_JAX = ("pipeline", "sssp_weighted")
CRASH_OUT = (2, 3)       # the crashed-out run: crashes past max_restarts=1
LONE_RANK = 5            # the rank whose own injector crashes
SURVIVORS = (4, 5, 6, 7)
ONE_DEVICE_RANK = 4      # the rank that remeshes 4 -> 1
IMRU_N, IMRU_D, IMRU_ITERS = 512, 8, 30
IMRU_CRASH = 3
IMRU_STRAGGLE = (6, 0.4)  # (iteration, seconds) on STRAGGLER only
STRAGGLER = 2


def inputs():
    """The chaos program's inputs, drawn in its order from its seed."""

    rng = np.random.default_rng(11)
    src = rng.integers(0, N, 64)
    dst = rng.integers(0, N, 64)
    gsrc = np.repeat(np.arange(N), 4).astype(np.int32)
    gdst = rng.integers(0, N, 4 * N).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, 4 * N).astype(np.float32)
    return {"src": src, "dst": dst, "gsrc": gsrc, "gdst": gdst,
            "weights": weights}


def imru_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(IMRU_N, IMRU_D)).astype(np.float32)
    w_true = rng.normal(size=(IMRU_D,)).astype(np.float32)
    return X, X @ w_true, 0.01 / IMRU_N


def generic_case(name, data, relation, TL):
    """``(program, relations, semi_naive)`` of a generic workload, its
    program from the listings module ``TL`` of either package and its
    relations built by ``relation(n, *columns)``."""

    src, dst = data["src"], data["dst"]
    if name == "tc":
        return TL.transitive_closure_program(), \
            {"edge": relation(N, src, dst)}, False
    if name == "cc_semi_naive":
        s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
        return TL.connected_components_program(), {
            "edge": relation(N, s2, d2),
            "node": relation(N, np.arange(N),
                             np.arange(N, dtype=np.float32))}, True
    deg = np.bincount(src, minlength=N).astype(np.float32)
    return TL.pagerank_threshold_program(tau=0.04), {
        "edge": relation(N, src, dst),
        "node": relation(N, np.arange(N), np.full(N, 1.0 / N, np.float32),
                         deg, np.full(N, 0.15 / N, np.float32))}, False


def grids(res, preds):
    """``{pred: (present, {col: values})}`` of a generic result, numpy."""

    out = {}
    for p in preds:
        rel = res.state[p]
        out[p] = (np.asarray(rel.present.cpu()),
                  {k: np.asarray(v.cpu()) for k, v in rel.values.items()})
    return out


def _summary(res, ex, answer):
    return {"answer": answer(res), "restarts": res.restarts,
            "phases": list(res.phase_iterations),
            "iterations": res.iterations, "events": list(res.remesh_events),
            "stragglers": res.straggler_events,
            "notes": list(ex.plan.notes)}


def _chaos(name, rank, root, compile_on, answer, mesh8, mesh4, jax_dir):
    """One workload three ways (and the extra cases); ``compile_on(mesh)``
    compiles it on a mesh or one device."""

    import torch.distributed as dist

    from repro_torch.ft import FailureInjector

    iters = ITERS[name]
    d = os.path.join(root, name)
    out = {}
    ex = compile_on(mesh8)
    out["clean"] = _summary(ex.run(max_iters=iters, on_device=False), ex,
                            answer)
    ex = compile_on(mesh8)
    out["crash"] = _summary(ex.run(
        max_iters=iters, checkpoint_dir=os.path.join(d, "crash"),
        checkpoint_every=4, injector=FailureInjector(crashes=[3])), ex,
        answer)
    ex = compile_on(mesh8)
    lone = FailureInjector(crashes=[3] if rank == LONE_RANK else [])
    out["lone"] = _summary(ex.run(
        max_iters=iters, checkpoint_dir=os.path.join(d, "lone"),
        checkpoint_every=4, injector=lone), ex, answer)
    out["lone"]["fired"] = len(lone.fired)

    ex8 = compile_on(mesh8)
    out_dir = os.path.join(d, "out")
    try:
        ex8.run(max_iters=iters, checkpoint_dir=out_dir, checkpoint_every=2,
                injector=FailureInjector(crashes=list(CRASH_OUT)),
                max_restarts=1)
        out["raised"] = None
    except RuntimeError as err:
        out["raised"] = str(err)
    if rank == 0:
        # The crashed-out checkpoint as it stands, for the one-device
        # resume and the JAX package (the remeshed run writes on).
        shutil.copytree(out_dir, os.path.join(d, "snapshot"))
    dist.barrier()
    if mesh4 is not None:
        ex4 = ex8.remesh(mesh4)
        out["remesh"] = _summary(ex4.run(
            max_iters=iters, checkpoint_dir=out_dir, resume=True), ex4,
            answer)
        if rank == ONE_DEVICE_RANK:
            one_dir = os.path.join(d, "one_device")
            shutil.copytree(os.path.join(d, "snapshot"), one_dir)
            ex1 = ex4.remesh(None)
            out["one_device"] = _summary(ex1.run(
                max_iters=iters, checkpoint_dir=one_dir, resume=True), ex1,
                answer)
    if name in FROM_JAX:
        ex = compile_on(mesh8)
        out["from_jax"] = _summary(ex.run(
            max_iters=iters, checkpoint_dir=os.path.join(jax_dir, name),
            resume=True), ex, answer)
    return out


def _survivors(rank, mesh8):
    """Meshes over a subset of the world: a prefix is never taken
    unasked, and a (2, 2) mesh over ranks 4-7 gathers over its two axes in
    its own order; the collectives a run without fault tolerance makes."""

    import torch

    from repro_torch.core.listings import transitive_closure_program
    from repro_torch.core.executor import Relation, compile_program
    from repro_torch.launch.mesh import make_data_mesh, make_mesh
    from repro_torch.parallel import collectives as C

    out = {}
    try:
        make_data_mesh(4, device="cpu")
        out["prefix"] = None
    except ValueError as err:
        out["prefix"] = str(err)
    m22 = make_mesh((2, 2), ("pod", "data"), ranks=SURVIVORS, device="cpu")
    if m22 is not None:
        with C.bind(m22):
            out["gathered"] = C.all_gather(
                torch.tensor([rank]), ("pod", "data")).reshape(-1).tolist()
            out["summed"] = int(C.psum(torch.tensor([rank]), ("pod",
                                                             "data")))
        out["index"] = m22.linear_index(("pod", "data"))
    # Without fault tolerance a mesh run keeps its collectives: one 4 B
    # agreed flag an iteration.
    data = inputs()
    ex = compile_program(transitive_closure_program(), {
        "edge": Relation.from_columns(N, data["src"], data["dst"],
                                      device="cpu")}, mesh=mesh8)
    mesh8.stats.reset()
    res = ex.run(max_iters=ITERS["tc"])
    out["plain_pmax"] = (dict(mesh8.stats.sent).get("pmax", 0),
                         res.iterations)
    return out


def _in_step_failure(root, mesh8):
    """C17: a failure raised inside a superstep (here on every rank, at the
    same superstep, before its collectives) propagates on a mesh after
    one try, where one device restores and replays it."""

    import torch

    from repro_torch.core.pregel import VertexProgram, compile_pregel
    from repro_torch.carry import graph_from_numpy

    data = inputs()
    g = graph_from_numpy(N, data["gsrc"], data["gdst"],
                         np.zeros(N, np.float32), edge_data=data["weights"],
                         device="cpu")
    tries = []

    def message(j, s, ed):
        if j == 3:
            tries.append(j)
            raise RuntimeError("failure inside the step")
        return s + ed

    vp = VertexProgram(
        init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, 1e9),
        message=message,
        apply=lambda j, s, inbox, got: (torch.minimum(s, inbox),
                                        torch.minimum(s, inbox) < s),
        combine="min")
    ex = compile_pregel(vp, g, mesh=mesh8, device="cpu")
    try:
        ex.run(max_iters=ITERS["sssp_weighted"], on_device=False,
               checkpoint_dir=os.path.join(root, "in_step"),
               checkpoint_every=2)
        raised = None
    except RuntimeError as err:
        raised = str(err)
    return {"in_step": {"raised": raised, "tries": len(tries)}}


def rank_main(rank, world, root, jax_dir):
    """One rank of the chaos program: every workload, then IMRU."""

    import time

    import torch

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core import listings
    from repro_torch.core.executor import Relation, compile_program
    from repro_torch.core.imru import IMRUTask, compile_imru
    from repro_torch.core.pregel import VertexProgram, compile_pregel
    from repro_torch.ft import FailureInjector
    from repro_torch.launch.mesh import make_data_mesh

    t0 = time.perf_counter()
    mesh8 = make_data_mesh(device="cpu")
    mesh4 = make_data_mesh(4, ranks=SURVIVORS, device="cpu")
    data = inputs()
    results = {"in_mesh4": mesh4 is not None}
    results.update(_survivors(rank, mesh8))
    results.update(_in_step_failure(root, mesh8))

    def rel(n, *cols):
        return Relation.from_columns(n, *cols, device="cpu")

    for name in GENERIC:
        program, rels, semi = generic_case(name, data, rel, listings)

        def compile_on(mesh, program=program, rels=rels, semi=semi):
            return compile_program(program, dict(rels), mesh=mesh,
                                   semi_naive=semi, device="cpu")

        results[name] = _chaos(name, rank, root, compile_on,
                               lambda r, _p=PREDS[name]: grids(r, _p),
                               mesh8, mesh4, jax_dir)

    g = graph_from_numpy(N, data["gsrc"], data["gdst"],
                         np.zeros(N, np.float32), edge_data=data["weights"],
                         device="cpu")
    vp = VertexProgram(
        init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, 1e9),
        message=lambda j, s, ed: s + ed,
        apply=lambda j, s, inbox, got: (torch.minimum(s, inbox),
                                        torch.minimum(s, inbox) < s),
        combine="min")
    results["sssp_weighted"] = _chaos(
        "sssp_weighted", rank, root,
        lambda mesh: compile_pregel(vp, g, mesh=mesh, device="cpu"),
        lambda r: {"state": np.asarray(r.state[0]),
                   "active": np.asarray(r.state[1])},
        mesh8, mesh4, jax_dir)

    # IMRU BGD: this rank's eighth of the records, the model replicated.
    X, y, lr = imru_data()
    per = IMRU_N // world
    rec = {"x": torch.from_numpy(X[rank * per:(rank + 1) * per]),
           "y": torch.from_numpy(y[rank * per:(rank + 1) * per])}
    task = IMRUTask(init_model=lambda: torch.zeros(IMRU_D),
                    map=lambda r, m: (r["x"] @ m - r["y"]) @ r["x"],
                    update=lambda j, m, g: m - lr * g)
    imru = {}
    ex = compile_imru(task, rec, mesh=mesh8)
    clean = ex.run(max_iters=IMRU_ITERS, on_device=False,
                   straggler_fallback=False)
    imru["clean"] = np.asarray(clean.state)
    imru["notes"] = list(ex.plan.notes)
    ex = compile_imru(task, rec, mesh=mesh8)
    res = ex.run(max_iters=IMRU_ITERS,
                 checkpoint_dir=os.path.join(root, "imru"),
                 checkpoint_every=2,
                 injector=FailureInjector(crashes=[IMRU_CRASH]),
                 straggler_fallback=False)
    imru["crash"] = np.asarray(res.state)
    imru["crash_restarts"] = res.restarts
    ex = compile_imru(task, rec, mesh=mesh8)
    slow = FailureInjector(straggles=[IMRU_STRAGGLE] if rank == STRAGGLER
                           else [])
    res = ex.run(max_iters=IMRU_ITERS, on_device=False, injector=slow)
    imru["straggle"] = np.asarray(res.state)
    imru["straggle_events"] = res.straggler_events
    imru["straggle_notes"] = list(ex.plan.notes)
    imru["fallbacks"] = list(ex.straggler_fallbacks)
    imru["reduce"] = ex.plan.reduce.kind
    results["imru"] = imru
    results["seconds"] = time.perf_counter() - t0
    return results
