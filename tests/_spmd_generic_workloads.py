"""The generic engine on a mesh, in both packages: shared inputs and runners
for ``test_torch_spmd_generic.py`` (the row exchanges) and
``test_torch_spmd_generic_dense.py`` (the sharded dense grids, forced row
tables and the two listings).

The workloads are those of the JAX package's three 8-device programs
(``spmd_exchange_program.py``, ``spmd_executor_program.py``,
``spmd_rowtable_program.py``) on inputs made here with numpy from seeds.
:func:`jax_main` runs the JAX package's side in a subprocess with 8
virtual devices and writes the answers under a directory;
:func:`rank_main` is one of 8 ``gloo`` ranks of the port
(``launch_ranks``), which returns its answers together with those of the
port's single-device dense run of each workload.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

N = 64            # the domain of the JAX programs' small workloads
PN = 256          # the pipeline's domain
IMRU_N, IMRU_D, IMRU_ITERS = 512, 8, 60
CONNECTORS = ("dense_psum", "merging", "hash_sort")

# tag -> (program, relation set, predicates compared, max_iters, options
# of the mesh compile, options shared with the single-device dense run).
EXCHANGE = {
    "tc/gspmd": ("tc", "edge", ("tc",), 100,
                 {"storage": "row-table", "exchange": "gspmd"}, {}),
    "tc/bucket-a2a": ("tc", "edge", ("tc",), 100,
                      {"storage": "row-table", "exchange": "bucket-a2a"},
                      {}),
    "tc-chunked/bucket-a2a": ("tc", "edge", ("tc",), 100,
                              {"storage": "row-table",
                               "exchange": "bucket-a2a",
                               "chunks": {"edge": 3}}, {}),
    "cc-semi/bucket-a2a": ("cc", "cc", ("cc",), 100,
                           {"storage": "row-table",
                            "exchange": "bucket-a2a"},
                           {"semi_naive": True}),
    "negated-reach/bucket-a2a": ("nr", "nr", ("reach",), 100,
                                 {"storage": "row-table",
                                  "exchange": "bucket-a2a"}, {}),
    "pipeline/gspmd": ("pipe", "pipe", ("rank", "hot", "reach"), 60,
                       {"storage": "row-table", "exchange": "gspmd"},
                       {"semi_naive": True}),
    "pipeline/bucket-a2a": ("pipe", "pipe", ("rank", "hot", "reach"), 60,
                            {"storage": "row-table",
                             "exchange": "bucket-a2a"},
                            {"semi_naive": True}),
    "pipeline/psum-scatter": ("pipe", "pipe", ("rank", "hot", "reach"), 60,
                              {"storage": "row-table",
                               "exchange": "psum-scatter"},
                              {"semi_naive": True}),
}
# Connected components over 2,000 edge draws on 64 vertices: the edge side
# of C2's join is larger than its head, whose receiver cap the reference
# gives every side's buckets (ROADMAP C16).
WIDE = {
    "cc-wide/bucket-a2a": ("cc", "cc-wide", ("cc",), 100,
                           {"storage": "row-table",
                            "exchange": "bucket-a2a"}, {}),
}
DENSE = {
    "dense/tc": ("tc", "edge", ("tc",), 100, {}, {}),
    "dense/cc": ("cc", "cc", ("cc",), 100, {}, {}),
    "dense/cc-semi": ("cc", "cc", ("cc",), 100, {}, {"semi_naive": True}),
    "dense/pipeline": ("pipe-small", "pipe-small", ("rank", "hot", "reach"),
                       30, {}, {}),
}
# Dense heads over a row-table edge set: the rules run whole and the
# replicated row slabs land on each rank's block of the heads' grids.
MIXED = {
    "mixed/tc": ("tc", "edge", ("tc",), 100,
                 {"storage": {"edge": "row-table"}}, {}),
    "mixed/pipeline": ("pipe-small", "pipe-small", ("rank", "hot", "reach"),
                       30, {"storage": {"edge": "row-table"}}, {}),
}
ROWTABLE = {
    f"rows/{name}": (prog, rels, preds, iters, {"storage": "row-table"}, kw)
    for name, (prog, rels, preds, iters, kw) in {
        "tc": ("tc", "edge", ("tc",), 100, {}),
        "cc": ("cc", "cc", ("cc",), 100, {}),
        "cc-semi": ("cc", "cc", ("cc",), 100, {"semi_naive": True}),
        "negated-reach": ("nr", "nr", ("reach",), 100, {}),
        "pipeline": ("pipe", "pipe", ("rank", "hot", "reach"), 60, {}),
    }.items()
}
PARTS = {"exchange": {**EXCHANGE, **WIDE},
         "dense": {**DENSE, **MIXED, **ROWTABLE}}
LISTING1 = tuple(f"listing1/{c}" for c in CONNECTORS)


def inputs():
    """The numpy columns of every relation set, made from seeds."""

    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, N, 96), rng.integers(0, N, 96)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    psrc = np.repeat(np.arange(PN), 3)
    pdst = rng.integers(0, PN, 3 * PN)
    pdeg = np.bincount(psrc, minlength=PN).astype(np.float32)
    deg = np.bincount(src, minlength=N).astype(np.float32)
    gsrc = np.repeat(np.arange(N), 4).astype(np.int32)
    gdst = rng.integers(0, N, 4 * N).astype(np.int32)
    X = rng.normal(size=(IMRU_N, IMRU_D)).astype(np.float32)
    w = rng.normal(size=IMRU_D).astype(np.float32)
    wide = np.random.default_rng(12)
    ws, wd = wide.integers(0, N, 1000), wide.integers(0, N, 1000)
    return {
        "cc-wide": (N, {"edge": (np.concatenate([ws, wd]),
                                 np.concatenate([wd, ws])),
                        "node": (np.arange(N),
                                 np.arange(N, dtype=np.float32))}),
        "edge": (N, {"edge": (src, dst)}),
        "cc": (N, {"edge": (s2, d2),
                   "node": (np.arange(N), np.arange(N, dtype=np.float32))}),
        "nr": (N, {"edge": (src, dst),
                   "source": (np.arange(8),
                              np.array([1, 0, 1, 1, 0, 1, 0, 1],
                                       np.float32)),
                   "blocked": (np.array([3, 9, 27]),),
                   "node": (np.arange(N),
                            (np.arange(N) % 5).astype(np.float32))}),
        "pipe": (PN, {"edge": (psrc, pdst),
                      "node": (np.arange(PN),
                               np.full(PN, 1.0 / PN, np.float32), pdeg,
                               np.full(PN, 0.15 / PN, np.float32))}),
        "pipe-small": (N, {"edge": (src, dst),
                           "node": (np.arange(N),
                                    np.full(N, 1.0 / N, np.float32), deg,
                                    np.full(N, 0.15 / N, np.float32))}),
        "graph": (gsrc, gdst,
                  np.bincount(gsrc, minlength=N).astype(np.float32)),
        "imru": (X, X @ w),
    }


def _program(listings, name):
    return {
        "tc": listings.transitive_closure_program,
        "cc": listings.connected_components_program,
        "nr": listings.negated_reach_program,
        "pipe": lambda: listings.pagerank_threshold_program(tau=1.5 / PN),
        "pipe-small": lambda: listings.pagerank_threshold_program(tau=0.012),
    }[name]()


def _grids(rel):
    """(presence, {position: values}) of a result relation, dense."""

    if hasattr(rel, "to_dense"):
        rel = rel.to_dense()
    present = rel.present
    if hasattr(present, "cpu"):
        present = present.cpu()
    return (np.asarray(present),
            {int(k): np.asarray(v.cpu() if hasattr(v, "cpu") else v)
             for k, v in rel.values.items()})


def _record(res, preds, ex):
    return {
        "grids": {p: _grids(res.state[p]) for p in preds},
        "iterations": int(res.iterations),
        "phase_iterations": [int(i) for i in res.phase_iterations],
        "converged": bool(res.converged),
        "fallback": bool(res.storage_fallback),
        "notes": list(ex.plan.notes),
    }


# ---------------------------------------------------------------------------
# The JAX package's side (a subprocess with 8 virtual devices)
# ---------------------------------------------------------------------------


def jax_main(out_dir, part):
    import pickle

    import jax

    from repro.core import listings
    from repro.core.executor import Relation, compile_program
    from repro.launch.mesh import make_data_mesh

    assert len(jax.devices()) == 8
    mesh = make_data_mesh()
    data = inputs()
    out = {}
    for tag, (prog, rels, preds, iters, mesh_kw, kw) in PARTS[part].items():
        n, cols = data[rels]
        relations = {k: Relation.from_columns(n, *c) for k, c in cols.items()}
        ex = compile_program(_program(listings, prog), relations, mesh=mesh,
                             **mesh_kw, **kw)
        out[tag] = _record(ex.run(max_iters=iters), preds, ex)
    if part == "dense":
        out.update(_jax_listings(mesh, data))
    with open(os.path.join(out_dir, f"jax_{part}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_listings(mesh, data):
    import jax.numpy as jnp

    from repro.core.executor import compile_program
    from repro.core.imru import IMRUTask
    from repro.core.pregel import Graph, VertexProgram

    gsrc, gdst, outdeg = data["graph"]
    g = Graph(N, jnp.asarray(gsrc), jnp.asarray(gdst), jnp.asarray(outdeg))
    vp = VertexProgram(
        init_vertex=lambda ids, vd: jnp.stack(
            [jnp.full((N,), 1.0 / N), vd], axis=1),
        message=lambda j, s, ed: s[:, 0] / jnp.maximum(s[:, 1], 1.0),
        apply=lambda j, s, inbox, got: (
            jnp.stack([0.15 / N + 0.85 * inbox, s[:, 1]], axis=1),
            jnp.ones(s.shape[0], jnp.bool_)),
        combine="sum",
    )
    out = {}
    for conn in CONNECTORS:
        ex = compile_program(vp.program(), {"data": g}, binding=vp,
                             mesh=mesh, force_connector=conn)
        res = ex.run(max_iters=12)
        out[f"listing1/{conn}"] = {"state": np.asarray(res.state[0]),
                                   "notes": list(ex.plan.notes)}
    X, y = data["imru"]
    task = IMRUTask(
        init_model=lambda: jnp.zeros(IMRU_D, jnp.float32),
        map=lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"],
        update=lambda j, m, gr: m - 1e-3 * gr,
        tol=1e-9,
    )
    ex = compile_program(task.program(),
                         {"training_data": {"x": jnp.asarray(X),
                                            "y": jnp.asarray(y)}},
                         binding=task, mesh=mesh)
    res = ex.run(max_iters=IMRU_ITERS)
    out["listing2"] = {"state": np.asarray(res.state),
                       "notes": list(ex.plan.notes)}
    return out


# ---------------------------------------------------------------------------
# The port's side: one of 8 gloo ranks
# ---------------------------------------------------------------------------


def _port_relations(data, rels):
    from repro_torch.core.executor import Relation

    n, cols = data[rels]
    return {k: Relation.from_columns(n, *c, device="cpu")
            for k, c in cols.items()}


def run_case(case, mesh, data, single=True):
    """The port's answer to one workload on ``mesh``, and (``single``) the
    grids of its single-device dense run."""

    from repro_torch.core import listings
    from repro_torch.core.executor import compile_program

    prog, rels, preds, iters, mesh_kw, kw = case
    relations = _port_relations(data, rels)
    ex = compile_program(_program(listings, prog), relations, mesh=mesh,
                         **mesh_kw, **kw)
    out = _record(ex.run(max_iters=iters), preds, ex)
    if single:
        one = compile_program(_program(listings, prog), relations,
                              device="cpu", **kw).run(max_iters=iters)
        out["single"] = {p: _grids(one.state[p]) for p in preds}
    return out


def _port_listings(mesh, data):
    import torch

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.executor import compile_program
    from repro_torch.core.imru import IMRUTask, compile_imru
    from repro_torch.core.pregel import VertexProgram, compile_pregel

    gsrc, gdst, outdeg = data["graph"]
    g = graph_from_numpy(N, gsrc, gdst, outdeg, device="cpu")
    vp = VertexProgram(
        init_vertex=lambda ids, vd: torch.stack(
            [torch.full((N,), 1.0 / N, device=ids.device), vd], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / N + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool, device=s.device)),
        combine="sum",
    )
    out = {}
    for conn in CONNECTORS:
        gen = compile_program(vp.program(), {"data": g}, binding=vp,
                              mesh=mesh, force_connector=conn)
        spec = compile_pregel(vp, g, mesh=mesh, force_connector=conn)
        out[f"listing1/{conn}"] = {
            "state": gen.run(max_iters=12).state[0].numpy(),
            "spec": spec.run(max_iters=12).state[0].numpy(),
            "notes": list(gen.plan.notes),
            "spec_notes": list(spec.plan.notes)}
    # Listing 2: this rank's shard of the records (the data axis's).
    X, y = data["imru"]
    per = IMRU_N // mesh.shape["data"]
    s = mesh.linear_index(mesh.batch_axes)
    recs = {"x": torch.from_numpy(X[s * per:(s + 1) * per]),
            "y": torch.from_numpy(y[s * per:(s + 1) * per])}
    task = IMRUTask(
        init_model=lambda: torch.zeros(IMRU_D),
        map=lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"],
        update=lambda j, m, gr: m - 1e-3 * gr,
        tol=1e-9,
    )
    gen = compile_program(task.program(), {"training_data": recs},
                          binding=task, mesh=mesh)
    spec = compile_imru(task, recs, mesh=mesh)
    out["listing2"] = {"state": gen.run(max_iters=IMRU_ITERS).state.numpy(),
                       "spec": spec.run(max_iters=IMRU_ITERS).state.numpy(),
                       "notes": list(gen.plan.notes),
                       "spec_notes": list(spec.plan.notes)}
    return out


def rank_main(rank, world, part, extras):
    """One rank of the port: every workload of ``part`` on the ``(8,)``
    data mesh, then the named ``extras`` (functions of this module called
    with the mesh and the inputs, each returning a dict)."""

    from repro_torch.launch.mesh import make_data_mesh

    t0 = time.perf_counter()
    mesh = make_data_mesh(device="cpu")
    data = inputs()
    out = {tag: run_case(case, mesh, data)
           for tag, case in PARTS[part].items()}
    if part == "dense":
        out.update(_port_listings(mesh, data))
    for name in extras:
        out[name] = globals()[name](mesh, data)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Extras run inside the ranks
# ---------------------------------------------------------------------------


def audit(mesh, data):
    """C1: every integer index handed to torch by the row exchanges, the
    block converters and the sharded dense rules lies in range."""

    from test_torch_spmd import _IndexAudit

    with _IndexAudit() as a:
        for tag in ("tc-chunked/bucket-a2a", "cc-semi/bucket-a2a",
                    "negated-reach/bucket-a2a", "pipeline/bucket-a2a",
                    "pipeline/psum-scatter"):
            run_case(EXCHANGE[tag], mesh, data, single=False)
        for case in (DENSE["dense/pipeline"], *MIXED.values()):
            run_case(case, mesh, data, single=False)
        overflow(mesh, data)
    return {"checked": a.checked, "bad": a.bad}


@contextlib.contextmanager
def _local_flags(log):
    """Record each exchange's own overflow flag, before the ranks OR it."""

    from unittest import mock

    from repro_torch.core import executor

    real = executor.exchange_row_slabs

    def record(*a, **kw):
        outs, of = real(*a, **kw)
        log.append(bool(of))
        return outs, of

    with mock.patch.object(executor, "exchange_row_slabs", record), \
            mock.patch.object(executor, "row_hash_exchange",
                              _hash_exchange(record)):
        yield


def _hash_exchange(slabs):
    def exchange(owner, payload, valid, n_shards, bucket_cap, axes):
        ((out, valid_x),), of = slabs([(owner, payload, valid)], n_shards,
                                      bucket_cap, axes)
        return out, valid_x, of
    return exchange


def overflow(mesh, data):
    """Buckets of 2 rows for the transitive closure's join: the ranks'
    own flags differ (the valid rows lie on the first ranks' slices),
    every rank takes the dense fallback, and the answer is the
    single-device one."""

    from unittest import mock

    from repro_torch.core import executor, listings

    relations = _port_relations(data, "edge")
    ex = executor.compile_program(listings.transitive_closure_program(),
                                  relations, mesh=mesh, storage="row-table",
                                  exchange="bucket-a2a")
    flags = []
    with _local_flags(flags), mock.patch.object(
            executor, "_bucket_cap", lambda ecap, slices, n_shards: 2):
        res = ex.run(max_iters=100)
    return {"flags": flags, "fallback": bool(res.storage_fallback),
            "tc": _grids(res.state["tc"])[0]}


def blocks(mesh, data):
    """The shapes a rank holds: the carried state, its delta, a view and
    the EDB grids of the dense transitive closure and pipeline."""

    from repro_torch.core import listings
    from repro_torch.core.executor import compile_program

    ex = compile_program(listings.transitive_closure_program(),
                         _port_relations(data, "edge"), mesh=mesh,
                         semi_naive=True)
    _, state = ex.phase_step_fn()
    pipe = compile_program(_program(listings, "pipe-small"),
                           _port_relations(data, "pipe-small"), mesh=mesh)
    _, pstate = pipe.phase_step_fn()
    return {
        "tc": tuple(state["tc"]["present"].shape),
        "delta": tuple(state["tc"]["delta"].shape),
        "edge": tuple(ex.local_relations["edge"].present.shape),
        "rank": tuple(pstate["rank"]["values"][1].shape),
        "node": tuple(pipe.local_relations["node"].values[2].shape),
        "owners": sorted(df.label for ph in pipe.phases
                         for df in ph.init + ph.body + ph.finals + ph.post
                         if id(df) in pipe.owners),
        "sharded": sorted(pipe.sharded),
    }


def refusals(mesh, data):
    """The options that once refused on a mesh, each of which runs now:
    fault tolerance (A10c: checkpoints, a crash injected on rank 3 only
    (every rank restarts once) and a remesh onto the same ranks, each
    against the plain run's closure), and serving (A10d: ``run(params=)``
    and ``run_batched`` over the edge relation and its reverse, each
    against the single-device executable's answers to the same bindings).
    """

    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import listings
    from repro_torch.core.executor import Relation, compile_program
    from repro_torch.ft import FailureInjector

    ex = compile_program(listings.transitive_closure_program(),
                         _port_relations(data, "edge"), mesh=mesh)
    n, cols = data["edge"]
    src, dst = cols["edge"]
    params = [{"edge": Relation.from_columns(n, a, b, device="cpu")}
              for a, b in ((src, dst), (dst, src))]
    want = _grids(ex.run(max_iters=100).state["tc"])[0]
    out = {}
    # One directory for every rank: rank 0 writes, every rank restores.
    made = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(made, src=0)
    d = made[0]
    ported = {
        "checkpoint_dir": lambda: ex.run(
            max_iters=100, checkpoint_dir=os.path.join(d, "a"),
            checkpoint_every=2),
        "injector": lambda: ex.run(
            max_iters=100, checkpoint_dir=os.path.join(d, "b"),
            checkpoint_every=2, injector=FailureInjector(
                crashes=[2] if dist.get_rank() == 3 else [])),
        "remesh": lambda: ex.remesh(mesh).run(max_iters=100),
    }
    for name, call in ported.items():
        res = call()
        out[name] = {"equal": bool(np.array_equal(
                         _grids(res.state["tc"])[0], want)),
                     "restarts": res.restarts,
                     "events": list(res.remesh_events)}
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(d)
    one = compile_program(listings.transitive_closure_program(),
                          _port_relations(data, "edge"), device="cpu")
    served = {
        "params": lambda x: [x.run(max_iters=100, params=ps)
                             for ps in params],
        "run_batched": lambda x: x.run_batched(params, max_iters=100),
    }
    for name, call in served.items():
        got, single = call(ex), call(one)
        out[name] = {"equal": all(
                         np.array_equal(_grids(g.state["tc"])[0],
                                        _grids(w.state["tc"])[0])
                         and g.iterations == w.iterations
                         for g, w in zip(got, single)),
                     "restarts": sum(g.restarts for g in got),
                     "events": [e for g in got for e in g.remesh_events]}
    return out


def load_jax(out_dir, part):
    import pickle

    with open(os.path.join(out_dir, f"jax_{part}.pkl"), "rb") as f:
        return pickle.load(f)

