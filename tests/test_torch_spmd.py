"""Sharded Pregel and IMRU in the port against the JAX package's 8-device
runs.

One module-scoped fixture runs two things at once on the same numpy inputs
made from seeds: a subprocess of the JAX package with 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``, set before JAX is imported),
which writes its answers to an ``.npz`` and a ``.json`` under ``tmp_path``,
and 8 ``gloo`` ranks of the port (``launch_ranks``: spawned processes that
meet through a FileStore under ``tmp_path``, every collective and the
launch itself under a timeout).  The tests compare the two:

* Pregel on the ``(8,)`` ``data`` mesh over ``dense_psum``, ``merging``
  and ``hash_sort``, dense and semi-naive (the plan's density threshold
  and cap floor pinned as the JAX package's SPMD programs pin them):
  PageRank, SSSP, CC, weighted SSSP, edge-weighted PageRank, and the
  argmin / topk / mean / logsumexp workloads in float64; PageRank on the
  ``(4, 2)`` ``data x model`` mesh.  The f32 programs run a second time
  under the card's combine contract (the kernel's plain version, whose
  empty max/min segments read 0), which the sharded max/min fold must
  not take for a message.  max/min/argmin/topk states
  bit-equal, the others within 1e-6 relative; the same iterations,
  convergence and ``modes``; ``plan.notes`` byte-equal.
* IMRU batch gradient descent on the ``(2, 2, 2)`` ``pod x data x model``
  mesh under the four reduce schedules, each within 1e-6 of the JAX
  package's; ``ef_int8_allreduce`` over 500 steps on the ``(4, 2)`` mesh
  within 5e-2 of the truth (the reference test's bar) and 1e-6 of the JAX
  package's model, and ``compile_imru(codec="int8_ef")`` on the
  ``(2, 2, 2)`` mesh, whose shards are the same four, within 1e-6 of it.
* ``kary_tree_psum`` for k in {2, 3, 4} over 8 ranks equal to ``psum``
  (int32 exactly, f32 within 1e-6).
* The ranks agree: every rank gathers the same global states.

In-process: C5 (``_bucket_by_owner`` keeps a bucket's first ``cap`` rows
where the reference's clamp overwrites slot cap - 1) and C1 (inside the
ranks, every integer index the sharded connectors hand to torch lies in
range, under an audit mode).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core import physical as TP
from repro_torch.launch.mesh import launch_ranks

ROOT = Path(__file__).resolve().parents[1]
N = 64
CONNECTORS = ("dense_psum", "merging", "hash_sort")
# name -> (max_iters, readout column or None, combine)
PROGRAMS = {"pagerank": (15, 0, "sum"), "sssp": (100, None, "min"),
            "cc": (100, None, "max"), "sssp_w": (100, None, "min"),
            "pagerank_w": (15, 0, "sum")}
MONOIDS = {"argmin_sssp": "argmin", "topk_prop": "topk",
           "mean_labelprop": "mean", "logsumexp_diffusion": "logsumexp"}
EXACT = {"min", "max", "argmin", "topk"}
SCHEDULES = ("flat", "hierarchical", "kary_tree", "scatter")
IMRU_N, IMRU_D, IMRU_ITERS, EF_STEPS = 512, 8, 300, 500
REL_TOL = 1e-6
LAUNCH_TIMEOUT = 600.0
PREGEL_CASES = (
    [f"data8/{p}/{c}/{m}" for p in PROGRAMS for c in CONNECTORS
     for m in ("dense", "sparse")]
    + [f"data8/{w}/{c}/{m}" for w in MONOIDS for c in CONNECTORS
       for m in ("dense", "sparse")]
    + [f"data4model2/pagerank/{c}/dense" for c in CONNECTORS])
# The f32 cases again under the card's combine contract (below).
KERNEL_CASES = [f"kernel/{p}/{c}/{m}" for p in PROGRAMS for c in CONNECTORS
                for m in ("dense", "sparse")]


# ---------------------------------------------------------------------------
# Inputs, made with numpy from seeds (the JAX package's SPMD programs')
# ---------------------------------------------------------------------------


def _random_graph(seed=1):
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(N):
        for _ in range(rng.integers(1, 5)):
            src.append(v)
            dst.append(int(rng.integers(0, N)))
    for v in range(N):
        src.append(int(rng.integers(0, N)))
        dst.append(v)
    return np.array(src, np.int32), np.array(dst, np.int32)


def _edge_weights(n_edges):
    return (((np.arange(n_edges) % 7) + 1) * 0.25).astype(np.float32)


def _imru_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(IMRU_N, IMRU_D)).astype(np.float32)
    w_true = rng.normal(size=(IMRU_D,)).astype(np.float32)
    return X, w_true, X @ w_true, 0.01 / IMRU_N


def _monoid_inputs():
    sys.path.insert(0, str(ROOT / "tests"))
    from _monoid_workloads import TOPK_K, make_graph

    rng = np.random.default_rng(11)
    return make_graph(N), rng.standard_normal(N) * 3.0, TOPK_K


# ---------------------------------------------------------------------------
# The JAX side: run in a subprocess with 8 virtual devices
# ---------------------------------------------------------------------------


def _jax_programs():
    import jax.numpy as jnp

    from repro.core.pregel import VertexProgram

    inf = jnp.float32(1e9)

    def pr(msg):
        return VertexProgram(
            init_vertex=lambda ids, vd: jnp.stack(
                [jnp.full((N,), 1.0 / N), vd], axis=1),
            message=msg,
            apply=lambda j, s, inbox, got: (
                jnp.stack([0.15 / N + 0.85 * inbox, s[:, 1]], axis=1),
                jnp.ones(s.shape[0], jnp.bool_)),
            combine="sum")

    def sssp(msg):
        return VertexProgram(
            init_vertex=lambda ids, vd: jnp.where(ids == 0, 0.0, inf),
            message=msg,
            apply=lambda j, s, inbox, got: (
                jnp.minimum(s, inbox), jnp.minimum(s, inbox) < s),
            combine="min")

    return {
        "pagerank": pr(lambda j, s, ed: s[:, 0] / jnp.maximum(s[:, 1], 1.0)),
        "sssp": sssp(lambda j, s, ed: s + 1.0),
        "cc": VertexProgram(
            init_vertex=lambda ids, vd: ids.astype(jnp.float32),
            message=lambda j, s, ed: s,
            apply=lambda j, s, inbox, got: (
                jnp.maximum(s, inbox), jnp.maximum(s, inbox) > s),
            combine="max"),
        "sssp_w": sssp(lambda j, s, ed: s + ed),
        "pagerank_w": pr(
            lambda j, s, ed: s[:, 0] / jnp.maximum(s[:, 1], 1.0) * ed),
    }


def _jax_pregel(ex, sparse, iters):
    import dataclasses

    if sparse:
        ex.plan = dataclasses.replace(ex.plan, density_threshold=0.6,
                                      sparse_cap_floor=16)
    res = ex.run(max_iters=iters)
    return res, ex.plan.notes


def _jax_main(out_dir, part):
    """The JAX package's answers, written to ``out_dir/jax_<part>.npz`` and
    ``.json``: ``part`` "f32" runs every case but the generalized
    aggregates, "f64" those (in float64, as the JAX package's own sharded
    monoid program runs them); the fixture runs the two at once."""

    import jax

    from repro.launch.mesh import make_compat_mesh, make_data_mesh

    assert len(jax.devices()) == 8
    arrays, meta = {}, {}

    def record(case, res, notes):
        arrays[case] = np.asarray(res.state[0])
        meta[case] = {"iterations": int(res.iterations),
                      "converged": bool(res.converged),
                      "modes": list(res.modes), "notes": list(notes)}

    data8 = make_data_mesh()
    mesh42 = make_compat_mesh((4, 2), ("data", "model"))
    mesh222 = make_compat_mesh((2, 2, 2), ("pod", "data", "model"))
    if part == "f64":
        _jax_monoids(data8, record)
    else:
        _jax_f32(data8, mesh42, mesh222, record, arrays)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"),
             **{k.replace("/", "|"): v for k, v in arrays.items()})
    with open(os.path.join(out_dir, f"jax_{part}.json"), "w") as f:
        json.dump(meta, f)


def _jax_f32(data8, mesh42, mesh222, record, arrays):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core.imru import IMRUTask, compile_imru
    from repro.core.pregel import Graph, compile_pregel
    from repro.optim.compression import ef_int8_allreduce, init_ef_state

    src, dst = _random_graph()
    outdeg = np.bincount(src, minlength=N).astype(np.float32)
    weights = _edge_weights(len(src))
    progs = _jax_programs()
    for name, (iters, _, _) in PROGRAMS.items():
        edata = jnp.asarray(weights) if name.endswith("_w") else None
        g = Graph(N, jnp.asarray(src), jnp.asarray(dst),
                  jnp.asarray(outdeg), edge_data=edata)
        for conn in CONNECTORS:
            for mode in ("dense", "sparse"):
                ex = compile_pregel(progs[name], g, mesh=data8,
                                    force_connector=conn,
                                    semi_naive=mode == "sparse")
                record(f"data8/{name}/{conn}/{mode}",
                       *_jax_pregel(ex, mode == "sparse", iters))
    g = Graph(N, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(outdeg))
    for conn in CONNECTORS:
        ex = compile_pregel(progs["pagerank"], g, mesh=mesh42,
                            force_connector=conn)
        record(f"data4model2/pagerank/{conn}/dense",
               *_jax_pregel(ex, False, 15))

    # IMRU under the four schedules on (2, 2, 2); int8 error feedback.
    X, w_true, y, lr = _imru_data()
    for sched in SCHEDULES:
        task = IMRUTask(
            init_model=lambda: jnp.zeros((IMRU_D,), jnp.float32),
            map=lambda rec, m: ((rec["x"] @ m - rec["y"]) @ rec["x"]),
            update=lambda j, m, g: m - lr * g, tol=1e-7)
        ex = compile_imru(task, {"x": jnp.asarray(X), "y": jnp.asarray(y)},
                          mesh=mesh222, force_reduce=sched)
        res = ex.run(max_iters=IMRU_ITERS)
        record(f"imru/{sched}", res, ex.plan.notes)
        arrays[f"imru/{sched}"] = np.asarray(res.state)

    Xs = jax.device_put(jnp.asarray(X),
                        NamedSharding(mesh42, P(("data",), None)))
    ys = jax.device_put(jnp.asarray(y), NamedSharding(mesh42, P(("data",))))

    def step(w, resid):
        def shard_fn(xx, yy, w, r):
            g = (xx @ w - yy) @ xx
            (g_sum,), st = ef_int8_allreduce(
                (g,), init_ef_state((g,))._replace(residuals=(r,)),
                axes=("data",))
            return w - lr * g_sum, st.residuals[0]

        return shard_map(
            shard_fn, mesh=mesh42,
            in_specs=(P(("data",), None), P(("data",)), P(), P()),
            out_specs=(P(), P()), check_rep=False,
        )(Xs, ys, w, resid)

    w = jnp.zeros(IMRU_D, jnp.float32)
    resid = jnp.zeros(IMRU_D, jnp.float32)
    stepj = jax.jit(step)
    for _ in range(EF_STEPS):
        w, resid = stepj(w, resid)
        jax.block_until_ready(w)
    arrays["ef"] = np.asarray(w)


def _jax_monoids(data8, record):
    import jax
    import jax.numpy as jnp

    from repro.core.pregel import Graph, compile_pregel

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(ROOT / "tests"))
    from _monoid_workloads import build_workloads

    (msrc, mdst, mweights), _, _ = _monoid_inputs()
    for name, wl in build_workloads(N, dtype=jnp.float64).items():
        g = Graph(N, jnp.asarray(msrc), jnp.asarray(mdst),
                  jnp.zeros(N, jnp.float64),
                  edge_data=jnp.asarray(mweights) if wl["weighted"]
                  else None)
        for conn in CONNECTORS:
            for mode in ("dense", "sparse"):
                ex = compile_pregel(wl["prog"], g, mesh=data8,
                                    force_connector=conn,
                                    semi_naive=mode == "sparse")
                record(f"data8/{name}/{conn}/{mode}",
                       *_jax_pregel(ex, mode == "sparse", wl["iters"]))


# ---------------------------------------------------------------------------
# The port's side: 8 gloo ranks
# ---------------------------------------------------------------------------


def _torch_programs():
    from repro_torch.core.pregel import VertexProgram

    inf = 1e9

    def pr(msg):
        return VertexProgram(
            init_vertex=lambda ids, vd: torch.stack(
                [torch.full((N,), 1.0 / N, device=ids.device), vd], dim=1),
            message=msg,
            apply=lambda j, s, inbox, got: (
                torch.stack([0.15 / N + 0.85 * inbox, s[:, 1]], dim=1),
                torch.ones(s.shape[0], dtype=torch.bool, device=s.device)),
            combine="sum")

    def sssp(msg):
        return VertexProgram(
            init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, inf),
            message=msg,
            apply=lambda j, s, inbox, got: (
                torch.minimum(s, inbox), torch.minimum(s, inbox) < s),
            combine="min")

    return {
        "pagerank": pr(lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1],
                                                              min=1.0)),
        "sssp": sssp(lambda j, s, ed: s + 1.0),
        "cc": VertexProgram(
            init_vertex=lambda ids, vd: ids.to(torch.float32),
            message=lambda j, s, ed: s,
            apply=lambda j, s, inbox, got: (
                torch.maximum(s, inbox), torch.maximum(s, inbox) > s),
            combine="max"),
        "sssp_w": sssp(lambda j, s, ed: s + ed),
        "pagerank_w": pr(
            lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0) * ed),
    }


def _torch_monoid_programs():
    """The four workloads of ``tests/_monoid_workloads.py`` in float64."""

    from repro_torch.core.pregel import VertexProgram

    _, seeds, k = _monoid_inputs()
    f64 = torch.float64
    seeds_t = torch.from_numpy(seeds)

    def sssp_init(ids, vd):
        dist = torch.where(ids == 0, 0.0, 1e9).to(f64)
        return torch.stack([dist, torch.full((N,), -1.0, dtype=f64,
                                             device=ids.device),
                            ids.to(f64)], dim=1)

    def sssp_apply(j, s, inbox, got):
        better = inbox[:, 0] < s[:, 0]
        head = torch.where(better[:, None], inbox, s[:, :2])
        return torch.cat([head, s[:, 2:]], dim=1), better

    def topk_init(ids, vd):
        base = torch.full((N, k), float("-inf"), dtype=f64,
                          device=ids.device)
        base[:, 0] = seeds_t.to(ids.device)
        return base

    def topk_apply(j, s, inbox, got):
        merged = torch.sort(torch.cat([s, inbox], dim=1), dim=1,
                            descending=True).values[:, :k]
        return merged, torch.any(merged != s, dim=1)

    def ones(s):
        return torch.ones(s.shape[0], dtype=torch.bool, device=s.device)

    return {
        "argmin_sssp": (VertexProgram(
            sssp_init, lambda j, s, ed: torch.stack([s[:, 0] + ed, s[:, 2]],
                                                    dim=1),
            sssp_apply, combine="argmin", name="sssp-parents"), 4 * N, True),
        "topk_prop": (VertexProgram(
            topk_init, lambda j, s, ed: s, topk_apply, combine="topk",
            name="topk-prop"), 4 * N, False),
        "mean_labelprop": (VertexProgram(
            lambda ids, vd: seeds_t.to(ids.device),
            lambda j, s, ed: torch.stack([s, torch.ones_like(s)], dim=1),
            lambda j, s, inbox, got: (0.5 * s + 0.5 * inbox, ones(s)),
            combine="mean", name="label-prop"), 6, False),
        "logsumexp_diffusion": (VertexProgram(
            lambda ids, vd: seeds_t.to(ids.device), lambda j, s, ed: s,
            lambda j, s, inbox, got: (inbox, ones(s)),
            combine="logsumexp", name="lse-diffusion"), 4, False),
    }


class _IndexAudit(TorchFunctionMode):
    """Records every integer index tensor that indexing, gathers and
    scatters receive outside ``[0, size)`` of its dimension (torch raises
    past the end on the CPU and device-asserts on CUDA, and wraps a
    negative index silently)."""

    def __init__(self):
        super().__init__()
        self.checked = 0
        self.bad = []

    def _check(self, t, dim, index):
        if not (isinstance(index, torch.Tensor) and index.numel()
                and not index.dtype.is_floating_point
                and index.dtype != torch.bool):
            return
        self.checked += 1
        lo, hi = int(index.min()), int(index.max())
        if not (0 <= lo and hi < t.shape[dim]):
            self.bad.append((lo, hi, int(t.shape[dim])))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            t, idx = args[0], args[1]
            idx = idx if isinstance(idx, tuple) else (idx,)
            for dim, index in enumerate(idx):
                self._check(t, dim, index)
        elif func in (torch.Tensor.index_select, torch.index_select,
                      torch.Tensor.index_add_):
            self._check(args[0], args[1], args[2])
        elif func is torch.Tensor.scatter_reduce_:
            self._check(args[0], args[1], args[2])
        return func(*args, **kwargs)


@contextlib.contextmanager
def _kernel_contract():
    """The combines as the card runs them: every f32 sum/max/min through
    the segment-combine kernel's plain version, whose contract is the
    kernel's (an empty max/min segment reads 0, not the identity)."""

    from unittest import mock

    from repro_torch.core import physical
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_reference,
    )

    def eligible(values, op="sum"):
        return op in ("sum", "max", "min") \
            and values.dtype in (torch.float32, torch.bfloat16)

    def launch(values, ids, n, op, edge_active=None):
        return segment_combine_reference(values, ids, n, op,
                                         edge_active=edge_active)

    with mock.patch.object(physical, "kernel_eligible", eligible), \
            mock.patch.object(physical, "segment_combine_cuda", launch):
        yield


def _port_pregel(ex, sparse, iters):
    import dataclasses

    if sparse:
        ex.plan = dataclasses.replace(ex.plan, density_threshold=0.6,
                                      sparse_cap_floor=16)
    res = ex.run(max_iters=iters)
    return {"state": res.state[0].numpy(), "iterations": res.iterations,
            "converged": bool(res.converged), "modes": list(res.modes),
            "notes": list(ex.plan.notes)}


def _rank_main(rank, world):
    """One rank of the port: every case, on the meshes of the JAX run."""

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.imru import IMRUTask, compile_imru
    from repro_torch.core.pregel import Graph, compile_pregel
    from repro_torch.launch.mesh import make_data_mesh, make_mesh
    from repro_torch.optim.compression import ef_int8_allreduce, init_ef_state
    from repro_torch.parallel import collectives as C

    t0 = time.perf_counter()
    data8 = make_data_mesh(device="cpu")
    mesh42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    mesh222 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    out = {}
    src, dst = _random_graph()
    outdeg = np.bincount(src, minlength=N).astype(np.float32)
    weights = _edge_weights(len(src))
    progs = _torch_programs()
    for name, (iters, _, _) in PROGRAMS.items():
        g = graph_from_numpy(N, src, dst, outdeg,
                             weights if name.endswith("_w") else None,
                             device="cpu")
        for conn in CONNECTORS:
            for mode in ("dense", "sparse"):
                ex = compile_pregel(progs[name], g, mesh=data8,
                                    force_connector=conn,
                                    semi_naive=mode == "sparse")
                out[f"data8/{name}/{conn}/{mode}"] = _port_pregel(
                    ex, mode == "sparse", iters)
    with _kernel_contract():
        for case in KERNEL_CASES:
            _, name, conn, mode = case.split("/")
            g = graph_from_numpy(N, src, dst, outdeg,
                                 weights if name.endswith("_w") else None,
                                 device="cpu")
            ex = compile_pregel(progs[name], g, mesh=data8,
                                force_connector=conn,
                                semi_naive=mode == "sparse")
            out[case] = _port_pregel(ex, mode == "sparse",
                                     PROGRAMS[name][0])
    g = graph_from_numpy(N, src, dst, outdeg, device="cpu")
    for conn in CONNECTORS:
        ex = compile_pregel(progs["pagerank"], g, mesh=mesh42,
                            force_connector=conn)
        out[f"data4model2/pagerank/{conn}/dense"] = _port_pregel(
            ex, False, 15)

    (msrc, mdst, mweights), _, _ = _monoid_inputs()
    for name, (prog, iters, weighted) in _torch_monoid_programs().items():
        g = Graph(N, torch.from_numpy(msrc), torch.from_numpy(mdst),
                  torch.zeros(N, dtype=torch.float64),
                  torch.from_numpy(mweights) if weighted else None)
        for conn in CONNECTORS:
            for mode in ("dense", "sparse"):
                ex = compile_pregel(prog, g, mesh=data8,
                                    force_connector=conn,
                                    semi_naive=mode == "sparse")
                out[f"data8/{name}/{conn}/{mode}"] = _port_pregel(
                    ex, mode == "sparse", iters)

    # IMRU: this rank's quarter of the records (shard pod * 2 + data).
    X, w_true, y, lr = _imru_data()
    per = IMRU_N // 4
    s = mesh222.linear_index(mesh222.batch_axes)
    rec = {"x": torch.from_numpy(X[s * per:(s + 1) * per]),
           "y": torch.from_numpy(y[s * per:(s + 1) * per])}

    def bgd(tol):
        return IMRUTask(
            init_model=lambda: torch.zeros(IMRU_D),
            map=lambda r, m: (r["x"] @ m - r["y"]) @ r["x"],
            update=lambda j, m, g: m - lr * g, tol=tol)

    for sched in SCHEDULES:
        ex = compile_imru(bgd(1e-7), rec, mesh=mesh222, force_reduce=sched)
        res = ex.run(max_iters=IMRU_ITERS)
        out[f"imru/{sched}"] = {"state": res.state.numpy(),
                                "iterations": res.iterations,
                                "notes": list(ex.plan.notes)}
    ex = compile_imru(bgd(0.0), rec, mesh=mesh222, codec="int8_ef",
                      force_reduce="flat")
    out["imru/int8_ef"] = {"state": ex.run(max_iters=EF_STEPS).state.numpy()}

    # The reference test's error-feedback loop on the (4, 2) mesh.
    d = mesh42.coordinate("data")
    xx = torch.from_numpy(X[d * per:(d + 1) * per])
    yy = torch.from_numpy(y[d * per:(d + 1) * per])
    w = torch.zeros(IMRU_D)
    st = init_ef_state((w,))
    with C.bind(mesh42):
        for _ in range(EF_STEPS):
            (g_sum,), st = ef_int8_allreduce(((xx @ w - yy) @ xx,), st,
                                             ("data",))
            w = w - lr * g_sum
    out["ef"] = w.numpy()

    # kary_tree_psum against psum over the 8 ranks.
    kary = {}
    with C.bind(data8):
        for k in (2, 3, 4):
            xi = torch.tensor([rank * 7 - 3, rank ** 3, 1 << 20],
                              dtype=torch.int32)
            xf = torch.tensor([rank * 0.1 + 1.0 / 3.0, -rank ** 0.5, 1e6],
                              dtype=torch.float32)
            kary[k] = (TP.kary_tree_psum(xi, "data", k).numpy(),
                       C.psum(xi, ("data",)).numpy(),
                       TP.kary_tree_psum(xf, "data", k).numpy(),
                       C.psum(xf, ("data",)).numpy())
    out["kary"] = kary

    # C1: every index the sharded connectors hand to torch, on a dense and
    # a sparse superstep over a pinned ~10% frontier, and bucket overflow.
    rng = np.random.default_rng(5)
    active = torch.zeros(N, dtype=torch.bool)
    active[rng.choice(N, N // 10, replace=False)] = True
    g = graph_from_numpy(N, src, dst, outdeg, weights, device="cpu")
    with _IndexAudit() as audit:
        for conn in CONNECTORS:
            ex = compile_pregel(progs["sssp_w"], g, mesh=data8,
                                force_connector=conn, semi_naive=True)
            carry = (ex.init()[0], ex.to_shard(active))
            ex.superstep(carry, 0)
            cap = ex.plan.sparse_cap_for(int(ex.shard_edge_counts(
                carry[1]).max()))
            ex.sparse_superstep(cap)(carry, 0)
        ids = torch.tensor([9, 1, 60, 2, 3, 0, 61], dtype=torch.int32)
        TP._bucket_by_owner(ids, torch.ones(7), N, 8, 1, True,
                            edge_active=torch.tensor(
                                [True, True, True, True, False, True,
                                 False]))
    out["audit"] = {"checked": audit.checked, "bad": audit.bad}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# The fixture: both sides at once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("spmd")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
         f"import test_torch_spmd as t; "
         f"t._jax_main({str(out_dir)!r}, {part!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("f32", "f64")]
    try:
        ranks = launch_ranks(_rank_main, 8, store_dir=str(out_dir),
                             timeout=LAUNCH_TIMEOUT)
        errs = [p.communicate(timeout=LAUNCH_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    arrays, meta = {}, {}
    for p, err, part in zip(procs, errs, ("f32", "f64")):
        assert p.returncode == 0, err[-4000:]
        with np.load(out_dir / f"jax_{part}.npz") as f:
            arrays.update({k.replace("|", "/"): f[k] for k in f.files})
        meta.update(json.loads((out_dir / f"jax_{part}.json").read_text()))
    print(f"spmd: both sides in {time.perf_counter() - t0:.1f}s, the ranks' "
          f"own {ranks[0]['seconds']:.1f}s")
    return ranks, arrays, meta


def _close(got, want, exact):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= REL_TOL * scale


@pytest.mark.parametrize("case", PREGEL_CASES + KERNEL_CASES)
def test_sharded_pregel_matches_jax(runs, case):
    ranks, arrays, meta = runs
    got = ranks[0][case]
    case = case.replace("kernel/", "data8/")
    want = meta[case]
    combine = MONOIDS.get(case.split("/")[1]) \
        or PROGRAMS[case.split("/")[1]][2]
    _close(got["state"], arrays[case], combine in EXACT)
    assert got["iterations"] == want["iterations"]
    assert got["converged"] == want["converged"]
    assert got["modes"] == want["modes"]
    if case.endswith("/sparse") and combine in ("min", "argmin"):
        assert any(m.startswith("sparse@") for m in got["modes"])


@pytest.mark.parametrize("case", PREGEL_CASES + [f"imru/{s}"
                                                 for s in SCHEDULES])
def test_plan_notes_match_jax(runs, case):
    ranks, _, meta = runs
    assert ranks[0][case]["notes"] == meta[case]["notes"]


def test_ranks_agree(runs):
    ranks, _, _ = runs
    for r in ranks[1:]:
        for case in PREGEL_CASES + [f"imru/{s}" for s in SCHEDULES]:
            np.testing.assert_array_equal(r[case]["state"],
                                          ranks[0][case]["state"])
            assert r[case].get("modes") == ranks[0][case].get("modes")


@pytest.mark.parametrize("sched", SCHEDULES)
def test_imru_schedules_match_jax(runs, sched):
    ranks, arrays, meta = runs
    got = ranks[0][f"imru/{sched}"]
    _close(got["state"], arrays[f"imru/{sched}"], False)
    assert got["iterations"] == meta[f"imru/{sched}"]["iterations"]


def test_int8_error_feedback_matches_jax(runs):
    ranks, arrays, _ = runs
    _, w_true, _, _ = _imru_data()
    assert float(np.abs(ranks[0]["ef"] - w_true).max()) < 5e-2
    _close(ranks[0]["ef"], arrays["ef"], False)


def test_imru_int8_ef_codec_matches_the_error_feedback_loop(runs):
    ranks, arrays, _ = runs
    _close(ranks[0]["imru/int8_ef"]["state"], arrays["ef"], False)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_kary_tree_psum_equals_psum(runs, k):
    ranks, _, _ = runs
    for r in ranks:
        ti, pi, tf, pf = r["kary"][k]
        np.testing.assert_array_equal(ti, pi)
        assert np.abs(tf - pf).max() <= 1e-6 * np.abs(pf).max()


def test_sharded_connector_indices_stay_in_range(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["audit"]["checked"] >= 30
        assert r["audit"]["bad"] == []


# ---------------------------------------------------------------------------
# C5, in process
# ---------------------------------------------------------------------------


def _overflowing_buckets():
    """Owner 0 (vertices 0-7 of 64 over 8 shards) gets 5 rows at cap 3;
    owner 7 gets 2; one row is masked off."""

    ids = np.array([1, 60, 3, 0, 5, 61, 7, 2], np.int32)
    vals = np.arange(1, 9, dtype=np.float32)
    act = np.array([True, True, True, True, True, True, True, False])
    return ids, vals, act


def test_bucket_by_owner_keeps_the_first_cap_rows():
    ids, vals, act = _overflowing_buckets()
    ids_b, vals_b = TP._bucket_by_owner(
        torch.from_numpy(ids), torch.from_numpy(vals), N, 8, 3, True,
        edge_active=torch.from_numpy(act))
    # Owner 0's rows sorted by destination: 0, 1, 3, 5, 7 -> keeps 0, 1, 3.
    assert ids_b[0].tolist() == [0, 1, 3]
    assert vals_b[0].tolist() == [4.0, 1.0, 3.0]
    assert ids_b[7].tolist() == [60, 61, -1]
    assert vals_b[7].tolist() == [2.0, 6.0, 0.0]
    assert (ids_b[1:7] == -1).all() and (vals_b[1:7] == 0).all()


def test_reference_bucket_by_owner_clobbers_slot_cap_minus_1():
    import jax.numpy as jnp

    from repro.core.physical import _bucket_by_owner

    ids, vals, act = _overflowing_buckets()
    ids_b, vals_b = _bucket_by_owner(
        jnp.asarray(ids), jnp.asarray(vals), N, 8, 3, True,
        edge_active=jnp.asarray(act))
    # The overflow rows (destinations 5 and 7) are clamped into slot 2 and
    # write -1 / 0 over the kept destination 3.
    assert np.asarray(ids_b[0]).tolist()[:2] == [0, 1]
    assert np.asarray(ids_b[0])[2] == -1 and np.asarray(vals_b[0])[2] == 0
