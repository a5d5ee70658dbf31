"""Serving on a mesh on the card: 4 ranks on one GPU over staged ``gloo``.

These tests need the card and skip without one; they import nothing of
JAX, so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_spmd_serving_cuda.py

Four ranks (``launch_ranks``, a FileStore under ``tmp_path``) serve from
one ``FixpointServer(mesh=)`` each, their blocks on ``cuda:0``:
personalized PageRank from 4 seed sets on 256 vertices (16 out-edges a
vertex), batched within 1e-8 of the one-by-one answers, with every rank's
answers bit-equal; and the 4-vertex segment-scan programs (sum, and max
and min), 16 queries batched, where the segment-combine kernel launches
once a GroupBy firing for the batch and, on the inputs of the last
firing, agrees with its plain version (max/min bit-equal, the sum within
``kernel.sum_depth``'s bar).
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

N = 256
DEGREE = 16
SEED_SETS = ([0], [5, 9], [17, 100, 200], [3, 40, 41, 255])
ITERS = 20
SCAN_N, SCAN_K = 4, 16
SPREAD = (
    "M1: hi(0, X, L)        :- lab(X, L).\n"
    "M2: hi(J+1, X, max<L>) :- hi(J, Y, L), edge(Y, X).\n"
    "M3: hi(J+1, X, L)      :- hi(J, X, L).\n"
    "M4: lo(0, X, L)        :- lab(X, L).\n"
    "M5: lo(J+1, X, min<L>) :- lo(J, Y, L), edge(Y, X).\n"
    "M6: lo(J+1, X, L)      :- lo(J, X, L).\n")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _graph(n, src, dst):
    from repro_torch.core.executor import Relation

    deg = np.bincount(src, minlength=n).astype(np.float32)
    return {"edge": Relation.from_columns(n, src, dst, device="cpu"),
            "deg": Relation.from_columns(n, np.arange(n), deg, device="cpu")}


def _seed(n, vs):
    from repro_torch.core.executor import Relation

    vs = np.asarray(vs)
    return {"seed": Relation.from_columns(
        n, vs, np.full(len(vs), 1.0 / len(vs), np.float32), device="cpu")}


def _values(ans, pred):
    rel = ans[pred]
    return torch.where(rel.present, rel.values[1], 0.0).cpu().numpy()


def _rank(rank, world):
    from repro_torch.core import physical
    from repro_torch.core.executor import Relation
    from repro_torch.core.monoid import get_monoid
    from repro_torch.core.parser import parse
    from repro_torch.core.serving import (
        FixpointServer,
        personalized_pagerank_program,
    )
    from repro_torch.kernels.segment_combine import kernel as sc_kernel
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_reference,
    )
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(device="cuda", backend="gloo")
    rng = np.random.default_rng(4)
    a = rng.integers(0, N, N)
    b = 2 * rng.integers(0, N // 2, N) + 1
    src = np.repeat(np.arange(N), DEGREE)
    dst = (np.repeat(a, DEGREE) + np.tile(np.arange(DEGREE), N)
           * np.repeat(b, DEGREE)) % N
    ppr = personalized_pagerank_program()
    server = FixpointServer(_graph(N, src, dst), mesh=mesh)
    batch = [_seed(N, vs) for vs in SEED_SETS]
    bat = server.query(ppr, batch, max_iters=ITERS, force="batched")
    seq = server.query(ppr, batch, max_iters=ITERS, force="sequential")
    out = {"ppr": (np.stack([_values(x, "rank") for x in bat.answers]),
                   np.stack([_values(x, "rank") for x in seq.answers])),
           "device": str(bat.answers[0]["rank"].present.device)}

    scan = FixpointServer(_graph(SCAN_N, np.array([0, 0, 1, 2, 2, 3]),
                                 np.array([1, 2, 2, 0, 3, 1])), mesh=mesh)
    spread = parse(SPREAD, aggregates={
        op: get_monoid(op).as_aggregate() for op in ("max", "min")})
    seeds = [_seed(SCAN_N, np.sort(rng.choice(SCAN_N, 1 + q % 2,
                                              replace=False)))
             for q in range(SCAN_K)]
    labs = [{"lab": Relation.from_columns(
        SCAN_N, np.arange(SCAN_N), rng.normal(size=SCAN_N).astype(np.float32),
        device="cpu")} for _ in range(SCAN_K)]
    real = physical._sorted_combine
    for tag, prog, params in (("sum", ppr, seeds), ("max/min", spread, labs)):
        calls = []

        def record(*args):
            if any(isinstance(x, torch.Tensor)
                   and torch._C._functorch.is_batchedtensor(x)
                   for x in args):
                return real(*args)
            before = sc_kernel.launch_count
            res = real(*args)
            calls.append((sc_kernel.launch_count - before, args))
            return res

        physical._sorted_combine = record
        try:
            res = scan.query(prog, params, max_iters=ITERS, force="batched")
        finally:
            physical._sorted_combine = real
        vals, ids, n, op, act = calls[-1][1]
        ker = real(vals, ids, n, op, act)
        ref = segment_combine_reference(vals, ids, n, op, edge_active=act)
        depth = float(sc_kernel.summation_depths(ids, n,
                                                 vals.shape[1]).max())
        bar = depth * 2.0 ** -24 * float(
            segment_combine_reference(vals.abs(), ids, n, "sum",
                                      edge_active=act).abs().max())
        out[tag] = {"launches": [c[0] for c in calls],
                    "iterations": res.iterations,
                    "width": int(vals.shape[1]),
                    "err": float((ker - ref).abs().max()), "bar": bar}
    return out


def test_batched_serving_on_the_card_mesh(tmp_path):
    _card()
    ranks = launch_ranks(_rank, 4, store_dir=str(tmp_path), timeout=600)
    for r in ranks:
        assert r["device"].startswith("cuda")
        bat, seq = r["ppr"]
        assert np.abs(bat - seq).max() <= 1e-8
        assert np.array_equal(bat, ranks[0]["ppr"][0])
        for tag in ("sum", "max/min"):
            got = r[tag]
            # One launch a GroupBy firing, for the 16 queries at once.
            assert got["launches"] == [1] * got["iterations"]
            assert got["width"] == SCAN_K
            if tag == "sum":
                assert got["err"] <= got["bar"]
            else:
                assert got["err"] == 0.0
