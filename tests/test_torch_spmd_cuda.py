"""Sharded Pregel on the card: 8 ranks on one GPU over staged ``gloo``.

These tests need the card and skip without one; they import nothing of
JAX, so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_spmd_cuda.py

Eight ranks (``launch_ranks``, a FileStore under ``tmp_path``) put their
shards on ``cuda:0`` and exchange through pinned host buffers
(``backend="gloo"``: NCCL refuses two ranks on one GPU).  PageRank and SSSP
at the CPU test's size (64 vertices) over the three connectors, dense and
semi-naive, must equal the port's single-device run on the card: SSSP
exactly, PageRank within 1e-6 relative (sums in another order), in as
many iterations, SSSP's semi-naive runs with a sparse superstep; every
rank launches the segment-combine kernel and stages bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

N = 64
CONNECTORS = ("dense_psum", "merging", "hash_sort")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _graph():
    rng = np.random.default_rng(1)
    src, dst = [], []
    for v in range(N):
        for _ in range(rng.integers(1, 5)):
            src.append(v)
            dst.append(int(rng.integers(0, N)))
    for v in range(N):
        src.append(int(rng.integers(0, N)))
        dst.append(v)
    src, dst = np.array(src, np.int32), np.array(dst, np.int32)
    return src, dst, np.bincount(src, minlength=N).astype(np.float32)


def _programs():
    from repro_torch.core.pregel import VertexProgram

    return {
        "pagerank": (VertexProgram(
            init_vertex=lambda ids, vd: torch.stack(
                [torch.full((N,), 1.0 / N, device=ids.device), vd], dim=1),
            message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
            apply=lambda j, s, inbox, got: (
                torch.stack([0.15 / N + 0.85 * inbox, s[:, 1]], dim=1),
                torch.ones(s.shape[0], dtype=torch.bool, device=s.device)),
            combine="sum"), 15),
        "sssp": (VertexProgram(
            init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, 1e9),
            message=lambda j, s, ed: s + 1.0,
            apply=lambda j, s, inbox, got: (
                torch.minimum(s, inbox), torch.minimum(s, inbox) < s),
            combine="min"), 100),
    }


def _run(ex, mode, iters):
    if mode == "sparse":
        ex.plan = dataclasses.replace(ex.plan, density_threshold=0.6,
                                      sparse_cap_floor=16)
    res = ex.run(max_iters=iters)
    return res.state[0].cpu().numpy(), res.iterations, list(res.modes)


def _cases():
    return [(p, c, m) for p in ("pagerank", "sssp") for c in CONNECTORS
            for m in ("dense", "sparse")]


def _rank(rank, world):
    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.pregel import compile_pregel
    from repro_torch.kernels.segment_combine import kernel as sc_kernel
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(device="cuda", backend="gloo")
    src, dst, outdeg = _graph()
    g = graph_from_numpy(N, src, dst, outdeg, device="cpu")
    out = {}
    sc_kernel.reset_launch_count()
    for name, conn, mode in _cases():
        prog, iters = _programs()[name]
        ex = compile_pregel(prog, g, mesh=mesh, force_connector=conn,
                            semi_naive=mode == "sparse")
        out[(name, conn, mode)] = _run(ex, mode, iters)
    out["launches"] = sc_kernel.launch_count
    out["staged"] = mesh.stats.staged_bytes
    out["transport"] = mesh.transport
    return out


def test_eight_ranks_on_one_card_equal_the_single_device_run(tmp_path):
    device = _card()
    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.pregel import compile_pregel

    ranks = launch_ranks(_rank, 8, store_dir=str(tmp_path), timeout=600)
    src, dst, outdeg = _graph()
    g = graph_from_numpy(N, src, dst, outdeg, device=device)
    for name, conn, mode in _cases():
        prog, iters = _programs()[name]
        want = _run(compile_pregel(prog, g, force_connector=conn,
                                   semi_naive=mode == "sparse",
                                   device=device), mode, iters)
        for r in ranks:
            got = r[(name, conn, mode)]
            # Iterations equal; the modes' capacities differ (a shard's
            # count against the whole graph's), not the answers.
            assert got[1] == want[1], (name, conn, mode)
            if mode == "sparse" and name == "sssp":
                assert any(m.startswith("sparse@") for m in got[2])
            if name == "sssp":
                np.testing.assert_array_equal(got[0], want[0])
            else:
                assert np.abs(got[0] - want[0]).max() <= \
                    1e-6 * np.abs(want[0]).max()
    for r in ranks:
        assert r["launches"] > 0 and r["staged"] > 0
        assert r["transport"] == "gloo, staged through pinned host buffers"
