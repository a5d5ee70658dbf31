"""Fault tolerance on a mesh on the card: 2 ranks on one GPU over staged
``gloo``, a crash and a remesh.

These tests need the card and skip without one; they import nothing of
JAX, so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_spmd_ft_cuda.py

Two ranks (``launch_ranks``, a FileStore under ``tmp_path``) put their
shards on ``cuda:0``.  PageRank on 4096 vertices with a checkpoint every 4
supersteps: a crash on rank 1 only restarts both ranks once and lands on
the uninterrupted run's bits; a run crashed past its restarts is remeshed
onto rank 1 alone (``make_data_mesh(1, ranks=[1])``; rank 0, the writer,
leaves) and resumed from disk, within 1e-6 relative of the uninterrupted
run (one rank sums in another order).  The whole program runs twice and
gives the same bits, and every rank launches the segment-combine kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

N = 4096
STEPS = 20


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _program():
    from repro_torch.core.pregel import VertexProgram

    return VertexProgram(
        init_vertex=lambda ids, vd: torch.stack(
            [torch.full((N,), 1.0 / N, device=ids.device), vd], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / N + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool, device=s.device)),
        combine="sum")


def _rank(rank, world, root):
    import os

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.pregel import compile_pregel
    from repro_torch.ft import FailureInjector
    from repro_torch.kernels.segment_combine import kernel as sc_kernel
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(device="cuda", backend="gloo")
    alone = make_data_mesh(1, ranks=[1], device="cuda", backend="gloo")
    rng = np.random.default_rng(5)
    src = rng.integers(0, N, 6 * N)
    dst = rng.integers(0, N, 6 * N)
    g = graph_from_numpy(N, src, dst,
                         np.bincount(src, minlength=N).astype(np.float32),
                         device="cpu")
    ex = compile_pregel(_program(), g, mesh=mesh)
    sc_kernel.reset_launch_count()
    clean = ex.run(max_iters=STEPS).state[0].cpu().numpy()
    launches = sc_kernel.launch_count
    res = ex.run(max_iters=STEPS, checkpoint_dir=os.path.join(root, "crash"),
                 checkpoint_every=4,
                 injector=FailureInjector(crashes=[6] if rank == 1 else []))
    out = {"clean": clean, "launches": launches, "restarts": res.restarts,
           "crash": res.state[0].cpu().numpy()}
    try:
        ex.run(max_iters=STEPS, checkpoint_dir=os.path.join(root, "out"),
               checkpoint_every=4, injector=FailureInjector(crashes=[9, 10]),
               max_restarts=1)
        out["raised"] = False
    except RuntimeError:
        out["raised"] = True
    if alone is not None:
        one = ex.remesh(alone)
        res = one.run(max_iters=STEPS,
                      checkpoint_dir=os.path.join(root, "out"), resume=True)
        out["remesh"] = res.state[0].cpu().numpy()
        out["events"] = list(res.remesh_events)
        out["iterations"] = res.iterations
    return out


def _launch(tmp_path):
    tmp_path.mkdir()
    return launch_ranks(_rank, 2, str(tmp_path), store_dir=str(tmp_path),
                        backend="gloo", timeout=600)


def test_crash_and_remesh_on_the_card(tmp_path):
    _card()
    a = _launch(tmp_path / "a")
    b = _launch(tmp_path / "b")
    for runs in (a, b):
        for r in runs:
            assert r["launches"] > 0
            assert r["restarts"] == 1 and r["raised"]
            np.testing.assert_array_equal(r["crash"], r["clean"])
        assert "remesh" not in runs[0]
        got, want = runs[1]["remesh"], runs[1]["clean"]
        assert runs[1]["events"] == ["remesh(2->1: data=1)"]
        assert runs[1]["iterations"] == STEPS - 8
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-6 * scale
    for x, y in zip(a, b):
        for key in ("clean", "crash") + (("remesh",) if "remesh" in x
                                         else ()):
            np.testing.assert_array_equal(x[key], y[key])
