"""The generic engine's row exchanges on the card: 8 ranks on one GPU over
staged ``gloo``.

These tests need the card and skip without one; they import nothing of
JAX, so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_spmd_generic_cuda.py

The PageRank -> threshold -> reach pipeline at n = 256 on forced row
tables, under ``bucket-a2a`` and under ``psum-scatter``, on 8 ranks that
put their slabs on ``cuda:0`` (``backend="gloo"``: NCCL refuses two ranks
on one GPU), then on 8 ranks on the CPU.  On the card every rank runs it
twice with the same bits, launches the segment-combine kernel, stages
bytes through the host and keeps its row tables; ``hot`` and ``reach`` and
the ranked vertices equal the CPU run's rank 0, the ranks within 1e-6
relative (the kernel adds in another order than the CPU's scatter).
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

PN = 256
ITERS = 60
MODES = ("bucket-a2a", "psum-scatter")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")


def _relations():
    from repro_torch.core.executor import Relation

    rng = np.random.default_rng(7)
    src = np.repeat(np.arange(PN), 3)
    dst = rng.integers(0, PN, 3 * PN)
    deg = np.bincount(src, minlength=PN).astype(np.float32)
    return {"edge": Relation.from_columns(PN, src, dst, device="cpu"),
            "node": Relation.from_columns(
                PN, np.arange(PN), np.full(PN, 1.0 / PN, np.float32), deg,
                np.full(PN, 0.15 / PN, np.float32), device="cpu")}


def _answers(res):
    return {p: (res.state[p].tuples(),
                {k: v.cpu().numpy() for k, v in res.state[p].values.items()})
            for p in ("rank", "hot", "reach")}


def _rank(rank, world, device):
    from repro_torch.core.executor import compile_program
    from repro_torch.core.listings import pagerank_threshold_program
    from repro_torch.kernels.segment_combine import kernel as sc_kernel
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(device=device, backend="gloo")
    out = {"staged": 0}
    for mode in MODES:
        ex = compile_program(pagerank_threshold_program(tau=1.5 / PN),
                             _relations(), mesh=mesh, storage="row-table",
                             exchange=mode)
        sc_kernel.reset_launch_count()
        mesh.stats.reset()
        first = ex.run(max_iters=ITERS)
        launches = sc_kernel.launch_count
        out["staged"] += mesh.stats.staged_bytes
        again = ex.run(max_iters=ITERS)
        out[mode] = {"first": _answers(first), "again": _answers(again),
                     "launches": launches,
                     "fallback": first.storage_fallback
                     or again.storage_fallback}
    return out


def _same(a, b):
    for p, (rows, vals) in a.items():
        np.testing.assert_array_equal(b[p][0], rows)
        for k, v in vals.items():
            np.testing.assert_array_equal(b[p][1][k], v)


def test_pipeline_exchanges_on_the_card(tmp_path):
    _card()
    (tmp_path / "gpu").mkdir()
    (tmp_path / "cpu").mkdir()
    gpu = launch_ranks(_rank, 8, "cuda", store_dir=str(tmp_path / "gpu"),
                       timeout=600)
    cpu = launch_ranks(_rank, 8, "cpu", store_dir=str(tmp_path / "cpu"),
                       timeout=600)
    for mode in MODES:
        want = cpu[0][mode]["first"]
        for r in gpu:
            got = r[mode]
            _same(got["first"], got["again"])
            assert got["launches"] > 0 and not got["fallback"]
            for p in ("hot", "reach"):
                np.testing.assert_array_equal(got["first"][p][0],
                                              want[p][0])
            np.testing.assert_array_equal(got["first"]["rank"][0],
                                          want["rank"][0])
            a, b = got["first"]["rank"][1][1], want["rank"][1][1]
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    for r in gpu:
        assert r["staged"] > 0
