"""Out-of-core chunk streaming and fault tolerance on the card.

These tests need the card and skip without one; they import nothing of JAX,
so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_outofcore_cuda.py

* A chunked EDB's host chunks lie in pinned memory, and a ``RowRelation``
  left on the CPU is taken for a chunked EDB (its rows stream) and refused
  for any other.
* The forced-row PageRank -> threshold -> reach pipeline on 2^20 edges
  streamed in 4 and 7 chunks (copies of the next chunk overlapping the
  firing on the current one) equals the unchunked run on the card: sets
  exactly, ranks within 1e-6 relative L1 (the chunk folds add in another
  order), with the threshold in the widest gap of the ranks; two chunked
  runs are bit-identical (no float atomics on the path: every fold is the
  segment-combine kernel), and so is a run with a crash in the middle of a
  chunk stream, restored from its checkpoint.
* A Pregel PageRank with two crashes restored from checkpoints, and one
  resumed from disk, is bit-equal to the uninterrupted run; a checkpoint
  written from the card restores on the CPU and on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.carry import graph_from_numpy
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.core import executor as TE
from repro_torch.core import listings as TL
from repro_torch.core.pregel import VertexProgram, compile_pregel
from repro_torch.ft import FailureInjector
from repro_torch.kernels.segment_combine import kernel as sc_kernel

CPU = torch.device("cpu")
N, DEGREE, ITERS = 1 << 14, 64, 12


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _pipeline_inputs():
    """Distinct out-edges a vertex (a + k·b mod n, b odd), a float64
    PageRank of ITERS iterations and a threshold in its widest gap."""

    rng = np.random.default_rng(5)
    a = rng.integers(0, N, N)
    b = 2 * rng.integers(0, N // 2, N) + 1
    src = np.repeat(np.arange(N), DEGREE)
    dst = (np.repeat(a, DEGREE) + np.tile(np.arange(DEGREE), N)
           * np.repeat(b, DEGREE)) % N
    deg = np.bincount(src, minlength=N).astype(np.float64)
    r = np.full(N, 1.0 / N)
    for _ in range(ITERS):
        r = 0.85 * np.bincount(dst, (r / deg)[src], minlength=N) + 0.15 / N
    srt = np.sort(r)
    gi = int(np.argmax(np.diff(srt)[N // 2:])) + N // 2
    return src, dst, deg.astype(np.float32), float((srt[gi] + srt[gi + 1]) / 2)


def _pipeline(dev, edge_device=None, **kw):
    src, dst, deg, tau = _pipeline_inputs()
    rels = {
        "edge": TE.RowRelation.from_columns(N, src, dst,
                                            device=edge_device or dev),
        "node": TE.Relation.from_columns(
            N, np.arange(N), np.full(N, 1.0 / N, np.float32), deg,
            np.full(N, 0.15 / N, np.float32), device=dev),
    }
    return TE.compile_program(TL.pagerank_threshold_program(tau=tau), rels,
                              storage="row-table", device=dev, **kw)


def _ranks(res):
    return res.state["rank"].values[1]


def test_host_chunks_are_pinned_and_a_cpu_edb_streams():
    dev = _card()
    ex = _pipeline(dev, chunks={"edge": 4})
    for chunk in ex.chunked_edb["edge"]:
        assert chunk["ids"].is_pinned() and chunk["valid"].is_pinned()
    host = _pipeline(dev, edge_device=CPU, chunks={"edge": 4})
    want = ex.run(max_iters=ITERS)
    got = host.run(max_iters=ITERS)
    assert torch.equal(_ranks(got), _ranks(want))
    with pytest.raises(ValueError, match="lies on cpu"):
        _pipeline(dev, edge_device=CPU)


@pytest.mark.parametrize("m", (4, 7))
def test_chunked_pipeline_on_the_card_equals_unchunked(m):
    dev = _card()
    base = _pipeline(dev).run(max_iters=ITERS)
    sc_kernel.reset_launch_count()
    got = _pipeline(dev, chunks={"edge": m}).run(max_iters=ITERS)
    # the per-chunk GroupBy and the fold into the accumulator, each chunk
    assert sc_kernel.launch_count >= 2 * m * ITERS
    assert got.phase_iterations == base.phase_iterations
    assert not got.storage_fallback
    for p in ("rank", "hot", "reach"):
        np.testing.assert_array_equal(got.state[p].tuples(),
                                      base.state[p].tuples())
    a, b = _ranks(got).double(), _ranks(base).double()
    assert float((a - b).abs().sum() / b.abs().sum()) <= 1e-6


def test_two_chunked_runs_and_a_crashed_one_are_bit_identical(tmp_path):
    dev = _card()
    first = _pipeline(dev, chunks={"edge": 4}).run(max_iters=ITERS)
    second = _pipeline(dev, chunks={"edge": 4}).run(max_iters=ITERS)
    inj = FailureInjector(chunk_crashes=((3, 2),))
    crashed = _pipeline(dev, chunks={"edge": 4}).run(
        max_iters=ITERS, checkpoint_dir=str(tmp_path), checkpoint_every=2,
        injector=inj)
    assert crashed.restarts == 1
    assert [e.detail for e in inj.fired] == ["chunk 2"]
    for res in (second, crashed):
        assert res.phase_iterations == first.phase_iterations
        for p in ("rank", "hot", "reach"):
            assert torch.equal(res.state[p].rows, first.state[p].rows)
        assert torch.equal(_ranks(res), _ranks(first))


def _pregel_pagerank(dev):
    rng = np.random.default_rng(2)
    n = 1 << 16
    src = rng.integers(0, n, 8 * n).astype(np.int32)
    dst = rng.integers(0, n, 8 * n).astype(np.int32)
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    g = graph_from_numpy(n, src, dst, outdeg, device=dev)
    vp = VertexProgram(
        init_vertex=lambda ids, vd: torch.stack(
            [torch.full((n,), 1.0 / n, device=ids.device), vd], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / n + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool, device=s.device)),
        combine="sum",
    )
    return compile_pregel(vp, g, device=dev)


def test_pregel_crash_restore_and_resume_are_bit_equal(tmp_path):
    dev = _card()
    ex = _pregel_pagerank(dev)
    clean = ex.run(max_iters=20)
    host = ex.run(max_iters=20, on_device=False)
    assert torch.equal(host.state[0], clean.state[0])
    d = str(tmp_path / "a")
    res = ex.run(max_iters=20, checkpoint_dir=d, checkpoint_every=4,
                 injector=FailureInjector(crashes=(6, 13)))
    assert res.restarts == 2
    assert res.state[0].is_cuda
    assert torch.equal(res.state[0], clean.state[0])
    d = str(tmp_path / "b")
    stopped = ex.run(max_iters=10, checkpoint_dir=d, checkpoint_every=4)
    assert stopped.iterations == 10
    resumed = ex.run(max_iters=20, checkpoint_dir=d, resume=True)
    assert resumed.iterations == 10
    assert torch.equal(resumed.state[0], clean.state[0])


def test_card_checkpoint_restores_on_the_cpu_and_the_card(tmp_path):
    dev = _card()
    tree = {"x": torch.randn(1000, device=dev).to(torch.bfloat16),
            "m": torch.rand(7, device=dev) < 0.5}
    save_pytree(str(tmp_path), 1, tree)
    on_cpu, _, _ = restore_pytree(str(tmp_path),
                                  like={k: v.cpu() for k, v in tree.items()})
    on_card, _, _ = restore_pytree(str(tmp_path), like=tree)
    for k in tree:
        assert on_cpu[k].device == CPU and on_card[k].is_cuda
        assert torch.equal(on_cpu[k], tree[k].cpu())
        assert torch.equal(on_card[k], tree[k])
