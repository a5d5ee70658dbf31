"""Row-table storage on the card: the row primitives and the segmented row
GroupBy, which reaches the segment-combine kernel.

These tests need the card and skip without one; they import nothing of JAX,
so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_rowtable_cuda.py

The primitives on CUDA tensors must equal the same calls on CPU tensors,
exactly, including the inputs whose indices reach a sentinel (probes past
the sorted prefix, pair slots past the count, invalid rows' scatters,
empty compaction slots), which device-assert if an index leaves its range.
A row GroupBy past 2^20 grid cells must launch the kernel once, equal the
CPU's plain combine exactly (integer-valued payloads, so sums are exact in
any order), and two runs must be bit-identical; a forced-row PageRank
pipeline on the card launches the kernel at least twice an iteration
(the segmented GroupBy and the row merge) and equals the same run on the
CPU: sets exactly, ranks within 1e-5 relative (sums in another order,
compounded over the iterations), with the threshold in the widest gap of
the ranks.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import algebra as TA
from repro_torch.core import executor as TE
from repro_torch.core import listings as TL
from repro_torch.core import physical as TP
from repro_torch.kernels.segment_combine import kernel as sc_kernel

CPU = torch.device("cpu")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _same(cpu_out, cuda_out):
    for a, b in zip(cpu_out, cuda_out):
        assert torch.equal(a, b.cpu()), (a, b)


def _codes(gen, cap, hi):
    return torch.randint(0, hi, (cap,), generator=gen, dtype=torch.int64)


def test_row_primitives_on_the_card_equal_the_cpu():
    dev = _card()
    gen = torch.Generator().manual_seed(0)
    for cap_l, cap_r, out_cap, hi in ((64, 48, 16, 40), (64, 48, 4096, 40),
                                      (1, 5, 8, 2**32), (300, 1, 64, 9)):
        lc, rc = _codes(gen, cap_l, hi), _codes(gen, cap_r, hi)
        lv = torch.rand(cap_l, generator=gen) < 0.8
        rv = torch.rand(cap_r, generator=gen) < 0.8
        lc[0] = hi + 5  # a probe past every right code
        for fn, args in (
                (TP.sort_row_codes, (lc, lv)),
                (TP.join_row_codes, (lc, lv, rc, rv, out_cap)),
                (TP.difference_row_codes, (lc, lv, rc, rv)),
                (TP.difference_row_codes, (lc, lv, rc, rv & False))):
            want = fn(*args)
            got = fn(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                       for a in args))
            _same(want if isinstance(want, tuple) else (want,),
                  got if isinstance(got, tuple) else (got,))
        perm, skey, nv = TP.sort_row_codes(lc.to(dev), lv.to(dev))
        _same(TP.unique_row_runs(*TP.sort_row_codes(lc, lv)[1:]),
              TP.unique_row_runs(skey, nv))
    for shape, cap in (((7,), 4), ((33, 20), 1024), ((9, 9), 8), ((), 3)):
        present = torch.rand(shape, generator=gen) < 0.3
        want = TP.grid_to_rows(present, cap)
        got = TP.grid_to_rows(present.to(dev), cap)
        _same(want, got)
        n = max(shape) if shape else 4
        _same((TP.rows_to_grid(want[0], want[1], n),),
              (TP.rows_to_grid(got[0], got[1], n),))


def test_row_operators_with_sentinels_on_the_card():
    dev = _card()
    n = 8

    def ctx(device):
        return TE._Ctx(program=None, n=n, device=device, sigs={},
                       relations={}, state={}, views={}, materialized={},
                       connectors={}, j=0, row_cap=16)

    def rows(device, dims, ids, valid, cols=None):
        return TE._Rows(dims, torch.tensor(ids, dtype=torch.int32,
                                           device=device),
                        torch.tensor(valid, device=device),
                        {c: torch.tensor(v, device=device)
                         for c, v in (cols or {}).items()})

    def run(device):
        c = ctx(device)
        left = rows(device, ("X",), [[1], [2], [3]], [True, True, False],
                    {"W": [5.0, 6.0, 5.0]})
        right = rows(device, ("W",), [[5], [7]], [True, False])
        anti = TE._antijoin_rows(left, right, ("W",), c)
        grid = TE._rows_to_inter(
            rows(device, ("X", "Y"), [[7, 7], [1, 2], [0, 0]],
                 [False, True, False], {"V": [1.0, 2.0, 3.0]}), c)
        joined = TE._join_rows(
            rows(device, ("X", "Y"), [[1, 2], [3, 4], [5, 6]],
                 [True, False, True]),
            rows(device, ("Y", "Z"), [[2, 0], [2, 1], [6, 6]],
                 [True, True, False]), ("Y",), c)
        return (anti.valid, grid.present, grid.cols["V"], joined.ids,
                joined.valid, *c.overflow)

    _same(run(CPU), run(dev))


def _big_child(device, agg_vals, seed=0):
    """A (X, Y) slab over n = 2048 (2^22 grid cells, past the dense
    lowering) with padding strewn among the valid rows."""

    n, cap = 2048, 1 << 14
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n, (cap, 2), generator=gen, dtype=torch.int32)
    ids[:, 0] = torch.randint(0, 64, (cap,), generator=gen,
                              dtype=torch.int32)
    ids = torch.unique(ids, dim=0)
    cap = ids.shape[0]
    ids = ids[torch.randperm(cap, generator=gen)]
    valid = torch.rand(cap, generator=gen) < 0.9
    vals = agg_vals(gen, cap)
    return n, TE._Rows(("X", "Y"), ids.to(device), valid.to(device),
                       {"V": vals.to(device)})


@pytest.mark.parametrize("agg", ["sum", "min", "max"])
def test_segmented_row_groupby_launches_the_kernel(agg):
    dev = _card()

    def ints(g, c):
        return torch.randint(-1000, 1000, (c,), generator=g).float()

    n, child = _big_child(dev, ints)
    _, plain = _big_child(CPU, ints)
    op = TA.GroupBy(None, ("X",), agg, "V", "acc")

    def ctx(device):
        return TE._Ctx(program=None, n=n, device=device, sigs={},
                       relations={}, state={}, views={}, materialized={},
                       connectors={}, j=0, row_cap=1 << 16)

    sc_kernel.reset_launch_count()
    got = TE._groupby_rows(op, child, ctx(dev))
    assert sc_kernel.launch_count == 1
    again = TE._groupby_rows(op, child, ctx(dev))
    want = TE._groupby_rows(op, plain, ctx(CPU))
    assert torch.equal(got.ids, again.ids)
    assert torch.equal(got.valid, again.valid)
    assert torch.equal(got.cols["acc"], again.cols["acc"])
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.valid.cpu(), want.valid)
    valid = want.valid
    assert torch.equal(got.cols["acc"].cpu()[valid], want.cols["acc"][valid])


def test_forced_row_pagerank_pipeline_on_the_card_equals_the_cpu():
    dev = _card()
    n, iters = 2048, 20
    rng = np.random.default_rng(7)
    src = np.repeat(np.arange(n), 4)
    dst = rng.integers(0, n, 4 * n)
    deg = np.bincount(src, minlength=n).astype(np.float32)
    adj = np.zeros((n, n))
    adj[src, dst] = 1.0
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = 0.85 * adj.T @ (r / deg) + 0.15 / n
    srt = np.sort(r)
    gi = int(np.argmax(np.diff(srt)[n // 2:])) + n // 2
    tau = float((srt[gi] + srt[gi + 1]) / 2)
    cols = {"edge": (src, dst),
            "node": (np.arange(n), np.full(n, 1.0 / n, np.float32), deg,
                     np.full(n, 0.15 / n, np.float32))}

    def run(device):
        rels = {p: TE.Relation.from_columns(n, *c, device=device)
                for p, c in cols.items()}
        ex = TE.compile_program(TL.pagerank_threshold_program(tau=tau),
                                rels, storage="row-table", device=device)
        return ex.run(max_iters=iters, on_device=True)

    want = run(CPU)
    sc_kernel.reset_launch_count()
    got = run(dev)
    assert sc_kernel.launch_count >= 2 * iters
    assert got.phase_iterations == want.phase_iterations
    assert not got.storage_fallback
    for p in ("rank", "hot", "reach"):
        np.testing.assert_array_equal(got.state[p].tuples(),
                                      want.state[p].tuples())
    torch.testing.assert_close(got.state["rank"].values[1].cpu(),
                               want.state["rank"].values[1], rtol=1e-5,
                               atol=0)
