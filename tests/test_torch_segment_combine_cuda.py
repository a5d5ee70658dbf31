"""The Hopper segment-combine kernel against its plain version.

These tests need the card (the CUDA kernel has no CPU mode) and skip
without one; they import nothing of JAX, so they run on the machine with
the card as they are:

    python -m pytest -q tests/test_torch_segment_combine_cuda.py

max/min must be bit-equal to the plain version and two launches
bit-identical.  Sums: within 1e-5 of the segment's sum of |v| of the plain
version on random segments, and on the hub-split cases (tiles whose rows
span more than ``kernel.PIECE_CHUNKS`` chunks, cut into pieces) within
gamma_d sum|v| of a float64 sum, d = ``kernel.sum_depth`` of the chunks
and pieces that hold the segment (gamma_d = d u / (1 - d u), u = 2^-24;
bf16 output adds 2^-8 of the value); integer-valued hubs summed exactly.
"""

import pytest
import torch

from repro_torch.kernels.segment_combine import kernel as K
from repro_torch.kernels.segment_combine.kernel import segment_combine_cuda
from repro_torch.kernels.segment_combine.ref import segment_combine_reference

BF16_ULP = 2.0 ** -7
F32_UNIT = 2.0 ** -24
BF16_UNIT = 2.0 ** -8
F64_UNIT = 2.0 ** -53


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(op, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    E, F, N = 100_003, 4, 7_919
    ids = torch.sort(torch.randint(0, N, (E - 20,), generator=gen,
                                   device="cuda", dtype=torch.int32)).values
    pad = torch.full((10,), -1, dtype=torch.int32, device="cuda")
    ids = torch.cat([pad, ids, pad]).contiguous()
    vals = torch.randn((E, F), generator=gen, device="cuda").to(dtype)
    act = torch.rand(E, generator=gen, device="cuda") < 0.7
    for edge_active in (None, act):
        ker = segment_combine_cuda(vals, ids, N, op, edge_active=edge_active)
        again = segment_combine_cuda(vals, ids, N, op,
                                     edge_active=edge_active)
        ref = segment_combine_reference(vals, ids, N, op,
                                        edge_active=edge_active)
        assert torch.equal(ker, again)
        if op == "sum":
            mag = segment_combine_reference(vals.float().abs(), ids, N,
                                            "sum", edge_active=edge_active)
            tol = 1e-5 * mag + 1e-30
            if dtype == torch.bfloat16:
                tol = tol + BF16_ULP * ref.float().abs()
            assert bool(((ker.float() - ref.float()).abs() <= tol).all())
        else:
            assert torch.equal(ker, ref)


# Hub-split cases, as chip_smoke.py's SPLIT_CASES at smaller sizes:
# (id, rows) runs, n, F, the integer-valued hubs, the rows of a wholly
# inactive piece, and whether the hubs' tile is split.
C, PK = K.CHUNK_ROWS, K.PIECE_CHUNKS
SPLIT_CASES = {
    "tile_of_K_chunks": (
        [(s, 37) for s in range(5)] + [(7, PK * C - 185)], 768, 1, (7,),
        None, False),
    "tile_of_K_plus_1_chunks": (
        [(s, 37) for s in range(5)] + [(7, PK * C - 85)], 768, 1, (7,),
        None, True),
    "hub_mid_chunk": (
        [(-1, 300)] + [(s, 13) for s in range(10)] + [(20, PK * C + 77)]
        + [(s, 5) for s in range(21, 200)] + [(s, 7) for s in range(300, 330)]
        + [(-1, 33)], 512, 1, (20,), None, True),
    "two_long_segments": (
        [(-1, 50)] + [(s, 9) for s in range(10)]
        + [(10, PK * C + 33), (11, PK * C + 99)]
        + [(s, 3) for s in range(12, 250)] + [(-1, 10)], 512, 1, (10, 11),
        None, True),
    "inactive_piece": (
        [(3, 3 * PK * C)] + [(s, 21) for s in range(4, 100)], 256, 1, (3,),
        (PK * C, 2 * PK * C), True),
    "wide_payload": (
        [(0, 3), (1, 5), (5, (PK + 2) * C), (9, 11)], 32, 1024, (5,), None,
        True),
}


def _split_case(name, dtype, with_active, device):
    runs, n, F, hubs, quiet, split = SPLIT_CASES[name]
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    ids = torch.repeat_interleave(
        torch.tensor([i for i, _ in runs], dtype=torch.int32),
        torch.tensor([r for _, r in runs])).to(device)
    E = ids.shape[0]
    act = (torch.rand(E, generator=gen, device=device) < 0.5
           if with_active else None)
    if quiet is not None:
        if act is None:
            ids[quiet[0]:quiet[1]] = -1
        else:
            act[quiet[0]:quiet[1]] = False
    vals = torch.randn((E, F), generator=gen, device=device)
    for h in hubs:
        at = ids == h
        vals[at] = torch.randint(1, 9, (int(at.sum()), F), generator=gen,
                                 device=device).float()
    _, pieces = K.summation_shape(ids, n, F, act)
    assert all((int(pieces[h]) > 1) == split for h in hubs), pieces[
        list(hubs)]
    return vals.to(dtype).contiguous(), ids.contiguous(), n, act, hubs


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hub_split_matches_plain(name, op, dtype):
    device = _card()
    for with_active in (False, True):
        vals, ids, n, act, hubs = _split_case(name, dtype, with_active,
                                              device)
        before = K.launch_count
        ker = segment_combine_cuda(vals, ids, n, op, edge_active=act)
        again = segment_combine_cuda(vals, ids, n, op, edge_active=act)
        ref = segment_combine_reference(vals, ids, n, op, edge_active=act)
        torch.cuda.synchronize()
        assert K.launch_count == before + 2
        assert ker.dtype == dtype and ker.shape == (n, vals.shape[1])
        assert torch.equal(ker, again)
        if op != "sum":
            assert torch.equal(ker, ref)
            continue
        valid = (ids >= 0) & (ids < n)
        if act is not None:
            valid &= act
        rows = torch.nonzero(valid).squeeze(1)
        seg = ids.long()[rows]
        v = vals[rows].double()
        exact = torch.zeros((n, vals.shape[1]), dtype=torch.float64,
                            device=device).index_add_(0, seg, v)
        mag = torch.zeros_like(exact).index_add_(0, seg, v.abs())
        m = torch.bincount(seg, minlength=n).double()[:, None]
        d = K.summation_depths(ids, n, vals.shape[1], act).double()[:, None]
        tol = (d * F32_UNIT / (1 - d * F32_UNIT) + m * F64_UNIT) * mag
        if dtype == torch.bfloat16:
            tol = tol + BF16_UNIT * (exact.abs() + tol)
        err = (ker.double() - exact).abs()
        assert bool((err <= tol).all()), float((err - tol).max())
        for h in hubs:
            want = vals.float()[valid & (ids == h)].sum(0).to(dtype)
            assert torch.equal(ker[h], want), h


def test_the_library_matches_the_wrapper_constants():
    _card()
    lib = K._library()  # raises if the built constants differ
    assert lib.segment_combine_piece_chunks() == K.PIECE_CHUNKS


def _f64_bar(vals, ids, n, act):
    """(float64 sum, its bar) as in ``test_hub_split_matches_plain``: gamma_d
    sum|v| with d = ``kernel.summation_depths`` (at the slice width for a
    sliced payload) plus the float64 sum's own m 2^-53 sum|v|."""

    valid = (ids >= 0) & (ids < n)
    if act is not None:
        valid &= act
    rows = torch.nonzero(valid).squeeze(1)
    seg = ids.long()[rows]
    v = vals[rows].double()
    F = vals.shape[1]
    exact = torch.zeros((n, F), dtype=torch.float64,
                        device=vals.device).index_add_(0, seg, v)
    mag = torch.zeros_like(exact).index_add_(0, seg, v.abs())
    m = torch.bincount(seg, minlength=n).double()[:, None]
    d = K.summation_depths(ids, n, F, act).double()[:, None]
    tol = (d * F32_UNIT / (1 - d * F32_UNIT) + m * F64_UNIT) * mag
    if vals.dtype == torch.bfloat16:
        tol = tol + BF16_UNIT * (exact.abs() + tol)
    return exact, tol


@pytest.mark.parametrize("F", [K.ACC_FLOATS + 1, 2 * K.ACC_FLOATS])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_payload_is_sliced_and_matches_plain(F, op, dtype):
    # ROADMAP C10: a payload wider than ACC_FLOATS takes one launch a
    # column slice (kernel.column_slices); max/min bit-equal to plain, sums
    # within their float64 bar, two calls bit-identical.
    device = _card()
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    E, n = 3001, 257
    ids = torch.sort(torch.randint(0, n, (E - 8,), generator=gen,
                                   device=device, dtype=torch.int32)).values
    pad = torch.full((4,), -1, dtype=torch.int32, device=device)
    ids = torch.cat([pad, ids, pad]).contiguous()
    vals = torch.randn((E, F), generator=gen, device=device).to(dtype)
    act = torch.rand(E, generator=gen, device=device) < 0.6
    for edge_active in (None, act):
        before = K.launch_count
        ker = segment_combine_cuda(vals, ids, n, op, edge_active=edge_active)
        again = segment_combine_cuda(vals, ids, n, op,
                                     edge_active=edge_active)
        torch.cuda.synchronize()
        assert K.launch_count == before + 2 * len(K.column_slices(F))
        assert ker.shape == (n, F) and ker.dtype == dtype
        assert torch.equal(ker, again)
        ref = segment_combine_reference(vals, ids, n, op,
                                        edge_active=edge_active)
        if op != "sum":
            assert torch.equal(ker, ref)
            continue
        exact, tol = _f64_bar(vals, ids, n, edge_active)
        err = (ker.double() - exact).abs()
        assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_rows_give_the_empty_value(F, op, dtype):
    # ROADMAP C9 on the card: E = 0 launches and every segment reads the
    # kernel's empty value, 0 (ROADMAP C4), as the plain version does.
    device = _card()
    vals = torch.zeros((0, F), dtype=dtype, device=device)
    ids = torch.zeros(0, dtype=torch.int32, device=device)
    for edge_active in (None, torch.zeros(0, dtype=torch.bool,
                                          device=device)):
        before = K.launch_count
        ker = segment_combine_cuda(vals, ids, 9, op, edge_active=edge_active)
        torch.cuda.synchronize()
        assert K.launch_count == before + 1
        ref = segment_combine_reference(vals, ids, 9, op,
                                        edge_active=edge_active)
        assert ker.shape == (9, F)
        assert torch.equal(ker, ref)
        assert torch.equal(ker, torch.zeros_like(ker))


def test_generic_engine_segment_scan_launches_the_kernel():
    # On a grid of at most 21 cells the planner prefers the segment scan to
    # the masked reduction even for a sum (planner.plan_program), so the
    # generic engine's GroupBy reaches the kernel: PageRank -> threshold ->
    # reach on 4 vertices (16 rows a GroupBy), held against numpy.  Ranks
    # within 1e-6 relative (f32 sums in another order), sets exact.
    import numpy as np

    from repro_torch.core.executor import Relation, compile_program
    from repro_torch.core.listings import pagerank_threshold_program

    device = _card()
    n, iters, tau = 4, 30, 0.25
    src = np.repeat(np.arange(n), 2)
    dst = np.array([1, 2, 2, 3, 1, 2, 0, 2])
    deg = np.bincount(src, minlength=n).astype(np.float32)
    rels = {
        "edge": Relation.from_columns(n, src, dst, device=device),
        "node": Relation.from_columns(
            n, np.arange(n), np.full(n, 1.0 / n, np.float32), deg,
            np.full(n, 0.15 / n, np.float32), device=device),
    }
    ex = compile_program(pagerank_threshold_program(tau=tau), rels,
                         device=device)
    assert f"groupby(P2: sum via segment-scan, {n * n} rows -> {n})" \
        in ex.plan.notes
    adj = np.zeros((n, n), np.float32)
    adj[src, dst] = 1.0
    r = np.full(n, 1.0 / n, np.float32)
    for _ in range(iters):
        r = (0.85 * (adj.T @ (r / deg)) + 0.15 / n).astype(np.float32)
    hot = r > tau
    reach = hot.copy()
    while True:
        new = reach | ((((adj > 0).T @ reach) > 0) & hot)
        if (new == reach).all():
            break
        reach = new
    for on_device in (False, True):
        K.reset_launch_count()
        res = ex.run(max_iters=iters, on_device=on_device)
        # one GroupBy a PageRank iteration
        assert K.launch_count >= res.phase_iterations[0]
        rank = res.state["rank"].values[1].cpu().numpy()
        np.testing.assert_allclose(rank, r, rtol=1e-6, atol=0)
        assert (res.state["hot"].present.cpu().numpy() == hot).all()
        assert (res.state["reach"].present.cpu().numpy() == reach).all()
