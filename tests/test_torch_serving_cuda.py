"""The serving layer's card paths: the segment-combine kernel under
``torch.func.vmap`` and the EDB cache's copies.

These tests need the card (the CUDA kernel has no CPU mode) and skip
without one; they import nothing of JAX, so they run on the machine with
the card as they are:

    python -m pytest -q tests/test_torch_serving_cuda.py

Under vmap the k queries of a combine move into its payload columns, so
one combine launches the kernel once a column slice of
``kernel.ACC_FLOATS`` floats.  max/min must be bit-equal to the k single
calls; sums within (gamma_d1 + gamma_d2) sum|v| of them, d1 and d2 the
kernel's summation depths at the single and the batched width
(``kernel.summation_depths``; gamma_d = d u / (1 - d u), u = 2^-24).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.physical import segment_combine_sorted
from repro_torch.kernels.segment_combine import kernel as K

F32_UNIT = 2.0 ** -24


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _gamma(d):
    return d * F32_UNIT / (1.0 - d * F32_UNIT)


def _case(k, F, with_active, device, E=300_011, n=70_001):
    gen = torch.Generator(device=device)
    gen.manual_seed(k * 31 + F)
    ids = torch.sort(torch.randint(-1, n + 1, (E,), generator=gen,
                                   device=device, dtype=torch.int32)).values
    vals = torch.randn((k, E, F), generator=gen, device=device)
    act = (torch.rand(E, generator=gen, device=device) < 0.6) \
        if with_active else None
    return vals, ids, n, act


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("k,F", [(16, 1), (4, 3)])
def test_vmapped_kernel_launches_once_and_matches_single_calls(
        op, with_active, k, F):
    device = _card()
    vals, ids, n, act = _case(k, F, with_active, device)
    before = K.launch_count
    got = torch.func.vmap(lambda v: segment_combine_sorted(
        v, ids, n, op, edge_active=act))(vals)
    torch.cuda.synchronize()
    assert K.launch_count == before + 1
    assert got.shape == (k, n, F)
    single = torch.stack([segment_combine_sorted(vals[q], ids, n, op,
                                                 edge_active=act)
                          for q in range(k)])
    assert K.launch_count == before + 1 + k
    if op != "sum":
        assert torch.equal(got, single)
        return
    mag = torch.stack([segment_combine_sorted(vals[q].abs(), ids, n, "sum",
                                              edge_active=act)
                       for q in range(k)]).double()
    d1 = K.summation_depths(ids, n, F, act).double()[None, :, None]
    d2 = K.summation_depths(ids, n, k * F, act).double()[None, :, None]
    bar = (_gamma(d1) + _gamma(d2)) * mag
    assert bool(((got.double() - single.double()).abs() <= bar).all())


def test_vmapped_kernel_wider_than_the_accumulator_takes_two_slices():
    device = _card()
    k, F = 3, 4096                      # k * F = 12288 > ACC_FLOATS
    vals, ids, n, _ = _case(k, F, False, device, E=20_011, n=3_001)
    assert len(K.column_slices(k * F)) == 2
    before = K.launch_count
    got = torch.func.vmap(lambda v: segment_combine_sorted(
        v, ids, n, "max"))(vals)
    torch.cuda.synchronize()
    assert K.launch_count == before + 2
    for q in range(k):
        assert torch.equal(got[q], segment_combine_sorted(vals[q], ids, n,
                                                          "max"))


def test_edb_cache_copies_a_host_relation_once_and_a_card_one_never():
    device = _card()
    from repro_torch.core.executor import Relation
    from repro_torch.core.serving import EDBCache

    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 512, 4096), rng.integers(0, 512, 4096)
    cache = EDBCache()
    host = Relation.from_columns(512, src, dst, device="cpu")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    placed = cache.place("edge", host, device)
    grown = torch.cuda.memory_allocated() - before
    assert placed.present.is_cuda and grown >= 512 * 512
    assert torch.equal(placed.present.cpu(), host.present)
    assert cache.place("edge", host, device) is placed
    assert torch.cuda.memory_allocated() - before == grown
    card = Relation.from_columns(512, src, dst, device=device)
    again = cache.place("edge2", card, device)
    assert again.present is card.present
    assert cache.counters() == {"hits": 1, "misses": 2, "size": 2}


def test_batched_serving_on_the_card_equals_sequential():
    device = _card()
    from repro_torch.core.executor import Relation
    from repro_torch.core.serving import (
        FixpointServer,
        personalized_pagerank_program,
        point_reachability_program,
    )

    n = 96
    rng = np.random.default_rng(1)
    src = np.repeat(np.arange(n), 4)
    dst = rng.integers(0, n, 4 * n)
    pairs = np.unique(src * n + dst)
    src, dst = pairs // n, pairs % n
    deg = np.bincount(src, minlength=n).astype(np.float32)
    server = FixpointServer({
        "edge": Relation.from_columns(n, src, dst, device="cpu"),
        "deg": Relation.from_columns(n, np.arange(n), deg, device="cpu"),
    }, device=device)
    seeds = [np.sort(rng.choice(n, rng.integers(1, 9), replace=False))
             for _ in range(8)]
    batch = [{"seed": Relation.from_columns(
        n, vs, np.full(len(vs), 1.0 / len(vs), np.float32), device="cpu")}
        for vs in seeds]
    ppr = personalized_pagerank_program()
    got = server.query(ppr, batch, max_iters=20, force="batched")
    seq = server.query(ppr, batch, max_iters=20, force="sequential")
    assert got.batched and got.cache_hit is False and seq.cache_hit
    for b, s in zip(got.answers, seq.answers):
        assert torch.equal(b["rank"].present, s["rank"].present)
        rb, rs = b["rank"].values[1], s["rank"].values[1]
        assert rb.is_cuda
        assert float((rb - rs).abs().max()) <= 1e-6 * float(rs.abs().max())
    probes = [{"src": Relation.from_columns(n, np.array([a]), device="cpu"),
               "dst": Relation.from_columns(n, np.array([b]), device="cpu")}
              for a, b in rng.integers(0, n, (8, 2))]
    reach = point_reachability_program()
    got = server.query(reach, probes, max_iters=n, force="batched")
    seq = server.query(reach, probes, max_iters=n, force="sequential")
    for b, s in zip(got.answers, seq.answers):
        for pred in ("reach", "hit"):
            assert torch.equal(b[pred].present, s[pred].present)
