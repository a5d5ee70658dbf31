"""The port's segment combine against the JAX package's.

The port's plain version (``repro_torch...ref``) is held against the JAX
``segment_combine_reference`` and against the Pallas kernel in interpret
mode, on the same numpy inputs.  max/min must match exactly; sums within
1e-6 of the segment's sum of |v| (f32 sums taken in another order).  bf16
payloads may differ by one bf16 ulp where the f32 sums round apart.  The
Hopper kernel itself is held against the plain version on the card only,
in ``tests/test_torch_segment_combine_cuda.py`` (which imports nothing of
JAX, so it runs on the machine with the card); here, on the CPU, the
summation depth of its decomposition (``kernel.sum_depth``) that those
tests' bars read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_combine.ops import (
    segment_combine as jax_segment_combine,
)
from repro.kernels.segment_combine.ref import (
    segment_combine_reference as jax_reference,
)
from repro_torch.kernels.segment_combine import kernel as K
from repro_torch.kernels.segment_combine.kernel import segment_combine_cuda
from repro_torch.kernels.segment_combine.ops import (
    kernel_eligible,
    segment_combine,
)
from repro_torch.kernels.segment_combine.ref import segment_combine_reference

SUM_RTOL = 1e-6
BF16_ULP = 2.0 ** -7

SEG_SWEEP = [
    (1000, 8, 64, "sum"), (513, 16, 200, "sum"), (2048, 32, 256, "sum"),
    (256, 4, 32, "max"), (777, 8, 130, "min"), (64, 128, 16, "sum"),
]


def _sorted_ids(rng, E, N, front=0, back=3):
    ids = np.sort(rng.integers(0, N, size=E - front - back)).astype(np.int32)
    return np.concatenate([np.full(front, -1, np.int32), ids,
                           np.full(back, -1, np.int32)])


def _magnitude(vals, ids, N, act=None):
    """Per-segment sum of |v| over the kept rows (float64)."""

    keep = ids >= 0
    if act is not None:
        keep &= act
    out = np.zeros((N, vals.shape[1]))
    np.add.at(out, ids[keep], np.abs(vals[keep].astype(np.float64)))
    return out


def _assert_combine_close(got, want, op, mag, bf16=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if op != "sum":
        np.testing.assert_array_equal(got, want)
        return
    tol = SUM_RTOL * mag + 1e-30
    if bf16:
        tol = tol + BF16_ULP * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want))


def _torch(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("E,F,N,op", SEG_SWEEP)
def test_plain_matches_jax_reference_and_pallas_interpret(E, F, N, op):
    rng = np.random.default_rng(E + F)
    ids = _sorted_ids(rng, E, N)
    vals = rng.normal(size=(E, F)).astype(np.float32)
    got = segment_combine(_torch(vals), _torch(ids), N, op).numpy()
    mag = _magnitude(vals, ids, N)
    ref = jax_reference(jnp.asarray(vals), jnp.asarray(ids), N, op)
    _assert_combine_close(got, ref, op, mag)
    pallas = jax_segment_combine(jnp.asarray(vals), jnp.asarray(ids), N, op,
                                 interpret=True)
    _assert_combine_close(got, pallas, op, mag)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_plain_padding_at_both_ends_and_out_of_range_ids(op):
    rng = np.random.default_rng(11)
    E, F, N = 500, 3, 37
    ids = _sorted_ids(rng, E, N, front=17, back=9)
    ids[-40:-9] = N + 2          # out-of-range ids are dropped
    vals = rng.normal(size=(E, F)).astype(np.float32)
    got = segment_combine_reference(_torch(vals), _torch(ids), N, op)
    ref = jax_reference(jnp.asarray(vals), jnp.asarray(ids), N, op)
    keep = (ids >= 0) & (ids < N)
    _assert_combine_close(got, ref, op,
                          _magnitude(vals[keep], ids[keep], N))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_plain_bf16_matches_pallas_interpret(op):
    E, F, N = 600, 4, 40
    rng = np.random.default_rng(9)
    ids = np.sort(rng.integers(0, N, E)).astype(np.int32)
    vals = jnp.asarray(rng.normal(size=(E, F)).astype(np.float32),
                       jnp.bfloat16)
    vals_np = np.asarray(vals.astype(jnp.float32))
    got = segment_combine(_torch(vals_np).to(torch.bfloat16), _torch(ids),
                          N, op)
    assert got.dtype == torch.bfloat16
    pallas = jax_segment_combine(vals, jnp.asarray(ids), N, op,
                                 interpret=True)
    _assert_combine_close(got.float(), pallas.astype(jnp.float32), op,
                          _magnitude(vals_np, ids, N), bf16=True)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_plain_clustered_edge_active_matches_jax(op):
    E, F, N = 600, 4, 40
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, N, E)).astype(np.int32)
    vals = rng.normal(size=(E, F)).astype(np.float32)
    # clustered activity: whole id ranges (hence edge blocks) go quiet
    act = (rng.random(E) < 0.15) & (np.arange(E) > E // 2)
    got = segment_combine(_torch(vals), _torch(ids), N, op,
                          edge_active=_torch(act))
    mag = _magnitude(vals, ids, N, act)
    ref = jax_reference(jnp.asarray(vals), jnp.asarray(ids), N, op,
                        edge_active=jnp.asarray(act))
    _assert_combine_close(got, ref, op, mag)
    pallas = jax_segment_combine(jnp.asarray(vals), jnp.asarray(ids), N, op,
                                 edge_active=jnp.asarray(act),
                                 interpret=True)
    _assert_combine_close(got, pallas, op, mag)


def test_plain_max_min_keep_the_kernel_identity_quirk():
    # A real max/min equal to the kernel's identity (-1e30 / +1e30) reads 0,
    # as on the TPU: the plain version mirrors the kernel bit for bit.
    ids = torch.tensor([0, 0, 1], dtype=torch.int32)
    vals = torch.tensor([[-1e30], [-2e30], [3.0]])
    out = segment_combine_reference(vals, ids, 3, "max")
    assert out[:, 0].tolist() == [0.0, 3.0, 0.0]
    out = segment_combine_reference(-vals, ids, 3, "min")
    assert out[:, 0].tolist() == [0.0, -3.0, 0.0]


def test_kernel_eligible_needs_a_cuda_f32_or_bf16_payload():
    f32 = torch.zeros((8, 2))
    assert not kernel_eligible(f32, "sum")        # CPU tensor
    assert not kernel_eligible(f32, "argmin")     # no kernel_op
    assert not kernel_eligible(torch.zeros((8, 2), dtype=torch.int32))


def test_cuda_wrapper_raises_on_cpu_tensors():
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segment_combine_cuda(torch.zeros((8, 2)), ids, 4, "sum")


@pytest.mark.parametrize("chunks", [1, 2, 7, K.PIECE_CHUNKS])
def test_sum_depth_of_an_unsplit_segment_is_the_old_bound(chunks):
    # One piece: CHUNK_DEPTH in the chunk, one addition a chunk.
    assert K.sum_depth(chunks, 1) == K.CHUNK_DEPTH + chunks
    t = K.sum_depth(torch.tensor([chunks]), torch.tensor([1]))
    assert t.tolist() == [K.CHUNK_DEPTH + chunks]


@pytest.mark.parametrize("chunks,pieces", [(33, 2), (100, 4), (12_700, 398)])
def test_sum_depth_of_a_split_segment(chunks, pieces):
    # At most PIECE_CHUNKS chunk totals a piece, then the pieces' chain.
    want = K.CHUNK_DEPTH + K.PIECE_CHUNKS + pieces - 1
    assert K.sum_depth(chunks, pieces) == want <= K.CHUNK_DEPTH + chunks


def _ids(runs):
    return torch.repeat_interleave(
        torch.tensor([i for i, _ in runs], dtype=torch.int32),
        torch.tensor([r for _, r in runs]))


def test_summation_shape_cuts_tiles_into_pieces_of_k_chunks():
    C, PK = K.CHUNK_ROWS, K.PIECE_CHUNKS
    # Tile 0 (the first min(ACC_FLOATS, CHUNK_ROWS) segments at F = 1):
    # padding fills chunk 0, segment 0 starts chunk 1, the hub (segment 5)
    # runs through chunk 100; the next tile's first segment shares chunk
    # 100.  b0 = 1, so the hub's chunks 1-100 are pieces 0 .. 99 // PK.
    tile_n = min(K.ACC_FLOATS, C)
    other = tile_n + 3
    ids = _ids([(-1, C), (0, 10), (5, 100 * C - 10), (other, 50)])
    chunks, pieces = K.summation_shape(ids, 2 * tile_n, 1)
    hub_pieces = -(-100 // PK)
    assert (chunks[0], pieces[0]) == (1, 1)
    assert (chunks[5], pieces[5]) == (100, hub_pieces)
    assert (chunks[other], pieces[other]) == (1, 1)
    assert int(chunks[1:5].sum() + pieces[1:5].sum()) == 0
    depths = K.summation_depths(ids, 2 * tile_n, 1)
    assert depths[5] == K.CHUNK_DEPTH + PK + hub_pieces - 1
    assert depths[0] == depths[other] == K.CHUNK_DEPTH + 1


@pytest.mark.parametrize("extra,pieces", [(0, 1), (1, 2)])
def test_a_tile_of_k_chunks_stays_whole_and_k_plus_1_splits(extra, pieces):
    C, PK = K.CHUNK_ROWS, K.PIECE_CHUNKS
    ids = _ids([(2, 100), (7, PK * C - 100 + extra)])
    chunks, got = K.summation_shape(ids, 256, 1)
    assert (int(chunks[7]), int(got[7])) == (PK + extra, pieces)
    assert int(got[2]) == 1


def test_summation_shape_follows_the_payload_width_and_the_mask():
    C, PK = K.CHUNK_ROWS, K.PIECE_CHUNKS
    # Half a piece of segment 7, then a piece of segment 8, in one tile at
    # F = 1: segment 8's chunks cross the tile's first piece boundary.  At
    # F = 1024 a tile holds 8 segments, so segment 8 starts a tile (and a
    # piece) of its own.
    ids = _ids([(7, PK // 2 * C), (8, PK * C)])
    _, pieces = K.summation_shape(ids, 16, 1)
    assert pieces[7:9].tolist() == [1, 2]
    _, pieces = K.summation_shape(ids, 16, 1024)
    assert pieces[7:9].tolist() == [1, 1]
    # A wholly inactive piece holds none of the segment's rows.
    ids = _ids([(3, 3 * PK * C)])
    act = torch.ones(ids.shape[0], dtype=torch.bool)
    act[PK * C: 2 * PK * C] = False
    chunks, pieces = K.summation_shape(ids, 8, 1, act)
    assert (int(chunks[3]), int(pieces[3])) == (2 * PK, 2)


def test_summation_depths_never_below_the_old_bound_unsplit():
    rng = np.random.default_rng(3)
    E, N = 50_000, 4_000
    ids = _torch(_sorted_ids(rng, E, N, front=300, back=77))
    act = _torch(rng.random(E) < 0.6)
    chunks, pieces = K.summation_shape(ids, N, 2, act)
    depths = K.summation_depths(ids, N, 2, act)
    whole = pieces == 1
    assert bool(whole.any())
    assert torch.equal(depths[whole], K.CHUNK_DEPTH + chunks[whole])


@pytest.mark.parametrize("width,plan", [
    (1, [(0, 1)]),
    (K.ACC_FLOATS, [(0, K.ACC_FLOATS)]),
    (K.ACC_FLOATS + 1, [(0, K.ACC_FLOATS), (K.ACC_FLOATS, K.ACC_FLOATS + 1)]),
    (2 * K.ACC_FLOATS, [(0, K.ACC_FLOATS), (K.ACC_FLOATS, 2 * K.ACC_FLOATS)]),
])
def test_wide_payloads_are_cut_into_column_slices(width, plan):
    # ROADMAP C10: one launch a slice of at most ACC_FLOATS columns.
    assert K.column_slices(width) == plan


def test_summation_depths_of_a_wide_payload_take_the_deepest_slice():
    ids = torch.repeat_interleave(torch.arange(40, dtype=torch.int32),
                                  300)
    wide = K.summation_depths(ids, 40, K.ACC_FLOATS + 1)
    per_slice = [K.summation_depths(ids, 40, w) for w in (K.ACC_FLOATS, 1)]
    assert torch.equal(wide, torch.maximum(*per_slice))
    with pytest.raises(ValueError, match="one launch's width"):
        K.summation_shape(ids, 40, K.ACC_FLOATS + 1)
