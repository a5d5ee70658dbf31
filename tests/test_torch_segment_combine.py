"""The port's segment combine against the JAX package's.

The port's plain version (``repro_torch...ref``) is held against the JAX
``segment_combine_reference`` and against the Pallas kernel in interpret
mode, on the same numpy inputs.  max/min must match exactly; sums within
1e-6 of the segment's sum of |v| (f32 sums taken in another order).  bf16
payloads may differ by one bf16 ulp where the f32 sums round apart.  The
Hopper kernel itself is held against the plain version on the card only.
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
