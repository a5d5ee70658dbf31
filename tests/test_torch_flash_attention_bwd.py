"""The port's flash-attention backward against the JAX package's, on the
CPU.

The same numpy inputs go through ``jax.grad`` of the JAX package's
``flash_attention`` (the Pallas forward and dq/dkv kernels in interpret
mode, ``block_q = block_k = 64``), ``attention_reference`` and
``chunked_attention``, and through the port's ``ops.flash_attention`` (the
``torch.autograd.Function`` whose CPU route runs ``attention_reference``
and the plain backward ``attention_backward``) and ``chunked_attention``
(the port of the JAX package's custom VJP).  The loss is the
cos-weighted sum of ``tests/test_kernels.py``.

Tolerances: gradients within 2e-5 max abs of the Pallas kernels and of
``jax.grad`` of the reference (``tests/test_kernels.py``'s bar), within
1e-5 of ``chunked_attention``'s (the same math, f32 sums in another
order).  The Pallas kernels leave rows past the last whole block
unwritten, so they are compared at block multiples only; the references
at every length.

The card's bf16 route (P and dS rounded to bf16 before their products,
f32 sums, bf16 outputs) is emulated step by step here and held to
``kernel.bf16_bwd_error_bound``, which must also reject a backward that
drops delta or skips a KV tile's dK/dV.  The kernels themselves are held
to the plain backward on the card in
``tests/test_torch_flash_attention_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash_attention,
)
from repro.kernels.flash_attention.ref import (
    attention_reference as jax_reference,
)
from repro.models.common import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_backward,
    attention_reference,
    visible_mask,
)
from repro_torch.models.common import chunked_attention

GRAD_TOL = 2e-5
CHUNKED_TOL = 1e-5

# tests/test_kernels.py:55-61
PALLAS_CASES = [
    # B, H, KH, Sq, Skv, D, causal, window
    (1, 2, 2, 128, 128, 64, True, None),
    (1, 4, 2, 128, 128, 64, True, None),
    (1, 2, 2, 128, 128, 64, True, 64),
    (2, 2, 1, 64, 64, 32, False, None),
]

RAGGED = [
    (1, 4, 2, 37, 93, 16, True, None),
    (2, 2, 1, 37, 93, 32, False, None),
    (1, 2, 2, 37, 93, 16, True, 5),
    (1, 2, 1, 93, 37, 16, True, None),     # Sq > Skv: 56 rows see no key
    (1, 2, 2, 64, 64, 32, True, 1),        # each row sees only itself
    (1, 2, 2, 50, 50, 16, False, 0),       # no row sees a key
]


def _arrays(case, seed):
    B, H, KH, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, KH, Skv, D), (B, KH, Skv, D))]


def _weights(D):
    return np.cos(np.arange(D, dtype=np.float32))


def _jax_grads(fn, arrays, D):
    w = jnp.asarray(_weights(D))
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrays))


def _port_grads(fn, arrays, D):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*leaves) * torch.from_numpy(_weights(D))).sum().backward()
    return [t.grad for t in leaves]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_plain_backward_matches_pallas_kernels(case):
    causal, window, D = case[6], case[7], case[5]
    arrays = _arrays(case, seed=0)
    want = _jax_grads(lambda q, k, v: jax_flash_attention(
        q, k, v, causal=causal, window=window, interpret=True, block_q=64,
        block_k=64), arrays, D)
    got = _port_grads(lambda q, k, v: flash_attention(
        q, k, v, causal=causal, window=window), arrays, D)
    _close(got, want, GRAD_TOL)


@pytest.mark.parametrize("case", PALLAS_CASES[:2] + RAGGED)
def test_plain_backward_matches_jax_reference(case):
    causal, window, D = case[6], case[7], case[5]
    arrays = _arrays(case, seed=1)
    want = _jax_grads(lambda q, k, v: jax_reference(
        q, k, v, causal=causal, window=window), arrays, D)
    got = _port_grads(lambda q, k, v: flash_attention(
        q, k, v, causal=causal, window=window), arrays, D)
    _close(got, want, GRAD_TOL)
    # the same through the LM's layout
    got = _port_grads(lambda q, k, v: flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, layout="bshd").transpose(1, 2),
        arrays, D)
    _close(got, want, GRAD_TOL)


def test_plain_backward_gives_zero_for_rows_that_see_no_key():
    case = (1, 2, 1, 93, 37, 16, True, None)
    q, k, v = (torch.from_numpy(a) for a in _arrays(case, seed=2))
    out, m, l = attention_reference(q, k, v, return_stats=True)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    delta = (do * out).sum(-1)
    dq, dk, dv = attention_backward(q, k, v, do, m, l, delta)
    empty = l == 0
    assert int(empty.sum()) == 2 * 56
    assert bool((dq[empty] == 0).all())
    assert bool(torch.isfinite(dk).all() and torch.isfinite(dv).all())


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("case", [(1, 4, 2, 9, 13, 8, True, None),
                                  (2, 2, 1, 7, 7, 8, False, 3),
                                  (1, 2, 2, 13, 9, 8, True, 1)])
def test_function_cpu_route_passes_gradcheck_in_f64(case, layout):
    causal, window = case[6], case[7]
    arrays = [torch.from_numpy(a).double() for a in _arrays(case, seed=3)]
    if layout == "bshd":
        arrays = [a.transpose(1, 2).contiguous() for a in arrays]
    leaves = [a.requires_grad_() for a in arrays]
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                        window=window, layout=layout),
        leaves)


@pytest.mark.parametrize("case", PALLAS_CASES[1:2] + RAGGED[:4])
def test_chunked_attention_gradients_match_jax(case):
    """The LM's attention on the CPU in (B, S, H, D), with a chunk that
    does not divide Skv."""

    causal, window, D = case[6], case[7], case[5]
    arrays = [a.transpose(0, 2, 1, 3) for a in _arrays(case, seed=4)]
    want = _jax_grads(lambda q, k, v: jax_chunked(
        q, k, v, causal=causal, window=window, chunk=24), arrays, D)
    got = _port_grads(lambda q, k, v: chunked_attention(
        q, k, v, causal=causal, window=window, chunk=24), arrays, D)
    _close(got, want, CHUNKED_TOL)


# ---------------------------------------------------------------------------
# The bf16 route's error bound
# ---------------------------------------------------------------------------


def _bf16_route(q, k, v, do, m, l, delta, causal, window, scale,
                skip_tile=False, drop_delta=False):
    """The backward kernels' bf16 route step by step ([B, H, S, D], bf16
    inputs): S and dP in f32, P and dS in f32, each rounded to bf16 before
    its product, the products summed in f32, the outputs rounded to bf16.
    Planted faults: ``skip_tile`` leaves KV tile 0's dK/dV out (zeros),
    ``drop_delta`` forms dS = P dP."""

    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = q.float() @ kf.transpose(-1, -2) * scale
    ok = visible_mask(Sq, Skv, causal, window, q.device) & (l[..., None] > 0)
    il = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    p = torch.where(ok, torch.exp(s - m[..., None]) * il[..., None], 0.0)
    dp = do.float() @ vf.transpose(-1, -2)
    ds = p * (dp - (0.0 if drop_delta else delta[..., None]))
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq = (dsb @ kf * scale).bfloat16()
    dk = (dsb.transpose(-1, -2) @ q.float()).reshape(B, KH, G, Skv, D)
    dv = (pb.transpose(-1, -2) @ do.float()).reshape(B, KH, G, Skv, D)
    dk, dv = (dk.sum(2) * scale).bfloat16(), dv.sum(2).bfloat16()
    if skip_tile:
        dk[:, :, :64] = 0
        dv[:, :, :64] = 0
    return dq, dk, dv


BOUND_CASES = [
    # B, H, KH, Sq, Skv, D, causal, window
    (1, 6, 2, 500, 500, 64, True, None),
    (1, 4, 2, 100, 700, 128, True, None),
    (1, 2, 2, 500, 500, 64, True, 64),
    (1, 4, 2, 333, 400, 160, False, 100),
]


def _bound_inputs(case, seed):
    causal, window, D = case[6], case[7], case[5]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays(case, seed))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed)
                     ).bfloat16()
    scale = 1.0 / D ** 0.5
    out, m, l = attention_reference(q.float(), k.float(), v.float(),
                                    causal=causal, window=window,
                                    sm_scale=scale, return_stats=True)
    delta = (do.float() * out.bfloat16().float()).sum(-1)
    ref = attention_backward(q.float(), k.float(), v.float(), do.float(), m,
                             l, delta, causal=causal, window=window,
                             sm_scale=scale)
    bounds = K.bf16_bwd_error_bound(q, k, v, do, m, l, delta, ref,
                                    causal=causal, window=window,
                                    sm_scale=scale)
    return (q, k, v, do, m, l, delta, causal, window, scale), ref, bounds


def _over(got, ref, bounds):
    return [int(((g.float() - r).abs() > b).sum())
            for g, r, b in zip(got, ref, bounds)]


@pytest.mark.parametrize("case", BOUND_CASES)
def test_bf16_backward_bound_holds_for_the_bf16_route(case):
    args, ref, bounds = _bound_inputs(case, seed=5)
    got = _bf16_route(*args)
    assert _over(got, ref, bounds) == [0, 0, 0], [
        float(((g.float() - r).abs() / b).max())
        for g, r, b in zip(got, ref, bounds)]


@pytest.mark.parametrize("fault", ["skip_tile", "drop_delta"])
def test_bf16_backward_bound_rejects_planted_faults(fault):
    args, ref, bounds = _bound_inputs(BOUND_CASES[0], seed=6)
    got = _bf16_route(*args, **{fault: True})
    over = _over(got, ref, bounds)
    if fault == "skip_tile":
        assert over[0] == 0 and over[1] > 0 and over[2] > 0, over
    else:
        assert over[0] > 0 and over[1] > 0 and over[2] == 0, over
