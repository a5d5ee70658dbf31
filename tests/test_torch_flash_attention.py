"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX package's ``flash_attention``
(the Pallas kernel in interpret mode, ``block_q = block_k = 64``), its
``attention_reference`` and ``chunked_attention``, and through the port's
``ops.flash_attention`` (its plain version on a CPU tensor),
``attention_reference`` and ``chunked_attention`` (the chunked
online-softmax on a CPU tensor).  The Pallas kernel leaves rows past the
last whole block unwritten (ROADMAP C7), so it is compared only at block
multiples; the references and the chunked paths at every length.

Tolerances: out within 1e-5 max abs in f32 and 3e-2 in bf16 (the bars of
``tests/test_kernels.py``, 2e-6 loosened to 1e-5 in f32 for another
summation order); m and l within 1e-5 relative (of max(|x|, 1)), rows with
no visible key exactly -1e30 and 0 on both sides.  The kernel itself is
held against the plain version on the card in
``tests/test_torch_flash_attention_cuda.py``; its bf16 route is held there
to ``kernel.bf16_error_bound``, which the tests here check against a
step-by-step emulation of that route (bf16 P into P V, f32 l, bf16 out).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as JK
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
    NEG_INF,
    attention_reference,
)
from repro_torch.models.common import chunked_attention

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
STATS_RTOL = 1e-5

# tests/test_kernels.py:27-37, with the dtype as a name.
FLASH_SWEEP = [
    # B, H, KH, Sq, Skv, D, causal, window, dtype
    (1, 2, 2, 128, 128, 64, True, None, "float32"),
    (2, 4, 2, 128, 128, 64, True, None, "float32"),   # GQA
    (1, 4, 1, 64, 64, 32, False, None, "float32"),    # MQA bidir
    (1, 2, 2, 128, 128, 64, True, 64, "float32"),     # SWA
    (1, 2, 2, 256, 256, 64, True, 32, "float32"),     # narrow SWA
    (1, 2, 1, 64, 256, 64, True, None, "float32"),    # Sq < Skv
    (1, 2, 2, 128, 128, 128, True, None, "float32"),  # D=128
    (1, 2, 2, 128, 128, 64, True, None, "bfloat16"),
    (1, 8, 2, 64, 64, 32, True, None, "bfloat16"),
]

RAGGED = [
    # B, H, KH, Sq, Skv, D, causal, window
    (1, 4, 2, 37, 93, 16, True, None),
    (2, 2, 1, 37, 93, 32, False, None),
    (1, 2, 2, 37, 93, 16, True, 5),
    (1, 2, 1, 93, 37, 16, True, None),     # Sq > Skv: 56 rows see no key
    (1, 2, 2, 64, 64, 32, True, 1),        # each row sees only itself
    (1, 2, 2, 50, 50, 16, False, 0),       # no row sees a key
]


def _inputs(case, dtype, seed):
    B, H, KH, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, H, Sq, D), (B, KH, Skv, D), (B, KH, Skv, D))]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("case", FLASH_SWEEP)
def test_port_matches_pallas_kernel(case):
    causal, window, dtype = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype, seed=0)
    want = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                               interpret=True, block_q=64, block_k=64)
    _close(flash_attention(q, k, v, causal=causal, window=window), want,
           TOL[dtype])
    _close(attention_reference(q, k, v, causal=causal, window=window), want,
           TOL[dtype])


@pytest.mark.parametrize("case", FLASH_SWEEP)
def test_port_stats_match_pallas_kernel(case):
    """The plain version's m, l against lane 0 of the Pallas kernel's."""

    causal, window, dtype = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype, seed=1)
    scale = 1.0 / case[5] ** 0.5
    _, jm, jl = JK.flash_fwd(jq, jk, jv, causal=causal, window=window,
                             sm_scale=scale, block_q=64, block_k=64,
                             interpret=True)
    _, m, l = attention_reference(q, k, v, causal=causal, window=window,
                                  sm_scale=scale, return_stats=True)
    jm, jl = np.asarray(jm)[..., 0], np.asarray(jl)[..., 0]
    seen = jm > NEG_INF
    np.testing.assert_array_equal(m.numpy()[~seen], jm[~seen])
    np.testing.assert_array_equal(l.numpy()[~seen], jl[~seen])
    for got, want in ((m.numpy(), jm), (l.numpy(), jl)):
        np.testing.assert_array_less(
            np.abs(got - want)[seen],
            STATS_RTOL * np.maximum(np.abs(want[seen]), 1.0))


@pytest.mark.parametrize("case", FLASH_SWEEP)
def test_port_chunked_matches_jax_chunked(case):
    """The LM's attention on the CPU, in the (B, S, H, D) layout, with
    chunks smaller than the sequence so the online softmax really runs."""

    causal, window, dtype = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype, seed=2)

    def bshd(x):
        return x.transpose(0, 2, 1, 3) if isinstance(x, jnp.ndarray) \
            else x.transpose(1, 2)

    want = jax_chunked(bshd(jq), bshd(jk), bshd(jv), causal=causal,
                       window=window, chunk=48)
    got = chunked_attention(bshd(q), bshd(k), bshd(v), causal=causal,
                            window=window, chunk=48)
    _close(got, want, TOL[dtype])
    ref = chunked_attention(bshd(q), bshd(k), bshd(v), causal=causal,
                            window=window, impl="ref")
    _close(ref, want, TOL[dtype])


@pytest.mark.parametrize("case", RAGGED)
def test_ragged_and_fully_masked_rows(case):
    causal, window = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, "float32", seed=3)
    want = jax_reference(jq, jk, jv, causal=causal, window=window)
    _close(attention_reference(q, k, v, causal=causal, window=window), want,
           TOL["float32"])
    _close(flash_attention(q, k, v, causal=causal, window=window), want,
           TOL["float32"])
    want_c = jax_chunked(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                         jv.transpose(0, 2, 1, 3), causal=causal,
                         window=window, chunk=32)
    _close(want_c.transpose(0, 2, 1, 3), want, TOL["float32"])
    got_c = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, chunk=32)
    _close(got_c.transpose(1, 2), want, TOL["float32"])
    # rows with no visible key read 0 and carry the kernel's empty stats
    out, m, l = attention_reference(q, k, v, causal=causal, window=window,
                                    return_stats=True)
    empty = (m == NEG_INF).numpy()
    assert np.all(out.numpy()[empty] == 0.0)
    assert np.all(l.numpy()[empty] == 0.0)
    assert np.all(l.numpy()[~empty] >= 1.0)


BOUND_CASES = [
    # B, H, KH, Sq, Skv, D, causal, window
    (1, 4, 2, 1000, 1000, 64, True, None),
    (1, 4, 2, 100, 1000, 128, True, None),
    (1, 2, 2, 1000, 1000, 64, True, 64),
    (1, 4, 2, 333, 777, 160, False, 100),
]


def _bf16_route(q, k, v, causal, window, scale, skip_first_tile=False):
    """The kernel's bf16 route step by step on the CPU ([B, H, S, D]): an
    online softmax over 64-key tiles in f32, each tile's P rounded to bf16
    before P V, l summed from the unrounded P, the output rounded to bf16.
    ``skip_first_tile`` plants a fault: rows past key 63 skip keys 0-63."""

    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    row = torch.arange(Sq)[:, None] + (Skv - Sq)
    m = torch.full((B, H, Sq, 1), NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, D))
    for c0 in range(0, Skv, 64):
        col = torch.arange(c0, min(c0 + 64, Skv))[None, :]
        vis = torch.ones((Sq, col.shape[1]), dtype=torch.bool)
        if causal:
            vis &= col <= row
        if window is not None:
            vis &= col > row - window
        if skip_first_tile and c0 == 0:
            vis &= row < 64
        s = q.float() @ kf[:, :, c0:c0 + 64].transpose(-1, -2) * scale
        s = s.masked_fill(~vis, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + p.bfloat16().float() @ vf[:, :, c0:c0 + 64]
        m = m_new
    return (acc / torch.where(l > 0, l, 1.0)).bfloat16()


def _bound(q, k, v, causal, window, scale):
    ref = attention_reference(q.float(), k.float(), v.float(), causal=causal,
                              window=window, sm_scale=scale)
    ref_abs_v = attention_reference(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window,
                                    sm_scale=scale)
    return ref, K.bf16_error_bound(ref, ref_abs_v, k.shape[2], q.shape[3])


@pytest.mark.parametrize("case", BOUND_CASES)
def test_bf16_error_bound_holds_for_the_bf16_route(case):
    causal, window = case[6:]
    _, (q, k, v) = _inputs(case, "bfloat16", seed=5)
    scale = 1.0 / case[5] ** 0.5
    ref, bound = _bound(q, k, v, causal, window, scale)
    err = (_bf16_route(q, k, v, causal, window, scale).float() - ref).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


def _wgmma_route(q, k, v, causal, window, scale):
    """The forward's bf16 ``wgmma`` route step by step on the CPU ([B, H,
    S, D]): scores scaled by scale log2 e in f32, an online softmax in base
    2 over 128-key tiles, each tile's P rounded to bf16 before P V, l summed
    from the unrounded P, the output rounded to bf16; m returned in
    natural-log units (-1e30 for a row that sees no key).  Returns (out,
    m, l)."""

    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    row = torch.arange(Sq)[:, None] + (Skv - Sq)
    m2 = torch.full((B, H, Sq, 1), -torch.inf)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, D))
    c = torch.tensor(scale, dtype=torch.float32) * 1.4426950408889634
    for c0 in range(0, Skv, 128):
        col = torch.arange(c0, min(c0 + 128, Skv))[None, :]
        vis = torch.ones((Sq, col.shape[1]), dtype=torch.bool)
        if causal:
            vis &= col <= row
        if window is not None:
            vis &= col > row - window
        s = (q.float() @ kf[:, :, c0:c0 + 128].transpose(-1, -2)) * c
        s = s.masked_fill(~vis, -torch.inf)
        m_new = torch.maximum(m2, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp2(s - base)
        corr = torch.exp2(m2 - base)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + p.bfloat16().float() @ vf[:, :, c0:c0 + 128]
        m2 = m_new
    out = (acc / torch.where(l > 0, l, 1.0)).bfloat16()
    m = torch.where(m2 == -torch.inf, NEG_INF, m2 * 0.6931471805599453)
    return out, m[..., 0], l[..., 0]


@pytest.mark.parametrize("case", BOUND_CASES + [
    (1, 3, 1, 300, 130, 128, True, None)])
def test_bf16_error_bound_holds_for_the_wgmma_route(case):
    """The base-2 route stays inside the same bound, and its m (back in
    natural-log units) and l agree with the plain statistics within 1e-5
    relative; rows that see no key keep -1e30 and 0 exactly."""

    causal, window = case[6:]
    _, (q, k, v) = _inputs(case, "bfloat16", seed=7)
    scale = 1.0 / case[5] ** 0.5
    ref, bound = _bound(q, k, v, causal, window, scale)
    out, m, l = _wgmma_route(q, k, v, causal, window, scale)
    err = (out.float() - ref).abs()
    assert bool((err <= bound).all()), float((err / bound).max())
    _, m_ref, l_ref = attention_reference(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        sm_scale=scale, return_stats=True)
    seen = m_ref > NEG_INF
    assert torch.equal(m[~seen], m_ref[~seen])
    assert torch.equal(l[~seen], l_ref[~seen])
    for got, want in ((m, m_ref), (l, l_ref)):
        rel = (got - want).abs() / want.abs().clamp(min=1.0)
        assert float(rel[seen].max()) <= STATS_RTOL


def test_bf16_error_bound_rejects_a_skipped_tile():
    """A fault whose error shrinks as rows grow breaks the bound on far
    more of the long rows than the flat 3e-2 bar does (on the CPU,
    331,522 elements against 301 of rows 2000-3999)."""

    case = (1, 8, 2, 4000, 4000, 64, True, None)
    _, (q, k, v) = _inputs(case, "bfloat16", seed=6)
    scale = 1.0 / 8.0
    ref, bound = _bound(q, k, v, True, None, scale)
    out = _bf16_route(q, k, v, True, None, scale, skip_first_tile=True)
    err = (out.float() - ref).abs()[:, :, 2000:]
    over_bound = int((err > bound[:, :, 2000:]).sum())
    over_flat = int((err > TOL["bfloat16"]).sum())
    assert over_bound > 100 * over_flat
    good = _bf16_route(q, k, v, True, None, scale)
    assert bool(((good.float() - ref).abs() <= bound).all())


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_fwd(q, q, q, causal=True, window=None, sm_scale=0.25)


def test_ops_on_cpu_is_differentiable_plain_torch():
    """On the CPU the plain version runs, and autograd goes through it."""

    (_, _, _), (q, k, v) = _inputs(FLASH_SWEEP[1], "float32", seed=4)
    q.requires_grad_()
    flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
