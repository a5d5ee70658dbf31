"""The Hopper flash-attention kernels against their plain versions.

These tests need the card (the CUDA kernel has no CPU mode) and skip
without one; they import nothing of JAX, so they run on the machine with
the card as they are:

    python -m pytest -q tests/test_torch_flash_attention_cuda.py

Bars: out within 1e-5 max abs in f32 and 3e-2 in bf16 of the plain version
(in f32) on unit-normal inputs (the bars ``tests/test_kernels.py`` sets for
the Pallas kernel, 2e-6 loosened to 1e-5 in f32 for another summation
order), and in bf16 also within ``kernel.bf16_error_bound`` per element,
which scales with the row; ``m`` and ``l`` within 1e-5 relative (of
max(|x|, 1)) of the plain version's row max and row sum on rows that see a
key; rows that see no key read out 0, m -1e30 and l 0.

The backward kernels (dQ, dK/dV) are held against ``attention_backward``
computed in f32 from the same inputs and the same m, l and delta: in f32
within 1e-5 times max(1, max |gradient|) (another summation order), in
bf16 within ``kernel.bf16_bwd_error_bound`` per element (P and dS enter
their products rounded to bf16).  Two launches give the same bits.

Every route is held to these bars: ``f32``, ``mma`` and the warp-specialised
``wgmma`` kernels (the forward, dQ and dK/dV at head dims 64 and 128),
each test checking that its launch went through the route ``kernel.route``
picks, at query-head groups of 1, 3 and 4.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF,
    attention_backward,
    attention_reference,
)

STATS_RTOL = 1e-5
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}

CASES = [
    # B, H, KH, Sq, Skv, D, causal, window  (tests/test_kernels.py sweep)
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 4, 1, 64, 64, 32, False, None),
    (1, 2, 2, 128, 128, 64, True, 64),
    (1, 2, 2, 256, 256, 64, True, 32),
    (1, 2, 1, 64, 256, 64, True, None),
    (1, 2, 2, 128, 128, 128, True, None),
    (1, 8, 2, 64, 64, 32, True, None),
    # ragged tails, windows across tiles, Sq > Skv, other head dims
    (1, 3, 1, 1000, 1000, 64, True, None),
    (2, 4, 2, 100, 1000, 128, True, None),
    (1, 2, 2, 1000, 1000, 64, True, 64),
    (1, 2, 1, 93, 37, 16, True, None),
    (1, 4, 2, 37, 93, 160, False, 20),
    (1, 2, 2, 77, 77, 256, True, 1),
    (1, 2, 2, 1, 300, 128, True, None),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, dtype, layout, device, seed=0):
    B, H, KH, Sq, Skv, D = case[:6]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def mk(heads, S):
        x = torch.randn((B, heads, S, D), generator=gen, device=device)
        x = x.to(dtype)
        return x if layout == "bhsd" else x.transpose(1, 2).contiguous()

    return mk(H, Sq), mk(KH, Skv), mk(KH, Skv)


def _to_bhsd(x, layout):
    return x if layout == "bhsd" else x.transpose(1, 2)


def _check(case, dtype, layout):
    device = _card()
    causal, window = case[6], case[7]
    q, k, v = _inputs(case, dtype, layout, device)
    scale = 1.0 / case[5] ** 0.5
    before = (K.launch_count, K.fwd_wgmma_launch_count)
    out, m, l = K.flash_fwd(q, k, v, causal=causal, window=window,
                            sm_scale=scale, layout=layout)
    torch.cuda.synchronize()
    wgmma = K.route("fwd", dtype, case[5]) == "wgmma"
    assert (K.launch_count, K.fwd_wgmma_launch_count) == \
        (before[0] + 1, before[1] + wgmma)
    assert out.dtype == dtype and out.shape == q.shape
    q, k, v = (_to_bhsd(t, layout).float() for t in (q, k, v))
    ref, m_ref, l_ref = attention_reference(
        q, k, v, causal=causal, window=window, sm_scale=scale,
        return_stats=True)
    err = (_to_bhsd(out, layout).float() - ref).abs()
    assert err.max().item() <= TOL[dtype], err.max().item()
    if dtype == torch.bfloat16:
        bound = K.bf16_error_bound(
            ref, attention_reference(q, k, v.abs(), causal=causal,
                                     window=window, sm_scale=scale),
            k.shape[2], q.shape[3])
        assert bool((err <= bound).all()), (err / bound).max().item()
    seen = m_ref > NEG_INF
    assert torch.equal(m[~seen], m_ref[~seen])
    assert torch.equal(l[~seen], l_ref[~seen])
    for got, want in ((m, m_ref), (l, l_ref)):
        bad = (got - want).abs() > STATS_RTOL * want.abs().clamp(min=1.0)
        assert not bool((bad & seen).any()), float(
            (got - want).abs()[seen].max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_bhsd(case, dtype):
    _check(case, dtype, "bhsd")


@pytest.mark.parametrize("case", CASES[::2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_bshd(case, dtype):
    _check(case, dtype, "bshd")


def test_kernel_at_the_lm_prefill_shape():
    """phi4-mini's prefill attention, bf16, causal, in the LM's layout."""

    _check((1, 24, 8, 4000, 4000, 128, True, None), torch.bfloat16, "bshd")


def test_ops_routes_cuda_tensors_to_the_kernel():
    device = _card()
    q, k, v = _inputs(CASES[1], torch.float32, "bhsd", device)
    before = K.launch_count
    out = flash_attention(q, k, v, causal=True)
    assert K.launch_count == before + 1
    ref = attention_reference(q, k, v, causal=True)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


def test_kernel_raises_on_what_it_does_not_take():
    device = _card()
    q, k, v = _inputs(CASES[1], torch.float32, "bhsd", device)
    with pytest.raises(NotImplementedError, match="ops.flash_attention"):
        K.flash_fwd(q.clone().requires_grad_(), k, v, causal=True,
                    window=None, sm_scale=0.2)
    with pytest.raises(ValueError, match="head dim"):
        K.flash_fwd(q[..., :24], k[..., :24], v[..., :24], causal=True,
                    window=None, sm_scale=0.2)
    with pytest.raises(TypeError):
        K.flash_fwd(q.half(), k.half(), v.half(), causal=True, window=None,
                    sm_scale=0.2)
    wide = torch.zeros(q.shape[:3] + (72,), device=device)
    with pytest.raises(ValueError, match="aligned"):  # 8 bytes off
        K.flash_fwd(wide[..., 2:66], k, v, causal=True, window=None,
                    sm_scale=0.2)


BWD_CASES = [c for c in CASES if c[5] <= K.MAX_BWD_HEAD_DIM] + [
    (1, 2, 2, 50, 50, 16, False, 0),     # no row sees a key
]
BWD_F32_TOL = 1e-5


def _bwd_check(case, dtype, layout):
    device = _card()
    causal, window = case[6], case[7]
    q, k, v = _inputs(case, dtype, layout, device)
    do = _inputs(case, dtype, layout, device, seed=1)[0]
    scale = 1.0 / case[5] ** 0.5
    out, m, l = K.flash_fwd(q, k, v, causal=causal, window=window,
                            sm_scale=scale, layout=layout)
    delta = (do.float() * out.float()).sum(-1)
    delta = (delta if layout == "bhsd" else delta.transpose(1, 2)) \
        .contiguous()
    kw = dict(causal=causal, window=window, sm_scale=scale, layout=layout)
    before = (K.dq_launch_count, K.dkv_launch_count,
              K.dq_wgmma_launch_count, K.dkv_wgmma_launch_count)
    dq = K.flash_bwd_dq(q, k, v, do, m, l, delta, **kw)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, m, l, delta, **kw)
    dq2 = K.flash_bwd_dq(q, k, v, do, m, l, delta, **kw)
    dk2, dv2 = K.flash_bwd_dkv(q, k, v, do, m, l, delta, **kw)
    torch.cuda.synchronize()
    wgmma = K.route("dkv", dtype, case[5]) == "wgmma"
    assert K.route("dq", dtype, case[5]) == K.route("dkv", dtype, case[5])
    assert (K.dq_launch_count, K.dkv_launch_count,
            K.dq_wgmma_launch_count, K.dkv_wgmma_launch_count) == \
        (before[0] + 2, before[1] + 2, before[2] + 2 * wgmma,
         before[3] + 2 * wgmma)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)
    assert dq.shape == q.shape and dk.shape == k.shape and \
        dv.shape == v.shape and dq.dtype == dk.dtype == dtype
    bq, bk, bv, bdo = (_to_bhsd(t, layout) for t in (q, k, v, do))
    ref = attention_backward(bq.float(), bk.float(), bv.float(),
                             bdo.float(), m, l, delta, causal=causal,
                             window=window, sm_scale=scale)
    got = [_to_bhsd(t, layout).float() for t in (dq, dk, dv)]
    if dtype == torch.float32:
        for name, g, r in zip("qkv", got, ref):
            tol = BWD_F32_TOL * max(1.0, float(r.abs().max()))
            err = float((g - r).abs().max())
            assert err <= tol, (name, err, tol)
    else:
        bounds = K.bf16_bwd_error_bound(bq, bk, bv, bdo, m, l, delta, ref,
                                        causal=causal, window=window,
                                        sm_scale=scale)
        for name, g, r, b in zip("qkv", got, ref, bounds):
            err = (g - r).abs()
            assert bool((err <= b).all()), (name, float((err / b).max()))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_bhsd(case, dtype):
    _bwd_check(case, dtype, "bhsd")


@pytest.mark.parametrize("case", BWD_CASES[::2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_bshd(case, dtype):
    _bwd_check(case, dtype, "bshd")


def test_backward_kernels_at_the_lm_train_shape():
    """phi4-mini's training attention (one sequence of 4096), bf16, causal,
    in the LM's layout."""

    _bwd_check((1, 24, 8, 4096, 4096, 128, True, None), torch.bfloat16,
               "bshd")


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_gradients_through_ops_use_the_kernels(layout):
    """``ops.flash_attention`` is differentiable on the card: autograd
    launches the forward once and each backward kernel once, and the
    gradients match plain autograd through ``attention_reference``."""

    device = _card()
    case = (2, 4, 2, 100, 130, 64, True, None)
    q, k, v = _inputs(case, torch.float32, layout, device)
    w = torch.cos(torch.arange(64, device=device, dtype=torch.float32))
    K.reset_launch_count()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, layout=layout)
    (out * w).sum().backward()
    assert (K.launch_count, K.dq_launch_count, K.dkv_launch_count) == \
        (1, 1, 1)
    plain = [_to_bhsd(t, layout).clone().requires_grad_() for t in (q, k, v)]
    (attention_reference(*plain, causal=True) * w).sum().backward()
    for a, b in zip(leaves, plain):
        err = float((_to_bhsd(a.grad, layout) - b.grad).abs().max())
        assert err <= BWD_F32_TOL * max(1.0, float(b.grad.abs().max())), err


def test_backward_kernels_raise_on_what_they_do_not_take():
    device = _card()
    q, k, v = _inputs(CASES[1], torch.float32, "bhsd", device)
    B, H, Sq = q.shape[:3]
    stats = [torch.zeros((B, H, Sq), device=device) for _ in range(3)]
    kw = dict(causal=True, window=None, sm_scale=0.125)
    with pytest.raises(ValueError, match="delta"):
        K.flash_bwd_dq(q, k, v, q, stats[0], stats[1], stats[2][:, :, :-1],
                       **kw)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros((1, 2, 8, 176), device=device)
        K.flash_bwd_dkv(wide, wide, wide, wide, *[
            torch.zeros((1, 2, 8), device=device)] * 3, **kw)
    with pytest.raises(TypeError):
        K.flash_bwd_dq(q, k, v, q.bfloat16(), *stats, **kw)


# The warp-specialised wgmma routes (forward, dQ and dK/dV at head dims 64
# and 128) and the mma.sync route that keeps head dim 160: query-head groups
# of 1, 3 and 4; causal and windowed masks, Sq != Skv, ragged tails at 1000
# and 4000, rows that see no key; both layouts.
ROUTE_DIMS = [64, 128, 160]
ROUTE_GROUPS = [1, 3, 4]
ROUTE_MASKS = {
    # name: (B, KH, Sq, Skv, causal, window)
    "causal_1000": (1, 2, 1000, 1000, True, None),
    "window_1000": (1, 1, 1000, 1000, True, 100),
    "short_q": (2, 1, 100, 1000, True, None),
    "no_key_rows": (1, 1, 300, 130, True, None),
    "window_only": (1, 1, 333, 777, False, 64),
}


def _route_case(d, g, mask):
    B, KH, Sq, Skv, causal, window = ROUTE_MASKS[mask]
    return (B, g * KH, KH, Sq, Skv, d, causal, window)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("mask", sorted(ROUTE_MASKS))
@pytest.mark.parametrize("g", ROUTE_GROUPS)
@pytest.mark.parametrize("d", ROUTE_DIMS)
def test_bf16_forward_routes_match_plain(d, g, mask, layout):
    _check(_route_case(d, g, mask), torch.bfloat16, layout)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("mask", sorted(ROUTE_MASKS))
@pytest.mark.parametrize("g", ROUTE_GROUPS)
@pytest.mark.parametrize("d", ROUTE_DIMS)
def test_bf16_dkv_routes_match_plain(d, g, mask, layout):
    _bwd_check(_route_case(d, g, mask), torch.bfloat16, layout)


@pytest.mark.parametrize("d", [64, 128])
def test_routes_at_the_4000_tail(d):
    """A ragged tail of 4000 rows (not a multiple of the 128-row tiles) at
    phi4-mini's group of 3, forward, dQ and dK/dV."""

    case = (1, 6, 2, 4000, 4000, d, True, None)
    _check(case, torch.bfloat16, "bshd")
    before = K.dq_wgmma_launch_count
    _bwd_check(case, torch.bfloat16, "bshd")
    assert K.dq_wgmma_launch_count == before + 2


@pytest.mark.parametrize("d", [64, 128, 160])
def test_dq_route_by_head_dim(d):
    """bf16 dQ takes the wgmma route at head dims 64 and 128 and keeps
    mma.sync at 160 (stablelm-12b's), and is held to its bar on each."""

    _card()
    want = "mma" if d == 160 else "wgmma"
    assert K.route("dq", torch.bfloat16, d) == want
    before = K.dq_wgmma_launch_count
    _bwd_check((1, 4, 2, 333, 333, d, True, None), torch.bfloat16, "bhsd")
    assert K.dq_wgmma_launch_count == before + 2 * (want == "wgmma")
