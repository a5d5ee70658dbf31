"""The Hopper flash-attention forward kernel against its plain version.

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
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF,
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
    before = K.launch_count
    out, m, l = K.flash_fwd(q, k, v, causal=causal, window=window,
                            sm_scale=scale, layout=layout)
    torch.cuda.synchronize()
    assert K.launch_count == before + 1
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
    with pytest.raises(NotImplementedError, match="B3/B4"):
        flash_attention(q.clone().requires_grad_(), k, v)
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
