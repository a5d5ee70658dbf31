"""The LM families' card paths: the flash forward kernel (B2) at the shapes
the mla, hybrid and encdec families give it, the backward kernels (B3, B4)
at the shapes their training gives them, and the MoE dispatch at
mixtral-8x22b's full width, forward and backward.

These tests need the card (the CUDA kernel has no CPU mode) and skip
without one; they import nothing of JAX, so they run on the machine with
the card as they are:

    python -m pytest -q tests/test_torch_families_cuda.py

B2 is held to its plain version on the same inputs in f32: in f32 within
1e-5 (another summation order); in bf16 per element within the kernel's
own error bound (``kernel.bf16_error_bound``, capped at 3e-2).  The MoE
layer (bf16, ``capacity_factor=0.5``, so experts overflow) is held to a
float64 oracle that keeps each expert's first ``cap`` arrivals, on the
routing the layer chose, within a first-order bound of its bf16
roundings (``_expert_bound``); a pair clobbered as the JAX package's clamp
clobbers it (ROADMAP C11) would be off by its whole gated output.  Two
calls are bit-identical.

B3 and B4 are held per element to the plain backward (``attention_backward``
in f32 on the same bf16 inputs and statistics) within the kernels' own
bound (``kernel.bf16_bwd_error_bound``) at MLA's q.k head dim 96 (the
``mma`` route), hymba's 25/5 heads at D 64 with its 1024-key window, and
whisper's 448 decoder positions against its 1500 frames.  The MoE layer's
backward (bf16, the configs' capacity factor) gives the same bits twice:
every index-accumulate in it adds at most two terms onto zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import (
    attention_backward,
    attention_reference,
)
from repro_torch.models import blocks
from repro_torch.models.registry import get_config

BF16_UNIT = 2.0 ** -8
F32_UNIT = 2.0 ** -24


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


# (B, H, KH, Sq, Skv, D, causal, window): MLA's q.k head dim 96 (the mma
# route) at S 1000; whisper's cross-attention with more queries than keys
# and its decode step (Sq 1) against the 1500 frames; hymba's 25/5 heads
# with a window.
SHAPES = [
    (1, 4, 4, 1000, 1000, 96, True, None),
    (2, 4, 4, 1000, 375, 64, False, None),
    (4, 16, 16, 1, 1500, 64, False, None),
    (1, 25, 5, 300, 300, 64, True, 64),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_matches_plain_at_family_shapes(shape, dtype):
    device = _card()
    B, H, KH, Sq, Skv, D, causal, window = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(Sq * 7 + Skv + D)
    q, k, v = (torch.randn(s, generator=gen, device=device).to(dtype)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    scale = 1.0 / D ** 0.5
    before = K.launch_count
    out, _, _ = K.flash_fwd(q, k, v, causal=causal, window=window,
                            sm_scale=scale, layout="bshd")
    torch.cuda.synchronize()
    assert K.launch_count == before + 1
    want_route = "f32" if dtype == torch.float32 else (
        "wgmma" if D in K.WGMMA_HEAD_DIMS else "mma")
    assert K.route("fwd", dtype, D) == want_route
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    ref = attention_reference(qt, kt, vt, causal=causal, window=window,
                              sm_scale=scale)
    err = (out.transpose(1, 2).float() - ref).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        ref_abs_v = attention_reference(qt, kt, vt.abs(), causal=causal,
                                        window=window, sm_scale=scale)
        bar = K.bf16_error_bound(ref, ref_abs_v, Skv, D).clamp(max=3e-2)
        assert int((err > bar).sum()) == 0, float((err / bar).max())


def _expert_bound(xd, wg, wu, wd):
    """float64 output ``y`` of one expert on the rows ``xd`` and the first-
    order bound on |computed - y| per element of the bf16 layer: h and u
    rounded to bf16 after f32 sums over E terms, silu(h) and silu(h) * u
    rounded to bf16, the Wd product's f32 sum over F terms, y rounded to
    bf16 (u = 2^-8, gamma_n = n 2^-24; |silu'| <= 1.1)."""

    silu = torch.nn.functional.silu
    gamma_e = xd.shape[1] * F32_UNIT
    gamma_f = wd.shape[0] * F32_UNIT
    h, uu = xd @ wg, xd @ wu
    dh = BF16_UNIT * h.abs() + gamma_e * (xd.abs() @ wg.abs())
    du = BF16_UNIT * uu.abs() + gamma_e * (xd.abs() @ wu.abs())
    s = silu(h)
    a = s * uu
    ds = BF16_UNIT * s.abs() + 1.1 * dh
    da = BF16_UNIT * a.abs() + ds * uu.abs() + s.abs() * du
    y = a @ wd
    dy = BF16_UNIT * y.abs() + gamma_f * (a.abs() @ wd.abs()) \
        + da @ wd.abs()
    return y, dy


def test_moe_apply_full_width_drops_at_capacity():
    """mixtral-8x22b's MoE layer at its full width (d_model 6144, 8
    experts of d_ff 16384, top 2), 512 tokens, capacity factor 0.5."""

    device = _card()
    cfg = dataclasses.replace(get_config("mixtral_8x22b"),
                              capacity_factor=0.5)
    E, X, Fd, T = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, 512
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def w(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale) \
            .to(torch.bfloat16)

    p = {"router": w(E, X), "w_gate": w(X, E, Fd), "w_up": w(X, E, Fd),
         "w_down": w(X, Fd, E, scale=0.02 / (2 * cfg.n_layers) ** 0.5)}
    x = torch.randn((1, T, E), generator=gen, device=device) \
        .to(torch.bfloat16)
    got = blocks.moe_apply(p, x, cfg)
    again = blocks.moe_apply(p, x, cfg)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (1, T, E)
    assert torch.equal(got, again)

    # The routing the layer chose, and the first cap arrivals an expert.
    cap = blocks.moe_capacity(cfg, T)
    order, e_s, w_s, rank, keep = blocks._route(x.reshape(T, E),
                                                p["router"], cfg, cap)
    pairs = torch.empty_like(order)
    pairs[order] = torch.arange(T * 2, device=device)
    choice = e_s[pairs].reshape(T, 2).cpu().numpy()
    gates = w_s[pairs].reshape(T, 2).double().cpu().numpy()
    arrived = np.zeros(X, dtype=np.int64)
    keep_tok = np.zeros((T, 2))
    for t in range(T):
        for i in range(2):
            e = choice[t, i]
            keep_tok[t, i] = arrived[e] < cap
            arrived[e] += 1
    assert (arrived > cap).any(), "the case must overflow an expert"
    assert int(keep.sum()) == int(keep_tok.sum())

    # float64 oracle on the same bf16 values: the kept pairs' gated expert
    # outputs; the bar adds each pair's gated bound, the f32 sum of the
    # pairs and the output's rounding (u |out|), with 10% for second-order
    # terms.
    xd = x.reshape(T, E).double()
    want = torch.zeros((T, E), dtype=torch.float64, device=device)
    bar = torch.zeros_like(want)
    for e in range(X):
        wg, wu, wd = (p[n][e].double() for n in ("w_gate", "w_up",
                                                  "w_down"))
        for i in range(2):
            sel = np.flatnonzero((choice[:, i] == e) & (keep_tok[:, i] > 0))
            if sel.size == 0:
                continue
            rows = torch.from_numpy(sel).to(device)
            y, dy = _expert_bound(xd[rows], wg, wu, wd)
            g = torch.from_numpy(gates[sel, i]).to(device)[:, None]
            want[rows] += g * y
            bar[rows] += g * dy
    bar = 1.1 * (bar + BF16_UNIT * want.abs())
    err = (got.reshape(T, E).double() - want).abs()
    assert int((err > bar).sum()) == 0, float((err / bar).max())


# (B, H, KH, Sq, Skv, D, causal, window) of the families' training: MLA's
# q.k head dim 96 (mma route), hymba's windowed 25/5 heads, whisper's
# decoder against its frames.
BWD_SHAPES = [
    (1, 8, 8, 1024, 1024, 96, True, None),
    (1, 25, 5, 2048, 2048, 64, True, 1024),
    (2, 16, 16, 448, 1500, 64, False, None),
]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_backward_matches_plain_at_family_training_shapes(shape):
    device = _card()
    B, H, KH, Sq, Skv, D, causal, window = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(Sq * 3 + Skv + D)
    q, k, v, do = (torch.randn(s, generator=gen, device=device)
                   .to(torch.bfloat16)
                   for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D),
                             (B, Sq, H, D)))
    scale = 1.0 / D ** 0.5
    kw = dict(causal=causal, window=window, sm_scale=scale, layout="bshd")
    out, m, l = K.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = (K.dq_launch_count, K.dkv_launch_count)
    dq = K.flash_bwd_dq(q, k, v, do, m, l, delta, **kw)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, m, l, delta, **kw)
    torch.cuda.synchronize()
    assert (K.dq_launch_count, K.dkv_launch_count) == (before[0] + 1,
                                                       before[1] + 1)
    want_route = "wgmma" if D in K.WGMMA_HEAD_DIMS else "mma"
    assert K.route("dq", torch.bfloat16, D) == want_route
    assert K.route("dkv", torch.bfloat16, D) == want_route
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    ref = attention_backward(qt.float(), kt.float(), vt.float(), dot.float(),
                             m, l, delta, causal=causal, window=window,
                             sm_scale=scale)
    bars = K.bf16_bwd_error_bound(qt, kt, vt, dot, m, l, delta, ref,
                                  causal=causal, window=window,
                                  sm_scale=scale)
    for got, want, bar in zip((dq, dk, dv), ref, bars):
        assert got.dtype == torch.bfloat16
        err = (got.transpose(1, 2).float() - want).abs()
        assert int((err > bar).sum()) == 0, float((err / bar).max())


def test_moe_backward_full_width_is_bit_identical():
    """mixtral-8x22b's MoE layer at its full width, 2048 tokens at the
    capacity factor it trains at (1.25), bf16: two backward
    passes give the same gradient bits for the input, the router and every
    expert weight, and the router gets a gradient."""

    device = _card()
    cfg = get_config("mixtral_8x22b")
    E, X, Fd, T = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, 2048
    gen = torch.Generator(device=device)
    gen.manual_seed(1)

    def w(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale) \
            .to(torch.bfloat16)

    p = {"router": w(E, X), "w_gate": w(X, E, Fd), "w_up": w(X, E, Fd),
         "w_down": w(X, Fd, E, scale=0.02 / (2 * cfg.n_layers) ** 0.5)}
    x = torch.randn((1, T, E), generator=gen, device=device) \
        .to(torch.bfloat16)
    dy = torch.randn((1, T, E), generator=gen, device=device) \
        .to(torch.bfloat16)

    def grads():
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xl = x.detach().requires_grad_()
        out = blocks.moe_apply(leaves, xl, cfg)
        out.backward(dy)
        torch.cuda.synchronize()
        return [xl.grad] + [leaves[k].grad for k in sorted(leaves)]

    first, second = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert float(first[1 + sorted(p).index("router")].abs().max()) > 0
