"""Differentiable flash attention: the ``torch.autograd.Function`` around the
Hopper kernels, the counterpart of the JAX package's ``jax.custom_vjp``
(``repro.kernels.flash_attention.ops``).

On a CUDA tensor the forward launches ``flash_fwd`` and keeps ``q, k, v,
out, m, l``; the backward computes ``delta = rowsum(dO * O)`` in f32 with
one PyTorch reduction (as the JAX package computes it outside Pallas) and
launches ``flash_bwd_dq`` and ``flash_bwd_dkv``, the latter already summing
each query-head group onto its KV head.  On a CPU tensor the same Function
runs the kernels' plain versions (``attention_reference`` with its
statistics, then ``attention_backward``).  Both ``[B, H, S, D]`` and the
LM's ``[B, S, H, D]`` layout are taken as they are.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import (
    attention_backward,
    attention_reference,
)

__all__ = ["flash_attention", "FlashAttention"]


def _to_bhsd(t: torch.Tensor, layout: str) -> torch.Tensor:
    return t if layout == "bhsd" else t.transpose(1, 2)


def _kernel_takes(t: torch.Tensor, layout: str) -> bool:
    """Whether the kernels read ``t`` through its strides as it is."""

    size = t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and not any(
        s * size % 16 for s in K._bhsd_strides(t, layout))


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, causal, window, sm_scale, layout) -> out``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, layout):
        if q.is_cuda:
            out, m, l = K.flash_fwd(q, k, v, causal=causal, window=window,
                                    sm_scale=sm_scale, layout=layout)
        else:
            out, m, l = attention_reference(
                _to_bhsd(q, layout), _to_bhsd(k, layout), _to_bhsd(v, layout),
                causal=causal, window=window, sm_scale=sm_scale,
                return_stats=True)
            out = _to_bhsd(out, layout)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, window, sm_scale, layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, window, sm_scale, layout = ctx.args
        if do.dtype != q.dtype:
            do = do.to(q.dtype)
        # delta = rowsum(dO * O) in f32, as [B, H, Sq]
        delta = (do.float() * out.float()).sum(-1)
        if layout == "bshd":
            delta = delta.transpose(1, 2)
        delta = delta.contiguous()
        if q.is_cuda:
            if not _kernel_takes(do, layout):
                do = do.contiguous()
            kw = dict(causal=causal, window=window, sm_scale=sm_scale,
                      layout=layout)
            dq = K.flash_bwd_dq(q, k, v, do, m, l, delta, **kw)
            dk, dv = K.flash_bwd_dkv(q, k, v, do, m, l, delta, **kw)
        else:
            dq, dk, dv = attention_backward(
                _to_bhsd(q, layout), _to_bhsd(k, layout), _to_bhsd(v, layout),
                _to_bhsd(do, layout), m, l, delta, causal=causal,
                window=window, sm_scale=sm_scale)
            dq, dk, dv = (_to_bhsd(t, layout) for t in (dq, dk, dv))
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    layout: str = "bhsd",
) -> torch.Tensor:
    """Blockwise attention, differentiable.  In the ``"bhsd"`` layout q is
    [B,H,Sq,D] and k/v [B,KH,Skv,D]; in ``"bshd"`` [B,Sq,H,D] and
    [B,Skv,KH,D].  The output is in q's layout.

    A CPU tensor gets the plain versions; a CUDA tensor gets the kernels,
    which raise on what they do not take."""

    if layout not in K.LAYOUTS:
        raise ValueError(f"layout must be one of {K.LAYOUTS}, got {layout!r}")
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return FlashAttention.apply(q, k, v, causal, window, sm_scale, layout)
