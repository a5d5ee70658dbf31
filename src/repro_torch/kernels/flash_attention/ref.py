"""Plain PyTorch versions of the flash-attention kernels: the forward
(:func:`attention_reference`) and the backward (:func:`attention_backward`).

Semantics contract, the JAX package's ``attention_reference``, shared with
``csrc/flash_attention_{fwd,bwd}.cu``:

* ``q``: f32/bf16[B, H, S_q, D]; ``k``/``v``: [B, KH, S_kv, D] with
  ``H % KH == 0`` (GQA: query-head group ``H // KH`` shares one KV head).
* ``causal=True`` masks ``col > row + (S_kv - S_q)`` (aligned suffixes, so a
  single decode row attends to the whole cache).
* ``window=w`` additionally masks ``col <= row_abs - w`` (sliding-window /
  Mistral-style SWA).  ``window=None`` means full attention.
* softmax is computed in f32 regardless of input dtype (in f64 for f64
  inputs); output cast back.
* Rows with no visible keys (fully masked) return zeros.

With ``return_stats=True`` it also returns the kernel's row statistics in
f32 ``[B, H, S_q]``: ``m``, the row's largest scaled score, and ``l``, the
row's sum of ``exp(s - m)``.  A row with no visible key has ``m = -1e30``
and ``l = 0``, as the kernel (and the Pallas kernel) leaves them.

:func:`attention_backward` is the math of the Pallas ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` with ``ops.py``'s GQA group sum: from those statistics
and ``delta = rowsum(dO * O)`` it recomputes ``P = exp(s - m) / l`` (0
where masked or where ``l = 0``) and returns ``dq`` and the group-summed
``dk``, ``dv``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_reference", "attention_backward", "visible_mask",
           "NEG_INF"]

NEG_INF = -1e30  # the kernels' masked score and empty-row max


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def visible_mask(Sq: int, Skv: int, causal: bool, window: Optional[int],
                 device) -> torch.Tensor:
    """[Sq, Skv] bool: which keys each query row sees (suffix-aligned
    causal and window masks)."""

    row = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    col = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    return mask


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    return_stats: bool = False,
):
    B, H, Sq, D = q.shape
    Bk, KH, Skv, Dk = k.shape
    if (B, D) != (Bk, Dk) or H % KH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree")
    group = H // KH
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    acc = _acc_dtype(q)

    # [B, KH, G, Sq, Skv] scores: the group shares its KV head without a
    # materialised repeat.
    qg = q.to(acc).reshape(B, KH, group, Sq, D)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.to(acc)) * scale

    mask = visible_mask(Sq, Skv, causal, window, q.device)
    s = s.masked_fill(~mask, -torch.inf)

    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # fully-masked rows
    p = torch.exp(s - m)
    del s
    l = torch.sum(p, dim=-1, keepdim=True)
    # Normalising the [.., Sq, D] output instead of p saves a pass over the
    # [.., Sq, Skv] slab; a fully-masked row has p = 0 and reads 0.
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.to(acc))
    out = out / torch.clamp(l, min=1e-30)
    out = out.reshape(B, H, Sq, D).to(q.dtype)
    if not return_stats:
        return out
    seen = mask.any(dim=-1)
    m = torch.where(seen, m.reshape(B, H, Sq), NEG_INF)
    l = torch.where(seen, l.reshape(B, H, Sq), 0.0)
    return out, m, l


def attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
):
    """``(dq, dk, dv)`` of attention from the forward's row statistics.

    ``q``, ``do``: [B, H, Sq, D]; ``k``, ``v``: [B, KH, Skv, D]; ``m``,
    ``l``, ``delta``: f32 [B, H, Sq] (``m`` the row's largest scaled score,
    ``l`` its sum of ``exp(s - m)``, ``delta = rowsum(do * out)``).  ``dq``
    comes out in q's dtype, ``dk`` and ``dv`` summed over each query-head
    group in k's and v's dtypes; the sums are taken in f32 (f64 for f64
    inputs)."""

    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    acc = _acc_dtype(q)
    qg = q.to(acc).reshape(B, KH, G, Sq, D)
    dog = do.to(acc).reshape(B, KH, G, Sq, D)
    kf, vf = k.to(acc), v.to(acc)
    m = m.to(acc).reshape(B, KH, G, Sq, 1)
    l = l.to(acc).reshape(B, KH, G, Sq, 1)
    delta = delta.to(acc).reshape(B, KH, G, Sq, 1)

    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kf) * scale
    mask = visible_mask(Sq, Skv, causal, window, q.device) & (l > 0)
    p = torch.where(mask, torch.exp(s - m) / torch.where(l > 0, l, 1.0), 0.0)
    del s
    dp = torch.einsum("bkgqd,bkcd->bkgqc", dog, vf)
    ds = p * (dp - delta) * scale
    del dp
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, kf).reshape(B, H, Sq, D)
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qg)
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
