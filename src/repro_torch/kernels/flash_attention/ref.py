"""Plain PyTorch version of the flash-attention forward kernel.

Semantics contract, the JAX package's ``attention_reference``, shared with
``csrc/flash_attention_fwd.cu``:

* ``q``: f32/bf16[B, H, S_q, D]; ``k``/``v``: [B, KH, S_kv, D] with
  ``H % KH == 0`` (GQA: query-head group ``H // KH`` shares one KV head).
* ``causal=True`` masks ``col > row + (S_kv - S_q)`` (aligned suffixes, so a
  single decode row attends to the whole cache).
* ``window=w`` additionally masks ``col <= row_abs - w`` (sliding-window /
  Mistral-style SWA).  ``window=None`` means full attention.
* softmax is computed in f32 regardless of input dtype; output cast back.
* Rows with no visible keys (fully masked) return zeros.

With ``return_stats=True`` it also returns the kernel's row statistics in
f32 ``[B, H, S_q]``: ``m``, the row's largest scaled score, and ``l``, the
row's sum of ``exp(s - m)``.  A row with no visible key has ``m = -1e30``
and ``l = 0``, as the kernel (and the Pallas kernel) leaves them.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_reference", "NEG_INF"]

NEG_INF = -1e30  # the kernels' masked score and empty-row max


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

    # [B, KH, G, Sq, Skv] scores: the group shares its KV head without a
    # materialised repeat.
    qg = q.to(torch.float32).reshape(B, KH, group, Sq, D)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.to(torch.float32)) * scale

    dev = q.device
    row = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
    col = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    s = s.masked_fill(~mask, -torch.inf)

    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # fully-masked rows
    p = torch.exp(s - m)
    del s
    l = torch.sum(p, dim=-1, keepdim=True)
    # Normalising the [.., Sq, D] output instead of p saves a pass over the
    # [.., Sq, Skv] slab; a fully-masked row has p = 0 and reads 0.
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.to(torch.float32))
    out = out / torch.clamp(l, min=1e-30)
    out = out.reshape(B, H, Sq, D).to(q.dtype)
    if not return_stats:
        return out
    seen = mask.any(dim=-1)
    m = torch.where(seen, m.reshape(B, H, Sq), NEG_INF)
    l = torch.where(seen, l.reshape(B, H, Sq), 0.0)
    return out, m, l
