"""Shared model substrate: configs, norms, rope, attention, losses.

Layout conventions (the JAX package's, kept at every public function):

* activations are ``(batch, seq, d_model)``; attention internals use
  ``(batch, seq, heads, head_dim)``;
* softmax/statistics in f32, matmuls in the config's compute dtype.

The prefill/train attention entry point, :func:`chunked_attention`, is
differentiable.  On a CUDA tensor it goes through the Hopper
flash-attention kernels (``ops.flash_attention``: the forward kernel, and
the dQ and dK/dV kernels in the backward); on a CPU tensor through a port
of the JAX package's chunked online-softmax and its custom VJP (the
two-pass flash backward over KV chunks, O(Sq * chunk) live memory);
``impl="ref"`` runs the kernels' plain version (``attention_reference``,
plain autograd) on either device.  Decode attention over the KV cache is
plain PyTorch: no kernel lies behind it.  On a cache whose slots are cut
over a mesh axis (ROADMAP A10e-2) each rank attends its block with
:func:`decode_attention_partial` and :func:`decode_attention_join` joins
the blocks' softmax statistics over the axis (split-softmax decode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch.census import vmem_region
from repro_torch.parallel import collectives as C

__all__ = [
    "ArchConfig",
    "SHAPES",
    "ATTENTION_IMPLS",
    "rms_norm",
    "rope",
    "apply_rope",
    "chunked_attention",
    "decode_attention",
    "decode_attention_partial",
    "decode_attention_join",
    "cross_entropy_loss",
    "dtype_of",
]


# ---------------------------------------------------------------------------
# Architecture config (one instance per assigned architecture)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | mla | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention
    window: Optional[int] = None    # sliding-window attention
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MLA (MiniCPM3 / DeepSeek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    d_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                # precomputed frame embeddings (stub)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    mlp_type: str = "swiglu"        # swiglu | gelu (whisper)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple (Megatron-style); padded columns
        are masked to -1e30 in the head."""

        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded per-step
        state?"""

        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Parameter count (embeddings + layers), from the param specs."""

        from repro_torch.models.lm import param_count

        return param_count(self)


# The four input-shape cells shared by all LM archs.
SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

# ``impl`` values of :func:`chunked_attention`: "auto" launches the flash
# kernel on a CUDA tensor and runs the chunked online-softmax on a CPU one;
# "ref" runs the kernel's plain version on either device.
ATTENTION_IMPLS = ("auto", "ref")


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dt)


def rope(positions: torch.Tensor, dim: int,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding tables: returns (sin, cos) of shape [..., dim/2]."""

    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; sin/cos: [B, S, D/2] (or broadcastable)."""

    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (train/prefill)
# ---------------------------------------------------------------------------


def _chunk_mask(rows, cols, Skv, causal, window):
    mask = (cols[None, :] < Skv).expand(rows.shape[0], cols.shape[0])
    if causal:
        mask = mask & (cols[None, :] <= rows[:, None])
    if window is not None:
        mask = mask & (cols[None, :] > rows[:, None] - window)
    return mask


def _relayouts(q, k, v, chunk, scale):
    """f32 K and V in (B, KH, chunks, chunk, D) (zero-padded to a chunk
    multiple), scaled q in (B, KH, G, Sq, D), and the absolute query rows."""

    B, Sq, H, D = q.shape
    _, Skv, KH, _ = k.shape
    group = H // KH

    qf = (q.to(torch.float32) * scale).permute(0, 2, 1, 3)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    pad_kv = (-Skv) % chunk
    if pad_kv:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad_kv))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad_kv))
    nk = (Skv + pad_kv) // chunk
    kf = kf.reshape(B, KH, nk, chunk, D)
    vf = vf.reshape(B, KH, nk, chunk, D)
    qg = qf.reshape(B, KH, group, Sq, D)
    rows = torch.arange(Sq, device=q.device) + (Skv - Sq)
    return kf, vf, qg, rows


def _chunked_fwd(q, k, v, causal, window, chunk, scale):
    """Online-softmax forward over KV chunks (the JAX package's
    ``_chunked_fwd``); returns (out_f32, m, l) in the grouped
    (B, KH, G, Sq, *) layout."""

    B, Sq, H, D = q.shape
    _, Skv, KH, _ = k.shape
    group = H // KH
    kf, vf, qg, rows = _relayouts(q, k, v, chunk, scale)
    nk = kf.shape[2]
    dev = q.device

    m = torch.full((B, KH, group, Sq, 1), -torch.inf, device=dev)
    l = torch.zeros((B, KH, group, Sq, 1), device=dev)
    acc = torch.zeros((B, KH, group, Sq, D), device=dev)
    for ci in range(nk):
        # the flash kernel's body: s and p stay on chip there
        with vmem_region("flash"):
            kc, vc = kf[:, :, ci], vf[:, :, ci]
            cols = ci * chunk + torch.arange(chunk, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kc)
            mask = _chunk_mask(rows, cols, Skv, causal, window)
            s = torch.where(mask, s, -torch.inf)
            m_cur = torch.amax(s, dim=-1, keepdim=True)
            m_new = torch.maximum(m, m_cur)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(s - m_safe), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               0.0)
            l = corr * l + torch.sum(p, -1, keepdim=True)
            acc = acc * corr + torch.einsum("bkgqc,bkcd->bkgqd", p, vc)
            m = m_new
    out = acc / torch.where(l > 0, l, 1.0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return out, m, l


class _ChunkedAttention(torch.autograd.Function):
    """The JAX package's ``_chunked_attention`` custom VJP: the forward keeps
    (q, k, v, out_f32, m, l); the backward recomputes p per (q, KV chunk)
    from the saved statistics, the math of the flash backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, scale):
        out, m, l = _chunked_fwd(q, k, v, causal, window, chunk, scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, window, chunk, scale)
        B, Sq, H, D = q.shape
        return out.reshape(B, H, Sq, D).transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, window, chunk, scale = ctx.args
        B, Sq, H, D = q.shape
        _, Skv, KH, _ = k.shape
        group = H // KH
        kf, vf, qg, rows = _relayouts(q, k, v, chunk, scale)
        dof = do.to(torch.float32).permute(0, 2, 1, 3).reshape(
            B, KH, group, Sq, D)
        l_safe = torch.where(l > 0, l, 1.0)
        delta = torch.sum(dof * out, dim=-1, keepdim=True)
        nk = kf.shape[2]
        dq_acc = torch.zeros_like(qg)
        dk_chunks, dv_chunks = [], []
        for ci in range(nk):
            # the dQ and dK/dV kernels' body
            with vmem_region("flash"):
                kc, vc = kf[:, :, ci], vf[:, :, ci]
                cols = ci * chunk + torch.arange(chunk, device=q.device)
                s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kc)
                mask = _chunk_mask(rows, cols, Skv, causal, window)
                p = torch.where(mask, torch.exp(s - m), 0.0) / l_safe
                dp = torch.einsum("bkgqd,bkcd->bkgqc", dof, vc)
                ds = p * (dp - delta)
                dq_acc = dq_acc + torch.einsum("bkgqc,bkcd->bkgqd", ds, kc)
                dv_chunks.append(torch.einsum("bkgqc,bkgqd->bkcd", p, dof))
                dk_chunks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qg))
        # s = (q * scale) . k, so ds/dq needs the extra scale while ds/dk is
        # exactly ds^T qg (qg already carries the scale).
        dq = (dq_acc * scale).reshape(B, H, Sq, D).transpose(1, 2)
        dk = torch.cat(dk_chunks, dim=2)[:, :, :Skv].transpose(1, 2)
        dv = torch.cat(dv_chunks, dim=2)[:, :, :Skv].transpose(1, 2)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def chunked_attention(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Skv, KH, D)
    v: torch.Tensor,   # (B, Skv, KH, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 512,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Blockwise attention in the ``(B, S, H, D)`` layout, forward and
    backward.

    A CUDA tensor goes through the flash-attention kernels, which read this
    layout through strides (no transpose); a CPU tensor runs the chunked
    online-softmax and its two-pass backward with O(Sq * chunk) live
    memory, the math of the JAX package's ``chunked_attention``.
    ``impl="ref"`` runs the kernels' plain version
    (``attention_reference``) under plain autograd on either device."""

    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"impl must be one of {ATTENTION_IMPLS}, got "
                         f"{impl!r}")
    B, Sq, H, D = q.shape
    _, Skv, _, _ = k.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    if impl == "ref":
        from repro_torch.kernels.flash_attention.ref import (
            attention_reference,
        )

        out = attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, sm_scale=scale,
        )
        return out.transpose(1, 2)
    if q.is_cuda:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window,
                               sm_scale=scale, layout="bshd")
    chunk = min(chunk, Skv)
    return _ChunkedAttention.apply(q, k, v, causal, window, chunk, scale)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KH, D)
    v_cache: torch.Tensor,  # (B, S, KH, D)
    valid: torch.Tensor,    # (B, S) bool — which cache slots are live
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over the KV cache (plain PyTorch)."""

    B, _, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    group = H // KH
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)

    qg = (q.to(torch.float32) * scale).reshape(B, KH, group, D)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)
    live = valid[:, None, None, :]
    s = torch.where(live, s, -torch.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp(l, min=1e-30), vf)
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_partial(
    q: torch.Tensor,        # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S_block, KH, D): one block of the slots
    v_cache: torch.Tensor,
    valid: torch.Tensor,    # (B, S_block) bool
    *,
    sm_scale: Optional[float] = None,
):
    """Single-token attention over one block of the cache's slots,
    unnormalised: ``(o, m, l)``, each ``(B, KH, H // KH, ...)`` in f32, with
    ``m`` the block's row max (``-inf`` where no slot is live), ``l`` the
    sum of ``exp(s - m)`` and ``o`` that sum weighted by the values (zeros
    for a block with no live slot)."""

    B, _, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    qg = (q.to(torch.float32) * scale).reshape(B, KH, H // KH, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    live = valid[:, None, None, :]
    s = torch.where(live, s, -torch.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - torch.where(torch.isfinite(m), m,
                                                     0.0)), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o, m, l


def decode_attention_join(o, m, l, axes, dtype: torch.dtype) -> torch.Tensor:
    """The attention of :func:`decode_attention_partial`'s blocks joined
    over the mesh ``axes`` that cut the slots: one ``pmax`` of ``m``, one
    ``psum`` of ``(l e^(m - M), o e^(m - M))``; ``(B, 1, H, D)`` in
    ``dtype``.  With ``axes`` empty, the one block normalised."""

    B, KH, G, D = o.shape
    M = C.pmax(m, axes)
    w = torch.where(torch.isfinite(m),
                    torch.exp(m - torch.where(torch.isfinite(M), M, 0.0)),
                    0.0)
    ol = C.psum(torch.cat([o * w, l * w], dim=-1), axes)
    out = ol[..., :D] / torch.clamp(ol[..., D:], min=1e-30)
    return out.reshape(B, 1, KH * G, D).to(dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy_loss(
    logits: torch.Tensor,   # (B, S, V)
    labels: torch.Tensor,   # (B, S) int
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next-token cross entropy, label picked by a select over the vocab
    (no one-hot)."""

    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.sum(
        torch.where(vocab_ids == labels[..., None], logits, 0.0), dim=-1
    )
    nll = lse - picked
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
