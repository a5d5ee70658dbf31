"""Layer blocks of the dense family (the JAX package's ``models/blocks.py``).

The dense family provides, for :mod:`repro_torch.models.lm`:

* ``layer_specs(cfg)`` — a tree of :class:`ParamSpec` (shape + logical
  sharding axes): the single source of truth for init and parameter counts.
* ``layer_apply(params, x, ctx, cache)`` — the layer forward.  ``ctx``
  bundles mode ("train" | "prefill" | "decode"), rope tables, the cache
  length and position; returns ``(y, new_cache)``.
* ``layer_cache_specs`` for serving.

Mixers keep softmax statistics in f32 and matmuls in the config's compute
dtype (``x.to(dt) @ w.to(dt)``, as the JAX package; a weight already in the
compute dtype is used as it is).  On one device the JAX package's
``shard(...)`` annotations are no-ops and are dropped, and
``_maybe_repeat_kv`` is the identity (tp = 1).  The other families (mla,
moe, ssm, hybrid, encdec) are ROADMAP A14(c) and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ArchConfig,
    apply_rope,
    chunked_attention,
    decode_attention,
    dtype_of,
    rms_norm,
)

__all__ = [
    "ParamSpec",
    "LayerCtx",
    "layer_specs",
    "layer_apply",
    "layer_cache_specs",
    "attention_mixer",
    "attention_specs",
    "attention_cache_specs",
    "mlp_specs",
    "mlp_apply",
    "unported_family",
]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | small_normal
    dtype: Optional[str] = None  # override param dtype (e.g. f32 for norms)


@dataclass
class LayerCtx:
    cfg: ArchConfig
    mode: str                    # train | prefill | decode
    sin: Optional[torch.Tensor] = None  # rope tables for current positions
    cos: Optional[torch.Tensor] = None
    pos: Optional[int] = None    # absolute position (decode)
    cache_len: int = 0
    causal: bool = True
    attention: str = "auto"      # chunked_attention's impl: auto | ref


def unported_family(cfg: ArchConfig) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP "
        f"A14(c)); the port runs the dense family"
    )


def _cdt(cfg):
    return dtype_of(cfg.compute_dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ArchConfig,
              d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    E, Fd = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": ParamSpec((E, Fd), ("embed", "ffn")),
            "w_up": ParamSpec((E, Fd), ("embed", "ffn")),
            "w_down": ParamSpec((Fd, E), ("ffn", "embed"),
                                init="small_normal"),
        }
    return {
        "w_up": ParamSpec((E, Fd), ("embed", "ffn")),
        "b_up": ParamSpec((Fd,), ("ffn",), init="zeros"),
        "w_down": ParamSpec((Fd, E), ("ffn", "embed"), init="small_normal"),
        "b_down": ParamSpec((E,), ("embed",), init="zeros"),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    dt = _cdt(cfg)
    x = x.to(dt)
    if cfg.mlp_type == "swiglu":
        h = F.silu(_mm(x, p["w_gate"], dt)) * _mm(x, p["w_up"], dt)
        return _mm(h, p["w_down"], dt)
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(_mm(x, p["w_up"], dt) + p["b_up"].to(dt), approximate="tanh")
    return _mm(h, p["w_down"], dt) + p["b_down"].to(dt)


# ---------------------------------------------------------------------------
# GQA attention mixer
# ---------------------------------------------------------------------------


def attention_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    E, H, KH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((E, H * D), ("embed", "qkv")),
        "wk": ParamSpec((E, KH * D), ("embed", "qkv")),
        "wv": ParamSpec((E, KH * D), ("embed", "qkv")),
        "wo": ParamSpec((H * D, E), ("qkv", "embed"), init="small_normal"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((D,), (None,), init="ones",
                                    dtype="float32")
        specs["k_norm"] = ParamSpec((D,), (None,), init="ones",
                                    dtype="float32")
    return specs


def _qkv(p, x, cfg, rope_tabs):
    dt = _cdt(cfg)
    B, S, _ = x.shape
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _mm(x, p["wq"], dt).reshape(B, S, H, D)
    k = _mm(x, p["wk"], dt).reshape(B, S, KH, D)
    v = _mm(x, p["wv"], dt).reshape(B, S, KH, D)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope_tabs[0] is not None:
        sin, cos = rope_tabs
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _ring_valid(pos: int, L: int, window: int, device) -> torch.Tensor:
    """Ring cache: slot i holds absolute position p = the largest p <= pos
    with p % L == i.  Visible iff p exists and lies in the window
    (pos - window, pos]."""

    slots = torch.arange(L, device=device)
    p_abs = pos - torch.remainder(pos - slots, L)
    return (p_abs >= 0) & (p_abs > pos - window)


def attention_mixer(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    ctx: LayerCtx,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Decode writes the new token's k/v into ``cache`` in place (the JAX
    package donates the cache and updates it with a dynamic slice) and
    returns the same dict."""

    cfg = ctx.cfg
    dt = _cdt(cfg)
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.hd

    if ctx.mode == "decode":
        q, k_new, v_new = _qkv(p, x, cfg, (ctx.sin, ctx.cos))
        k_c, v_c = cache["k"], cache["v"]
        L = k_c.shape[1]
        pos = int(ctx.pos)
        slot = pos % L if cfg.window is not None else pos
        if not 0 <= slot < L:
            raise IndexError(f"decode position {pos} is past the cache "
                             f"length {L}")
        k_c[:, slot] = k_new[:, 0].to(k_c.dtype)
        v_c[:, slot] = v_new[:, 0].to(v_c.dtype)
        if cfg.window is not None:
            valid = _ring_valid(pos, L, cfg.window, x.device)
        else:
            valid = torch.arange(L, device=x.device) <= pos
        valid = valid[None, :].expand(B, L)
        out = decode_attention(q, k_c, v_c, valid)
        new_cache = cache
    else:
        q, k, v = _qkv(p, x, cfg, (ctx.sin, ctx.cos))
        out = chunked_attention(q, k, v, causal=ctx.causal,
                                window=cfg.window, impl=ctx.attention)
        new_cache = None
        if ctx.mode == "prefill":
            Lc = ctx.cache_len
            if cfg.window is not None and Lc < S:
                # ring layout: slot i holds absolute position p, p % Lc == i
                roll = S % Lc
                k_keep = torch.roll(k[:, -Lc:], roll, dims=1)
                v_keep = torch.roll(v[:, -Lc:], roll, dims=1)
            else:
                pad = Lc - S
                k_keep = F.pad(k, (0, 0, 0, 0, 0, pad))
                v_keep = F.pad(v, (0, 0, 0, 0, 0, pad))
            new_cache = {"k": k_keep, "v": v_keep}
    out = out.reshape(B, S, H * D)
    y = _mm(out, p["wo"], dt)
    return y, new_cache


def attention_cache_specs(cfg: ArchConfig, batch: int, seq: int):
    L = min(seq, cfg.window) if cfg.window is not None else seq
    kv = (batch, L, cfg.n_kv_heads, cfg.hd)
    axes = ("batch", "kv_seq", None, None)
    return {
        "k": ParamSpec(kv, axes, init="zeros", dtype=cfg.compute_dtype),
        "v": ParamSpec(kv, axes, init="zeros", dtype=cfg.compute_dtype),
    }


# ---------------------------------------------------------------------------
# Layer assembly
# ---------------------------------------------------------------------------


def layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.family != "dense":
        raise unported_family(cfg)
    E = cfg.d_model

    def ln():
        return ParamSpec((E,), ("embed",), init="ones", dtype="float32")

    return {
        "ln1": ln(), "attn": attention_specs(cfg),
        "ln2": ln(), "mlp": mlp_specs(cfg),
    }


def layer_apply(
    params: Dict[str, Any],
    x: torch.Tensor,
    ctx: LayerCtx,
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    cfg = ctx.cfg
    if cfg.family != "dense":
        raise unported_family(cfg)
    h = rms_norm(x, params["ln1"])
    attn_out, new_cache = attention_mixer(params["attn"], h, ctx, cache)
    x = x + attn_out
    h = rms_norm(x, params["ln2"])
    x = x + mlp_apply(params["mlp"], h, cfg)
    return x, new_cache


def layer_cache_specs(cfg: ArchConfig, batch: int,
                      seq: int) -> Dict[str, Any]:
    if cfg.family != "dense":
        raise unported_family(cfg)
    return attention_cache_specs(cfg, batch, seq)
