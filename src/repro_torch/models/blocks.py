"""Layer blocks for every architecture family (the JAX package's
``models/blocks.py``).

Each family provides, for :mod:`repro_torch.models.lm`:

* ``layer_specs(cfg)`` — a tree of :class:`ParamSpec` (shape + logical
  sharding axes): the single source of truth for init and parameter counts.
* ``layer_apply(params, x, ctx, cache)`` — the layer forward.  ``ctx``
  bundles mode ("train" | "prefill" | "decode"), rope tables, the cache
  length and position; returns ``(y, new_cache)``.
* ``layer_cache_specs`` for serving.

Mixers keep softmax and scan statistics in f32 and matmuls in the config's
compute dtype (``x.to(dt) @ w.to(dt)``, as the JAX package; a weight
already in the compute dtype is used as it is).  Decode writes the cache
in place: slices for the KV and latent caches, ``copy_`` for the SSM
state it replaces.

The JAX package's ``shard(...)`` annotations are dropped: on one device
they are no-ops, and on a mesh GSPMD turns them into collectives, which
the port places itself.  Inside a ``sharding.placement`` (the train step
on a mesh, ROADMAP A10e-1, and prefill and decode on a mesh, A10e-2) a
layer reads its parameters' *local* shapes:
where a weight is cut over ``model`` the layer is Megatron tensor
parallel, :func:`~repro_torch.parallel.collectives.copy_to` at its input
(identity forward, ``psum`` backward) and
:func:`~repro_torch.parallel.collectives.reduce_from` at its output
(``psum`` forward):

* the MLP: ``w_gate``/``w_up`` (and ``b_up``) column-parallel, ``w_down``
  row-parallel, ``b_down`` added once after the ``psum``;
* GQA attention: q, k, v heads column-parallel (the rank's heads are
  contiguous, and GQA's grouping is contiguous too, so rank r's q heads
  read exactly rank r's kv heads), ``wo`` row-parallel; ``q_norm`` and
  ``k_norm`` pass through ``copy_to``, since each rank's gradient of them
  is its heads' share; where the plan keeps
  ``qkv`` whole the attention is replicated;
* the MoE: the router replicated (through ``copy_to``: a rank's gates see
  only its experts' outputs), each rank runs its X/tp experts (EP) or its
  ffn columns of every expert (``expert_ffn`` over ``model``), and the
  weighted contributions are ``psum``'d.  The capacity is the reference's
  per data shard: the rank's tokens are its data group's;
* the decode cache: its slots cut over ``model`` (``kv_seq``; whole where
  ``model`` does not divide them) with every kv head, as the reference's
  ``attention_cache_specs`` lays it out.  Prefill re-cuts its kept K/V
  from heads to slots with one all-to-all (``_cache_layout``); decode
  attends each rank's slots for every head and joins the softmax
  statistics over ``model`` (``_decode_attention``);
* kv heads that ``model`` does not divide (ROADMAP A10h-3,
  :func:`_repeat_layout`): where it divides the q heads only (case (i)),
  the kv projections' columns are all-gathered and the whole kv heads
  repeated to the rank's q heads (the reference's ``_maybe_repeat_kv``).
  Where it does not divide the q heads (case (ii)) the planner keeps
  ``qkv`` whole and the attention is replicated, as the reference's; a
  plan that cuts them mid-head anyway is refused (A10h-4);
* MLA (ROADMAP A10h-1): ``q_up``, ``k_up``, ``v_up`` column-parallel over
  heads, ``wo`` row-parallel, the latents whole on every rank; its latent
  cache's slots cut as the dense cache's, and decode joins a split
  softmax in the latent space (``_mla_decode``);
* the SSD mixer (ROADMAP A10h-2): whole on every ``model`` rank, as the
  reference's rules keep ``ssm_heads``, ``ssm_state`` and ``conv_dim``
  replicated, with no collective; its gradients are whole on each rank
  (the train step does not sum them over ``model``), and its cache is cut
  over ``batch`` only.  The hybrid layer's attention half is tensor
  parallel and its SSM half replicated, so their average is whole on
  every rank.

Outside a placement every one of these is the identity: one device, as
before.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.census import vmem_region
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding
from repro_torch.models.common import (
    ArchConfig,
    apply_rope,
    chunked_attention,
    decode_attention,
    decode_attention_join,
    decode_attention_partial,
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
    "mla_specs",
    "mla_mixer",
    "mla_cache_specs",
    "moe_specs",
    "moe_apply",
    "ssm_specs",
    "ssd_chunked",
    "ssm_mixer",
    "ssm_cache_specs",
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
    cache_len: int = 0           # the cache's global slots (0: the cache's)
    causal: bool = True
    attention: str = "auto"      # chunked_attention's impl: auto | ref
    kv_axes: Tuple[str, ...] = ()  # the mesh axes cutting the cache's slots


def _cdt(cfg):
    return dtype_of(cfg.compute_dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x.to(dt) @ w.to(dt)


def _tp_cut(local: int, whole: int) -> Tuple[str, ...]:
    """The ``model`` axes a layer whose weight dim holds ``local`` of
    ``whole`` entries on this rank is tensor parallel over (``()``: the
    dim is whole, the layer replicated)."""

    return sharding.tp_axes() if local < whole else ()


def _repeat_layout(p, cfg: ArchConfig) -> Tuple[Tuple[str, ...], bool]:
    """``(tp, repeat)``: the ``model`` axes GQA attention's heads are cut
    over (``()`` where whole: the attention replicated), and whether
    ``model`` divides the q heads but not the kv heads (ROADMAP A10h-3,
    case (i)): each rank then projects its own q heads, all-gathers the kv
    projections' columns and repeats the whole kv heads to its q heads
    (the reference's ``_maybe_repeat_kv``).  A cut of the q heads that
    ``model`` does not divide would fall mid-head: the mesh steps refuse
    it before any collective (A10h-4), and the planner never makes one."""

    tp = _tp_cut(p["wq"].shape[-1], cfg.n_heads * cfg.hd)
    if not tp:
        return tp, False
    n = sharding.ambient_axis_size(tp[0])
    if cfg.n_heads % n:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} q heads cut over a {n}-way model "
            f"axis that does not divide them (ROADMAP A10h-4)")
    return tp, cfg.n_kv_heads % n != 0


def _gather_columns(ts, tp):
    """The whole outputs of column-cut projections, each of ``ts`` a
    rank's block ``(..., w)`` of its columns: one all-gather of them side
    by side, whose backward is one reduce-scatter (each rank's columns get
    the gradient summed over the ranks that read them)."""

    widths = [t.shape[-1] for t in ts]
    g = C.gather_dim(torch.cat(ts, dim=-1)[None], tp, 0)
    out, at = [], 0
    for w in widths:
        part = g[..., at:at + w].movedim(0, -2)
        out.append(part.reshape(part.shape[:-2] + (-1,)))
        at += w
    return out


def _repeat_kv(t: torch.Tensor, cfg: ArchConfig, tp) -> torch.Tensor:
    """Whole kv heads ``(B, S, KH, D)`` as the rank's ``H / tp`` q heads
    read them, one kv head a q head: the reference's repeat to ``H`` heads
    cut by heads, repeating only the kv heads the rank's q heads read (an
    expand, whose backward sums the repeats in a fixed order)."""

    B, S, _, D = t.shape
    g = cfg.n_heads // cfg.n_kv_heads
    n = cfg.n_heads // C.axis_size(tp[0])
    a = C.axis_index(tp) * n
    lo, hi = a // g, (a + n - 1) // g + 1
    t = t[:, :, lo:hi, None].expand(B, S, hi - lo, g, D)
    return t.reshape(B, S, (hi - lo) * g, D).narrow(2, a - lo * g, n)


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
    tp = _tp_cut(p["w_up"].shape[-1], cfg.d_ff)
    x = C.copy_to(x, tp)
    if cfg.mlp_type == "swiglu":
        h = F.silu(_mm(x, p["w_gate"], dt)) * _mm(x, p["w_up"], dt)
        return C.reduce_from(_mm(h, p["w_down"], dt), tp)
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(_mm(x, p["w_up"], dt) + p["b_up"].to(dt), approximate="tanh")
    return C.reduce_from(_mm(h, p["w_down"], dt), tp) + p["b_down"].to(dt)


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


def _qkv(p, x, cfg, rope_tabs, tp=(), repeat=False):
    """q, k, v at the rank's heads (``tp``: the ``model`` axes the columns
    are cut over), or, under ``repeat`` (:func:`_repeat_layout`), q at the
    rank's heads and k, v whole: their projections' columns gathered
    before any reshape into heads, since a rank's kv columns may hold
    part of a head."""

    dt = _cdt(cfg)
    B, S, _ = x.shape
    D = cfg.hd
    q = _mm(x, p["wq"], dt)
    k = _mm(x, p["wk"], dt)
    v = _mm(x, p["wv"], dt)
    if repeat:
        k, v = _gather_columns([k, v], tp)
    q, k, v = (t.reshape(B, S, -1, D) for t in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm(q, C.copy_to(p["q_norm"], tp))
        k = rms_norm(k, C.copy_to(p["k_norm"], tp))
    if rope_tabs[0] is not None:
        sin, cos = rope_tabs
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _check_cache_len(cache_len: int, S: int) -> None:
    """A cache without a ring must hold the whole prompt: a negative pad
    would crop it to its first ``cache_len`` positions without a word (the
    JAX package's ``jnp.pad`` refuses it too; ROADMAP C13)."""

    if cache_len < S:
        raise ValueError(f"prefill of S = {S} tokens into a cache of "
                         f"cache_len = {cache_len} slots: a cache without a "
                         f"window must hold the prompt (ROADMAP C13)")


def _slot_valid(pos: int, L: int, window: Optional[int],
                slots: torch.Tensor) -> torch.Tensor:
    """Which of the slots ``slots`` (global ids: a rank's block of a cut
    cache) of a cache of ``L`` slots are live at ``pos``.  In a ring
    (``window``) slot i holds absolute position p = the largest p <= pos
    with p % L == i, visible iff p exists and lies in the window
    (pos - window, pos]."""

    if window is None:
        return slots <= pos
    p_abs = pos - torch.remainder(pos - slots, L)
    return (p_abs >= 0) & (p_abs > pos - window)


def _local_slot(slot: int, first: int, n: int) -> Optional[int]:
    """The global cache slot ``slot`` in the block of ``n`` slots from
    ``first`` that this rank holds, or ``None`` where another rank's block
    holds it (that rank writes it)."""

    return slot - first if first <= slot < first + n else None


def _cache_layout(t: torch.Tensor, tp, kv) -> torch.Tensor:
    """Prefill's kept K or V ``(B, Lc, KH_local, D)``, its heads cut over
    ``tp``, laid out as the cache's spec: the slots cut over ``kv`` (one
    all-to-all from a cut by heads to a cut by slots, or this rank's block
    of slots where the heads are whole), or whole (the heads
    all-gathered)."""

    if kv and tp:
        return C.all_to_all_dim(t, tp, 1, 2)
    if kv:
        n = t.shape[1] // C.axis_size(kv[0])
        return t.narrow(1, C.axis_index(kv) * n, n).contiguous()
    if tp:
        return C.all_gather_dim(t, tp, 2)
    return t


def _decode_attention(q, k_new, v_new, cache, ctx: LayerCtx, tp,
                      repeat=False):
    """Write the new token's K/V into ``cache`` in place and attend over
    it.  ``q``, ``k_new``, ``v_new`` as :func:`_qkv` gives them (cut over
    ``tp``; k and v whole under ``repeat``); returns the attention at q's
    heads.

    On a mesh (ROADMAP A10e-2) the cache holds every kv head, so the new
    token's K/V are all-gathered over ``tp`` where they are the rank's
    heads (``repeat`` gathered them whole already).  Where its slots are
    cut over ``ctx.kv_axes`` only the rank that owns the written slot
    writes it, at its local slot (guarded, never clamped: ROADMAP C1),
    every head's q attends the rank's slots, masked by their global ids,
    and the blocks' softmax statistics are joined over the axes; where the
    slots are whole the rank attends its own q heads (their kv heads
    narrowed, or repeated under ``repeat``)."""

    cfg = ctx.cfg
    k_c, v_c = cache["k"], cache["v"]
    Ll = k_c.shape[1]
    L = ctx.cache_len or Ll
    kv = ctx.kv_axes
    pos = int(ctx.pos)
    slot = pos % L if cfg.window is not None else pos
    if not 0 <= slot < L:
        raise IndexError(f"decode position {pos} is past the cache "
                         f"length {L}")
    if tp and not repeat:
        k_new = C.all_gather_dim(k_new, tp, 2)
        v_new = C.all_gather_dim(v_new, tp, 2)
    first = C.axis_index(kv) * Ll if kv else 0
    local = _local_slot(slot, first, Ll)
    if local is not None:
        k_c[:, local] = k_new[:, 0].to(k_c.dtype)
        v_c[:, local] = v_new[:, 0].to(v_c.dtype)
    B = q.shape[0]
    slots = torch.arange(first, first + Ll, device=q.device)
    valid = _slot_valid(pos, L, cfg.window, slots)[None, :].expand(B, Ll)
    if not kv:
        if repeat:
            k_c, v_c = _repeat_kv(k_c, cfg, tp), _repeat_kv(v_c, cfg, tp)
        elif tp:
            KH = k_c.shape[2] // C.axis_size(tp[0])
            k_c = k_c.narrow(2, C.axis_index(tp) * KH, KH)
            v_c = v_c.narrow(2, C.axis_index(tp) * KH, KH)
        return decode_attention(q, k_c, v_c, valid)
    H = q.shape[2]
    if tp:
        q = C.all_gather_dim(q, tp, 2)
    out = decode_attention_join(*decode_attention_partial(q, k_c, v_c, valid),
                                kv, q.dtype)
    if tp:
        out = out.narrow(2, C.axis_index(tp) * H, H)
    return out


def attention_mixer(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    ctx: LayerCtx,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Decode writes the new token's k/v into ``cache`` in place (the JAX
    package donates the cache and updates it with a dynamic slice) and
    returns the same dict.

    On a mesh where ``model`` divides the q heads but not the kv heads
    (ROADMAP A10h-3, :func:`_repeat_layout`) the kv heads are gathered
    whole and repeated to the rank's q heads; the cache holds the raw kv
    heads, as the reference's."""

    cfg = ctx.cfg
    dt = _cdt(cfg)
    B, S, _ = x.shape
    tp, repeat = _repeat_layout(p, cfg)
    x = C.copy_to(x, tp)

    if ctx.mode == "decode":
        q, k_new, v_new = _qkv(p, x, cfg, (ctx.sin, ctx.cos), tp, repeat)
        out = _decode_attention(q, k_new, v_new, cache, ctx, tp, repeat)
        new_cache = cache
    else:
        q, k, v = _qkv(p, x, cfg, (ctx.sin, ctx.cos), tp, repeat)
        k_att, v_att = (k, v) if not repeat else (
            _repeat_kv(k, cfg, tp), _repeat_kv(v, cfg, tp))
        out = chunked_attention(q, k_att, v_att, causal=ctx.causal,
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
                _check_cache_len(Lc, S)
                pad = Lc - S
                k_keep = F.pad(k, (0, 0, 0, 0, 0, pad))
                v_keep = F.pad(v, (0, 0, 0, 0, 0, pad))
            heads = () if repeat else tp
            new_cache = {"k": _cache_layout(k_keep, heads, ctx.kv_axes),
                         "v": _cache_layout(v_keep, heads, ctx.kv_axes)}
    out = out.reshape(B, S, -1)
    y = C.reduce_from(_mm(out, p["wo"], dt), tp)
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
# MLA mixer (MiniCPM3 / DeepSeek-style multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    E, H = cfg.d_model, cfg.n_heads
    Qr, KVr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "q_down": ParamSpec((E, Qr), ("embed", None)),
        "q_norm": ParamSpec((Qr,), (None,), init="ones", dtype="float32"),
        "q_up": ParamSpec((Qr, H * (nd + rd)), (None, "qkv")),
        "kv_down": ParamSpec((E, KVr + rd), ("embed", None)),
        "kv_norm": ParamSpec((KVr,), (None,), init="ones", dtype="float32"),
        "k_up": ParamSpec((KVr, H * nd), ("kv_lora", "qkv")),
        "v_up": ParamSpec((KVr, H * vd), ("kv_lora", "qkv")),
        "wo": ParamSpec((H * vd, E), ("qkv", "embed"), init="small_normal"),
    }


def _mla_decode(p, q_nope, q_rope, c_new, kr_new, cache, ctx: LayerCtx,
                tp):
    """MLA's absorbed-matrix decode: write the new token's latent ``c`` and
    rope key ``kr`` into ``cache`` in place and attend in the latent space
    (in f32).  ``q_nope``/``q_rope`` at the rank's heads (cut over
    ``tp``); returns ``(B, 1, H_local, vd)``.

    On a mesh (ROADMAP A10h-1) the latent is whole on every ``model`` rank,
    so the owner of the written slot writes it from its own copy, with no
    collective (guarded as ``_decode_attention``: ROADMAP C1).  Where the
    slots are cut over ``ctx.kv_axes`` the rank's q heads' latent queries
    are all-gathered over ``tp`` (one collective), every head scores the
    rank's slots (keys ``[c, kr]``, values ``c``: one kv head), the split
    softmax is joined over the axes (one ``pmax``, one ``psum``) and the
    rank keeps its heads; where the slots are whole the rank attends its
    own heads with no collective, as one device does.  The latent query
    ``[q_lat, q_rope]`` meets the keys ``[c, kr]`` as one kv head of
    :func:`decode_attention_partial`, so one device runs the same code."""

    cfg = ctx.cfg
    dt = _cdt(cfg)
    nd, rd, vd, KVr = (cfg.nope_head_dim, cfg.rope_head_dim,
                       cfg.v_head_dim, cfg.kv_lora_rank)
    c_cache, kr_cache = cache["c"], cache["kr"]
    Ll = c_cache.shape[1]
    L = ctx.cache_len or Ll
    kv = ctx.kv_axes
    pos = int(ctx.pos)
    if not 0 <= pos < L:
        raise IndexError(f"decode position {pos} is past the cache "
                         f"length {L}")
    first = C.axis_index(kv) * Ll if kv else 0
    local = _local_slot(pos, first, Ll)
    if local is not None:
        c_cache[:, local] = c_new[:, 0].to(c_cache.dtype)
        kr_cache[:, local] = kr_new[:, 0, 0].to(kr_cache.dtype)
    B, _, H, _ = q_nope.shape
    slots = torch.arange(first, first + Ll, device=q_nope.device)
    valid = _slot_valid(pos, L, None, slots)[None, :].expand(B, Ll)
    k_up = p["k_up"].to(dt).reshape(KVr, H, nd)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, k_up)
    scale = 1.0 / ((nd + rd) ** 0.5)
    c32 = c_cache.to(torch.float32)
    q_all = torch.cat([q_lat.to(torch.float32), q_rope.to(torch.float32)],
                      dim=-1)
    gather = bool(kv and tp)
    if gather:
        q_all = C.all_gather_dim(q_all, tp, 2)
    keys = torch.cat([c32, kr_cache.to(torch.float32)], dim=-1)
    ctx_lat = decode_attention_join(*decode_attention_partial(
        q_all, keys[:, :, None], c32[:, :, None], valid, sm_scale=scale),
        kv, dt)
    if gather:
        ctx_lat = ctx_lat.narrow(2, C.axis_index(tp) * H, H)
    v_up = p["v_up"].to(dt).reshape(KVr, H, vd)
    return torch.einsum("bshr,rhv->bshv", ctx_lat, v_up)


def mla_mixer(p, x, ctx, cache=None):
    """Prefill attends over full-width keys ``[k_nope, k_rope]`` through
    ``chunked_attention`` (v zero-padded to the q·k head dim and sliced
    back); decode keeps the latent ``c`` and the shared rope key ``kr`` and
    attends in the latent space (the absorbed-matrix form, in f32,
    :func:`_mla_decode`).

    On a mesh (ROADMAP A10h-1) ``q_up``, ``k_up`` and ``v_up`` are column
    parallel over the rank's heads and ``wo`` row parallel; ``q_down``,
    ``kv_down`` and the norms are whole, so every rank computes the whole
    latent ``cq``/``c_kv`` and rope key, and each enters the
    column-parallel region through ``copy_to`` (its gradient summed over
    the ranks' heads).  The latent cache's slots are cut over
    ``kv_seq`` as the dense cache's: prefill keeps this rank's block of
    them, a local slice."""

    cfg = ctx.cfg
    dt = _cdt(cfg)
    B, S, E = x.shape
    nd, rd, vd, KVr = (cfg.nope_head_dim, cfg.rope_head_dim,
                       cfg.v_head_dim, cfg.kv_lora_rank)
    H = p["q_up"].shape[-1] // (nd + rd)
    tp = _tp_cut(H, cfg.n_heads)

    cq = C.copy_to(rms_norm(_mm(x, p["q_down"], dt), p["q_norm"]), tp)
    q = _mm(cq, p["q_up"], dt).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    kv = _mm(x, p["kv_down"], dt)
    c_kv = C.copy_to(rms_norm(kv[..., :KVr], p["kv_norm"]), tp)
    k_rope = kv[..., KVr:].reshape(B, S, 1, rd)
    if ctx.sin is not None:
        q_rope = apply_rope(q_rope, ctx.sin, ctx.cos)
        k_rope = apply_rope(k_rope, ctx.sin, ctx.cos)
    k_rope = C.copy_to(k_rope, tp)

    if ctx.mode == "decode":
        out = _mla_decode(p, q_nope, q_rope, c_kv, k_rope, cache, ctx, tp)
        new_cache = cache
    else:
        k_nope = _mm(c_kv, p["k_up"], dt).reshape(B, S, H, nd)
        v = _mm(c_kv, p["v_up"], dt).reshape(B, S, H, vd)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # pad v to the q·k head dim for the shared attention primitive
        v_p = F.pad(v, (0, (nd + rd) - vd))
        out = chunked_attention(q_full, k, v_p, causal=ctx.causal,
                                impl=ctx.attention)[..., :vd]
        new_cache = None
        if ctx.mode == "prefill":
            _check_cache_len(ctx.cache_len, S)
            pad = ctx.cache_len - S
            new_cache = {
                "c": _cache_layout(F.pad(c_kv, (0, 0, 0, pad)), (),
                                   ctx.kv_axes),
                "kr": _cache_layout(F.pad(k_rope[:, :, 0, :], (0, 0, 0, pad)),
                                    (), ctx.kv_axes),
            }
    out = out.reshape(B, S, H * vd)
    return C.reduce_from(_mm(out, p["wo"], dt), tp), new_cache


def mla_cache_specs(cfg: ArchConfig, batch: int, seq: int):
    return {
        "c": ParamSpec((batch, seq, cfg.kv_lora_rank),
                       ("batch", "kv_seq", None), init="zeros",
                       dtype=cfg.compute_dtype),
        "kr": ParamSpec((batch, seq, cfg.rope_head_dim),
                        ("batch", "kv_seq", None), init="zeros",
                        dtype=cfg.compute_dtype),
    }


# ---------------------------------------------------------------------------
# MoE (mixtral / arctic): top-k routing, sort-based capacity dispatch
# ---------------------------------------------------------------------------


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    E, X, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    specs = {
        "router": ParamSpec((E, X), ("embed", None)),
        "w_gate": ParamSpec((X, E, Fd), ("experts", "embed", "expert_ffn")),
        "w_up": ParamSpec((X, E, Fd), ("experts", "embed", "expert_ffn")),
        "w_down": ParamSpec((X, Fd, E), ("experts", "expert_ffn", "embed"),
                            init="small_normal"),
    }
    if cfg.dense_residual:
        for k, v in mlp_specs(cfg, cfg.d_ff).items():
            specs[f"res_{k}"] = v
    return specs


def moe_capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots an expert for a batch of ``tokens`` (the JAX package's
    formula, Python's ``round``)."""

    return int(max(1, round(tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k experts, the most probable first."""

    return torch.topk(probs, k, dim=-1).indices


def _combine(y, slot, weight, order, k: int) -> torch.Tensor:
    """Each token's output in f32: the weighted expert rows ``y[slot]`` of
    its k pairs (in sort ``order``) summed in expert order (the order of
    the JAX package's scatter-add), without float atomics."""

    contrib = y[slot].to(torch.float32) * weight[:, None]
    # Where each (token, choice) pair sits in the sorted list; a token's
    # pairs in ascending position are its pairs in expert order.
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    at = at.reshape(-1, k).sort(dim=1).values
    out = contrib[at[:, 0]]
    for j in range(1, k):
        out = out + contrib[at[:, j]]
    return out


def _experts(buf, p, dt):
    """silu(buf Wg) * (buf Wu) Wd for every expert's slots ``buf``
    (X, C, E), as batched matmuls."""

    h = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    return torch.bmm(F.silu(h) * u, p["w_down"].to(dt))


def _route(xf, w_router, cfg: ArchConfig, cap: int):
    """Top-k routing of the tokens ``xf`` (T, E) and their (token, expert)
    pairs sorted by expert, stably, so that arrival order ranks the pairs
    of one expert (ROADMAP C2).  Returns the sort's permutation of the
    pairs (pair ``t * k + i`` is token t's i-th choice), the sorted pairs'
    expert ids, gate weights and ranks within their expert, and whether
    each is kept (rank < ``cap``)."""

    dt = _cdt(cfg)
    T, k = xf.shape[0], cfg.top_k
    logits = _mm(xf, w_router, dt).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    idx = _top_k(probs, k)                                # (T, k)
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    order = torch.argsort(idx.reshape(-1), stable=True)
    e_s = idx.reshape(-1)[order]
    w_s = gates.reshape(-1)[order]
    start = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(T * k, device=xf.device) - start
    return order, e_s, w_s, rank, rank < cap


def _local_slots(e_s, rank, keep, x0: int, n_local: int, cap: int):
    """Each sorted pair's row in the dispatch buffer of the experts
    ``[x0, x0 + n_local)`` this rank holds (``n_local * cap`` rows, then a
    spill row) and whether it is kept here: a pair past its expert's
    capacity, or of another ``model`` rank's expert under EP, goes to the
    spill row, which is sliced off (ROADMAP C1, C11)."""

    mine = keep & (e_s >= x0) & (e_s < x0 + n_local)
    return torch.where(mine, (e_s - x0) * cap + rank, n_local * cap), mine


def moe_apply(p, x, cfg: ArchConfig) -> torch.Tensor:
    """Top-k MoE with static-capacity sort-based dispatch on one data shard.

    Pairs past an expert's capacity are dropped: they are written to a
    spill row that is sliced off, never clamped onto the slot of a kept
    pair (the JAX package's clamp overwrites the pair at rank cap - 1:
    ROADMAP C11).  The experts run as batched matmuls; each token's output
    is the sum of its pairs' weighted expert outputs (``_combine``),
    rounded once to the compute dtype.

    The backward's index-accumulates give the same bits in any order
    (ROADMAP C6): the gathers ``xf[t_s]`` add each token's top_k <= 2
    rows onto zero (two addends commute exactly); ``y[slot]``, the
    gate gathers and the combine's ``contrib[at[:, j]]`` read each kept
    row once (one addend onto zero), and the spill row's zeros are sliced
    off.
    """

    dt = _cdt(cfg)
    B, S, E = x.shape
    X, k = cfg.n_experts, cfg.top_k
    T = B * S
    cap = moe_capacity(cfg, T)
    xl, fl = p["w_gate"].shape[0], p["w_gate"].shape[-1]
    tp = _tp_cut(xl * fl, X * (cfg.moe_d_ff or cfg.d_ff))
    xf = C.copy_to(x.reshape(T, E).to(dt), tp)
    order, e_s, w_s, rank, keep = _route(xf, C.copy_to(p["router"], tp),
                                         cfg, cap)
    t_s = torch.div(order, k, rounding_mode="floor")
    x0 = C.axis_index("model") * xl if xl < X else 0
    slot, keep = _local_slots(e_s, rank, keep, x0, xl, cap)
    buf = xf.new_zeros((xl * cap + 1, E))
    buf[slot] = xf[t_s]
    y = _experts(buf[:xl * cap].view(xl, cap, E), p, dt).reshape(
        xl * cap, E)
    y = torch.cat([y, y.new_zeros((1, E))])              # the spill row
    out = _combine(y, slot, torch.where(keep, w_s, 0.0), order, k)
    out = C.reduce_from(out, tp).to(dt).reshape(B, S, E)

    if cfg.dense_residual:
        res = {kk[4:]: vv for kk, vv in p.items() if kk.startswith("res_")}
        out = out + mlp_apply(res, x, cfg)
    return out


# ---------------------------------------------------------------------------
# Mamba2 SSD mixer
# ---------------------------------------------------------------------------


def ssm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    E = cfg.d_model
    Din = cfg.d_inner
    H, N, G = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = Din + 2 * G * N
    return {
        "in_proj": ParamSpec(
            (E, 2 * Din + 2 * G * N + H), ("embed", "conv_dim")
        ),
        "conv_w": ParamSpec((cfg.d_conv, conv_dim), (None, "conv_dim")),
        "conv_b": ParamSpec((conv_dim,), ("conv_dim",), init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="ones", dtype="float32"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros",
                             dtype="float32"),
        "norm": ParamSpec((Din,), ("conv_dim",), init="ones", dtype="float32"),
        "out_proj": ParamSpec((Din, E), ("conv_dim", "embed"),
                              init="small_normal"),
    }


def _segsum_decay(dA_chunk: torch.Tensor) -> torch.Tensor:
    """dA_chunk: (..., Q) log-decay increments -> (..., Q, Q) decay matrix
    L[i, j] = exp(sum_{k=j+1..i} dA_k) for i >= j, else 0.

    The upper triangle is masked before the exp (to exp(-inf) = 0): its
    sums are positive and overflow to inf at the published chunk sizes,
    and a mask after the exp then gives the backward 0 * inf = NaN (the
    JAX package's ``where(tri, exp(diff), 0)`` does; ROADMAP C14).  The
    values are the same bits either way."""

    cs = torch.cumsum(dA_chunk, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    Q = dA_chunk.shape[-1]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=dA_chunk.device))
    return torch.exp(torch.where(tri, diff, -torch.inf))


def _ssd_chunk_states(st_c, decay):
    """The inter-chunk recurrence: each chunk's state contribution ``st_c``
    (b,nc,h,p,n) and whole-chunk decay (b,nc,h) -> the state entering
    each chunk (b,nc,h,p,n) and the final state (b,h,p,n)."""

    st = st_c.new_zeros(st_c[:, 0].shape)
    states = []
    for c in range(st_c.shape[1]):
        states.append(st)
        st = st * decay[:, c, :, None, None] + st_c[:, c]
    return torch.stack(states, dim=1), st


def ssd_chunked(x, dt, A_log, Bm, Cm, D, chunk: int):
    """Chunked state-space duality scan (Mamba2, arXiv:2405.21060 §6).

    x: (b,s,h,p) f32; dt: (b,s,h) f32 (post-softplus); Bm/Cm: (b,s,g,n);
    A_log: (h,); D: (h,).  Returns y: (b,s,h,p) and the final state
    (b,h,p,n) — the decode handoff.  The JAX package's ``lax.scan`` over
    chunks, with each chunk's (Q x Q) tiles, its state contribution and
    its output from the incoming state computed for all chunks at once
    (batched over a chunk axis); only the state recurrence
    (``_ssd_chunk_states``, two small products a chunk) runs chunk by
    chunk.
    """

    b, s0, h, p = x.shape
    g = Bm.shape[2]
    rep = h // g
    # Pad to a chunk multiple: padded steps carry dt=0 (decay 1, zero input),
    # so they perturb neither outputs nor the final state.
    pad = (-s0) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    s = s0 + pad
    nc = s // chunk
    A = -torch.exp(A_log)                   # (h,) negative decay rates
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).transpose(2, 3)       # (b,nc,h,Q)
    dAc = dtc * A[None, None, :, None]
    Bc = torch.repeat_interleave(Bm, rep, dim=2).reshape(b, nc, chunk, h, -1)
    Cc = torch.repeat_interleave(Cm, rep, dim=2).reshape(b, nc, chunk, h, -1)

    # the SSD kernel's body: its (Q x Q) tiles stay on chip there
    with vmem_region("ssd"):
        cs = torch.cumsum(dAc, dim=-1)                      # (b,nc,h,Q)
        L = _segsum_decay(dAc)                              # (b,nc,h,Q,Q)
        scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
        M = scores * L * dtc[..., None, :]
        y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xc)
        decay_states = torch.exp(cs[..., -1:] - cs)         # (b,nc,h,Q)
        st_c = torch.einsum("bckhn,bchk,bckhp->bchpn", Bc,
                            decay_states * dtc, xc)
        states, st = _ssd_chunk_states(st_c, torch.exp(cs[..., -1]))
        y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cc, states,
                             torch.exp(cs))
    y = (y_diag + y_off).reshape(b, s, h, p)
    y = y + x * D[None, None, :, None]
    return y[:, :s0], st


def _split_in_proj(z, cfg: ArchConfig):
    Din = cfg.d_inner
    G, N = cfg.ssm_groups, cfg.ssm_state
    zgate = z[..., :Din]
    xbc = z[..., Din:Din + Din + 2 * G * N]
    dt = z[..., Din + Din + 2 * G * N:]
    return zgate, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C)."""

    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(
        pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :] for i in range(K)
    )
    return out + b[None, None, :]


def ssm_mixer(p, x, ctx, cache=None):
    """Decode rounds the new SSM state to the cache's dtype every step, as
    the JAX package does, and writes it and the conv window into
    ``cache`` in place."""

    cfg = ctx.cfg
    dt_c = _cdt(cfg)
    B, S, E = x.shape
    Din = cfg.d_inner
    G, N, H, P = (cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads,
                  cfg.ssm_head_dim)
    f32 = torch.float32

    z = _mm(x, p["in_proj"], dt_c)
    zgate, xbc, dt_raw = _split_in_proj(z, cfg)

    if ctx.mode == "decode":
        conv_state = cache["conv"]                    # (B, K-1, C)
        window = torch.cat([conv_state, xbc.to(f32)], dim=1)
        w = p["conv_w"].to(f32)
        conv_out = torch.einsum("bkc,kc->bc", window, w) + p["conv_b"]
        xbc_a = F.silu(conv_out)[:, None, :]          # (B,1,C)
        new_conv = window[:, 1:, :].to(conv_state.dtype)
    else:
        conv = _causal_conv(xbc.to(f32), p["conv_w"].to(f32),
                            p["conv_b"].to(f32))
        xbc_a = F.silu(conv)
        new_conv = None
        if ctx.mode == "prefill":
            # The last K - 1 conv inputs; a shorter prompt's window is
            # left-padded with the causal conv's own zeros, so that decode
            # always meets K - 1 rows (ROADMAP C12).
            keep = cfg.d_conv - 1
            new_conv = F.pad(xbc.to(f32)[:, max(0, S - keep):, :],
                             (0, 0, max(0, keep - S), 0))

    xs = xbc_a[..., :Din].reshape(B, -1, H, P).to(f32)
    Bm = xbc_a[..., Din:Din + G * N].reshape(B, -1, G, N).to(f32)
    Cm = xbc_a[..., Din + G * N:].reshape(B, -1, G, N).to(f32)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].to(f32))

    if ctx.mode == "decode":
        st = cache["ssm"].to(f32)                     # (B,H,P,N)
        rep = H // G
        B1 = torch.repeat_interleave(Bm[:, 0], rep, dim=1)   # (B,H,N)
        C1 = torch.repeat_interleave(Cm[:, 0], rep, dim=1)
        dt1 = dt[:, 0]                                # (B,H)
        x1 = xs[:, 0]                                 # (B,H,P)
        decay = torch.exp(dt1 * A[None, :])           # (B,H)
        st = st * decay[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt1, B1, x1)
        y = torch.einsum("bhn,bhpn->bhp", C1, st)
        y = y + x1 * p["D"][None, :, None]
        y = y.reshape(B, 1, Din)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(st)
        new_cache = cache
    else:
        y, final_state = ssd_chunked(
            xs, dt, p["A_log"].to(f32), Bm, Cm, p["D"].to(f32),
            min(cfg.ssm_chunk, xs.shape[1]),
        )
        y = y.reshape(B, S, Din)
        new_cache = None
        if ctx.mode == "prefill":
            new_cache = {"conv": new_conv, "ssm": final_state.to(dt_c)}

    # Gated RMSNorm + out projection.
    y = rms_norm(y * F.silu(zgate.to(f32)), p["norm"])
    return _mm(y, p["out_proj"], dt_c), new_cache


def ssm_cache_specs(cfg: ArchConfig, batch: int):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": ParamSpec((batch, cfg.d_conv - 1, conv_dim),
                          ("batch", None, "conv_dim"), init="zeros",
                          dtype="float32"),
        "ssm": ParamSpec(
            (batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            ("batch", "ssm_heads", None, None), init="zeros",
            dtype=cfg.compute_dtype,
        ),
    }


# ---------------------------------------------------------------------------
# Layer assembly per family
# ---------------------------------------------------------------------------


def layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    E = cfg.d_model

    def ln():
        return ParamSpec((E,), ("embed",), init="ones", dtype="float32")

    if cfg.family in ("dense", "encdec"):
        return {
            "ln1": ln(), "attn": attention_specs(cfg),
            "ln2": ln(), "mlp": mlp_specs(cfg),
        }
    if cfg.family == "mla":
        return {
            "ln1": ln(), "attn": mla_specs(cfg),
            "ln2": ln(), "mlp": mlp_specs(cfg),
        }
    if cfg.family == "moe":
        return {
            "ln1": ln(), "attn": attention_specs(cfg),
            "ln2": ln(), "moe": moe_specs(cfg),
        }
    if cfg.family == "ssm":
        return {"ln1": ln(), "ssm": ssm_specs(cfg)}
    if cfg.family == "hybrid":
        return {
            "ln1": ln(), "attn": attention_specs(cfg), "ssm": ssm_specs(cfg),
            "ln2": ln(), "mlp": mlp_specs(cfg),
        }
    raise ValueError(cfg.family)


def layer_apply(
    params: Dict[str, Any],
    x: torch.Tensor,
    ctx: LayerCtx,
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    cfg = ctx.cfg
    fam = cfg.family
    if fam in ("dense", "encdec", "mla", "moe"):
        mixer = mla_mixer if fam == "mla" else attention_mixer
        h = rms_norm(x, params["ln1"])
        attn_out, new_cache = mixer(params["attn"], h, ctx, cache)
        x = x + attn_out
        h = rms_norm(x, params["ln2"])
        if fam == "moe":
            x = x + moe_apply(params["moe"], h, cfg)
        else:
            x = x + mlp_apply(params["mlp"], h, cfg)
        return x, new_cache
    if fam == "ssm":
        h = rms_norm(x, params["ln1"])
        y, new_cache = ssm_mixer(params["ssm"], h, ctx, cache)
        return x + y, new_cache
    if fam == "hybrid":
        h = rms_norm(x, params["ln1"])
        attn_cache = cache.get("attn") if cache else None
        ssm_cache = cache.get("ssm") if cache else None
        a, new_attn = attention_mixer(params["attn"], h, ctx, attn_cache)
        s, new_ssm = ssm_mixer(params["ssm"], h, ctx, ssm_cache)
        x = x + 0.5 * (a + s)
        h = rms_norm(x, params["ln2"])
        x = x + mlp_apply(params["mlp"], h, cfg)
        new_cache = None
        if new_attn is not None or new_ssm is not None:
            new_cache = {"attn": new_attn, "ssm": new_ssm}
        return x, new_cache
    raise ValueError(fam)


def layer_cache_specs(cfg: ArchConfig, batch: int,
                      seq: int) -> Dict[str, Any]:
    fam = cfg.family
    if fam in ("dense", "encdec", "moe"):
        return attention_cache_specs(cfg, batch, seq)
    if fam == "mla":
        return mla_cache_specs(cfg, batch, seq)
    if fam == "ssm":
        return ssm_cache_specs(cfg, batch)
    if fam == "hybrid":
        return {
            "attn": attention_cache_specs(cfg, batch, seq),
            "ssm": ssm_cache_specs(cfg, batch),
        }
    raise ValueError(fam)
