"""Launch wrappers for the Hopper flash-attention kernels: the forward
(``src/repro_torch/csrc/flash_attention_fwd.cu``) and the backward's dQ and
dK/dV kernels (``src/repro_torch/csrc/flash_attention_bwd.cu``).

They replace the Pallas TPU kernels ``flash_fwd``, ``flash_bwd_dq`` and
``flash_bwd_dkv`` of ``repro.kernels.flash_attention.kernel``.  Each reads
its tensors through strides in either the LM's ``[B, S, H, D]`` layout
(``"bshd"``) or the ``[B, H, S, D]`` layout of ``ops.flash_attention``
(``"bhsd"``) and writes its outputs in the layout of the matching input:
the forward ``out`` like q plus the row statistics ``m`` and ``l`` as f32
``[B, H, Sq]``; the backward ``dq`` like q, ``dk`` and ``dv`` like k,
already summed over each query-head group.  These wrappers check what the
kernels take, allocate the outputs, launch on PyTorch's current stream and
count the launches.  They never fall back: a tensor a kernel does not take
raises.  Gradients go through ``ops.flash_attention``, whose
``torch.autograd.Function`` calls the three in turn.

Each kernel has routes by dtype and head dim, picked by :func:`route`:
``"f32"`` (CUDA-core FMAs), ``"wgmma"`` (bf16, all three kernels at head
dims 64 and 128: a TMA ring, ``wgmma`` and warp specialisation) and
``"mma"`` (bf16 ``mma.sync``, every other head dim the wrapper takes).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch.census import refuse_kernel

__all__ = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "route",
           "bf16_error_bound", "bf16_bwd_error_bound", "launch_count",
           "dq_launch_count", "dkv_launch_count", "fwd_wgmma_launch_count",
           "dq_wgmma_launch_count", "dkv_wgmma_launch_count",
           "reset_launch_count", "LAYOUTS",
           "ROUTES", "WGMMA_HEAD_DIMS"]

_DTYPES = (torch.float32, torch.bfloat16)
LAYOUTS = ("bhsd", "bshd")
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 160
# The launchers' route ids (csrc/flash_attention_{fwd,bwd}.cu).
ROUTES = {"f32": 0, "mma": 1, "wgmma": 2}
WGMMA_HEAD_DIMS = (64, 128)

# Launches of each kernel since the last reset (one per wrapper call that
# reaches the card): the forward, the dQ and the dK/dV kernel, all routes;
# and of each one's wgmma route alone.
launch_count = 0
dq_launch_count = 0
dkv_launch_count = 0
fwd_wgmma_launch_count = 0
dq_wgmma_launch_count = 0
dkv_wgmma_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, dq_launch_count, dkv_launch_count
    global fwd_wgmma_launch_count, dq_wgmma_launch_count
    global dkv_wgmma_launch_count
    launch_count = dq_launch_count = dkv_launch_count = 0
    fwd_wgmma_launch_count = dq_wgmma_launch_count = 0
    dkv_wgmma_launch_count = 0


def route(kernel: str, dtype: torch.dtype, d: int) -> str:
    """The route a wrapper takes for ``kernel`` (``"fwd"``, ``"dq"`` or
    ``"dkv"``) on inputs of ``dtype`` at head dim ``d``: ``"f32"`` for
    f32; for bf16 ``"wgmma"`` where it covers d (d in
    ``WGMMA_HEAD_DIMS``, all three kernels), else ``"mma"``.  Raises
    TypeError on another dtype and ValueError on a head dim no route
    takes."""

    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"kernel must be 'fwd', 'dq' or 'dkv', got "
                         f"{kernel!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"the flash kernels take f32 or bf16, got {dtype}")
    max_d = MAX_HEAD_DIM if kernel == "fwd" else MAX_BWD_HEAD_DIM
    if d % 16 or not 16 <= d <= max_d:
        raise ValueError(f"flash {kernel} takes a head dim that is a "
                         f"multiple of 16 up to {max_d}, got {d}")
    if dtype == torch.float32:
        return "f32"
    if d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd_launch.argtypes = (
            [p] * 6 + [i] * 7 + [ll] * 12 + [i, i, ctypes.c_float, p]
        )
        lib.flash_attention_fwd_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        tail = [strides, i, i, ctypes.c_float, p]
        lib.flash_attention_bwd_dq_launch.argtypes = \
            [p] * 8 + [i] * 7 + tail
        lib.flash_attention_bwd_dkv_launch.argtypes = \
            [p] * 9 + [i] * 7 + tail
        lib.flash_attention_bwd_dq_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_dkv_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bhsd_strides(t: torch.Tensor, layout: str) -> Tuple[int, int, int]:
    """(batch, seq, head) element strides of a tensor in ``layout``."""

    if layout == "bhsd":
        return t.stride(0), t.stride(2), t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def _check(name, q, k, v, layout, max_d, extra=()):
    """What the kernels take of q, k, v (and of ``extra``, tensors shaped
    like q): returns (B, H, KH, Sq, Skv, D)."""

    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    tensors = (("q", q), ("k", k), ("v", v)) + tuple(extra)
    if not (q.is_cuda and all(t.device == q.device for _, t in tensors)):
        raise ValueError(f"{name} needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for _, t in tensors):
        raise TypeError(f"{name} takes f32 or bf16 tensors of one dtype, "
                        f"got {[str(t.dtype) for _, t in tensors]}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or any(
            t.shape != q.shape for _, t in extra):
        raise ValueError(f"{name} needs 4-d q and equal 4-d k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if layout == "bhsd":
        B, H, Sq, D = q.shape
        Bk, KH, Skv, Dk = k.shape
    else:
        B, Sq, H, D = q.shape
        Bk, Skv, KH, Dk = k.shape
    if (Bk, Dk) != (B, D) or KH == 0 or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree ({layout})")
    if D % 16 or not 16 <= D <= max_d:
        raise ValueError(f"{name} takes a head dim that is a multiple of "
                         f"16 up to {max_d}, got {D}")
    size = q.element_size()
    for tname, t in tensors:
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {tname} must be contiguous in its "
                             f"last dim")
        if t.data_ptr() % 16 or any(
                st * size % 16 for st in _bhsd_strides(t, layout)):
            raise ValueError(f"{name}: {tname} must be 16-byte aligned in "
                             f"its pointer and strides")
    if max(B * H * Sq, B * KH * Skv) * D >= 2 ** 62 or Sq >= 2 ** 31 \
            or Skv >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large")
    return B, H, KH, Sq, Skv, D


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, window: Optional[int], sm_scale: float,
    layout: str = "bhsd",
):
    """Returns ``(out, m, l)``: ``out`` in q's layout and dtype, ``m`` and
    ``l`` f32 ``[B, H, Sq]`` (see :mod:`.ref` for the contract)."""

    global launch_count, fwd_wgmma_launch_count
    refuse_kernel("flash_fwd (B2)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_fwd is the forward kernel alone and records no graph; "
            "call ops.flash_attention for gradients")
    B, H, KH, Sq, Skv, D = _check("flash_fwd", q, k, v, layout,
                                  MAX_HEAD_DIM)
    if window is not None and window < 0:
        raise ValueError(f"flash_fwd: window must be >= 0, got {window}")
    chosen = route("fwd", q.dtype, D)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B == 0 or H == 0 or Sq == 0:
        return out, m, l
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(),
        ROUTES[chosen], B, H, KH, Sq, Skv, D,
        *_bhsd_strides(q, layout), *_bhsd_strides(k, layout),
        *_bhsd_strides(v, layout), *_bhsd_strides(out, layout),
        int(bool(causal)), -1 if window is None else int(window),
        float(sm_scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch ({chosen} "
                           f"route) failed: CUDA error {err}")
    launch_count += 1
    if chosen == "wgmma":
        fwd_wgmma_launch_count += 1
    return out, m, l


def _check_stats(name, B, H, Sq, device, **stats):
    for sname, t in stats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq) \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: {sname} must be a contiguous f32 "
                             f"[B, H, Sq] = {(B, H, Sq)} tensor on "
                             f"{device}, got {t.dtype} {tuple(t.shape)}")


def _strides(*tensors, layout):
    vals = [s for t in tensors for s in _bhsd_strides(t, layout)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bwd_inputs(name, q, k, v, do, m, l, delta, window, layout):
    dims = _check(name, q, k, v, layout, MAX_BWD_HEAD_DIM,
                  extra=(("do", do),))
    B, H, KH, Sq, Skv, D = dims
    _check_stats(name, B, H, Sq, q.device, m=m, l=l, delta=delta)
    if window is not None and window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    return dims


def flash_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, delta: torch.Tensor,
    *, causal: bool, window: Optional[int], sm_scale: float,
    layout: str = "bhsd",
) -> torch.Tensor:
    """``dq`` in q's layout and dtype from the forward's ``m``, ``l`` and
    ``delta = rowsum(do * out)`` (f32 ``[B, H, Sq]``); ``do`` is shaped
    like q (see :func:`.ref.attention_backward` for the contract)."""

    global dq_launch_count, dq_wgmma_launch_count
    refuse_kernel("flash_bwd_dq (B3)")
    B, H, KH, Sq, Skv, D = _bwd_inputs("flash_bwd_dq", q, k, v, do, m, l,
                                       delta, window, layout)
    chosen = route("dq", q.dtype, D)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if B == 0 or H == 0 or Sq == 0:
        return dq
    if Skv == 0:
        return dq.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_library().flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        ROUTES[chosen], B, H, KH, Sq, Skv, D,
        _strides(q, k, v, do, dq, layout=layout),
        int(bool(causal)), -1 if window is None else int(window),
        float(sm_scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq kernel launch ({chosen}"
                           f" route) failed: CUDA error {err}")
    dq_launch_count += 1
    if chosen == "wgmma":
        dq_wgmma_launch_count += 1
    return dq


def flash_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, delta: torch.Tensor,
    *, causal: bool, window: Optional[int], sm_scale: float,
    layout: str = "bhsd",
):
    """``(dk, dv)`` in k's layout and dtype, each already summed over the
    query heads of its KV head's group; inputs as :func:`flash_bwd_dq`."""

    global dkv_launch_count, dkv_wgmma_launch_count
    refuse_kernel("flash_bwd_dkv (B4)")
    B, H, KH, Sq, Skv, D = _bwd_inputs("flash_bwd_dkv", q, k, v, do, m, l,
                                       delta, window, layout)
    chosen = route("dkv", q.dtype, D)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if B == 0 or KH == 0 or Skv == 0:
        return dk, dv
    if Sq == 0:
        return dk.zero_(), dv.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_library().flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ROUTES[chosen], B, H, KH, Sq, Skv, D,
        _strides(q, k, v, do, dk, dv, layout=layout),
        int(bool(causal)), -1 if window is None else int(window),
        float(sm_scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv kernel launch "
                           f"({chosen} route) failed: CUDA error {err}")
    dkv_launch_count += 1
    if chosen == "wgmma":
        dkv_wgmma_launch_count += 1
    return dk, dv


BF16_UNIT = 2.0 ** -8     # unit roundoff of bf16
ACC_UNIT = 2.0 ** -23     # of an f32 sum that may truncate (tensor cores)


def bf16_error_bound(ref: torch.Tensor, ref_abs_v: torch.Tensor,
                     skv: int, d: int) -> torch.Tensor:
    """Per-element bound on ``|flash_fwd(q, k, v)[0] - ref|`` on the bf16
    route, where ``ref = attention_reference(q, k, v)`` and ``ref_abs_v =
    attention_reference(q, k, |v|)`` (same masks and scale; f32).

    Both bf16 routes (``mma`` and ``wgmma``) round each probability p_j
    to bf16 before P V and divide by l summed from the unrounded p_j, so
    P's rounding moves a row's output by at most 2^-8 sum_j p_j |v_j| / l
    = 2^-8 ``ref_abs_v``; the output's own rounding to bf16 adds 2^-8
    |out|.  The f32 sums of the kernel and of the reference (over ``skv``
    keys and ``d`` lanes, at 2^-23 for a truncating accumulator) add
    (skv + d) 2^-23 each, relative to the same two magnitudes.  The
    ``wgmma`` route takes p_j = 2^x, x = s_j scale log2 e - m log2 e, by
    the SFU (``ex2.approx``, relative error about 2^-22): the rounding of
    x moves p_j by at most about |x| 2^-23 ln 2 relative, and a p_j that
    matters at 2^-24 has |x| <= 24, so the two stay under 19 x 2^-23,
    inside the sums' 2 (skv + d) 2^-23 for any d >= 16.  To first order
    in these units."""

    eps = 2 * (skv + d) * ACC_UNIT
    return (BF16_UNIT + eps) * (ref_abs_v + ref.abs())


def bf16_bwd_error_bound(q, k, v, do, m, l, delta, ref, *, causal, window,
                         sm_scale):
    """Per-element bounds ``(bdq, bdk, bdv)`` on ``|kernel - ref|`` for the
    backward kernels' bf16 route, where ``ref = (dq, dk, dv)`` is
    :func:`.ref.attention_backward` of the same bf16 inputs computed in f32
    (all ``[B, H|KH, S, D]``; m, l, delta as given to both).

    Both bf16 routes form S and dP as f32 sums over the D lanes of exact
    bf16 products, P = exp(S scale - m) / l (the ``wgmma`` route as
    2^(S scale log2 e - m log2 e) / l by the SFU, whose errors of about
    2^-22 relative are 2^14 times smaller than P's 2^-8 rounding below)
    and dS = P (dP - delta) in f32, and
    rounds P and dS to bf16 before their products, which it sums in f32
    over n terms (n = Skv for dQ, G Sq for dK and dV); the outputs are
    rounded to bf16.  So, to first order in u = 2^-8 and w = 2^-23 (an f32
    sum that may truncate), with kernel and reference each contributing
    their own sums:

    * the rounding of P and dS and of the output moves dV by at most
      u (sum_q P |dO| + |dV|), dQ by u (scale sum_k |dS| |K| + |dQ|) and dK
      by u (scale sum_q |dS| |Q| + |dK|); the n-term sums add 2 n w times
      the same magnitudes;
    * the D-lane sums move scale S by e_S = 2 D w scale |Q| |K|^T and dP
      by e_P = 2 D w |dO| |V|^T, so P by P e_S and dS by
      P (e_S |dP - delta| + e_P); these enter dV as sum_q P e_S |dO|, dQ as
      scale sum_k P (e_S |dP - delta| + e_P) |K| and dK likewise with |Q|.

    Computed one (batch, KV head) at a time, so the [G, Sq, Skv] slabs of
    one group are the largest temporaries."""

    from repro_torch.kernels.flash_attention.ref import visible_mask

    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    u, w = BF16_UNIT, ACC_UNIT
    dq_ref, dk_ref, dv_ref = (t.float() for t in ref)
    bdq = torch.empty_like(dq_ref)
    bdk = torch.empty_like(dk_ref)
    bdv = torch.empty_like(dv_ref)
    mask = visible_mask(Sq, Skv, causal, window, q.device)
    for b in range(B):
        for kh in range(KH):
            hs = slice(kh * G, (kh + 1) * G)
            qg, dog = q[b, hs].float(), do[b, hs].float()
            kk, vv = k[b, kh].float(), v[b, kh].float()
            mg = m[b, hs, :, None]
            lg = l[b, hs, :, None]
            dg = delta[b, hs, :, None]
            s = qg @ kk.T * sm_scale
            ok = mask & (lg > 0)
            p = torch.where(ok, torch.exp(s - mg) / torch.where(lg > 0, lg,
                                                                 1.0), 0.0)
            del s
            dpd = (dog @ vv.T - dg).abs()
            e_s = (2 * D * w * sm_scale) * (qg.abs() @ kk.abs().T)
            e_p = (2 * D * w) * (dog.abs() @ vv.abs().T)
            err_ds = p * (e_s * dpd + e_p)
            ds = p * dpd
            pe = p * e_s
            del e_s, e_p
            n_dq, n_kv = Skv, G * Sq
            bdq[b, hs] = (u + 2 * n_dq * w) * (
                sm_scale * ds @ kk.abs() + dq_ref[b, hs].abs()) \
                + sm_scale * err_ds @ kk.abs()
            qa, da = qg.abs(), dog.abs()
            bdk[b, kh] = (u + 2 * n_kv * w) * (
                sm_scale * torch.einsum("gqc,gqd->cd", ds, qa)
                + dk_ref[b, kh].abs()) \
                + sm_scale * torch.einsum("gqc,gqd->cd", err_ds, qa)
            bdv[b, kh] = (u + 2 * n_kv * w) * (
                torch.einsum("gqc,gqd->cd", p, da) + dv_ref[b, kh].abs()) \
                + torch.einsum("gqc,gqd->cd", pe, da)
            del p, dpd, err_ds, ds, pe
    return bdq, bdk, bdv
