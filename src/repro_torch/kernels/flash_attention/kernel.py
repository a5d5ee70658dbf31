"""Launch wrapper for the Hopper flash-attention forward kernel
(``src/repro_torch/csrc/flash_attention_fwd.cu``).

The kernel replaces the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_fwd``.  It reads q, k and v
through strides in either the LM's ``[B, S, H, D]`` layout (``"bshd"``) or
the ``[B, H, S, D]`` layout of ``ops.flash_attention`` (``"bhsd"``), writes
the output in q's layout and dtype, and the row statistics ``m`` and ``l``
as f32 ``[B, H, Sq]``.  This wrapper checks what the kernel takes,
allocates the outputs, launches on PyTorch's current stream and counts the
launch.  It never falls back: a tensor the kernel does not take raises.
Forward only: the backward kernels are ROADMAP B3/B4.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["flash_fwd", "bf16_error_bound", "launch_count",
           "reset_launch_count", "LAYOUTS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAYOUTS = ("bhsd", "bshd")
MAX_HEAD_DIM = 256

# Launches of the kernel since the last reset (one per wrapper call that
# reaches the card).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


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


def _bhsd_strides(t: torch.Tensor, layout: str) -> Tuple[int, int, int]:
    """(batch, seq, head) element strides of a tensor in ``layout``."""

    if layout == "bhsd":
        return t.stride(0), t.stride(2), t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, window: Optional[int], sm_scale: float,
    layout: str = "bhsd",
):
    """Returns ``(out, m, l)``: ``out`` in q's layout and dtype, ``m`` and
    ``l`` f32 ``[B, H, Sq]`` (see :mod:`.ref` for the contract)."""

    global launch_count
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd needs q, k and v on one CUDA device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_fwd is forward only: the backward kernels "
            "(flash_bwd_dq, flash_bwd_dkv) are ROADMAP B3/B4")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes f32 or bf16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_fwd needs 4-d q and equal 4-d k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if layout == "bhsd":
        B, H, Sq, D = q.shape
        Bk, KH, Skv, Dk = k.shape
    else:
        B, Sq, H, D = q.shape
        Bk, Skv, KH, Dk = k.shape
    if (Bk, Dk) != (B, D) or KH == 0 or H % KH:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree ({layout})")
    if window is not None and window < 0:
        raise ValueError(f"flash_fwd: window must be >= 0, got {window}")
    if D % 16 or not 16 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd takes a head dim that is a multiple of "
                         f"16 up to {MAX_HEAD_DIM}, got {D}")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_fwd: {name} must be contiguous in its "
                             f"last dim")
        if t.data_ptr() % 16 or any(
                s * size % 16 for s in _bhsd_strides(t, layout)):
            raise ValueError(f"flash_fwd: {name} must be 16-byte aligned in "
                             f"its pointer and strides")
    if max(B * H * Sq, B * KH * Skv) * D >= 2 ** 62 or Sq >= 2 ** 31 \
            or Skv >= 2 ** 31:
        raise ValueError("flash_fwd: tensor too large")

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
        _DTYPES[q.dtype], B, H, KH, Sq, Skv, D,
        *_bhsd_strides(q, layout), *_bhsd_strides(k, layout),
        *_bhsd_strides(v, layout), *_bhsd_strides(out, layout),
        int(bool(causal)), -1 if window is None else int(window),
        float(sm_scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out, m, l


BF16_UNIT = 2.0 ** -8     # unit roundoff of bf16
ACC_UNIT = 2.0 ** -23     # of an f32 sum that may truncate (tensor cores)


def bf16_error_bound(ref: torch.Tensor, ref_abs_v: torch.Tensor,
                     skv: int, d: int) -> torch.Tensor:
    """Per-element bound on ``|flash_fwd(q, k, v)[0] - ref|`` on the bf16
    route, where ``ref = attention_reference(q, k, v)`` and ``ref_abs_v =
    attention_reference(q, k, |v|)`` (same masks and scale; f32).

    The route rounds each probability p_j to bf16 before P V and divides
    by l summed from the unrounded p_j, so P's rounding moves a row's
    output by at most 2^-8 sum_j p_j |v_j| / l = 2^-8 ``ref_abs_v``; the
    output's own rounding to bf16 adds 2^-8 |out|.  The f32 sums of the
    kernel and of the reference (over ``skv`` keys and ``d`` lanes, at
    2^-23 for a truncating accumulator) add (skv + d) 2^-23 each, relative
    to the same two magnitudes.  To first order in these units."""

    eps = 2 * (skv + d) * ACC_UNIT
    return (BF16_UNIT + eps) * (ref_abs_v + ref.abs())
