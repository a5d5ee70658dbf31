"""Launch wrapper for the Hopper sorted segment combine
(``src/repro_torch/csrc/segment_combine.cu``).

The kernel replaces the Pallas TPU kernel
``repro.kernels.segment_combine.kernel.segment_combine_pallas``.  This
wrapper checks what the kernel takes, allocates the output and the band
scratch, launches on PyTorch's current stream and counts the launch.  It
never falls back: a tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["segment_combine_cuda", "launch_count", "reset_launch_count"]

_OPS = {"sum": 0, "max": 1, "min": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel since the last reset (one per wrapper call that
# reaches the card).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("segment_combine")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.segment_combine_launch.argtypes = [
            p, ctypes.c_int, p, p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, p, p, p,
        ]
        lib.segment_combine_launch.restype = ctypes.c_int
        lib.segment_combine_block_rows.restype = ctypes.c_int
        lib.segment_combine_max_width.restype = ctypes.c_int
        lib._typed = True
    return lib


def segment_combine_cuda(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    n_segments: int,
    op: str = "sum",
    *,
    edge_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[s] = op`` over the active rows with id ``s`` (see
    :mod:`repro_torch.kernels.segment_combine.ref` for the contract)."""

    global launch_count
    if not values.is_cuda:
        raise ValueError("segment_combine_cuda needs CUDA tensors")
    if op not in _OPS:
        raise ValueError(f"segment_combine_cuda: op must be sum/max/min, "
                         f"got {op!r}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"segment_combine_cuda takes f32 or bf16 values, got "
                        f"{values.dtype}")
    if values.ndim != 2 or not values.is_contiguous():
        raise ValueError("values must be a contiguous [E, F] tensor")
    E, F = values.shape
    if (segment_ids.dtype != torch.int32 or segment_ids.shape != (E,)
            or not segment_ids.is_contiguous()
            or segment_ids.device != values.device):
        raise ValueError("segment_ids must be a contiguous int32[E] tensor "
                         "on the values' device")
    if edge_active is not None and (
            edge_active.dtype != torch.bool or edge_active.shape != (E,)
            or not edge_active.is_contiguous()
            or edge_active.device != values.device):
        raise ValueError("edge_active must be a contiguous bool[E] tensor "
                         "on the values' device")
    if not 0 <= n_segments < 2**31 or E >= 2**31:
        raise ValueError("segment_combine_cuda needs E, n_segments < 2^31")
    lib = _library()
    if not 1 <= F <= lib.segment_combine_max_width():
        raise ValueError(f"segment_combine_cuda: payload width {F} is out of "
                         f"range [1, {lib.segment_combine_max_width()}]")
    out = torch.empty((n_segments, F), dtype=values.dtype,
                      device=values.device)
    if n_segments == 0:
        return out
    rows = lib.segment_combine_block_rows()
    n_blocks = (E + rows - 1) // rows
    scratch = torch.empty(max(2 * n_blocks, 1), dtype=torch.int32,
                          device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.segment_combine_launch(
        values.data_ptr(), _DTYPES[values.dtype], segment_ids.data_ptr(),
        None if edge_active is None else edge_active.data_ptr(),
        E, F, n_segments, _OPS[op], scratch.data_ptr(), out.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"segment_combine kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out
