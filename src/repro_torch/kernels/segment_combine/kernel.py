"""Launch wrapper for the Hopper sorted segment combine
(``src/repro_torch/csrc/segment_combine.cu``).

The kernel replaces the Pallas TPU kernel
``repro.kernels.segment_combine.kernel.segment_combine_pallas``.  This
wrapper checks what the kernel takes, allocates the output and the
scratch (sized from E, n and F alone: no host sync), launches on
PyTorch's current stream and counts the launch.  It never falls back: a
tensor the kernel does not take raises.

The kernel folds rows in chunks of ``CHUNK_ROWS`` and cuts a tile of
output segments whose rows span more than ``PIECE_CHUNKS`` chunks into
pieces of at most that many, one block each, folded in piece order by a
second pass.  :func:`sum_depth` is the summation depth that decomposition
gives a segment, and :func:`summation_depths` computes it for every
segment of an input, mirroring the kernel's tiles and pieces.

A payload wider than the kernel's ``ACC_FLOATS`` accumulator is combined
one column slice at a time (:func:`column_slices`): one launch a slice,
each deterministic, so the result stays bit-identical from call to call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.launch.census import refuse_kernel

__all__ = ["segment_combine_cuda", "launch_count", "reset_launch_count",
           "CHUNK_ROWS", "CHUNK_DEPTH", "PIECE_CHUNKS", "ACC_FLOATS",
           "column_slices", "sum_depth", "summation_shape",
           "summation_depths"]

_OPS = {"sum": 0, "max": 1, "min": 2}

# The kernel's decomposition (csrc/segment_combine.cu; checked against the
# library when it loads): rows per chunk (256 threads of 4 consecutive
# rows), the most chunks one block folds (K), and the floats of one tile's
# accumulator (a tile holds min(ACC_FLOATS // F, CHUNK_ROWS) segments).
CHUNK_ROWS = 1024
PIECE_CHUNKS = 8
ACC_FLOATS = 8192
# Additions a term passes through inside its chunk: 3 in its thread's
# rows, a 5-level warp scan, 1 for the lanes before, then up to 7 folds of
# earlier warps' tails.
CHUNK_DEPTH = 3 + 5 + 1 + 7


def column_slices(width: int):
    """The ``(start, stop)`` column ranges that one launch each combines:
    consecutive slices of ``ACC_FLOATS`` columns, the last one shorter."""

    return [(c, min(c + ACC_FLOATS, width))
            for c in range(0, width, ACC_FLOATS)]


def sum_depth(chunks, pieces):
    """The most f32 additions a term of a segment passes through, for a
    segment whose valid rows lie in ``chunks`` chunks and ``pieces``
    pieces (ints or integer tensors): ``CHUNK_DEPTH`` in its chunk, one a
    chunk into its piece's accumulator (at most ``PIECE_CHUNKS`` chunks a
    piece), and ``pieces - 1`` folds of the pieces in order.  A segment in
    one piece gets ``CHUNK_DEPTH + chunks``."""

    if isinstance(chunks, torch.Tensor):
        in_piece = chunks.clamp(max=PIECE_CHUNKS)
    else:
        in_piece = min(chunks, PIECE_CHUNKS)
    return CHUNK_DEPTH + in_piece + pieces - 1


def summation_shape(
    segment_ids: torch.Tensor,
    n_segments: int,
    width: int,
    edge_active: Optional[torch.Tensor] = None,
):
    """``(chunks, pieces)``, int64 ``[n_segments]``: for each segment, the
    chunks and the pieces of the kernel's decomposition that hold its valid
    rows at payload width ``width`` (0 for an empty segment).  Mirrors the
    kernel: a tile's first edge block b0 is the first whose running maximum
    of valid ids reaches the tile, and a row of chunk b lies in piece
    (b - b0) // PIECE_CHUNKS.  ``width`` is one launch's, at most
    ``ACC_FLOATS`` (see :func:`column_slices`)."""

    if not 1 <= width <= ACC_FLOATS:
        raise ValueError(f"summation_shape: one launch's width is in [1, "
                         f"{ACC_FLOATS}], got {width}")
    ids = segment_ids.long()
    E = ids.shape[0]
    valid = (ids >= 0) & (ids < n_segments)
    if edge_active is not None:
        valid &= edge_active
    nb = -(-E // CHUNK_ROWS)
    key = torch.full((nb * CHUNK_ROWS,), -1, dtype=torch.long,
                     device=ids.device)
    key[:E] = torch.where(valid, ids, -1)
    pref = torch.cummax(key.view(nb, CHUNK_ROWS).max(1).values, 0).values
    del key
    tile_n = min(ACC_FLOATS // width, CHUNK_ROWS)
    rows = torch.nonzero(valid).squeeze(1)
    seg = ids[rows]
    chunk = rows // CHUNK_ROWS
    del rows
    b0 = torch.searchsorted(pref, (seg // tile_n) * tile_n)
    piece = (chunk - b0) // PIECE_CHUNKS
    del b0

    def runs(part):
        first = torch.ones_like(seg, dtype=torch.bool)
        first[1:] = (seg[1:] != seg[:-1]) | (part[1:] != part[:-1])
        return torch.bincount(seg[first], minlength=n_segments)

    return runs(chunk), runs(piece)


def summation_depths(
    segment_ids: torch.Tensor,
    n_segments: int,
    width: int,
    edge_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`sum_depth` of every segment (int64 ``[n_segments]``) at
    payload width ``width``: for a payload cut into column slices, the
    deepest over the slices' widths."""

    depths = None
    for w in sorted({stop - start for start, stop in column_slices(width)}):
        chunks, pieces = summation_shape(segment_ids, n_segments, w,
                                         edge_active)
        d = sum_depth(chunks, pieces.clamp(min=1))
        depths = d if depths is None else torch.maximum(depths, d)
    return depths


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
        i, ll = ctypes.c_int, ctypes.c_longlong
        lib.segment_combine_launch.argtypes = [
            p, i, p, p, ll, i, i, i, i, p, p, p,
        ]
        lib.segment_combine_launch.restype = i
        lib.segment_combine_scratch_bytes.argtypes = [ll, i, i, i]
        lib.segment_combine_scratch_bytes.restype = ll
        for name in ("block_rows", "max_width", "piece_chunks"):
            getattr(lib, f"segment_combine_{name}").restype = i
        built = (lib.segment_combine_block_rows(),
                 lib.segment_combine_piece_chunks(),
                 lib.segment_combine_max_width())
        if built != (CHUNK_ROWS, PIECE_CHUNKS, ACC_FLOATS):
            raise RuntimeError(
                f"segment_combine library built with (rows, K, accumulator) "
                f"{built}, the wrapper expects "
                f"{(CHUNK_ROWS, PIECE_CHUNKS, ACC_FLOATS)}")
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
    :mod:`repro_torch.kernels.segment_combine.ref` for the contract).  One
    launch for each of :func:`column_slices` of the payload's width."""

    global launch_count
    if not values.is_cuda:
        raise ValueError("segment_combine_cuda needs CUDA tensors")
    refuse_kernel("segment_combine (B1)")
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
    out = torch.empty((n_segments, F), dtype=values.dtype,
                      device=values.device)
    if n_segments == 0 or F == 0:
        return out
    lib = _library()
    slices = column_slices(F)
    for start, stop in slices:
        whole = len(slices) == 1
        part = values if whole else values[:, start:stop].contiguous()
        dst = out if whole else torch.empty(
            (n_segments, stop - start), dtype=values.dtype,
            device=values.device)
        err = _launch(lib, part, segment_ids, n_segments, op, edge_active,
                      PIECE_CHUNKS, dst)
        if err != 0:
            raise RuntimeError(f"segment_combine kernel launch failed: CUDA "
                               f"error {err}")
        launch_count += 1
        if not whole:
            out[:, start:stop] = dst
    return out


def _launch(lib, values, segment_ids, n_segments, op, edge_active, split,
            out) -> int:
    """One launch of the library's C entry point with split length
    ``split`` (0: one block a tile, however long), on checked inputs,
    scratch allocated here; returns the CUDA error.  Counts nothing: the
    wrapper above counts its own launches."""

    E, F = values.shape
    nbytes = lib.segment_combine_scratch_bytes(E, F, n_segments, split)
    scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8,
                          device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    return lib.segment_combine_launch(
        values.data_ptr(), _DTYPES[values.dtype], segment_ids.data_ptr(),
        None if edge_active is None else edge_active.data_ptr(),
        E, F, n_segments, _OPS[op], split, scratch.data_ptr(),
        out.data_ptr(), stream,
    )
