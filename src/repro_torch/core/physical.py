"""Physical operators of the single-device Pregel path (paper Section 4,
Figures 4 and 9), in PyTorch.

The port of the single-device half of :mod:`repro.core.physical`: the
group-by / combine primitives (sorted segment combine and scatter combine,
the two receiver algorithms of Fig. 9), the index join (Fig. 4 O7), the
frontier compaction of the semi-naive supersteps, the three Pregel
connectors with their sparse variants for one device (``axes == ()``),
and the row-table primitives of the generic executor's sparse storage
(row codes, sort-merge join, set-difference, grid <-> row converters).

Every fast-path combine on a CUDA tensor with an f32/bf16 payload runs the
hand-written segment-combine kernel, which adds in a fixed order: the
scatter combine sorts by destination first (a stable sort keeps each
destination's rows in arrival order) and then runs the same kernel, so no
combine on the path uses float atomics.  On the CPU both stay plain
scatters that match the JAX reference.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.monoid import (
    CombineMonoid,
    generic_segment_combine,
    get_monoid,
)
from repro_torch.kernels.segment_combine.kernel import segment_combine_cuda
from repro_torch.kernels.segment_combine.ops import kernel_eligible

__all__ = [
    "segment_combine_sorted",
    "scatter_combine",
    "index_join",
    "dense_psum_exchange",
    "merging_exchange",
    "hash_sort_exchange",
    "compact_active_edges",
    "sparse_merging_exchange",
    "sparse_hash_sort_exchange",
    "fused_got_exchange",
    "COMBINE_OPS",
    "row_codes",
    "sort_row_codes",
    "unique_row_runs",
    "join_row_codes",
    "difference_row_codes",
    "grid_to_rows",
    "row_linear_index",
    "rows_to_grid",
]


# The fast-path table: op -> (binary combine, identity of the plain scatter).
COMBINE_OPS = {
    "sum": (torch.add, 0.0),
    "max": (torch.maximum, float("-inf")),
    "min": (torch.minimum, float("inf")),
}


def _rows_2d(values: torch.Tensor) -> torch.Tensor:
    """``values[E, ...]`` as ``[E, W]``, W the product of the trailing dims
    (1 for a 1-D slab).  The width is explicit: torch cannot infer a -1
    dimension of a tensor with no elements, and a combine of 0 rows must
    still return its identity-filled output."""

    return values.reshape(values.shape[0], math.prod(values.shape[1:]))


def _require_single_device(axes: Tuple[str, ...]) -> None:
    if axes:
        raise NotImplementedError(
            f"sharded connectors (axes={axes!r}) are not ported yet: "
            "ROADMAP A10 (multi-GPU)"
        )


def _generic_combine(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    monoid: CombineMonoid,
    *,
    edge_active=None,
    flag_cols: int = 0,
    presorted: bool,
) -> torch.Tensor:
    """Rank-normalizing wrapper over :func:`generic_segment_combine`:
    scalar-payload monoids accept [E] / [E, ...] slabs (flattened to 2-D and
    restored); structured monoids require [E, W] exactly."""

    if values.ndim == 2:
        return generic_segment_combine(
            values, segment_ids, num_segments, monoid,
            edge_active=edge_active, flag_cols=flag_cols,
            presorted=presorted,
        )
    if monoid.structured or flag_cols:
        raise ValueError(
            f"monoid {monoid.name!r} needs [rows, width] payloads, got "
            f"shape {tuple(values.shape)}"
        )
    flat = _rows_2d(values)
    out = generic_segment_combine(
        flat, segment_ids, num_segments, monoid,
        edge_active=edge_active, presorted=presorted,
    )
    return out.reshape((num_segments,) + tuple(values.shape[1:]))


def _plain_scatter(
    values: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    op: str,
    keep: torch.Tensor,
) -> torch.Tensor:
    """Scatter-combine the rows where ``keep`` holds; the others go to a
    spill row that is sliced off (``index_add_`` raises on an out-of-range
    index, where XLA's scatter drops it).  Empty segments read the op's
    identity: 0, -inf or +inf (the integer extremes for integer payloads)."""

    flat = _rows_2d(values)
    idx = torch.where(keep, ids.to(torch.int64), num_segments)
    init = COMBINE_OPS[op][1]
    if not values.dtype.is_floating_point and op != "sum":
        info = torch.iinfo(values.dtype)
        init = info.min if op == "max" else info.max
    out = torch.full((num_segments + 1, flat.shape[1]), init,
                     dtype=values.dtype, device=values.device)
    if op == "sum":
        out.index_add_(0, idx, flat)
    else:
        out.scatter_reduce_(
            0, idx[:, None].expand(-1, flat.shape[1]), flat,
            reduce="amax" if op == "max" else "amin", include_self=True,
        )
    return out[:num_segments].reshape(
        (num_segments,) + tuple(values.shape[1:])
    )


def segment_combine_sorted(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "sum",
    *,
    edge_active: Optional[torch.Tensor] = None,
    flag_cols: int = 0,
) -> torch.Tensor:
    """Pre-clustered (sorted) group-by combine — the *merging* side of
    Fig. 9.  Requires the ids of the kept rows sorted ascending.

    A CUDA tensor with an f32/bf16 payload runs the segment-combine kernel
    (empty segments read 0, see its contract); anything else runs a plain
    scatter that matches the JAX package's XLA segment ops (empty max/min
    segments read -inf/+inf).  Pregel callers gate empty segments behind
    the got-a-message mask either way.  ``edge_active`` excludes rows
    outside the frontier; ``op`` names any registered monoid, and monoids
    without a ``kernel_op`` take the generic path, where the trailing
    ``flag_cols`` combine under ``max``.
    """

    monoid = get_monoid(op)
    if monoid.kernel_op is None:
        return _generic_combine(
            values, segment_ids, num_segments, monoid,
            edge_active=edge_active, flag_cols=flag_cols, presorted=True,
        )
    op = monoid.kernel_op
    if kernel_eligible(values, op):
        flat = _rows_2d(values).contiguous()
        out = segment_combine_cuda(
            flat, segment_ids.to(torch.int32).contiguous(), num_segments,
            op,
            edge_active=None if edge_active is None
            else edge_active.contiguous(),
        )
        return out.reshape((num_segments,) + tuple(values.shape[1:]))
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    if edge_active is not None:
        keep = keep & edge_active
    return _plain_scatter(values, segment_ids, num_segments, op, keep)


def scatter_combine(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "sum",
    *,
    edge_active: Optional[torch.Tensor] = None,
    flag_cols: int = 0,
) -> torch.Tensor:
    """Unordered scatter-reduce — the *hash* side of Fig. 9.

    No sortedness assumption: every row combines into its destination.
    Rows where ``edge_active`` is False, and ids at or beyond
    ``num_segments``, are dropped; a negative id counts from the end, as
    XLA's scatter indexing does.  On a CUDA tensor with an f32/bf16 payload
    the rows are stably sorted by destination and combined by the
    segment-combine kernel, so sums come out the same on every run.
    Generic monoids sort by destination and run the segmented-scan path.
    """

    monoid = get_monoid(op)
    if monoid.kernel_op is None:
        return _generic_combine(
            values, segment_ids, num_segments, monoid,
            edge_active=edge_active, flag_cols=flag_cols, presorted=False,
        )
    op = monoid.kernel_op
    ids = segment_ids.to(torch.int32)
    ids = torch.where(ids < 0, ids + num_segments, ids)
    if kernel_eligible(values, op):
        ids, order = torch.sort(ids, stable=True)
        return segment_combine_sorted(
            values[order], ids, num_segments, op,
            edge_active=None if edge_active is None else edge_active[order],
        )
    keep = (ids >= 0) & (ids < num_segments)
    if edge_active is not None:
        keep = keep & edge_active
    return _plain_scatter(values, ids, num_segments, op, keep)


def index_join(state: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Index join (Fig. 4 O7): probe the dense id-indexed state by gather."""

    return torch.index_select(state, 0, ids)


# ---------------------------------------------------------------------------
# Pregel message-exchange connectors (Fig. 4 connectors, Fig. 9 variants)
# ---------------------------------------------------------------------------
#
# Contract: ``dst_ids`` int32[E] global destination ids, ``payload``
# [E, ...] per-edge messages computed from source state; every connector
# returns the combined inbound messages [n_vertices, ...].  On one device
# the three differ in how the receiver groups: dense_psum scatters, merging
# sorts and runs the sorted combine, hash_sort scatters in arrival order.


def compact_active_edges(
    edge_mask: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity compaction of the active-edge frontier: a prefix sum
    over the mask and a binary search for the edge where the running count
    first reaches each of the ``cap`` slots.  Returns ``(idx, valid)``:
    ``idx`` int32[cap] (edge index, or E for an empty slot) and ``valid``
    bool[cap].  Active edges beyond ``cap`` are dropped; the adaptive driver
    picks ``cap`` from the measured frontier, so that never happens there.
    """

    E = edge_mask.shape[0]
    device = edge_mask.device
    if E == 0:
        return (
            torch.zeros(cap, dtype=torch.int32, device=device),
            torch.zeros(cap, dtype=torch.bool, device=device),
        )
    csum = torch.cumsum(edge_mask.to(torch.int32), 0, dtype=torch.int32)
    slots = torch.arange(1, cap + 1, dtype=torch.int32, device=device)
    idx = torch.searchsorted(csum, slots, side="left").to(torch.int32)
    valid = torch.arange(cap, dtype=torch.int32, device=device) < csum[-1]
    idx = torch.where(valid, idx, E)
    return idx, valid


def fused_got_exchange(
    exchange: Callable[[torch.Tensor], torch.Tensor],
    payload: torch.Tensor,
    edge_valid: torch.Tensor,
    op: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One exchange for ``(inbox, got)`` instead of two: a flag column that
    carries 1.0 on every occupied slot rides (and combines) with the
    payload.  ``sum`` flags count messages (``got = flag > 0``); ``max``
    reads 1.0 where a message arrived; ``min`` reads exactly 1.0 there and
    +inf (plain) or 0 (kernel) where none did, so ``got = flag == 1.0``;
    generic monoids combine the flag under ``max``."""

    flat = _rows_2d(payload)
    flag = torch.where(edge_valid, 1.0, 0.0).to(flat.dtype)
    fused = torch.cat([flat, flag[:, None]], dim=1)
    out = exchange(fused)
    inbox = out[..., :-1].reshape(
        (out.shape[0],) + tuple(payload.shape[1:])
    )
    got = get_monoid(op).got_mask(out[..., -1])
    return inbox, got


def dense_psum_exchange(
    dst_ids: torch.Tensor,
    payload: torch.Tensor,
    n_vertices: int,
    axes: Tuple[str, ...],
    op: str = "sum",
    edge_mask: Optional[torch.Tensor] = None,
    flag_cols: int = 0,
) -> torch.Tensor:
    """Dense partial-vector exchange.  On one device it is the scatter
    combine of the outbound messages into a length-N vector; ``edge_mask``
    drops inactive edges (the frontier-masked path)."""

    _require_single_device(axes)
    return scatter_combine(
        payload, dst_ids, n_vertices, op, edge_active=edge_mask,
        flag_cols=flag_cols,
    )


def _single_device_exchange(
    dst_ids, payload, n_vertices, op, presorted, edge_active=None,
    flag_cols=0,
):
    if presorted:
        order = torch.argsort(dst_ids, stable=True)
        act = None if edge_active is None else edge_active[order]
        return segment_combine_sorted(
            payload[order], dst_ids[order], n_vertices, op,
            edge_active=act, flag_cols=flag_cols,
        )
    return scatter_combine(
        payload, dst_ids, n_vertices, op, edge_active=edge_active,
        flag_cols=flag_cols,
    )


def merging_exchange(dst_ids, payload, n_vertices, axes,
                     op="sum", bucket_cap=None, edge_mask=None,
                     flag_cols=0):
    """The hash-partitioning *merging* connector (Fig. 4): sort by
    destination, then the sorted combine.  ``edge_mask`` excludes inactive
    edges; on the card the kernel skips edge blocks that are wholly
    inactive.  ``bucket_cap`` sizes the all-to-all buckets of the sharded
    form and is unused on one device."""

    _require_single_device(axes)
    return _single_device_exchange(
        dst_ids, payload, n_vertices, op, True,
        edge_active=edge_mask, flag_cols=flag_cols,
    )


def hash_sort_exchange(dst_ids, payload, n_vertices, axes,
                       op="sum", bucket_cap=None, edge_mask=None,
                       flag_cols=0):
    """The hash connector with receiver-side grouping (Fig. 9 variant): the
    receiver scatter-combines in arrival order."""

    _require_single_device(axes)
    return _single_device_exchange(
        dst_ids, payload, n_vertices, op, False,
        edge_active=edge_mask, flag_cols=flag_cols,
    )


def sparse_merging_exchange(
    dst_ids: torch.Tensor,
    payload: torch.Tensor,
    edge_valid: torch.Tensor,
    n_vertices: int,
    axes: Tuple[str, ...],
    op: str = "sum",
    bucket_cap: Optional[int] = None,
    flag_cols: int = 0,
) -> torch.Tensor:
    """Frontier-compacted variant of :func:`merging_exchange` over a
    ``cap``-sized slab; ``edge_valid`` marks its occupied slots."""

    return merging_exchange(
        dst_ids, payload, n_vertices, axes, op, bucket_cap,
        edge_mask=edge_valid, flag_cols=flag_cols,
    )


def sparse_hash_sort_exchange(
    dst_ids: torch.Tensor,
    payload: torch.Tensor,
    edge_valid: torch.Tensor,
    n_vertices: int,
    axes: Tuple[str, ...],
    op: str = "sum",
    bucket_cap: Optional[int] = None,
    flag_cols: int = 0,
) -> torch.Tensor:
    """Frontier-compacted variant of :func:`hash_sort_exchange`."""

    return hash_sort_exchange(
        dst_ids, payload, n_vertices, axes, op, bucket_cap,
        edge_mask=edge_valid, flag_cols=flag_cols,
    )


# ---------------------------------------------------------------------------
# Row-table primitives (sparse storage for the generic executor)
# ---------------------------------------------------------------------------
#
# A *row table* is the compacted sparse counterpart of the executor's dense
# vertex-domain grids: a fixed-capacity slab of id columns ``int32[cap, k]``
# plus a validity mask ``bool[cap]`` (value columns ride alongside as
# ``[cap]`` tensors owned by the caller).  Every primitive below keeps its
# shapes static and reads nothing back to the host; set semantics ride on
# *row codes*, the lexicographic encoding of a row's id tuple, so Join is a
# sort-merge over codes, AntiJoin an exact searchsorted set-difference, and
# GroupBy/dedupe unique-run segment combines.
#
# Codes are int64 (the reference packs uint32 codes, which torch can
# neither searchsorted on the CPU nor lexsort): the ``n**k <= 2**32`` guard
# stays, so every valid code lies below ``_ROW_SENTINEL`` and a stable sort
# of one composed key puts exactly the valid rows first.  Every index that
# could leave its range (a pair past the true count, a row past the valid
# prefix, an invalid row's scatter) is clamped or sent to a spill slot that
# is sliced off: torch raises on such an index where XLA drops it.
#
# Capacity discipline: joins expand into a caller-chosen ``out_cap`` and
# report an ``overflow`` flag (a device bool) instead of silently dropping
# rows; the executor accumulates those flags and falls back to the dense
# grids when any fires (lossless overflow policy).

# The sort key of an invalid row: one past the largest valid code.
_ROW_SENTINEL = 1 << 32


def row_codes(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Lexicographic int64 code of each id row: ``sum ids[:, i] *
    n**(k-1-i)``.

    Requires ``n ** k <= 2**32`` (checked statically), the reference's
    code space, so the planner's row-table choices and their errors stay
    the reference's.
    """

    cap, k = ids.shape
    if k and float(n) ** k > 4294967296.0:
        raise ValueError(
            f"row_codes: domain**arity = {n}**{k} exceeds the 2^32 row-code "
            "space (row-table storage caps key arity by domain size)"
        )
    code = torch.zeros(cap, dtype=torch.int64, device=ids.device)
    for i in range(k):
        code = code * n + ids[:, i].to(torch.int64)
    return code


def sort_row_codes(
    codes: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort a row table by code with valid rows first.

    Returns ``(perm, sorted_key, n_valid)``: ``perm`` (int64) reorders any
    per-row tensor into sorted order, ``sorted_key`` is monotone (valid
    rows' ascending codes, then ``_ROW_SENTINEL`` for the invalid suffix),
    and the first ``n_valid`` (an int32 device scalar) sorted slots are
    exactly the valid rows.  The sort is stable, so equal codes keep their
    slab order: the reference's permutation.
    """

    skey = torch.where(valid, codes, _ROW_SENTINEL)
    sorted_key, perm = torch.sort(skey, stable=True)
    return perm, sorted_key, valid.sum(dtype=torch.int32)


def unique_row_runs(
    sorted_key: torch.Tensor, n_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-occurrence mask and segment ids (int32) of the unique runs in
    a sorted key tensor (valid prefix only).  ``seg[i]`` numbers the run
    row ``i`` belongs to; rows past ``n_valid`` alias the last run and
    must be masked by the caller (``edge_active``)."""

    cap = sorted_key.shape[0]
    ar = torch.arange(cap, dtype=torch.int32, device=sorted_key.device)
    prev = torch.cat([sorted_key[:1], sorted_key[:-1]])
    is_new = (ar < n_valid) & ((ar == 0) | (sorted_key != prev))
    seg = torch.clamp(torch.cumsum(is_new, 0, dtype=torch.int32) - 1, min=0)
    return is_new, seg


def join_row_codes(
    l_codes: torch.Tensor,
    l_valid: torch.Tensor,
    r_codes: torch.Tensor,
    r_valid: torch.Tensor,
    out_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-merge equi-join of two row tables on their codes.

    The right table is sorted once; each left row finds its matching run by
    binary search, and a prefix sum over per-row match counts lays the pairs
    out densely into ``out_cap`` slots (the static-shape pair expansion).
    Returns ``(li, ri, valid, overflow)``: left/right row indices (int64,
    always in range) per output slot, the slot validity mask, and a device
    flag set when the true pair count exceeds ``out_cap`` (pairs beyond
    the cap are dropped: the caller must honor the flag).
    """

    cap_l, cap_r = l_codes.shape[0], r_codes.shape[0]
    device = l_codes.device
    t = torch.arange(out_cap, dtype=torch.int64, device=device)
    if cap_l == 0 or cap_r == 0:
        zeros = torch.zeros(out_cap, dtype=torch.int64, device=device)
        return (zeros, zeros, torch.zeros(out_cap, dtype=torch.bool,
                                          device=device),
                torch.zeros((), dtype=torch.bool, device=device))
    perm_r, r_skey, r_nv = sort_row_codes(r_codes, r_valid)
    start = torch.searchsorted(r_skey, l_codes, side="left")
    # Clamp to the valid prefix: a left code equal to the sentinel would
    # otherwise also "match" the invalid suffix.
    end = torch.minimum(torch.searchsorted(r_skey, l_codes, side="right"),
                        r_nv.to(torch.int64))
    cnt = torch.where(l_valid, torch.clamp(end - start, min=0), 0)
    offs = torch.cumsum(cnt, 0)
    total = offs[-1]
    li = torch.clamp(torch.searchsorted(offs, t, side="right"),
                     max=cap_l - 1)
    before = offs[li] - cnt[li]
    rpos = torch.clamp(start[li] + (t - before), 0, cap_r - 1)
    return li, perm_r[rpos], t < total, total > out_cap


def difference_row_codes(
    l_codes: torch.Tensor,
    l_valid: torch.Tensor,
    r_codes: torch.Tensor,
    r_valid: torch.Tensor,
) -> torch.Tensor:
    """Exact set-difference membership mask: True for valid left rows whose
    code has NO valid right row (the AntiJoin keep-mask).  Capacity-free:
    the left table is returned in place, only the mask changes."""

    cap_r = r_codes.shape[0]
    if cap_r == 0:
        return l_valid.clone()
    _, r_skey, r_nv = sort_row_codes(r_codes, r_valid)
    pos = torch.searchsorted(r_skey, l_codes, side="left")
    member = (pos < r_nv) & (r_skey[torch.clamp(pos, max=cap_r - 1)]
                             == l_codes)
    return l_valid & ~member


def grid_to_rows(
    present: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact a dense presence grid into a row table (``to_rows`` boundary
    converter).  Returns ``(ids, valid, lin, overflow)``: id columns
    ``int32[cap, k]``, slot validity, the clamped linear cell index per
    slot (int64, for gathering value grids via ``grid.reshape(-1)[lin]``),
    and the overflow flag (more present cells than ``cap``)."""

    device = present.device
    shape = tuple(present.shape)
    if not shape:
        valid = torch.zeros(cap, dtype=torch.bool, device=device)
        valid[:1] = present.to(torch.bool)
        return (
            torch.zeros((cap, 0), dtype=torch.int32, device=device),
            valid,
            torch.zeros(cap, dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
        )
    flat = present.reshape(-1)
    size = flat.shape[0]
    idx, valid = compact_active_edges(flat, cap)
    overflow = flat.sum(dtype=torch.int64) > cap
    lin = torch.clamp(idx.to(torch.int64), max=size - 1)
    cols, rest = [], lin
    for d in reversed(shape):
        cols.append((rest % d).to(torch.int32))
        rest = rest // d
    return torch.stack(cols[::-1], dim=-1), valid, lin, overflow


def row_linear_index(ids: torch.Tensor, valid: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Linear dense-grid cell index of each row (int64 ``[cap]``); invalid
    rows get the spill index ``n**k``, one past the grid, which a scatter
    into ``n**k + 1`` cells writes and then slices off.  Only meaningful
    when the dense grid is materializable."""

    return torch.where(valid, row_codes(ids, n), int(n) ** ids.shape[1])


def rows_to_grid(ids: torch.Tensor, valid: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Scatter a row table back onto the dense presence grid (``to_grid``
    boundary converter)."""

    k = ids.shape[1]
    if k == 0:
        return valid.any()
    size = int(n) ** k
    flat = torch.zeros(size + 1, dtype=torch.bool, device=ids.device)
    flat[row_linear_index(ids, valid, n)] = True
    return flat[:size].reshape((n,) * k)
