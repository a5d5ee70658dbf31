"""Physical operators of the single-device Pregel path (paper Section 4,
Figures 4 and 9), in PyTorch.

The port of the single-device half of :mod:`repro.core.physical`: the
group-by / combine primitives (sorted segment combine and scatter combine,
the two receiver algorithms of Fig. 9), the index join (Fig. 4 O7), the
frontier compaction of the semi-naive supersteps, and the three Pregel
connectors with their sparse variants for one device (``axes == ()``).

Every fast-path combine on a CUDA tensor with an f32/bf16 payload runs the
hand-written segment-combine kernel, which adds in a fixed order: the
scatter combine sorts by destination first (a stable sort keeps each
destination's rows in arrival order) and then runs the same kernel, so no
combine on the path uses float atomics.  On the CPU both stay plain
scatters that match the JAX reference.
"""

from __future__ import annotations

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
]


# The fast-path table: op -> (binary combine, identity of the plain scatter).
COMBINE_OPS = {
    "sum": (torch.add, 0.0),
    "max": (torch.maximum, float("-inf")),
    "min": (torch.minimum, float("inf")),
}


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
    flat = values.reshape(values.shape[0], -1)
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

    flat = values.reshape(values.shape[0], -1)
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
        flat = values.reshape(values.shape[0], -1).contiguous()
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

    flat = payload.reshape(payload.shape[0], -1)
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
