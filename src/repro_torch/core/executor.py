"""The Pregel superstep builders of the unified executor (Fig. 4), on one
device.

The port of the Listing-1 part of :mod:`repro.core.executor`:
``build_pregel_steps`` materializes the planned superstep pipeline — the
dense superstep (index-join gather, message UDF, connector combine,
``_apply_and_merge``) and the factory of frontier-compacted sparse
supersteps that the adaptive driver swaps in.  The sharded layout
(``mesh=``) is ROADMAP A10; the generic ``compile_program`` engine is A8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.monoid import get_monoid
from repro_torch.core.physical import (
    compact_active_edges,
    dense_psum_exchange,
    fused_got_exchange,
    hash_sort_exchange,
    merging_exchange,
    sparse_hash_sort_exchange,
    sparse_merging_exchange,
)
from repro_torch.core.tree import tree_map

__all__ = ["PregelStepBundle", "build_pregel_steps"]

_EXCHANGES = {
    "dense_psum": dense_psum_exchange,
    "merging": merging_exchange,
    "hash_sort": hash_sort_exchange,
}

# Frontier-compacted connector variants (dense_psum has none: its masked
# path keeps the N-sized combine but runs edge work on the compacted slab).
_SPARSE_EXCHANGES = {
    "merging": sparse_merging_exchange,
    "hash_sort": sparse_hash_sort_exchange,
}


def _rows_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask[E]`` shaped to broadcast over ``like[E, ...]``."""

    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def _compact_and_gather(prog, j, state, active, src, dst, cap: int, *,
                        edge_data=None):
    """Sparse-superstep prologue: mask the edge slab by source activity,
    compact the frontier into ``cap`` slots, gather the compacted endpoints,
    state and edge data, and run the message UDF.  Returns ``(dst_c,
    payload, valid)``.  Empty slots carry a clamped in-range index: their
    payload is computed from real state but excluded via ``valid``."""

    if src.shape[0] == 0:
        # Zero-edge slab: one inert edge, masked off, so every gather below
        # has a real row (the clamp would otherwise wrap to -1).
        device = src.device
        src = torch.zeros(1, dtype=torch.int32, device=device)
        dst = torch.zeros(1, dtype=torch.int32, device=device)
        edge_data = tree_map(
            lambda e: torch.zeros((1,) + tuple(e.shape[1:]), dtype=e.dtype,
                                  device=device),
            edge_data,
        )
        mask = torch.zeros(1, dtype=torch.bool, device=device)
    else:
        mask = torch.index_select(active, 0, src)
    idx, valid = compact_active_edges(mask, cap)
    idx_c = torch.clamp(idx, max=src.shape[0] - 1)
    src_c = torch.index_select(src, 0, idx_c)
    dst_c = torch.index_select(dst, 0, idx_c)
    edata_c = tree_map(lambda e: torch.index_select(e, 0, idx_c), edge_data)
    src_state = tree_map(lambda s: torch.index_select(s, 0, src_c), state)
    payload = prog.message(j, src_state, edata_c)
    return dst_c, payload, valid


def _apply_and_merge(prog, j, state, inbox, got):
    """Superstep epilogue (O8..O10 + L7): finalize the inbox (``mean``),
    run the apply UDF, keep the old state wherever no message arrived, and
    halt those vertices.  Every superstep variant shares this merge."""

    monoid = get_monoid(prog.combine)
    if monoid.finalize is not None:
        inbox = monoid.finalize(inbox)
    new_state, new_active = prog.apply(j, state, inbox, got)
    merged = tree_map(
        lambda old, new: torch.where(_rows_mask(got, new), new, old),
        state, new_state,
    )
    return merged, new_active & got


@dataclass
class PregelStepBundle:
    """The steps ``compile_pregel`` wraps: the dense superstep, the
    frontier-compacted sparse factory (per static capacity), and the edge
    slab size (a capacity at or above it cannot win)."""

    superstep: Callable
    sparse_step_factory: Callable[[int], Callable]
    local_edge_cap: int


def build_pregel_steps(prog, graph, plan, mesh=None) -> PregelStepBundle:
    """Materialize the planned Listing-1 superstep pipeline on one
    device."""

    if mesh is not None:
        raise NotImplementedError(
            "sharded Pregel (mesh=) is not ported yet: ROADMAP A10 "
            "(multi-GPU)"
        )
    connector = _EXCHANGES[plan.connector]
    op = prog.combine
    monoid = get_monoid(op)
    n = graph.n_vertices

    def superstep(carry, j):
        """One superstep (Fig. 4's O7..O15 pipeline)."""

        state, active = carry
        # O7 index join: probe source state by gather.
        src_state = tree_map(
            lambda s: torch.index_select(s, 0, graph.src), state
        )
        src_active = torch.index_select(active, 0, graph.src)
        payload = prog.message(j, src_state, graph.edge_data)
        # Vote-to-halt: inactive sources contribute the combine identity.
        payload = torch.where(
            _rows_mask(src_active, payload), payload,
            monoid.identity_like(payload),
        )
        # O15 sender combine + connector + O14 receiver combine.
        inbox = connector(graph.dst, payload, n, (), op)
        got = connector(
            graph.dst, torch.where(src_active, 1.0, 0.0), n, (), "sum",
        ) > 0
        # O8 apply + O9/O10 masked state update (the L7 non-null check).
        return _apply_and_merge(prog, j, state, inbox, got)

    sparse_ex = _SPARSE_EXCHANGES.get(plan.connector)

    def sparse_step_factory(cap: int) -> Callable:
        """Frontier-compacted superstep: gather, message UDF, combine and
        exchange run over a ``cap``-sized slab of the active edges."""

        def step(carry, j):
            state, active = carry
            dst_c, payload, valid = _compact_and_gather(
                prog, j, state, active, graph.src, graph.dst, cap,
                edge_data=graph.edge_data,
            )
            if sparse_ex is None:
                ex = lambda fused: dense_psum_exchange(
                    dst_c, fused, n, (), op, edge_mask=valid, flag_cols=1,
                )
            else:
                ex = lambda fused: sparse_ex(
                    dst_c, fused, valid, n, (), op, flag_cols=1,
                )
            inbox, got = fused_got_exchange(ex, payload, valid, op)
            return _apply_and_merge(prog, j, state, inbox, got)

        return step

    return PregelStepBundle(
        superstep=superstep,
        sparse_step_factory=sparse_step_factory,
        local_edge_cap=graph.n_edges,
    )
