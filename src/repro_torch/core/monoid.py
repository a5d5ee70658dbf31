"""Extensible aggregate algebra: registrable combine monoids (PyTorch).

The port of :mod:`repro.core.monoid`.  A :class:`CombineMonoid` is a
commutative, associative combine with identity, registered once and resolved
by name wherever a combine happens: the logical layer's delta-safety
metadata (:meth:`CombineMonoid.as_aggregate`), the planner's payload-width
cost terms, and the connectors and group-by primitives of
:mod:`repro_torch.core.physical`.

A monoid combines *slabs*: tensors whose trailing dimension is the monoid's
payload width ``W`` (1 for plain elementwise combines).  ``combine`` must be
vectorized over every leading dimension, associative, commutative, and
absorb the ``identity`` row; :func:`register_monoid` checks those laws and
fails closed.

Monoids whose ``kernel_op`` names a fast path (``sum``/``max``/``min``) ride
the hand-written segment-combine kernel on the card.  Everything else
lowers to :func:`generic_segment_combine`: sort rows by segment (when not
presorted), run a log-step segmented scan with the monoid's combine, and
scatter each run's end into the output.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "CombineMonoid",
    "MonoidError",
    "register_monoid",
    "get_monoid",
    "registered_monoids",
    "check_monoid",
    "generic_segment_combine",
]


class MonoidError(ValueError):
    """A registered aggregate violates the monoid laws (or is unknown)."""


IdentitySpec = Union[float, Callable[[int], Sequence[float]]]


@dataclass(frozen=True)
class CombineMonoid:
    """A commutative, associative combine with identity — one aggregate.

    ``combine(a, b)`` folds two slabs of shape ``[..., W]`` elementwise over
    the leading dims; ``identity`` is a scalar (broadcast over any shape) or
    a callable ``width -> row`` for monoids whose identity differs per
    column (argmin: ``[+inf, 0, ...]``).

    ``width`` pins the exact payload width, ``min_width`` is a lower bound;
    monoids with either structure need payloads of rank >= 2 (``[E, W]``).
    ``idempotent`` and ``delta_safe`` feed the semi-naive rewrite;
    ``kernel_op`` names the fast path (sum/max/min) this monoid rides;
    ``finalize`` maps the combined accumulator to what the apply UDF sees
    (``mean``); ``float_only`` rejects non-floating payloads on the generic
    path; ``canonicalize`` maps a slab into the monoid's domain for the law
    checker (``topk``: descending rows).
    """

    name: str
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    identity: IdentitySpec
    width: Optional[int] = None
    min_width: int = 1
    idempotent: bool = False
    delta_safe: Optional[bool] = None
    kernel_op: Optional[str] = None
    finalize: Optional[Callable[[torch.Tensor], torch.Tensor]] = field(
        default=None
    )
    float_only: bool = True
    canonicalize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    doc: str = ""

    @property
    def is_delta_safe(self) -> bool:
        return self.idempotent if self.delta_safe is None else self.delta_safe

    @property
    def structured(self) -> bool:
        """True when the payload's trailing dim is monoid structure (the
        slab must be rank >= 2), not free feature columns."""

        return self.width is not None or self.min_width > 1

    # -- identity construction ---------------------------------------------

    def identity_row(self, width: int) -> np.ndarray:
        if callable(self.identity):
            row = np.asarray(self.identity(width), dtype=np.float64)
            if row.shape != (width,):
                raise MonoidError(
                    f"monoid {self.name!r}: identity({width}) returned shape "
                    f"{row.shape}, expected ({width},)"
                )
            return row
        return np.full((width,), float(self.identity))

    def identity_slab(
        self, shape: Tuple[int, ...], dtype: torch.dtype,
        device: torch.device, flag_cols: int = 0,
    ) -> torch.Tensor:
        """An identity-filled slab of ``shape``; the trailing ``flag_cols``
        columns (fused got-flags riding the exchange) take 0, the identity
        of the ``max`` they combine under."""

        width = int(shape[-1]) - flag_cols
        row = np.concatenate(
            [self.identity_row(width), np.zeros((flag_cols,))]
        )
        return torch.as_tensor(row, dtype=dtype, device=device).expand(shape)

    def identity_like(self, x: torch.Tensor) -> torch.Tensor:
        """Identity slab shaped like ``x`` (neutralizes the payloads of
        inactive or padding edges before they reach a combine)."""

        if not callable(self.identity):
            return torch.full_like(x, float(self.identity))
        if x.ndim < 2:
            raise MonoidError(
                f"monoid {self.name!r} has a structured identity; payloads "
                f"must be rank >= 2 ([rows, width]), got shape "
                f"{tuple(x.shape)}"
            )
        return self.identity_slab(tuple(x.shape), x.dtype, x.device)

    # -- fused-slab combine (payload columns + got-flag columns) ------------

    def combine_slab(
        self, a: torch.Tensor, b: torch.Tensor, flag_cols: int = 0
    ) -> torch.Tensor:
        """Combine two slabs whose trailing ``flag_cols`` columns are fused
        got-flags: payload columns fold under the monoid, flag columns under
        ``max``."""

        if flag_cols == 0:
            return self.combine(a, b)
        pa, fa = a[..., :-flag_cols], a[..., -flag_cols:]
        pb, fb = b[..., :-flag_cols], b[..., -flag_cols:]
        return torch.cat(
            [self.combine(pa, pb), torch.maximum(fa, fb)], dim=-1
        )

    def got_mask(self, flag: torch.Tensor) -> torch.Tensor:
        """Decode the combined got-flag column of a fused exchange
        (``min``: an empty +inf would pass ``> 0``, so test ``== 1.0``)."""

        if self.kernel_op == "min":
            return flag == 1.0
        return flag > 0

    # -- payload validation -------------------------------------------------

    def validate_payload(self, shape: Tuple[int, ...], dtype) -> None:
        """Raise when a message payload cannot feed this monoid."""

        shape = tuple(shape)
        if self.structured:
            if len(shape) < 2:
                raise MonoidError(
                    f"monoid {self.name!r} needs structured payloads "
                    f"[rows, width>={max(self.min_width, self.width or 0)}]; "
                    f"got shape {shape}"
                )
            w = int(shape[-1])
            if self.width is not None and w != self.width:
                raise MonoidError(
                    f"monoid {self.name!r} needs payload width "
                    f"{self.width}, got {w} (shape {shape})"
                )
            if w < self.min_width:
                raise MonoidError(
                    f"monoid {self.name!r} needs payload width >= "
                    f"{self.min_width}, got {w} (shape {shape})"
                )
        if self.float_only and not dtype.is_floating_point:
            raise MonoidError(
                f"monoid {self.name!r} accepts floating payloads only, "
                f"got dtype {dtype}"
            )

    # -- bridge to the logical layer ----------------------------------------

    def as_aggregate(self, *, recomputable: bool = False):
        """This monoid as a :class:`repro_torch.core.datalog.Aggregate`
        (``recomputable``: the executing plan rebuilds the aggregate every
        iteration, as Pregel inboxes are)."""

        from repro_torch.core.datalog import Aggregate

        return Aggregate(
            name=self.name,
            zero=(lambda: self.identity_row(self.width or 1)),
            combine=self.combine,
            idempotent=self.idempotent,
            recomputable=recomputable or self.is_delta_safe,
        )


# ---------------------------------------------------------------------------
# Registration-time law checking (fail closed)
# ---------------------------------------------------------------------------


def _check_widths(m: CombineMonoid) -> Tuple[int, ...]:
    if m.width is not None:
        return (m.width,)
    lo = max(m.min_width, 1)
    return tuple(dict.fromkeys((lo, lo + 1, lo + 3)))


def _sample_slabs(m: CombineMonoid, width: int, rng) -> np.ndarray:
    """Negatives, zeros, duplicated rows (ties) and identity rows."""

    base = rng.standard_normal((8, width)) * 4.0
    base[2] = base[1]
    base[3] = 0.0
    base[4, 0] = base[5, 0]
    base[6] = m.identity_row(width)
    return base.astype(np.float64)


def check_monoid(m: CombineMonoid, *, seed: int = 0) -> None:
    """Verify identity absorption, commutativity, associativity and (when
    claimed) idempotence on deterministic samples; raise
    :class:`MonoidError` on any violation."""

    rng = np.random.default_rng(seed)
    for width in _check_widths(m):
        ident = m.identity_row(width)
        if not np.all(np.isfinite(ident) | np.isinf(ident)):
            raise MonoidError(f"monoid {m.name!r}: non-numeric identity")
        x = _sample_slabs(m, width, rng).astype(np.float32)
        a = torch.from_numpy(x)
        b = torch.from_numpy(np.roll(x, 1, axis=0))
        c = torch.from_numpy(np.roll(x, 3, axis=0))
        if m.canonicalize is not None:
            a, b, c = m.canonicalize(a), m.canonicalize(b), m.canonicalize(c)
        ident_slab = m.identity_slab(x.shape, torch.float32, a.device)

        def close(u, v):
            return np.allclose(
                u.numpy(), v.numpy(), rtol=1e-6, atol=1e-8, equal_nan=True,
            )

        if not close(m.combine(a, ident_slab), a) or not close(
            m.combine(ident_slab, a), a
        ):
            raise MonoidError(
                f"monoid {m.name!r}: identity law violated at width {width} "
                f"(combine(x, identity) != x)"
            )
        if not close(m.combine(a, b), m.combine(b, a)):
            raise MonoidError(
                f"monoid {m.name!r}: combine is not commutative at width "
                f"{width}"
            )
        if not close(
            m.combine(m.combine(a, b), c), m.combine(a, m.combine(b, c))
        ):
            raise MonoidError(
                f"monoid {m.name!r}: combine is not associative at width "
                f"{width}"
            )
        if m.idempotent and not close(m.combine(a, a), a):
            raise MonoidError(
                f"monoid {m.name!r}: claimed idempotent but "
                f"combine(x, x) != x at width {width}"
            )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, CombineMonoid] = {}


def register_monoid(
    m: CombineMonoid, *, check: bool = True, overwrite: bool = False
) -> CombineMonoid:
    """Register ``m`` under ``m.name``; fails closed via
    :func:`check_monoid` unless ``check=False``."""

    if not m.name or not isinstance(m.name, str):
        raise MonoidError("monoid needs a non-empty string name")
    if m.name in _REGISTRY and not overwrite:
        raise MonoidError(
            f"monoid {m.name!r} is already registered "
            "(pass overwrite=True to replace it)"
        )
    if m.kernel_op is not None and m.kernel_op not in (
        "sum", "max", "min"
    ):
        raise MonoidError(
            f"monoid {m.name!r}: kernel_op must be one of sum/max/min "
            f"(the hardware fast paths), got {m.kernel_op!r}"
        )
    if check:
        check_monoid(m)
    _REGISTRY[m.name] = m
    return m


def get_monoid(name: str) -> CombineMonoid:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MonoidError(
            f"unknown combine monoid {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}"
        ) from None


def registered_monoids() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Generic monoid path: segmented reduce via a log-step segmented scan
# ---------------------------------------------------------------------------


def _segmented_scan(
    values: torch.Tensor, ids: torch.Tensor, monoid: CombineMonoid,
    flag_cols: int,
) -> torch.Tensor:
    """Inclusive scan within runs of equal (sorted) ids, in log2(E) steps:
    at offset ``d`` row ``i`` folds in row ``i - d`` when both carry the
    same id.  Sorted ids make "same id at i - d" imply "same run", so after
    the step with offset ``d`` row ``i`` holds its run's fold over the last
    ``2d`` rows."""

    E = values.shape[0]
    d = 1
    while d < E:
        same = (ids[d:] == ids[:-d])[:, None]
        folded = monoid.combine_slab(values[:-d], values[d:], flag_cols)
        values = torch.cat(
            [values[:d], torch.where(same, folded, values[d:])], dim=0
        )
        d *= 2
    return values


def generic_segment_combine(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    monoid: CombineMonoid,
    *,
    edge_active: Optional[torch.Tensor] = None,
    flag_cols: int = 0,
    presorted: bool = False,
) -> torch.Tensor:
    """Segmented reduce under an arbitrary registered monoid.

    ``values`` is a rank-2 slab ``[E, W(+flag_cols)]``; rows with
    ``edge_active`` False (or a negative id — padding) become the identity
    row, so they combine as no-ops without disturbing a presorted order.
    Ids at or beyond ``num_segments`` spill into a dropped row.  Empty
    segments read the identity row.
    """

    if values.ndim != 2:
        raise MonoidError(
            f"generic monoid path needs rank-2 slabs, got "
            f"{tuple(values.shape)}"
        )
    monoid.validate_payload(
        tuple(values.shape[:-1]) + (values.shape[-1] - flag_cols,),
        values.dtype,
    )
    E = values.shape[0]
    out_shape = (num_segments,) + tuple(values.shape[1:])
    if E == 0:
        return monoid.identity_slab(
            out_shape, values.dtype, values.device, flag_cols
        ).clone()

    ids = segment_ids.to(torch.int64)
    ident = monoid.identity_slab(
        tuple(values.shape), values.dtype, values.device, flag_cols
    )
    dead = ids < 0
    if edge_active is not None:
        dead = dead | ~edge_active
    values = torch.where(dead[:, None], ident, values)
    # Neutralized rows keep an in-range id so sortedness survives: clamping
    # negatives to 0 can only move them ahead of every real row.
    ids = torch.where(dead, ids.clamp(min=0), ids)
    ids = ids.clamp(max=num_segments)  # spill row for out-of-range ids

    if not presorted:
        order = torch.argsort(ids, stable=True)
        ids = ids[order]
        values = values[order]

    scanned = _segmented_scan(values, ids, monoid, flag_cols)
    is_end = torch.cat(
        [ids[1:] != ids[:-1], torch.ones(1, dtype=torch.bool,
                                         device=ids.device)]
    )
    out = monoid.identity_slab(
        (num_segments + 1,) + tuple(values.shape[1:]), values.dtype,
        values.device, flag_cols,
    ).clone()
    out[ids[is_end]] = scanned[is_end]
    return out[:num_segments]


# ---------------------------------------------------------------------------
# Built-in monoids
# ---------------------------------------------------------------------------


def _lex_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic row minimum over the trailing columns: column 0 is the
    key; ties cascade through the payload columns."""

    a_wins = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    undecided = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for col in range(a.shape[-1]):
        ac, bc = a[..., col], b[..., col]
        a_wins = a_wins | (undecided & (ac < bc))
        undecided = undecided & (ac == bc)
    return torch.where(a_wins[..., None], a, b)


def _topk_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two descending-sorted rows, keeping the k = width largest of
    the multiset union."""

    merged = torch.sort(torch.cat([a, b], dim=-1), dim=-1,
                        descending=True).values
    return merged[..., : a.shape[-1]]


def _mean_finalize(acc: torch.Tensor) -> torch.Tensor:
    """(sum, count) accumulator -> mean; empty inboxes (count 0) read 0."""

    return acc[..., 0] / torch.clamp(acc[..., 1], min=1.0)


def _register_builtins() -> None:
    # The three fast-path combines.  float_only is False: the plain scatter
    # paths take integer payloads too.
    register_monoid(CombineMonoid(
        "sum", combine=torch.add, identity=0.0, kernel_op="sum",
        idempotent=False, float_only=False,
        doc="elementwise addition (PageRank mass, gradients)",
    ), check=False)
    register_monoid(CombineMonoid(
        "max", combine=torch.maximum, identity=float("-inf"),
        kernel_op="max", idempotent=True, float_only=False,
        doc="elementwise maximum (connected components by max label)",
    ), check=False)
    register_monoid(CombineMonoid(
        "min", combine=torch.minimum, identity=float("inf"),
        kernel_op="min", idempotent=True, float_only=False,
        doc="elementwise minimum (SSSP distances)",
    ), check=False)
    # The four generalized aggregates; their laws are pinned by the tests.
    register_monoid(CombineMonoid(
        "argmin",
        combine=_lex_min,
        identity=lambda w: [float("inf")] + [0.0] * (w - 1),
        min_width=2,
        idempotent=True,
        doc="lexicographic row-min: (key, payload...) — SSSP parent "
            "pointers, spanning forests",
    ), check=False)
    register_monoid(CombineMonoid(
        "topk",
        combine=_topk_merge,
        identity=float("-inf"),
        min_width=1,
        idempotent=False,
        delta_safe=False,
        canonicalize=lambda x: torch.sort(x, dim=-1, descending=True).values,
        doc="keep the k = payload-width largest values (k-truncated "
            "personalized PageRank); rows must be descending-sorted",
    ), check=False)
    register_monoid(CombineMonoid(
        "mean",
        combine=torch.add,
        identity=0.0,
        width=2,
        idempotent=False,
        delta_safe=False,
        kernel_op="sum",
        finalize=_mean_finalize,
        doc="(sum, count) pairs finalized to sum/count — label "
            "propagation / Adsorption-style averaging",
    ), check=False)
    register_monoid(CombineMonoid(
        "logsumexp",
        combine=torch.logaddexp,
        identity=float("-inf"),
        idempotent=False,
        delta_safe=False,
        doc="elementwise log-sum-exp accumulation (softmax-weighted "
            "message pooling in log space)",
    ), check=False)


_register_builtins()
