"""Fault tolerance: failure injection, elastic re-planning and
bounded-staleness aggregation (the port of :mod:`repro.ft.elastic`).

* **Failure detection.**  :class:`FailureInjector` raises a host exception
  at a chosen step (or at a chosen chunk of the out-of-core stream) and
  sleeps for a straggle.  The drivers restore from the last durable
  checkpoint when an exception leaves ``step`` and replay: iterations are
  pure functions of the carried state (Datalog semantics), so the replay
  is exact.  What the drivers survive is an exception raised on the host.
  A device-side assert on the card leaves the CUDA context broken for the
  rest of the process: no restore inside that process can run, and
  recovery from it means a new process that resumes from disk
  (``resume=True``).
* **Elastic re-planning.**  :class:`ElasticPlanner` maps a shrunken device
  set to the nearest valid mesh description; the executables'
  ``remesh(mesh)`` recompiles onto the surviving ranks
  (:func:`repro_torch.launch.mesh.make_mesh` with ``ranks=``) and resumes
  from the unsharded checkpoints.
* **Straggler mitigation.**  :func:`stale_aggregate` reduces over the
  shards that arrived and carries the late ones into the next step, under
  any monoid for which a late application is sound.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.hardware import MeshSpec

__all__ = ["FailureEvent", "FailureInjector", "ElasticPlanner",
           "stale_aggregate"]


@dataclass
class FailureEvent:
    step: int
    kind: str            # "crash" | "straggle"
    detail: str = ""


class FailureInjector:
    """Deterministic failure schedule for FT tests."""

    def __init__(self, crashes: Sequence[int] = (),
                 straggles: Sequence[Tuple[int, float]] = (),
                 chunk_crashes: Sequence[Tuple[int, int]] = ()) -> None:
        self.crashes = set(crashes)
        self.straggles = dict(straggles)
        # (step, chunk) crash points inside the out-of-core streaming loop
        # — the executor's chunked step fires them mid-stream, after some
        # chunk partials have already been accumulated.
        self.chunk_crashes = set(chunk_crashes)
        self.fired: List[FailureEvent] = []

    def maybe_fail(self, step: int) -> None:
        if step in self.crashes:
            self.crashes.discard(step)
            self.fired.append(FailureEvent(step, "crash"))
            raise RuntimeError(f"injected device failure at step {step}")
        if step in self.straggles:
            delay = self.straggles.pop(step)
            self.fired.append(FailureEvent(step, "straggle", f"{delay}s"))
            time.sleep(delay)

    def maybe_fail_chunk(self, step: int, chunk: int) -> None:
        if (step, chunk) in self.chunk_crashes:
            self.chunk_crashes.discard((step, chunk))
            self.fired.append(
                FailureEvent(step, "crash", f"chunk {chunk}")
            )
            raise RuntimeError(
                f"injected device failure at step {step} chunk {chunk}"
            )


class ElasticPlanner:
    """Re-derive a valid mesh after losing devices.

    Policy: keep the ``model`` axis intact (TP degree is a property of the
    lowered program), shrink ``data``/(``pod``) to the largest whole value
    supported by the surviving device count.  Returns the new
    :class:`MeshSpec` and how many devices idle (stranded).
    """

    def __init__(self, model_axis: int) -> None:
        self.model_axis = model_axis

    def replan(self, n_alive: int,
               multi_pod: bool = False) -> Tuple[MeshSpec, int]:
        tp = self.model_axis
        usable_groups = n_alive // tp
        if usable_groups < 1:
            raise RuntimeError(
                f"{n_alive} devices cannot host one model replica (tp={tp})"
            )
        if multi_pod and usable_groups % 2 == 0 and usable_groups >= 4:
            pods, data = 2, usable_groups // 2
            mesh = MeshSpec((("pod", pods), ("data", data), ("model", tp)))
        else:
            mesh = MeshSpec((("data", usable_groups), ("model", tp)))
        stranded = n_alive - mesh.n_devices
        return mesh, stranded


def stale_aggregate(
    partials: torch.Tensor,       # (n_shards, ...) partial aggregates
    arrived: torch.Tensor,        # (n_shards,) bool — arrived in time
    carry: torch.Tensor,          # (...) late contributions from last step
    monoid: str = "sum",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded-staleness reduce under any eligible registered monoid:
    combine the on-time shards with last step's late arrivals; stash this
    step's late shards (pre-combined) for the next step.

    With every shard on time this is exactly a full reduce; under
    stragglers no contribution is ever dropped, only delayed one step.

    Eligibility is decided by the monoid registry's flags and **fails
    closed**: a late contribution is applied one step later than its peers,
    which is only sound when re-ordering/late application cannot change the
    fixpoint —

    * ``sum`` — the error-feedback path: addition is commutative and each
      contribution is applied exactly once, so the running total is
      unbiased (delayed, never lost);
    * idempotent / delta-safe monoids (``max``, ``min``, ``argmin``, ...) —
      folding a late partial next step is the same as folding it now;
    * everything else (``topk``, ``mean``, ``logsumexp``, ...) raises
      :class:`~repro_torch.core.monoid.MonoidError` — a multiset-merge
      applied late double-counts against fresh partials.
    """

    from repro_torch.core.monoid import MonoidError, get_monoid

    m = get_monoid(monoid)
    if not (monoid == "sum" or m.idempotent or bool(m.is_delta_safe)):
        raise MonoidError(
            f"monoid {monoid!r} is not eligible for bounded-staleness "
            "aggregation: it is neither idempotent nor delta-safe (and not "
            "the error-feedback 'sum' path), so a delayed contribution "
            "would corrupt the reduce — failing closed"
        )
    mask = arrived.reshape((-1,) + (1,) * (partials.ndim - 1))
    if monoid == "sum":
        zero = torch.zeros_like(partials)
        on_time = torch.where(mask, partials, zero).sum(dim=0)
        late = torch.where(mask, zero, partials).sum(dim=0)
        return on_time + carry, late
    ident = m.identity_like(partials)
    on_parts = torch.where(mask, partials, ident)
    late_parts = torch.where(mask, ident, partials)

    def _fold(slabs):
        out = slabs[0]
        for i in range(1, slabs.shape[0]):
            out = m.combine(out, slabs[i])
        return out

    return m.combine(_fold(on_parts), carry), _fold(late_parts)
