"""Fixpoint drivers for XY-stratified programs (paper §3.3, Appendix B.2).

* :func:`device_fixpoint` — the loop with no host work between supersteps
  beyond one read of the convergence flag each iteration.  Loop-invariant
  relations (the graph) are captured by the step as tensors that stay on
  the device across iterations: the paper's loop-invariant caching.
* :class:`HostFixpointDriver` — the iteration driver of Fig. 1 that can
  interleave work between supersteps: straggler detection with its
  ``on_straggler`` hook, an ``on_iteration`` hook and the adaptive
  dense<->sparse ``select_step``.  (Checkpoint, restore and failure
  injection come with the fault-tolerance slice, ROADMAP A11.)

Termination mirrors Appendix B.2: ``max_iters`` is reached or the iteration
derives no new facts (``converged(prev, new)``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves

__all__ = [
    "FixpointResult",
    "device_fixpoint",
    "HostFixpointDriver",
    "DriverConfig",
]

logger = logging.getLogger(__name__)

# The host driver logs every LOG_EVERY-th iteration at INFO.
LOG_EVERY = 10


@dataclass
class FixpointResult:
    state: Any
    iterations: int
    converged: bool
    seconds: float = 0.0
    # Per-iteration execution mode labels when an adaptive step selector ran
    # ("dense" / "sparse@<cap>" / "halt(empty-frontier)"); empty otherwise.
    modes: Tuple[str, ...] = ()
    # Iterations of each fixpoint phase of a multi-phase generic program.
    phase_iterations: Tuple[int, ...] = ()
    straggler_events: int = 0
    # The generic executor re-ran the program on dense-grid storage after a
    # row-table slab overflowed its capacity (the lossless fallback).
    storage_fallback: bool = False


def _synchronize(state: Any) -> None:
    """Wait for the device work behind ``state`` (a no-op on the CPU)."""

    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def device_fixpoint(
    body: Callable[[Any, int], Any],
    converged: Callable[[Any, Any], torch.Tensor],
    init_state: Any,
    max_iters: int,
) -> FixpointResult:
    """Run ``body(state, j) -> state`` until ``converged(prev, new)`` (a
    one-element bool tensor) holds or ``max_iters`` is reached.  The flag
    is the only value read back per superstep."""

    t0 = time.perf_counter()
    state, j, done = init_state, 0, False
    while j < max_iters and not done:
        new_state = body(state, j)
        done = bool(converged(state, new_state))
        state = new_state
        j += 1
    _synchronize(state)
    return FixpointResult(
        state=state,
        iterations=j,
        converged=done,
        seconds=time.perf_counter() - t0,
    )


@dataclass
class DriverConfig:
    max_iters: int = 1000
    # An iteration slower than ``straggler_factor`` times the trailing mean
    # of the last ten is logged, counted and handed to ``on_straggler``.
    # ``checkpoint_every`` and ``max_restarts`` come with the driver that
    # reads them (ROADMAP A11, fault tolerance).
    straggler_factor: float = 3.0


class HostFixpointDriver:
    """Host-side fixpoint loop.

    * ``step(state, j) -> state`` — one iteration (the physical plan).
    * ``converged(prev, new)`` — the no-new-facts test.
    * optional ``select_step(state, j) -> (step_fn, label)`` — per-iteration
      choice of the executing step (the adaptive dense<->sparse policy);
      labels are recorded in ``mode_history`` and the result's ``modes``.
    * optional ``on_iteration(j, dt)`` after every iteration (``j`` counts
      the iterations done) and ``on_straggler(j, dt)`` when iteration ``j``
      is a straggler.  IMRU's straggler hook swaps a rebuilt step into
      ``self.step``, which the next iteration runs.

    ``save=``, ``restore=`` and ``injector=`` (checkpoint, restore and
    failure injection) raise: ROADMAP A11 (fault tolerance).
    """

    def __init__(
        self,
        step: Callable[[Any, int], Any],
        converged: Callable[[Any, Any], Any],
        config: Optional[DriverConfig] = None,
        save: Optional[Callable[[Any, int], None]] = None,
        restore: Optional[Callable[[], Tuple[Any, int]]] = None,
        on_iteration: Optional[Callable[[int, float], None]] = None,
        select_step: Optional[
            Callable[[Any, int], Tuple[Callable[[Any, int], Any], str]]
        ] = None,
        injector: Optional[Any] = None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
    ) -> None:
        if save is not None or restore is not None or injector is not None:
            raise NotImplementedError(
                "save=, restore= and injector= are not ported yet: ROADMAP "
                "A11 (fault tolerance)"
            )
        self.step = step
        self.converged = converged
        self.config = DriverConfig() if config is None else config
        self.on_iteration = on_iteration
        self.on_straggler = on_straggler
        self.select_step = select_step
        self.mode_history: list[str] = []
        self.iter_times: list[float] = []
        self.straggler_events = 0

    def run(self, init_state: Any, start_iter: int = 0) -> FixpointResult:
        state, j = init_state, start_iter
        cfg = self.config
        t_start = time.perf_counter()
        done = False
        while j < cfg.max_iters and not done:
            t0 = time.perf_counter()
            step_fn = self.step
            if self.select_step is not None:
                step_fn, mode = self.select_step(state, j)
                self.mode_history.append(mode)
            new_state = step_fn(state, j)
            _synchronize(new_state)

            dt = time.perf_counter() - t0
            self.iter_times.append(dt)
            if len(self.iter_times) > 3:
                recent = self.iter_times[-11:-1]
                trailing = sum(recent) / len(recent)
                if dt > cfg.straggler_factor * trailing:
                    self.straggler_events += 1
                    logger.warning(
                        "straggler: iteration %d took %.3fs (%.1fx trailing "
                        "mean %.3fs)", j, dt, dt / trailing, trailing,
                    )
                    if self.on_straggler is not None:
                        self.on_straggler(j, dt)

            done = bool(self.converged(state, new_state))
            state = new_state
            j += 1
            if self.on_iteration is not None:
                self.on_iteration(j, dt)
            if j % LOG_EVERY == 0:
                logger.info("iteration %d done in %.3fs", j, dt)

        return FixpointResult(
            state=state,
            iterations=j - start_iter,
            converged=done,
            seconds=time.perf_counter() - t_start,
            modes=tuple(self.mode_history),
            straggler_events=self.straggler_events,
        )
