"""Fixpoint drivers for XY-stratified programs (paper §3.3, Appendix B.2).

* :func:`device_fixpoint` — the loop with no host work between supersteps
  beyond one read of the convergence flag each iteration.  Loop-invariant
  relations (the graph) are captured by the step as tensors that stay on
  the device across iterations: the paper's loop-invariant caching.
* :class:`HostFixpointDriver` — the iteration driver of Fig. 1 that can
  interleave work between supersteps: checkpoints, restore and replay after
  a failure, failure injection, straggler detection with its
  ``on_straggler`` hook, an ``on_iteration`` hook and the adaptive
  dense<->sparse ``select_step``.

Termination mirrors Appendix B.2: ``max_iters`` is reached or the iteration
derives no new facts (``converged(prev, new)``).  On a mesh every rank runs
its own driver over its shard, and both drivers read the one flag a
superstep that :func:`agreed` all-reduces, so that every rank stops at the
same iteration: a rank that stopped alone would leave the others waiting
in the next collective.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.parallel import collectives as C

__all__ = [
    "FixpointResult",
    "device_fixpoint",
    "HostFixpointDriver",
    "DriverConfig",
    "checkpointed_run",
    "agreed",
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
    restarts: int = 0
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


def agreed(done: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``done`` on every rank of ``axes`` (a one-element bool tensor that
    holds only where each rank's holds): an all-reduce MAX of the ranks'
    ``not done``.  Without a mesh or axes, ``done`` itself."""

    if mesh is None or not axes:
        return done
    with C.bind(mesh):
        return ~C.pmax((~done).reshape(1).to(torch.int32), axes) \
            .to(torch.bool).reshape(())


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
    checkpoint_every: int = 0            # 0 = disabled
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    max_restarts: int = 3
    # An iteration slower than ``straggler_factor`` times the trailing mean
    # of the last ten (since the last restore) is logged, counted and
    # handed to ``on_straggler``.
    straggler_factor: float = 3.0


class HostFixpointDriver:
    """Fault-tolerant host-side fixpoint loop.

    * ``step(state, j) -> state`` — one iteration (the physical plan).
    * ``converged(prev, new)`` — the no-new-facts test.
    * optional ``save(state, j)`` / ``restore() -> (state, j)`` hooks,
      wired to :mod:`repro_torch.checkpoint` by the executables.
    * optional ``select_step(state, j) -> (step_fn, label)`` — per-iteration
      choice of the executing step (the adaptive dense<->sparse policy);
      labels are recorded in ``mode_history`` and the result's ``modes``.
    * optional ``on_iteration(j, dt)`` after every iteration (``j`` counts
      the iterations done) and ``on_straggler(j, dt)`` when iteration ``j``
      is a straggler.  IMRU's straggler hook swaps a rebuilt step into
      ``self.step``, which the next iteration runs.
    * optional ``injector`` (:class:`repro_torch.ft.FailureInjector`):
      ``maybe_fail(j)`` at the step boundary raises (a crash) or sleeps (a
      straggle).

    Failure handling: an exception raised inside ``step`` (the injector's
    included) restores from the last checkpoint and replays, at most
    ``config.max_restarts`` times; without a ``restore`` hook it propagates.
    Iterations are pure functions of the state, so the replay is exact.
    Only a host exception is recoverable: a device-side assert on the card
    leaves the CUDA context broken for the rest of the process, and every
    later call on it fails, the restore's included.
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
        self.step = step
        self.converged = converged
        # A fresh config per driver: a shared default instance would leak
        # config mutations across drivers.
        self.config = DriverConfig() if config is None else config
        self.save = save
        self.restore = restore
        self.on_iteration = on_iteration
        self.injector = injector
        self.on_straggler = on_straggler
        self.select_step = select_step
        self.mode_history: list[str] = []
        self.iter_times: list[float] = []
        self.straggler_events = 0
        self.restarts = 0
        # Straggler window start: iterations recorded before the most recent
        # restart are excluded from the trailing mean (their times belong to
        # the failed attempt).
        self._window_start = 0
        # Single-shot fault injection (testing) — instance state, so one
        # driver's injected failure can never leak into another.
        self.fail_at: Optional[int] = None
        self._failed_once = False

    def run(self, init_state: Any, start_iter: int = 0) -> FixpointResult:
        state, j = init_state, start_iter
        cfg = self.config
        t_start = time.perf_counter()
        done = False
        while j < cfg.max_iters and not done:
            t0 = time.perf_counter()
            try:
                if self.fail_at is not None and j == self.fail_at \
                        and not self._failed_once:
                    self._failed_once = True
                    raise RuntimeError(f"injected failure at iteration {j}")
                if self.injector is not None:
                    self.injector.maybe_fail(j)
                step_fn = self.step
                if self.select_step is not None:
                    step_fn, mode = self.select_step(state, j)
                    self.mode_history.append(mode)
                new_state = step_fn(state, j)
                _synchronize(new_state)
            except Exception as exc:  # noqa: BLE001 — FT boundary
                self.restarts += 1
                if self.restarts > cfg.max_restarts or self.restore is None:
                    raise
                logger.warning(
                    "iteration %d failed (%s); restoring from checkpoint "
                    "(restart %d/%d)", j, exc, self.restarts, cfg.max_restarts
                )
                state, j = self.restore()
                self._window_start = len(self.iter_times)
                # Drop mode labels recorded for the failed attempt and for
                # iterations about to be replayed, keeping mode_history[i]
                # aligned with iteration start_iter + i.
                del self.mode_history[max(j - start_iter, 0):]
                continue

            dt = time.perf_counter() - t0
            self.iter_times.append(dt)
            window = self.iter_times[self._window_start:]
            if len(window) > 3:
                recent = window[-11:-1]
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
            if cfg.checkpoint_every and self.save is not None \
                    and j % cfg.checkpoint_every == 0:
                self.save(state, j)
            if j % LOG_EVERY == 0:
                logger.info("iteration %d done in %.3fs", j, dt)

        if self.save is not None and cfg.checkpoint_every:
            self.save(state, j)
        return FixpointResult(
            state=state,
            iterations=j - start_iter,
            converged=done,
            seconds=time.perf_counter() - t_start,
            restarts=self.restarts,
            modes=tuple(self.mode_history),
            straggler_events=self.straggler_events,
        )


def checkpointed_run(
    make_driver: Callable[..., HostFixpointDriver],
    init: Any,
    like: Callable[[], Any],
    max_iters: int,
    *,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    max_restarts: int = 3,
    keep_checkpoints: int = 3,
) -> FixpointResult:
    """Run a single-loop fixpoint on the host driver with checkpoints.

    ``make_driver(config, save, restore)`` builds the driver from a
    :class:`DriverConfig` and the save/restore hooks (``None`` without a
    ``checkpoint_dir``).  With one, the state is checkpointed through a
    :class:`~repro_torch.checkpoint.CheckpointStore` every
    ``checkpoint_every`` iterations (default 8) and at entry, a failure
    restores from the last one, and ``resume=True`` starts from the
    directory's latest.  ``like()`` gives the restore template: restored
    leaves land on its device."""

    store, start_iter = None, 0
    save = restore = None
    if checkpoint_dir is not None:
        from repro_torch.checkpoint import CheckpointStore, latest_step

        store = CheckpointStore(checkpoint_dir, keep=keep_checkpoints)
        if checkpoint_every <= 0:
            checkpoint_every = 8

        def save(state, j):
            store.save(j, state, extra={"iteration": j})

        def restore():
            state, j, _ = store.restore(like=like())
            return state, int(j)

        if resume and latest_step(checkpoint_dir) is not None:
            init, start_iter = restore()
    driver = make_driver(
        DriverConfig(max_iters=max_iters,
                     checkpoint_every=checkpoint_every if store else 0,
                     max_restarts=max_restarts),
        save, restore,
    )
    if store is not None and start_iter == 0:
        # Entry restore point: a crash before the first periodic save must
        # still have somewhere to rewind to.
        save(init, 0)
    try:
        res = driver.run(init, start_iter=start_iter)
    except BaseException:
        # Drain the writer before the failure propagates, so it cannot
        # race a successor run over the same checkpoint directory.
        if store is not None:
            store.quiesce()
        raise
    if store is not None:
        store.wait()  # surface any pending async-save failure
    return res
