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
in the next collective.  For the same reason the host driver agrees its
fault-tolerance decisions on a mesh (a crash at the step boundary, a
straggler), and its checkpoints go through
:class:`~repro_torch.checkpoint.MeshCheckpointStore`.
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
    "AgreedFailure",
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
    # One note per elastic remesh the executable went through
    # ("remesh(8->4: data=4)").
    remesh_events: Tuple[str, ...] = ()
    # The generic executor re-ran the program on dense-grid storage after a
    # row-table slab overflowed its capacity (the lossless fallback).
    storage_fallback: bool = False


class AgreedFailure(RuntimeError):
    """A failure every rank of a mesh agreed on and gives up on together
    (past ``max_restarts``, or with no restore hook): each rank raises it
    at the same iteration, the rank whose own check failed with that
    failure as its cause.  Handlers may make one more collective."""


def _synchronize(state: Any) -> None:
    """Wait for the device work behind ``state`` (a no-op on the CPU)."""

    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def agreed(done: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``done`` on every rank of ``axes`` (a one-element bool tensor that
    holds only where each rank's holds): an all-reduce MAX of the ranks'
    ``not done``.  Without a mesh or axes, ``done`` itself.  Under
    ``torch.func.vmap`` (a batched run: one flag a query) the k flags
    travel in one all-reduce (the collective's batching rule), so a
    batched phase agrees once a superstep and stops when every query's
    flag holds on every rank."""

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

    On a ``mesh`` (every rank runs its own driver in lockstep) a driver
    with fault tolerance or a straggler hook (``restore``, ``injector``,
    ``fail_at`` or ``on_straggler``; the same on every rank) agrees its
    decisions: each rank runs its boundary checks (``fail_at``,
    ``maybe_fail(j)``) locally, and one all-reduce (max) over every axis of
    the mesh, before the step, carries this boundary's failure flag and the
    previous iteration's straggler flag and time.  A crash on any one rank
    makes every rank count one restart and restore together (the restore
    hook is collective); a straggler on any rank makes every rank count it
    and call ``on_straggler`` for that iteration, before the next step
    runs, as one device does.  The last iteration's straggler flag is
    agreed after the loop.  A mesh driver without these makes no extra
    collective and counts its own stragglers.  A failure inside a step on
    a mesh propagates (ROADMAP C17, a deliberate departure from the
    reference's one controller): the other ranks are already inside the
    step's collectives, so no in-process restore can reach them; recovery
    is a new run that resumes from disk, on the same mesh or after a
    ``remesh``.
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
        mesh: Optional[Any] = None,
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
        self.mesh = mesh
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

    def _boundary(self, j: int) -> Optional[Exception]:
        """This rank's failure at the step boundary of iteration ``j``."""

        try:
            if self.fail_at is not None and j == self.fail_at \
                    and not self._failed_once:
                self._failed_once = True
                raise RuntimeError(f"injected failure at iteration {j}")
            if self.injector is not None:
                self.injector.maybe_fail(j)
        except Exception as exc:  # noqa: BLE001 — FT boundary
            return exc
        return None

    def _straggled(self, dt: float) -> bool:
        """Whether an iteration of ``dt`` s (just appended to
        ``iter_times``) is slower than ``straggler_factor`` times the
        trailing mean of the last ten since the last restore."""

        window = self.iter_times[self._window_start:]
        if len(window) <= 3:
            return False
        recent = window[-11:-1]
        return dt > self.config.straggler_factor * sum(recent) / len(recent)

    def _straggler(self, j: int, dt: float) -> None:
        self.straggler_events += 1
        window = self.iter_times[self._window_start:]
        recent = window[-11:-1] or [dt]
        trailing = sum(recent) / len(recent)
        logger.warning(
            "straggler: iteration %d took %.3fs (%.1fx trailing mean %.3fs)",
            j, dt, dt / max(trailing, 1e-12), trailing,
        )
        if self.on_straggler is not None:
            self.on_straggler(j, dt)

    def _agreed_flags(self, failure, late) -> Tuple[bool, Optional[Tuple]]:
        """One all-reduce (max) over the mesh of this rank's boundary
        failure and its last iteration's ``late = (j, dt, straggled)``:
        (a failure on any rank, the last iteration as every rank takes it
        (``straggled`` on any rank, the slowest ``dt``) or None)."""

        j, dt, slow = late if late is not None else (-1, 0.0, False)
        t = torch.tensor([1.0 if failure is not None else 0.0,
                          1.0 if slow else 0.0, dt, float(j)],
                         dtype=torch.float64, device=self.mesh.device)
        with C.bind(self.mesh):
            t = C.pmax(t, self.mesh.wide_axes).cpu()
        late = None if t[3] < 0 else (int(t[3]), float(t[2]), bool(t[1] > 0))
        return bool(t[0] > 0), late

    def run(self, init_state: Any, start_iter: int = 0) -> FixpointResult:
        state, j = init_state, start_iter
        cfg = self.config
        t_start = time.perf_counter()
        done = False
        lockstep = self.mesh is not None and bool(self.mesh.wide_axes)
        agree = lockstep and (
            self.restore is not None or self.injector is not None
            or self.fail_at is not None or self.on_straggler is not None)
        late = None  # the last iteration, awaiting the agreement
        while j < cfg.max_iters and not done:
            t0 = time.perf_counter()
            failure = self._boundary(j)
            failed = failure is not None
            if agree:
                failed, late = self._agreed_flags(failure, late)
                if late is not None and late[2]:
                    self._straggler(late[0], late[1])
                late = None
            if not failed:
                try:
                    step_fn = self.step
                    if self.select_step is not None:
                        step_fn, mode = self.select_step(state, j)
                        self.mode_history.append(mode)
                    new_state = step_fn(state, j)
                    _synchronize(new_state)
                except Exception as exc:  # noqa: BLE001 — FT boundary
                    if lockstep:
                        raise  # C17: the other ranks are inside the step
                    failure, failed = exc, True
            if failed:
                self.restarts += 1
                if self.restarts > cfg.max_restarts or self.restore is None:
                    if agree:
                        raise AgreedFailure(
                            f"a rank of the mesh failed at iteration {j} "
                            f"(restart {self.restarts} of at most "
                            f"{cfg.max_restarts})"
                            + ("" if failure is None else f": {failure}")
                        ) from failure
                    raise failure
                logger.warning(
                    "iteration %d failed (%s); restoring from checkpoint "
                    "(restart %d/%d)", j,
                    failure if failure is not None else "on another rank",
                    self.restarts, cfg.max_restarts
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
            if agree:
                late = (j, dt, self._straggled(dt))
            elif self._straggled(dt):
                self._straggler(j, dt)

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

        if agree and late is not None:
            _, late = self._agreed_flags(None, late)
            if late[2]:
                self._straggler(late[0], late[1])
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
    mesh: Optional[Any] = None,
    to_global: Optional[Callable[[Any], Any]] = None,
    to_local: Optional[Callable[[Any], Any]] = None,
) -> FixpointResult:
    """Run a single-loop fixpoint on the host driver with checkpoints.

    ``make_driver(config, save, restore)`` builds the driver from a
    :class:`DriverConfig` and the save/restore hooks (``None`` without a
    ``checkpoint_dir``).  With one, the state is checkpointed through a
    :class:`~repro_torch.checkpoint.MeshCheckpointStore` every
    ``checkpoint_every`` iterations (default 8) and at entry, a failure
    restores from the last one, and ``resume=True`` starts from the
    directory's latest.  ``like()`` gives the restore template: restored
    leaves land on its device.  On a ``mesh`` every rank calls this in
    lockstep: ``to_global`` gathers a rank's state into the global tree
    the checkpoint holds, ``like()`` is that global tree, and ``to_local``
    cuts a restored one to the rank's shard."""

    store, start_iter = None, 0
    save = restore = None
    if checkpoint_dir is not None:
        from repro_torch.checkpoint import MeshCheckpointStore

        store = MeshCheckpointStore(checkpoint_dir, keep=keep_checkpoints,
                                    mesh=mesh, to_global=to_global,
                                    to_local=to_local)
        if checkpoint_every <= 0:
            checkpoint_every = 8

        def save(state, j):
            store.save(j, state, extra={"iteration": j})

        def restore(step=None):
            state, j, _ = store.restore(like=like(), step=step)
            return state, int(j)

        if resume:
            step = store.latest()
            if step is not None:
                init, start_iter = restore(step)
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
    except BaseException as exc:
        # Drain the writer before the failure propagates, so it cannot
        # race a successor run over the same checkpoint directory (on a
        # mesh, one that other ranks start at once).
        if store is not None:
            store.quiesce(agreed=isinstance(exc, AgreedFailure))
        raise
    if store is not None:
        store.wait()  # surface any pending async-save failure
    return res
