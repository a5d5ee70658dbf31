"""Iterative Map-Reduce-Update front-end (paper §2.2, Listing 2, Fig. 5) in
PyTorch.

The user supplies the three UDFs of the programming model, on tensors:

* ``init_model() -> model``               (a tensor or nested containers
                                           of tensors)
* ``map(records, model) -> stat``         (vectorized over a record batch;
                                           the per-record map of the paper
                                           fused with sender-side early
                                           aggregation — Fig. 5's O5+O6)
* ``update(j, model, stat) -> model``

plus the ``reduce`` aggregate (default: elementwise sum — the commutative/
associative monoid the planner's early-aggregation rewrite relies on).

:func:`compile_imru` registers the UDFs into the Listing-2 Datalog program,
runs the stratifier and the algebra translator, plans the physical strategy
from the records' statistics, and has the executor build the step
(:func:`repro_torch.core.executor.build_imru_step`).  Convergence is rule
G3's ``M != NewM`` test: the fixpoint is reached when ``update`` returns the
model unchanged (to within ``tol``).

With ``mesh=`` each rank holds its shard of the records (sharded over the
``pod``/``data`` axes, replicated over ``model``) and a replica of the
model; the partial statistics meet in the planned reduce schedule (or the
``int8_ef`` codec) and every rank applies the same update.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import algebra, stratify
from repro_torch.core.datalog import Aggregate, Program
from repro_torch.core.executor import build_imru_step
from repro_torch.core.fixpoint import (
    DriverConfig,
    FixpointResult,
    HostFixpointDriver,
    agreed,
    checkpointed_run,
    device_fixpoint,
)
from repro_torch.core.hardware import MeshSpec, TPU_V5E, HardwareSpec
from repro_torch.core.listings import imru_program
from repro_torch.core.planner import IMRUPhysicalPlan, IMRUStats, plan_imru
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_spec_of
from repro_torch.parallel import collectives as C

__all__ = ["IMRUTask", "IMRUExecutable", "compile_imru", "tree_sum_aggregate"]

_ONE_DEVICE = MeshSpec((("data", 1),))


def tree_sum_aggregate() -> Aggregate:
    """The default ``reduce``: elementwise sum (BGD's gradient sum)."""

    return Aggregate(
        name="reduce",
        zero=lambda: 0.0,
        combine=lambda a, b: tree_map(torch.add, a, b),
        # G2's collect@J is rebuilt from model@J every iteration, never
        # folded into collect@J-1 — delta reads are safe.
        recomputable=True,
    )


@dataclass
class IMRUTask:
    """An Iterative Map-Reduce-Update task: the paper's three UDFs."""

    init_model: Callable[[], Any]
    map: Callable[[Any, Any], Any]
    update: Callable[[Any, Any, Any], Any]
    reduce: Aggregate = field(default_factory=tree_sum_aggregate)
    name: str = "imru-task"
    tol: float = 0.0  # convergence tolerance for the M != NewM test

    def program(self) -> Program:
        """The Listing-2 Datalog program with this task's UDFs bound."""

        return imru_program(
            udfs={
                "init_model": self.init_model,
                "map": self.map,
                "update": self.update,
            },
            aggregates={"reduce": self.reduce},
        )


@dataclass
class IMRUExecutable:
    """A compiled IMRU task: physical plan + step + fixpoint drivers."""

    task: IMRUTask
    program: Program
    logical: algebra.LogicalPlan
    plan: IMRUPhysicalPlan
    step: Callable[[Any, int], Any]          # (model, j) -> model
    records: Any                              # device-resident cached EDB
    device: torch.device
    # Straggler mitigation: what the re-planning fallback needs (the stats
    # that fed ``plan_imru``, the mesh description, the hardware model) plus
    # one note per fallback taken.
    mesh_spec: MeshSpec = _ONE_DEVICE
    stats: Optional[IMRUStats] = None
    hw: HardwareSpec = TPU_V5E
    straggler_fallbacks: Tuple[str, ...] = ()
    mesh: Optional[Any] = None

    def init(self) -> Any:
        return tree_map(lambda t: torch.as_tensor(t, device=self.device),
                        self.task.init_model())

    def converged(self, prev: Any, new: Any) -> torch.Tensor:
        """``M == NewM`` to within ``tol``, as a one-element bool tensor
        (the only value the drivers read back)."""

        same = torch.ones((), dtype=torch.bool, device=self.device)
        for a, b in zip(tree_leaves(prev), tree_leaves(new)):
            same = same & torch.all(torch.abs(a - b) <= self.task.tol)
        return agreed(same, self.mesh,
                      () if self.mesh is None else self.mesh.batch_axes)

    # -- drivers ------------------------------------------------------------

    def run(
        self,
        max_iters: int,
        on_device: bool = True,
        *,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        injector: Optional[Any] = None,
        max_restarts: int = 3,
        keep_checkpoints: int = 3,
        straggler_fallback: bool = True,
    ) -> FixpointResult:
        """Run the IMRU fixpoint: :func:`device_fixpoint` when
        ``on_device`` and no fault tolerance is asked for, else the host
        driver.

        Fault tolerance (host driver): ``checkpoint_dir`` checkpoints the
        model host-side every ``checkpoint_every`` iterations (default 8);
        ``injector`` fires crashes/straggles at the step boundary;
        ``resume=True`` continues from disk.  A detected straggler switches
        the reduce to the planner's k-ary aggregation tree when
        ``straggler_fallback`` is on; fallbacks taken are recorded in
        ``straggler_fallbacks`` and ``plan.notes``.  On a mesh the model
        is replicated: the mesh's first rank writes it, every rank reads
        it back, and the driver agrees a crash or a straggler on any rank
        (:class:`~repro_torch.core.fixpoint.HostFixpointDriver`), so every
        rank restores, or swaps in the k-ary tree, at the same
        iteration."""

        ft = checkpoint_dir is not None or injector is not None
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True needs checkpoint_dir=")
        model = self.init()
        if on_device and not ft:
            return device_fixpoint(self.step, self.converged, model,
                                   max_iters)

        def make_driver(config, save, restore):
            driver = self.driver(config, save=save, restore=restore,
                                 injector=injector)
            if straggler_fallback:
                driver.on_straggler = self._kary_fallback(driver)
            return driver

        return checkpointed_run(
            make_driver, model, self.init, max_iters,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            resume=resume, max_restarts=max_restarts,
            keep_checkpoints=keep_checkpoints, mesh=self.mesh,
        )

    def _kary_fallback(self, driver: HostFixpointDriver) -> Callable:
        """Straggler response: re-plan the reduce as the k-ary aggregation
        tree (a straggling participant delays one tree edge, not the whole
        synchronous ring), rebuild the step, and swap it into the live
        driver — the remaining iterations run the new schedule.  On a mesh
        the driver calls this on every rank at the same iteration (the
        straggler is agreed), and each rebuilds the same step over the
        mesh.
        """

        def on_straggler(j: int, dt: float) -> None:
            if self.plan.reduce.kind == "kary_tree" or self.stats is None:
                return
            new_plan = plan_imru(
                self.stats, self.mesh_spec, self.hw,
                force_reduce="kary_tree",
                codec=self.plan.reduce.codec,
                microbatches=self.plan.microbatches,
            )
            step, _ = build_imru_step(self.task, self.records, new_plan,
                                      self.mesh, self.mesh_spec)
            note = f"straggler-fallback(kary_tree @ iteration {j})"
            self.plan = replace(new_plan, notes=new_plan.notes + (note,))
            self.step = step
            self.straggler_fallbacks = self.straggler_fallbacks + (note,)
            driver.step = step

        return on_straggler

    def driver(self, config: DriverConfig, **hooks) -> HostFixpointDriver:
        return HostFixpointDriver(
            step=lambda m, j: self.step(m, j),
            converged=self.converged,
            config=config,
            mesh=self.mesh,
            **hooks,
        )


def _nbytes(t: torch.Tensor, lead: int = 0) -> int:
    """Bytes of ``t`` past its first ``lead`` dims."""

    return int(np.prod(t.shape[lead:], dtype=np.int64)) * t.element_size()


def compile_imru(
    task: IMRUTask,
    records: Any,
    *,
    mesh: Any = None,
    mesh_spec: Optional[MeshSpec] = None,
    hw: HardwareSpec = TPU_V5E,
    stats: Optional[IMRUStats] = None,
    force_reduce: Optional[str] = None,
    codec: Optional[str] = None,
    microbatches: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> IMRUExecutable:
    """Compile an IMRU task through the full declarative stack, on
    ``device`` (default: the card; with none present this raises).

    ``records`` is a tensor or nested containers of tensors with a common
    leading (record) dimension, on ``device``
    (:func:`repro_torch.carry.imru_records_from_numpy`); it is the
    loop-invariant cached EDB.  The planner's statistics come from the
    records' shapes and dtypes and from the model's, which ``init_model``
    gives on the ``meta`` device (no data, no map run).  ``hw`` defaults to
    the TPU model so plan notes match the JAX package's.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`): ``records`` are
    this rank's shard, on the mesh's device, of equal size on every rank
    of the ``pod``/``data`` axes; the planner sees their sum and
    ``mesh_spec`` defaults to :func:`~repro_torch.launch.mesh.mesh_spec_of`
    the mesh.  ``force_reduce`` pins the reduce schedule and ``codec`` the
    codec around it (``bf16``, or ``int8_ef`` with error feedback).
    """

    if mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    leaves = tree_leaves(records)
    for t in leaves:
        if t.device.type != device.type:
            raise ValueError(
                f"records lie on {t.device}, compile_imru was asked for "
                f"{device}: put them there "
                "(repro_torch.carry.imru_records_from_numpy)"
            )
    n_records = int(leaves[0].shape[0])
    if mesh is not None and mesh.batch_axes:
        # Each rank holds its shard; the planner sees them all.
        with C.bind(mesh):
            counts = C.all_gather(torch.tensor([n_records], device=device),
                                  mesh.batch_axes).reshape(-1).tolist()
        if len(set(counts)) != 1:
            raise ValueError(f"the ranks' record shards differ in size: "
                             f"{counts}")
        n_records = sum(counts)

    # (1)-(3): Datalog -> schedule -> logical plan.  These raise on any
    # violation of the paper's semantic requirements.
    program = task.program()
    schedule = stratify.iteration_schedule(program)
    assert tuple(r.label for r in schedule.body_rules) == ("G2", "G3")
    logical = algebra.translate(program)

    # (4): physical planning from data statistics.
    if stats is None:
        with torch.device("meta"):
            model0 = task.init_model()
        model_bytes = sum(_nbytes(torch.as_tensor(m))
                          for m in tree_leaves(model0))
        stats = IMRUStats(
            n_records=n_records,
            record_bytes=sum(_nbytes(t, 1) for t in leaves),
            model_bytes=model_bytes,
            stat_bytes=model_bytes,  # gradient-shaped statistic
            flops_per_record=2.0 * model_bytes / 4.0,
        )
    if mesh_spec is None:
        mesh_spec = _ONE_DEVICE if mesh is None else mesh_spec_of(mesh)
    plan = plan_imru(
        stats, mesh_spec, hw,
        force_reduce=force_reduce, codec=codec, microbatches=microbatches,
    )

    # (5): the executor materializes the planned step (map + early
    # aggregation over microbatches + update).
    step, records = build_imru_step(task, records, plan, mesh, mesh_spec)

    return IMRUExecutable(
        task=task,
        program=program,
        logical=logical,
        plan=plan,
        step=step,
        records=records,
        device=device,
        mesh_spec=mesh_spec,
        stats=stats,
        hw=hw,
        mesh=mesh,
    )
