"""Pregel front-end (paper §2.1, Listing 1, Fig. 4) in PyTorch.

"Think like a vertex", vectorized.  The user supplies the Listing-1 UDFs as
functions on tensors:

* ``init_vertex(ids, vertex_data) -> state``          (rule L1)
* ``message(j, src_state, edge_data) -> payload``     (the message half of
  ``update``, evaluated per edge from source state)
* ``apply(j, state, inbox, got) -> (new_state, active)`` (the state-update
  half of ``update``; ``active`` is the vote-to-halt bit)
* ``combine`` — a registered commutative/associative monoid (rule L3).

:func:`compile_pregel` binds the UDFs into the Listing-1 Datalog program,
runs the front end (stratifier, algebra, semi-naive rewrite), probes the
workload statistics, cost-plans the physical strategy, and has the executor
build the supersteps.  Supersteps run to the Appendix-B.2 fixpoint: no
active vertices.

On a mesh (``compile_pregel(mesh=)``, one process a rank: see
:mod:`repro_torch.launch.mesh`) every rank compiles the same global graph
and keeps its shard: the vertex rows of its ``pod``/``data`` coordinate
and the edges whose source it owns.  The carry holds the shard's rows;
each decision the host takes between supersteps (converged, dense /
sparse / halt, the sparse capacity) comes from collectively reduced
values, so every rank runs the same superstep; the result's state is
gathered to the global arrays after the loop.  Checkpoints hold the
global carry (gathered on save, written by one rank, cut to each rank's
rows on restore), so :meth:`PregelExecutable.remesh` can move a run onto
the surviving ranks, or onto one device, and resume it from disk.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import algebra, stratify
from repro_torch.core.datalog import Program
from repro_torch.core.executor import build_pregel_steps
from repro_torch.core.fixpoint import (
    DriverConfig,
    FixpointResult,
    HostFixpointDriver,
    agreed,
    checkpointed_run,
    device_fixpoint,
)
from repro_torch.core.hardware import MeshSpec, TPU_V5E, HardwareSpec
from repro_torch.core.listings import pregel_program
from repro_torch.core.monoid import get_monoid
from repro_torch.core.physical import scatter_combine
from repro_torch.core.planner import (
    PregelPhysicalPlan,
    PregelStats,
    plan_pregel,
)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_spec_of, remesh_note
from repro_torch.parallel import collectives as C

__all__ = ["Graph", "VertexProgram", "PregelExecutable", "compile_pregel"]


@dataclass
class Graph:
    """Static graph: dense ids, an edge list.  For a mesh, the global
    graph, on the CPU or the rank's device."""

    n_vertices: int
    src: torch.Tensor         # int32[E] source vertex ids
    dst: torch.Tensor         # int32[E] destination vertex ids
    vertex_data: Any          # tensors with leading dim N (EDB `data`)
    edge_data: Any = None     # optional tensors with leading dim E

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def out_degree(self) -> torch.Tensor:
        return scatter_combine(
            torch.ones(self.src.shape, dtype=torch.float32,
                       device=self.device),
            self.src, self.n_vertices, "sum",
        )


@dataclass
class VertexProgram:
    """The Listing-1 UDFs in vectorized form."""

    init_vertex: Callable[[torch.Tensor, Any], Any]
    message: Callable[[Any, Any, Any], Any]
    apply: Callable[[Any, Any, Any, Any], Tuple[Any, torch.Tensor]]
    combine: str = "sum"
    name: str = "pregel-task"

    def program(self) -> Program:
        monoid = get_monoid(self.combine)
        # Every Pregel inbox is recomputed from scratch each superstep
        # (collect@J derives solely from send@J), which licenses the
        # semi-naive rewrite even for non-idempotent combines.
        return pregel_program(
            udfs={"init_vertex": self.init_vertex, "update": self.apply},
            aggregates={"combine": monoid.as_aggregate(recomputable=True)},
        )


@dataclass
class PregelExecutable:
    prog: VertexProgram
    program: Program
    logical: algebra.LogicalPlan
    plan: PregelPhysicalPlan
    superstep: Callable[[Any, int], Any]   # ((state, active), j) -> carry
    graph: Graph
    semi_naive: bool = False
    sparse_step_factory: Optional[Callable[[int], Callable]] = field(
        default=None, repr=False
    )
    # Edge-slab size (a shard's, on a mesh): a compaction capacity at or
    # above it cannot win, so the adaptive driver keeps the
    # frontier-masked dense path.
    local_edge_cap: int = 0
    # The failure injector threaded from compile (honored at the host step
    # boundary).
    injector: Optional[Any] = None
    # A mesh (repro_torch.launch.mesh.Mesh) the vertices are sharded over,
    # and ``active -> int[n_shards]``, the gathered shard-local active-edge
    # counts.
    mesh: Optional[Any] = None
    shard_count_fn: Optional[Callable] = field(default=None, repr=False)
    _sparse_steps: Dict[int, Callable] = field(default_factory=dict,
                                               repr=False)
    # One note per remesh in this executable's lineage, and the compile
    # options :meth:`remesh` recompiles with.
    remesh_events: Tuple[str, ...] = ()
    _compile_kwargs: Dict[str, Any] = field(default_factory=dict,
                                            repr=False)

    @property
    def device(self) -> torch.device:
        return self.graph.device if self.mesh is None else self.mesh.device

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return () if self.mesh is None else self.mesh.batch_axes

    def to_shard(self, tree: Any) -> Any:
        """This rank's rows of global per-vertex tensors, on its device
        (the identity off a mesh)."""

        if not self.batch_axes:
            return tree
        n_shards = int(np.prod([self.mesh.shape[a]
                                for a in self.batch_axes]))
        rows = self.graph.n_vertices // n_shards
        lo = self.mesh.linear_index(self.batch_axes) * rows
        # A copy: a shard cut from a restored global carry must not keep
        # the global tensor alive.
        return tree_map(
            lambda t: t.narrow(0, lo, rows).to(self.device, copy=True),
            tree)

    def gather(self, tree: Any) -> Any:
        """The global per-vertex tensors from every rank's rows (a
        collective: every rank calls it)."""

        if not self.batch_axes:
            return tree
        with C.bind(self.mesh):
            return tree_map(
                lambda t: C.all_gather(t, self.batch_axes).reshape(
                    (-1,) + tuple(t.shape[1:])), tree)

    def global_init(self) -> Tuple[Any, torch.Tensor]:
        """The initial global carry: ``init_vertex`` over the global ids
        and vertex data (UDFs may close over global arrays, as the JAX
        package's see the global state).  It is also the template a
        checkpoint restores into: checkpoints hold the global carry."""

        n = self.graph.n_vertices
        device = self.device
        ids = torch.arange(n, dtype=torch.int32, device=device)
        vdata = tree_map(lambda t: t.to(device), self.graph.vertex_data)
        state = self.prog.init_vertex(ids, vdata)
        active = torch.ones(n, dtype=torch.bool, device=device)
        return state, active

    def init(self) -> Tuple[Any, torch.Tensor]:
        """The initial carry: :meth:`global_init`'s rows of this rank."""

        return self.to_shard(self.global_init())

    def converged(self, prev, new) -> torch.Tensor:
        """No vertex active on any shard: one all-reduced flag."""

        _, active = new
        return agreed(~torch.any(active), self.mesh, self.batch_axes)

    # -- semi-naive (delta-frontier) execution ------------------------------

    def active_edge_count(self, active: torch.Tensor) -> int:
        """|Δ frontier| in edges: edges whose source is active (one
        reduction, read on the host)."""

        return int(self.shard_edge_counts(active).sum())

    def shard_edge_counts(self, active: torch.Tensor) -> np.ndarray:
        """Shard-local active-edge counts, int array of length n_shards,
        the same on every rank: on a mesh one gathered read a superstep,
        which the host driver aggregates into one decision (sum -> density,
        max -> compaction capacity)."""

        if self.shard_count_fn is None:
            return np.asarray([int(torch.index_select(
                active, 0, self.graph.src).sum())])
        return self.shard_count_fn(active)

    def sparse_superstep(self, cap: int) -> Callable:
        """The frontier-compacted superstep for a static capacity (cached;
        the adaptive driver walks a power-of-two ladder)."""

        fn = self._sparse_steps.get(cap)
        if fn is None:
            fn = self.sparse_step_factory(cap)
            self._sparse_steps[cap] = fn
        return fn

    @staticmethod
    def halt_superstep(carry, j) -> Tuple[Any, torch.Tensor]:
        """The superstep for an all-empty edge frontier: no edge carries a
        message, so every vertex keeps its state and halts — O(N) instead
        of a cap-floor-sized compaction that moves nothing."""

        return carry[0], torch.zeros_like(carry[1])

    def adaptive_select_step(self, carry, j: int) -> Tuple[Callable, str]:
        """Per-superstep dense<->sparse choice (the Fig. 9 connector choice
        recomputed online): measure the frontier, consult the plan's
        density threshold, and pick the executing superstep.  On a mesh the
        gathered shard counts make one decision for every rank."""

        _, active = carry
        counts = self.shard_edge_counts(active)
        total = int(counts.sum())
        if total == 0:
            return self.halt_superstep, "halt(empty-frontier)"
        density = total / max(self.graph.n_edges, 1)
        if self.plan.mode_for_density(density) == "sparse":
            cap = self.plan.sparse_cap_for(int(counts.max()))
            if cap < self.local_edge_cap:
                return self.sparse_superstep(cap), f"sparse@{cap}"
        return self.superstep, "dense"

    # -- fixpoint entry points ---------------------------------------------

    def run(
        self,
        max_iters: int,
        on_device: Optional[bool] = None,
        adaptive: Optional[bool] = None,
        *,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        injector: Optional[Any] = None,
        max_restarts: int = 3,
        keep_checkpoints: int = 3,
    ) -> FixpointResult:
        """Run to the Appendix-B.2 fixpoint.

        Semi-naive plans default to the host driver with per-superstep
        adaptive dense/sparse selection; dense plans default to
        :func:`device_fixpoint`.  ``on_device=True`` and ``adaptive=True``
        exclude each other.  On a mesh the result's state is the global
        state, gathered after the loop (``seconds`` leaves the gather out).

        Fault tolerance (host driver only): ``checkpoint_dir``
        checkpoints the ``(state, active)`` carry host-side every
        ``checkpoint_every`` supersteps (default 8) through a
        :class:`~repro_torch.checkpoint.MeshCheckpointStore`; a crash
        restores and replays, and ``resume=True`` continues a run from
        disk, also one written on another mesh (after :meth:`remesh`) or
        by the JAX package.  ``injector`` overrides the compile-time
        :class:`~repro_torch.ft.FailureInjector` at the step boundary.  A
        restored carry lands on the executable's device.  On a mesh
        every rank passes the same options (an injector may fire on one
        rank only: the driver agrees the crash): the checkpoint holds the
        global carry, gathered on save and written by the mesh's first
        rank, and each rank restores its own rows."""

        if on_device and adaptive:
            raise ValueError(
                "on_device=True and adaptive=True are incompatible: "
                "adaptive dense/sparse selection needs the host driver"
            )
        injector = self.injector if injector is None else injector
        ft = checkpoint_dir is not None or injector is not None
        if on_device and ft:
            raise ValueError(
                "fault tolerance (checkpoint_dir/injector) needs the host "
                "driver: pass on_device=False"
            )
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True needs checkpoint_dir=")
        if adaptive is None:
            adaptive = self.semi_naive and not on_device
        if on_device is None:
            on_device = not adaptive and not ft
        init = self.init()
        if on_device and not adaptive:
            res = device_fixpoint(
                self.superstep, self.converged, init, max_iters
            )
        else:
            res = checkpointed_run(
                lambda config, save, restore: self.driver(
                    config, adaptive=adaptive, save=save, restore=restore,
                    injector=injector),
                init, self.global_init, max_iters,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                max_restarts=max_restarts,
                keep_checkpoints=keep_checkpoints, mesh=self.mesh,
                to_global=self.gather, to_local=self.to_shard,
            )
        if self.batch_axes:
            res.state = self.gather(res.state)
        if self.remesh_events:
            res = replace(res, remesh_events=self.remesh_events)
        return res

    def driver(
        self,
        config: DriverConfig,
        adaptive: Optional[bool] = None,
        **hooks,
    ) -> HostFixpointDriver:
        if adaptive is None:
            adaptive = self.semi_naive
        hooks.setdefault("injector", self.injector)
        return HostFixpointDriver(
            step=self.superstep,
            converged=self.converged,
            config=config,
            select_step=self.adaptive_select_step if adaptive else None,
            mesh=self.mesh,
            **hooks,
        )

    def remesh(self, mesh) -> "PregelExecutable":
        """Recompile this vertex program onto ``mesh`` (the surviving
        ranks, :func:`~repro_torch.launch.mesh.make_mesh` with ``ranks=``;
        every rank of it calls this) or onto one device (``None``, on this
        executable's device): the same global graph and program, the
        stored compile options, the plan re-derived for the new topology.
        The remesh is recorded in ``plan.notes`` and carried into
        ``FixpointResult.remesh_events``.  Checkpoints written by the old
        executable restore into the new one: they hold the global
        carry."""

        graph, kw = self.graph, dict(self._compile_kwargs)
        if mesh is None:
            graph = _graph_to(graph, self.device)
            kw["device"] = self.device
        new = compile_pregel(self.prog, graph, mesh=mesh,
                             semi_naive=self.semi_naive,
                             injector=self.injector, **kw)
        note = remesh_note(self.mesh, mesh)
        new.plan = replace(new.plan, notes=new.plan.notes + (note,))
        new.remesh_events = self.remesh_events + (note,)
        return new


def _meta_like(t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    shape = tuple(t.shape) if rows is None else (rows,) + tuple(t.shape[1:])
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _probe_payload(prog: VertexProgram, graph: Graph):
    """Shape and dtype of one superstep's message payload, from the init and
    message UDFs run on ``meta`` tensors (no data, no FLOPs); None when the
    UDFs cannot run there."""

    n, e = graph.n_vertices, graph.n_edges
    try:
        ids = torch.empty(n, dtype=torch.int32, device="meta")
        vdata = tree_map(_meta_like, graph.vertex_data)
        state = prog.init_vertex(ids, vdata)
        src_state = tree_map(lambda s: _meta_like(s, e), state)
        edata = tree_map(_meta_like, graph.edge_data)
        payload = prog.message(0, src_state, edata)
        return tuple(payload.shape), payload.dtype
    except Exception:
        return None  # shape probe is best-effort for exotic UDFs


def compile_pregel(
    prog: VertexProgram,
    graph: Graph,
    *,
    mesh: Any = None,
    mesh_spec: Optional[MeshSpec] = None,
    hw: HardwareSpec = TPU_V5E,
    force_connector: Optional[str] = None,
    payload_bytes: int = 4,
    semi_naive: bool = False,
    injector: Optional[Any] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> PregelExecutable:
    """Compile a vertex program through the declarative stack (Fig. 1).

    ``device`` (default: the card) must be the device the graph's tensors
    lie on; with no device named and no card present this raises.
    ``semi_naive=True`` enables delta-frontier evaluation: the logical plan's
    eligible recursive reads become ``Delta`` scans, the physical plan gains
    a frontier-density threshold from the cost model, and the executable
    carries frontier-compacted sparse supersteps the adaptive driver swaps
    in below it.  ``prog.combine`` names any registered monoid; the message
    payload is probed on ``meta`` tensors so structured monoids validate
    their width at compile and the planner prices the true per-message
    bytes (``payload_bytes`` is the fallback when the probe cannot run).
    ``hw`` defaults to the TPU model so plan notes match the JAX package's.
    ``injector`` (a :class:`~repro_torch.ft.FailureInjector`) rides the
    executable to its host driver's step boundary.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`; every rank calls
    this with the same global graph) shards the vertices and the edge
    slabs over its ``pod``/``data`` axes on the mesh's device;
    ``mesh_spec`` defaults to :func:`~repro_torch.launch.mesh.mesh_spec_of`
    it, so the plan and its notes are the JAX package's for that mesh.
    """

    if mesh is not None:
        # The graph stays global (on the CPU or the rank's device); the
        # executor cuts this rank's shard to the mesh's device.
        if device is not None and torch.device(device).type \
                != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
        if not mesh.batch_axes:
            graph = _graph_to(graph, device)
    device = resolve_device(device)
    for t in [graph.src, graph.dst] + tree_leaves(graph.vertex_data) \
            + tree_leaves(graph.edge_data):
        if mesh is None and isinstance(t, torch.Tensor) \
                and t.device.type != device.type:
            raise ValueError(
                f"graph tensors lie on {t.device}, compile_pregel was asked "
                f"for {device}: build the graph there "
                "(repro_torch.carry.graph_from_numpy)"
            )
    monoid = get_monoid(prog.combine)

    # Per-edge attribute payload width (weighted graphs).
    edge_attr_bytes = 0
    for leaf in tree_leaves(graph.edge_data):
        shape = tuple(leaf.shape)
        if len(shape) < 1 or shape[0] != graph.n_edges:
            raise ValueError(
                "every edge_data leaf needs leading dim n_edges "
                f"({graph.n_edges}); got shape {shape}"
            )
        edge_attr_bytes += leaf.element_size() * int(
            np.prod(shape[1:], dtype=np.int64)
        )

    msg_bytes = payload_bytes
    probe = _probe_payload(prog, graph)
    if probe is not None:
        shape, dtype = probe
        monoid.validate_payload(shape, dtype)
        msg_bytes = dtype.itemsize * max(
            int(np.prod(shape[1:], dtype=np.int64)), 1
        )

    # (1)-(3): Datalog -> XY schedule -> Figure-3 logical plan.
    program = prog.program()
    schedule = stratify.iteration_schedule(program)
    assert tuple(r.label for r in schedule.init_rules) == ("L1", "L2")
    logical = algebra.translate(program)
    sn_notes: Tuple[str, ...] = ()
    if semi_naive:
        logical, sn_notes = algebra.semi_naive_rewrite(logical, program)

    # (4): physical plan from graph statistics.
    if mesh_spec is None:
        mesh_spec = MeshSpec((("data", 1),)) if mesh is None \
            else mesh_spec_of(mesh)
    stats = PregelStats(
        n_vertices=graph.n_vertices,
        n_edges=graph.n_edges,
        vertex_bytes=payload_bytes,
        msg_bytes=msg_bytes,
        edge_attr_bytes=edge_attr_bytes,
        combine=prog.combine,
    )
    plan = plan_pregel(
        stats, mesh_spec, hw, force_connector=force_connector,
        semi_naive=semi_naive, extra_notes=sn_notes,
    )

    # (5): the executor materializes the planned superstep pipeline.
    bundle = build_pregel_steps(prog, graph, plan, mesh, injector=injector)
    return PregelExecutable(
        prog=prog,
        program=program,
        logical=logical,
        plan=plan,
        superstep=bundle.superstep,
        graph=graph,
        semi_naive=semi_naive,
        sparse_step_factory=bundle.sparse_step_factory,
        local_edge_cap=bundle.local_edge_cap,
        injector=bundle.injector,
        mesh=mesh,
        shard_count_fn=bundle.shard_count_fn,
        _compile_kwargs={"hw": hw, "force_connector": force_connector,
                         "payload_bytes": payload_bytes},
    )


def _graph_to(graph: Graph, device: torch.device) -> Graph:
    return Graph(graph.n_vertices, graph.src.to(device),
                 graph.dst.to(device),
                 tree_map(lambda t: t.to(device), graph.vertex_data),
                 tree_map(lambda t: t.to(device), graph.edge_data))
