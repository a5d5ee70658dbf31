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
"""

from __future__ import annotations

from dataclasses import dataclass, field
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

__all__ = ["Graph", "VertexProgram", "PregelExecutable", "compile_pregel"]


@dataclass
class Graph:
    """Static graph on one device: dense ids, an edge list."""

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
    # Edge-slab size: a compaction capacity at or above it cannot win, so
    # the adaptive driver keeps the frontier-masked dense path.
    local_edge_cap: int = 0
    _sparse_steps: Dict[int, Callable] = field(default_factory=dict,
                                               repr=False)

    @property
    def device(self) -> torch.device:
        return self.graph.device

    def init(self) -> Tuple[Any, torch.Tensor]:
        n = self.graph.n_vertices
        ids = torch.arange(n, dtype=torch.int32, device=self.device)
        state = self.prog.init_vertex(ids, self.graph.vertex_data)
        active = torch.ones(n, dtype=torch.bool, device=self.device)
        return state, active

    @staticmethod
    def converged(prev, new) -> torch.Tensor:
        _, active = new
        return ~torch.any(active)

    # -- semi-naive (delta-frontier) execution ------------------------------

    def active_edge_count(self, active: torch.Tensor) -> int:
        """|Δ frontier| in edges: edges whose source is active (one
        reduction, read on the host)."""

        return int(torch.index_select(active, 0, self.graph.src).sum())

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
        density threshold, and pick the executing superstep."""

        _, active = carry
        total = self.active_edge_count(active)
        if total == 0:
            return self.halt_superstep, "halt(empty-frontier)"
        density = total / max(self.graph.n_edges, 1)
        if self.plan.mode_for_density(density) == "sparse":
            cap = self.plan.sparse_cap_for(total)
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
        injector: Optional[Any] = None,
    ) -> FixpointResult:
        """Run to the Appendix-B.2 fixpoint.

        Semi-naive plans default to the host driver with per-superstep
        adaptive dense/sparse selection; dense plans default to
        :func:`device_fixpoint`.  ``on_device=True`` and ``adaptive=True``
        exclude each other."""

        if checkpoint_dir is not None or injector is not None:
            raise NotImplementedError(
                "checkpoint_dir= and injector= are not ported yet: ROADMAP "
                "A11 (fault tolerance)"
            )
        if on_device and adaptive:
            raise ValueError(
                "on_device=True and adaptive=True are incompatible: "
                "adaptive dense/sparse selection needs the host driver"
            )
        if adaptive is None:
            adaptive = self.semi_naive and not on_device
        init = self.init()
        if not adaptive:
            return device_fixpoint(
                self.superstep, self.converged, init, max_iters
            )
        return HostFixpointDriver(
            step=self.superstep,
            converged=self.converged,
            config=DriverConfig(max_iters=max_iters),
            select_step=self.adaptive_select_step,
        ).run(init)

    def remesh(self, mesh) -> "PregelExecutable":
        raise NotImplementedError(
            "remesh is not ported yet: ROADMAP A11 (fault tolerance)"
        )


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
    checkpoint_dir: Optional[str] = None,
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
    """

    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: ROADMAP A10 (multi-GPU)"
        )
    if checkpoint_dir is not None or injector is not None:
        raise NotImplementedError(
            "checkpoint_dir= and injector= are not ported yet: ROADMAP A11 "
            "(fault tolerance)"
        )
    device = resolve_device(device)
    for t in [graph.src, graph.dst] + tree_leaves(graph.vertex_data) \
            + tree_leaves(graph.edge_data):
        if isinstance(t, torch.Tensor) and t.device.type != device.type:
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
        mesh_spec = MeshSpec((("data", 1),))
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
    bundle = build_pregel_steps(prog, graph, plan)
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
    )
