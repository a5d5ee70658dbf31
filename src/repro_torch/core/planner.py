"""Cost-based physical planner (paper Section 4).

Lowers the logical plans of :mod:`repro_torch.core.algebra` into physical plans for
the PyTorch runtime, applying the paper's named optimizations as explicit,
testable rewrite rules:

* **Early aggregation / early grouping** (Fig. 5 O6, Fig. 4 O15) — exploit
  commutativity+associativity of the registered aggregate to pre-reduce
  sender-side: microbatch-local gradient accumulation for IMRU, per-shard
  message combining for Pregel.
* **Aggregation-tree selection** (Fig. 5 O8, the "model volume property") —
  pick the gradient-reduction collective schedule by alpha-beta cost:
  flat all-reduce, hierarchical per-axis (ICI before DCN), reduce-scatter +
  sharded update + all-gather (ZeRO-1), or a k-ary latency tree for the
  cross-pod hop.
* **Loop-invariant caching** (§5.2, HaLoop "sticky" placement) — EDB
  relations scanned inside the fixpoint body stay device-resident across
  iterations; only the per-iteration frontier moves.
* **Join algorithm + storage selection** (Fig. 4 O7/O5) — vertex state is a
  dense id-indexed sharded array ("B-tree" analogue) probed by gather
  (index join); the logical max-over-temporal vanishes.
* **Connector selection** (Fig. 9) — Pregel message exchange: dense partial
  psum (replicate-and-reduce), or sparse all-to-all with either the
  *merging* combiner (pre-sorted segment reduce — cheaper compute, stalls at
  scale) or *hash+sort* (scatter-add — robust).

Each applied rule is recorded in ``plan.notes`` so tests and EXPERIMENTS.md
can assert which rewrites fired.  The cost model is the same three-term
roofline used for §Roofline (see :mod:`repro_torch.core.hardware`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.hardware import (
    CollectiveCost,
    HardwareSpec,
    MeshSpec,
    TPU_V5E,
    all_to_all,
    kary_tree_reduce,
    ring_all_gather,
    ring_all_reduce,
    ring_reduce_scatter,
)

__all__ = [
    "IMRUStats",
    "PregelStats",
    "ReduceSchedule",
    "IMRUPhysicalPlan",
    "PregelPhysicalPlan",
    "ProgramPlan",
    "GroupBySpec",
    "plan_imru",
    "plan_pregel",
    "plan_program",
    "pregel_superstep_costs",
    "ServingDecision",
    "serving_admission",
    "enumerate_reduce_schedules",
]


# ---------------------------------------------------------------------------
# Workload statistics ("data statistics" driving the optimizer)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IMRUStats:
    """Statistics of an Iterative Map-Reduce-Update task.

    ``stat_bytes`` is the size of the aggregated statistic — the (gradient,
    loss) payload; 16 MB in the paper's BGD task, gigabytes for LM training.
    """

    n_records: int
    record_bytes: int
    model_bytes: int
    stat_bytes: int
    flops_per_record: float
    dtype_bytes: int = 4


@dataclass(frozen=True)
class PregelStats:
    """``frontier_density`` is the expected fraction of edges whose source
    vertex is still active (|Δ frontier| / E).  Semi-naive plans cost their
    superstep estimate at this density (see :func:`plan_pregel`); the
    adaptive driver re-measures the true density every superstep and
    re-evaluates the dense↔sparse choice online.

    ``edge_attr_bytes`` is the per-edge attribute payload (weighted graphs:
    the bytes of ``Graph.edge_data`` gathered for every evaluated edge — 0
    for unweighted topologies).  It widens the edge-pipeline memory terms on
    both the dense and the frontier-compacted paths, so the dense↔sparse
    ``density_threshold`` accounts for weighted payloads.

    ``combine`` names the registered aggregate monoid; ``msg_bytes`` is the
    full per-message payload (a structured monoid like argmin carries its
    whole (key, payload...) row — ``compile_pregel`` derives it from the
    probed message shape).  Monoids without a hardware fast path combine
    dense partials by all-gather instead of psum-scatter, which the
    connector costing accounts for (see :func:`plan_pregel`)."""

    n_vertices: int
    n_edges: int
    vertex_bytes: int
    msg_bytes: int
    edge_attr_bytes: int = 0
    flops_per_edge: float = 2.0
    frontier_density: float = 1.0
    combine: str = "sum"


# ---------------------------------------------------------------------------
# Reduce schedules (the aggregation-tree feature)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReduceSchedule:
    """A physical strategy for the global ``reduce`` aggregate.

    kinds:
      * ``flat``          — one all-reduce over all data-parallel axes.
      * ``hierarchical``  — all-reduce over intra-pod ``data`` (ICI), then
                            over ``pod`` (DCN): the paper's machine-local
                            pre-aggregation + 1-level tree.
      * ``scatter``       — reduce-scatter over ``data`` + all-reduce over
                            ``pod`` on the shard + all-gather at use point
                            (ZeRO-1: enables sharded optimizer states).
      * ``kary_tree``     — hierarchical, with the cross-pod hop done as a
                            k-ary latency tree (paper's 4-ary tree).
    """

    kind: str
    kary: int = 4
    codec: Optional[str] = None  # None | "bf16" | "int8_ef"
    notes: Tuple[str, ...] = ()

    def codec_factor(self) -> float:
        return {"bf16": 0.5, "int8_ef": 0.25}.get(self.codec or "", 1.0)

    def cost(
        self, stat_bytes: float, mesh: MeshSpec, hw: HardwareSpec
    ) -> CollectiveCost:
        nbytes = stat_bytes * self.codec_factor()
        d, p = mesh.size("data"), mesh.size("pod")
        ici, dcn = hw.ici_bw, hw.dcn_bw
        a_i, a_d = hw.ici_latency, hw.dcn_latency
        if self.kind == "flat":
            # One logical all-reduce over pod*data; the busiest link is the
            # slowest class touched (DCN when pods > 1).
            n = d * p
            bw = dcn if p > 1 else ici
            alpha = a_d if p > 1 else a_i
            return ring_all_reduce(nbytes, n, bw, alpha)
        if self.kind == "hierarchical":
            inner = ring_all_reduce(nbytes, d, ici, a_i)
            outer = ring_all_reduce(nbytes, p, dcn, a_d)
            return inner + outer
        if self.kind == "scatter":
            rs = ring_reduce_scatter(nbytes, d, ici, a_i)
            outer = ring_all_reduce(nbytes / max(d, 1), p, dcn, a_d)
            ag = ring_all_gather(nbytes, d, ici, a_i)
            return rs + outer + ag
        if self.kind == "kary_tree":
            inner = ring_all_reduce(nbytes, d, ici, a_i)
            tree = kary_tree_reduce(nbytes, p, self.kary, dcn, a_d)
            return inner + tree
        raise ValueError(f"unknown reduce schedule {self.kind!r}")


def enumerate_reduce_schedules(mesh: MeshSpec) -> Tuple[ReduceSchedule, ...]:
    scheds = [ReduceSchedule("flat"), ReduceSchedule("hierarchical"),
              ReduceSchedule("scatter")]
    if mesh.size("pod") > 2:
        scheds += [ReduceSchedule("kary_tree", kary=4)]
    return tuple(scheds)


# ---------------------------------------------------------------------------
# IMRU physical plan (paper Figure 5)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IMRUPhysicalPlan:
    """Physical plan for the Iterative Map-Reduce-Update dataflow.

    Mirrors Figure 5 of the paper with TPU-native operators:

      scan(records, cached) -> map -> [microbatch local pre-agg]
        -> reduce collective schedule -> update -> next model
    """

    mesh: MeshSpec
    batch_axes: Tuple[str, ...]          # axes sharding the record scan
    model_axes: Tuple[str, ...]          # axes sharding model params (TP)
    reduce: ReduceSchedule
    microbatches: int
    cache_training_data: bool            # loop-invariant caching
    donate_state: bool
    shard_optimizer_states: bool         # ZeRO-1 (implied by scatter)
    notes: Tuple[str, ...] = ()
    est_step_seconds: float = 0.0

    def explain(self) -> str:
        lines = [
            f"IMRU physical plan on mesh {self.mesh}",
            f"  records sharded over {self.batch_axes}; "
            f"model sharded over {self.model_axes or ('<replicated>',)}",
            f"  reduce schedule: {self.reduce.kind}"
            + (f" (k={self.reduce.kary})" if self.reduce.kind == "kary_tree" else "")
            + (f" codec={self.reduce.codec}" if self.reduce.codec else ""),
            f"  microbatches: {self.microbatches}",
            f"  loop-invariant cache: {self.cache_training_data}",
            f"  sharded optimizer states: {self.shard_optimizer_states}",
            f"  estimated step: {self.est_step_seconds * 1e3:.3f} ms",
            "  applied rules: " + ", ".join(self.notes),
        ]
        return "\n".join(lines)


def plan_imru(
    stats: IMRUStats,
    mesh: MeshSpec,
    hw: HardwareSpec = TPU_V5E,
    *,
    force_reduce: Optional[str] = None,
    codec: Optional[str] = None,
    microbatches: Optional[int] = None,
) -> IMRUPhysicalPlan:
    """Cost-based lowering of the Figure-2 logical plan onto a mesh.

    ``force_reduce``/``codec``/``microbatches`` allow the perf harness to pin
    a choice (the paper's "tunable to a specific task").
    """

    notes: List[str] = []

    # Rule: loop-invariant caching — training_data is EDB scanned inside the
    # fixpoint body, therefore cached device-resident (paper §5.2).
    cache = True
    notes.append("loop-invariant-caching(training_data)")

    # Rule: early aggregation — reduce is declared commutative+associative,
    # so map-local pre-aggregation is sound (Fig. 5 O6).
    notes.append("early-aggregation(map-local)")

    # Rule: model-volume property — shard the model over the 'model' axis
    # when a replica would not comfortably fit a chip's HBM alongside
    # activations; otherwise replicate (BGD's vector model).
    model_axes: Tuple[str, ...] = ()
    if stats.model_bytes > hw.hbm_bytes // 8:
        model_axes = ("model",)
        notes.append("model-volume(shard-params-over-model-axis)")
    else:
        notes.append("model-volume(replicate-params)")

    # Rule: aggregation-tree selection — cost every schedule, pick cheapest.
    candidates = enumerate_reduce_schedules(mesh)
    if force_reduce is not None:
        candidates = tuple(
            replace(s, codec=codec) for s in candidates if s.kind == force_reduce
        )
        if not candidates:
            candidates = (ReduceSchedule(force_reduce, codec=codec),)
    elif codec is not None:
        candidates = tuple(replace(s, codec=codec) for s in candidates)

    grad_bytes = stats.stat_bytes / max(len(model_axes) and mesh.size("model"), 1)
    best = min(candidates, key=lambda s: s.cost(grad_bytes, mesh, hw).seconds)
    reduce_cost = best.cost(grad_bytes, mesh, hw)
    notes.append(f"aggregation-tree({best.kind})")
    if best.codec:
        notes.append(f"gradient-codec({best.codec})")

    # Microbatching: bound live activation memory; default heuristic keeps
    # the per-device record slab under ~1/4 HBM.
    dp = mesh.data_parallel_size
    per_dev_bytes = stats.n_records * stats.record_bytes / max(dp, 1)
    mb = microbatches or max(1, int(math.ceil(per_dev_bytes / (hw.hbm_bytes / 4))))
    if mb > 1:
        notes.append(f"microbatch(x{mb})")

    # Roofline estimate of one iteration (compute + memory + collective).
    chips = mesh.n_devices
    compute = stats.n_records * stats.flops_per_record / (chips * hw.peak_flops_bf16)
    memory = stats.n_records * stats.record_bytes / (chips * hw.hbm_bw)
    est = max(compute, memory) + reduce_cost.seconds

    return IMRUPhysicalPlan(
        mesh=mesh,
        batch_axes=tuple(n for n in ("pod", "data") if mesh.size(n) > 1),
        model_axes=model_axes,
        reduce=best,
        microbatches=mb,
        cache_training_data=cache,
        donate_state=True,
        shard_optimizer_states=(best.kind == "scatter"),
        notes=tuple(notes),
        est_step_seconds=est,
    )


# ---------------------------------------------------------------------------
# Generic-program physical plan (the unified logical-plan executor)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GroupBySpec:
    """One GroupBy site of a generic program, as seen by the planner.

    ``rows`` is the flattened size of the grouped child grid (``n`` to the
    number of its key dimensions), ``segments`` the output-grid size; the
    gap between them is the fan-in the receiver-side combine absorbs.
    """

    label: str
    agg: str
    rows: int
    segments: int
    kernel_op: Optional[str]


@dataclass(frozen=True)
class ProgramPlan:
    """Physical plan for a generic XY-stratified program on the dense-grid
    executor (:mod:`repro_torch.core.executor`).

    The logical plan is the execution contract: per-iteration rules run as
    dense masked tensor ops over the vertex-domain grid, GroupBy sites lower
    to the Fig.-9 receiver-side combine algorithms resolved through the
    :class:`~repro_torch.core.monoid.CombineMonoid` registry, and recursive SCCs
    execute as sequential fixpoint phases.
    """

    mesh: MeshSpec
    domain: int
    phases: Tuple[Tuple[str, ...], ...]
    groupbys: Tuple[GroupBySpec, ...]
    connectors: Mapping[str, str]        # rule label -> combine strategy
    semi_naive: bool = False
    notes: Tuple[str, ...] = ()
    est_iteration_seconds: float = 0.0
    # Physical storage selection: predicate -> "dense-grid" | "row-table",
    # the row-table slab capacity per row predicate, and the shared
    # intermediate slab capacity (0 when no predicate is row-stored).
    storage: Mapping[str, str] = field(default_factory=dict)
    row_caps: Mapping[str, int] = field(default_factory=dict)
    row_cap: int = 0
    # Explicit sharded exchange selection: row predicate -> "bucket-a2a" |
    # "psum-scatter" | "gspmd" (empty on single-shard meshes), with the
    # per-shard receiver bucket capacity for the bucket all-to-all modes.
    exchanges: Mapping[str, str] = field(default_factory=dict)
    exchange_caps: Mapping[str, int] = field(default_factory=dict)
    # Out-of-core streaming: row-stored EDB predicate -> chunk count (>= 2
    # or forced), plus the per-device HBM budget the split was sized for.
    chunks: Mapping[str, int] = field(default_factory=dict)
    hbm_budget: int = 0

    def explain(self) -> str:
        lines = [
            f"Generic program plan on mesh {self.mesh} "
            f"(domain n={self.domain})",
            "  fixpoint phases: "
            + " -> ".join("+".join(p) for p in self.phases),
            f"  estimated iteration: "
            f"{self.est_iteration_seconds * 1e3:.3f} ms",
            "  applied rules: " + ", ".join(self.notes),
        ]
        return "\n".join(lines)


# Storage-selection cost model (see docs/optimizations.md):
# - a predicate's dense grid above _ROW_FORCE_CELLS cells is infeasible to
#   materialize per iteration -> always row-table;
# - between _ROW_MIN_CELLS and the force threshold, row-table wins when the
#   estimated cardinality leaves the grid at least _ROW_EST_FACTOR-x empty
#   (row ops pay sort-merge log factors, so mild sparsity keeps dense);
# - below _ROW_MIN_CELLS the dense masked tensor ops always win.
_ROW_FORCE_CELLS = 1 << 24
_ROW_MIN_CELLS = 1 << 21
_ROW_EST_FACTOR = 16
# Row-table slab capacities: 8x estimate headroom rounded to a power of
# two, never above _ROW_CAP_MAX (the lossless overflow fallback catches
# underestimates); intermediates get 4x the largest predicate slab.
_ROW_CAP_MAX = 1 << 20
_ROW_INTER_CAP_MAX = 1 << 22
# Explicit-exchange selection (see docs/optimizations.md "Out-of-core
# streaming & explicit exchanges"): slabs below _EXCHANGE_MIN_ROWS are too
# small for the shard_map bucket machinery to beat GSPMD's replicated
# lowering (the all-to-all alpha terms dominate), so they stay implicit.
# psum-scatter needs a dense per-shard partial grid, so it is only chosen
# when the target's cell count keeps that grid cheap.
_EXCHANGE_MIN_ROWS = 1 << 13
_PSUM_SCATTER_MAX_CELLS = 1 << 20
_EXCHANGE_MODES = ("bucket-a2a", "psum-scatter", "gspmd")


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _select_storage(
    domain: int,
    predicates: Mapping[str, Tuple[int, float]],
    forced: Optional[Mapping[str, str]],
) -> Tuple[Dict[str, str], Dict[str, int]]:
    storage: Dict[str, str] = {}
    row_caps: Dict[str, int] = {}
    for pred, (arity, est) in predicates.items():
        cells = float(domain) ** arity
        choice = (forced or {}).get(pred)
        if choice is None:
            if arity == 0:
                choice = "dense-grid"
            elif cells > _ROW_FORCE_CELLS:
                choice = "row-table"
            elif cells >= _ROW_MIN_CELLS and est * _ROW_EST_FACTOR <= cells:
                choice = "row-table"
            else:
                choice = "dense-grid"
        elif choice not in ("dense-grid", "row-table"):
            raise ValueError(
                f"unknown storage {choice!r} for predicate {pred!r} "
                "(expected 'dense-grid' or 'row-table')"
            )
        if arity == 0:
            choice = "dense-grid"  # scalar facts have no row encoding
        storage[pred] = choice
        if choice == "row-table":
            cap = min(_next_pow2(max(64, int(8 * est))), _ROW_CAP_MAX)
            if cells <= _ROW_CAP_MAX:
                # Universe bound: the slab never needs more rows than the
                # whole domain grid has cells (small forced-row domains
                # become overflow-free).
                cap = min(cap, _next_pow2(int(cells)))
            row_caps[pred] = cap
    return storage, row_caps


def plan_program(
    phases: Tuple[Tuple[str, ...], ...],
    groupbys: Sequence[GroupBySpec],
    domain: int,
    mesh: MeshSpec,
    hw: HardwareSpec = TPU_V5E,
    *,
    semi_naive: bool = False,
    extra_notes: Tuple[str, ...] = (),
    predicates: Optional[Mapping[str, Tuple[int, float]]] = None,
    storage: Optional[Mapping[str, str]] = None,
    row_cap: Optional[int] = None,
    exchange: Optional[object] = None,
    exchange_ops: Optional[Mapping[str, Optional[str]]] = None,
    hbm_budget: Optional[int] = None,
    chunks: Optional[object] = None,
    edb: Sequence[str] = (),
    row_value_cols: Optional[Mapping[str, int]] = None,
) -> ProgramPlan:
    """Cost-based lowering of a generic logical plan onto the dense-grid
    executor.

    Mirrors :func:`plan_pregel`'s note discipline: every applied strategy is
    recorded in ``plan.notes`` so golden tests pin the decisions.  The
    GroupBy connector choice is the Fig.-9 receiver-algorithm selection:
    monoids riding a hardware fast path take the dense masked reduction over
    the grouped axes (``dense-reduce`` — the grid analogue of the dense
    partial-vector connector, one streaming pass, no ids); generic monoids
    lower to the pre-clustered segmented scan (``segment-scan`` — the
    *merging* algorithm: keys-leading grid order makes the flattened segment
    ids presorted, so no sort is ever paid).  Both costs are estimated and
    the winner recorded.

    ``predicates`` maps each predicate to ``(key arity, estimated rows)``
    and drives the per-predicate **storage selection** (``dense-grid`` vs
    ``row-table`` — see the ``_ROW_*`` cost constants); ``storage`` forces
    individual predicates, ``row_cap`` pins the intermediate slab size.
    The selection is recorded as the leading ``storage-selection(...)``
    note (byte-identical to the historical all-dense note when nothing is
    row-stored).

    ``extra_notes`` carries upstream logical-rewrite decisions, appended
    last in a fixed order: the ``semi-naive(...)`` delta-rewrite entries,
    then the optimizer's single ``rewrite(join-reorder: ..., pushdown: ...,
    cse: n shared)`` entry from :func:`repro_torch.core.rewrite.rewrite_plan`
    (when ``compile_program(..., rewrite=True)``) — so golden tests pin
    logical and physical decisions in one tuple.

    On multi-shard meshes each row-stored predicate additionally gets an
    **explicit-exchange selection** (``exchange(...)`` notes): slabs at
    least ``_EXCHANGE_MIN_ROWS`` deep lower their GroupBy/Join sites onto
    the explicit sharded connectors — a key-hash ``bucket-a2a`` whose
    per-shard receiver capacity divides the global estimate by the shard
    count (``exchange_caps``), or ``psum-scatter`` when the target's merge
    monoid rides the sum kernel and its dense partial grid stays small —
    while smaller slabs keep the implicit ``gspmd`` lowering.  ``exchange``
    forces one mode for every predicate (a string) or per predicate (a
    mapping); ``exchange_ops`` supplies each predicate's merge-monoid
    kernel op.

    **Out-of-core streaming** (``chunking(...)`` notes): row-stored EDB
    predicates (``edb``) whose estimated device slab exceeds the per-device
    ``hbm_budget`` (default: half of ``hw.hbm_bytes``) are split into
    host-resident chunks streamed through the fixpoint step; ``chunks``
    forces a count globally (int) or per predicate (mapping).
    ``row_value_cols`` gives each predicate's value-column count for the
    slab-byte estimate.
    """

    pred_storage, row_caps = _select_storage(
        domain, predicates or {}, storage
    )
    row_preds = sorted(p for p, s in pred_storage.items() if s == "row-table")
    if row_preds:
        n_dense = sum(1 for s in pred_storage.values() if s == "dense-grid")
        parts = [f"n={domain}"] + [
            f"{p}=row-table[cap={row_caps[p]}]" for p in row_preds
        ]
        if n_dense:
            parts.append(f"dense-grid x{n_dense}")
        storage_note = "storage-selection(" + ", ".join(parts) + ")"
        inter_cap = row_cap if row_cap is not None else min(
            max(4 * max(row_caps.values()), 256), _ROW_INTER_CAP_MAX
        )
    else:
        # No row-stored predicate: the note stays byte-identical to the
        # all-dense plans golden tests pin.
        storage_note = f"storage-selection(dense-grid[n={domain}])"
        inter_cap = 0

    notes: List[str] = [
        storage_note,
        "loop-invariant-caching(edb-grids)",
    ]
    dp = mesh.data_parallel_size
    if dp > 1:
        notes.append(f"spmd(gspmd data-parallel x{dp})")

    # Rule: explicit-exchange selection — on multi-shard meshes, decide per
    # row-stored predicate whether its GroupBy/Join sites run on the
    # explicit sharded connectors (shard_map bucket all-to-all /
    # psum-scatter) or stay on the implicit GSPMD lowering.  The per-shard
    # receiver capacity divides the global cardinality estimate by the
    # shard count (each shard owns ~1/dp of the key-hash space) — deriving
    # it from row_caps directly would leave buckets dp-x oversized.
    pred_arity = {p: a for p, (a, _) in (predicates or {}).items()}
    pred_est = {p: e for p, (_, e) in (predicates or {}).items()}
    exchanges: Dict[str, str] = {}
    exchange_caps: Dict[str, int] = {}
    if dp > 1 and row_preds:
        forced_exchange: Mapping[str, str]
        if exchange is None:
            forced_exchange = {}
        elif isinstance(exchange, str):
            forced_exchange = {p: exchange for p in row_preds}
        else:
            forced_exchange = dict(exchange)
        for p in forced_exchange:
            if forced_exchange[p] not in _EXCHANGE_MODES:
                raise ValueError(
                    f"unknown exchange {forced_exchange[p]!r} for "
                    f"predicate {p!r} (expected one of {_EXCHANGE_MODES})"
                )
        ops = exchange_ops or {}
        for p in row_preds:
            cells = float(domain) ** pred_arity.get(p, 2)
            mode = forced_exchange.get(p)
            if mode is None:
                if row_caps[p] >= _EXCHANGE_MIN_ROWS:
                    if ops.get(p) == "sum" and cells <= _PSUM_SCATTER_MAX_CELLS:
                        mode = "psum-scatter"
                    else:
                        mode = "bucket-a2a"
                else:
                    mode = "gspmd"
            exchanges[p] = mode
            if mode != "gspmd":
                per_shard = int(8 * pred_est.get(p, row_caps[p] / 8.0)) // dp
                exchange_caps[p] = min(
                    _next_pow2(max(64, per_shard)), row_caps[p]
                )
                detail = (
                    f"bucket-a2a[cap={exchange_caps[p]}]"
                    if mode == "bucket-a2a" else mode
                )
            else:
                detail = mode
            notes.append(f"exchange({p}: {detail})")

    # Rule: out-of-core streaming — split row-stored EDB scans whose device
    # slab exceeds the per-device HBM budget into host-resident chunks.
    budget = int(hbm_budget) if hbm_budget is not None else hw.hbm_bytes // 2
    if budget <= 0:
        raise ValueError(f"hbm_budget must be positive, got {budget}")
    if chunks is None:
        forced_chunks: Mapping[str, int] = {}
    elif isinstance(chunks, int):
        forced_chunks = {p: chunks for p in edb if pred_storage.get(p) == "row-table"}
    else:
        forced_chunks = dict(chunks)
    for p, m in forced_chunks.items():
        if p not in set(edb):
            raise ValueError(
                f"chunked streaming only applies to EDB scans; {p!r} is "
                "not an EDB predicate of this program"
            )
        if pred_storage.get(p) != "row-table":
            raise ValueError(
                f"chunked streaming requires row-table storage for {p!r} "
                f"(got {pred_storage.get(p, '<unknown>')!r})"
            )
        if int(m) < 1:
            raise ValueError(f"chunk count must be >= 1, got {m} for {p!r}")
    vals = row_value_cols or {}
    chunk_counts: Dict[str, int] = {}
    for p in sorted(set(edb)):
        if pred_storage.get(p) != "row-table":
            continue
        arity = pred_arity.get(p, 2)
        slab_bytes = row_caps[p] * (4 * arity + 1 + 4 * vals.get(p, 0))
        m = forced_chunks.get(p)
        if m is None:
            m = int(math.ceil(slab_bytes / budget))
        m = max(int(m), 1)
        if m > 1:
            chunk_counts[p] = m
            notes.append(f"chunking({p}: {m} chunks, budget={budget}B)")

    if len(phases) > 1:
        notes.append(
            "fixpoint-phases("
            + " -> ".join("+".join(p) for p in phases)
            + ")"
        )

    connectors: Dict[str, str] = {}
    est = 0.0
    for spec in groupbys:
        # Dense masked reduction: stream the grid once (value + mask).
        dense_s = spec.rows * 5.0 / hw.hbm_bw
        # Segmented scan: value + presorted ids + scan state, ~log passes.
        seg_s = (
            spec.rows * 9.0 * max(math.log2(max(spec.rows, 2)), 1.0) / 8.0
        ) / hw.hbm_bw
        if spec.kernel_op is not None and dense_s <= seg_s:
            strategy = "dense-reduce"
            est += dense_s
        else:
            strategy = "segment-scan"
            est += seg_s
        connectors[spec.label] = strategy
        notes.append(
            f"groupby({spec.label}: {spec.agg} via {strategy}, "
            f"{spec.rows} rows -> {spec.segments})"
        )
    notes.extend(extra_notes)

    return ProgramPlan(
        mesh=mesh,
        domain=domain,
        phases=phases,
        groupbys=tuple(groupbys),
        connectors=connectors,
        semi_naive=semi_naive,
        notes=tuple(notes),
        est_iteration_seconds=est,
        storage=pred_storage,
        row_caps=row_caps,
        row_cap=inter_cap,
        exchanges=exchanges,
        exchange_caps=exchange_caps,
        chunks=chunk_counts,
        hbm_budget=budget,
    )


# ---------------------------------------------------------------------------
# Pregel physical plan (paper Figure 4)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PregelPhysicalPlan:
    """Physical plan for the Pregel superstep dataflow (Figure 4).

    ``connector`` selects the message-exchange strategy:
      * ``dense_psum``  — each shard accumulates a dense partial contribution
        vector over all N vertices, reduced with psum-scatter to owners.
        The TPU-native plan when ``N * msg_bytes`` fits HBM comfortably;
        collective volume is independent of edge count.
      * ``merging``     — sparse all-to-all with sender-sorted buckets and a
        pre-clustered (sorted segment) combine at the receiver — the paper's
        hash-partitioning *merging* connector.
      * ``hash_sort``   — sparse all-to-all with receiver-side sort or
        scatter-add — the paper's hash connector + explicit sorter.
    """

    mesh: MeshSpec
    vertex_axes: Tuple[str, ...]
    connector: str
    sender_combine: bool                 # early grouping (Fig. 4 O15)
    join: str                            # 'index' (gather) | 'sort_merge'
    cache_graph: bool                    # loop-invariant caching
    semi_naive: bool = False             # delta-frontier evaluation enabled
    density_threshold: float = 0.0       # frontier density below which the
                                         # sparse (delta) path wins
    # Planner-derived floor of the per-shard compaction capacity: tiny
    # frontiers share one compiled sparse-superstep variant instead of
    # recompiling down the whole power-of-two ladder.
    sparse_cap_floor: int = 64
    notes: Tuple[str, ...] = ()
    est_superstep_seconds: float = 0.0

    def sparse_cap_for(self, count: int) -> int:
        """Per-shard compaction capacity for a measured shard-local
        active-edge count (on sharded meshes: the *maximum* over shards, so
        every shard's frontier fits the same static slab and the mesh stays
        in SPMD lockstep).  Next power of two, bounded below by
        ``sparse_cap_floor``.  The single source of the cap ladder —
        benchmarks reuse it so they time exactly what the adaptive driver
        runs."""

        return max(self.sparse_cap_floor, 1 << max(count - 1, 0).bit_length())

    def mode_for_density(self, density: float) -> str:
        """The Fig.-9 connector choice recomputed online: given the measured
        frontier density of the upcoming superstep, execute the dense plan or
        the frontier-compacted sparse plan.  Called by the adaptive fixpoint
        driver every superstep."""

        # threshold 0.0 is the "sparse never wins" sentinel from
        # plan_pregel's ladder — it must not match density 0.0 (the final
        # superstep of a converged run) and trigger a pointless sparse
        # compile.
        if (
            self.semi_naive
            and self.density_threshold > 0.0
            and density <= self.density_threshold
        ):
            return "sparse"
        return "dense"

    def explain(self) -> str:
        lines = [
            f"Pregel physical plan on mesh {self.mesh}",
            f"  vertices sharded over {self.vertex_axes}",
            f"  connector: {self.connector}; sender-side combine: {self.sender_combine}",
            f"  vertex join: {self.join}; graph cached: {self.cache_graph}",
            f"  semi-naive: {self.semi_naive}"
            + (f" (sparse below density {self.density_threshold:.3f})"
               if self.semi_naive else ""),
            f"  estimated superstep: {self.est_superstep_seconds * 1e3:.3f} ms",
            "  applied rules: " + ", ".join(self.notes),
        ]
        return "\n".join(lines)


def pregel_superstep_costs(
    stats: PregelStats,
    mesh: MeshSpec,
    hw: HardwareSpec,
    density: float,
) -> Tuple[float, float]:
    """Roofline (dense_seconds, sparse_seconds) for one superstep at the
    given frontier density — the planner's frontier-density cost terms.

    * Dense: every edge is gathered, evaluated, and combined regardless of
      how small the frontier is; the exchange moves the full message volume.
    * Sparse (delta): one O(E) streaming pass compacts the active-edge
      frontier (cumsum + scatter, memory-bound, touches only ids + mask),
      then gather/UDF/combine/exchange all scale with density·E.

    Weighted graphs (``stats.edge_attr_bytes > 0``) add the per-edge
    attribute gather to both edge pipelines: the dense path streams E
    attribute rows, the sparse path only density·E of them — widening the
    payload moves the crossover in favor of compaction.

    This model is only ever used for *relative* dense-vs-sparse decisions
    (the threshold ladder and the expected-density ratio in
    :func:`plan_pregel`); absolute superstep estimates come from
    :func:`plan_pregel`'s connector-specific terms, which model the chosen
    exchange rather than a generic one.
    """

    chips = mesh.n_devices
    dp = mesh.data_parallel_size
    e, n = stats.n_edges, stats.n_vertices
    active_e = max(density, 0.0) * e

    def edge_pipeline(n_e: float) -> float:
        compute = n_e * stats.flops_per_edge / (chips * hw.peak_flops_bf16)
        memory = (
            n_e * (8 + 2 * stats.msg_bytes + stats.edge_attr_bytes)
            + n * stats.vertex_bytes
        ) / (chips * hw.hbm_bw)
        return max(compute, memory)

    comm_dense = ring_reduce_scatter(
        n * stats.msg_bytes / max(dp, 1), dp, hw.ici_bw, hw.ici_latency
    ).seconds
    if dp > 1:
        # Frontier-sized interconnect terms for the sharded sparse path:
        # each shard exchanges dp x cap bucket slots of (payload + fused
        # got-flag + destination id) bytes, where cap covers the maximally
        # loaded shard's frontier (balanced estimate: active_e / dp), plus
        # one tiny per-shard-count all-gather for the collective
        # dense<->sparse mode agreement.
        cap = active_e / dp
        slab_bytes = dp * cap * (stats.msg_bytes + 8)
        comm_sparse = (
            all_to_all(slab_bytes, dp, hw.ici_bw, hw.ici_latency).seconds
            + hw.ici_latency * (dp - 1)
        )
    else:
        comm_sparse = 0.0

    dense = edge_pipeline(float(e)) + (comm_dense if dp > 1 else 0.0)
    # Compaction pass: stream the edge mask + write the index slab.
    compact = e * 5 / (chips * hw.hbm_bw)
    sparse = compact + edge_pipeline(active_e) + comm_sparse
    return dense, sparse


def plan_pregel(
    stats: PregelStats,
    mesh: MeshSpec,
    hw: HardwareSpec = TPU_V5E,
    *,
    force_connector: Optional[str] = None,
    semi_naive: bool = False,
    extra_notes: Tuple[str, ...] = (),
) -> PregelPhysicalPlan:
    notes: List[str] = list(extra_notes)

    # Rule: storage selection — dense id-indexed sharded state array: the
    # logical max-over-temporal (L4/L5) becomes a direct frontier read and
    # vertex updates are in-place (paper Fig. 4 O5/O10 B-tree).
    notes.append("storage-selection(dense-indexed-state)")
    # Rule: join algorithm — ordered/index probe == gather on vertex ids.
    join = "index"
    notes.append("join-algorithm(index-gather)")
    # Rule: loop-invariant caching — graph topology pinned across supersteps.
    notes.append("loop-invariant-caching(graph)")
    # Rule: early grouping — combine is commutative+associative, pre-reduce
    # on the sender shard before exchanging (Fig. 4 O15).
    sender_combine = True
    notes.append("early-grouping(sender-combine)")

    dp = mesh.data_parallel_size
    chips = mesh.n_devices

    # Aggregate resolution: every combine string names a registered monoid
    # whose payload width already widened ``msg_bytes`` (compile_pregel) and
    # whose execution strategy shapes the dense-exchange cost below.
    from repro_torch.core.monoid import get_monoid  # deferred: planner stays light

    monoid = get_monoid(stats.combine)

    # Connector choice, cost-based (Fig. 9).  The dense plan moves
    # N*msg_bytes/device once (psum-scatter); the sparse plans move only
    # boundary messages but pay alpha*(n-1) and sort/merge compute.
    dense_bytes_per_dev = stats.n_vertices * stats.msg_bytes / max(dp, 1)
    edge_msgs_per_dev = stats.n_edges * stats.msg_bytes / max(dp, 1)
    # After sender-side combining, at most one message per (shard, dst):
    combined_per_dev = min(edge_msgs_per_dev,
                           stats.n_vertices * stats.msg_bytes / max(dp, 1) * 1.0)

    if monoid.kernel_op is None:
        # Generic monoids cannot ride psum-scatter: each shard all-gathers
        # every partial dense vector and re-combines locally.  The gathered
        # total is dp full length-N vectors (ring_all_gather's nbytes is
        # the total volume) — dp^2 x the reduce-scatter's per-shard bytes,
        # which pushes wide-payload generic aggregates toward the sparse
        # connectors.
        dense_cost = ring_all_gather(
            stats.n_vertices * stats.msg_bytes * max(dp, 1), dp,
            hw.ici_bw, hw.ici_latency,
        )
    else:
        dense_cost = ring_reduce_scatter(
            dense_bytes_per_dev, dp, hw.ici_bw, hw.ici_latency
        )
    sparse_cost = all_to_all(combined_per_dev, dp, hw.ici_bw, hw.ici_latency)
    # Merging connector stall penalty grows with the fan-in (paper §5.2.3):
    merge_stall = hw.ici_latency * dp * 8.0
    merging_cost = sparse_cost.seconds + merge_stall
    hash_sort_cost = sparse_cost.seconds + (
        # receiver-side sort of its combined messages
        2.0 * (combined_per_dev / max(stats.msg_bytes, 1))
        * max(math.log2(max(combined_per_dev / max(stats.msg_bytes, 1), 2)), 1)
        / hw.peak_flops_bf16 * 1e3
    )

    if force_connector is not None:
        connector = force_connector
    else:
        options = {
            "dense_psum": dense_cost.seconds,
            "merging": merging_cost,
            "hash_sort": hash_sort_cost,
        }
        connector = min(options, key=options.get)
    notes.append(f"connector({connector})")

    # Rule: aggregate-monoid resolution — anything beyond the closed
    # sum/max/min enum records its payload-width cost term and execution
    # strategy (the generic XLA monoid path, or a fast path it rides like
    # mean's sum kernel), mirroring the edge-payload note below.
    if stats.combine not in ("sum", "max", "min"):
        strategy = (
            f"{monoid.kernel_op}-fast-path" if monoid.kernel_op
            else "xla-generic"
        )
        notes.append(
            f"combine-monoid({stats.combine}, {stats.msg_bytes}B/msg, "
            f"{strategy})"
        )

    # Rule: weighted-payload cost terms — per-edge attributes (edge weights,
    # labels, feature rows) are gathered for every evaluated edge, widening
    # the edge-pipeline memory traffic on both the dense and the compacted
    # sparse paths (see :func:`pregel_superstep_costs`).
    if stats.edge_attr_bytes:
        notes.append(f"edge-payload({stats.edge_attr_bytes}B/edge)")

    compute = stats.n_edges * stats.flops_per_edge / (chips * hw.peak_flops_bf16)
    memory = (
        stats.n_edges * (8 + stats.edge_attr_bytes)
        + stats.n_vertices * stats.vertex_bytes
    ) / (chips * hw.hbm_bw)
    comm = {
        "dense_psum": dense_cost.seconds,
        "merging": merging_cost,
        "hash_sort": hash_sort_cost,
    }[connector]
    est = max(compute, memory) + comm

    # Rule: semi-naive (delta-frontier) evaluation — find the frontier
    # density below which the frontier-compacted sparse superstep beats the
    # dense one (the Fig. 9 connector choice parameterized by density).  The
    # adaptive driver compares the measured per-superstep density against
    # this threshold online.
    # Per-shard compaction-capacity floor: a power of two no larger than a
    # quarter of the shard-local edge slab (so the sparse path can actually
    # engage on small graphs), capped at 64 so tiny frontiers share one
    # compiled variant on production-sized graphs.
    local_e = max(1, stats.n_edges // max(dp, 1))
    cap_floor = min(64, 1 << max((local_e // 4).bit_length() - 1, 0))

    density_threshold = 0.0
    if semi_naive:
        if dp > 1:
            notes.append(
                f"sharded-delta(per-shard compaction, bucket-a2a x{dp}, "
                f"collective mode-agreement)"
            )
        rho = 1.0
        while rho > 1.0 / (4 * max(stats.n_edges, 1)):
            d_cost, s_cost = pregel_superstep_costs(stats, mesh, hw, rho)
            if s_cost < d_cost:
                break
            rho /= 2.0
        else:
            rho = 0.0
        density_threshold = rho
        notes.append(
            f"semi-naive(adaptive dense<->sparse @ density "
            f"{density_threshold:.3g})"
        )
        # The caller's expected steady-state frontier density refines the
        # superstep estimate: a workload expected to live below the
        # threshold is costed on the sparse path.  The estimate keeps the
        # selected connector's comm terms — the roofline model only supplies
        # the sparse:dense ratio at the expected density, so estimates stay
        # comparable across (possibly forced) connectors.
        exp_rho = stats.frontier_density
        if exp_rho < 1.0 and exp_rho <= density_threshold:
            d_cost, s_cost = pregel_superstep_costs(stats, mesh, hw, exp_rho)
            est *= s_cost / d_cost
            notes.append(f"expected-density({exp_rho:.3g})")

    return PregelPhysicalPlan(
        mesh=mesh,
        vertex_axes=tuple(n for n in ("pod", "data") if mesh.size(n) > 1),
        connector=connector,
        sender_combine=sender_combine,
        join=join,
        cache_graph=True,
        semi_naive=semi_naive,
        density_threshold=density_threshold,
        sparse_cap_floor=cap_floor,
        notes=tuple(notes),
        est_superstep_seconds=est,
    )


# ---------------------------------------------------------------------------
# Serving admission: batch-vs-sequential for parameterized query fixpoints
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingDecision:
    """The planner's batch-vs-sequential call for one serving request.

    ``serving_admission`` costs a k-query batch with the same roofline
    vocabulary as :func:`pregel_superstep_costs`: a vmapped fixpoint runs
    every query's iteration back-to-back on device state k times as large,
    so the batched estimate scales the per-iteration cost by ``batch`` but
    pays the host dispatch overhead (driver loop, convergence readback,
    result unpacking) once instead of ``batch`` times.  Sequential wins
    only when the batch is degenerate (k == 1), the program is ineligible
    (row-table storage, structured monoids that reject vmap), or the
    stacked state would blow the HBM budget.
    """

    batch: int
    batched: bool
    est_batched_seconds: float
    est_sequential_seconds: float
    reason: str

    def note(self) -> str:
        """The ``serving(...)`` plan note recorded on serve results."""

        mode = "batched" if self.batched else "sequential"
        return (
            f"serving(batch={self.batch}: {mode}, "
            f"est {self.est_batched_seconds * 1e3:.3g}ms vs "
            f"{self.est_sequential_seconds * 1e3:.3g}ms seq; {self.reason})"
        )


def serving_admission(
    plan: ProgramPlan,
    batch: int,
    state_bytes: int,
    hw: HardwareSpec = TPU_V5E,
    *,
    eligible: bool = True,
    ineligible_reason: str = "",
    dispatch_overhead_s: float = 2e-3,
    expected_iters: int = 16,
    memory_fraction: float = 0.5,
) -> ServingDecision:
    """Decide batched-vmap vs sequential dispatch for ``batch`` queries.

    ``state_bytes`` is the per-query fixpoint state footprint (carried
    predicate grids); the memory guard refuses to stack a batch whose
    combined state exceeds ``memory_fraction`` of device HBM, since the
    vmapped while_loop keeps every query's state live simultaneously.
    ``dispatch_overhead_s`` is the per-request host-side constant the
    batch amortizes (jit dispatch, convergence readback, unpacking) and
    ``expected_iters`` the assumed fixpoint depth — both are knobs, not
    measurements, and only the *relative* decision consumes them.
    """

    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    iter_s = max(plan.est_iteration_seconds, state_bytes / hw.hbm_bw)
    seq = batch * (dispatch_overhead_s + expected_iters * iter_s)
    batched = dispatch_overhead_s + expected_iters * batch * iter_s
    if batch == 1:
        return ServingDecision(
            batch=1, batched=False,
            est_batched_seconds=batched, est_sequential_seconds=seq,
            reason="single query",
        )
    if not eligible:
        return ServingDecision(
            batch=batch, batched=False,
            est_batched_seconds=batched, est_sequential_seconds=seq,
            reason=ineligible_reason or "program ineligible for vmap",
        )
    hbm_budget = memory_fraction * hw.hbm_bytes
    if batch * state_bytes > hbm_budget:
        return ServingDecision(
            batch=batch, batched=False,
            est_batched_seconds=batched, est_sequential_seconds=seq,
            reason=(
                f"memory guard: {batch}x{state_bytes}B state > "
                f"{memory_fraction:.0%} of {hw.hbm_bytes}B HBM"
            ),
        )
    return ServingDecision(
        batch=batch, batched=True,
        est_batched_seconds=batched, est_sequential_seconds=seq,
        reason=(
            f"amortizes {batch - 1} dispatches "
            f"({dispatch_overhead_s * 1e3:.3g}ms each)"
        ),
    )
