"""Online fixpoint serving: plan cache + EDB cache + vmap query batching.

The port of :mod:`repro.core.serving` on one device.  The executor makes
``compile_program`` run figures; this module makes it serve traffic.
Three mechanisms, each measurable on its own:

* **Plan cache** — compiled :class:`~repro_torch.core.executor.
  GenericExecutable` objects are compile-once/execute-many artifacts.
  :class:`PlanCache` is an LRU keyed by :func:`plan_cache_key` — the
  canonical program shape: parsed-text hash (``Program.to_text``
  round-trips whitespace/comments away) x relation signatures x mesh
  topology x storage/rewrite overrides, the same sha256 hex digest as the
  reference's.  Hit/miss/eviction counters surface on every
  :class:`ServeResult`.

* **EDB cache** — :class:`EDBCache` keeps the shared dense relations on
  the server's device *across* requests: a relation the caller hands over
  on the host is copied once, and repeated queries against the same graph
  skip the host-to-device copy even when they compile fresh plans.

* **Query batching** — k parameterized queries (personalized PageRank from
  k seed vectors, k point-to-point reachability probes) run through ONE
  shared fixpoint under ``torch.func.vmap``
  (``GenericExecutable.run_batched``), behind the planner-costed admission
  policy :func:`repro_torch.core.planner.serving_admission`, whose
  decision is recorded as a ``serving(...)`` note on the result.  Dense
  sum/max/min plans batch; row-table storage fails closed (its overflow
  flags are read on the host) and dispatches one query at a time, each
  compiled with its bindings.

``mesh=`` raises ``NotImplementedError`` naming ROADMAP A10.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.datalog import Program, UDF
from repro_torch.core.executor import (
    ExecutorError,
    FixpointResult,
    GenericExecutable,
    Relation,
    RowRelation,
    compile_program,
)
from repro_torch.core.hardware import HardwareSpec, TPU_V5E
from repro_torch.core.monoid import get_monoid
from repro_torch.core.parser import parse
from repro_torch.core.planner import ServingDecision, serving_admission
from repro_torch.device import resolve_device

__all__ = [
    "PERSONALIZED_PAGERANK_TEXT",
    "POINT_REACHABILITY_TEXT",
    "personalized_pagerank_program",
    "point_reachability_program",
    "plan_cache_key",
    "relation_signature",
    "PlanCache",
    "EDBCache",
    "ServeResult",
    "FixpointServer",
    "top_k",
]


# ---------------------------------------------------------------------------
# Parameterized query programs
# ---------------------------------------------------------------------------

PERSONALIZED_PAGERANK_TEXT = """\
% Personalized PageRank: per-query restart mass at the seed vertices.
%   rank_{t+1}(x) = d * sum_{y->x} rank_t(y)/deg(y) + (1-d) * seed(x)
% seed(X, S) is the per-query parameter; edge/deg are the shared graph.
R1: rank(0, X, R)        :- seed(X, R).
R2: rank(J+1, X, sum<C>) :- rank(J, Y, R), deg(Y, D), edge(Y, X),
        scale(R, D -> C).
R3: rank(J+1, X, B)      :- rank(J, X, _), seed(X, S), restart(S -> B).
"""

POINT_REACHABILITY_TEXT = """\
% Point-to-point reachability: does any dst vertex lie in src's closure?
% src(X) / dst(X) are the per-query parameters; edge is the shared graph.
Q1: reach(0, X)   :- src(X).
Q2: reach(J+1, Y) :- reach(J, X), edge(X, Y).
Q3: reach(J+1, X) :- reach(J, X).
Q4: @frontier reachF(X) :- reach(J, X).
Q5: hit(X)        :- reachF(X), dst(X).
"""


def personalized_pagerank_program(damping: float = 0.85) -> Program:
    """:data:`PERSONALIZED_PAGERANK_TEXT` parsed with the damping factor
    bound into the ``scale``/``restart`` UDFs.  R2 and R3 union under the
    ``sum`` monoid (damped in-rank plus restart mass), the same shape as
    the Fig.-11 PageRank stratum."""

    scale = UDF(
        "scale",
        lambda r, d: (damping * r / torch.clamp(d, min=1.0),),
        n_in=2, n_out=1,
    )
    restart = UDF(
        "restart", lambda s: ((1.0 - damping) * s,), n_in=1, n_out=1
    )
    return parse(
        PERSONALIZED_PAGERANK_TEXT,
        name="personalized-pagerank",
        udfs={"scale": scale, "restart": restart},
        aggregates={"sum": get_monoid("sum").as_aggregate()},
    )


def point_reachability_program() -> Program:
    """:data:`POINT_REACHABILITY_TEXT` parsed — ``hit`` is non-empty iff
    some ``dst`` vertex is reachable from the ``src`` set."""

    return parse(POINT_REACHABILITY_TEXT, name="point-reachability")


# ---------------------------------------------------------------------------
# Plan-cache key: the canonical program shape
# ---------------------------------------------------------------------------


def relation_signature(name: str, rel: Any) -> Tuple[Any, ...]:
    """The plan-relevant shape of one EDB relation: storage kind, domain,
    and column layout.  Cardinality is intentionally *excluded* — the dense
    executor's plan depends on grid shapes, not on which cells are present,
    so two graphs over the same domain share compiled plans (the EDB cache
    keyed by identity tells them apart at execution time)."""

    kind = "row-table" if isinstance(rel, RowRelation) else "dense-grid"
    return (name, kind, rel.n, tuple(rel.key_positions),
            tuple(sorted(rel.values)))


def plan_cache_key(
    program: Union[Program, str],
    relations: Mapping[str, Any],
    *,
    param_names: Sequence[str] = (),
    mesh: Any = None,
    epoch: int = 0,
    **overrides: Any,
) -> str:
    """The canonical program-shape key of one compiled plan.

    sha256 over: the *canonical* program text (``Program.to_text()``
    round-trips, so two texts differing only in whitespace/comments hash
    identically), the UDF/aggregate binding names, every EDB relation's
    :func:`relation_signature`, the sorted parameter-relation names, the
    mesh topology (empty on one device), the server epoch (bumped on EDB
    updates — the invalidation mechanism), and any compile overrides
    (``storage=``, ``rewrite=``, ``row_cap=``, ...).  Anything that changes
    the compiled artifact must be in the key; anything that only changes
    *data* must not be (that is the EDB cache's job).  Byte for byte the
    reference's key: the same inputs give the same hex digest."""

    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: ROADMAP A10 (multi-GPU)"
        )
    prog = parse(program) if isinstance(program, str) else program
    h = hashlib.sha256()
    h.update(prog.to_text().encode())
    h.update(repr(tuple(sorted(prog.udfs))).encode())
    h.update(repr(tuple(sorted(prog.aggregates))).encode())
    h.update(repr(tuple(
        relation_signature(name, rel)
        for name, rel in sorted(relations.items())
    )).encode())
    h.update(repr(tuple(sorted(param_names))).encode())
    h.update(repr(()).encode())  # the mesh topology of one device
    h.update(repr(int(epoch)).encode())
    h.update(repr(tuple(sorted(
        (k, repr(v)) for k, v in overrides.items() if v is not None
    ))).encode())
    return h.hexdigest()


class PlanCache:
    """LRU cache of compiled executables keyed by :func:`plan_cache_key`.

    ``get`` counts a hit or a miss and refreshes recency; ``put`` evicts
    least-recently-used entries past ``capacity`` (counting evictions).
    ``key in cache`` is a non-counting peek.
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[str, GenericExecutable]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str) -> Optional[GenericExecutable]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def put(self, key: str, exe: GenericExecutable) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = exe
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def __contains__(self, key: object) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> Tuple[str, ...]:
        """Cached keys, least-recently-used first."""

        return tuple(self._entries)

    def counters(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries)}


# ---------------------------------------------------------------------------
# EDB cache: shared relations kept on the device across requests
# ---------------------------------------------------------------------------


def _on_device(rel: Relation, device: torch.device) -> Relation:
    """``rel`` with its tensors on ``device`` (a tensor already there is
    not copied)."""

    return Relation(
        n=rel.n,
        key_positions=tuple(rel.key_positions),
        present=rel.present.to(device),
        values={p: g.to(device) for p, g in rel.values.items()},
    )


class EDBCache:
    """Shared EDB relations kept on the device *across* requests.

    Within a run the EDB tensors stay on the device across fixpoint
    iterations (loop-invariant caching); this cache extends their lifetime
    across *requests*: the first placement of relation ``name`` copies a
    relation the caller gave on the host to the device once, later
    requests reuse the placed :class:`Relation` (a tensor already on the
    device is not copied).  Entries are guarded by the source object's
    identity — rebinding a name to a new relation replaces the cached
    copy.
    """

    def __init__(self):
        self._entries: Dict[Tuple[str, str], Tuple[Any, Relation]] = {}
        self.hits = 0
        self.misses = 0

    def place(self, name: str, rel: Relation,
              device: Union[str, torch.device]) -> Relation:
        """The twin of ``rel`` on ``device`` (dense relations only;
        :class:`RowRelation` EDB is packed by ``compile_program`` and
        passes through untouched)."""

        if isinstance(rel, RowRelation):
            return rel
        device = torch.device(device)
        key = (name, str(device))
        entry = self._entries.get(key)
        if entry is not None and entry[0] is rel:
            self.hits += 1
            return entry[1]
        self.misses += 1
        placed = _on_device(rel, device)
        self._entries[key] = (rel, placed)
        return placed

    def invalidate(self, name: Optional[str] = None) -> None:
        """Drop the cached copies of ``name`` (all names when ``None``)."""

        if name is None:
            self._entries.clear()
            return
        for key in [k for k in self._entries if k[0] == name]:
            del self._entries[key]

    def counters(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._entries)}


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeResult:
    """One served request: per-query answers plus the serving telemetry.

    ``answers`` has one ``{pred: Relation}`` dict per query in the
    request's batch.  ``notes`` is the compiled plan's notes with the
    admission policy's ``serving(...)`` decision appended (the compiled
    plan itself is shared across requests, so per-request decisions never
    mutate it).  ``cache`` merges the plan-cache and EDB-cache counters at
    response time."""

    answers: Tuple[Dict[str, Relation], ...]
    batched: bool
    decision: ServingDecision
    notes: Tuple[str, ...]
    plan_key: str
    cache_hit: bool
    cache: Dict[str, int]
    compile_seconds: float
    execute_seconds: float
    iterations: int
    converged: bool

    @property
    def batch(self) -> int:
        return len(self.answers)


def _state_bytes(exe: GenericExecutable) -> int:
    """Per-query fixpoint state footprint: every carried predicate's dense
    grid — presence + delta masks (1 byte each) plus float32 value grids.
    The admission policy's memory guard multiplies this by the batch."""

    total = 0
    for phase in exe.phases:
        for pred in phase.carried:
            keys, vals = exe.sigs[pred]
            cells = exe.domain ** len(keys)
            total += cells * (2 + 4 * len(vals))
    return total


class FixpointServer:
    """Serve parameterized Datalog queries against a shared EDB, on
    ``device`` (default: the card; with none present this raises).

    Construction binds the shared relations (the graph); each
    :meth:`query` call takes a program plus per-query parameter bindings,
    resolves a compiled plan through the :class:`PlanCache`, routes the
    batch through ``run_batched`` or a sequential loop per the
    :func:`~repro_torch.core.planner.serving_admission` decision, and
    returns a :class:`ServeResult`.  ``update_relation`` swaps a shared
    relation and bumps the server epoch — every cached plan misses
    afterwards (plan invalidation) and the EDB copy is made again lazily.

    ``hw`` is the hardware the planner and the admission policy cost
    against (``TPU_V5E`` by default, as ``compile_program``'s; pass
    ``H100_SXM`` on the card).  ``compile_overrides`` forwards
    ``storage=`` / ``rewrite=`` / ``row_cap=`` / ``semi_naive=`` to
    ``compile_program`` and participates in the cache key.
    """

    def __init__(
        self,
        relations: Mapping[str, Any],
        *,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Any = None,
        domain: Optional[int] = None,
        plan_cache_capacity: int = 8,
        hw: HardwareSpec = TPU_V5E,
        dispatch_overhead_s: float = 2e-3,
        expected_iters: int = 16,
        memory_fraction: float = 0.5,
        **compile_overrides: Any,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "FixpointServer(mesh=) is not ported yet: ROADMAP A10 "
                "(multi-GPU)"
            )
        self.device = resolve_device(device)
        self.relations: Dict[str, Any] = dict(relations)
        if domain is None:
            domains = {rel.n for rel in self.relations.values()}
            if len(domains) != 1:
                raise ExecutorError(
                    "pass domain= (EDB relations disagree on the domain)"
                )
            domain = domains.pop()
        self.domain = domain
        self.hw = hw
        self.plan_cache = PlanCache(plan_cache_capacity)
        self.edb_cache = EDBCache()
        self.compile_overrides = dict(compile_overrides)
        self.admission_knobs = {
            "dispatch_overhead_s": dispatch_overhead_s,
            "expected_iters": expected_iters,
            "memory_fraction": memory_fraction,
        }
        self.epoch = 0

    # -- EDB lifecycle ------------------------------------------------------

    def update_relation(self, name: str, rel: Any) -> None:
        """Swap shared relation ``name`` and bump the serving epoch: the
        epoch is part of every plan key, so all cached plans (which closed
        over the old device tensors) miss from now on, and the EDB cache
        drops the stale copy."""

        self.relations[name] = rel
        self.edb_cache.invalidate(name)
        self.epoch += 1

    # -- request path -------------------------------------------------------

    def plan_key(
        self,
        program: Union[Program, str],
        param_names: Sequence[str] = (),
    ) -> str:
        """The cache key :meth:`query` would use for this program shape."""

        prog = parse(program) if isinstance(program, str) else program
        return plan_cache_key(
            prog, self.relations,
            param_names=tuple(sorted(param_names)),
            epoch=self.epoch,
            **self.compile_overrides,
        )

    def _compile(
        self, program: Program, first_params: Mapping[str, Relation]
    ) -> GenericExecutable:
        bindings: Dict[str, Any] = {}
        for name in program.edb:
            if name in first_params:
                # Placeholder binding: parameter relations are rebound per
                # query at execution time; the compiled plan only consumes
                # their signature.  (A row-table plan compiles each query
                # with its own bindings.)
                rel = first_params[name]
                bindings[name] = rel if isinstance(rel, RowRelation) \
                    else _on_device(rel, self.device)
            elif name in self.relations:
                bindings[name] = self.edb_cache.place(
                    name, self.relations[name], self.device
                )
            else:
                raise ExecutorError(
                    f"EDB relation {name!r} is neither a shared server "
                    "relation nor a query parameter"
                )
        return compile_program(
            program, bindings, domain=self.domain, hw=self.hw,
            device=self.device, **self.compile_overrides,
        )

    def query(
        self,
        program: Union[Program, str],
        params: Union[None, Mapping[str, Relation],
                      Sequence[Mapping[str, Relation]]] = None,
        *,
        max_iters: int = 32,
        on_device: bool = False,
        force: Optional[str] = None,
    ) -> ServeResult:
        """Serve one request: a program plus 0, 1, or k parameter bindings.

        ``params`` may be ``None`` (unparameterized), one ``{name:
        Relation}`` mapping, or a sequence of k mappings — a batch.  The
        admission policy decides batched-vmap vs sequential dispatch;
        ``force="batched"``/``"sequential"`` overrides it (benchmarks and
        differential tests use this to pin the path).  Nothing else picks
        the route: a batched run that fails raises."""

        prog = parse(program) if isinstance(program, str) else program
        if params is None:
            param_list: List[Dict[str, Relation]] = [{}]
        elif isinstance(params, Mapping):
            param_list = [dict(params)]
        else:
            param_list = [dict(ps) for ps in params]
            if not param_list:
                raise ExecutorError("params batch must be non-empty")
        names = set(param_list[0])
        if any(set(ps) != names for ps in param_list[1:]):
            raise ExecutorError(
                "every param set in a batch must bind the same relations"
            )
        k = len(param_list)

        key = self.plan_key(prog, names)
        exe = self.plan_cache.get(key)
        cache_hit = exe is not None
        compile_seconds = 0.0
        if exe is None:
            t0 = time.perf_counter()
            exe = self._compile(prog, param_list[0])
            compile_seconds = time.perf_counter() - t0
            self.plan_cache.put(key, exe)

        eligible, why = True, ""
        if exe._any_row or exe.row_edb:
            eligible, why = False, (
                "row-table storage (overflow flags cannot cross vmap)"
            )
        elif not names:
            eligible, why = False, "no parameter bindings to batch over"
        decision = serving_admission(
            exe.plan, k, _state_bytes(exe), self.hw,
            eligible=eligible, ineligible_reason=why,
            **self.admission_knobs,
        )
        batched = decision.batched
        if force == "batched":
            if not eligible:
                raise ExecutorError(f"cannot force batched dispatch: {why}")
            batched = k > 1
        elif force == "sequential":
            batched = False
        elif force is not None:
            raise ExecutorError(
                f"force must be 'batched' or 'sequential', got {force!r}"
            )

        t0 = time.perf_counter()
        if batched:
            results: List[FixpointResult] = exe.run_batched(
                param_list, max_iters, on_device=on_device
            )
        elif names and (exe._any_row or exe.row_edb):
            # Row-table storage cannot swap parameter grids at dispatch
            # time (``run(params=)`` fails closed on row-stored
            # parameters), so each query compiles with its bindings baked
            # in — correct, just without the compile-once win.
            results = [
                self._compile(prog, ps).run(max_iters, on_device)
                for ps in param_list
            ]
        else:
            results = [
                exe.run(max_iters, on_device, params=ps or None)
                for ps in param_list
            ]
        execute_seconds = time.perf_counter() - t0

        cache = {f"plan_{k_}": v
                 for k_, v in self.plan_cache.counters().items()}
        cache.update({f"edb_{k_}": v
                      for k_, v in self.edb_cache.counters().items()})
        return ServeResult(
            answers=tuple(r.state for r in results),
            batched=batched,
            decision=decision,
            notes=tuple(exe.plan.notes) + (decision.note(),),
            plan_key=key,
            cache_hit=cache_hit,
            cache=cache,
            compile_seconds=compile_seconds,
            execute_seconds=execute_seconds,
            iterations=max(r.iterations for r in results),
            converged=all(r.converged for r in results),
        )


# ---------------------------------------------------------------------------
# Answer extraction: top-k via the topk monoid
# ---------------------------------------------------------------------------


def top_k(rel: Relation, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The k highest-scoring vertices of a unary-key scored relation
    (e.g. a converged personalized-PageRank ``rank``), as ``(ids,
    scores)`` descending, on the host.

    The scores reduce through the registered ``topk``
    :class:`~repro_torch.core.monoid.CombineMonoid` (a k-truncated
    aggregate): each present vertex contributes a width-k row ``[score,
    -inf, ...]`` and a binary combine tree merges them with the monoid's
    sort-merge-truncate — the serving-side answer extraction the dense
    GroupBy lowering cannot host (structured monoids are rejected there,
    fail closed)."""

    if len(rel.key_positions) != 1 or len(rel.values) != 1:
        raise ExecutorError(
            "top_k needs a unary-key, single-value relation "
            f"(got keys={rel.key_positions}, values={sorted(rel.values)})"
        )
    monoid = get_monoid("topk")
    present = rel.present
    (vpos,) = rel.values
    scores = torch.where(
        present, rel.values[vpos], float("-inf")
    ).to(torch.float32)
    k = min(int(k), int(scores.shape[0]))
    slab = torch.full((scores.shape[0], k), float("-inf"),
                      dtype=torch.float32, device=scores.device)
    slab[:, 0] = scores
    slab = monoid.canonicalize(slab)
    identity = torch.full((1, k), float("-inf"), dtype=torch.float32,
                          device=scores.device)
    while slab.shape[0] > 1:
        if slab.shape[0] % 2:
            slab = torch.cat([slab, identity], dim=0)
        slab = monoid.combine(slab[0::2], slab[1::2])
    top_scores = slab[0].cpu().numpy()
    order = np.argsort(-scores.cpu().numpy(), kind="stable")[:k]
    return order, top_scores
