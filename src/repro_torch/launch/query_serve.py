"""Request loop for online fixpoint serving (the executor's serve path).

The port of :mod:`repro.launch.query_serve` on one device.
``launch/serve.py`` serves the LM: prefill (one expensive pass that builds
the reusable state) then decode (cheap steps amortizing it).  This module
is the same shape for Datalog fixpoints: the *cold compile* of a query
plan is the prefill — paid once per canonical program shape — and every
later dispatch against the cached
:class:`~repro_torch.core.serving.PlanCache` entry is a decode-step
analogue: the compiled plan driven with per-request parameter grids.
Batching slots in the same way decode batches sequences: k parameterized
queries vmap through one shared fixpoint when the planner's admission
policy (``serving(...)`` note) says the batch amortizes dispatch overhead.

:func:`serve_request_loop` is the loop: it coalesces consecutive
requests that share a plan key into batches (up to ``max_batch``) and
answers them in arrival order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from repro_torch.core.datalog import Program
from repro_torch.core.serving import FixpointServer, ServeResult

__all__ = ["QueryRequest", "QueryResponse", "build_query_server",
           "serve_request_loop"]


@dataclass
class QueryRequest:
    """One query in flight: a program plus its parameter bindings.

    ``program`` must be a parsed :class:`Program` (text with UDFs cannot
    be parsed without its bindings; parse at the edge).  ``params`` binds
    the per-query parameter relations, ``{}``/``None`` for
    unparameterized programs.
    """

    program: Program
    params: Optional[Mapping[str, Any]] = None
    max_iters: int = 32
    tag: str = ""


@dataclass
class QueryResponse:
    """The answer to one :class:`QueryRequest`: this query's relations plus
    the :class:`~repro_torch.core.serving.ServeResult` of the (possibly
    batched) dispatch that carried it."""

    request: QueryRequest
    answers: Dict[str, Any]
    result: ServeResult = field(repr=False)

    @property
    def batched(self) -> bool:
        return self.result.batched


def build_query_server(
    relations: Mapping[str, Any], *, mesh: Any = None, device: Any = None,
    **kwargs: Any,
) -> FixpointServer:
    """A :class:`~repro_torch.core.serving.FixpointServer` over the shared
    EDB on ``device`` (default: the card) — the serving analogue of
    ``build_prefill_step``/``build_decode_step`` (kwargs forward:
    ``plan_cache_capacity=``, ``hw=``, admission knobs, compile
    overrides).  A ``mesh`` raises (ROADMAP A10)."""

    return FixpointServer(relations, mesh=mesh, device=device, **kwargs)


def _group_key(server: FixpointServer, req: QueryRequest):
    names = tuple(sorted(req.params or {}))
    return (server.plan_key(req.program, names), names, req.max_iters)


def serve_request_loop(
    server: FixpointServer,
    requests: Iterable[QueryRequest],
    *,
    max_batch: int = 16,
    on_device: bool = False,
    force: Optional[str] = None,
) -> List[QueryResponse]:
    """Answer a request stream, batching runs of same-shaped queries.

    Consecutive requests whose (plan key, parameter names, max_iters)
    match coalesce into one :meth:`FixpointServer.query` dispatch of up to
    ``max_batch`` queries — the admission policy then decides whether the
    coalesced batch actually vmaps.  Responses come back in arrival
    order; a request with no parameters always dispatches alone.
    """

    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    responses: List[QueryResponse] = []
    group: List[QueryRequest] = []
    group_key = None

    def flush():
        nonlocal group, group_key
        if not group:
            return
        head = group[0]
        params: Sequence[Mapping[str, Any]] = [
            dict(req.params or {}) for req in group
        ]
        result = server.query(
            head.program,
            params if any(params) else None,
            max_iters=head.max_iters,
            on_device=on_device,
            force=force,
        )
        for req, answers in zip(group, result.answers):
            responses.append(QueryResponse(
                request=req, answers=dict(answers), result=result
            ))
        group, group_key = [], None

    for req in requests:
        key = _group_key(server, req)
        if group and (key != group_key or len(group) >= max_batch
                      or not req.params):
            flush()
        group.append(req)
        group_key = key
        if not req.params:
            flush()
    flush()
    return responses
