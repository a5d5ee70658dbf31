"""Named-axis collectives over a :class:`~repro_torch.launch.mesh.Mesh`.

The port's stand-ins for the ``lax`` collectives the JAX package calls
inside ``shard_map``.  The axes a call may name are the ones bound by
:func:`bind`, as ``shard_map`` binds a mesh's axes: the executor's sharded
steps run under ``bind(mesh)``, and outside it :func:`axes_present` finds
no axis, so the same connector code runs on one device.

* :func:`axis_index`, :func:`axis_size`
* :func:`psum`, :func:`pmax` -> ``all_reduce``
* :func:`psum_scatter` -> ``reduce_scatter`` (untiled: ``x[n, ...]`` in,
  the sum's row of this rank out)
* :func:`all_gather` -> ``all_gather_into_tensor`` (untiled: ``[n, ...]``)
* :func:`all_to_all` -> ``all_to_all_single`` (tiled on dim 0)
* :func:`ppermute` -> ``batch_isend_irecv``, the permutation in axis-local
  indices

An op over several axes runs over the group of those axes taken together,
ranks in row-major order of the axes (which must be in the mesh's order).
Bool payloads travel as uint8.  With staged ``gloo`` on the card every
payload is copied to a pinned host buffer and back here, in
:func:`_on_wire`, the one place that stages; the mesh's ``stats`` count
each op's calls and bytes and the staged bytes.

The LM's layers on a mesh (ROADMAP A10e-1) need collectives that autograd
sees, the JAX package getting them from GSPMD's transpose rules:

* :func:`copy_to` — identity forward, ``psum`` backward: the input of a
  column-parallel layer (Megatron's *f*);
* :func:`reduce_from` — ``psum`` forward, identity backward: the output of
  a row-parallel layer (Megatron's *g*);
* :func:`gather_dim` — ``all_gather`` of a dim forward, ``psum_scatter``
  of it backward: a ZeRO-3 parameter at use.

:func:`all_gather_dim` and :func:`psum_scatter_dim` are the same exchanges
tiled along any dim, outside autograd; :func:`all_to_all_dim` re-cuts a
tensor from one dim to another (a decode cache's K/V from a cut by heads
to a cut by slots, ROADMAP A10e-2).

Under ``torch.func.vmap`` (a batched serving run: k queries through one
fixpoint) :func:`psum`, :func:`pmax`, :func:`psum_scatter`,
:func:`all_gather` and :func:`all_to_all` go through one operator,
``repro_torch::collective``, whose batching rule folds the query axis
into the payload: k queries issue ONE collective a call site, as GSPMD's
batched collectives do in the reference.  c10d's own ops have no batching
rule.  Outside vmap they call the same code directly.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._C._functorch import is_batchedtensor

__all__ = ["bind", "bound_mesh", "axes_present", "axis_index", "axis_size",
           "psum", "pmax", "psum_scatter", "all_gather", "all_to_all",
           "ppermute", "all_gather_dim", "psum_scatter_dim",
           "all_to_all_dim", "copy_to",
           "reduce_from", "gather_dim"]

_BOUND: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_bound_mesh", default=None)

# torch 2.13 renames reduce_scatter_tensor and all_gather_into_tensor (same
# arguments); older releases have only the old names.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@contextlib.contextmanager
def bind(mesh) -> Iterator[None]:
    """Bind ``mesh``'s axes for the collectives called inside."""

    token = _BOUND.set(mesh)
    try:
        yield
    finally:
        _BOUND.reset(token)


def bound_mesh():
    return _BOUND.get()


def _mesh():
    mesh = _BOUND.get()
    if mesh is None:
        raise NameError("no mesh axes are bound: call inside "
                        "collectives.bind(mesh)")
    return mesh


def axes_present(axis_names: Sequence[str]) -> Tuple[str, ...]:
    """The names among ``axis_names`` that the bound mesh has."""

    mesh = _BOUND.get()
    if mesh is None:
        return ()
    return tuple(a for a in axis_names if a in mesh.axis_names)


def axis_size(axis: str) -> int:
    return _mesh().shape[axis]


def axis_index(axes) -> int:
    """This rank's index along ``axes``: one axis name, or several taken
    together (row-major, the first major)."""

    return _mesh().linear_index(_axes(axes))


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _on_wire(mesh, name: str, send: torch.Tensor, recv_shape,
             call: Callable[[torch.Tensor, torch.Tensor], None]
             ) -> torch.Tensor:
    """Run ``call(send, recv)`` on wire tensors and return ``recv`` on
    ``send``'s device: bool as uint8, and with staged gloo both through
    pinned host buffers."""

    dtype = send.dtype
    wire = torch.uint8 if dtype == torch.bool else dtype
    send = send.contiguous().view(wire) if dtype == torch.bool \
        else send.contiguous()
    nbytes = send.numel() * send.element_size()
    mesh.stats.calls[name] += 1
    mesh.stats.sent[name] += nbytes
    if mesh.staged and send.is_cuda:
        host = torch.empty(send.shape, dtype=wire, pin_memory=True)
        host.copy_(send)
        recv = torch.empty(recv_shape, dtype=wire, pin_memory=True)
        call(host, recv)
        out = recv.to(send.device)
        mesh.stats.staged_bytes += nbytes + recv.numel() * recv.element_size()
    else:
        out = torch.empty(recv_shape, dtype=wire, device=send.device)
        call(send, out)
    return out.view(torch.bool) if dtype == torch.bool else out


def _all_reduce(x: torch.Tensor, axes, op, name: str) -> torch.Tensor:
    axes = _axes(axes)
    if not axes:
        return x
    mesh = _mesh()
    # A reduction does not depend on the axes' order.
    group = mesh.group(tuple(sorted(axes, key=mesh.axis_names.index)))

    def call(send, recv):
        recv.copy_(send)
        dist.all_reduce(recv, op=op, group=group)

    return _on_wire(mesh, name, x, x.shape, call)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    if not _axes(axes):
        return x
    return _dispatch("psum", x, axes)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    if not _axes(axes):
        return x
    return _dispatch("pmax", x, axes)


def psum_scatter(x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=0, tiled=False)``:
    ``x[n, ...]`` summed over the group, row ``axis_index`` of the sum."""

    return _dispatch("psum_scatter", x, axes)


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.all_gather(x, axes, tiled=False)``: ``[n, ...]``, row i from
    the group's rank i."""

    return _dispatch("all_gather", x, axes)


def all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.all_to_all(x, axes, 0, 0, tiled=True)``: block i of dim 0 goes
    to the group's rank i; the received blocks, in sender order."""

    return _dispatch("all_to_all", x, axes)


def _psum(x: torch.Tensor, axes) -> torch.Tensor:
    return _all_reduce(x, axes, dist.ReduceOp.SUM, "psum")


def _pmax(x: torch.Tensor, axes) -> torch.Tensor:
    return _all_reduce(x, axes, dist.ReduceOp.MAX, "pmax")


def _psum_scatter(x: torch.Tensor, axes) -> torch.Tensor:
    axes = _axes(axes)
    mesh = _mesh()
    group = mesh.group(axes)
    return _on_wire(mesh, "psum_scatter", x, x.shape[1:],
                    lambda s, r: _reduce_scatter(r.view(-1), s.view(-1),
                                                 group=group))


def _all_gather_impl(x: torch.Tensor, axes) -> torch.Tensor:
    axes = _axes(axes)
    mesh = _mesh()
    group = mesh.group(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    return _on_wire(mesh, "all_gather", x, (n,) + tuple(x.shape),
                    lambda s, r: _all_gather(r.view(-1), s.view(-1),
                                             group=group))


def _all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    axes = _axes(axes)
    mesh = _mesh()
    group = mesh.group(axes)
    return _on_wire(mesh, "all_to_all", x, x.shape,
                    lambda s, r: dist.all_to_all_single(
                        r.view(-1), s.view(-1), group=group))


_IMPLS = {"psum": _psum, "pmax": _pmax, "psum_scatter": _psum_scatter,
          "all_gather": _all_gather_impl, "all_to_all": _all_to_all}


def _dispatch(kind: str, x: torch.Tensor, axes) -> torch.Tensor:
    """A batched payload (under vmap) goes through the operator and its
    batching rule; any other calls the collective directly."""

    if is_batchedtensor(x):
        return _collective(x, kind, ",".join(_axes(axes)))
    return _IMPLS[kind](x, axes)


@torch.library.custom_op("repro_torch::collective", mutates_args=())
def _collective(x: torch.Tensor, kind: str, axes: str) -> torch.Tensor:
    """The named-axis collective ``kind`` of ``x`` over ``axes`` (names
    joined by commas) of the bound mesh, as one operator, so that
    ``torch.func.vmap`` reaches it through :func:`_collective_vmap`."""

    return _IMPLS[kind](x, tuple(axes.split(",")))


def _collective_vmap(info, in_dims, x, kind, axes):
    """Batching rule of :func:`_collective`: k queries, one collective.

    The reductions are elementwise, so the batched payload goes as it is.
    The others act on the payload's leading dimension: the query axis
    moves right behind it (``[k, n, ...] -> [n, k, ...]``), so that each
    rank's block of a tiled exchange, or its gathered row, carries all k
    queries, and the output's query axis is dimension 1 (``all_gather``,
    ``all_to_all``) or 0 (``psum_scatter``)."""

    d = in_dims[0]
    if d is None:
        return _collective(x, kind, axes), None
    if kind in ("psum", "pmax"):
        return _collective(x, kind, axes), d
    x = x.movedim(d, 0)
    if kind == "all_gather":
        return _collective(x, kind, axes), 1
    x = x.movedim(0, 1)
    return _collective(x, kind, axes), 1 if kind == "all_to_all" else 0


torch.library.register_vmap(_collective, _collective_vmap)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` of ``perm`` (axis-local
    indices) ``src`` sends ``x`` to ``dst``; a rank that nobody sends to
    gets zeros."""

    mesh = _mesh()
    group = mesh.group((axis,))
    ranks = dist.get_process_group_ranks(group)
    me = mesh.coordinate(axis)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1 or len(dsts) > 1:
        raise ValueError(f"ppermute needs a permutation, got {perm}")

    def call(send, recv):
        recv.zero_()
        ops = []
        for d in dsts:
            if d == me:
                recv.copy_(send)
            else:
                ops.append(dist.P2POp(dist.isend, send, ranks[d], group))
        for s in srcs:
            if s != me:
                ops.append(dist.P2POp(dist.irecv, recv, ranks[s], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    return _on_wire(mesh, "ppermute", x, x.shape, call)


# ---------------------------------------------------------------------------
# Tiled exchanges along a dim, and the collectives autograd sees
# ---------------------------------------------------------------------------


def all_gather_dim(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """``x`` gathered over ``axes`` along ``dim``, rank i's block i-th
    (``lax.all_gather(..., axis=dim, tiled=True)``)."""

    g = all_gather(x, axes)
    shape = list(x.shape)
    shape[dim] *= g.shape[0]
    return g.movedim(0, dim).reshape(shape)


def psum_scatter_dim(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """``x`` summed over ``axes``, this rank's block of ``dim``
    (``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``)."""

    n = math.prod(axis_size(a) for a in _axes(axes))
    shape = list(x.shape)
    shape[dim:dim + 1] = [n, shape[dim] // n]
    return psum_scatter(x.reshape(shape).movedim(dim, 0).contiguous(), axes)


def all_to_all_dim(x: torch.Tensor, axes, split: int,
                   concat: int) -> torch.Tensor:
    """``x`` cut into ``n`` blocks along ``split``, block i sent to the
    group's rank i, and the blocks received joined along ``concat`` in
    sender order (``lax.all_to_all(x, axes, split, concat, tiled=True)``):
    a tensor cut over ``axes`` along ``concat`` comes back cut along
    ``split``.  One ``all_to_all``."""

    n = math.prod(axis_size(a) for a in _axes(axes))
    shape = list(x.shape)
    blocks = x.reshape(shape[:split] + [n, shape[split] // n]
                       + shape[split + 1:]).movedim(split, 0).contiguous()
    got = all_to_all(blocks, axes).movedim(0, concat)
    shape[split] //= n
    shape[concat] *= n
    return got.reshape(shape)


def _psum_f32(x: torch.Tensor, axes) -> torch.Tensor:
    """``psum`` accumulated in f32 (a bf16 payload is summed at f32 and
    rounded once)."""

    if x.dtype in (torch.float32, torch.float64):
        return psum(x, axes)
    return psum(x.to(torch.float32), axes).to(x.dtype)


# The backward of these runs where autograd runs it (on the card, its
# device thread, outside the caller's ``bind``): each binds the mesh its
# forward saw.


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.mesh = axes, _mesh()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with bind(ctx.mesh):
            return _psum_f32(g, ctx.axes), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return _psum_f32(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, _mesh()
        return all_gather_dim(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        with bind(ctx.mesh):
            return psum_scatter_dim(g, ctx.axes, ctx.dim), None, None


def copy_to(x: torch.Tensor, axes) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axes`` backward."""

    axes = _axes(axes)
    return _CopyTo.apply(x, axes) if axes else x


def reduce_from(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` summed over ``axes`` forward; the gradient as it is
    backward (every rank of ``axes`` holds the same one)."""

    axes = _axes(axes)
    return _ReduceFrom.apply(x, axes) if axes else x


def gather_dim(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """``x`` gathered over ``axes`` along ``dim`` forward; the gradient
    summed over ``axes`` and this rank's block of ``dim`` kept backward."""

    axes = _axes(axes)
    return _GatherDim.apply(x, axes, dim) if axes else x
