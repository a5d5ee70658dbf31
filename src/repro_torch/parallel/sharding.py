"""Logical-axis sharding rules and their placement over a mesh (the JAX
package's ``parallel/sharding.py``).

Model code names the logical axes of every parameter ("embed", "heads",
"vocab", ...), and a :class:`ShardingRules` instance chosen by the LM
planner maps them to mesh axes:

* ``model`` — Megatron tensor parallelism: heads, ffn, vocab and experts;
* ``fsdp`` — ZeRO-3: a parameter's ``embed`` dim over ``data``;
* ``batch`` — data parallelism over (``pod``, ``data``).

:func:`logical_to_spec` / :func:`spec_for_param` resolve a leaf's logical
axes to a :class:`PartitionSpec`, the reference's rules exactly.  The
JAX package hands the spec to GSPMD; the port has no GSPMD, so a spec
here says which block of the global tensor a rank holds
(:func:`local_block`, :func:`join_blocks`), and the model's layers place
their collectives themselves, reading the ambient :func:`placement`:

* :func:`tp_axes` — the ``model`` axes a tensor-parallel layer reduces
  over (empty outside a placement or on a mesh without ``model``);
* :func:`at_use` — a parameter tree as the layer uses it: under ZeRO-3
  each dim sharded over ``data`` gathered (its gradient reduce-scattered
  back in the backward, :func:`~repro_torch.parallel.collectives.
  gather_dim`);
* :func:`batch_axes` — the axes a loss averages over;
* :func:`cut_axes` — the mesh axes the placement's rules give a logical
  axis of a given length (a decode cache's ``kv_seq``).

Outside a placement every one of these is the identity, as the
reference's ``shard(...)`` is outside its context.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, replace
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch

__all__ = ["ShardingRules", "PartitionSpec", "P", "logical_to_spec",
           "spec_for_param", "spec_axes", "local_shape", "local_block",
           "join_blocks", "placement", "ambient_axis_size", "tp_axes",
           "batch_axes", "cut_axes", "at_use"]


@dataclass(frozen=True)
class ShardingRules:
    """Map logical axis name -> mesh axis (or tuple of axes, or None)."""

    rules: Tuple[Tuple[str, object], ...] = (
        ("batch", ("pod", "data")),
        ("seq", None),
        ("embed", None),
        ("heads", "model"),
        ("kv_heads", None),
        ("qkv", "model"),
        ("ffn", "model"),
        ("vocab", "model"),
        ("experts", "model"),
        ("expert_ffn", None),
        ("kv_seq", "model"),
        ("kv_lora", None),
        ("ssm_heads", None),
        ("ssm_state", None),
        ("conv_dim", None),
        ("fsdp", None),          # resolved by param spec when fsdp=True
        ("stack", None),         # the stacked-layers leading axis
    )
    fsdp: bool = False           # ZeRO-3 parameter sharding over `data`
    fsdp_axis: str = "data"
    expert_parallel: bool = True

    def get(self, name: str):
        for n, v in self.rules:
            if n == name:
                return v
        raise KeyError(f"unknown logical axis {name!r}")

    def with_rule(self, name: str, value) -> "ShardingRules":
        new = tuple(
            (n, value if n == name else v) for n, v in self.rules
        )
        if name not in [n for n, _ in self.rules]:
            new = new + ((name, value),)
        return replace(self, rules=new)


class PartitionSpec:
    """One entry a dim: a mesh axis name, a tuple of them (the dim sharded
    over their product, the first axis major) or ``None`` (replicated);
    JAX's ``PartitionSpec``.  Not a tuple, so that the port's tree
    functions take a spec as one leaf; it compares equal to the tuple of
    its entries."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.parts == other.parts
        if isinstance(other, tuple):
            return self.parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P{self.parts!r}"


P = PartitionSpec


def logical_to_spec(rules: ShardingRules, logical: Sequence[Optional[str]],
                    *, param: bool = False,
                    shape: Optional[Sequence[int]] = None,
                    mesh: Any = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec.

    * a mesh axis is used at most once (first logical axis wins);
    * with ``shape`` + ``mesh`` (anything with a ``shape`` dict of axis
      sizes), axes that do not divide the dimension are dropped
      (replicated);
    * under ``fsdp``, *parameter* ``embed`` dims shard over the data axis
      (ZeRO-3); activation ``embed`` stays replicated.
    """

    used: set = set()
    out = []
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        if name == "fsdp":
            v = rules.fsdp_axis if (rules.fsdp and param) else None
        elif param and rules.fsdp and name == "embed":
            v = rules.fsdp_axis
        elif name == "experts" and not rules.expert_parallel:
            v = None
        else:
            v = rules.get(name)
        if v is None:
            out.append(None)
            continue
        axes = (v,) if isinstance(v, str) else tuple(v)
        axes = tuple(a for a in axes if a not in used)
        if shape is not None and mesh is not None:
            # Greedy divisibility filter over the axis product.
            kept, dim = [], shape[i]
            for a in axes:
                size = mesh.shape.get(a, 1)
                if size > 1 and dim % size == 0:
                    kept.append(a)
                    dim //= size
            axes = tuple(kept)
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return PartitionSpec(*out)


def spec_for_param(rules: ShardingRules, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None,
                   mesh: Any = None) -> PartitionSpec:
    return logical_to_spec(rules, logical, param=True, shape=shape, mesh=mesh)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""

    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entries(spec, ndim: int):
    parts = list(spec)
    return parts + [None] * (ndim - len(parts))


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a global ``shape`` cut by ``spec``."""

    return tuple(
        d // math.prod(mesh.shape[a] for a in spec_axes(e))
        for d, e in zip(shape, _entries(spec, len(shape))))


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (a
    view)."""

    for dim, e in enumerate(_entries(spec, x.dim())):
        axes = spec_axes(e)
        if axes:
            n = x.shape[dim] // math.prod(mesh.shape[a] for a in axes)
            x = x.narrow(dim, mesh.linear_index(axes) * n, n)
    return x


def join_blocks(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` under ``spec``
    (all-gathers over each sharded dim's axes; every rank of the mesh
    calls it, with the same spec)."""

    from repro_torch.parallel import collectives as C

    with C.bind(mesh):
        for dim, e in enumerate(_entries(spec, x.dim())):
            if spec_axes(e):
                x = C.all_gather_dim(x, spec_axes(e), dim)
    return x


# -- the ambient placement ---------------------------------------------------


@dataclass(frozen=True)
class _Placement:
    mesh: Any
    specs: Any       # the param spec tree (stacked leaves with "stack")
    rules: ShardingRules


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_placement", default=None)


@contextlib.contextmanager
def placement(mesh, specs: Any, rules: ShardingRules) -> Iterator[None]:
    """Run the model's layers on ``mesh``, the parameters this rank's
    blocks under the spec tree ``specs`` and the activations laid out by
    the plan's ``rules``: the counterpart of the reference's
    ``activation_sharding_context``.  The collectives run under
    ``collectives.bind(mesh)``, which the caller holds."""

    token = _CTX.set(None if mesh is None else
                     _Placement(mesh, specs, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def ambient_axis_size(name: str) -> int:
    """Size of a mesh axis in the ambient placement (1 outside one)."""

    ctx = _CTX.get()
    if ctx is None:
        return 1
    return int(ctx.mesh.shape.get(name, 1))


def tp_axes() -> Tuple[str, ...]:
    """``("model",)`` where the ambient mesh has a ``model`` axis of more
    than one rank, else ``()``."""

    return ("model",) if ambient_axis_size("model") > 1 else ()


def batch_axes() -> Tuple[str, ...]:
    """The ambient mesh's batch axes of more than one rank."""

    ctx = _CTX.get()
    return () if ctx is None else ctx.mesh.batch_axes


def cut_axes(name: str, dim: int) -> Tuple[str, ...]:
    """The mesh axes the ambient placement's rules cut a dimension of
    ``dim`` entries with the logical axis ``name`` over (the divisibility
    filter applied); ``()`` outside a placement."""

    ctx = _CTX.get()
    if ctx is None:
        return ()
    return spec_axes(logical_to_spec(ctx.rules, (name,), shape=(dim,),
                                     mesh=ctx.mesh)[0])


def _gather_tree(tree, specs, lead: int):
    from repro_torch.parallel import collectives as C

    if isinstance(tree, dict):
        return {k: _gather_tree(v, specs[k], lead) for k, v in tree.items()}
    for dim, e in enumerate(_entries(specs, tree.dim() + lead)[lead:]):
        axes = tuple(a for a in spec_axes(e) if a != "model")
        if axes:
            tree = C.gather_dim(tree, axes, dim)
    return tree


def at_use(tree: Any, *path: str, stacked: bool = False) -> Any:
    """``tree`` (the parameters at ``params[path[0]][path[1]]...``) as the
    layers use it: every dim its spec shards over a batch axis (ZeRO-3's
    ``embed`` over ``data``) gathered, differentiably; the ``model`` dims
    stay cut.  ``stacked``: ``tree`` is one layer of a stacked tree (its
    specs carry the leading "stack" entry)."""

    ctx = _CTX.get()
    if ctx is None:
        return tree
    specs = ctx.specs
    for k in path:
        specs = specs[k]
    return _gather_tree(tree, specs, 1 if stacked else 0)
