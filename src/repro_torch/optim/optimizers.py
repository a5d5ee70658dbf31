"""Optimizers: the IMRU ``update`` UDF family for LM training (the JAX
package's ``optim/optimizers.py``).

Each optimizer is a pair of functions over the port's trees
(``core/tree.py``): ``init(params) -> state`` and ``update(grads, state,
params, step) -> (params, state)``, with the JAX package's signatures.
``update`` writes the new values into ``params`` and ``state`` in place
and returns them, leaf by leaf and in slices of at most ``_SLICE``
elements, so its temporaries stay small: the counterpart of the JAX
package donating the state to the jitted step.  Every rule is
elementwise, so the slices give the same values as the whole.
``clip_by_global_norm`` likewise scales the gradients in place.  ``step``
is an int32 scalar tensor; learning rates and bias corrections are
computed from it in f32.

The int8 error-feedback gradient codec is ``optim/compression.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "AdamState", "sgd", "adamw", "clip_by_global_norm",
           "warmup_cosine"]

_SLICE = 1 << 26   # elements per slice of an in-place update

LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # update(grads, state, params, step) -> (params, state), in place
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]


class AdamState(NamedTuple):
    m: Any
    v: Any


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _lr_fn(lr: LR) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda step: _f32(lr, step.device)


def _slices(*tensors):
    """Aligned flat slices of equally shaped tensors, at most ``_SLICE``
    elements each."""

    n = tensors[0].numel()
    flat = [t.view(-1) for t in tensors]
    for lo in range(0, n, _SLICE):
        yield [f[lo:lo + _SLICE] for f in flat]


def _elementwise(rule):
    """An in-place update from an elementwise ``rule(g, p, *moments, **c)
    -> (new_p, *new_moments)`` applied leafwise: ``moments`` is a tuple of
    trees shaped like the params."""

    def update(grads, moments, params, consts):
        m_l = [tree_leaves(t) for t in moments]
        for g, p, *ms in zip(tree_leaves(grads), tree_leaves(params), *m_l):
            for gs, ps, *mss in _slices(g, p, *ms):
                outs = rule(gs, ps, *mss, **consts)
                for dst, src in zip([ps] + mss, outs):
                    dst.copy_(src)

    return update


def global_norm(grads, axes: Optional[Sequence[Tuple[str, ...]]] = None
                ) -> torch.Tensor:
    """The f32 L2 norm over every leaf of ``grads``.

    On a mesh each leaf is this rank's block and ``axes`` lists, leaf by
    leaf in ``tree_leaves`` order, the mesh axes that cut it: the local
    sums of squares of the leaves cut alike are added, and that sum is
    ``psum``'d over exactly those axes (under ``collectives.bind``), so a
    leaf replicated over an axis counts once, not once a rank."""

    leaves = tree_leaves(grads)
    if axes is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                              for g in leaves))
    from repro_torch.parallel import collectives as C

    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, ax in zip(leaves, axes, strict=True):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        groups[ax] = groups[ax] + sq if ax in groups else sq
    return torch.sqrt(sum(C.psum(groups[ax], ax) for ax in sorted(groups)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float,
                        axes: Optional[Sequence[Tuple[str, ...]]] = None):
    """``(grads, global norm)``: every leaf scaled in place by min(1,
    max_norm / norm) in f32 and cast back to its dtype.  ``axes``: as
    :func:`global_norm`'s, for a tree of blocks on a mesh."""

    gn = global_norm(grads, axes)
    scale = _clip_scale(gn, max_norm)
    for g in tree_leaves(grads):
        for (gs,) in _slices(g):
            gs.copy_(gs.to(torch.float32) * scale)
    return grads, gn


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5 *
                         (1.0 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def sgd(lr: LR = 1e-2, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def plain(g, p, *, lr_t):
        return ((p.to(torch.float32) - lr_t * g.to(torch.float32))
                .to(p.dtype),)

    def heavy_ball(g, p, m, *, lr_t):
        new_m = momentum * m + g.to(torch.float32)
        return (p.to(torch.float32) - lr_t * new_m).to(p.dtype), new_m

    upd = _elementwise(plain if momentum == 0.0 else heavy_ball)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def moments(state):
        return () if momentum == 0.0 else (state,)

    def update(grads, state, params, step):
        upd(grads, moments(state), params, {"lr_t": lr_fn(step)})
        return params, state

    return Optimizer(init, update)


def adamw(
    lr: LR = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """AdamW.  ``state_dtype`` is the first moment's dtype (bf16 for
    memory-bound plans); the second moment stays f32, as in the JAX
    package."""

    lr_fn = _lr_fn(lr)

    def rule(g, p, m, v, *, lr_t, c1, c2):
        g32 = g.to(torch.float32)
        new_m = (b1 * m.to(torch.float32) + (1 - b1) * g32).to(m.dtype)
        new_v = b2 * v + (1 - b2) * torch.square(g32)
        mh = new_m.to(torch.float32) / c1
        vh = new_v / c2
        upd = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(
            torch.float32)
        return (p.to(torch.float32) - lr_t * upd).to(p.dtype), new_m, new_v

    upd = _elementwise(rule)

    def init(params):
        return AdamState(
            m=tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                             device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        )

    def consts(step):
        step_f = step.to(torch.float32) + 1.0
        one = torch.ones((), dtype=torch.float32, device=step.device)
        return {"lr_t": lr_fn(step),
                "c1": 1.0 - torch.pow(one * b1, step_f),
                "c2": 1.0 - torch.pow(one * b2, step_f)}

    def update(grads, state, params, step):
        upd(grads, (state.m, state.v), params, consts(step))
        return params, state

    return Optimizer(init, update)
