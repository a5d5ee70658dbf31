"""Train-step builder on one device (the JAX package's ``launch/train.py``
with ``mesh=None``).

``build_train_step`` turns an :class:`~repro_torch.core.lm_planner.LMPlan`
into ``step_fn(state, batch) -> (state, metrics)``:

  batch -> [microbatches: grads accumulated into one accumulator]
    -> mean -> clip by global norm -> optimizer update -> step + 1

``state = {"params": ..., "opt": ..., "step": int32 scalar tensor}``.  The
state's tensors are updated in place under ``torch.no_grad()``, the
counterpart of the JAX package's ``donate_argnums=(0,)``; the full-size
run needs that to fit.  Each microbatch's backward writes every parameter's
gradient into the accumulator as soon as autograd has it (a post-accumulate
hook on per-layer views of the stacked parameters) and frees it, so no
whole set of per-microbatch gradients is held.  As in the JAX package the
accumulator is f32 when there are several microbatches and the parameters'
dtype when there is one.  Placement over a mesh is ROADMAP A10e: a ``mesh``
that is not ``None`` raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.lm_planner import LMPlan
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ATTENTION_IMPLS, dtype_of
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm

__all__ = ["build_train_step", "make_optimizer"]

Device = Optional[Union[str, torch.device]]


def make_optimizer(plan: LMPlan, lr=3e-4) -> Optimizer:
    return adamw(lr=lr, state_dtype=dtype_of(plan.m_dtype))


def _leaf_view(p: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """A leaf that shares ``p``'s storage and adds its gradient into
    ``dst`` (then frees it) as soon as autograd has it."""

    view = p.detach().requires_grad_()

    def into_accumulator(t: torch.Tensor) -> None:
        dst.add_(t.grad)
        t.grad = None

    view.register_post_accumulate_grad_hook(into_accumulator)
    return view


def _grad_views(params: Dict[str, Any], acc: Dict[str, Any]):
    """The parameter tree the model reads for one microbatch: every leaf a
    view of the state's tensor whose gradient lands in ``acc``; the stacked
    layers as a list of per-layer trees."""

    views: Dict[str, Any] = {}
    for key, sub in params.items():
        if key in lm._STACKED_KEYS:
            n = tree_leaves(sub)[0].shape[0]
            views[key] = [tree_map(lambda p, a: _leaf_view(p[i], a[i]),
                                   sub, acc[key]) for i in range(n)]
        else:
            views[key] = tree_map(_leaf_view, sub, acc[key])
    return views


def build_train_step(
    plan: LMPlan,
    mesh=None,
    optimizer: Optional[Optimizer] = None,
    clip_norm: float = 1.0,
    *,
    device: Device = None,
    attention: str = "auto",
):
    """Returns ``(step_fn, None, None)``, as the JAX package's ``mesh=None``
    branch.  ``step_fn(state, batch)`` moves ``batch`` to ``device``, runs
    ``plan.microbatches`` microbatches under ``plan.remat`` and returns
    ``(state, {"loss", "grad_norm"})``.  ``attention="ref"`` runs the
    attention's plain version in place of the flash kernels."""

    if mesh is not None:
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP A10e); "
            "pass mesh=None")
    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention must be one of {ATTENTION_IMPLS}")
    dev = resolve_device(device)
    cfg = plan.cfg
    optimizer = optimizer or make_optimizer(plan)
    n_mb = plan.microbatches

    def grads_of(params, batch) -> Tuple[torch.Tensor, Any]:
        acc_dtype = (lambda p: torch.float32) if n_mb > 1 else \
            (lambda p: p.dtype)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype(p),
                                             device=p.device), params)
        B = batch["tokens"].shape[0]
        mb = B // n_mb
        losses: List[torch.Tensor] = []
        for i in range(n_mb):
            sub = {k: v[i * mb:(i + 1) * mb] if v.ndim >= 1 else v
                   for k, v in batch.items()}
            with torch.enable_grad():
                loss, _ = lm.loss_fn(_grad_views(params, acc), sub, cfg,
                                     remat_policy=plan.remat,
                                     attention=attention)
                loss.backward()
            losses.append(loss.detach())
        if n_mb == 1:
            return losses[0], acc
        inv = 1.0 / n_mb
        with torch.no_grad():
            for g in tree_leaves(acc):
                g.mul_(inv)
        return sum(losses[1:], losses[0]) * inv, acc

    def step_fn(state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, grads = grads_of(state["params"], batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            optimizer.update(grads, state["opt"], state["params"],
                             state["step"])
        del grads
        new_state = {
            "params": state["params"],
            "opt": state["opt"],
            "step": state["step"] + 1,
        }
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step_fn, None, None
