"""The LM train step (the JAX package's ``launch/train.py``).

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
dtype when there is one.

On a mesh (``mesh`` a :class:`~repro_torch.launch.mesh.Mesh` of ``pod``,
``data`` and ``model`` axes; ROADMAP A10e-1) every rank runs the step on
its own blocks of the state, the layouts the reference's GSPMD step
gives its arrays, made explicit:

* parameters by :func:`param_specs` (``model`` is Megatron tensor
  parallelism over heads, ffn, vocab and experts; under ``rules.fsdp``
  the ``embed`` dims over ``data``, ZeRO-3, gathered at use);
* the moments and the gradient accumulator by :func:`opt_specs_like`
  (ZeRO-1: :func:`_zero1_spec` adds ``data`` on the first free divisible
  dim);
* the batch by rows: ``batch_fn(global_batch)`` gives this rank, for
  microbatch i, its block over the batch axes of the reference's global
  microbatch i (rows ``[i mb, (i+1) mb)``, which GSPMD shards over
  ``data``): what the MoE's per-data-shard capacity and the masked mean
  see.

A microbatch's loss is the mean over the global microbatch.  After its
backward, the gradients are reduced over the batch axes leaf by leaf in
the tree's order (reduce-scattered into the ZeRO shard where the
accumulator's spec adds ``data``, all-reduced where it adds nothing; a
ZeRO-3 leaf's gather at use has reduce-scattered it already), so every
rank issues the same collectives in the same order whatever autograd's
own order.  The clip takes the global norm over the shards, AdamW runs
elementwise on each rank's shard, and a ZeRO-1 parameter is all-gathered
over ``data`` back to its layout.  Every family runs on a mesh
(:data:`MESH_FAMILIES`; A10e-1, A10h-1, A10h-2).  The SSD mixer's
leaves have no ``model`` in their specs (the reference keeps
``ssm_heads``, ``ssm_state`` and ``conv_dim`` replicated), so their
gradients, whole on every ``model`` rank, are reduced over the batch axes
only, as the norms' are.  kv heads that ``model`` does not divide, where
it divides the q heads, are repeated to the rank's q heads as the
reference's ``_maybe_repeat_kv`` does (A10h-3, case (i):
``blocks._repeat_layout``).  q heads that it does not divide (case (ii))
the planner keeps whole, the attention replicated as the reference's; a
plan that cuts any attention's q heads over such an axis, mid-head,
refuses (A10h-4, :func:`_refuse_unported`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.lm_planner import LMPlan
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ATTENTION_IMPLS, dtype_of
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (P, PartitionSpec, local_shape,
                                           spec_axes, spec_for_param)

__all__ = ["build_train_step", "make_optimizer", "param_specs",
           "opt_specs_like", "MESH_FAMILIES"]

# The families whose train step, prefill and decode run on a mesh: dense
# and moe (A10e-1, A10e-2), mla and encdec (A10h-1), ssm and hybrid
# (A10h-2: the SSD mixer whole on every model rank).
MESH_FAMILIES = ("dense", "moe", "mla", "encdec", "ssm", "hybrid")

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
    """With ``mesh=None`` returns ``(step_fn, None, None)``, as the JAX
    package's ``mesh=None`` branch: ``step_fn(state, batch)`` moves
    ``batch`` to ``device``, runs ``plan.microbatches`` microbatches under
    ``plan.remat`` and returns ``(state, {"loss", "grad_norm"})``.

    On a mesh returns ``(step_fn, state_specs, batch_fn)``, as the
    reference returns ``(jitted, state_sh, bsh)``: ``state_specs`` the
    spec tree of ``{"params", "opt", "step"}`` (cut a global state with
    ``carry.shard_state``), ``batch_fn(global_batch)`` this rank's rows on
    the mesh's device, and ``step_fn(state, rows)`` the step on this
    rank's blocks (every rank calls it).  ``device`` must then be the
    mesh's or ``None``.  ``attention="ref"`` runs the attention's plain
    version in place of the flash kernels."""

    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention must be one of {ATTENTION_IMPLS}")
    if mesh is not None:
        if device is not None and \
                resolve_device(device).type != mesh.device.type:
            raise ValueError(f"the step runs on the mesh's device "
                             f"{mesh.device}, not {device}")
        return _build_mesh_step(plan, mesh, optimizer, clip_norm, attention)
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


# ---------------------------------------------------------------------------
# On a mesh (ROADMAP A10e-1)
# ---------------------------------------------------------------------------


def _spec_tree(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over a nested dict whose leaves are tuples of
    logical axes (``lm.param_axes``), with parallel trees."""

    if isinstance(axes_tree, dict):
        return {k: _spec_tree(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    return fn(axes_tree, *trees)


def param_specs(cfg, mesh, rules) -> Dict[str, Any]:
    """The parameters' spec tree (the reference's ``param_shardings``,
    divisibility-sanitized)."""

    return _spec_tree(
        lambda ax, a: spec_for_param(rules, ax, shape=tuple(a.shape),
                                     mesh=mesh),
        lm.param_axes(cfg), lm.abstract_params(cfg))


def _zero1_spec(spec, shape, mesh, axis: str = "data") -> PartitionSpec:
    """Add optimizer-state sharding over ``axis`` on the first free,
    divisible dimension (ZeRO-1); none on a mesh without ``axis`` (where
    the reference's spec would name an axis the mesh lacks)."""

    if axis not in mesh.shape:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for p in parts:
        used.update(spec_axes(p))
    if axis in used:
        return spec
    n = mesh.shape.get(axis, 1)
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % n == 0 and d >= n:
            parts[i] = axis
            return P(*parts)
    return spec


def opt_specs_like(p_specs, opt_like, mesh, zero: str, fsdp: bool):
    """Each optimizer-state tensor's spec: its parameter's, plus ZeRO-1's
    ``data`` dim (the reference's ``opt_shardings_like``).  ``opt_like``
    is the state's tree (``AdamState``, a momentum tree or ``()``)."""

    def build(moments):
        return _moment_specs(p_specs, moments, mesh, zero, fsdp)

    if isinstance(opt_like, tuple) and not opt_like:
        return ()
    if isinstance(opt_like, tuple):          # AdamState(m, v)
        return type(opt_like)(*[build(t) for t in opt_like])
    return build(opt_like)


def _moment_specs(p_specs, like, mesh, zero: str, fsdp: bool):
    """The specs of a tree laid out as the optimizer state (a moment, the
    gradient accumulator): the parameter's, ZeRO-1's dim added."""

    return tree_map(
        lambda a, spec: _zero1_spec(spec, tuple(a.shape), mesh)
        if zero == "zero1" and not fsdp else spec, like, p_specs)


def _refuse_unported(cfg, mesh, p_specs, doing: str = "training") -> None:
    """The paths not ported to a mesh raise before any collective
    (``doing``: "training" or "serving"): a family outside
    :data:`MESH_FAMILIES`, and any attention's q heads (GQA, MLA's,
    the encoder's, the cross-attention's) cut over a ``model`` axis that
    does not divide them, which would cut them mid-head (ROADMAP A10h-4).
    The planner keeps such heads whole, the attention replicated, as the
    reference's; only a hand-set ``qkv`` rule reaches the refusal.  kv
    heads that ``model`` does not divide are taken where it divides the q
    heads (A10h-3, case (i))."""

    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{doing} the {cfg.family} family ({cfg.name}) on a mesh is not "
            f"ported; the mesh step takes {MESH_FAMILIES}")
    tp = mesh.shape.get("model", 1)
    if not cfg.n_heads % tp:
        return
    mixers = [p_specs["layers"].get(m) for m in ("attn", "xattn")]
    mixers.append(p_specs.get("enc_layers", {}).get("attn"))
    cut = any("model" in spec_axes(e) for attn in mixers if attn
              for k in ("wq", "q_up", "wo") if k in attn for e in attn[k])
    if cut:
        raise NotImplementedError(
            f"{doing} {cfg.name}: {cfg.n_heads} q heads cut over a {tp}-way "
            f"model axis that does not divide them (mid-head) are not "
            f"ported (ROADMAP A10h-4); the planner keeps them whole")


@dataclass(frozen=True)
class _Leaf:
    """How one parameter's gradient reaches its accumulator block:
    reduce-scattered over ``scatter_axes`` along ``scatter_dim`` (ZeRO-1's
    added dim), then ``psum``'d over ``psum_axes``; ``norm_axes`` cut the
    accumulator (the global norm's ``psum``)."""

    acc_shape: Tuple[int, ...]
    scatter_dim: int
    scatter_axes: Tuple[str, ...]
    psum_axes: Tuple[str, ...]
    norm_axes: Tuple[str, ...]


def _leaf_plan(p_spec, a_spec, shape, mesh) -> _Leaf:
    ndim = len(shape)
    pe = list(p_spec) + [None] * (ndim - len(p_spec))
    ae = list(a_spec) + [None] * (ndim - len(a_spec))
    # A batch axis in the parameter's own spec is ZeRO-3's: the gather at
    # use reduce-scattered the gradient over it already.
    done = {a for e in pe for a in spec_axes(e)}
    dim, extra = -1, ()
    for i, (p, a) in enumerate(zip(pe, ae)):
        added = tuple(x for x in spec_axes(a) if x not in spec_axes(p))
        if added:
            dim, extra = i, added
    rest = tuple(a for a in mesh.batch_axes
                 if a not in done and a not in extra)
    norm = tuple(a for a in mesh.axis_names
                 if any(a in spec_axes(e) for e in ae))
    return _Leaf(local_shape(shape, a_spec, mesh), dim, extra, rest, norm)


def _snapshot(stats) -> Dict[str, Dict[str, int]]:
    return {"calls": dict(stats.calls), "sent": dict(stats.sent),
            "staged": stats.staged_bytes}


def _delta(after, before) -> Dict[str, Any]:
    return {
        "calls": {k: v - before["calls"].get(k, 0)
                  for k, v in after["calls"].items()
                  if v != before["calls"].get(k, 0)},
        "sent": {k: v - before["sent"].get(k, 0)
                 for k, v in after["sent"].items()
                 if v != before["sent"].get(k, 0)},
        "staged": after["staged"] - before["staged"]}


class _MeshStep:
    """``step_fn`` on a mesh.  ``phases`` holds the last step's
    collectives by phase (``"microbatch i"``, ``"reduce i"``, ``"clip"``,
    ``"update"``): calls by op, bytes handed to each, bytes staged."""

    def __init__(self, plan, mesh, optimizer, clip_norm, attention,
                 p_specs, a_specs):
        self.plan, self.mesh, self.optimizer = plan, mesh, optimizer
        self.clip_norm, self.attention = clip_norm, attention
        self.p_specs = p_specs
        shapes = tree_leaves(lm.abstract_params(plan.cfg))
        self.leaves = [
            _leaf_plan(ps, as_, tuple(a.shape), mesh) for ps, as_, a in zip(
                tree_leaves(p_specs), tree_leaves(a_specs), shapes,
                strict=True)]
        self.phases: Dict[str, Any] = {}

    def _phase(self, name, fn, *args):
        before = _snapshot(self.mesh.stats)
        out = fn(*args)
        self.phases[name] = _delta(_snapshot(self.mesh.stats), before)
        return out

    def _microbatch(self, params, sub, mbuf):
        with torch.enable_grad():
            loss, _ = lm.loss_fn(_grad_views(params, mbuf), sub,
                                 self.plan.cfg, remat_policy=self.plan.remat,
                                 attention=self.attention)
            loss.backward()
        return loss.detach()

    def _reduce(self, mbuf, acc):
        """This microbatch's gradients into the accumulator's blocks, leaf
        by leaf in the tree's order; the buffer is zeroed for the next."""

        with torch.no_grad():
            for g, a, leaf in zip(tree_leaves(mbuf), tree_leaves(acc),
                                  self.leaves):
                r = g.to(a.dtype)
                if leaf.scatter_axes:
                    r = C.psum_scatter_dim(r, leaf.scatter_axes,
                                           leaf.scatter_dim)
                if leaf.psum_axes:
                    r = C.psum(r, leaf.psum_axes)
                a.add_(r)
                g.zero_()

    def _update(self, grads, state):
        """AdamW on this rank's shards; a ZeRO-1 parameter's shard is cut
        from its block, updated and all-gathered back over ``data``."""

        params = state["params"]
        shards = []
        for p, leaf in zip(tree_leaves(params), self.leaves):
            if leaf.scatter_axes:
                n = leaf.acc_shape[leaf.scatter_dim]
                at = self.mesh.linear_index(leaf.scatter_axes) * n
                p = p.narrow(leaf.scatter_dim, at, n).contiguous()
            shards.append(p)
        it = iter(shards)
        self.optimizer.update(grads, state["opt"],
                              tree_map(lambda _: next(it), params),
                              state["step"])
        for p, s, leaf in zip(tree_leaves(params), shards, self.leaves):
            if leaf.scatter_axes:
                p.copy_(C.all_gather_dim(s, leaf.scatter_axes,
                                         leaf.scatter_dim))

    def __call__(self, state, batch):
        plan, mesh = self.plan, self.mesh
        n_mb = plan.microbatches
        batch = {k: torch.as_tensor(v, device=mesh.device)
                 for k, v in batch.items()}
        params = state["params"]
        acc_dtype = (lambda p: torch.float32) if n_mb > 1 else \
            (lambda p: p.dtype)
        acc = [torch.zeros(leaf.acc_shape, dtype=acc_dtype(p),
                           device=p.device)
               for p, leaf in zip(tree_leaves(params), self.leaves)]
        it = iter(acc)
        acc = tree_map(lambda _: next(it), params)
        mbuf = tree_map(torch.zeros_like, params)
        rows = batch["tokens"].shape[0] // n_mb
        losses: List[torch.Tensor] = []
        self.phases = {}
        with C.bind(mesh), sharding.placement(mesh, self.p_specs,
                                              plan.rules):
            for i in range(n_mb):
                sub = {k: v[i * rows:(i + 1) * rows] if v.ndim >= 1 else v
                       for k, v in batch.items()}
                losses.append(self._phase(f"microbatch {i}", self._microbatch,
                                          params, sub, mbuf))
                self._phase(f"reduce {i}", self._reduce, mbuf, acc)
            del mbuf
            with torch.no_grad():
                if n_mb > 1:
                    for g in tree_leaves(acc):
                        g.mul_(1.0 / n_mb)
                loss = losses[0] if n_mb == 1 else \
                    sum(losses[1:], losses[0]) * (1.0 / n_mb)
                acc, gnorm = self._phase(
                    "clip", clip_by_global_norm, acc, self.clip_norm,
                    [leaf.norm_axes for leaf in self.leaves])
                self._phase("update", self._update, acc, state)
        del acc
        new_state = {"params": params, "opt": state["opt"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}


def _build_mesh_step(plan: LMPlan, mesh, optimizer, clip_norm, attention):
    cfg = plan.cfg
    optimizer = optimizer or make_optimizer(plan)
    p_specs = param_specs(cfg, mesh, plan.rules)
    _refuse_unported(cfg, mesh, p_specs)
    opt_like = optimizer.init(lm.abstract_params(cfg))
    o_specs = opt_specs_like(p_specs, opt_like, mesh, plan.zero,
                             plan.rules.fsdp)
    # The accumulator is laid out as the optimizer state (the reference's
    # ``_acc_constraint``).
    a_specs = _moment_specs(p_specs, lm.abstract_params(cfg), mesh,
                            plan.zero, plan.rules.fsdp)
    state_specs = {"params": p_specs, "opt": o_specs, "step": P()}
    n_mb = plan.microbatches
    axes = mesh.batch_axes
    dp = math.prod(mesh.shape[a] for a in axes)

    def batch_fn(global_batch):
        """This rank's rows of ``global_batch``: for each microbatch its
        block of the global microbatch, in microbatch order."""

        B = int(next(iter(global_batch.values())).shape[0])
        mb = B // n_mb
        if B % n_mb or mb % dp:
            raise ValueError(
                f"a batch of {B} rows in {n_mb} microbatches over {dp} data "
                f"ranks: each microbatch's rows must divide evenly")
        d, per = mesh.linear_index(axes), mb // dp
        rows = torch.tensor([i * mb + d * per + j for i in range(n_mb)
                             for j in range(per)])
        out = {}
        for k, v in global_batch.items():
            t = torch.as_tensor(v)
            out[k] = (t[rows] if t.ndim >= 1 else t).to(mesh.device)
        return out

    step = _MeshStep(plan, mesh, optimizer, clip_norm, attention, p_specs,
                     a_specs)
    return step, state_specs, batch_fn
