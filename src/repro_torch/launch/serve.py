"""Serve-step builders: prefill and decode, on one device or on a mesh.

``decode_step`` is the paper's fixpoint viewed at token granularity: carried
state = (KV cache, position), loop body = one superstep of the serving
dataflow.  The cache is updated in place (the JAX package donates it to the
jitted step for the same effect).  PyTorch runs eagerly, so the builders
return plain functions; their return arity is the JAX package's.

On a mesh (``mesh`` a :class:`~repro_torch.launch.mesh.Mesh` of ``pod``,
``data`` and ``model`` axes; ROADMAP A10e-2) every rank runs the step on
its own blocks, the layouts the reference's GSPMD steps give their arrays,
made explicit:

* the parameters by ``launch.train.param_specs`` (tensor parallelism over
  ``model``: heads, ffn, experts and the vocab; ZeRO-3's ``embed`` over
  ``data`` where the plan sets ``fsdp``, gathered at use);
* the batch by rows (:func:`batch_rows`: the rank's block over the batch
  axes);
* the decode cache by :func:`cache_specs_on` (the reference's
  ``cache_shardings``): the rank's rows and, where ``model`` divides
  them, its block of the slots, every kv head;
* the logits by their rows and vocab columns (``lm.gather_logits`` joins
  them), which :func:`greedy_sample` reads vocab-parallel.

An encoder-decoder's cross K/V cache is cut over ``batch`` only: every
``model`` rank holds every head, as the reference lays it out.  So is an
SSM's ``conv`` window and state (ROADMAP A10h-2: the ``ssm`` family and
the hybrid's SSM half, whose mixer runs whole on every ``model`` rank);
the hybrid's attention half keeps its ring cache with the slots cut over
``model``.  kv heads that ``model`` does not divide, where it divides
the q heads (A10h-3, case (i)), are gathered whole and repeated to the
rank's q heads, as the reference serves them; the cache holds the raw kv
heads.  q heads that it does not divide the planner keeps whole, the
attention replicated as the reference's; a plan that cuts them mid-head
refuses a mesh before any collective (A10h-4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.lm_planner import LMPlan
from repro_torch.device import resolve_device
from repro_torch.launch.train import _refuse_unported, _spec_tree, param_specs
from repro_torch.models import lm
from repro_torch.models.common import ATTENTION_IMPLS
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import logical_to_spec

__all__ = ["cache_specs_on", "build_prefill_step", "build_decode_step",
           "batch_rows", "greedy_sample"]

Device = Optional[Union[str, torch.device]]


def cache_specs_on(cfg, mesh, rules, batch: int, seq: int) -> Dict[str, Any]:
    """The decode cache's spec tree on ``mesh`` (the reference's
    ``cache_shardings``): ``lm.cache_axes`` resolved by ``rules`` with the
    divisibility filter, so a slot count that ``model`` does not divide is
    kept whole."""

    return _spec_tree(
        lambda ax, a: logical_to_spec(rules, ax, shape=tuple(a.shape),
                                      mesh=mesh),
        lm.cache_axes(cfg, batch, seq), lm.abstract_cache(cfg, batch, seq))


def batch_rows(batch: Dict[str, Any], mesh, rules) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (a dict of arrays with a leading
    row dim), on the mesh's device: its block over the batch axes as
    ``"batch"`` resolves for the row count (every row where they do not
    divide it)."""

    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        spec = logical_to_spec(rules, ("batch",), shape=(t.shape[0],),
                               mesh=mesh)
        out[k] = sharding.local_block(t, spec, mesh).to(mesh.device)
    return out


def _mesh_specs(plan: LMPlan, mesh, device: Device):
    """The parameters' specs of a mesh step, after the refusals."""

    if device is not None and resolve_device(device).type != mesh.device.type:
        raise ValueError(f"the step runs on the mesh's device {mesh.device}, "
                         f"not {device}")
    p_specs = param_specs(plan.cfg, mesh, plan.rules)
    _refuse_unported(plan.cfg, mesh, p_specs, "serving")
    return p_specs


def build_prefill_step(plan: LMPlan, mesh, cache_len: int,
                       device: Device = None, *, attention: str = "auto"):
    """Returns ``(prefill_fn, param_specs)`` (``None`` without a mesh);
    ``prefill_fn(params, batch)`` runs ``batch["tokens"]`` (and an
    encoder-decoder's ``batch["enc_input"]`` frames), moved to ``device``,
    and returns ``(last-token logits, cache, pos)``.  On a mesh every rank
    calls it with its blocks of the parameters (cut by ``param_specs``) and
    its rows of the batch (:func:`batch_rows`), and gets its blocks of the
    logits and of the cache (:func:`cache_specs_on` at ``cache_len``).
    ``attention="ref"`` runs the attention's plain version in place of the
    flash kernel."""

    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention must be one of {ATTENTION_IMPLS}")
    cfg = plan.cfg
    if mesh is not None:
        p_specs = _mesh_specs(plan, mesh, device)

        @torch.inference_mode()
        def mesh_prefill_fn(params, batch):
            tokens = torch.as_tensor(batch["tokens"], device=mesh.device)
            enc_input = batch.get("enc_input")
            if enc_input is not None:
                enc_input = torch.as_tensor(enc_input, device=mesh.device)
            with C.bind(mesh), sharding.placement(mesh, p_specs, plan.rules):
                return lm.prefill(params, tokens, cfg, cache_len,
                                  enc_input=enc_input, attention=attention)

        return mesh_prefill_fn, p_specs
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        enc_input = batch.get("enc_input")
        if enc_input is not None:
            enc_input = torch.as_tensor(enc_input, device=dev)
        return lm.prefill(params, tokens, cfg, cache_len,
                          enc_input=enc_input, attention=attention)

    return prefill_fn, None


def build_decode_step(plan: LMPlan, mesh, device: Device = None, *,
                      attention: str = "auto",
                      cache_len: Optional[int] = None):
    """Returns ``(decode_fn, None, None)``; ``decode_fn(params, cache, token,
    pos)`` returns ``(logits, cache)`` with the cache updated in place.
    ``attention="ref"`` runs an encoder-decoder's cross-attention on its
    plain version (the self-attention over the cache is plain PyTorch).

    On a mesh returns ``(decode_fn, param_specs, cache_specs)`` with
    ``cache_specs(batch, seq)`` the cache's spec tree
    (:func:`cache_specs_on`); every rank calls ``decode_fn`` with its
    blocks of the parameters and the cache and its rows of ``token``, and
    gets its blocks of the logits.  ``cache_len`` is then the whole
    cache's slot count (the prefill's ``cache_len``), which a rank's block
    does not show."""

    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention must be one of {ATTENTION_IMPLS}")
    cfg = plan.cfg
    if mesh is not None:
        if cache_len is None:
            raise ValueError("a decode step on a mesh needs the cache's "
                             "global slot count (cache_len=)")
        p_specs = _mesh_specs(plan, mesh, device)

        @torch.inference_mode()
        def mesh_decode_fn(params, cache, token, pos):
            token = torch.as_tensor(token, device=mesh.device)
            with C.bind(mesh), sharding.placement(mesh, p_specs, plan.rules):
                return lm.decode_step(params, cache, token, pos, cfg,
                                      attention=attention,
                                      cache_len=cache_len)

        def c_specs(batch: int, seq: int):
            return cache_specs_on(cfg, mesh, plan.rules, batch, seq)

        return mesh_decode_fn, p_specs, c_specs
    dev = resolve_device(device)

    @torch.inference_mode()
    def decode_fn(params, cache, token, pos):
        token = torch.as_tensor(token, device=dev)
        return lm.decode_step(params, cache, token, pos, cfg,
                              attention=attention)

    return decode_fn, None, None


def greedy_sample(logits: torch.Tensor, cfg=None, mesh=None) -> torch.Tensor:
    """The last position's argmax token of every row, ``(B, 1)`` int32.

    On ``mesh``, where the logits are a rank's block of ``cfg``'s padded
    vocab cut over ``model``, the argmax is vocab-parallel: a ``pmax`` of
    each rank's row max, then the lowest global id that holds it (the tie
    rule of ``argmax``), so every ``model`` rank returns its rows'
    tokens."""

    last = logits[:, -1, :]
    if mesh is None or last.shape[-1] == cfg.padded_vocab:
        return torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    n = last.shape[-1]
    with C.bind(mesh):
        best = torch.amax(last, dim=-1).to(torch.float32)
        at = torch.argmax(last, dim=-1) + C.axis_index("model") * n
        top = C.pmax(best, "model")
        token = -C.pmax(torch.where(best == top, -at, -cfg.padded_vocab),
                        "model")
    return token.to(torch.int32)[:, None]
