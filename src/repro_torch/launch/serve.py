"""Serve-step builders: prefill and decode on one device.

``decode_step`` is the paper's fixpoint viewed at token granularity: carried
state = (KV cache, position), loop body = one superstep of the serving
dataflow.  The cache is updated in place (the JAX package donates it to the
jitted step for the same effect).  PyTorch runs eagerly, so the builders
return plain functions; their return arity is the JAX package's.  Placement
over a mesh is ROADMAP A10e: a ``mesh`` that is not ``None`` raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.lm_planner import LMPlan
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ATTENTION_IMPLS

__all__ = ["build_prefill_step", "build_decode_step", "greedy_sample"]

Device = Optional[Union[str, torch.device]]


def _single_device(mesh, device: Device) -> torch.device:
    if mesh is not None:
        raise NotImplementedError(
            "serving over a device mesh is not ported yet (ROADMAP A10e); "
            "pass mesh=None")
    return resolve_device(device)


def build_prefill_step(plan: LMPlan, mesh, cache_len: int,
                       device: Device = None, *, attention: str = "auto"):
    """Returns ``(prefill_fn, None)``; ``prefill_fn(params, batch)`` runs
    ``batch["tokens"]`` (and an encoder-decoder's ``batch["enc_input"]``
    frames), moved to ``device``, and returns ``(last-token logits, cache,
    pos)``.  ``attention="ref"`` runs the attention's plain version in
    place of the flash kernel.""" 

    dev = _single_device(mesh, device)
    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention must be one of {ATTENTION_IMPLS}")
    cfg = plan.cfg

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
                      attention: str = "auto"):
    """Returns ``(decode_fn, None, None)``; ``decode_fn(params, cache, token,
    pos)`` returns ``(logits, cache)`` with the cache updated in place.
    ``attention="ref"`` runs an encoder-decoder's cross-attention on its
    plain version (the self-attention over the cache is plain PyTorch)."""

    dev = _single_device(mesh, device)
    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention must be one of {ATTENTION_IMPLS}")
    cfg = plan.cfg

    @torch.inference_mode()
    def decode_fn(params, cache, token, pos):
        token = torch.as_tensor(token, device=dev)
        return lm.decode_step(params, cache, token, pos, cfg,
                              attention=attention)

    return decode_fn, None, None


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
