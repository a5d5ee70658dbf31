"""Model registry: config lookup, reduced configs, the dry run's inputs
(abstract params, input specs, the cells' skip rule), the model bundle.

Every architecture id of the JAX package is listed, and :func:`get_config`
returns each one's config from ``repro_torch.configs``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import lm
from repro_torch.models.common import SHAPES, ArchConfig, dtype_of

__all__ = [
    "ARCH_IDS",
    "get_config",
    "reduced_config",
    "abstract_params",
    "input_specs",
    "cell_is_applicable",
    "build_model",
]

ARCH_IDS = (
    "minitron_8b",
    "phi4_mini_3_8b",
    "minicpm3_4b",
    "stablelm_12b",
    "whisper_medium",
    "chameleon_34b",
    "mixtral_8x22b",
    "arctic_480b",
    "mamba2_130m",
    "hymba_1_5b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving tiny config for CPU tests (the JAX package's
    ``reduced_config``)."""

    changes: Dict[str, Any] = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=128 if cfg.d_ff else 0,
        vocab=128,
        head_dim=16,
    )
    if cfg.family == "mla":
        changes.update(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                       nope_head_dim=8, v_head_dim=16)
    if cfg.n_experts:
        # capacity_factor = n_experts -> capacity == T*k: drop-free routing,
        # so prefill/decode outputs match teacher forcing exactly in tests.
        changes.update(n_experts=4, top_k=2, moe_d_ff=64, capacity_factor=4.0)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_heads=0,
                       ssm_chunk=8)
    if cfg.window is not None:
        changes.update(window=16)
    if cfg.family == "encdec":
        changes.update(enc_layers=2, enc_seq=24)
    changes["param_dtype"] = "float32"
    changes["compute_dtype"] = "float32"
    return dataclasses.replace(cfg, **changes)


def abstract_params(cfg: ArchConfig) -> Dict[str, Any]:
    return lm.abstract_params(cfg)


def cell_is_applicable(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    """The JAX package's skip rule: ``long_500k`` runs only for the
    sub-quadratic configs."""

    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, (
            f"{cfg.name}: long_500k skipped — pure full attention "
            "(O(S) KV state per step; no sub-quadratic path)"
        )
    return True, ""


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, Any]:
    """Stand-ins on the ``meta`` device for every model input of a shape
    cell, in the JAX package's dtypes (int32 tokens):

    * train:   {tokens (B,S), [enc_input]}
    * prefill: {tokens (B,S), [enc_input]}
    * decode:  {token (B,1), pos, cache tree}

    ``pos`` is a Python int, ``S - 1`` (the last slot of the cache), where
    the JAX package has an int32 scalar: the port's ``decode_step`` takes
    the position as an int."""

    shp = SHAPES[shape_name]
    B = shp["batch"]
    S = shp["seq"]
    meta = torch.device("meta")
    if shp["kind"] in ("train", "prefill"):
        specs: Dict[str, Any] = {
            "tokens": torch.empty((B, S), dtype=torch.int32, device=meta),
        }
        if cfg.family == "encdec":
            specs["enc_input"] = torch.empty(
                (B, cfg.enc_seq, cfg.d_model),
                dtype=dtype_of(cfg.compute_dtype), device=meta)
        return specs
    return {
        "token": torch.empty((B, 1), dtype=torch.int32, device=meta),
        "pos": S - 1,
        "cache": lm.abstract_cache(cfg, B, S),
    }


def build_model(cfg: ArchConfig):
    """Bundle of the model functions for this config."""

    return {
        "init_params": lambda gen, **kw: lm.init_params(cfg, gen, **kw),
        "forward": lambda p, t, **kw: lm.forward(p, t, cfg, **kw),
        "prefill": lambda p, t, L, **kw: lm.prefill(p, t, cfg, L, **kw),
        "decode_step": lambda p, c, t, pos, **kw: lm.decode_step(
            p, c, t, pos, cfg, **kw),
        "init_cache": lambda b, s, **kw: lm.init_cache(cfg, b, s, **kw),
    }
