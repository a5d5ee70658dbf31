"""Logical-axis sharding rules (the planner's sharding vocabulary).

Model code in the JAX package annotates parameters and activations with
*logical* axis names ("batch", "embed", "heads", ...), and a
:class:`ShardingRules` instance chosen by the LM planner maps them to mesh
axes.  The port runs on one device so far: the rules are kept because the
planner's plan carries them (and its notes name them), while the model
code drops the ``shard(...)`` annotations, which are no-ops on one device.
Multi-device placement of the LM is ROADMAP A10e.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

__all__ = ["ShardingRules"]


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
