"""Physical planner for LM train/serve steps (the JAX package's
``core/lm_planner.py``, on the port's hardware model).

LM training is an IMRU program (map = per-microbatch grad, reduce = the
gradient sum, update = optimizer); serving is a fixpoint over the token
position.  The planner makes the paper's physical choices for those
programs from the arch config, the shape cell and the hardware model:
dtype policy, ZeRO stage, expert placement, attention TP feasibility,
remat and microbatching, the gradient codec and the sharding rules.  Every
decision lands in ``LMPlan.notes``; given the same ``HardwareSpec`` they
are byte-equal to the JAX package's.  The default stays ``TPU_V5E``; pass
``hw=H100_SXM`` to plan for the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.hardware import HardwareSpec, MeshSpec, TPU_V5E
from repro_torch.models.common import SHAPES, ArchConfig
from repro_torch.parallel.sharding import ShardingRules

__all__ = ["LMPlan", "plan_lm"]


@dataclass(frozen=True)
class LMPlan:
    cfg: ArchConfig                # possibly dtype-adjusted
    mesh: MeshSpec
    shape_name: str
    kind: str                      # train | prefill | decode
    rules: ShardingRules
    remat: str = "full"            # full | dots | none
    microbatches: int = 1
    zero: str = "zero1"            # none | zero1 | zero3
    m_dtype: str = "float32"       # Adam first-moment dtype
    v_dtype: str = "float32"
    grad_codec: Optional[str] = None
    notes: Tuple[str, ...] = ()

    def explain(self) -> str:
        return (
            f"LMPlan[{self.cfg.name} x {self.shape_name} on {self.mesh}]\n"
            f"  kind={self.kind} zero={self.zero} remat={self.remat} "
            f"microbatches={self.microbatches}\n"
            f"  param_dtype={self.cfg.param_dtype} m={self.m_dtype} "
            f"v={self.v_dtype} codec={self.grad_codec}\n"
            f"  fsdp={self.rules.fsdp} ep={self.rules.expert_parallel}\n"
            "  applied rules: " + ", ".join(self.notes)
        )


def _param_count(cfg: ArchConfig) -> int:
    from repro_torch.models import lm

    return lm.param_count(cfg)


def plan_lm(
    cfg: ArchConfig,
    shape_name: str,
    mesh: MeshSpec,
    hw: HardwareSpec = TPU_V5E,
    *,
    overrides: Optional[Dict] = None,
) -> LMPlan:
    shp = SHAPES[shape_name]
    kind = shp["kind"]
    notes = []
    tp = mesh.size("model")
    dp = mesh.data_parallel_size

    n_params = _param_count(cfg)
    bytes_f32 = 4 * n_params

    # ---- dtype policy (model-volume property, severe end) -----------------
    param_dtype, m_dtype, v_dtype = cfg.param_dtype, "float32", "float32"
    # fully sharded footprint if we take ZeRO-3 over the whole mesh:
    full_shard = mesh.n_devices
    if kind == "train":
        # params+m+v must leave room for activations + grads + transients
        budget = 0.55 * hw.hbm_bytes
        need_f32 = (4 + 4 + 4) * n_params / full_shard
        if need_f32 > budget:
            param_dtype, m_dtype = "bfloat16", "bfloat16"
            notes.append("dtype-policy(bf16-params+bf16-m: f32 master would "
                         "not fit even fully sharded)")
            if (2 + 2 + 4) * n_params / full_shard > budget:
                v_dtype = "bfloat16"
                notes.append("dtype-policy(bf16-v)")
    else:
        if 4 * n_params / full_shard > 0.5 * hw.hbm_bytes:
            param_dtype = "bfloat16"
            notes.append("dtype-policy(bf16-serving-params)")

    pb = {"float32": 4, "bfloat16": 2}[param_dtype]

    # ---- ZeRO stage (model volume property) --------------------------------
    per_replica_params = pb * n_params / tp
    zero = "none"
    fsdp = False
    if kind == "train":
        zero = "zero1"
        notes.append("aggregation-tree(reduce-scatter+sharded-update: ZeRO-1)")
        if per_replica_params > 0.25 * hw.hbm_bytes:
            fsdp = True
            zero = "zero3"
            notes.append("model-volume(ZeRO-3/fsdp: params sharded over data)")
        else:
            notes.append("model-volume(params replicated over data)")
    else:
        if per_replica_params > 0.45 * hw.hbm_bytes:
            fsdp = True
            notes.append("model-volume(serving fsdp: per-layer all-gather)")

    # ---- expert placement ---------------------------------------------------
    ep = bool(cfg.n_experts) and cfg.n_experts % tp == 0
    expert_ffn_tp = bool(cfg.n_experts) and not ep \
        and (cfg.moe_d_ff or cfg.d_ff) % tp == 0
    if cfg.n_experts:
        notes.append(
            "expert-placement("
            + ("EP over model axis" if ep
               else "TP on expert ffn (n_experts % tp != 0)")
            + ")"
        )

    # ---- attention TP feasibility (recorded for §Perf) ----------------------
    attention_replicated = (
        cfg.family in ("dense", "moe", "hybrid", "encdec", "mla")
        and cfg.n_heads % tp != 0
    )
    if attention_replicated:
        notes.append(
            f"attention-replicated({cfg.n_heads} heads % tp={tp} != 0: "
            "qkv params + attention compute replicated over model — "
            "avoids per-layer q all-gathers; see head-dim-sharding "
            "hillclimb)"
        )

    # ---- remat / microbatching (early aggregation) --------------------------
    remat = "full" if kind == "train" else "none"
    microbatches = 1
    if kind == "train":
        B_local = max(shp["batch"] // dp, 1)
        S = shp["seq"]
        # Per-layer full remat, as the JAX package plans it.
        L = cfg.n_layers
        carried = L
        # live memory =
        #   group-boundary carry (bf16 x per saved boundary)
        # + one group's recompute window
        # + the logits slab (bf16 logits + f32 softmax + f32 grad)
        Vp_shard = cfg.padded_vocab // tp if cfg.padded_vocab % tp == 0 \
            else cfg.padded_vocab
        # logits slab is sequence-chunked (lm.chunked_xent, 512 tokens)
        act = B_local * S * (
            cfg.d_model * 2 * (carried + cfg.enc_layers)
            + cfg.d_model * 2 * 10
        ) + B_local * 512 * Vp_shard * 10
        if cfg.family in ("ssm", "hybrid"):
            # SSD intra-chunk (Q x Q) decay/score tensors dominate: ~6 f32
            # buffers of (B, S/Q, H, Q, Q) live through the backward pass.
            act = max(
                act,
                B_local * S * cfg.ssm_chunk * cfg.n_ssm_heads * 4 * 6,
            )
        if cfg.n_experts:
            # dispatch buffer (X, C, E) + ffn intermediates, sharded over
            # the expert/ffn axis
            F = cfg.moe_d_ff or cfg.d_ff
            act = max(
                act,
                int(B_local * S * cfg.top_k * cfg.capacity_factor)
                * (cfg.d_model + 2 * F // tp) * 2 * 2,
            )
        limit = 0.25 * hw.hbm_bytes
        while act / microbatches > limit and microbatches < B_local:
            microbatches *= 2
        if microbatches > 1:
            notes.append(f"early-aggregation(microbatch x{microbatches})")

    # ---- gradient codec ------------------------------------------------------
    grad_codec = None
    if kind == "train" and mesh.size("pod") > 1 and pb * n_params / tp > 1e9:
        grad_codec = None  # baseline: uncompressed; hillclimb may enable
        notes.append("grad-codec(candidate int8_ef for DCN hop; baseline off)")

    # ---- sharding rules -------------------------------------------------------
    rules = ShardingRules(fsdp=fsdp, expert_parallel=ep)
    if attention_replicated:
        rules = rules.with_rule("qkv", None)
    if expert_ffn_tp:
        rules = rules.with_rule("expert_ffn", "model")
    notes.append("loop-invariant-caching(params+cache donated across steps)")
    if kind == "decode":
        notes.append("storage-selection(kv_seq sharded over model; "
                     + {"mla": "latent cache", "ssm": "O(1) state",
                        "hybrid": "ring SWA + O(1) state",
                        }.get(cfg.family,
                              "ring SWA cache" if cfg.window else "dense cache")
                     + ")")

    cfg2 = dataclasses.replace(cfg, param_dtype=param_dtype)
    plan = LMPlan(
        cfg=cfg2, mesh=mesh, shape_name=shape_name, kind=kind,
        rules=rules, remat=remat, microbatches=microbatches, zero=zero,
        m_dtype=m_dtype, v_dtype=v_dtype, grad_codec=grad_codec,
        notes=tuple(notes),
    )
    if overrides:
        plan = dataclasses.replace(plan, **overrides)
    return plan
