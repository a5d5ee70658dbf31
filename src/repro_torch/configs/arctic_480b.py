"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    rope_theta=10000.0,
    notes="128 experts shard 8-per-device over the model axis (EP). "
          "56 q heads do not divide 16 -> baseline replicates attention "
          "over `model` (see §Perf). ZeRO-3 (fsdp) mandatory at 480B.",
)
