"""minicpm3-4b [mla] — multi-head latent attention [hf:openbmb/MiniCPM3-4B]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="mla",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448,
    q_lora_rank=768, kv_lora_rank=256,
    nope_head_dim=64, rope_head_dim=32, v_head_dim=64,
    rope_theta=10000.0,
    notes="MLA latent KV cache: 288 bytes-per-token-per-layer class; decode "
          "uses the absorbed-matrix form (latent-space attention).",
)
