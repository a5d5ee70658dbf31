"""hymba-1.5b [hybrid] — parallel attention + mamba heads
[arXiv:2411.13676; hf]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    window=1024,
    ssm_state=16, ssm_head_dim=64, ssm_groups=1, ssm_expand=2,
    d_conv=4, ssm_chunk=128,
    notes="Parallel attn+SSM heads fused per block (outputs averaged after "
          "per-branch processing). Hymba's meta tokens and per-layer "
          "global/local mix are simplified to uniform SWA (scan-over-layers "
          "homogeneity); recorded as a deviation. SWA+SSM -> long_500k RUNS.",
)
