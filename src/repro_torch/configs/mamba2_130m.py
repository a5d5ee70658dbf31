"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_groups=1, ssm_expand=2,
    d_conv=4, ssm_chunk=128, tie_embeddings=True,
    notes="Attention-free: the paper's reduce/collective planning applies "
          "to gradient aggregation only; decode state is O(1) per step so "
          "long_500k RUNS.",
)
