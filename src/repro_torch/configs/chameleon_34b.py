"""chameleon-34b [vlm] — early-fusion; VQ image tokens arrive pre-fused in
the shared vocab (frontend STUB) [arXiv:2405.09818]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, head_dim=128,
    qk_norm=True, rope_theta=10000.0,
    notes="Early fusion = ordinary token stream over a VQ-extended vocab; "
          "image tokenizer stubbed (tokens arrive pre-quantized).",
)
