"""whisper-medium [audio] — enc-dec; conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, d_model) [arXiv:2212.04356]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    enc_layers=24, enc_seq=1500,
    mlp_type="gelu",
    notes="Backbone only per assignment; mel-spectrogram conv frontend "
          "stubbed as precomputed frame embeddings. Decoder shapes follow "
          "the assignment grid (4k/32k) rather than whisper's 448 cap.",
)
