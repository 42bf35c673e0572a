"""whisper-small [arXiv:2212.04356; unverified]: 12L enc + 12L dec d_model=768
12H d_ff=3072 vocab=51865; enc-dec, conv frontend STUBBED -- input_specs()
supplies precomputed frame embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,                      # each of encoder and decoder
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    rope_theta=0.0,                   # learned positions, no RoPE
    subquadratic=False,
    tie_embeddings=True,
    source="arXiv:2212.04356",
    notes="conv frontend stub per assignment; decode_32k exceeds the model's "
          "448 trained positions -- runs mechanically on the backbone "
          "(documented); long_500k skipped (full attention).",
)
