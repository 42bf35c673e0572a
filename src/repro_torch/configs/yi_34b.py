"""yi-34b [arXiv:2403.04652; hf]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; llama-architecture GQA."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    act="swiglu",
    rope_theta=5e6,
    subquadratic=False,
    tie_embeddings=False,
    source="arXiv:2403.04652",
)
