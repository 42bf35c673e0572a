"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified]: 40L d_model=5120
32H (GQA kv=8) d_ff=14336 vocab=131072; pixtral-ViT frontend (STUB) +
mistral-nemo backbone.  input_specs() supplies precomputed patch embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    act="swiglu",
    rope_theta=1e6,
    vision_tokens=256,               # stub patch embeddings prepended
    subquadratic=False,
    tie_embeddings=False,
    source="hf:mistralai/Pixtral-12B-2409",
    notes="ViT frontend stubbed per assignment; backbone-only transformer.",
)
