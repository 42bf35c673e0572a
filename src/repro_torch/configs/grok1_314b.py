"""grok-1-314b [hf:xai-org/grok-1; unverified]: 64L d_model=6144 48H (GQA kv=8)
d_ff=32768 vocab=131072, MoE 8 experts top-2."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    act="swiglu",   # grok-1 gated GeGLU-style FFN (3 matrices) ~ SwiGLU
    rope_theta=1e4,
    n_experts=8,
    top_k=2,
    moe_period=1,                     # every layer MoE
    subquadratic=False,
    tie_embeddings=True,
    source="hf:xai-org/grok-1",
    notes="8 experts do not divide the 16-way model axis: expert FFN dims "
          "shard instead (TP-in-expert, DESIGN.md SS4).",
)
