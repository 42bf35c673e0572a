"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4 family; unverified]:
48L d_model=5120 40H (GQA kv=8) per-expert d_ff=8192 vocab=202048,
MoE 128 experts top-1, interleaved dense/MoE (every other layer) which
reproduces the 400B-total / 17B-active ratio."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    act="swiglu",
    rope_theta=5e5,
    n_experts=128,
    top_k=1,
    moe_period=2,                     # dense, MoE, dense, MoE, ...
    dense_d_ff=16384,
    subquadratic=False,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family)",
    notes="early-fusion multimodality out of scope; text backbone per "
          "assignment. 128 experts shard cleanly over the 16-way model axis (EP).",
)
