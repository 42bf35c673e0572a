"""hymba-1.5b [arXiv:2411.13676; hf]: 32L d_model=1600 25H (GQA kv=5)
d_ff=5504 vocab=32001, ssm_state=16 -- parallel attention+mamba heads."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    act="swiglu",
    rope_theta=1e4,
    ssm_state=16,
    subquadratic=True,                # SSM branch: long_500k runs
    tie_embeddings=True,
    source="arXiv:2411.13676",
    notes="parallel attn+SSM heads per layer (the paper's heterogeneous "
          "co-execution at the architecture level); meta-tokens omitted. "
          "25 heads don't divide the model axis: flattened qk dims shard.",
)
