"""qwen1.5-32b [hf:Qwen/Qwen1.5 family; hf]: 64L d_model=5120 40H (MHA kv=40)
d_ff=27392 vocab=152064; QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    subquadratic=False,               # full attention: long_500k skipped
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-0.5B (family config, scaled)",
)
