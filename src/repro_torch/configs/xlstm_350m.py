"""xlstm-350m [arXiv:2405.04517; unverified]: 24L d_model=1024 4H d_ff=0
vocab=50304 -- alternating sLSTM + mLSTM blocks, no FFN."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,                           # no FFN: blocks carry internal up/down proj
    vocab=50304,
    act="identity",
    rope_theta=0.0,
    block_pattern="ms",               # mLSTM, sLSTM alternating
    subquadratic=True,                # recurrent: O(1) decode state
    decode_capable=True,
    tie_embeddings=True,
    source="arXiv:2405.04517",
    notes="d_ff=0 makes the paper's Fig-2a MLP fusion inapplicable; Kitsune "
          "contribution limited to epilogue fusion + mesh reduction trees "
          "(DESIGN.md SS5 'weakest fit').",
)
