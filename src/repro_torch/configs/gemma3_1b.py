"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified]: 26L d_model=1152 4H
(GQA kv=1) d_ff=6912 vocab=262144; 5:1 local:global sliding-window, 128k ctx."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    act="swiglu",
    window=1024,
    window_pattern="LLLLLG",          # 5 local : 1 global
    rope_theta=1e6,                    # global layers
    rope_theta_local=1e4,              # local layers
    subquadratic=True,                 # 5/6 layers are O(S*window); long_500k runs
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
    notes="qk-norm and pre+post norms of gemma3 simplified to pre-norm; "
          "window=1024 local layers; long-context decode keeps a full-length "
          "cache but attends windowed (see DESIGN.md SS5).",
)
