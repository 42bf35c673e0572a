"""Architecture config schema + input-shape definitions for the 40-cell grid."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # sliding-window pattern: e.g. "LLLLLG" repeats over layers (gemma3)
    window: int | None = None
    window_pattern: str | None = None
    rope_theta_local: float | None = None
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1          # every Pth layer is MoE (llama4: 2)
    dense_d_ff: int = 0          # d_ff of interleaved dense layers
    # ssm / hybrid
    ssm_state: int = 0
    block_pattern: str = ""      # xlstm: "ms" = alternate mLSTM/sLSTM
    # encdec (whisper): n_layers applies to each of enc and dec
    enc_seq_downsample: int = 1
    # vlm
    vision_tokens: int = 0
    # shape applicability
    subquadratic: bool = False   # runs long_500k
    decode_capable: bool = True
    dtype: str = "bfloat16"
    # KV-cache storage dtype: "bfloat16" | "float8_e4m3fn" (halves the
    # streamed decode bytes and the cache footprint -- the lever for MHA
    # archs like qwen whose 32k x 128-batch cache is 5.4 TB in bf16)
    kv_cache_dtype: str = "bfloat16"
    tie_embeddings: bool = True
    source: str = ""
    notes: str = ""

    # ---- derived ---------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.act == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        per_layer = attn + ffn
        if self.family == "moe":
            moe_layers = self.n_layers // self.moe_period
            dense_layers = self.n_layers - moe_layers
            dff = self.dense_d_ff or f
            per = attn + 3 * d * dff
            moe_per = attn + self.n_experts * 3 * d * f
            return emb + dense_layers * per + moe_layers * moe_per
        if self.family == "ssm":
            din = 2 * d
            per_m = d * din + 3 * din * din + din * 2 * self.n_heads + din * d + d * din
            per_s = d * 4 * d + d * d
            return emb + (self.n_layers // 2) * (per_m + per_s)
        if self.family == "hybrid":
            din = 2 * d
            ssm = d * 2 * din + din * (2 * self.ssm_state + 1) + din * d
            return emb + self.n_layers * (per_layer + ssm)
        if self.family == "encdec":
            # enc + dec stacks; dec adds cross-attention
            return emb + self.n_layers * (per_layer) + self.n_layers * (per_layer + attn)
        return emb + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        moe_layers = self.n_layers // self.moe_period
        dense_layers = self.n_layers - moe_layers
        dff = self.dense_d_ff or f
        act = (self.vocab * d + dense_layers * (attn + 3 * d * dff)
               + moe_layers * (attn + self.top_k * 3 * d * f))
        return act

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, 2 * self.moe_period,
                         2 * len(self.block_pattern or "x")),
            d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            dense_d_ff=128 if self.dense_d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            vision_tokens=min(self.vision_tokens, 16),
            window=min(self.window, 32) if self.window else None,
            dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The runnable cells for an arch (skips documented in DESIGN.md SS5)."""
    out = ["train_4k", "prefill_32k"]
    if cfg.decode_capable:
        out.append("decode_32k")
        if cfg.subquadratic:
            out.append("long_500k")
    return out
