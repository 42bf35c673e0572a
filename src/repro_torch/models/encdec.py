"""Encoder-decoder transformer (whisper-small backbone), the counterpart of
`repro/models/encdec.py`: parameters and the full-sequence forward.

The conv/mel frontend is a stub, as in the reference: `forward` takes
precomputed frame embeddings (B, S_enc, D).  Learned positional embeddings
(no RoPE), pre-norm, gelu MLPs (the fused two-matrix kernels in both
directions); the decoder has causal self-attention and cross-attention over
the encoder states.  Parameters keep the reference's stacked layout
(`enc/attn/wq` of shape (n_layers, d_model, q_dim)), so its `init_params`
output converts with `core.executor.params_from_numpy`.  The encoder runs
without remat and the decoder's layers under `torch.utils.checkpoint` when
`remat` is set, as in the reference.  Decode (`init_cache`,
`build_cross_cache`, `decode_step`) is not ported (ROADMAP A7).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L
from .lm import DTYPES, chunked_attention, unstack


def _init_stack(gen, cfg: ArchConfig, cross: bool, dtype, device) -> dict:
    d, n = cfg.d_model, cfg.n_layers

    def attn():
        return L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                groups=n, dtype=dtype, device=device)

    def ones():
        return torch.ones((n, d), dtype=dtype, device=device)

    p = {"ln1": ones(), "attn": attn(), "ln2": ones(),
         "mlp": L.init_mlp(gen, d, cfg.d_ff, groups=n, act="gelu", dtype=dtype,
                           device=device)}
    if cross:
        p["ln_x"] = ones()
        p["xattn"] = attn()
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda", max_positions: int = 448,
                max_source: int = 1500) -> dict:
    """Random weights in the reference's layout and scales, drawn from a
    `torch.Generator` seeded with `seed` on `device`."""
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    return {"embed": normal((cfg.vocab, d), 0.02),
            "pos_dec": normal((max_positions, d), 0.01),
            "pos_enc": normal((max_source, d), 0.01),
            "enc": _init_stack(gen, cfg, False, dtype, device),
            "dec": _init_stack(gen, cfg, True, dtype, device),
            "enc_norm": torch.ones(d, dtype=dtype, device=device),
            "final_norm": torch.ones(d, dtype=dtype, device=device)}


def _self_attn(p, x, *, cfg: ArchConfig, causal: bool, kv=None) -> torch.Tensor:
    b, s, _ = x.shape
    src = kv if kv is not None else x
    sk = src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (src @ p["wk"]).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    v = (src @ p["wv"]).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal)
    return o.transpose(1, 2).reshape(b, s, cfg.q_dim) @ p["wo"]


def _positions(table: torch.Tensor, s: int) -> torch.Tensor:
    """The first s rows of a learned position table, tiled beyond its
    length (as the reference does)."""
    if s > table.shape[0]:
        table = table.repeat(s // table.shape[0] + 1, 1)
    return table[None, :s]


def encode(params: dict, frame_embeds: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = frame_embeds.to(params["embed"].dtype)
    x = x + _positions(params["pos_enc"], x.shape[1])
    for p in unstack(params["enc"]):
        x = x + _self_attn(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg, causal=False)
        x = x + L.mlp_block(p["mlp"], L.rms_norm(x, p["ln2"]), act="gelu")
    return L.rms_norm(x, params["enc_norm"])


def _dec_block(p, x, enc, *, cfg: ArchConfig) -> torch.Tensor:
    x = x + _self_attn(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg, causal=True)
    x = x + _self_attn(p["xattn"], L.rms_norm(x, p["ln_x"]), cfg=cfg, causal=False, kv=enc)
    return x + L.mlp_block(p["mlp"], L.rms_norm(x, p["ln2"]), act="gelu")


def forward(params: dict, frame_embeds: torch.Tensor, tokens: torch.Tensor,
            cfg: ArchConfig, *, remat: bool = False,
            return_hidden: bool = False) -> torch.Tensor:
    """frame_embeds: (B, S_enc, D) stub; tokens: (B, S_dec) -> logits
    (B, S_dec, vocab), or the final-normed hidden states with
    `return_hidden`."""
    enc = encode(params, frame_embeds, cfg)
    x = L.embed(params["embed"], tokens).to(enc.dtype)
    x = x + _positions(params["pos_dec"], x.shape[1])
    block = functools.partial(_dec_block, cfg=cfg)
    for p in unstack(params["dec"]):
        x = checkpoint(block, p, x, enc, use_reentrant=False) if remat else block(p, x, enc)
    x = L.rms_norm(x, params["final_norm"])
    if return_hidden:
        return x
    return x @ params["embed"].T
