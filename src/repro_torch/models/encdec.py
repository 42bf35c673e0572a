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
`remat` is set, as in the reference.

Decode: `init_cache` holds the decoder's self-attention K/V and the
cross-attention K/V of the encoder states, `build_cross_cache` fills the
latter once per request, and `decode_step` runs one token against both.
The caches stay in the activation dtype whatever `kv_cache_dtype` says, as
the reference's do.  `kernels` (a `KernelConfig`) reaches the MLP blocks
and the self-attention decode kernel, as the reference's `kernels=` does.
As in the reference, the decoder's self-attention in decode ropes q and k
(theta 1e4) on top of the learned positions, which the full-sequence
forward does not (the reference documents this deviation).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distributed.sharding import (NULL, merge_dims, rows_matmul, sharded_entry, split_dim,
                                    whole_rows)
from ..kernels import KernelConfig
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
    # meta tensors (shapes only, e.g. to resolve shardings) draw nothing
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
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


def _self_attn(p, x, *, cfg: ArchConfig, causal: bool, kv=None, sharder=NULL) -> torch.Tensor:
    x = whole_rows(x)
    src = x if kv is None else whole_rows(kv)
    q = split_dim(rows_matmul(x, p["wq"]), 2, (cfg.n_heads, cfg.head_dim))
    k = split_dim(rows_matmul(src, p["wk"]), 2, (cfg.n_kv_heads, cfg.head_dim))
    v = split_dim(rows_matmul(src, p["wv"]), 2, (cfg.n_kv_heads, cfg.head_dim))
    q = sharder.constrain(q, "act_heads")
    k = sharder.constrain(k, "act_kv_heads")
    o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal)
    return sharder.constrain(rows_matmul(merge_dims(o.transpose(1, 2), 2), p["wo"]),
                             "act_resid")


def _positions(table: torch.Tensor, s: int) -> torch.Tensor:
    """The first s rows of a learned position table, tiled beyond its
    length (as the reference does)."""
    if s > table.shape[0]:
        table = table.repeat(s // table.shape[0] + 1, 1)
    return table[None, :s]


@sharded_entry
def encode(params: dict, frame_embeds: torch.Tensor, cfg: ArchConfig, *,
           kernels: KernelConfig = KernelConfig(), sharder=NULL) -> torch.Tensor:
    x = frame_embeds.to(params["embed"].dtype)
    x = sharder.constrain(x + _positions(params["pos_enc"], x.shape[1]), "act_resid")
    for p in unstack(params["enc"]):
        x = x + _self_attn(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg, causal=False,
                           sharder=sharder)
        x = x + L.mlp_block(p["mlp"], L.rms_norm(x, p["ln2"]), act="gelu", kernels=kernels,
                            constrain=sharder.constrain)
    return L.rms_norm(x, params["enc_norm"])


def _dec_block(p, x, enc, *, cfg: ArchConfig, kernels: KernelConfig, sharder) -> torch.Tensor:
    x = x + _self_attn(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg, causal=True,
                       sharder=sharder)
    x = x + _self_attn(p["xattn"], L.rms_norm(x, p["ln_x"]), cfg=cfg, causal=False, kv=enc,
                       sharder=sharder)
    return x + L.mlp_block(p["mlp"], L.rms_norm(x, p["ln2"]), act="gelu", kernels=kernels,
                           constrain=sharder.constrain)


@sharded_entry
def forward(params: dict, frame_embeds: torch.Tensor, tokens: torch.Tensor,
            cfg: ArchConfig, *, remat: bool = False,
            return_hidden: bool = False, kernels: KernelConfig = KernelConfig(),
            sharder=NULL) -> torch.Tensor:
    """frame_embeds: (B, S_enc, D) stub; tokens: (B, S_dec) -> logits
    (B, S_dec, vocab), or the final-normed hidden states with
    `return_hidden`; `sharder` pins the activations at the reference's
    sites."""
    enc = encode(params, frame_embeds, cfg, kernels=kernels, sharder=sharder)
    x = L.embed(params["embed"], tokens).to(enc.dtype)
    x = sharder.constrain(x + _positions(params["pos_dec"], x.shape[1]), "act_resid")
    block = functools.partial(_dec_block, cfg=cfg, kernels=kernels, sharder=sharder)
    for p in unstack(params["dec"]):
        x = checkpoint(block, p, x, enc, use_reentrant=False) if remat else block(p, x, enc)
    x = L.rms_norm(x, params["final_norm"])
    if return_hidden:
        return sharder.constrain(x, "act_resid")
    return sharder.constrain(rows_matmul(x, params["embed"].T), "logits")


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int = 1500,
               dtype=None, device="cuda") -> dict:
    """Zeros: self-attention "k"/"v" (n_layers, batch, Hkv, max_len, D) and
    cross-attention "xk"/"xv" (n_layers, batch, Hkv, enc_len, D)."""
    if dtype is None:
        dtype = DTYPES[cfg.dtype]
    n, h, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {"k": torch.zeros((n, batch, h, max_len, d), **kw),
            "v": torch.zeros((n, batch, h, max_len, d), **kw),
            "xk": torch.zeros((n, batch, h, enc_len, d), **kw),
            "xv": torch.zeros((n, batch, h, enc_len, d), **kw)}


def build_cross_cache(params: dict, enc: torch.Tensor, cfg: ArchConfig, cache: dict) -> dict:
    """The cross-attention K/V of the encoder states enc (B, S_enc, D), every
    decoder layer's, computed once per request: a new cache dict whose
    "xk"/"xv" are (n_layers, B, Hkv, S_enc, D)."""
    b, sk, _ = enc.shape
    xk, xv = [], []
    for p in unstack(params["dec"]):
        xk.append((enc @ p["xattn"]["wk"]).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
                  .transpose(1, 2))
        xv.append((enc @ p["xattn"]["wv"]).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
                  .transpose(1, 2))
    return dict(cache, xk=torch.stack(xk).to(cache["xk"].dtype),
                xv=torch.stack(xv).to(cache["xv"].dtype))


@sharded_entry
def decode_step(params: dict, token: torch.Tensor, pos, cache: dict,
                cfg: ArchConfig, *, kernels: KernelConfig = KernelConfig(),
                sharder=NULL) -> tuple[torch.Tensor, dict]:
    """One decoder token against the self-attention cache (updated in
    place; `flash_decode` at every layer) and the fixed cross cache
    (`chunked_attention`, as the reference attends it).  token: (B,) ids;
    pos: a python int or a per-slot (B,) tensor.  Returns (logits
    (B, vocab), cache)."""
    x = L.embed(params["embed"], token[:, None]).to(params["embed"].dtype)
    pmax = params["pos_dec"].shape[0]
    if torch.is_tensor(pos):
        x = x + params["pos_dec"][pos.clamp(max=pmax - 1)][:, None]
    else:
        x = x + params["pos_dec"][min(pos, pmax - 1)][None, None]
    b = x.shape[0]
    valid = (pos + 1).to(torch.int32) if torch.is_tensor(pos) else pos + 1
    for i, p in enumerate(unstack(params["dec"])):
        x = x + L.attention_decode(p["attn"], L.rms_norm(x, p["ln1"]), cache["k"][i],
                                   cache["v"][i], pos, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, theta=1e4,
                                   valid=valid, kernels=kernels,
                                   constrain=sharder.constrain)
        h = L.rms_norm(x, p["ln_x"])
        q = split_dim(h @ p["xattn"]["wq"], 2, (cfg.n_heads, cfg.head_dim))
        o = chunked_attention(q.transpose(1, 2), cache["xk"][i], cache["xv"][i], causal=False)
        x = x + sharder.constrain(o.transpose(1, 2).reshape(b, 1, cfg.q_dim)
                                  @ p["xattn"]["wo"], "act_resid")
        x = x + L.mlp_block(p["mlp"], L.rms_norm(x, p["ln2"]), act="gelu", kernels=kernels,
                            constrain=sharder.constrain)
    x = L.rms_norm(x, params["final_norm"])
    return (x @ params["embed"].T)[:, 0], cache
