"""Shared model layers (functional, explicit param dicts), the dense subset
of `repro/models/layers.py` that single-token decode and the full-sequence
forward need (`_project_qkv` projects and ropes any number of positions).

Parameters keep the reference's layout (wq (d_model, Hq*D), ...), so
`core.executor.params_from_numpy` carries the reference's weights across
unchanged.  Decode updates the KV cache IN PLACE (the reference returns new
arrays): the engines own their caches and rebind nothing.
"""
from __future__ import annotations

import functools
import math

import torch

from ..kernels import (decode_attention as k_decode, mlp as k_mlp,
                       mlp_swiglu as k_mlp_swiglu,
                       paged_decode_attention as k_paged_decode)
from ..kernels.ref import paged_rows

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms / rope / embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


@functools.cache
def _rope_freq(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """theta ** (-i / half) in float32, made once per (theta, width, device):
    a decode step would otherwise rebuild it at every site."""
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) or (S,)."""
    half = x.shape[-1] // 2
    freq = _rope_freq(float(theta), half, x.device)
    ang = positions[..., None].float() * freq                     # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(table: torch.Tensor, ids: torch.Tensor, scale: bool = False) -> torch.Tensor:
    e = table[ids]
    if scale:
        e = e * math.sqrt(table.shape[-1])
    return e


# ---------------------------------------------------------------------------
# attention block (GQA, optional window / qkv-bias)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, *, groups: int, bias: bool = False,
                   dtype=torch.bfloat16, device="cpu") -> dict:
    """Weights of `groups` stacked layers, drawn with the reference's scales
    (normal / sqrt(d_model)) from `gen`, one layer at a time."""
    s = d_model ** -0.5
    shapes = {"wq": (d_model, n_heads * head_dim), "wk": (d_model, n_kv * head_dim),
              "wv": (d_model, n_kv * head_dim), "wo": (n_heads * head_dim, d_model)}
    p = {k: _normal(gen, groups, shape, s, dtype, device) for k, shape in shapes.items()}
    if bias:
        for k, n in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[k] = torch.zeros((groups, n * head_dim), dtype=dtype, device=device)
    return p


def _normal(gen, groups, shape, scale, dtype, device) -> torch.Tensor:
    out = torch.empty((groups, *shape), dtype=dtype, device=device)
    for g in range(groups):
        out[g] = torch.randn(shape, generator=gen, device=device) * scale
    return out


def _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, n_heads, head_dim), positions, theta)
    k = rope(k.reshape(b, s, n_kv, head_dim), positions, theta)
    return q, k, v.reshape(b, s, n_kv, head_dim)


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, n_heads: int, n_kv: int,
                     head_dim: int, theta: float = 1e4, window: int | None = None,
                     valid=None) -> torch.Tensor:
    """Single-token decode with an in-place KV cache update.

    cache_k/v: (B, n_kv, S_max, D).  pos: the current position, a python
    int, or a per-slot (B,) tensor -- the serving engine's position clock:
    each sequence writes its new K/V at its own position and attends to
    exactly its own [0, pos+1) range.  `valid` may carry pos + 1 already
    converted for the kernel.  Sites without a window (`window` None) run
    the decode kernel; windowed ones the grouped torch path.  Returns the
    output."""
    b = x.shape[0]
    s_max = cache_k.shape[2]
    per_slot = torch.is_tensor(pos)
    if per_slot:
        positions = pos.reshape(b, 1)
    else:
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta)
    kc = k[:, 0].to(cache_k.dtype)                          # (B, n_kv, D)
    vc = v[:, 0].to(cache_v.dtype)
    # the write position clamps to the last row, as a dynamic slice update does
    if per_slot:
        wpos = pos.clamp(max=s_max - 1)
        slots = torch.arange(b, device=x.device)
        cache_k[slots, :, wpos] = kc
        cache_v[slots, :, wpos] = vc
    else:
        wpos = min(pos, s_max - 1)
        cache_k[:, :, wpos] = kc
        cache_v[:, :, wpos] = vc
    qh = q.transpose(1, 2)
    if valid is None:
        valid = (pos + 1).to(torch.int32) if per_slot else pos + 1
    if window is None:
        o = k_decode(qh, cache_k, cache_v, valid_len=valid)
    else:
        lo = (valid - window).clamp(min=0) if per_slot else max(0, valid - window)
        o = _grouped_decode(qh, cache_k, cache_v, valid, lo, n_heads=n_heads,
                            n_kv=n_kv, head_dim=head_dim, out_dtype=x.dtype)
    o = o.transpose(1, 2).reshape(b, 1, n_heads * head_dim)
    return o @ p["wo"]


def _grouped_decode(qh, ck, cv, valid, lo, *, n_heads, n_kv, head_dim, out_dtype):
    """Grouped-GQA masked-softmax decode in torch ops, for windowed sites:
    positions outside [lo, valid) score NEG_INF.  qh: (B, Hq, 1, D); ck/cv:
    (B, Hkv, S, D); valid, lo: ints or (B,) tensors.  Returns (B, Hq, 1, D)."""
    b, s_max = qh.shape[0], ck.shape[2]
    qg = qh.reshape(b, n_kv, n_heads // n_kv, head_dim)
    ki = torch.arange(s_max, device=qh.device)
    valid = torch.as_tensor(valid, device=qh.device).reshape(-1, 1)
    lo = torch.as_tensor(lo, device=qh.device).reshape(-1, 1)
    maskv = ((ki[None, :] < valid) & (ki[None, :] >= lo))[:, None, None, :]
    sc = torch.einsum("bhgd,bhsd->bhgs", qg.float(), ck.float()) * head_dim ** -0.5
    sc = torch.where(maskv, sc, torch.full_like(sc, NEG_INF))
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", pr, cv.float()).to(out_dtype)
    return o.reshape(b, n_heads, 1, head_dim)


def attention_decode_paged(p: dict, x: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, tables: torch.Tensor, pos: torch.Tensor,
                           write_rows: torch.Tensor, *, layer: tuple[int, int],
                           block_size: int, n_heads: int, n_kv: int, head_dim: int,
                           theta: float = 1e4, window: int | None = None,
                           valid=None) -> torch.Tensor:
    """Block-table-native decode: K/V live in the flat page pools the whole
    time -- no dense view, no scatter back.

    kp/vp: (P, G, A, Hkv, D) page pools, `layer=(g, a)` this site.  tables:
    (B, V) page ids; pos: (B,) position clock; write_rows: (B,) flat pool
    row for each slot's new K/V (the engine sends inactive slots to the
    null row 0).  The site's rows are written first, then attended, so a
    slot sees its own new token.  Sites without a window read the pools
    through the tables in the paged kernel; windowed ones gather their view
    and run the grouped torch path."""
    b = x.shape[0]
    g_i, a_i = layer
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, pos.reshape(b, 1), theta)
    kp[write_rows, g_i, a_i] = k[:, 0].to(kp.dtype)
    vp[write_rows, g_i, a_i] = v[:, 0].to(vp.dtype)
    qh = q.transpose(1, 2)
    if valid is None:
        valid = (pos + 1).to(torch.int32)
    if window is None:
        o = k_paged_decode(qh, kp, vp, tables, valid_len=valid,
                           block_size=block_size, layer=layer)
    else:
        rows = paged_rows(tables, block_size)
        ck = kp[rows, g_i, a_i].transpose(1, 2)
        cv = vp[rows, g_i, a_i].transpose(1, 2)
        lo = (valid - window).clamp(min=0)
        o = _grouped_decode(qh, ck, cv, valid, lo, n_heads=n_heads, n_kv=n_kv,
                            head_dim=head_dim, out_dtype=x.dtype)
    o = o.transpose(1, 2).reshape(b, 1, n_heads * head_dim)
    return o @ p["wo"]


# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, groups: int,
             act: str = "swiglu", dtype=torch.bfloat16, device="cpu") -> dict:
    s, s_ff = d_model ** -0.5, d_ff ** -0.5
    if act == "swiglu":
        return {"wg": _normal(gen, groups, (d_model, d_ff), s, dtype, device),
                "wu": _normal(gen, groups, (d_model, d_ff), s, dtype, device),
                "wd": _normal(gen, groups, (d_ff, d_model), s_ff, dtype, device)}
    return {"w1": _normal(gen, groups, (d_model, d_ff), s, dtype, device),
            "w2": _normal(gen, groups, (d_ff, d_model), s_ff, dtype, device)}


def mlp_block(p: dict, x: torch.Tensor, *, act: str = "swiglu") -> torch.Tensor:
    """The paper's Fig 2(a) pattern -> the fused MLP kernels; under autograd
    their backward is the Fig 2(c) kernels (kernels/ops.py)."""
    if act == "swiglu":
        return k_mlp_swiglu(x, p["wg"], p["wu"], p["wd"])
    return k_mlp(x, p["w1"], p["w2"], act=act)
