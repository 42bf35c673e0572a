"""Decoder-only LM, dense family: parameters, KV cache and single-token
decode, the counterparts of `repro/models/lm.py`.

Parameters keep the reference's STACKED layout -- `blocks/sub0/attn/wq` of
shape (groups, d_model, q_dim) -- so the reference's `init_params` output
converts with `core.executor.params_from_numpy` unchanged.  Where the
reference scans over layer groups (window and site index traced), decode
here is a Python loop over layers: every site's window and (group, sub-layer)
index are plain ints, so each site without a sliding window runs the decode
kernel (`flash_decode` on a dense cache, `paged_flash_decode` on page
pools), and only real windows (gemma3's local layers) take the grouped
torch path.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import layers as L

HUGE_WINDOW = 1 << 30

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _sub_kinds(cfg: ArchConfig) -> list[str]:
    """Structural kinds of the sub-layers inside one layer group."""
    if cfg.family == "moe":
        if cfg.moe_period == 1:
            return ["moe"]
        return (["dense"] * (cfg.moe_period - 1)) + ["moe"]
    if cfg.family == "hybrid":
        return ["hybrid"]
    if cfg.family == "ssm":
        return [{"m": "mlstm", "s": "slstm"}[c] for c in cfg.block_pattern]
    return ["dense"]  # dense / vlm


def _n_groups(cfg: ArchConfig) -> int:
    period = len(_sub_kinds(cfg))
    assert cfg.n_layers % period == 0, (cfg.name, cfg.n_layers, period)
    return cfg.n_layers // period


def _mlp_act(cfg: ArchConfig) -> str:
    return cfg.act if cfg.act in ("swiglu", "gelu", "relu") else "gelu"


def _check_dense(cfg: ArchConfig) -> None:
    if _sub_kinds(cfg) != ["dense"]:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported (ROADMAP A5/A7)")


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights in the reference's layout and scales (embeddings
    normal * 0.02, projections normal / sqrt(fan-in), norms 1), drawn from a
    `torch.Generator` seeded with `seed` on `device`.  The two frameworks
    draw different numbers from one seed; tests carry the reference's
    weights across with `params_from_numpy` instead."""
    _check_dense(cfg)
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    d, groups = cfg.d_model, _n_groups(cfg)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    params = {"embed": normal((cfg.vocab, d), 0.02),
              "final_norm": torch.ones(d, dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.vocab, d), 0.02)
    sub = {"ln1": torch.ones((groups, d), dtype=dtype, device=device),
           "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, groups=groups,
                                    bias=cfg.qkv_bias, dtype=dtype, device=device),
           "ln2": torch.ones((groups, d), dtype=dtype, device=device),
           "mlp": L.init_mlp(gen, d, cfg.dense_d_ff or cfg.d_ff, groups=groups,
                             act=_mlp_act(cfg), dtype=dtype, device=device)}
    params["blocks"] = {"sub0": sub}
    return params


def layer_schedule(cfg: ArchConfig) -> dict[str, list[list]]:
    """Per-layer sliding windows (HUGE_WINDOW where none) and rope thetas,
    shaped (groups, period) as python lists."""
    n = cfg.n_layers
    if cfg.window_pattern:
        pat = (cfg.window_pattern * ((n // len(cfg.window_pattern)) + 1))[:n]
        win = [cfg.window if c == "L" else HUGE_WINDOW for c in pat]
        theta = [cfg.rope_theta_local if c == "L" else cfg.rope_theta for c in pat]
    else:
        win = [cfg.window or HUGE_WINDOW] * n
        theta = [cfg.rope_theta or 1e4] * n
    period = n // _n_groups(cfg)
    return {"window": [win[i:i + period] for i in range(0, n, period)],
            "theta": [theta[i:i + period] for i in range(0, n, period)]}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """Dense KV cache {"k", "v"}: (groups, attn sites per group, batch,
    Hkv, max_len, D), zeros."""
    _check_dense(cfg)
    if cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(f"{cfg.name}: a {cfg.kv_cache_dtype} KV cache is not ported")
    if dtype is None:
        dtype = DTYPES[cfg.dtype]
    shape = (_n_groups(cfg), 1, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params: dict, token: torch.Tensor, pos, cache: dict,
                cfg: ArchConfig, *, block_tables: torch.Tensor | None = None,
                block_size: int | None = None,
                kv_write_rows: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """token: (B,) ids; pos: the current position (python int), or a
    per-slot (B,) tensor (paged serving: each slot writes and attends at its
    own position).  Returns (logits (B, vocab), cache), the cache's tensors
    updated in place.

    Paged-native mode: when `cache` holds the flat page pools "kp"/"vp"
    ((P, G, A, Hkv, D)) instead of dense views "k"/"v", attention reads and
    writes the pools through `block_tables` (B, V); `kv_write_rows` (B,) is
    the engine's flat pool row for each slot's new K/V."""
    _check_dense(cfg)
    x = L.embed(params["embed"], token[:, None], scale=True).to(params["embed"].dtype)
    sched = layer_schedule(cfg)
    paged = "kp" in cache
    if paged and (block_tables is None or block_size is None or kv_write_rows is None):
        raise ValueError("paged decode needs block_tables, block_size and kv_write_rows")
    valid = (pos + 1).to(torch.int32) if torch.is_tensor(pos) else pos + 1
    blocks = params["blocks"]["sub0"]
    for g in range(_n_groups(cfg)):
        p = _group(blocks, g)
        win = sched["window"][g][0]
        win = None if win >= HUGE_WINDOW else win
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                  theta=sched["theta"][g][0], window=win, valid=valid)
        h = L.rms_norm(x, p["ln1"])
        if paged:
            a = L.attention_decode_paged(p["attn"], h, cache["kp"], cache["vp"],
                                         block_tables, pos, kv_write_rows,
                                         layer=(g, 0), block_size=block_size, **kw)
        else:
            a = L.attention_decode(p["attn"], h, cache["k"][g, 0], cache["v"][g, 0],
                                   pos, **kw)
        x = x + a
        x = x + L.mlp_block(p["mlp"], L.rms_norm(x, p["ln2"]), act=_mlp_act(cfg))
    x = L.rms_norm(x, params["final_norm"])
    table = params.get("unembed", params["embed"])
    return (x @ table.T)[:, 0], cache


def _group(tree: dict, g: int) -> dict:
    """Layer group g's slice of stacked parameters."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g] for k, v in tree.items()}
