"""Decoder-only LM, dense family: parameters, the full-sequence forward
(training), KV cache and single-token decode, the counterparts of
`repro/models/lm.py`.

Parameters keep the reference's STACKED layout -- `blocks/sub0/attn/wq` of
shape (groups, d_model, q_dim) -- so the reference's `init_params` output
converts with `core.executor.params_from_numpy` unchanged.  Where the
reference scans over layer groups (window and site index traced), decode
here is a Python loop over layers: every site's window and (group, sub-layer)
index are plain ints, so each site without a sliding window runs the decode
kernel (`flash_decode` on a dense cache, `paged_flash_decode` on page
pools), and only real windows (gemma3's local layers) take the grouped
torch path.

The forward is a Python loop over layer groups too; with `remat` each
group runs under `torch.utils.checkpoint` (non-reentrant), the counterpart
of the reference's `jax.checkpoint` around its scan body.  Its attention is
`chunked_attention` in torch ops under autograd, as the reference's training
attention is XLA ops outside any Pallas kernel; its MLP blocks run the fused
kernels in both directions (`kernels.ops.mlp_swiglu` / `mlp`).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L

HUGE_WINDOW = 1 << 30
NEG_INF = -1e30

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


# ---------------------------------------------------------------------------
# chunked (flash-style) attention in torch ops
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                      chunk: int = 1024) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  Online softmax over KV
    chunks, GQA computed grouped (q as (B, Hkv, group, Sq, D)), a ragged last
    chunk padded and masked, masked scores NEG_INF, an empty row's
    normaliser read as 1; the causal mask aligns the ends.

    The running max is taken without a gradient: the output does not depend
    on it (it cancels between numerator and normaliser), so its gradient
    path would only add rounding, and autograd would keep every chunk's
    scores for it."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    grp = hq // hkv
    qf = q.reshape(b, hkv, grp, sq, d).float()
    if skv > 8192:
        chunk = min(chunk, 512)   # bound the f32 score tile at long context
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    scale = d ** -0.5
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    w = HUGE_WINDOW if window is None else window
    m = torch.full((b, hkv, grp, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, grp, sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, grp, sq, d), device=q.device)
    for j in range((skv + pad) // chunk):
        kj = k[:, :, j * chunk:(j + 1) * chunk].float()
        vj = v[:, :, j * chunk:(j + 1) * chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kj) * scale
        ki = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = ki < skv
        if causal:
            mask = mask & (qi >= ki)
        mask = mask & ((qi - ki) < w)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.detach().amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).reshape(b, hq, sq, d).to(q.dtype)


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


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _attn(p, x, *, cfg: ArchConfig, positions, theta, window) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = L._project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             positions, theta)
    o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=True, window=window)
    return o.transpose(1, 2).reshape(b, s, cfg.q_dim) @ p["wo"]


def _apply_sub(p, x, *, cfg: ArchConfig, positions, window, theta) -> torch.Tensor:
    """One dense sub-layer: pre-norm attention, then the pre-norm MLP."""
    h = L.rms_norm(x, p["ln1"])
    x = x + _attn(p["attn"], h, cfg=cfg, positions=positions, theta=theta,
                  window=window)
    return x + L.mlp_block(p["mlp"], L.rms_norm(x, p["ln2"]), act=_mlp_act(cfg))


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            remat: bool = False, return_hidden: bool = False) -> torch.Tensor:
    """tokens: (B, S) ids -> logits (B, S, vocab), or with `return_hidden`
    the final-normed hidden states (B, S, D) for the chunked cross entropy
    (train/step.py), which never materializes (B, S, V)."""
    _check_dense(cfg)
    x = L.embed(params["embed"], tokens, scale=True).to(params["embed"].dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    sched = layer_schedule(cfg)
    layers = unstack(params["blocks"]["sub0"])
    for g, p in enumerate(layers):
        fn = functools.partial(_apply_sub, cfg=cfg, positions=positions,
                               window=sched["window"][g][0], theta=sched["theta"][g][0])
        x = checkpoint(fn, p, x, use_reentrant=False) if remat else fn(p, x)
    x = L.rms_norm(x, params["final_norm"])
    if return_hidden:
        return x
    return x @ params.get("unembed", params["embed"]).T


def unstack(tree: dict) -> list[dict]:
    """Stacked (groups, ...) parameters as one dict of views per group,
    through `unbind`: under autograd the groups' gradients are stacked once,
    not each scattered into a zero tensor of the whole stack."""
    flat = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v.unbind(0)

    walk(tree, ())
    n = len(next(iter(flat.values())))
    out = []
    for g in range(n):
        d: dict = {}
        for path, vs in flat.items():
            node = d
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = vs[g]
        out.append(d)
    return out


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
    for g, p in enumerate(unstack(params["blocks"]["sub0"])):
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
