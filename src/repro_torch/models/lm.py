"""Decoder-only LM for the dense, moe, hybrid, ssm and vlm families:
parameters, the full-sequence forward (training), `prefill`, the cache and
single-token decode, the counterparts of `repro/models/lm.py`.

Parameters keep the reference's STACKED layout -- `blocks/sub0/attn/wq` of
shape (groups, d_model, q_dim), one `sub{i}` per sub-layer of a layer group
(llama4's dense + MoE pair, xlstm's mLSTM + sLSTM pair) -- so the
reference's `init_params` output converts with
`core.executor.params_from_numpy` unchanged.  Where the reference scans over
layer groups (window and site index traced), the forward and decode here
are Python loops over groups: every site's window and (group, sub-layer)
index are plain ints, so each attention site without a sliding window runs
the decode kernel (`flash_decode` on a dense cache, `paged_flash_decode` on
page pools), and only real windows (gemma3's local layers) take the grouped
torch path.  The MoE, Mamba and xLSTM blocks are torch ops, as the
reference computes them outside any Pallas kernel.

With `remat` each group runs under `torch.utils.checkpoint`
(non-reentrant), the counterpart of the reference's `jax.checkpoint` around
its scan body.  The forward's attention is `chunked_attention` in torch ops
under autograd, as the reference's training attention is XLA ops outside
any Pallas kernel; its MLP blocks run the fused kernels in both directions
(`kernels.ops.mlp_swiglu` / `mlp`).

`kernels` (a `KernelConfig`, the reference's `kernels=`) reaches every
kernel call of the forward, decode and prefill: the MLP blocks and the
decode attention sites; its default launches what an untuned call does.

The KV cache is stored in the activation dtype, or in float8_e4m3fn where
`cfg.kv_cache_dtype` says so (half the bytes; the reference's capacity
lever): decode and prefill write it through `kernels.ref.to_cache`, the
reference's cast, and the decode kernels read it as it is.  Recurrent
state stays float32 either way.

Decode writes the cache in place.  The recurrent entries (hymba's `ssm`,
xlstm's `mC`/`mn`/`mm` and `sc`/`sn`/`sm`) take the new state only in the
slots `state_mask` selects, the paged engine's active slots.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distributed.sharding import (NULL, is_dtensor, merge_dims, rows_matmul, sharded_entry,
                                    split_dim)
from ..distributed.sharding import pad as pad_dims
from ..kernels import KernelConfig
from ..kernels.ref import E4M3, to_cache
from . import layers as L

HUGE_WINDOW = 1 << 30
NEG_INF = -1e30

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# what a config's `kv_cache_dtype` may say: the activation dtype's cache,
# or float8_e4m3fn
KV_CACHE_DTYPES = ("bfloat16", "float8_e4m3fn")


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
    scores for it.

    On DTensors every rank attends its own queries (`_local_attention`)."""
    if is_dtensor(q):
        return _local_attention(q, k, v, causal=causal, window=window, chunk=chunk)
    return _attend(q, k, v, causal=causal, window=window, chunk=chunk)


def _local_attention(q, k, v, *, causal, window, chunk) -> torch.Tensor:
    """`chunked_attention` of DTensors on every rank's local shards
    (`local_map`): the batch and the query heads split as q's are (the KV
    heads with them), the queries' sequence split as q's is against whole
    keys and values, each rank's queries masked at their global positions
    (the keys' and values' gradients then partial sums over that split).
    DTensor cannot run the chunked attention's einsums on a sequence-split
    q itself: they flatten the split dim (torch 2.11 refuses)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    q_pl, kv_pl, kv_grad = [], [], []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and (p.dim == 0 or p.dim == 1
                                     and k.shape[1] % mesh.size(i) == 0):
            q_pl.append(p)
            kv_pl.append(p)
            kv_grad.append(p)
        elif isinstance(p, Shard) and p.dim == 2:
            q_pl.append(p)
            kv_pl.append(Replicate())
            kv_grad.append(Partial())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    _, offset = compute_local_shape_and_global_offset(tuple(q.shape), mesh, q_pl)
    fn = functools.partial(_attend, causal=causal, window=window, chunk=chunk,
                           q_pos0=k.shape[2] - q.shape[2] + offset[2])
    return local_map(fn, out_placements=(tuple(q_pl),),
                     in_placements=(tuple(q_pl), tuple(kv_pl), tuple(kv_pl)),
                     in_grad_placements=(tuple(q_pl), tuple(kv_grad), tuple(kv_grad)),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _attend(q, k, v, *, causal: bool, window: int | None, chunk: int,
            q_pos0: int | None = None) -> torch.Tensor:
    """The chunked attention of plain tensors; `q_pos0` is the first query's
    position among the keys (by default Skv - Sq: the ends aligned)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    grp = hq // hkv
    qf = split_dim(q, 1, (hkv, grp)).float()
    if skv > 8192:
        chunk = min(chunk, 512)   # bound the f32 score tile at long context
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:
        k = pad_dims(k, (0, 0, 0, pad))
        v = pad_dims(v, (0, 0, 0, pad))
    scale = d ** -0.5
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq if q_pos0 is None else q_pos0)
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
    return merge_dims(acc / l, 1).to(q.dtype)


ATTN_KINDS = ("dense", "moe", "hybrid")


def _init_sub(gen, kind: str, cfg: ArchConfig, groups: int, dtype, device) -> dict:
    d = cfg.d_model
    kw = dict(groups=groups, dtype=dtype, device=device)

    def ones():
        return torch.ones((groups, d), dtype=dtype, device=device)

    p: dict = {"ln1": ones()}
    if kind in ATTN_KINDS:
        p["attn"] = L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                     bias=cfg.qkv_bias, **kw)
        p["ln2"] = ones()
    if kind == "dense":
        p["mlp"] = L.init_mlp(gen, d, cfg.dense_d_ff or cfg.d_ff, act=_mlp_act(cfg), **kw)
    elif kind == "moe":
        p["moe"] = L.init_moe(gen, d, cfg.d_ff, cfg.n_experts, act=_mlp_act(cfg), **kw)
    elif kind == "hybrid":
        p["ln_ssm"] = ones()
        p["ssm"] = L.init_mamba(gen, d, 2 * d, cfg.ssm_state, **kw)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, act=_mlp_act(cfg), **kw)
    elif kind == "mlstm":
        p["mlstm"] = L.init_mlstm(gen, d, cfg.n_heads, **kw)
    elif kind == "slstm":
        p["slstm"] = L.init_slstm(gen, d, cfg.n_heads, **kw)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights in the reference's layout and scales (embeddings
    normal * 0.02, projections normal / sqrt(fan-in), norms 1, Mamba's
    a_log -0.5 and d_skip 1 in float32), drawn from a `torch.Generator`
    seeded with `seed` on `device`.  The two frameworks draw different
    numbers from one seed; tests carry the reference's weights across with
    `params_from_numpy` instead."""
    dtype = DTYPES[cfg.dtype]
    # meta tensors (shapes only, e.g. to resolve shardings) draw nothing
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d, groups = cfg.d_model, _n_groups(cfg)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    params = {"embed": normal((cfg.vocab, d), 0.02),
              "final_norm": torch.ones(d, dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.vocab, d), 0.02)
    params["blocks"] = {f"sub{i}": _init_sub(gen, kind, cfg, groups, dtype, device)
                        for i, kind in enumerate(_sub_kinds(cfg))}
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

def _attn(p, x, *, cfg: ArchConfig, positions, theta, window, sharder=NULL) -> torch.Tensor:
    q, k, v = L._project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             positions, theta, sharder.constrain)
    o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=True, window=window)
    return sharder.constrain(rows_matmul(merge_dims(o.transpose(1, 2), 2), p["wo"]),
                             "act_resid")


def _apply_sub(p, kind: str, x, *, cfg: ArchConfig, positions, window, theta,
               moe_groups: int = 64, moe_cf: float = 1.25,
               kernels: KernelConfig = KernelConfig(), sharder=NULL) -> torch.Tensor:
    """One sub-layer.  dense / moe / hybrid: pre-norm attention (hymba adds
    the Mamba branch on the same input and averages the two), then the
    pre-norm MLP or MoE block; mlstm / slstm: the pre-norm recurrent block."""
    c = sharder.constrain
    if kind in ATTN_KINDS:
        a = _attn(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg, positions=positions,
                  theta=theta, window=window, sharder=sharder)
        if kind == "hybrid":
            ssm_out, _ = L.mamba_block(p["ssm"], L.rms_norm(x, p["ln_ssm"]),
                                       d_state=cfg.ssm_state, constrain=c)
            a = 0.5 * (a + ssm_out)
        x = x + a
        h2 = L.rms_norm(x, p["ln2"])
        if kind == "moe":
            return x + L.moe_block(p["moe"], h2, n_experts=cfg.n_experts, top_k=cfg.top_k,
                                   act=_mlp_act(cfg), capacity_factor=moe_cf,
                                   num_groups=moe_groups, constrain=c)
        return x + L.mlp_block(p["mlp"], h2, act=_mlp_act(cfg), kernels=kernels,
                               constrain=c)
    if kind == "mlstm":
        return x + L.mlstm_block(p["mlstm"], L.rms_norm(x, p["ln1"]), n_heads=cfg.n_heads,
                                 constrain=c)
    if kind == "slstm":
        return x + L.slstm_block(p["slstm"], L.rms_norm(x, p["ln1"]), constrain=c)
    raise ValueError(kind)


def _apply_group(p, x, *, cfg: ArchConfig, positions, windows, thetas, **kw) -> torch.Tensor:
    for i, kind in enumerate(_sub_kinds(cfg)):
        x = _apply_sub(p[f"sub{i}"], kind, x, cfg=cfg, positions=positions,
                       window=windows[i], theta=thetas[i], **kw)
    return x


def _embed_inputs(params, tokens, cfg: ArchConfig, patch_embeds) -> torch.Tensor:
    """Token embeddings (scaled by sqrt(d_model)); for the vlm family the
    patch embeddings (B, vision_tokens, D) are prepended."""
    x = L.embed(params["embed"], tokens, scale=True).to(params["embed"].dtype)
    if cfg.family == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


@sharded_entry
def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            remat: bool = False, return_hidden: bool = False,
            patch_embeds: torch.Tensor | None = None, moe_groups: int = 64,
            moe_cf: float = 1.25, kernels: KernelConfig = KernelConfig(),
            sharder=NULL) -> torch.Tensor:
    """tokens: (B, S_txt) ids -> logits (B, S, vocab), or with
    `return_hidden` the final-normed hidden states (B, S, D) for the chunked
    cross entropy (train/step.py), which never materializes (B, S, V).
    vlm: `patch_embeds` (B, vision_tokens, D) are prepended, S =
    vision_tokens + S_txt.  MoE layers route in `moe_groups` groups at
    capacity factor `moe_cf`.  `sharder` (a distributed.sharding.Sharder,
    its parameters DTensors on its mesh) pins the activations at the
    reference's sites; NULL leaves them where they are."""
    x = _embed_inputs(params, tokens, cfg, patch_embeds)
    b, s, _ = x.shape
    x = sharder.constrain(x, "act_resid")
    positions = torch.arange(s, device=x.device).expand(b, s)
    sched = layer_schedule(cfg)
    for g, p in enumerate(unstack(params["blocks"])):
        fn = functools.partial(_apply_group, cfg=cfg, positions=positions,
                               windows=sched["window"][g], thetas=sched["theta"][g],
                               moe_groups=moe_groups, moe_cf=moe_cf, kernels=kernels,
                               sharder=sharder)
        x = checkpoint(fn, p, x, use_reentrant=False) if remat else fn(p, x)
    x = L.rms_norm(x, params["final_norm"])
    if return_hidden:
        return sharder.constrain(x, "act_resid")
    return sharder.constrain(rows_matmul(x, params.get("unembed", params["embed"]).T),
                             "logits")


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
    """Zeros in the reference's layout: the KV cache "k"/"v" (groups,
    attention sites per group, batch, Hkv, max_len, D) in `dtype` (by
    default, as the reference picks it: e4m3 where `kv_cache_dtype` asks
    for it, else the activation dtype) where the family attends, and float32 recurrent state
    where it recurs -- hymba's "ssm"
    (groups, batch, 2 d_model, ssm_state); xlstm's mLSTM "mC" (groups,
    mLSTM sites, batch, H, hd, hd), "mn" (..., H, hd), "mm" (..., H) and
    sLSTM "sc", "sn", "sm" (groups, sLSTM sites, batch, d_model), the
    stabilisers "mm" / "sm" at -1e30.  xlstm has no "k"/"v"."""
    if dtype is None:
        dtype = E4M3 if cfg.kv_cache_dtype == "float8_e4m3fn" else DTYPES[cfg.dtype]
    groups, kinds = _n_groups(cfg), _sub_kinds(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    cache: dict = {}
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    if n_attn:
        shape = (groups, n_attn, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if "hybrid" in kinds:
        cache["ssm"] = torch.zeros((groups, batch, 2 * cfg.d_model, cfg.ssm_state), **f32)
    n_m = kinds.count("mlstm")
    if n_m:
        hd = 2 * cfg.d_model // cfg.n_heads
        cache["mC"] = torch.zeros((groups, n_m, batch, cfg.n_heads, hd, hd), **f32)
        cache["mn"] = torch.zeros((groups, n_m, batch, cfg.n_heads, hd), **f32)
        cache["mm"] = torch.full((groups, n_m, batch, cfg.n_heads), NEG_INF, **f32)
    n_s = kinds.count("slstm")
    if n_s:
        for name in ("sc", "sn"):
            cache[name] = torch.zeros((groups, n_s, batch, cfg.d_model), **f32)
        cache["sm"] = torch.full((groups, n_s, batch, cfg.d_model), NEG_INF, **f32)
    return cache


def _store(dst: torch.Tensor, new: torch.Tensor, mask: torch.Tensor | None) -> None:
    """Write a recurrent state in place, into the slots `mask` (B,) selects
    (all without a mask); dst and new have the batch first."""
    if mask is not None:
        new = torch.where(mask.reshape(-1, *[1] * (new.dim() - 1)), new, dst)
    dst.copy_(new)


@sharded_entry
def decode_step(params: dict, token: torch.Tensor, pos, cache: dict,
                cfg: ArchConfig, *, moe_cf: float = 1.25, sharder=NULL,
                kernels: KernelConfig = KernelConfig(),
                block_tables: torch.Tensor | None = None,
                block_size: int | None = None,
                kv_write_rows: torch.Tensor | None = None,
                state_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """token: (B,) ids; pos: the current position (python int), or a
    per-slot (B,) tensor (paged serving: each slot writes and attends at its
    own position).  Returns (logits (B, vocab), cache), the cache's tensors
    updated in place.  MoE layers route the B tokens as one group at
    capacity factor `moe_cf`, as the reference decodes.

    Paged-native mode: when `cache` holds the flat page pools "kp"/"vp"
    ((P, G, A, Hkv, D)) instead of dense views "k"/"v", attention reads and
    writes the pools through `block_tables` (B, V); `kv_write_rows` (B,) is
    the engine's flat pool row for each slot's new K/V.  `state_mask` (B,)
    bool: the slots whose recurrent state this step advances (the others
    keep theirs bit for bit); None advances every slot."""
    x = L.embed(params["embed"], token[:, None], scale=True).to(params["embed"].dtype)
    sched = layer_schedule(cfg)
    kinds = _sub_kinds(cfg)
    paged = "kp" in cache
    if paged and (block_tables is None or block_size is None or kv_write_rows is None):
        raise ValueError("paged decode needs block_tables, block_size and kv_write_rows")
    valid = (pos + 1).to(torch.int32) if torch.is_tensor(pos) else pos + 1
    for g, gp in enumerate(unstack(params["blocks"])):
        attn_i = m_i = s_i = 0
        for i, kind in enumerate(kinds):
            p = gp[f"sub{i}"]
            if kind in ATTN_KINDS:
                win = sched["window"][g][i]
                kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                          theta=sched["theta"][g][i],
                          window=None if win >= HUGE_WINDOW else win, valid=valid,
                          kernels=kernels, constrain=sharder.constrain)
                h = L.rms_norm(x, p["ln1"])
                if paged:
                    a = L.attention_decode_paged(p["attn"], h, cache["kp"], cache["vp"],
                                                 block_tables, pos, kv_write_rows,
                                                 layer=(g, attn_i), block_size=block_size, **kw)
                else:
                    a = L.attention_decode(p["attn"], h, cache["k"][g, attn_i],
                                           cache["v"][g, attn_i], pos, **kw)
                attn_i += 1
                if kind == "hybrid":
                    ssm_out, s_new = L.mamba_block(p["ssm"], L.rms_norm(x, p["ln_ssm"]),
                                                   d_state=cfg.ssm_state,
                                                   ssm_state=cache["ssm"][g],
                                                   constrain=sharder.constrain)
                    _store(cache["ssm"][g], s_new, state_mask)
                    a = 0.5 * (a + ssm_out)
                x = x + a
                h2 = L.rms_norm(x, p["ln2"])
                if kind == "moe":
                    f = L.moe_block(p["moe"], h2, n_experts=cfg.n_experts, top_k=cfg.top_k,
                                    act=_mlp_act(cfg), capacity_factor=moe_cf, num_groups=1,
                                    constrain=sharder.constrain)
                else:
                    f = L.mlp_block(p["mlp"], h2, act=_mlp_act(cfg), kernels=kernels,
                                    constrain=sharder.constrain)
                x = x + f
            elif kind == "mlstm":
                names = ("mC", "mn", "mm")
                y, new = L.mlstm_step(p["mlstm"], L.rms_norm(x, p["ln1"]), cfg.n_heads,
                                      tuple(cache[n][g, m_i] for n in names))
                for n, t in zip(names, new):
                    _store(cache[n][g, m_i], t, state_mask)
                m_i += 1
                x = x + y
            elif kind == "slstm":
                names = ("sc", "sn", "sm")
                y, new = L.slstm_step(p["slstm"], L.rms_norm(x, p["ln1"]),
                                      tuple(cache[n][g, s_i] for n in names))
                for n, t in zip(names, new):
                    _store(cache[n][g, s_i], t, state_mask)
                s_i += 1
                x = x + y
    x = L.rms_norm(x, params["final_norm"])
    table = params.get("unembed", params["embed"])
    return sharder.constrain(x @ table.T, "logits")[:, 0], cache


@sharded_entry
def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            max_len: int | None = None, patch_embeds: torch.Tensor | None = None,
            kernels: KernelConfig = KernelConfig(), sharder=NULL) -> tuple[torch.Tensor, dict]:
    """The full-sequence forward, and a cache for decode on the same device:
    the attention cache from the prefix's K/V, re-projected layer by layer
    in one more pass (its MoE layers routed in 8 groups, as the reference's
    pass routes them), then padded to `max_len` (default S + 128) positions.

    As in the reference, the recurrent entries are left at their initial
    state (ROADMAP C, reference caveats).  Positions cover the whole
    sequence, vision tokens included; the reference's pass ropes the text
    positions only and fails on patch embeddings (ROADMAP C, deliberate
    differences)."""
    logits = forward(params, tokens, cfg, patch_embeds=patch_embeds, kernels=kernels,
                     sharder=sharder)
    x = _embed_inputs(params, tokens, cfg, patch_embeds)
    b, s, _ = x.shape
    max_len = max_len or (s + 128)
    cache = init_cache(cfg, b, max_len, device=x.device)
    if "k" not in cache:
        return logits, cache
    positions = torch.arange(s, device=x.device).expand(b, s)
    sched = layer_schedule(cfg)
    kinds = _sub_kinds(cfg)
    for g, gp in enumerate(unstack(params["blocks"])):
        attn_i = 0
        for i, kind in enumerate(kinds):
            p = gp[f"sub{i}"]
            if kind in ATTN_KINDS:
                _, k, v = L._project_qkv(p["attn"], L.rms_norm(x, p["ln1"]), cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim, positions,
                                         sched["theta"][g][i], sharder.constrain)
                cache["k"][g, attn_i, :, :, :s] = to_cache(k.transpose(1, 2), cache["k"].dtype)
                cache["v"][g, attn_i, :, :, :s] = to_cache(v.transpose(1, 2), cache["v"].dtype)
                attn_i += 1
            x = _apply_sub(p, kind, x, cfg=cfg, positions=positions,
                           window=sched["window"][g][i], theta=sched["theta"][g][i],
                           moe_groups=8, moe_cf=1.25, kernels=kernels, sharder=sharder)
    return logits, cache
