"""Shared model layers (functional, explicit param dicts), the counterparts
of `repro/models/layers.py`: norms and rope, attention (full-sequence and
single-token, dense cache or page pools), the fused MLP, the MoE block with
capacity routing, the Mamba-style selective SSM (hymba) and the xLSTM
blocks (mLSTM, sLSTM), each recurrent one with its one-step decode form.

Parameters keep the reference's layout (wq (d_model, Hq*D), experts
(E, d_model, d_ff), ...), so `core.executor.params_from_numpy` carries the
reference's weights across unchanged.  Decode updates the KV cache IN PLACE
(the reference returns new arrays): the engines own their caches and rebind
nothing.  The recurrent blocks return their new state; `lm.decode_step`
writes it into the cache in place.

A KV cache may be stored in float8_e4m3fn (`kv_cache_dtype`): every write
into it goes through `kernels.ref.to_cache` (the reference's cast, NaN past
+-464), the decode kernels read it as it is, and the windowed sites read it
as float32.  `kernels` (a `KernelConfig`) is handed to the kernel calls, as
the reference hands its `kernels=` to its ops; the default launches what an
untuned call launches.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..kernels import (KernelConfig, decode_attention as k_decode, mlp as k_mlp,
                       mlp_swiglu as k_mlp_swiglu,
                       paged_decode_attention as k_paged_decode)
from ..distributed.sharding import groupwise, split_dim
from ..kernels._build import capturing
from ..kernels.ref import paged_rows, to_cache

NEG_INF = -1e30


def _keep(t, _kind):
    """The `constrain` of a call without a sharder: the identity."""
    return t


def _write(write, dst: torch.Tensor, src: torch.Tensor, src_dim: dict[int, int],
           index: torch.Tensor | None = None) -> None:
    """write(dst, src, index): an in-place write of src into dst.  Under a
    sharder (dst a DTensor) it runs on every rank's local shards
    (`local_map`): DTensor has no in-place index_put into a sharded tensor.
    src_dim maps each dim of dst that may be sharded to the dim of src that
    lines up with it; src is redistributed to match, and a per-slot index
    (B,) is split with src's dim 0.  A dim of dst that is written at an
    index is never sharded."""
    from ..distributed.sharding import is_dtensor
    if not is_dtensor(dst):
        write(dst, src, index)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    src_pl, idx_pl = [], []
    for pl in dst.placements:
        d = src_dim.get(pl.dim) if isinstance(pl, Shard) else None
        if isinstance(pl, Shard) and d is None:
            raise NotImplementedError(f"an in-place write into a tensor sharded on its "
                                      f"indexed dim {pl.dim}")
        src_pl.append(Replicate() if d is None else Shard(d))
        idx_pl.append(Shard(0) if d == 0 else Replicate())
    mesh = dst.device_mesh
    args, in_pl = [dst, src], [dst.placements, tuple(src_pl)]
    if index is not None:
        if not is_dtensor(index):
            index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim, run_check=False)
        args.append(index)
        in_pl.append(tuple(idx_pl))
    else:
        args.append(None)
        in_pl.append(None)
    local_map(write, out_placements=None, in_placements=tuple(in_pl), device_mesh=mesh,
              redistribute_inputs=True)(*args)


def _put_slots(dst, src, wpos):
    """dst (B, H, S, D)[b, :, wpos[b]] = src[b] (B, H, D) for every slot b."""
    dst[torch.arange(dst.shape[0], device=dst.device), :, wpos] = src


# ---------------------------------------------------------------------------
# norms / rope / embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


_ROPE_FREQ: dict[tuple, torch.Tensor] = {}


def _rope_freq(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """theta ** (-i / half) in float32, made once per (theta, width, device):
    a decode step would otherwise rebuild it at every site.  Under a capture
    (core/trace.py) it is made as graph ops and not kept: a kept fake tensor
    would outlive the capture."""
    key = (theta, half, device)
    freq = _ROPE_FREQ.get(key)
    if freq is None:
        freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
        if not capturing():
            _ROPE_FREQ[key] = freq
    return freq


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
                   dtype=torch.bfloat16, device="cuda") -> dict:
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
    """(groups, *shape) normal * scale in `dtype`, drawn one group at a time
    (and one expert at a time for 3-D expert stacks), so that no float32
    draw larger than one layer's matrix exists: one f32 draw of maverick's
    (128, 5120, 8192) expert stack alone would be 21.5 GB."""
    out = torch.empty((groups, *shape), dtype=dtype, device=device)
    for g in range(groups):
        if len(shape) == 3:
            for e in range(shape[0]):
                out[g, e] = torch.randn(shape[1:], generator=gen, device=device) * scale
        else:
            out[g] = torch.randn(shape, generator=gen, device=device) * scale
    return out


def _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta, constrain=_keep):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(split_dim(q, 2, (n_heads, head_dim)), "act_heads")
    k = constrain(split_dim(k, 2, (n_kv, head_dim)), "act_kv_heads")
    v = constrain(split_dim(v, 2, (n_kv, head_dim)), "act_kv_heads")
    return rope(q, positions, theta), rope(k, positions, theta), v


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, n_heads: int, n_kv: int,
                     head_dim: int, theta: float = 1e4, window: int | None = None,
                     valid=None, kernels: KernelConfig = KernelConfig(),
                     constrain=_keep) -> torch.Tensor:
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
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta, constrain)
    kc = to_cache(k[:, 0], cache_k.dtype)                   # (B, n_kv, D)
    vc = to_cache(v[:, 0], cache_v.dtype)
    # the write position clamps to the last row, as a dynamic slice update does
    rows = {0: 0, 1: 1, 3: 2}          # cache dim -> kc dim
    if per_slot:
        wpos = pos.clamp(max=s_max - 1)
        _write(_put_slots, cache_k, kc, rows, wpos)
        _write(_put_slots, cache_v, vc, rows, wpos)
    else:
        wpos = min(pos, s_max - 1)

        def put(dst, src, _):
            dst[:, :, wpos] = src
        _write(put, cache_k, kc, rows)
        _write(put, cache_v, vc, rows)
    qh = q.transpose(1, 2)
    if valid is None:
        valid = (pos + 1).to(torch.int32) if per_slot else pos + 1
    if window is None:
        o = k_decode(qh, cache_k, cache_v, valid_len=valid, cfg=kernels)
    else:
        lo = (valid - window).clamp(min=0) if per_slot else max(0, valid - window)
        o = _grouped_decode(qh, cache_k, cache_v, valid, lo, n_heads=n_heads,
                            n_kv=n_kv, head_dim=head_dim, out_dtype=x.dtype)
    o = o.transpose(1, 2).reshape(b, 1, n_heads * head_dim)
    return constrain(o @ p["wo"], "act_resid")


def _grouped_decode(qh, ck, cv, valid, lo, *, n_heads, n_kv, head_dim, out_dtype):
    """Grouped-GQA masked-softmax decode in torch ops, for windowed sites:
    positions outside [lo, valid) score NEG_INF.  qh: (B, Hq, 1, D); ck/cv:
    (B, Hkv, S, D), in any dtype (a float8 cache is read as float32);
    valid, lo: ints or (B,) tensors.  Returns (B, Hq, 1, D)."""
    b, s_max = qh.shape[0], ck.shape[2]
    qg = split_dim(qh.reshape(b, n_heads, head_dim), 1, (n_kv, n_heads // n_kv))
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
                           valid=None, kernels: KernelConfig = KernelConfig(),
                           constrain=_keep) -> torch.Tensor:
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
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, pos.reshape(b, 1), theta,
                           constrain)

    def put(dst, src, rows):
        dst[rows, g_i, a_i] = src
    heads = {3: 1, 4: 2}               # pool dim -> new K/V dim
    _write(put, kp, to_cache(k[:, 0], kp.dtype), heads, write_rows)
    _write(put, vp, to_cache(v[:, 0], vp.dtype), heads, write_rows)
    qh = q.transpose(1, 2)
    if valid is None:
        valid = (pos + 1).to(torch.int32)
    if window is None:
        o = k_paged_decode(qh, kp, vp, tables, valid_len=valid,
                           block_size=block_size, layer=layer, cfg=kernels)
    else:
        rows = paged_rows(tables, block_size)
        ck = kp[rows, g_i, a_i].transpose(1, 2)
        cv = vp[rows, g_i, a_i].transpose(1, 2)
        lo = (valid - window).clamp(min=0)
        o = _grouped_decode(qh, ck, cv, valid, lo, n_heads=n_heads, n_kv=n_kv,
                            head_dim=head_dim, out_dtype=x.dtype)
    o = o.transpose(1, 2).reshape(b, 1, n_heads * head_dim)
    return constrain(o @ p["wo"], "act_resid")


# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, groups: int,
             act: str = "swiglu", dtype=torch.bfloat16, device="cuda") -> dict:
    s, s_ff = d_model ** -0.5, d_ff ** -0.5
    if act == "swiglu":
        return {"wg": _normal(gen, groups, (d_model, d_ff), s, dtype, device),
                "wu": _normal(gen, groups, (d_model, d_ff), s, dtype, device),
                "wd": _normal(gen, groups, (d_ff, d_model), s_ff, dtype, device)}
    return {"w1": _normal(gen, groups, (d_model, d_ff), s, dtype, device),
            "w2": _normal(gen, groups, (d_ff, d_model), s_ff, dtype, device)}


def mlp_block(p: dict, x: torch.Tensor, *, act: str = "swiglu",
              kernels: KernelConfig = KernelConfig(), constrain=_keep) -> torch.Tensor:
    """The paper's Fig 2(a) pattern -> the fused MLP kernels; under autograd
    their backward is the Fig 2(c) kernels (kernels/ops.py)."""
    if act == "swiglu":
        y = k_mlp_swiglu(x, p["wg"], p["wu"], p["wd"], cfg=kernels)
    else:
        y = k_mlp(x, p["w1"], p["w2"], act=act, cfg=kernels)
    return constrain(y, "act_resid")


# ---------------------------------------------------------------------------
# MoE block: top-k routing, capacity-based dispatch
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int, *,
             groups: int, act: str = "swiglu", dtype=torch.bfloat16,
             device="cuda") -> dict:
    s, s_ff = d_model ** -0.5, d_ff ** -0.5
    if act == "swiglu":
        experts = {"wg": _normal(gen, groups, (n_experts, d_model, d_ff), s, dtype, device),
                   "wu": _normal(gen, groups, (n_experts, d_model, d_ff), s, dtype, device),
                   "wd": _normal(gen, groups, (n_experts, d_ff, d_model), s_ff, dtype, device)}
    else:
        experts = {"w1": _normal(gen, groups, (n_experts, d_model, d_ff), s, dtype, device),
                   "w2": _normal(gen, groups, (n_experts, d_ff, d_model), s_ff, dtype, device)}
    return {"router": _normal(gen, groups, (d_model, n_experts), s, dtype, device),
            "experts": experts}


def top_k_lowest_first(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last dim, ties
    taken lowest index first as `jax.lax.top_k` takes them (`torch.topk`
    promises no order among ties on the card): a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(tokens, logits, *, n_experts: int, top_k: int, cap: int):
    """Capacity-based dispatch for G token groups at once.

    tokens: (G, T, D); logits: (G, T, E) float32.  Returns (dispatched
    (G, E, C, D), combine info).  Each routing entry's position in its
    expert comes from a cumsum over its group; the (E, C) slot map of token
    indices is scattered and the token vectors gathered, as the reference
    does.  An entry past its expert's capacity is dropped and writes
    nowhere: it is sent to a spare slot that is cut off afterwards.  (The
    reference redirects it to slot (0, 0), where its -1 may overwrite the
    token kept there; ROADMAP C, deliberate differences.)  No host sync:
    every shape follows from (G, T, E, C)."""
    n_groups, n_tok, d = tokens.shape
    gate, eidx = top_k_lowest_first(logits, top_k)                   # (G, T, k)
    gate = torch.softmax(gate, dim=-1)
    flat_e = eidx.reshape(n_groups, n_tok * top_k)
    flat_g = gate.reshape(n_groups, n_tok * top_k)
    flat_t = torch.arange(n_tok * top_k, device=tokens.device) // top_k
    onehot = (flat_e[..., None] == torch.arange(n_experts, device=tokens.device)).to(torch.int32)
    pos_in_e = (onehot.cumsum(dim=1) * onehot).sum(-1) - 1          # (G, T*k)
    keep = pos_in_e < cap
    spare = n_experts * cap
    slot = torch.where(keep, flat_e * cap + pos_in_e, spare)
    slot_tok = torch.full((n_groups, spare + 1), -1, dtype=torch.int64, device=tokens.device)
    slot_tok.scatter_(1, slot, flat_t.expand(n_groups, -1))
    slot_tok = slot_tok[:, :spare]                                   # (G, E*C)
    rows = tokens.gather(1, slot_tok.clamp(min=0)[..., None].expand(-1, -1, d))
    dispatched = torch.where(slot_tok[..., None] >= 0, rows, torch.zeros_like(rows))
    return dispatched.reshape(n_groups, n_experts, cap, d), (slot, flat_g, keep)


def _combine_group(out_e, info, n_tok: int, top_k: int, dtype):
    """Each token's output: the sum over its k routing entries of the gate
    times its expert's output row (0 where the entry was dropped), in `dtype`
    and in entry order, as the reference's scatter-add adds them.  out_e:
    (G, E, C, D)."""
    slot, flat_g, keep = info
    n_groups, n_experts, cap, d = out_e.shape
    gathered = out_e.reshape(n_groups, n_experts * cap, d).gather(
        1, torch.where(keep, slot, 0)[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, torch.zeros_like(gathered))
    gathered = (gathered * flat_g[..., None].to(out_e.dtype)).to(dtype)
    gathered = gathered.reshape(n_groups, n_tok, top_k, d)
    out = torch.zeros((n_groups, n_tok, d), dtype=dtype, device=out_e.device)
    for j in range(top_k):
        out = out + gathered[:, :, j]
    return out


def moe_block(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              act: str = "swiglu", capacity_factor: float = 1.25,
              num_groups: int = 64, constrain=_keep) -> torch.Tensor:
    """Mixture of experts with capacity routing: tokens split into groups,
    each group's routing entries dispatched to per-expert capacity slots
    (overflow drops), the experts computed as batched products over the
    flattened (groups x capacity) rows of each expert, the outputs combined
    by gate.  Every expert runs all its C slots per group, full or empty,
    as in the reference."""
    b, s, d = x.shape
    n_tok = b * s
    # groups: as many as keep at least 4 tokens per expert, at most
    # num_groups, dividing the tokens; C = max(int(T_g * k / E * cf), 1)
    g = min(num_groups, max(1, n_tok // (4 * n_experts)))
    while n_tok % g:
        g -= 1
    cap = max(int(n_tok // g * top_k / n_experts * capacity_factor), 1)
    toks = x.reshape(g, n_tok // g, d)
    logits = (toks @ p["router"]).float()
    dispatched, info = groupwise(
        functools.partial(_dispatch_group, n_experts=n_experts, top_k=top_k, cap=cap),
        4, toks, logits)
    dispatched = constrain(dispatched, "act_grouped_experts")        # (G, E, C, D)
    e = {k: constrain(v, "expert_weights") for k, v in p["experts"].items()}
    flat = dispatched.transpose(0, 1).reshape(n_experts, g * cap, d)
    if act == "swiglu":
        gg = constrain(torch.bmm(flat, e["wg"]), "act_expert_hidden_flat")
        uu = constrain(torch.bmm(flat, e["wu"]), "act_expert_hidden_flat")
        h = (F.silu(gg.float()) * uu.float()).to(x.dtype)
        out_f = torch.bmm(h, e["wd"])
    else:
        h = constrain(torch.bmm(flat, e["w1"]), "act_expert_hidden_flat")
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        out_f = torch.bmm(h, e["w2"])
    out_e = constrain(out_f.reshape(n_experts, g, cap, d).transpose(0, 1),
                      "act_grouped_experts")
    out = groupwise(functools.partial(_combine_group, n_tok=n_tok // g, top_k=top_k,
                                      dtype=x.dtype), 1, out_e, info)
    return constrain(out.reshape(b, s, d), "act_resid")


# ---------------------------------------------------------------------------
# Mamba-style selective SSM block (hymba)
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, d_model: int, d_inner: int, d_state: int, *,
               groups: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """The projections in `dtype`; a_log (-0.5) and d_skip (1) in float32
    whatever the model's dtype, as in the reference."""
    s, s_in = d_model ** -0.5, d_inner ** -0.5
    return {"in_x": _normal(gen, groups, (d_model, d_inner), s, dtype, device),
            "in_z": _normal(gen, groups, (d_model, d_inner), s, dtype, device),
            "w_bcdt": _normal(gen, groups, (d_inner, 2 * d_state + 1), s_in, dtype, device),
            "a_log": torch.full((groups, d_inner, d_state), -0.5, device=device),
            "d_skip": torch.ones((groups, d_inner), device=device),
            "out": _normal(gen, groups, (d_inner, d_model), s_in, dtype, device)}


def mamba_block(p: dict, x: torch.Tensor, *, d_state: int,
                ssm_state: torch.Tensor | None = None, constrain=_keep):
    """Selective SSM h_t = a_t * h_{t-1} + b_t, the state (B, I, state) in
    float32; only (y * z) is cast back before the output projection.

    With `ssm_state` (decode) one recurrence step from it; else the whole
    sequence from a zero state, an explicit loop over S (the reference's
    associative scan computes the same products in another order).
    Returns (y, the last state)."""
    xin = (x @ p["in_x"]).float()                                   # (B, S, I)
    z = F.silu((x @ p["in_z"]).float())
    bcdt = (xin.to(x.dtype) @ p["w_bcdt"]).float()
    b_in, c_out = bcdt[..., :d_state], bcdt[..., d_state:2 * d_state]
    dt = F.softplus(bcdt[..., -1:])                                  # (B, S, 1)
    a = torch.exp(-torch.exp(p["a_log"]) * dt[..., None])           # (B, S, I, state)
    bu = (b_in[..., None, :] * xin[..., None]) * dt[..., None]
    if ssm_state is not None:
        h = a[:, 0] * ssm_state + bu[:, 0]
        hs = h[:, None]
    else:
        h = bu[:, 0]
        steps = [h]
        for t in range(1, x.shape[1]):
            h = a[:, t] * h + bu[:, t]
            steps.append(h)
        hs = torch.stack(steps, dim=1)
    y = torch.einsum("bsid,bsd->bsi", hs, c_out)
    y = y + xin * p["d_skip"]
    return constrain((y * z).to(x.dtype) @ p["out"], "act_resid"), h


# ---------------------------------------------------------------------------
# xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int, *, groups: int,
               proj_factor: float = 2.0, dtype=torch.bfloat16, device="cuda") -> dict:
    d_in = int(d_model * proj_factor)
    s, s_in = d_model ** -0.5, d_in ** -0.5
    shapes = {"up": ((d_model, d_in), s), "wq": ((d_in, d_in), s_in),
              "wk": ((d_in, d_in), s_in), "wv": ((d_in, d_in), s_in),
              "wif": ((d_in, 2 * n_heads), s_in), "down": ((d_in, d_model), s_in),
              "skip_g": ((d_model, d_in), s)}
    return {k: _normal(gen, groups, shape, sc, dtype, device)
            for k, (shape, sc) in shapes.items()}


def mlstm_block(p: dict, x: torch.Tensor, *, n_heads: int, constrain=_keep) -> torch.Tensor:
    """mLSTM, parallel form: C_t = f_t C_{t-1} + i_t v_t k_t^T, h_t = C_t q_t
    / max(|n_t . q_t|, exp(-m_t)), computed as attention weighted by the
    stabilised cumulative log gates."""
    b, s, _ = x.shape
    xi = x @ p["up"]
    d_in = xi.shape[-1]
    hd = d_in // n_heads

    def heads(t):
        return t.reshape(b, s, n_heads, hd).transpose(1, 2)

    q = heads(xi @ p["wq"])
    k = heads(xi @ p["wk"]) / math.sqrt(hd)
    v = heads(xi @ p["wv"])
    gates = (xi @ p["wif"]).float().reshape(b, s, 2, n_heads)
    i_g = gates[:, :, 0].transpose(1, 2)                             # (B, H, S)
    f_g = F.logsigmoid(gates[:, :, 1]).transpose(1, 2)
    cum = torch.cumsum(f_g, dim=-1)
    dmat = cum[..., :, None] - cum[..., None, :] + i_g[..., None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    dmat = torch.where(mask, dmat, -torch.inf)
    m = dmat.amax(dim=-1, keepdim=True)                              # stabiliser
    w = torch.exp(dmat - m)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * w
    norm = torch.maximum(scores.sum(-1, keepdim=True).abs(), torch.exp(-m))
    h = torch.einsum("bhqk,bhkd->bhqd", scores / norm, v.float())
    h = h.transpose(1, 2).reshape(b, s, d_in).to(x.dtype)
    h = h * F.silu(x @ p["skip_g"])
    return constrain(h @ p["down"], "act_resid")


def mlstm_step(p: dict, x: torch.Tensor, n_heads: int, state):
    """One mLSTM recurrence step (decode), the recurrent twin of
    `mlstm_block`.  x: (B, 1, D); state = (C (B, H, hd, hd), n (B, H, hd),
    m (B, H)), float32.  Returns (y (B, 1, D), new state)."""
    c_st, n_st, m_st = state
    b = x.shape[0]
    xi = x[:, 0] @ p["up"]
    d_in = xi.shape[-1]
    hd = d_in // n_heads
    q = (xi @ p["wq"]).reshape(b, n_heads, hd)
    k = (xi @ p["wk"]).reshape(b, n_heads, hd) / math.sqrt(hd)
    v = (xi @ p["wv"]).reshape(b, n_heads, hd)
    gates = (xi @ p["wif"]).float().reshape(b, 2, n_heads)
    i_g, f_g = gates[:, 0], F.logsigmoid(gates[:, 1])
    m_new = torch.maximum(f_g + m_st, i_g)
    f_p = torch.exp(f_g + m_st - m_new)[..., None]
    i_p = torch.exp(i_g - m_new)[..., None]
    kf, vf = k.float(), v.float()
    c_new = f_p[..., None] * c_st + i_p[..., None] * (kf[..., :, None] * vf[..., None, :])
    n_new = f_p * n_st + i_p * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                        torch.exp(-m_new))[..., None]
    h = (num / den).reshape(b, d_in).to(x.dtype)
    h = h * F.silu(x[:, 0] @ p["skip_g"])
    return (h @ p["down"])[:, None], (c_new, n_new, m_new)


def slstm_step_fn(g: torch.Tensor, state):
    """The sLSTM cell: g (B, 4, D) gate pre-activations (i, f, z, o), state
    (c, n, m) float32."""
    c, n, m = state
    i_t, f_t, z_t, o_t = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_t)
    n_new = f_p * n + i_p
    h = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1.0)
    return h, (c_new, n_new, m_new)


def slstm_step(p: dict, x: torch.Tensor, state):
    """One sLSTM step (decode).  x: (B, 1, D)."""
    g = (x[:, 0] @ p["w_gates"]).float().reshape(x.shape[0], 4, -1)
    h, new = slstm_step_fn(g, state)
    return (h.to(x.dtype) @ p["out"])[:, None], new


def init_slstm(gen: torch.Generator, d_model: int, n_heads: int, *, groups: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    s = d_model ** -0.5
    return {"w_gates": _normal(gen, groups, (d_model, 4 * d_model), s, dtype, device),
            "out": _normal(gen, groups, (d_model, d_model), s, dtype, device)}


def slstm_block(p: dict, x: torch.Tensor, *, constrain=_keep) -> torch.Tensor:
    """sLSTM over the sequence: the cell stepped from (0, 0, -1e30), the
    part of xLSTM that does not parallelise over time."""
    b, s, d = x.shape
    gates = (x @ p["w_gates"]).float().reshape(b, s, 4, d)
    state = (torch.zeros((b, d), device=x.device), torch.zeros((b, d), device=x.device),
             torch.full((b, d), NEG_INF, device=x.device))
    hs = []
    for t in range(s):
        h, state = slstm_step_fn(gates[:, t], state)
        hs.append(h)
    return constrain(torch.stack(hs, dim=1).to(x.dtype) @ p["out"], "act_resid")
