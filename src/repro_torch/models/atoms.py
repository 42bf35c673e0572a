"""Lowerable training atomics: capture boundaries for the model building
blocks, so a traced training step keeps its MLP / SwiGLU / attention
blocks -- in BOTH directions -- as single recognisable graph nodes, the
counterparts of `repro/models/atoms.py`.

Each atom is an `atomic_vjp` pair (core/trace.py): the forward is the
kernels' plain oracle (`ref.mlp_ref` / `ref.mlp_swiglu_ref`), the backward
the matching oracle backward (`ref.mlp_bwd_ref` / `ref.mlp_swiglu_bwd_ref`,
the recompute-multicast math the kernels run).  Their `lower=` hints let
the `lower_kernels` pass bind the nodes to the kernels (`fused_mlp_fwd` /
`fused_mlp_swiglu_fwd` forward, `fused_mlp_bwd` / `fused_mlp_swiglu_bwd`
backward); unlowered execution replays the oracles, so the two paths are
numerically interchangeable.  (The models' own MLP blocks call the kernel
ops, which the capture already keeps whole; the atoms give the same
boundary with the reference's oracle semantics.)

Attention stays a single node per direction too.  Its backward is an
explicit flash-style recompute written in torch ops -- per KV chunk the
scores, P, dV, dP, dS, dQ and dK -- because an op's body runs below
autograd and cannot differentiate the forward.  No attention-backward
kernel exists, so lowering records a fallback reason and the recompute
runs on the plain path.

`dataflow_training()` installs the atoms over `layers.mlp_block` and both
`chunked_attention` entry points for the duration of a trace:

    with atoms.dataflow_training():
        app = repro_torch.compile(step_fn, (state, batch), mode="kitsune")
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from ..core.trace import atomic, atomic_vjp, attention_flops
from ..kernels import ref
from ..kernels.ops import mlp_flops
from . import encdec, layers, lm

# the model's attention as imported, before any dataflow_training() patch
_CHUNKED_ATTENTION = lm.chunked_attention


def _flatten2(x):
    return x.reshape(-1, x.shape[-1])


# ---------------------------------------------------------------------------
# MLP / SwiGLU atoms (one per activation)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def mlp_atom(act: str):
    """(x, w1, w2) -> act(x @ w1) @ w2 as a differentiable atomic pair."""
    def fwd(x, w1, w2):
        y = ref.mlp_ref(_flatten2(x), w1, w2, act=act)
        return y.reshape(*x.shape[:-1], w2.shape[1])

    def bwd(x, w1, w2, dy):
        dx, dw1, dw2 = ref.mlp_bwd_ref(_flatten2(x), w1, w2, _flatten2(dy), act=act)
        return dx.reshape(x.shape), dw1, dw2

    return atomic_vjp(fwd, bwd, "matmul", name=f"mlp_{act}",
                      flops=lambda i, o: mlp_flops(1, 1)(*i),
                      bwd_flops=lambda i, o: mlp_flops(3, 2, bwd=True)(*i),
                      lower=("mlp_fwd", ("act", act)),
                      bwd_lower=("mlp_bwd", ("act", act)))


@functools.lru_cache(maxsize=None)
def swiglu_atom(act: str = "silu"):
    """(x, wg, wu, wd) -> (act(x @ wg) * (x @ wu)) @ wd as an atomic pair."""
    def fwd(x, wg, wu, wd):
        y = ref.mlp_swiglu_ref(_flatten2(x), wg, wu, wd, act=act)
        return y.reshape(*x.shape[:-1], wd.shape[1])

    def bwd(x, wg, wu, wd, dy):
        dx, dwg, dwu, dwd = ref.mlp_swiglu_bwd_ref(
            _flatten2(x), wg, wu, wd, _flatten2(dy), act=act)
        return dx.reshape(x.shape), dwg, dwu, dwd

    return atomic_vjp(fwd, bwd, "matmul", name=f"swiglu_{act}",
                      flops=lambda i, o: mlp_flops(2, 1)(*i),
                      bwd_flops=lambda i, o: mlp_flops(6, 2, bwd=True)(*i),
                      lower=("swiglu_fwd", ("act", act)),
                      bwd_lower=("swiglu_bwd", ("act", act)))


# ---------------------------------------------------------------------------
# paged decode atom (inference only, no backward)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def paged_decode_atom(block_size: int):
    """(q, kp, vp, tables, valid) -> block-table-native decode attention.

    An inference-only atomic over one site's flat page pools: kp/vp are
    (pages * block_size, n_kv, d) row pools, `tables` the (batch, v_blocks)
    per-slot block table and `valid` the per-slot live lengths.  The
    forward is the gather oracle (`ref.paged_decode_ref`); the `lower=`
    hint binds the node to B8 (`paged_flash_decode`), which reads
    `tables[b, c]` inside the kernel and never materialises the gathered
    view."""
    def fwd(q, kp, vp, tables, valid):
        return ref.paged_decode_ref(q, kp, vp, tables, valid_len=valid,
                                    block_size=block_size)

    def flops(ins, outs):
        b, hq, _, d = ins[0].shape
        return 4.0 * b * hq * ins[3].shape[1] * block_size * d

    return atomic(fwd, "attention", flops=flops, name=f"paged_decode_b{block_size}",
                  lower=("paged_decode", ("block_size", block_size)))


# ---------------------------------------------------------------------------
# attention atom (flash-style recompute backward)
# ---------------------------------------------------------------------------

def chunked_attention_bwd(q, k, v, window, dy, *, causal: bool, chunk: int):
    """(dq, dk, dv) of `lm.chunked_attention(q, k, v, causal, window, chunk)`
    for the cotangent dy, in torch ops without autograd: one pass over the
    KV chunks recomputes the row statistics (m, l) as the forward takes
    them, then a second pass, per chunk, recomputes the scores and
    P = exp(s - m) / l, and forms dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dO * O)), dQ += dS K * scale and dK = dS^T Q * scale
    (grouped over the query heads of each kv head)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    grp = hq // hkv
    qf = q.reshape(b, hkv, grp, sq, d).float()
    do = dy.reshape(b, hkv, grp, sq, d).float()
    if skv > 8192:
        chunk = min(chunk, 512)
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    kf = F.pad(k, (0, 0, 0, pad)).float()
    vf = F.pad(v, (0, 0, 0, pad)).float()
    scale = d ** -0.5
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    n_chunks = (skv + pad) // chunk

    def scores(j):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, j * chunk:(j + 1) * chunk]) * scale
        ki = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = ki < skv
        if causal:
            mask = mask & (qi >= ki)
        mask = mask & ((qi - ki) < window)
        return torch.where(mask, s, lm.NEG_INF)

    m = torch.full((b, hkv, grp, sq, 1), lm.NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, grp, sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, grp, sq, d), device=q.device)
    for j in range(n_chunks):
        s = scores(j)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, j * chunk:(j + 1) * chunk])
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    delta = (do * (acc / l)).sum(-1, keepdim=True)
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        p = torch.exp(scores(j) - m) / l
        dv[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vf[:, :, sl])
        ds = p * (dp - delta)
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kf[:, :, sl]) * scale
        dk[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk[:, :, :skv].to(k.dtype),
            dv[:, :, :skv].to(v.dtype))


@functools.lru_cache(maxsize=None)
def attention_atom(causal: bool, chunk: int):
    """(q, k, v, window) -> chunked attention as a differentiable atomic.

    `window` is an int32 0-d tensor operand (HUGE_WINDOW for none) and gets
    no gradient; the backward node is `chunked_attention_bwd`, one
    flash-recompute node."""
    def fwd(q, k, v, window):
        return _CHUNKED_ATTENTION(q, k, v, causal=causal, window=window, chunk=chunk)

    def bwd(q, k, v, window, dy):
        return chunked_attention_bwd(q, k, v, window, dy, causal=causal, chunk=chunk)

    return atomic_vjp(fwd, bwd, "attention", name=f"attn_c{int(causal)}_k{chunk}",
                      n_diff=3, flops=attention_flops,
                      bwd_flops=lambda i, o: 2 * attention_flops(i, o),
                      lower=("attention_fwd", ("causal", causal)),
                      bwd_lower=("attention_bwd",))


def atomic_chunked_attention(q, k, v, *, causal=True, window=None, chunk=1024):
    """`lm.chunked_attention`'s signature, through `attention_atom`."""
    win = torch.tensor(lm.HUGE_WINDOW if window is None else window,
                       dtype=torch.int32, device=q.device)
    return attention_atom(causal, chunk)(q, k, v, win)


# ---------------------------------------------------------------------------
# capture context
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def patched(attention=None, mlp_block=None):
    """Swap the models' attention (both entry points) and/or MLP block for
    the duration of the context; the originals are restored on exit."""
    saved = (layers.mlp_block, lm.chunked_attention, encdec.chunked_attention)
    if mlp_block is not None:
        layers.mlp_block = mlp_block
    if attention is not None:
        lm.chunked_attention = encdec.chunked_attention = attention
    try:
        yield
    finally:
        layers.mlp_block, lm.chunked_attention, encdec.chunked_attention = saved


def _atomic_mlp_block(p, x, *, act="swiglu", kernels=None, constrain=layers._keep):
    """`layers.mlp_block` through the atoms; `kernels` is not read: a traced
    atom's tile is the lowering pass's (its default or its tuned one)."""
    if act == "swiglu":
        y = swiglu_atom("silu")(x, p["wg"], p["wu"], p["wd"])
    else:
        y = mlp_atom(act)(x, p["w1"], p["w2"])
    return constrain(y, "act_resid")


def dataflow_training():
    """Route the model blocks through the training atoms for the duration
    of a trace: `layers.mlp_block` (dense and encdec MLPs; MoE keeps its
    dispatch path) and both `chunked_attention` entry points.

    The patch is a PROCESS-WIDE module-global swap: enter it only around
    tracing, never around execution, and not while other threads run
    models (a concurrent serve tick would pick up the atoms).
    `compile_train_step` scopes it so."""
    return patched(attention=atomic_chunked_attention, mlp_block=_atomic_mlp_block)
