"""Plain-PyTorch oracles for the kernels: the same functions as
`repro.kernels.ref`, written in torch ops.

Products run in float32 on float32 copies of the operands, the counterpart
of the reference's `preferred_element_type=float32`: a product of two bf16
values is exact in float32, so only the summation order differs.  gelu is
the tanh approximation everywhere (`jax.nn.gelu`'s default; torch's default
is the exact erf form, which disagrees).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "silu": F.silu,
    "identity": lambda x: x,
}


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def mlp_ref(x, w1, w2, act: str = "gelu"):
    h = ACTS[act](_dot(x, w1))
    return _dot(h.to(x.dtype), w2).to(x.dtype)


def mlp_swiglu_ref(x, wg, wu, wd, act: str = "silu"):
    h = (ACTS[act](_dot(x, wg)) * _dot(x, wu)).to(x.dtype)
    return _dot(h, wd).to(x.dtype)


_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def _dgelu(x):
    """Closed-form derivative of the tanh-approximated gelu:
    0.5(1 + tanh u) + 0.5 x sech^2(u) u', u = sqrt(2/pi)(x + 0.044715 x^3)."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


# d/dx act(x): the one derivative table of the backward oracles (the CUDA
# kernels' `dact_apply` in csrc/common.cuh holds the same formulas).
DACTS = {
    "relu": lambda x: (x > 0).to(x.dtype),
    "identity": torch.ones_like,
    "gelu": _dgelu,
    "silu": lambda x: torch.sigmoid(x) * (1 + x * (1 - torch.sigmoid(x))),
}


def mlp_bwd_ref(x, w1, w2, dy, act: str = "gelu"):
    """(dx, dw1, dw2) of mlp_ref: the pre-activation is recomputed and feeds
    the dX GEMM and both dW GEMMs (Fig 2c).  `t` and `da` are rounded to x's
    dtype before the GEMMs that consume them; products run in f32 and dW is
    cast to the weight dtype at the end."""
    pre = _dot(x, w1)
    t = ACTS[act](pre)
    dyf = dy.float()
    da = (dyf @ w2.float().T) * DACTS[act](pre)
    da_x = da.to(x.dtype)
    dx = _dot(da_x, w1.T).to(x.dtype)
    dw1 = _dot(x.T, da_x).to(w1.dtype)
    dw2 = (t.to(x.dtype).float().T @ dyf).to(w2.dtype)
    return dx, dw1, dw2


def mlp_swiglu_bwd_ref(x, wg, wu, wd, dy, act: str = "silu"):
    """(dx, dwg, dwu, dwd) of mlp_swiglu_ref, the gated Fig 2c multicast."""
    g, u = _dot(x, wg), _dot(x, wu)
    sg = ACTS[act](g)
    t = (sg * u).to(x.dtype)
    dyf = dy.float()
    dt = dyf @ wd.float().T
    dg = (dt * u * DACTS[act](g)).to(x.dtype)
    du = (dt * sg).to(x.dtype)
    dx = (_dot(dg, wg.T) + _dot(du, wu.T)).to(x.dtype)
    dwg = _dot(x.T, dg).to(wg.dtype)
    dwu = _dot(x.T, du).to(wu.dtype)
    dwd = (t.float().T @ dyf).to(wd.dtype)
    return dx, dwg, dwu, dwd


def _expand_kv(k, v, hq: int):
    hkv = k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    return k, v


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B,Hq,Sq,D), k/v: (B,Hkv,Skv,D); GQA by head repetition; the
    causal mask aligns the ends (decode-friendly)."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k, v = _expand_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def decode_ref(q, k, v, *, valid_len=None, scale=None):
    """q: (B,Hq,1,D); masks cache positions >= valid_len, a scalar or a
    per-sequence (B,) vector."""
    d = q.shape[3]
    s_len = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k, v = _expand_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if valid_len is not None:
        valid = torch.as_tensor(valid_len, device=q.device)
        if valid.ndim == 1:
            valid = valid[:, None, None, None]
        pos = torch.arange(s_len, device=q.device)[None, None, None, :]
        s = torch.where(pos < valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def paged_rows(tables, block_size: int):
    """(B, V) block table -> (B, V*block_size) flat pool-row ids: the logical
    dense-view address map.  Row 0 is the engine's reserved null page, so
    table entries beyond a slot's allocation alias it."""
    b, vb = tables.shape
    offs = torch.arange(block_size, dtype=torch.int64, device=tables.device)
    return (tables.long()[:, :, None] * block_size
            + offs[None, None, :]).reshape(b, vb * block_size)


def paged_decode_ref(q, kp, vp, tables, *, valid_len, block_size: int,
                     layer=None, scale=None):
    """Oracle for paged_flash_decode: gather the dense view through the
    block table, then run `decode_ref`'s math.

    kp/vp: (P, Hkv, D) single-site pools, or (P, G, A, Hkv, D) full pools
    with `layer=(g, a)`."""
    rows = paged_rows(tables, block_size)
    if kp.ndim == 5:
        g_i, a_i = layer
        k, v = kp[rows, g_i, a_i], vp[rows, g_i, a_i]
    else:
        k, v = kp[rows], vp[rows]
    return decode_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                      valid_len=valid_len, scale=scale)


# The float8 KV cache's storage dtype, and the largest magnitude whose
# round-to-nearest-even e4m3 is finite: 448 is the largest finite e4m3, the
# next step (480) is the NaN encoding, and the tie at 464 goes to 448's even
# mantissa.
E4M3 = torch.float8_e4m3fn
E4M3_LIMIT = 464.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x cast to float8_e4m3fn byte for byte as the reference casts it
    (`x.astype(jnp.float8_e4m3fn)`, ml_dtypes): round to nearest even, NaN
    past +-464 and for +-inf.  torch's own cast saturates there to +-448
    instead; the sign of a NaN may differ from the reference's."""
    return torch.where(x.abs() > E4M3_LIMIT, torch.nan, x).to(E4M3)


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast to a KV cache's dtype: every write into a float8 cache or
    page pool goes through `to_e4m3`."""
    return to_e4m3(x) if dtype == E4M3 else x.to(dtype)


REDUCE_OPS = {"sum": lambda x: x.sum(dim=0),
              "max": lambda x: x.amax(dim=0),
              "min": lambda x: x.amin(dim=0)}


def reduce_ref(x, op: str = "sum"):
    return REDUCE_OPS[op](x.float()).to(x.dtype)
