"""Dataflow-fused MLP kernels -- the paper's Fig 2(a) forward and its
Fig 2(c) multicast backward.

    Y = act(X @ W1) @ W2                     (fused_mlp_fwd)
    Y = (act(X @ Wg) * (X @ Wu)) @ Wd        (fused_mlp_swiglu_fwd)
    (dX, dW1, dW2) of the first              (fused_mlp_bwd)
    (dX, dWg, dWu, dWd) of the second        (fused_mlp_swiglu_bwd)

Replace `repro/kernels/fused_mlp.py` `fused_mlp_fwd` and
`fused_mlp_swiglu_fwd` (TPU, Pallas) with csrc/fused_mlp.cu.  The (M, H)
hidden tensor never reaches HBM: each block builds a (rows, block_h)
hidden chunk in shared memory and multiplies it straight into W2.  When H spans
several chunks the blocks write f32 partials of Y, (n_split, M, Dout), and
`queue_reduce` folds them into the output dtype; the csrc header weighs that
traffic against bsp's.

The backward kernels (csrc/fused_mlp_bwd.cu) replace `fused_mlp_bwd` and
`fused_mlp_swiglu_bwd` the same way: the hidden tiles are recomputed from X,
dY and the weights into shared memory; dX comes out as f32 partials over
hidden chunks, each dW as f32 partials over row slices, and `queue_reduce`
folds both in a fixed order.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .queue_reduce import queue_reduce

ACT_CODES = {"identity": 0, "relu": 1, "gelu": 2, "silu": 3}

# Widest hidden chunk per block: the block's rows of it (128 for bf16, 64
# for f32) must fit in shared memory beside the 3-stage staging tiles
# (211 KB for bf16 at 512, 191 KB for f32 at 256, of the 227 KB a block may
# use).
MAX_BLOCK_H = {torch.bfloat16: 512, torch.float32: 256}

# The kernels' function in plain torch ops (the oracles hold the same math:
# f32 products, the hidden tile rounded to x's dtype before the second GEMM).
fused_mlp_fwd_plain = ref.mlp_ref
fused_mlp_swiglu_fwd_plain = ref.mlp_swiglu_ref
fused_mlp_bwd_plain = ref.mlp_bwd_ref
fused_mlp_swiglu_bwd_plain = ref.mlp_swiglu_bwd_ref

# Backward tiles: the dX kernel's hidden chunk (its 64 rows of da, or of dg
# and du, sit in shared memory beside the staging ring: 216 KB for the gated
# bf16 form at 512) and the dW kernel's row slice (t and da, or t, dg and du,
# for that many rows of a 64-wide hidden chunk: 194 KB gated bf16 at 256).
# float32 stages two slots instead of three, and its tiles are 4-byte wide.
BWD_BLOCK_H = {torch.bfloat16: 512, torch.float32: 128}
BWD_BLOCK_M = {torch.bfloat16: 256, torch.float32: 128}


@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function("fused_mlp", "repro_fused_mlp_fwd",
                                  [v, v, v, v, v] + [i] * 9 + [v])


@functools.cache
def _bwd_kernels():
    v, i = ctypes.c_void_p, ctypes.c_int
    dx = _build.kernel_function("fused_mlp_bwd", "repro_fused_mlp_bwd_dx",
                                [v] * 6 + [i] * 8 + [v])
    dw = _build.kernel_function("fused_mlp_bwd", "repro_fused_mlp_bwd_dw",
                                [v] * 8 + [i] * 8 + [v])
    return dx, dw


def _check(what: str, x, w1, wu, w2, act: str, dy=None):
    """Validate the operands of a fused-MLP kernel; returns the dtype code
    and (M, Din, H, Dout)."""
    ws = (w1, w2) if wu is None else (w1, wu, w2)
    extra = () if dy is None else (dy,)
    code = _build.cuda_operands(what, x, *ws, *extra)
    if act not in ACT_CODES:
        raise ValueError(f"{what}: act {act!r} has no kernel implementation")
    if x.ndim != 2 or any(w.ndim != 2 for w in ws + extra):
        raise ValueError(f"{what}: x, weights and dy must be 2-D")
    m, d_in = x.shape
    hdim, d_out = w1.shape[1], w2.shape[1]
    if (w1.shape[0] != d_in or w2.shape[0] != hdim
            or (wu is not None and wu.shape != w1.shape)
            or (dy is not None and dy.shape != (m, d_out))):
        raise ValueError(f"{what}: shapes do not chain: x {tuple(x.shape)}, "
                         f"weights {[tuple(w.shape) for w in ws]}"
                         + ("" if dy is None else f", dy {tuple(dy.shape)}"))
    if min(m, d_in, hdim, d_out) == 0:
        raise ValueError(f"{what}: empty operand")
    return code, (m, d_in, hdim, d_out)


def _launch(what: str, x, w1, wu, w2, act: str):
    code, (m, d_in, hdim, d_out) = _check(what, x, w1, wu, w2, act)
    bh = min(MAX_BLOCK_H[x.dtype], -(-hdim // 128) * 128)
    n_split = -(-hdim // bh)
    if n_split == 1:
        out = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((n_split, m, d_out), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        _kernel()(x.data_ptr(), w1.data_ptr(),
                  None if wu is None else wu.data_ptr(), w2.data_ptr(),
                  out.data_ptr(), m, d_in, hdim, d_out, code,
                  int(wu is not None), ACT_CODES[act], bh, int(n_split == 1),
                  _build.stream_of(x))
    if n_split == 1:
        return out
    return queue_reduce(out, op="sum", out_dtype=x.dtype)


def fused_mlp_fwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
                  act: str = "gelu") -> torch.Tensor:
    """act(x @ w1) @ w2 for 2-D x, the hidden dim streamed through shared
    memory in the widest chunks that fit (MAX_BLOCK_H)."""
    if x.device.type == "cpu":
        return fused_mlp_fwd_plain(x, w1, w2, act)
    y = _launch("fused_mlp", x, w1, None, w2, act)
    fused_mlp_fwd.launches += 1
    return y


def fused_mlp_swiglu_fwd(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                         wd: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """(act(x @ wg) * (x @ wu)) @ wd -- SwiGLU with act=silu; the builder
    graphs' plain gate*up form lowers here with act=identity."""
    if x.device.type == "cpu":
        return fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, act)
    y = _launch("fused_mlp_swiglu", x, wg, wu, wd, act)
    fused_mlp_swiglu_fwd.launches += 1
    return y


def _launch_bwd(what: str, x, w1, wu, w2, dy, act: str):
    """(dx, dw1[, dwu], dw2): both backward kernels, then the folds."""
    code, (m, d_in, hdim, d_out) = _check(what, x, w1, wu, w2, act, dy)
    gated = wu is not None
    dev, f32 = x.device, torch.float32
    bh = min(BWD_BLOCK_H[x.dtype], -(-hdim // 128) * 128)
    n_split = -(-hdim // bh)
    n_ms = -(-m // BWD_BLOCK_M[x.dtype])
    dx = torch.empty((n_split, m, d_in), dtype=f32, device=dev)
    p1 = torch.empty((n_ms, d_in, hdim), dtype=f32, device=dev)
    pu = torch.empty((n_ms, d_in, hdim), dtype=f32, device=dev) if gated else None
    p2 = torch.empty((n_ms, hdim, d_out), dtype=f32, device=dev)
    wu_ptr = wu.data_ptr() if gated else None
    k_dx, k_dw = _bwd_kernels()
    stream = _build.stream_of(x)
    with torch.cuda.device(dev):
        k_dx(x.data_ptr(), w1.data_ptr(), wu_ptr, w2.data_ptr(), dy.data_ptr(),
             dx.data_ptr(), m, d_in, hdim, d_out, code, int(gated),
             ACT_CODES[act], bh, stream)
        k_dw(x.data_ptr(), w1.data_ptr(), wu_ptr, w2.data_ptr(), dy.data_ptr(),
             p1.data_ptr(), None if pu is None else pu.data_ptr(), p2.data_ptr(),
             m, d_in, hdim, d_out, code, int(gated), ACT_CODES[act],
             BWD_BLOCK_M[x.dtype], stream)
    dx = queue_reduce(dx, op="sum", out_dtype=x.dtype)
    dws = [queue_reduce(p1, op="sum", out_dtype=w1.dtype)]
    if gated:
        dws.append(queue_reduce(pu, op="sum", out_dtype=wu.dtype))
    dws.append(queue_reduce(p2, op="sum", out_dtype=w2.dtype))
    return (dx, *dws)


def _count_bwd(fn, x) -> None:
    """One launch of a backward wrapper's kernels, counted in total and by
    x's rows (a model's blocks of one width run at several row counts, as
    whisper's encoder and decoder do)."""
    fn.launches += 1
    fn.launches_by_rows[x.shape[0]] = fn.launches_by_rows.get(x.shape[0], 0) + 1


def fused_mlp_bwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  dy: torch.Tensor, *, act: str = "gelu"):
    """(dx, dw1, dw2) of act(x @ w1) @ w2 for 2-D x and dy: the recomputed
    hidden tile feeds the dX GEMM and both dW GEMMs (Fig 2c)."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, w1, w2, dy, act)
    out = _launch_bwd("fused_mlp_bwd", x, w1, None, w2, dy, act)
    _count_bwd(fused_mlp_bwd, x)
    return out


def fused_mlp_swiglu_bwd(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                         wd: torch.Tensor, dy: torch.Tensor, *, act: str = "silu"):
    """(dx, dwg, dwu, dwd) of (act(x @ wg) * (x @ wu)) @ wd: the gated
    multicast, one recomputed (t, dg, du) tile set per row slice feeding all
    three weight-gradient GEMMs."""
    if x.device.type == "cpu":
        return fused_mlp_swiglu_bwd_plain(x, wg, wu, wd, dy, act)
    out = _launch_bwd("fused_mlp_swiglu_bwd", x, wg, wu, wd, dy, act)
    _count_bwd(fused_mlp_swiglu_bwd, x)
    return out


fused_mlp_fwd.launches = 0
fused_mlp_swiglu_fwd.launches = 0
fused_mlp_bwd.launches = 0
fused_mlp_swiglu_bwd.launches = 0
fused_mlp_bwd.launches_by_rows = {}
fused_mlp_swiglu_bwd.launches_by_rows = {}
