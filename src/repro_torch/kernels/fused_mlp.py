"""Dataflow-fused MLP forward kernels -- the paper's Fig 2(a) pattern.

    Y = act(X @ W1) @ W2                     (fused_mlp_fwd)
    Y = (act(X @ Wg) * (X @ Wu)) @ Wd        (fused_mlp_swiglu_fwd)

Replace `repro/kernels/fused_mlp.py` `fused_mlp_fwd` and
`fused_mlp_swiglu_fwd` (TPU, Pallas) with csrc/fused_mlp.cu.  The (M, H)
hidden tensor never reaches HBM: each block builds a (rows, block_h)
hidden chunk in shared memory and multiplies it straight into W2.  When H spans
several chunks the blocks write f32 partials of Y, (n_split, M, Dout), and
`queue_reduce` folds them into the output dtype; the csrc header weighs that
traffic against bsp's.

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


@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function("fused_mlp", "repro_fused_mlp_fwd",
                                  [v, v, v, v, v] + [i] * 9 + [v])


def _launch(what: str, x, w1, wu, w2, act: str):
    ws = (w1, w2) if wu is None else (w1, wu, w2)
    code = _build.cuda_operands(what, x, *ws)
    if act not in ACT_CODES:
        raise ValueError(f"{what}: act {act!r} has no kernel implementation")
    if x.ndim != 2 or any(w.ndim != 2 for w in ws):
        raise ValueError(f"{what}: x and weights must be 2-D")
    m, d_in = x.shape
    hdim, d_out = w1.shape[1], w2.shape[1]
    if (w1.shape[0] != d_in or w2.shape[0] != hdim
            or (wu is not None and wu.shape != w1.shape)):
        raise ValueError(f"{what}: shapes do not chain: x {tuple(x.shape)}, "
                         f"weights {[tuple(w.shape) for w in ws]}")
    if min(m, d_in, hdim, d_out) == 0:
        raise ValueError(f"{what}: empty operand")
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


fused_mlp_fwd.launches = 0
fused_mlp_swiglu_fwd.launches = 0
