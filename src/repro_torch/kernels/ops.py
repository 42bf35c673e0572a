"""Public wrappers around the kernels, the counterparts of
`repro.kernels.ops`: x may carry leading batch dims, which are flattened
for the kernel and restored after.

`mlp` and `mlp_swiglu` are differentiable: under autograd they run as
`torch.autograd.Function`s whose forward launches the fused forward kernel
and saves only x and the weights (never the (M, H) hidden tensor), and
whose backward launches the fused backward kernel -- the counterparts of
the reference's custom VJP (ops.py `_fused_mlp`) and of `atoms.swiglu_atom`,
which pairs the gated forward with `mlp_swiglu_bwd_ref`.  Without autograd
(serving, `torch.no_grad()`) they call the forward kernel directly.

Each call reaches its kernel's wrapper, which runs the CUDA kernel for CUDA
tensors and the plain version for CPU tensors.  No `_blocks`/`_pad_to`
tiling rule is needed: the Hopper kernels mask their own ragged edges.
Tile sizes follow from dtype and shape inside each wrapper; the reference's
`KernelConfig` knobs come back with the block-size autotuner.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_decode
from .fused_mlp import (fused_mlp_bwd, fused_mlp_fwd, fused_mlp_swiglu_bwd,
                        fused_mlp_swiglu_fwd)
from .paged_attention import paged_flash_decode
from .queue_reduce import queue_reduce


class FusedMLP(torch.autograd.Function):
    """act(x @ w1) @ w2 for 2-D x: B1 forward, B6 backward."""

    @staticmethod
    def forward(ctx, x, w1, w2, act):
        ctx.act = act
        ctx.save_for_backward(x, w1, w2)
        return fused_mlp_fwd(x, w1, w2, act=act)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2 = ctx.saved_tensors
        return (*fused_mlp_bwd(x, w1, w2, dy.contiguous(), act=ctx.act), None)


class FusedSwiGLU(torch.autograd.Function):
    """(act(x @ wg) * (x @ wu)) @ wd for 2-D x: B2 forward, B7 backward."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd, act):
        ctx.act = act
        ctx.save_for_backward(x, wg, wu, wd)
        return fused_mlp_swiglu_fwd(x, wg, wu, wd, act=act)

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, wd = ctx.saved_tensors
        return (*fused_mlp_swiglu_bwd(x, wg, wu, wd, dy.contiguous(), act=ctx.act),
                None)


def _differentiable(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
        act: str = "gelu") -> torch.Tensor:
    """act(x @ w1) @ w2; x may have leading batch dims."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _differentiable(x2, w1, w2):
        y = FusedMLP.apply(x2, w1, w2, act)
    else:
        y = fused_mlp_fwd(x2, w1, w2, act=act)
    return y.reshape(*lead, w2.shape[1])


def mlp_swiglu(x: torch.Tensor, wg, wu, wd, *,
               act: str = "silu") -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _differentiable(x2, wg, wu, wd):
        y = FusedSwiGLU.apply(x2, wg, wu, wd, act)
    else:
        y = fused_mlp_swiglu_fwd(x2, wg, wu, wd, act=act)
    return y.reshape(*lead, wd.shape[1])


def mlp_bwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
            dy: torch.Tensor, *, act: str = "gelu"):
    """(dx, dw1, dw2) of act(x @ w1) @ w2; x/dy may have leading batch dims."""
    dx, dw1, dw2 = fused_mlp_bwd(x.reshape(-1, x.shape[-1]), w1, w2,
                                 dy.reshape(-1, dy.shape[-1]), act=act)
    return dx.reshape(x.shape), dw1, dw2


def mlp_swiglu_bwd(x: torch.Tensor, wg, wu, wd, dy: torch.Tensor, *,
                   act: str = "silu"):
    """(dx, dwg, dwu, dwd) of (act(x @ wg) * (x @ wu)) @ wd; x/dy may have
    leading batch dims."""
    dx, dwg, dwu, dwd = fused_mlp_swiglu_bwd(
        x.reshape(-1, x.shape[-1]), wg, wu, wd, dy.reshape(-1, dy.shape[-1]), act=act)
    return dx.reshape(x.shape), dwg, dwu, dwd


def attention(q, k, v, *, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, *, valid_len=None) -> torch.Tensor:
    """Single-token attention, q (B, Hq, 1, D) against k/v (B, Hkv, S, D)."""
    return flash_decode(q, k, v, valid_len=valid_len)


def paged_decode_attention(q, kp, vp, tables, *, valid_len, block_size: int,
                           layer=None) -> torch.Tensor:
    """Decode attention straight out of the flat page pools (no dense-view
    gather): kp/vp (P, Hkv, D) or (P, G, A, Hkv, D) + layer=(g, a), tables
    (B, V), valid_len (B,)."""
    return paged_flash_decode(q, kp, vp, tables, valid_len=valid_len,
                              block_size=block_size, layer=layer)


def reduce(x: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """Reduce axis 0 of (N, R, C)."""
    return queue_reduce(x, op=op)
