"""Public forward wrappers around the kernels, the counterparts of
`repro.kernels.ops`: x may carry leading batch dims, which are flattened
for the kernel and restored after.

Each call reaches its kernel's wrapper, which runs the CUDA kernel for CUDA
tensors and the plain version for CPU tensors.  No `_blocks`/`_pad_to`
tiling rule is needed: the Hopper kernels mask their own ragged edges.
Tile sizes follow from dtype and shape inside each wrapper; the reference's
`KernelConfig` knobs come back with the block-size autotuner.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_decode
from .fused_mlp import fused_mlp_fwd, fused_mlp_swiglu_fwd
from .paged_attention import paged_flash_decode
from .queue_reduce import queue_reduce


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
        act: str = "gelu") -> torch.Tensor:
    """act(x @ w1) @ w2; x may have leading batch dims."""
    lead = x.shape[:-1]
    y = fused_mlp_fwd(x.reshape(-1, x.shape[-1]), w1, w2, act=act)
    return y.reshape(*lead, w2.shape[1])


def mlp_swiglu(x: torch.Tensor, wg, wu, wd, *,
               act: str = "silu") -> torch.Tensor:
    lead = x.shape[:-1]
    y = fused_mlp_swiglu_fwd(x.reshape(-1, x.shape[-1]), wg, wu, wd, act=act)
    return y.reshape(*lead, wd.shape[1])


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
