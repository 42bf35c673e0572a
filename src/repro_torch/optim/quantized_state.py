"""Block-wise int8 quantization for optimizer state (bnb-style), the
counterpart of `repro/optim/quantized_state.py`.

Each contiguous block of `block` values stores int8 codes and one f32
absmax scale: 4.0x -> ~1.03x bytes per value.  Used by
`adamw(state_bits=8)`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class QTensor(NamedTuple):
    """int8 codes (N_pad / block, block), f32 scales (N_pad / block,) and
    the original shape (static)."""
    codes: torch.Tensor
    scales: torch.Tensor
    shape: tuple


def quantize_blockwise(x: torch.Tensor, block: int = 256) -> QTensor:
    shape = tuple(x.shape)
    flat = x.reshape(-1).float()
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(scale == 0.0, 1.0, scale)
    # torch.round, like jnp.round, rounds halves to even
    codes = torch.clamp(torch.round(blocks / scale * 127.0), -127, 127).to(torch.int8)
    return QTensor(codes, scale[:, 0], shape)


def dequantize_blockwise(codes, scales=None, shape=None) -> torch.Tensor:
    if isinstance(codes, QTensor):
        codes, scales, shape = codes
    vals = codes.float() * (scales[:, None] / 127.0)
    n = 1
    for s in shape:
        n *= s
    return vals.reshape(-1)[:n].reshape(shape)
