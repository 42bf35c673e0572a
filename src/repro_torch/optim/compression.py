"""Gradient compression for the data-parallel all-reduce, the counterpart
of `repro/optim/compression.py`.

int8 + per-block scales + ERROR FEEDBACK (the residual of each step's
quantization is added back before the next step's compression), which keeps
convergence while cutting the collective's bytes ~4x -- aimed at the slow
axis of a multi-pod mesh.  One process per rank: the collective moves the
int8 codes and the f32 scales (`all_gather_into_tensor`), and every rank
dequantizes and sums them locally.
"""
from __future__ import annotations

import torch

from ..tree import tree_map
from .quantized_state import dequantize_blockwise, quantize_blockwise


def compress_int8(g: torch.Tensor, block: int = 256):
    return quantize_blockwise(g, block)


def decompress_int8(codes, scales, shape):
    return dequantize_blockwise(codes, scales, shape)


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    import torch.distributed as dist
    t = t.reshape(1, *t.shape)
    out = torch.empty((n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def error_feedback_allreduce(grads, residuals, group=None, block: int = 256):
    """Compressed mean-all-reduce over `group` (default: the world) with
    error feedback.  Returns (reduced grads, new residuals).

    Each leaf: e = g + residual; (codes, scales) = Q8(e); residual' = e -
    deQ(codes).  Only the int8 codes and the f32 scales cross the wire
    (~4x fewer bytes than an f32 all_reduce); every rank dequantizes the
    gathered codes and sums them locally, so the reduction is EXACT over the
    quantized values -- the only error is each rank's own quantization,
    which error feedback re-injects next step.
    """
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def leaf(g, r):
        e = g.float() + r
        codes, scales, shape = quantize_blockwise(e, block)
        new_r = e - dequantize_blockwise(codes, scales, shape)
        all_codes = _all_gather(codes, n, group)         # int8 on the wire
        all_scales = _all_gather(scales, n, group)
        vals = all_codes.float() * (all_scales[..., None] / 127.0)
        total = vals.sum(dim=0).reshape(-1)[:e.numel()].reshape(shape)
        return (total / n).to(g.dtype), new_r

    out = tree_map(leaf, grads, residuals)
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
