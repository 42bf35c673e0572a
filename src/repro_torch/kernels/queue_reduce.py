"""Queue-based parallel reduction kernel (paper Fig 2(b), Algorithm 1's
SplitReduction 'final' stage): (N, R, C) -> (R, C) over axis 0.

Replaces `repro/kernels/queue_reduce.py` `queue_reduce` (TPU, Pallas) with
the CUDA kernel in csrc/queue_reduce.cu, which folds the payloads in the
TPU kernel's order (x[0] op x[1] op ... in f32, then one cast), so that it
equals `sequential_fold` bit for bit.  A CPU tensor runs the plain version;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import REDUCE_OPS

_OPS = {"sum": 0, "max": 1, "min": 2}


@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function(
        "queue_reduce", "repro_queue_reduce",
        [v, v, i, ctypes.c_longlong, i, i, i, i, v])


def tile_candidates(rows: int) -> list[dict]:
    """Autotune grid of queue_reduce: its thread and load-batch geometry
    follows from the output's size and the card in the source, so a grid
    of one, the default."""
    return [{}]


def queue_reduce_plain(x: torch.Tensor, op: str = "sum",
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in torch ops: an f32 fold over axis 0."""
    return REDUCE_OPS[op](x.float()).to(out_dtype or x.dtype)


def sequential_fold(x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x[0] + x[1] + ... in f32, one payload at a time in order, then one
    cast: the TPU kernel's order written out in torch ops, which the kernel
    must equal bit for bit (sum).  A check's oracle; no path runs it."""
    acc = x[0].float()
    for n in range(1, x.shape[0]):
        acc = acc + x[n].float()
    return acc.to(out_dtype or x.dtype)


def queue_reduce(x: torch.Tensor, *, op: str = "sum",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Reduce (N, R, C) -> (R, C) over axis 0 through an f32 accumulator;
    the result has `out_dtype` (default: x's dtype).

    Each payload x[n] is one queue pop folded into the accumulator; only the
    final result is written (BSP writes/reads log-tree intermediates)."""
    _build.refuse_capture("queue_reduce", x)
    if op not in _OPS:
        raise ValueError(f"queue_reduce: unknown op {op!r}")
    if x.device.type == "cpu":
        return queue_reduce_plain(x, op, out_dtype)
    in_code = _build.cuda_operands("queue_reduce", x)
    out_dtype = out_dtype or x.dtype
    if x.ndim != 3 or x.shape[0] == 0:
        raise ValueError(f"queue_reduce: want (N>0, R, C), got {tuple(x.shape)}")
    if out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"queue_reduce: out dtype {out_dtype} not supported")
    n, r, c = x.shape
    out = torch.empty((r, c), dtype=out_dtype, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            _kernel()(x.data_ptr(), out.data_ptr(), n, r * c, in_code,
                      _build.DTYPE_CODES[out_dtype], _OPS[op], _build.sm_count(x.device),
                      _build.stream_of(x))
        queue_reduce.launches += 1
    return out


queue_reduce.launches = 0
