"""Dataflow attention kernel: K/V tiles stream past a running online-softmax
state (m, l, O) -- a 2-deep queue between a QK^T producer stage and a PV
consumer stage.  The (S, S) score matrix never exists in HBM (the BSP
baseline writes it twice).

Replaces `repro/kernels/flash_attention.py` `flash_attention` (TPU, Pallas)
with csrc/flash_attention.cu.  A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises.  (`flash_decode` is not ported yet.)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128


@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function(
        "flash_attention", "repro_flash_attention",
        [v, v, v, v] + [i] * 6 + [ctypes.c_float, i, i, i, v])


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: f32 scores, the causal mask
    start-aligned (query i sees keys <= i), masked scores NEG_INF,
    probabilities rounded to v's dtype before P @ V, a zero normaliser
    read as 1."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if k.shape[1] != hq:
        k = k.repeat_interleave(hq // k.shape[1], dim=1)
        v = v.repeat_interleave(hq // v.shape[1], dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return ((p.to(v.dtype).float() @ v.float()) / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); Hq % Hkv == 0 (query-head
    groups share a kv head), D <= 128."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    code = _build.cuda_operands("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q, k, v must be rank-4 and k, v "
                         "of one shape")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not fit (need equal batch and "
                         f"head dim <= {MAX_HEAD_DIM}, Hq % Hkv == 0)")
    out = torch.empty_like(q)
    if out.numel():
        scale = scale if scale is not None else d ** -0.5
        with torch.cuda.device(q.device):
            _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, skv, d, scale,
                      int(causal), int(window) if window else 0, code,
                      _build.stream_of(q))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
