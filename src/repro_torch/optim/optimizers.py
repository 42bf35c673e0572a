"""Optimizers (no external deps), the counterparts of
`repro/optim/optimizers.py`: AdamW (f32 or 8-bit block-quantized moments)
and Adafactor (factored second moment) for the configs over 100 B
parameters.

Functional API, over the port's parameter trees (repro_torch.tree):
    opt = adamw(lr); state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params)
The step count is a 0-d int32 tensor on the parameters' device, so the
learning rate and the bias corrections are computed there without a host
round trip.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..tree import leaves, tree_map
from .quantized_state import dequantize_blockwise, quantize_blockwise


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params) -> (new_params, state)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step)
        warm = peak_lr * (step + 1) / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    # scale in the grad's own dtype: an f32 round trip would materialize a
    # full f32 copy of every leaf
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _step0(params) -> torch.Tensor:
    ls = leaves(params)
    return torch.zeros((), dtype=torch.int32, device=ls[0].device if ls else "cpu")


def _unzip(params, out, n: int):
    return [tree_map(lambda _, o: o[i], params, out) for i in range(n)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_bits: int = 32, block: int = 256) -> Optimizer:
    """state_bits=8 stores m and v as int8 codes + per-block f32 scales."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def zero(p):
            # m and v are distinct buffers (never one tensor at two places)
            m = torch.zeros_like(p, dtype=torch.float32)
            v = torch.zeros_like(p, dtype=torch.float32)
            if state_bits == 8:
                return (quantize_blockwise(m, block), quantize_blockwise(v, block))
            return (m, v)
        return OptState(_step0(params), tree_map(zero, params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step

        def upd(p, g, mv):
            m, v = mv
            if state_bits == 8:
                m, v = dequantize_blockwise(m), dequantize_blockwise(v)
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g.square()
            u = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float()
            new_p = (p.float() - lr_t * u).to(p.dtype)
            if state_bits == 8:
                m, v = quantize_blockwise(m, block), quantize_blockwise(v, block)
            return new_p, (m, v)

        new_params, new_inner = _unzip(params, tree_map(upd, params, grads, state.inner), 2)
        return new_params, OptState(step, new_inner)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern) -- factored 2nd moment, O(n + m) state
# ---------------------------------------------------------------------------

def adafactor(lr: float | Callable = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def zero(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return (torch.zeros(p.shape[:-1], **z),                   # row
                        torch.zeros(p.shape[:-2] + p.shape[-1:], **z))    # col
            return torch.zeros(p.shape, **z)
        return OptState(_step0(params), tree_map(zero, params))

    def update(grads, state, params):
        step = state.step + 1
        beta = 1.0 - (step.float() + 1) ** -decay
        lr_t = lr_fn(step)

        def upd(p, g, s):
            g = g.float()
            g2 = g.square() + eps
            if p.ndim >= 2:
                r, c = s
                r = beta * r + (1 - beta) * g2.mean(dim=-1)
                c = beta * c + (1 - beta) * g2.mean(dim=-2)
                denom = (r[..., None] * c[..., None, :]
                         / (r.mean(dim=-1, keepdim=True)[..., None] + eps))
                u = g * torch.rsqrt(denom + eps)
                new_s = (r, c)
            else:
                v = beta * s + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = v
            rms = torch.sqrt(u.square().mean() + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.float() - lr_t * u).to(p.dtype), new_s

        new_params, new_inner = _unzip(params, tree_map(upd, params, grads, state.inner), 2)
        return new_params, OptState(step, new_inner)

    return Optimizer(init, update)
