"""The control's precision: a matrix product whose operands are rounded to
float8 e4m3 (each row of the activations and each column of the weights
scaled to e4m3's largest value, 448, first), accumulated in float32.  This
is the step below the bfloat16 that the configurations state, the step a
float8 GEMM would take."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def to_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to e4m3 with one scale per slice along `dim`, returned
    in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with both operands in e4m3."""
    return to_e4m3(x.float(), -1) @ to_e4m3(w.float(), 0)
