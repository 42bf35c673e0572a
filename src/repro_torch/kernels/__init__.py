"""Hand-written Hopper kernels (csrc/*.cu) with their PyTorch wrappers,
plain versions and launch counters.

`launch_counts()` reads, and `reset_launch_counts()` zeroes, the per-kernel
counters: each wrapper adds one where it launches its CUDA kernel and
nowhere else, so a run can show which kernels its path went through.
"""
from .flash_attention import combine_partials, flash_attention, flash_decode
from .fused_mlp import fused_mlp_fwd, fused_mlp_swiglu_fwd
from .ops import (attention, decode_attention, mlp, mlp_swiglu,
                  paged_decode_attention, reduce)
from .paged_attention import paged_flash_decode
from .queue_reduce import queue_reduce

KERNELS = {
    "fused_mlp": fused_mlp_fwd,
    "fused_mlp_swiglu": fused_mlp_swiglu_fwd,
    "flash_attention": flash_attention,
    "flash_decode": flash_decode,
    "paged_flash_decode": paged_flash_decode,
    "queue_reduce": queue_reduce,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
