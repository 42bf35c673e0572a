"""Hand-written Hopper kernels (csrc/*.cu) with their PyTorch wrappers,
plain versions and launch counters.

`launch_counts()` reads, and `reset_launch_counts()` zeroes, the per-kernel
counters: each wrapper adds one where it launches its CUDA kernel and
nowhere else, so a run can show which kernels its path went through.
`launches_by_rows(name)` splits a backward kernel's count by the rows of
its input.
"""
from .flash_attention import combine_partials, flash_attention, flash_decode
from .fused_mlp import (fused_mlp_bwd, fused_mlp_fwd, fused_mlp_swiglu_bwd,
                        fused_mlp_swiglu_fwd)
from .ops import (attention, decode_attention, mlp, mlp_bwd, mlp_swiglu,
                  mlp_swiglu_bwd, paged_decode_attention, reduce)
from .paged_attention import paged_flash_decode
from .queue_reduce import queue_reduce

KERNELS = {
    "fused_mlp": fused_mlp_fwd,
    "fused_mlp_swiglu": fused_mlp_swiglu_fwd,
    "fused_mlp_bwd": fused_mlp_bwd,
    "fused_mlp_swiglu_bwd": fused_mlp_swiglu_bwd,
    "flash_attention": flash_attention,
    "flash_decode": flash_decode,
    "paged_flash_decode": paged_flash_decode,
    "queue_reduce": queue_reduce,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launches_by_rows(name: str) -> dict[int, int]:
    return dict(KERNELS[name].launches_by_rows)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_rows"):
            fn.launches_by_rows = {}
