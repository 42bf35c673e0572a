"""Hand-written Hopper kernels (csrc/*.cu) with their PyTorch wrappers,
plain versions and launch counters.

Each wrapper is also a `torch.library` custom op (kernels/ops.py,
`torch.ops.repro_torch.*`), which is how the models and the capture
front-end reach it.  `KernelConfig` holds the launches' run-time knobs;
`autotune`, `time_fn` and `tune_cache` (kernels/autotune.py) search them.

`launch_counts()` reads, and `reset_launch_counts()` zeroes, the per-kernel
counters: each wrapper adds one where it launches its CUDA kernel and
nowhere else, so a run can show which kernels its path went through.
`launches_by_rows(name)` splits a backward kernel's count by the rows of
its input, `launches_by_form(name)` a forward kernel's by the form that
served it ("small_m" or "tiled", `fused_mlp.fwd_form`).

The counters are Python increments, so a CUDA graph replay moves none of
them: the serving engine takes `launch_state()` around a capture, restores
it afterwards (a capture is not a launch), and adds the capture's
`launch_delta` with `add_launches` on every replay.
"""
from .flash_attention import combine_partials, flash_attention, flash_decode
from .fused_mlp import (fused_mlp_bwd, fused_mlp_fwd, fused_mlp_swiglu_bwd,
                        fused_mlp_swiglu_fwd)
from .ops import (KernelConfig, attention, decode_attention, mlp, mlp_bwd,
                  mlp_swiglu, mlp_swiglu_bwd, paged_decode_attention, reduce)
from .autotune import autotune, time_fn, tune_cache
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


def launches_by_form(name: str) -> dict[str, int]:
    return dict(KERNELS[name].launches_by_form)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_rows"):
            fn.launches_by_rows = {}
        if hasattr(fn, "launches_by_form"):
            fn.launches_by_form = {}


def launch_state() -> dict[str, tuple[int, dict, dict]]:
    """Every counter of every kernel: {name: (launches, by rows, by form)}."""
    return {name: (fn.launches, dict(getattr(fn, "launches_by_rows", {})),
                   dict(getattr(fn, "launches_by_form", {})))
            for name, fn in KERNELS.items()}


def launch_delta(before: dict, after: dict) -> dict[str, tuple[int, dict, dict]]:
    """What the counters moved from `before` to `after` (launch_state()s),
    for the kernels that moved."""
    def sub(a: dict, b: dict) -> dict:
        return {k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
    return {name: (a[0] - before[name][0], sub(a[1], before[name][1]),
                   sub(a[2], before[name][2]))
            for name, a in after.items() if a[0] != before[name][0]}


def add_launches(delta: dict) -> None:
    """Count one more run of what `delta` (a launch_delta) launched."""
    for name, (n, rows, forms) in delta.items():
        fn = KERNELS[name]
        fn.launches += n
        for attr, part in (("launches_by_rows", rows), ("launches_by_form", forms)):
            for k, m in part.items():
                counts = getattr(fn, attr)
                counts[k] = counts.get(k, 0) + m


def restore_launches(state: dict) -> None:
    """Set every counter back to `state` (a launch_state())."""
    for name, (n, rows, forms) in state.items():
        fn = KERNELS[name]
        fn.launches = n
        if hasattr(fn, "launches_by_rows"):
            fn.launches_by_rows = dict(rows)
        if hasattr(fn, "launches_by_form"):
            fn.launches_by_form = dict(forms)
