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
served it ("small_m" or "tiled", `fused_mlp.fwd_form`),
`launches_by_fold(name)` a forward kernel's small-M launches by where their
f32 partials were folded ("kernel": inside the launch, "queue_reduce", or
"none": the launch wrote y itself), `launches_by_dtype(name)` a decode
kernel's by its K/V dtype ("bfloat16", "float32" or "float8_e4m3fn").

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


# the counters that split a kernel's launches: by its input rows (the
# backward kernels), by the form that served it and by where the small-M
# form's partials were folded (the MLP forwards), by its K/V dtype (the
# decode kernels)
SPLITS = ("launches_by_rows", "launches_by_form", "launches_by_dtype", "launches_by_fold")


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launches_by_rows(name: str) -> dict[int, int]:
    return dict(KERNELS[name].launches_by_rows)


def launches_by_form(name: str) -> dict[str, int]:
    return dict(KERNELS[name].launches_by_form)


def launches_by_dtype(name: str) -> dict[str, int]:
    return dict(KERNELS[name].launches_by_dtype)


def launches_by_fold(name: str) -> dict[str, int]:
    return dict(KERNELS[name].launches_by_fold)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for attr in SPLITS:
            if hasattr(fn, attr):
                setattr(fn, attr, {})


def launch_state() -> dict[str, tuple]:
    """Every counter of every kernel: {name: (launches, by rows, by form,
    by dtype, by fold)}."""
    return {name: (fn.launches, *(dict(getattr(fn, attr, {})) for attr in SPLITS))
            for name, fn in KERNELS.items()}


def launch_delta(before: dict, after: dict) -> dict[str, tuple]:
    """What the counters moved from `before` to `after` (launch_state()s),
    for the kernels that moved."""
    def sub(a: dict, b: dict) -> dict:
        return {k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
    return {name: (a[0] - before[name][0],
                   *(sub(x, y) for x, y in zip(a[1:], before[name][1:])))
            for name, a in after.items() if a[0] != before[name][0]}


def add_launches(delta: dict) -> None:
    """Count one more run of what `delta` (a launch_delta) launched."""
    for name, (n, *parts) in delta.items():
        fn = KERNELS[name]
        fn.launches += n
        for attr, part in zip(SPLITS, parts):
            for k, m in part.items():
                counts = getattr(fn, attr)
                counts[k] = counts.get(k, 0) + m


def restore_launches(state: dict) -> None:
    """Set every counter back to `state` (a launch_state())."""
    for name, (n, *parts) in state.items():
        fn = KERNELS[name]
        fn.launches = n
        for attr, part in zip(SPLITS, parts):
            if hasattr(fn, attr):
                setattr(fn, attr, dict(part))
