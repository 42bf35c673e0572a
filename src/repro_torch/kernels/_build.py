"""Build the CUDA kernels in csrc/ with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into
`build/repro_torch_kernels/lib<name>-<digest>.so` at the repository root
(listed in .gitignore).  The sources have a plain C interface and include no
PyTorch header, so each builds in seconds.  `<digest>` hashes the sources and
the flags: an edited source builds anew and a stale library is never loaded.
Builds happen at first use (a kernel's first launch, or `build_all()`, which
starts one nvcc per source at once), never at import: the CPU tests import
every module on machines with no CUDA toolkit.

Every pointer and the stream cross as `c_void_p`, every size as a C int (or
`c_longlong` where it may pass 2**31); each entry point returns
`cudaGetLastError()` after its launch, and `kernel_function` raises on a
non-zero code, so a refused launch (too much shared memory, a bad grid)
surfaces at the call instead of as silent garbage.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()


def sources() -> list[str]:
    """Names of the kernel libraries: one per `csrc/*.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every missing library in `names`, one nvcc each, all at once.

    Returns {name: {"seconds": wall time of its nvcc, or 0.0 if it was
    already built, "log": nvcc's stderr (ptxas register/spill report)}}.
    Raises RuntimeError naming the source if any compile fails."""
    nvcc = None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, dict] = {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        try:
            _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            err = f"nvcc timed out after {NVCC_TIMEOUT_S}s\n{err}"
        out[name] = {"seconds": time.perf_counter() - t0, "log": err}
        if proc.returncode == 0:
            os.replace(tmp, path)  # atomic: concurrent builders never see half a file
        else:
            failed.append(f"{name}.cu:\n{err}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return out


def build_all() -> dict[str, dict]:
    """Build every kernel library in parallel (chip_smoke's build phase)."""
    with _lock:
        return build(sources())


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    with _lock:
        build([name])
        return ctypes.CDLL(str(_library_path(name)))


def kernel_function(name: str, symbol: str,
                    argtypes: list) -> Callable[..., None]:
    """The C entry `symbol` of `csrc/<name>.cu` (built and loaded on first
    use) as a callable that raises RuntimeError when the launch fails."""
    lib = _load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err_str = lib.repro_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p

    def launch(*args) -> None:
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol}: CUDA error {rc} "
                               f"({err_str(rc).decode()})")
    return launch


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the decode kernels' K/V may be stored in float8 e4m3 beside a float32 or
# bfloat16 q: the code of such a pair is q's code + 2 (csrc/common.cuh
# DecodeDType)
KV8 = torch.float8_e4m3fn
KV8_CODE_OFFSET = 2


def cuda_operands(what: str, *tensors: torch.Tensor, kv: tuple = ()) -> int:
    """Check that kernel `what` can take these operands -- all on one CUDA
    device, one dtype (float32 or bfloat16), contiguous -- and return the
    dtype's code for the C entry point.  `kv`, the decode kernels' K/V
    operands, share one dtype of their own: the other operands', or
    float8_e4m3fn, which adds KV8_CODE_OFFSET to the code.  Raises
    ValueError otherwise."""
    first = tensors[0]
    for t in tensors + kv:
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {[str(u.device) for u in tensors + kv]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    for group in (tensors, kv):
        if any(t.dtype != group[0].dtype for t in group):
            raise ValueError(f"{what}: operands must share one dtype, "
                             f"got {[u.dtype for u in group]}")
    if first.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: dtype {first.dtype} not supported "
                         f"(float32 or bfloat16)")
    if kv and kv[0].dtype not in (first.dtype, KV8):
        raise ValueError(f"{what}: K/V dtype {kv[0].dtype} not supported beside "
                         f"{first.dtype} (the same, or {KV8})")
    return DTYPE_CODES[first.dtype] + (KV8_CODE_OFFSET if kv and kv[0].dtype == KV8 else 0)


_PROXY = torch._C._TorchDispatchModeKey.PROXY


def capturing() -> bool:
    """Whether a `make_fx` capture (core/trace.py) is recording."""
    return torch._C._get_dispatch_mode(_PROXY) is not None


def refuse_capture(what: str, t: torch.Tensor) -> None:
    """Raise if kernel wrapper `what` is reached under a capture: a fake
    tensor, or an active proxy mode (`make_fx`).  A launch there would run
    nothing, or leave an output with no graph edge; a capture reaches the
    kernels only as their ops (kernels/ops.py)."""
    if capturing() or isinstance(t, FakeTensor):
        raise RuntimeError(f"{what}: a kernel wrapper was called under a capture; "
                           f"call its op (repro_torch.kernels.ops) instead")


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SM count, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
