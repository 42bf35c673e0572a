#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each failing the run on any error (no phase's exception is caught):
  1. the card's name, power limit and count;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version at the shapes the
     main path gives it, in bf16 and f32, and time kernel, plain version,
     a one-call PyTorch yardstick (never used by the port) and the bound;
  4. the Llama3-8B challenge app at full width (d=4096, ff=14336, 32 heads
     of 128, vocab 128256, seq 2048, batch 4, its 2 layers + LM head, bf16
     weights from a seed; hkv=hq because the graph models GQA without
     materializing it) through `repro_torch.compile` in bsp, vertical and
     kitsune modes, twice each: every mode is held to an f32 run of the
     same graph and weights (MODEL_TOL), the second run must build nothing,
     and each kitsune run must launch fused_mlp_swiglu and flash_attention
     exactly twice;
  5. nerf, dlrm, mgn and graphcast at their published sizes, kitsune
     against bsp, with fused_mlp launched once per lowered site;
  6. a split-reduction graph, x (2048, 1024, 256) bf16 -> x*x -> sum over
     axis 0, kitsune (queue_reduce) against bsp;
  7. serving: phi3-medium-14b at full width and depth (40 layers, bf16
     weights from a seed, 29.3 GB) behind `PagedServingEngine`, 16 requests
     through 8 slots with chunked prefill, slot refill and prefix hits: the
     native tick must launch paged_flash_decode and fused_mlp_swiglu exactly
     40 times per decode step, a "gather" run flash_decode as often with
     bitwise-equal tokens, one request served alone by an engine whose KV
     pools are sized by the profiling pass (num_blocks=None, as the
     launcher builds it) must equal its tokens in the batch, and the
     reduced config (f32) must serve the same tokens on the card as on the
     CPU;
  8. training (phase 3 also holds the backward kernels and each autograd
     Function's gradients): gemma3-1b at full width and depth (26 layers,
     1.00 B bf16 parameters from a seed, AdamW, remat, 4 x 2048 tokens) takes
     3 steps on distinct batches and 5 on one repeated batch, where its loss
     must fall, each step launching fused_mlp_swiglu_bwd 26 and
     fused_mlp_swiglu 52 times (forward + remat recompute), with a
     torch.profiler split of one step; whisper-small (12 + 12 layers, 8 x
     1500 stub frames, 448 tokens) takes 3 steps, each launching
     fused_mlp_bwd 24 times (12 at the encoder's rows, 12 at the
     decoder's) and fused_mlp 36 times; the reduced gemma3/whisper
     configs (f32) train the same on the card as on the CPU, and twice
     alike on the card; the training launcher runs gemma3-1b for 4 steps in
     a subprocess and saves its checkpoint.
The launch counters are zeroed just before phase 4 and read just after
phase 6 (the compiler's main path), and zeroed and read around each engine
run of phase 7 (the serving paths) and each full-width run of phase 8
(the training paths).  The second-to-last line is the
per-kernel JSON summary: one row per kernel and main-path shape, its
`launches` taken from the run of the path that row belongs to (for the two
fused_mlp_bwd rows, only that run's launches at the row's input rows), with
every run's own count beside it.  The last line is {"ok": true, "device": ...}.
"""
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# torch.compile's caches stay inside the checkout
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import (TrainConfig, make_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.tree import flatten, leaves  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_plain,  # noqa: E402
                                                 flash_decode_plain)
from repro_torch.kernels.fused_mlp import (MAX_BLOCK_H,  # noqa: E402
                                           fused_mlp_bwd_plain,
                                           fused_mlp_fwd_plain,
                                           fused_mlp_swiglu_bwd_plain,
                                           fused_mlp_swiglu_fwd_plain)
from repro_torch.kernels.ref import DACTS  # noqa: E402
from repro_torch.kernels.paged_attention import paged_flash_decode_plain  # noqa: E402
from repro_torch.kernels.queue_reduce import queue_reduce_plain  # noqa: E402
from repro_torch.kernels.ref import paged_rows  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (PagedKVExecutor, PagedServingEngine,  # noqa: E402
                               ServeConfig, paged_tick)

PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense FLOP/s, H100 SXM
HBM = 3.35e12                                           # B/s
# bf16: 8 mantissa bits, sums of up to 14336 products in another order, and
# hidden tiles rounded to bf16 where the reference rounds too; f32: the
# reference tests' 2e-4.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# ...and, since an elementwise bound loose against small outputs (causal
# attention averages up to 2048 rows of v, so its outputs are ~0.05) could
# miss a skipped tile, a bound on the relative error ||got - want|| / ||want||.
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Whole-model agreement in bf16.  The modes round at different places (bsp
# rounds every op's output to bf16, the kernels keep f32 inside, the
# vertical program lets the compiler keep f32 between fused ops), so
# elementwise bounds would test rounding luck.  Each mode is instead held to
# an f32 run of the same graph and weights: its relative error
# ||out - ref|| / ||ref|| may be at most twice bsp's own (+1e-3), and at
# most MODEL_TOL against bsp itself.
MODEL_TOL = 5e-2
# The backward kernels' bf16 weight gradients against the plain version's
# own spread under reordered sums (see `check`): how many times that spread
# they may differ, and over how many reorderings it is taken.
FLOOR_FACTOR = 2.0
N_REORDER = 3
SOURCES = {
    "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:100"),
    "fused_mlp_swiglu": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                         "src/repro/kernels/fused_mlp.py:124"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:118"),
    "queue_reduce": ("src/repro_torch/kernels/csrc/queue_reduce.cu",
                     "src/repro/kernels/queue_reduce.py:57"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention.py:210"),
    "paged_flash_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:61"),
    "fused_mlp_bwd": ("src/repro_torch/kernels/csrc/fused_mlp_bwd.cu",
                      "src/repro/kernels/fused_mlp.py:318"),
    "fused_mlp_swiglu_bwd": ("src/repro_torch/kernels/csrc/fused_mlp_bwd.cu",
                             "src/repro/kernels/fused_mlp.py:264"),
}
# summary rows: phase-3 case -> (kernel, the path whose run counts its
# launches, the shape its times were taken at[, the kernel's input rows, where
# the path runs it at several: only those launches are the row's])
SUMMARY = {
    "fused_mlp": ("fused_mlp", "compiler", "x (524288, 256) -> 256 -> 256, relu"),
    "fused_mlp_swiglu": ("fused_mlp_swiglu", "compiler",
                         "x (8192, 4096) -> 14336 -> 4096, identity"),
    "flash_attention": ("flash_attention", "compiler", "q/k/v (4, 32, 2048, 128), causal"),
    "queue_reduce": ("queue_reduce", "compiler", "(16, 1024, 256) sum over axis 0"),
    "flash_decode": ("flash_decode", "serve_gather",
                     "q (8, 40, 1, 128), k/v (8, 10, 512, 128), ragged valid"),
    "paged_flash_decode": ("paged_flash_decode", "serve_native",
                           "q (8, 40, 1, 128), pools (8208, 40, 1, 10, 128), "
                           "tables (8, 32)"),
    "fused_mlp_swiglu_decode": ("fused_mlp_swiglu", "serve_native",
                                "x (8, 5120) -> 17920 -> 5120, silu"),
    "fused_mlp_swiglu_train": ("fused_mlp_swiglu", "train_gemma3",
                               "x (8192, 1152) -> 6912 -> 1152, silu"),
    "fused_mlp_swiglu_bwd": ("fused_mlp_swiglu_bwd", "train_gemma3",
                             "x, dy (8192, 1152), 1152 -> 6912 -> 1152, silu"),
    "fused_mlp_bwd": ("fused_mlp_bwd", "train_whisper",
                      "x, dy (12000, 768), 768 -> 3072 -> 768, gelu (encoder)", 8 * 1500),
    "fused_mlp_bwd_dec": ("fused_mlp_bwd", "train_whisper",
                          "x, dy (3584, 768), 768 -> 3072 -> 768, gelu (decoder)", 8 * 448),
}
# phase 7: phi3-medium-14b behind the paged engine
SERVE_ARCH = "phi3-medium-14b"
SERVE_CONFIG = dict(max_len=512, batch=8, block_size=16, prefill_chunk=16,
                    num_blocks=512, max_new_tokens=32)
SERVE_REQUESTS = 16
# phase-3 cases timed with a cold L2 (cuda_ms): the decode kernels, whose
# inputs would otherwise stay cached between timed calls
COLD_CASES = {"flash_decode", "flash_decode_s4096", "paged_flash_decode",
              "fused_mlp_swiglu_decode"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean device milliseconds per call over `reps` calls after one
    warm-up, each call between its own pair of CUDA events.  A sleep kernel
    first holds the device while the host queues every call, so host launch
    time never shows in the events.  With `cold`, a 64 MB write flushes the
    50 MB L2 cache before each call (for inputs that would otherwise stay
    cached between calls, which the serving loop never sees), and at least
    20 calls are timed."""
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold else None
    events = []
    torch.cuda._sleep(100_000_000)
    for _ in range(max(reps, 20) if cold else reps):
        if cold:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / len(events)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise AssertionError(f"shape {tuple(g.shape)} vs {tuple(w.shape)} "
                             f"or non-finite values")
    return ((g - w).norm() / w.norm()).item()


def worst(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / (tol + tol * |want|)):
    the second is <= 1 exactly when allclose(rtol=atol=tol) holds."""
    d = (got.float() - want.float()).abs()
    ratio = d / (tol + tol * want.float().abs())
    return d.max().item(), ratio.max().item()


def check(name: str, got, want, dtype, floors=None) -> tuple[float, float]:
    """(max |got - want|, relative error), raising if either bound of
    `dtype` is broken; for a tuple of outputs (the backward kernels'
    gradients) every output is held and the worst of each is returned.

    `floors`, where given (the backward kernels' weight gradients in
    bfloat16), are the plain version computed again with its contractions
    summed in other orders (see `reordered`).  Those kernels round t, da,
    dg, du to bf16 as the plain version does; an f32 difference of one ulp
    in a hidden value flips its bf16 rounding and moves a whole row of a
    weight gradient by ulp(t) * |dy|, whatever that gradient element's own
    size, so the plain version breaks atol = rtol = 2e-2 against a
    reordering of itself.  There the kernel is held to the plain version's
    own disagreement: its elementwise ratio may be at most FLOOR_FACTOR
    times the worst of the reorderings' (or <= 1), its max |err| at most
    FLOOR_FACTOR times the larger of theirs and one ulp of the largest
    output (the max |err| of either is that output's own rounding: one ulp
    of whichever large element flipped), and the relative-norm bound is
    unchanged."""
    if isinstance(got, tuple):
        errs = [check(f"{name}[{i}]", g, w, dtype,
                      None if floors is None or floors[0][i] is None
                      else [f[i] for f in floors])
                for i, (g, w) in enumerate(zip(got, want))]
        return max(e for e, _ in errs), max(r for _, r in errs)
    tol = TOL[dtype]
    rel = rel_err(got, want)                  # checks shape and finiteness
    err, ratio = worst(got, want, tol)
    err_limit, ratio_limit = math.inf, 1.0
    if floors is not None:
        f_err, f_ratio = (max(v) for v in zip(*(worst(f, want, tol) for f in floors)))
        top = want.float().abs().max().item()
        ulp = torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top)) if top else 0.0
        err_limit = FLOOR_FACTOR * max(f_err, ulp)
        ratio_limit = max(1.0, FLOOR_FACTOR * f_ratio)
        print(f"{name}: max |err| {err:.4g}, ratio {ratio:.3f}; the plain version against "
              f"{len(floors)} reorderings of itself: max |err| {f_err:.4g}, ratio "
              f"{f_ratio:.3f}; limits {err_limit:.4g}, {ratio_limit:.3f}", flush=True)
    if err > err_limit or ratio > ratio_limit or rel > REL_TOL[dtype]:
        raise AssertionError(f"{name}: max |err| {err:.4g} (limit {err_limit:.4g}), "
                             f"elementwise ratio {ratio:.3f} against atol=rtol={tol} "
                             f"(limit {ratio_limit:.3f}), relative error {rel:.3g} "
                             f"(limit {REL_TOL[dtype]})")
    return err, rel


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def kernel_cases(gen, dtype):
    """(name, kernel call, plain call, library call, flops, bytes) at the
    main path's shapes."""
    M, D, H = 8192, 4096, 14336                     # Llama3-8B FFN, batch 4 x 2048
    x = randn(gen, M, D, dtype=dtype)
    wg, wu = (randn(gen, D, H, dtype=dtype, scale=D ** -0.5) for _ in range(2))
    wd = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
    yield ("fused_mlp_swiglu",
           lambda: K.fused_mlp_swiglu_fwd(x, wg, wu, wd, act="identity"),
           lambda: fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "identity"),
           lambda: ((x @ wg) * (x @ wu)) @ wd,
           2.0 * M * D * H * 2 + 2.0 * M * H * D, nbytes(x, wg, wu, wd, x))
    del x, wg, wu, wd
    R, DI, HN = 4096 * 128, 256, 256                 # NeRF: 4096 rays x 128 samples
    x = randn(gen, R, DI, dtype=dtype)
    w1 = randn(gen, DI, HN, dtype=dtype, scale=DI ** -0.5)
    w2 = randn(gen, HN, HN, dtype=dtype, scale=HN ** -0.5)
    yield ("fused_mlp",
           lambda: K.fused_mlp_fwd(x, w1, w2, act="relu"),
           lambda: fused_mlp_fwd_plain(x, w1, w2, "relu"),
           lambda: torch.relu(x @ w1) @ w2,
           2.0 * R * DI * HN + 2.0 * R * HN * HN, nbytes(x, w1, w2, x))
    del x, w1, w2
    B, NH, S, HD = 4, 32, 2048, 128
    q, k, v = (randn(gen, B, NH, S, HD, dtype=dtype) for _ in range(3))
    yield ("flash_attention",
           lambda: K.flash_attention(q, k, v, causal=True),
           lambda: flash_attention_plain(q, k, v, causal=True),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
           4.0 * B * NH * HD * (S * (S + 1) / 2), nbytes(q, k, v, q))
    del q, k, v
    part = randn(gen, 16, 1024, 256, dtype=dtype)     # phase 6's fan-in partials
    yield ("queue_reduce",
           lambda: K.queue_reduce(part),
           lambda: queue_reduce_plain(part),
           lambda: torch.sum(part, dim=0),
           float(part.numel()), nbytes(part) + nbytes(part[0]))
    del part
    # the Llama FFN's f32 partials (one per hidden chunk) folded to the
    # output dtype -- queue_reduce's other main-path shape
    n_split = -(-H // MAX_BLOCK_H[dtype])
    fold = randn(gen, n_split, M, D, dtype=torch.float32)
    yield ("queue_reduce_mlp_fold",
           lambda: K.queue_reduce(fold, out_dtype=dtype),
           lambda: queue_reduce_plain(fold, "sum", dtype),
           lambda: torch.sum(fold, dim=0),
           float(fold.numel()), nbytes(fold) + fold[0].numel() * torch.finfo(dtype).bits // 8)
    del fold
    yield from decode_cases(gen, dtype)
    yield from train_cases(gen, dtype)


def swiglu_bwd_chain(x, wg, wu, wd, dy):
    """The backward of (silu(x @ wg) * (x @ wu)) @ wd as a chain of cuBLAS
    GEMMs and elementwise ops with the hidden tensors through HBM: the
    yardstick (no single PyTorch call computes an MLP backward)."""
    g, u = x @ wg, x @ wu
    sg = F.silu(g)
    dt = dy @ wd.T
    dg, du = dt * u * DACTS["silu"](g), dt * sg
    return (dg @ wg.T + du @ wu.T, x.T @ dg, x.T @ du, (sg * u).T @ dy)


def mlp_bwd_chain(x, w1, w2, dy):
    """The backward of gelu(x @ w1) @ w2 as a cuBLAS chain (see above)."""
    pre = x @ w1
    da = (dy @ w2.T) * DACTS["gelu"](pre)
    return (da @ w1.T, x.T @ da, F.gelu(pre, approximate="tanh").T @ dy)


def reordered(plain, x, ws, dy, gen):
    """N_REORDER times, `plain`'s weight gradients with the rows and the
    input and output features permuted before and the features restored
    after: the same function, every GEMM's f32 sum taken in another order
    (the floors `check` holds those gradients to).  dX, a sum over H of
    small weights times hidden values, keeps the plain elementwise bound:
    its slot is None."""
    *w_in, w_out = ws
    outs = []
    for _ in range(N_REORDER):
        pm = torch.randperm(x.shape[0], generator=gen, device=x.device)
        pi = torch.randperm(x.shape[1], generator=gen, device=x.device)
        po = torch.randperm(dy.shape[1], generator=gen, device=x.device)
        ii, io = torch.argsort(pi), torch.argsort(po)
        _, *dw_in, dw_out = plain(x[pm][:, pi], *(w[pi] for w in w_in), w_out[:, po],
                                  dy[pm][:, po])
        outs.append((None, *(d[ii] for d in dw_in), dw_out[:, io]))
    return outs


def train_cases(gen, dtype):
    """Phase 8's MLP kernels at its shapes: gemma3-1b's FFN over 4 x 2048
    tokens (B2 forward, B7 backward) and whisper-small's over the encoder's
    8 x 1500 and the decoder's 8 x 448 rows (B6).  float32 runs at fewer
    rows.  Operations count the GEMMs the function needs (B7: g, u, dt, two
    for dX, three for dW = 8; B6: pre, dt, one for dX, two for dW = 5), not
    the kernels' own: they recompute g, u and dt (B6: pre and dt) in both of
    their kernels, 11 GEMMs (B6: 7)."""
    D, H = 1152, 6912
    M = 8192 if dtype == torch.bfloat16 else 1024
    x, dy = randn(gen, M, D, dtype=dtype), randn(gen, M, D, dtype=dtype)
    wg, wu = (randn(gen, D, H, dtype=dtype, scale=D ** -0.5) for _ in range(2))
    wd = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
    gemm = 2.0 * M * D * H
    yield ("fused_mlp_swiglu_train",
           lambda: K.fused_mlp_swiglu_fwd(x, wg, wu, wd, act="silu"),
           lambda: fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "silu"),
           lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
           3 * gemm, nbytes(x, wg, wu, wd, x))
    yield ("fused_mlp_swiglu_bwd",
           lambda: K.fused_mlp_swiglu_bwd(x, wg, wu, wd, dy, act="silu"),
           lambda: fused_mlp_swiglu_bwd_plain(x, wg, wu, wd, dy, "silu"),
           lambda: swiglu_bwd_chain(x, wg, wu, wd, dy),
           8 * gemm, 2 * nbytes(x, wg, wu, wd, dy) - nbytes(dy),
           lambda: reordered(lambda *a: fused_mlp_swiglu_bwd_plain(*a, "silu"), x,
                             (wg, wu, wd), dy, gen))
    del x, dy, wg, wu, wd
    D, H = 768, 3072
    for name, rows in (("fused_mlp_bwd", 8 * 1500), ("fused_mlp_bwd_dec", 8 * 448)):
        M = rows if dtype == torch.bfloat16 else rows // 8
        x, dy = randn(gen, M, D, dtype=dtype), randn(gen, M, D, dtype=dtype)
        w1 = randn(gen, D, H, dtype=dtype, scale=D ** -0.5)
        w2 = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
        yield (name,
               lambda: K.fused_mlp_bwd(x, w1, w2, dy, act="gelu"),
               lambda: fused_mlp_bwd_plain(x, w1, w2, dy, "gelu"),
               lambda: mlp_bwd_chain(x, w1, w2, dy),
               5 * 2.0 * M * D * H, 2 * nbytes(x, w1, w2, dy) - nbytes(dy),
               lambda: reordered(lambda *a: fused_mlp_bwd_plain(*a, "gelu"), x, (w1, w2),
                                 dy, gen))
        del x, dy, w1, w2


def function_grads() -> None:
    """Each autograd Function's gradients on the card (forward kernel,
    backward kernel) against torch.autograd of the plain forward, float32,
    at a mid-size shape."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for gated, (M, D, H, act) in ((True, (2048, 1152, 6912, "silu")),
                                  (False, (1500, 768, 3072, "gelu"))):
        ws = [randn(gen, D, H, dtype=torch.float32, scale=D ** -0.5) for _ in range(1 + gated)]
        ws.append(randn(gen, H, D, dtype=torch.float32, scale=H ** -0.5))
        x = randn(gen, M, D, dtype=torch.float32)
        dy = randn(gen, M, D, dtype=torch.float32)
        ins = [t.requires_grad_() for t in (x, *ws)]
        fn, plain = ((K.mlp_swiglu, fused_mlp_swiglu_fwd_plain) if gated
                     else (K.mlp, fused_mlp_fwd_plain))
        before = K.launch_counts()
        got = torch.autograd.grad(fn(*ins, act=act), ins, dy)
        kern = "fused_mlp_swiglu_bwd" if gated else "fused_mlp_bwd"
        if K.launch_counts()[kern] != before[kern] + 1:
            raise AssertionError(f"{kern} was not launched by the Function's backward")
        want = torch.autograd.grad(plain(*ins, act), ins, dy)
        err, rel = check(f"{fn.__name__} grads", tuple(got), tuple(want), torch.float32)
        print(f"function {fn.__name__} ({M}, {D}->{H}->{D}) {act}: gradients vs autograd "
              f"of the plain forward, max |err| {err:.3g}, rel {rel:.3g} (f32)", flush=True)


def decode_cases(gen, dtype):
    """Phase 7's decode kernels at phi3-medium-14b's shapes: 8 slots, 40
    query heads over 10 kv heads of 128, ragged valid lengths.  Bounds
    count the rows the valid lengths cover (what these inputs need)."""
    cfg = get_config(SERVE_ARCH)
    B, HQ, HKV, HD = SERVE_CONFIG["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    esize = torch.finfo(dtype).bits // 8
    rng = np.random.default_rng(5)
    for s_len, name in ((512, "flash_decode"), (4096, "flash_decode_s4096")):
        q = randn(gen, B, HQ, 1, HD, dtype=dtype)
        k, v = (randn(gen, B, HKV, s_len, HD, dtype=dtype) for _ in range(2))
        valid = torch.from_numpy(rng.integers(1, s_len + 1, B).astype(np.int32)).to("cuda")
        mask = (torch.arange(s_len, device="cuda")[None, :] < valid[:, None])[:, None, None, :]
        rows = int(valid.clamp(max=s_len).sum())
        yield (name,
               lambda: K.flash_decode(q, k, v, valid_len=valid),
               lambda: flash_decode_plain(q, k, v, valid_len=valid),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True),
               4.0 * rows * HQ * HD, 2 * nbytes(q) + 2 * rows * HKV * HD * esize)
        del q, k, v
    # the engine's pool layout (P, G=40, A=1, Hkv, D) and block tables: each
    # slot owns distinct pages up to its valid length, the null page after
    bs, n_blocks = SERVE_CONFIG["block_size"], SERVE_CONFIG["num_blocks"]
    v_blocks = SERVE_CONFIG["max_len"] // bs
    pool = ((n_blocks + 1) * bs, cfg.n_layers, 1, HKV, HD)
    kp, vp = randn(gen, *pool, dtype=dtype), randn(gen, *pool, dtype=dtype)
    q = randn(gen, B, HQ, 1, HD, dtype=dtype)
    valid_np = rng.integers(1, v_blocks * bs + 1, B)
    tables_np = rng.permutation(np.arange(1, n_blocks + 1))[:B * v_blocks].reshape(B, v_blocks)
    tables_np[np.arange(v_blocks)[None, :] >= -(-valid_np // bs)[:, None]] = 0
    tables = torch.from_numpy(tables_np.astype(np.int32)).to("cuda")
    valid = torch.from_numpy(valid_np.astype(np.int32)).to("cuda")
    layer = (cfg.n_layers - 1, 0)
    got = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs, layer=layer)
    rows_idx = paged_rows(tables, bs)
    ck = kp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
    cv = vp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
    if not torch.equal(got, K.flash_decode(q, ck, cv, valid_len=valid, block_s=256)):
        raise AssertionError(f"paged_flash_decode[{dtype}] differs from gather + "
                             f"flash_decode at the same chunk size")
    print(f"paged_flash_decode[{dtype}] bitwise equal to gather + flash_decode", flush=True)
    del ck, cv
    rows = int(valid.sum())
    yield ("paged_flash_decode",
           lambda: K.paged_flash_decode(q, kp, vp, tables, valid_len=valid,
                                        block_size=bs, layer=layer),
           lambda: paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                            block_size=bs, layer=layer),
           None,
           4.0 * rows * HQ * HD,
           2 * nbytes(q) + 2 * rows * HKV * HD * esize + nbytes(tables, valid))
    del kp, vp
    # the FFN at phase 7's decode shape: M = the slot batch
    D, H = cfg.d_model, cfg.d_ff
    x = randn(gen, B, D, dtype=dtype)
    wg, wu = (randn(gen, D, H, dtype=dtype, scale=D ** -0.5) for _ in range(2))
    wd = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
    yield ("fused_mlp_swiglu_decode",
           lambda: K.fused_mlp_swiglu_fwd(x, wg, wu, wd, act="silu"),
           lambda: fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "silu"),
           lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
           2.0 * B * D * H * 2 + 2.0 * B * H * D, nbytes(x, wg, wu, wd, x))


def phase_kernels() -> dict:
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(3)
        reps = 5 if dtype == torch.bfloat16 else 2
        for name, kern, plain, lib, flops, nb, *reorder in kernel_cases(gen, dtype):
            floors = reorder[0]() if reorder and dtype == torch.bfloat16 else None
            err, rel = check(f"{name}[{dtype}]", kern(), plain(), dtype, floors)
            del floors
            cold = name in COLD_CASES
            t_op, t_by = flops / PEAK[dtype], nb / HBM
            if name.startswith("queue_reduce"):
                t_op = flops / PEAK[torch.float32]   # f32 adds, no tensor cores
            row = {"name": name, "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tol": TOL[dtype], "rel_err": rel,
                   "rel_tol": REL_TOL[dtype],
                   "ms": cuda_ms(kern, reps, cold), "plain_ms": cuda_ms(plain, reps, cold),
                   "library_ms": None if lib is None else cuda_ms(lib, reps, cold),
                   "bound_ms": 1e3 * max(t_op, t_by),
                   "bound_by": "operations" if t_op >= t_by else "bytes"}
            print("kernel " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                rows[name] = row
            torch.cuda.empty_cache()
        del gen
        torch.cuda.empty_cache()
    function_grads()
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: the compiler's main path
# ---------------------------------------------------------------------------

def f32(tree: dict) -> dict:
    return {k: f32(v) if isinstance(v, dict) else
            (v.float() if v.is_floating_point() else v) for k, v in tree.items()}


def run_modes(graph, feeds, params, modes, label):
    """Compile and run `graph` in each mode twice; return outputs and
    per-run launch deltas, asserting the second run builds nothing, and
    hold every mode's outputs to an f32 bsp run (see MODEL_TOL)."""
    outs, deltas = {}, {}
    ref = repro_torch.compile(graph, mode="bsp").run(f32(feeds), f32(params)).outputs
    for mode in modes:
        t0 = time.perf_counter()
        app = repro_torch.compile(graph, mode=mode)
        t_compile = time.perf_counter() - t0
        for i in range(2):
            before_builds = repro_torch.lowering_count()
            before = K.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = app.run(feeds, params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = K.launch_counts()
            builds = repro_torch.lowering_count() - before_builds
            delta = {k: after[k] - before[k] for k in after}
            print(f"{label} {mode} run {i}: {wall * 1e3:.1f} ms wall, "
                  f"{rep.n_programs} programs, boundary bytes "
                  f"{rep.bytes_accessed:.6g}, builds {builds}, "
                  f"launches {delta}" + (f", compile passes {t_compile * 1e3:.1f} ms"
                                         if i == 0 else ""), flush=True)
            if i == 1 and builds:
                raise AssertionError(f"{label} {mode}: second run built {builds} programs")
            if i == 1 and delta != deltas[mode]:
                raise AssertionError(f"{label} {mode}: launches differ across runs")
            deltas[mode] = delta
        outs[mode] = rep.outputs
        if mode == "kitsune":
            planned = {}
            for pl in app.lowering.pipelines.values():
                for m in pl.matches:
                    if m.executable and m.accepted:
                        planned[m.kernel] = planned.get(m.kernel, 0) + 1
            for kern, n in planned.items():
                if delta[kern] < n or (kern != "queue_reduce" and delta[kern] != n):
                    raise AssertionError(f"{label}: {kern} launched {delta[kern]} "
                                         f"times for {n} lowered sites")
    for k, want in ref.items():
        bsp_err = rel_err(outs["bsp"][k], want)
        for mode in modes:
            err = rel_err(outs[mode][k], want)
            vs_bsp = rel_err(outs[mode][k], outs["bsp"][k])
            max_abs = (outs[mode][k].float() - outs["bsp"][k].float()).abs().max().item()
            print(f"{label} {mode} [{k}] {tuple(want.shape)}: rel err vs f32 "
                  f"{err:.3e}, vs bsp {vs_bsp:.3e} (max |diff| {max_abs:.4g})",
                  flush=True)
            if err > 2 * bsp_err + 1e-3 or vs_bsp > MODEL_TOL:
                raise AssertionError(f"{label} {mode} [{k}]: rel err {err:.3e} "
                                     f"vs bsp's {bsp_err:.3e}, {vs_bsp:.3e} vs bsp")
    return outs, deltas


def phase_llama():
    graph = apps.llama3_8b(hkv=32)                   # published widths, 2 layers
    params = repro_torch.init_params(graph, seed=0, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for p in params.values() for t in p.values())
    gen = torch.Generator(device="cuda").manual_seed(1)
    feeds = {"ids": torch.randint(0, 128256, (4, 2048), generator=gen, device="cuda")}
    print(f"llama3_8b: {n_params / 1e9:.3f} B parameters in bf16", flush=True)
    _, deltas = run_modes(graph, feeds, params, ("bsp", "kitsune", "vertical"), "llama3_8b")
    k = deltas["kitsune"]
    if k["fused_mlp_swiglu"] != 2 or k["flash_attention"] != 2:
        raise AssertionError(f"llama3_8b kitsune launches {k}: want "
                             f"fused_mlp_swiglu x2, flash_attention x2")


def phase_apps():
    rng = np.random.default_rng(2)

    def feats(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            "cuda", torch.bfloat16)

    def ids(high, *shape):
        return torch.from_numpy(rng.integers(0, high, shape)).to("cuda")

    cases = {
        "nerf": ({"pts": feats(524288, 60), "view": feats(524288, 24)}),
        "dlrm": ({"dense_x": feats(8192, 13), "sparse_ids": ids(1_000_000, 8192, 8)}),
        "mgn": ({"nodes": feats(32768, 128), "edges": feats(98304, 128),
                 "edge_idx": ids(32768, 98304)}),
        "graphcast": ({"x": feats(40962, 256), "mesh_idx": ids(40962, 40962)}),
    }
    for name, feeds in cases.items():
        graph = apps.APPS[name]()
        params = repro_torch.init_params(graph, seed=0, dtype=torch.bfloat16,
                                         device="cuda")
        _, deltas = run_modes(graph, feeds, params, ("bsp", "kitsune"), name)
        if not deltas["kitsune"]["fused_mlp"]:
            raise AssertionError(f"{name}: fused_mlp never launched")
        del params
        torch.cuda.empty_cache()


def phase_split_reduction():
    g = repro_torch.Graph("split_reduction")
    g.input("x", (2048, 1024, 256), "bfloat16")
    g.elementwise("sq", ["x", "x"], "mul")
    g.reduce("batch_sum", "sq", axis=0)
    g.output("y", "batch_sum")
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2048, 1024, 256, generator=gen, device="cuda").to(torch.bfloat16)
    _, deltas = run_modes(g, {"x": x}, {}, ("bsp", "kitsune"), "split_reduction")
    if not deltas["kitsune"]["queue_reduce"]:
        raise AssertionError("split_reduction: queue_reduce never launched")


# ---------------------------------------------------------------------------
# phase 7: the serving path
# ---------------------------------------------------------------------------

def serve_prompts(vocab: int) -> dict[int, list[int]]:
    """16 prompts of 32-160 tokens from a numpy seed; the even ones share a
    32-token prefix, so later requests hit the prefix cache."""
    rng = np.random.default_rng(11)
    shared = rng.integers(2, vocab, 32).tolist()
    prompts = {}
    for rid in range(SERVE_REQUESTS):
        n = int(rng.integers(32, 161))
        tail = rng.integers(2, vocab, n).tolist()
        prompts[rid] = (shared + tail)[:n] if rid % 2 == 0 else tail
    return prompts


def serve_run(cfg, params, prompts, label, **overrides):
    """Serve `prompts` to completion with the launch counters zeroed just
    before and read just after; returns (tokens, engine, launches, seconds)."""
    sc = ServeConfig(**{**SERVE_CONFIG, **overrides})
    eng = PagedServingEngine(cfg, params, sc, eos_id=-1)
    for rid, p in prompts.items():
        eng.submit(p, rid=rid)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    st = eng.stats()
    steps = st["decode_steps"]
    print(f"serve {label}: {len(done)} requests, {st['tokens_out']} tokens, "
          f"{st['ticks']} ticks, {steps} decode steps in {wall:.2f} s: "
          f"{st['tokens_out'] / wall:.1f} tokens/s, {1e3 * wall / st['ticks']:.1f} ms "
          f"per tick, {1e3 * wall / steps:.2f} ms per decode step; launches "
          f"{ {k: n for k, n in launches.items() if n} }; prefix cache "
          f"{st['prefix_cache']}; preemptions {st['scheduler']['preemptions']}; "
          f"kv traffic {st['kv_traffic']}", flush=True)
    if st["pool"]["active"] != 0 or len(done) != len(prompts):
        raise AssertionError(f"serve {label}: {len(done)} of {len(prompts)} done, "
                             f"pool {st['pool']}")
    return done, eng, launches, wall


def profile_decode_ticks(cfg, params, eng, mode: str) -> None:
    """Three one-step ticks with all 8 slots decoding at ragged contexts
    (64-191 tokens, pages drawn from `eng`'s pools) under torch.profiler:
    device time per kernel and the device's idle share of the tick, whose
    wall time is taken again without the profiler."""
    rng = np.random.default_rng(13)
    b, bs, v_blocks = SERVE_CONFIG["batch"], SERVE_CONFIG["block_size"], eng.max_blocks
    tables = 1 + np.arange(b * v_blocks).reshape(b, v_blocks) % eng.pool.num_blocks
    state = {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab, (b, 1))).to("cuda"),
             "n_tok": torch.ones(b, dtype=torch.int64, device="cuda"),
             "pos": torch.from_numpy(rng.integers(64, 192, b)).to("cuda"),
             "tables": torch.from_numpy(tables.astype(np.int32)).to("cuda"),
             "kp": eng.kp, "vp": eng.vp}

    def ticks(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            paged_tick(params, state, cfg, block_size=bs, n_steps=1, mode=mode)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    ticks(1)
    wall = ticks(3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ticks(3)
    # kernels only: a CPU op's self device time repeats its kernels' times
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in rows) / 3e3
    if not rows:
        raise AssertionError(f"profile {mode}: the trace holds no kernel")
    print(f"profile {mode} decode tick (1 step, 8 slots): {1e3 * wall:.2f} ms wall, "
          f"{busy_ms:.2f} ms of kernels, device idle {100 * (1 - busy_ms / (1e3 * wall)):.1f} %",
          flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"  {us / 3e3:8.3f} ms/tick {count // 3:5d} calls/tick  {key[:90]}", flush=True)


def phase_serving() -> dict[str, dict[str, int]]:
    """Returns each serving run's launches, per kernel."""
    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    params = get_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    leaves = [t for sub in (params["blocks"]["sub0"]["attn"], params["blocks"]["sub0"]["mlp"])
              for t in sub.values()] + [params["blocks"]["sub0"]["ln1"],
                                        params["blocks"]["sub0"]["ln2"],
                                        params["final_norm"], params["unembed"]]
    step_bytes = nbytes(*leaves) + SERVE_CONFIG["batch"] * nbytes(params["embed"][0])
    n_params = sum(t.numel() for t in leaves) + params["embed"].numel()
    print(f"{SERVE_ARCH}: {n_params / 1e9:.3f} B parameters in bf16 "
          f"({(step_bytes + nbytes(params['embed'])) / 1e9:.2f} GB), {cfg.n_layers} layers, "
          f"drawn in {time.perf_counter() - t_phase:.1f} s", flush=True)
    sc = ServeConfig(**SERVE_CONFIG)
    print(f"PagedKVExecutor.get_max_allowed_kv_blocks() = "
          f"{PagedKVExecutor(cfg, params, sc).get_max_allowed_kv_blocks()} blocks of "
          f"{sc.block_size} tokens", flush=True)
    torch.cuda.empty_cache()
    prompts = serve_prompts(cfg.vocab)
    runs: dict[str, dict[str, int]] = {}
    native, eng, launches, wall = serve_run(cfg, params, prompts, "native")
    steps = eng.stats()["decode_steps"]
    want = {"paged_flash_decode": cfg.n_layers * steps,
            "fused_mlp_swiglu": cfg.n_layers * steps, "flash_decode": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"native run launched {launches}, want {want}")
    traffic = eng.stats()["kv_traffic"]
    if traffic["native_bytes_per_tick"] > traffic["gather_bytes_per_tick"]:
        raise AssertionError(f"native tick moves more KV bytes than gather: {traffic}")
    if not eng.stats()["prefix_cache"]["hits"]:
        raise AssertionError("no prefix-cache hit in the native run")
    print(f"decode step: {1e3 * wall / steps:.2f} ms measured (host clock, whole ticks "
          f"over decode steps) against a weight-read bound of "
          f"{1e3 * step_bytes / HBM:.2f} ms ({step_bytes / 1e9:.2f} GB / 3.35 TB/s)",
          flush=True)
    runs["serve_native"] = launches
    profile_decode_ticks(cfg, params, eng, "native")
    profile_decode_ticks(cfg, params, eng, "gather")
    del eng
    torch.cuda.empty_cache()

    gather, eng, launches, _ = serve_run(cfg, params, prompts, "gather",
                                         paged_attention="gather")
    want = {"flash_decode": cfg.n_layers * eng.stats()["decode_steps"],
            "fused_mlp_swiglu": cfg.n_layers * eng.stats()["decode_steps"],
            "paged_flash_decode": 0}
    if eng.stats()["decode_steps"] != steps or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"gather run launched {launches} over "
                             f"{eng.stats()['decode_steps']} steps, want {want}")
    if gather != native:
        diff = [rid for rid in native if native[rid] != gather.get(rid)]
        raise AssertionError(f"gather tokens differ from native for requests {diff}")
    print("serve: gather tokens bitwise equal to native", flush=True)
    runs["serve_gather"] = launches
    del eng
    torch.cuda.empty_cache()

    # request 0 alone, on pools sized by the profiling pass (the launcher's
    # default): the whole capacity model runs and must leave the card room
    solo, eng, launches, _ = serve_run(cfg, params, {0: prompts[0]}, "solo",
                                       num_blocks=None)
    if solo[0] != native[0]:
        raise AssertionError(f"request 0 alone {solo[0]} != in the batch {native[0]}")
    free, total = torch.cuda.mem_get_info()
    print(f"serve solo: default capacity {eng.pool.num_blocks} blocks "
          f"({nbytes(eng.kp, eng.vp) / 1e9:.2f} GB of KV pools); card {free / 1e9:.2f} GB "
          f"free of {total / 1e9:.2f} GB after the run, peak reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB", flush=True)
    print("serve: request 0 alone equals its tokens in the full batch", flush=True)
    runs["serve_solo"] = launches
    del params, eng
    torch.cuda.empty_cache()

    # the reduced config in f32, the same weights on the card and the CPU
    small = cfg.reduced()
    cpu_params = get_model(small).init(seed=0, device="cpu")
    card_params = to_device(cpu_params, "cuda")
    rng = np.random.default_rng(12)
    small_prompts = {rid: rng.integers(2, small.vocab, int(rng.integers(3, 40))).tolist()
                     for rid in range(12)}
    small_sc = dict(max_len=64, batch=4, block_size=8, prefill_chunk=8, num_blocks=48,
                    max_new_tokens=16)
    small_runs = {}
    for dev, p in (("cpu", cpu_params), ("cuda", card_params)):
        eng = PagedServingEngine(small, p, ServeConfig(**small_sc), eos_id=-1)
        for rid, pr in small_prompts.items():
            eng.submit(pr, rid=rid)
        eng.tick()
        first = eng.last_logits.float().cpu()
        small_runs[dev] = (eng.run_until_done(), first)
    logit_err = (small_runs["cpu"][1] - small_runs["cuda"][1]).abs().max().item()
    print(f"serve reduced: first-tick logits card vs CPU max |diff| {logit_err:.3g} "
          f"(limit 2e-4)", flush=True)
    if logit_err > 2e-4 or small_runs["cpu"][0] != small_runs["cuda"][0]:
        raise AssertionError(f"reduced {SERVE_ARCH}: card and CPU disagree "
                             f"(logits {logit_err:.3g})")
    print(f"serve reduced: {len(small_runs['cuda'][0])} requests, card tokens equal CPU tokens",
          flush=True)
    print(f"phase 7 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs

# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-3          # AdamW (f32 moments), constant
# |first loss - ln(vocab)|: random logits of spread ~0.7 add ~0.25 to the
# log-sum-exp and the z-loss ~0.02, so the first loss sits near ln(vocab)
FIRST_LOSS_MARGIN = 1.0


def train_batches(cfg, batch: int, seq: int, seed: int = 0):
    """step -> the step's batch on the card: SyntheticLM tokens, and for the
    encoder-decoder 1500 stub frames drawn from (seed, step)."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed))

    def at(step: int) -> dict:
        out = {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to("cuda")}
        if cfg.family == "encdec":
            rng = np.random.default_rng((seed, step))
            out["frame_embeds"] = torch.from_numpy(rng.standard_normal(
                (batch, 1500, cfg.d_model), dtype=np.float32)).to("cuda")
        return out
    return at


def train_steps(label, state, step_fn, batches, want):
    """Run `step_fn` over `batches` (counters zeroed by the caller before
    the run); each step must launch exactly `want` of the kernels named
    there.  Returns (state, losses, seconds per step)."""
    losses, secs = [], []
    for i, b in enumerate(batches):
        before = K.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        delta = {k: n - before[k] for k, n in K.launch_counts().items()}
        print(f"train {label} step {i}: loss {loss:.5f}, grad norm {m['grad_norm'].item():.4f}, "
              f"{1e3 * secs[-1]:.1f} ms, launches { {k: n for k, n in delta.items() if n} }",
              flush=True)
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        if bad or not math.isfinite(loss):
            raise AssertionError(f"train {label} step {i}: loss {loss}, launches "
                                 f"(got, want) {bad}")
        losses.append(loss)
    return state, losses, secs


def profile_train_step(label, step_fn, state, batch, step_s: float) -> None:
    """One step under torch.profiler: device time by kernel, grouped, and
    the device's idle share of an unprofiled step (`step_s`)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out, m = step_fn(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
    del out
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError(f"profile {label}: the trace holds no kernel")
    busy_ms = sum(r[2] for r in rows) / 1e3
    groups = {"B6/B7 backward (mlp_bwd_dx/dw)": ("mlp_bwd",),
              "B1/B2 forward (fused_mlp_kernel)": ("fused_mlp_kernel",),
              "B5 folds (queue_reduce)": ("queue_reduce",),
              "cuBLAS GEMMs": ("gemm", "nvjet", "xmma", "cutlass", "cublas")}
    split = {g: 0.0 for g in groups}
    split["other (elementwise, reductions, copies)"] = 0.0
    for key, _, us in rows:
        g = next((g for g, keys in groups.items() if any(k in key.lower() for k in keys)),
                 "other (elementwise, reductions, copies)")
        split[g] += us / 1e3
    print(f"profile {label} step: {1e3 * step_s:.1f} ms wall (unprofiled), {busy_ms:.1f} ms of "
          f"kernels, device idle {100 * (1 - busy_ms / (1e3 * step_s)):.1f} %", flush=True)
    for g, ms in split.items():
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} %  {g}", flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:5d} calls  {key[:90]}", flush=True)


def phase_train_gemma() -> dict[str, int]:
    """8a: gemma3-1b at full width and depth, 4 x 2048 tokens a step."""
    cfg = get_config("gemma3-1b")
    opt = adamw(TRAIN_LR)
    t0 = time.perf_counter()
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"train gemma3-1b: {n / 1e9:.3f} B parameters in bf16, {cfg.n_layers} layers, "
          f"AdamW f32 moments, drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    step = make_train_step(cfg, opt, TrainConfig(remat=True, xent_chunk=512))
    at = train_batches(cfg, 4, 2048)
    want = {"fused_mlp_swiglu_bwd": cfg.n_layers, "fused_mlp_swiglu": 2 * cfg.n_layers,
            "fused_mlp_bwd": 0, "fused_mlp": 0}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, distinct, s1 = train_steps("gemma3-1b", state, step, [at(i) for i in range(3)], want)
    repeated = at(3)
    state, rep, s2 = train_steps("gemma3-1b repeated", state, step, [repeated] * 5, want)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if abs(distinct[0] - math.log(cfg.vocab)) > FIRST_LOSS_MARGIN:
        raise AssertionError(f"first loss {distinct[0]} is not within {FIRST_LOSS_MARGIN} "
                             f"of ln({cfg.vocab}) = {math.log(cfg.vocab):.3f}")
    if not rep[-1] < rep[0]:
        raise AssertionError(f"loss did not fall on the repeated batch: {rep}")
    steady = s1[1:] + s2
    step_s = sum(steady) / len(steady)
    print(f"train gemma3-1b: first loss {distinct[0]:.4f} (ln V = {math.log(cfg.vocab):.4f}), "
          f"repeated batch {rep[0]:.4f} -> {rep[-1]:.4f}; {1e3 * step_s:.1f} ms per step "
          f"(mean of steps 2-8; first {1e3 * s1[0]:.1f}), {4 * 2048 / step_s:.0f} tokens/s, "
          f"peak allocated {peak / 1e9:.2f} GB", flush=True)
    profile_train_step("gemma3-1b", step, state, repeated, step_s)
    return launches


def phase_train_whisper() -> tuple[dict[str, int], dict[int, int]]:
    """8b: whisper-small at full width, 8 x (1500 frames, 448 tokens).
    Returns the run's launches and fused_mlp_bwd's by input rows."""
    cfg = get_config("whisper-small")
    opt = adamw(TRAIN_LR)
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"train whisper-small: {n / 1e9:.3f} B parameters in bf16, {cfg.n_layers} + "
          f"{cfg.n_layers} layers", flush=True)
    step = make_train_step(cfg, opt, TrainConfig(remat=True, xent_chunk=512))
    at = train_batches(cfg, 8, 448)
    # encoder (no remat) and decoder forward, decoder recompute; one
    # backward per block
    want = {"fused_mlp_bwd": 2 * cfg.n_layers, "fused_mlp": 3 * cfg.n_layers,
            "fused_mlp_swiglu_bwd": 0, "fused_mlp_swiglu": 0}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, losses, secs = train_steps("whisper-small", state, step, [at(i) for i in range(3)], want)
    launches, by_rows = K.launch_counts(), K.launches_by_rows("fused_mlp_bwd")
    # one backward per encoder block at 8 x 1500 rows, per decoder block at 8 x 448
    want_rows = {8 * 1500: 3 * cfg.n_layers, 8 * 448: 3 * cfg.n_layers}
    print(f"train whisper-small: fused_mlp_bwd launches by rows {by_rows}", flush=True)
    if by_rows != want_rows:
        raise AssertionError(f"fused_mlp_bwd by rows {by_rows}, want {want_rows}")
    step_s = sum(secs[1:]) / len(secs[1:])
    print(f"train whisper-small: losses {losses}; {1e3 * step_s:.1f} ms per step (steps 2-3), "
          f"{8 * 448 / step_s:.0f} decoder tokens/s ({8 * 1500 / step_s:.0f} frames/s), "
          f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return launches, by_rows


def phase_train_card_vs_cpu() -> None:
    """8c: the reduced configs (f32) train 3 steps from the same weights on
    the card (kernels) and on the CPU (plain versions): losses and every
    parameter within 2e-4; two card runs give bitwise-equal losses."""
    for name in ("gemma3-1b", "whisper-small"):
        cfg = get_config(name).reduced()
        opt = adamw(1e-3)
        base = get_model(cfg).init(seed=0, device="cpu")
        rng = np.random.default_rng(5)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 40)))}
        if cfg.family == "encdec":
            batch["frame_embeds"] = torch.from_numpy(
                rng.standard_normal((4, 40, cfg.d_model), dtype=np.float32))

        def run(device):
            params = to_device(base, device)
            state = {"params": params, "opt": opt.init(params)}
            step = make_train_step(cfg, opt, TrainConfig(xent_chunk=16))
            b = {k: v.to(device) for k, v in batch.items()}
            losses = []
            for _ in range(3):
                state, m = step(state, b)
                losses.append(m["loss"].item())
            return losses, state["params"]

        cpu_l, cpu_p = run("cpu")
        card_l, card_p = run("cuda")
        again_l, _ = run("cuda")
        loss_err = max(abs(a - b) for a, b in zip(cpu_l, card_l))
        p_err = max((a.float() - b.float().cpu()).abs().max().item()
                    for (_, a), (_, b) in zip(flatten(cpu_p), flatten(card_p)))
        print(f"train {name} reduced: card vs CPU losses {card_l} / {cpu_l}, max |diff| "
              f"{loss_err:.3g}, parameters max |diff| {p_err:.3g} (limit 2e-4); second card "
              f"run bitwise equal: {again_l == card_l}", flush=True)
        for (path, a), (_, b) in zip(flatten(cpu_p), flatten(card_p)):
            torch.testing.assert_close(b.cpu(), a, rtol=2e-4, atol=2e-4, msg=path)
        if loss_err > 2e-4 * (1 + max(cpu_l)) or again_l != card_l:
            raise AssertionError(f"{name} reduced: card {card_l}, CPU {cpu_l}, again {again_l}")


def phase_train_launcher() -> None:
    """8d: the training launcher in a subprocess on the card, gemma3-1b at
    full width, into a fresh checkpoint directory (a stale one would
    resume), deleted after."""
    ckpt = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build"))
    try:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma3-1b",
               "--steps", "4", "--batch", "8", "--seq", "128", "--ckpt", str(ckpt)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                             env=env)
        wall = time.perf_counter() - t0
        for line in out.stdout.splitlines():
            print(f"  launcher: {line}", flush=True)
        if out.returncode != 0:
            raise AssertionError(f"launcher exited {out.returncode}:\n{out.stderr[-3000:]}")
        size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        print(f"launcher: exit 0 in {wall:.1f} s (interpreter start, init, 4 steps, save); "
              f"checkpoint directory {size / 1e9:.2f} GB", flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def phase_training() -> tuple[dict[str, dict[str, int]], dict[str, dict[int, int]]]:
    """Returns each full-width training run's launches, per kernel, and the
    whisper run's fused_mlp_bwd launches by input rows."""
    t_phase = time.perf_counter()
    # phase 7's engines hold reference cycles: collect them, or their pools
    # and the phi3 weights (76 GB) stay allocated
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    runs = {"train_gemma3": phase_train_gemma()}
    torch.cuda.empty_cache()
    runs["train_whisper"], whisper_rows = phase_train_whisper()
    torch.cuda.empty_cache()
    phase_train_card_vs_cpu()
    torch.cuda.empty_cache()
    phase_train_launcher()
    print(f"phase 8 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs, {"train_whisper": whisper_rows}


def to_device(tree: dict, device) -> dict:
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} libraries", flush=True)
    for name, info in built.items():
        regs = [ln.split(":", 1)[-1].strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: nvcc {info['seconds']:.1f} s; " + " | ".join(regs), flush=True)

    rows = phase_kernels()

    K.reset_launch_counts()
    phase_llama()
    phase_apps()
    phase_split_reduction()
    compiler_path = K.launch_counts()
    missing = [k for k in ("fused_mlp", "fused_mlp_swiglu", "flash_attention",
                           "queue_reduce") if compiler_path[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the compiler's main path: {missing}")
    print(f"launches on the compiler's main path (phases 4-6): {compiler_path}", flush=True)
    torch.cuda.empty_cache()

    paths = {"compiler": compiler_path, **phase_serving()}
    torch.cuda.empty_cache()
    train_paths, rows_by_path = phase_training()
    paths.update(train_paths)
    for path, counts in paths.items():
        print(f"launches, {path} run: { {k: n for k, n in counts.items() if n} }", flush=True)

    def launches(path, kern, n_rows=None):
        return paths[path][kern] if n_rows is None else rows_by_path[path].get(n_rows, 0)

    missing = [case for case, (kern, path, _, *n_rows) in SUMMARY.items()
               if launches(path, kern, *n_rows) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")

    summary = []
    for case, (kern, path, shape, *n_rows) in SUMMARY.items():
        row = rows[case]
        source, replaces = SOURCES[kern]
        summary.append({"name": case, "kernel": kern, "route": "cuda", "source": source,
                        "replaces": replaces, "path": path, "shape": shape,
                        "launches": launches(path, kern, *n_rows),
                        "launches_by_run": {p: c[kern] for p, c in paths.items() if c[kern]},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
