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
     axis 0, kitsune (queue_reduce) against bsp.
The launch counters are zeroed just before phase 4 and read just after
phase 6: that span is the main path.  The second-to-last line is the
per-kernel JSON summary, the last line {"ok": true, "device": ...}.
"""
import json
import os
import subprocess
import sys
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
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.fused_mlp import (MAX_BLOCK_H,  # noqa: E402
                                           fused_mlp_fwd_plain,
                                           fused_mlp_swiglu_fwd_plain)
from repro_torch.kernels.queue_reduce import queue_reduce_plain  # noqa: E402

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
SOURCES = {
    "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:100"),
    "fused_mlp_swiglu": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                         "src/repro/kernels/fused_mlp.py:124"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:118"),
    "queue_reduce": ("src/repro_torch/kernels/csrc/queue_reduce.cu",
                     "src/repro/kernels/queue_reduce.py:57"),
}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def check(name: str, got, want, dtype) -> tuple[float, float]:
    """(max |got - want|, relative error), raising if either bound of
    `dtype` is broken."""
    tol = TOL[dtype]
    rel = rel_err(got, want)                  # checks shape and finiteness
    err, ratio = worst(got, want, tol)
    if ratio > 1.0 or rel > REL_TOL[dtype]:
        raise AssertionError(f"{name}: max |err| {err:.4g} (atol=rtol={tol}, "
                             f"ratio {ratio:.3f}), relative error {rel:.3g} "
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


def phase_kernels() -> dict:
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(3)
        reps = 5 if dtype == torch.bfloat16 else 2
        for name, kern, plain, lib, flops, nb in kernel_cases(gen, dtype):
            err, rel = check(f"{name}[{dtype}]", kern(), plain(), dtype)
            t_op, t_by = flops / PEAK[dtype], nb / HBM
            if name.startswith("queue_reduce"):
                t_op = flops / PEAK[torch.float32]   # f32 adds, no tensor cores
            row = {"name": name, "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tol": TOL[dtype], "rel_err": rel,
                   "rel_tol": REL_TOL[dtype],
                   "ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(plain, reps),
                   "library_ms": cuda_ms(lib, reps),
                   "bound_ms": 1e3 * max(t_op, t_by),
                   "bound_by": "operations" if t_op >= t_by else "bytes"}
            print("kernel " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                rows[name] = row
            torch.cuda.empty_cache()
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
    launches = K.launch_counts()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    summary = []
    for name, source_replaces in SOURCES.items():
        row = rows[name]
        source, replaces = source_replaces
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
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
