#!/usr/bin/env python3
"""Build-and-compare probe of queue_reduce (B5) and the bf16 fused-MLP
backward (B6 ungated, B7 gated) on one card.

    python3 tools/probe_bwd_reduce.py            # checks, then times
    python3 tools/probe_bwd_reduce.py --check    # checks only
    python3 tools/probe_bwd_reduce.py --time-only
    python3 tools/probe_bwd_reduce.py --only reduce   # or --only bwd
    python3 tools/probe_bwd_reduce.py --sub 'OLD=>NEW' [--sub ...]

--sub builds a variant of csrc/ (as tools/probe_tiled_mlp.py does).

Builds csrc/queue_reduce.cu and csrc/fused_mlp_bwd.cu (printing ptxas's
registers and spills), then holds:
  - B5 bitwise against the sequential f32 fold (`sequential_fold`) for sum,
    and against torch.amax / amin (NaN included) for max / min, at the main
    path's shapes, at payload strides that are not a multiple of 16 bytes
    and on views with a storage offset;
  - B6 and B7 in bf16 against the plain version (dX elementwise atol = rtol
    = 2e-2; every output relative error <= 1e-2, with the elementwise
    ratio printed for dW), and two calls bitwise alike;
then times with CUDA events: B5 at the decode fold (63, 8,
5120) f32 -> bf16, the compiler's fan-in (16, 1024, 256) bf16, the Llama
fold (4, 8192, 4096) f32 -> bf16 and the deepest training fold (18, 8192,
1152) f32 -> bf16 beside torch.sum; B6 at whisper-small's encoder (12000,
768 -> 3072 -> 768) and decoder (3584 rows) gelu, its dX and dW kernels
apart, beside the cuBLAS chain.  Prints the card and its power limit first.
Needs one card.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from probe_tiled_mlp import compare, ms, variant  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_mlp as FM  # noqa: E402
from repro_torch.kernels.queue_reduce import sequential_fold  # noqa: E402
from repro_torch.kernels.ref import DACTS  # noqa: E402

FOLDS = {"decode fold": ((63, 8, 5120), torch.float32, torch.bfloat16),
         "compiler fan-in": ((16, 1024, 256), torch.bfloat16, torch.bfloat16),
         "Llama fold": ((4, 8192, 4096), torch.float32, torch.bfloat16),
         "training fold": ((18, 8192, 1152), torch.float32, torch.bfloat16),
         "134 MB fold": ((16, 2048, 1024), torch.float32, torch.bfloat16),
         "deep 16 MB fold": ((100, 40, 1024), torch.float32, torch.bfloat16)}


def reduce_checks(gen) -> bool:
    ok = True
    shapes = [((63, 8, 5120), torch.float32, torch.bfloat16), ((1, 40, 64), torch.float32,
                                                                torch.float32),
              ((16, 33, 70), torch.bfloat16, torch.bfloat16), ((5, 3, 7), torch.float32,
                                                               torch.bfloat16),
              ((16, 1024, 256), torch.bfloat16, torch.float32),
              ((40, 300, 1000), torch.float32, torch.bfloat16),
              ((4, 2048, 4096), torch.float32, torch.bfloat16)]
    for shape, dt, out_dt in shapes:
        x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
        views = {"contiguous": x}
        flat = torch.randn(x.numel() + 1, generator=gen, device="cuda").to(dt)
        views["storage offset 1"] = flat[1:].view(shape)
        for label, v in views.items():
            same = torch.equal(K.queue_reduce(v, out_dtype=out_dt), sequential_fold(v, out_dt))
            print(f"{'ok  ' if same else 'FAIL'} B5 {shape} {dt}->{out_dt} {label}: "
                  f"sum bitwise == sequential fold", flush=True)
            ok &= same
            v2 = v.clone()
            v2.view(-1)[v2.numel() // 3] = float("nan")
            for op, fn in (("max", torch.amax), ("min", torch.amin)):
                got = K.queue_reduce(v2, op=op, out_dtype=out_dt).float()
                ref = fn(v2.float(), dim=0).to(out_dt).float()
                same = torch.equal(got.isnan(), ref.isnan()) and torch.equal(
                    got.nan_to_num(), ref.nan_to_num())
                print(f"{'ok  ' if same else 'FAIL'} B5 {shape} {label}: {op} == "
                      f"torch.{fn.__name__} (NaN propagates)", flush=True)
                ok &= same
    return ok


def operands(gen, m, d, h, o, gated):
    x = torch.randn(m, d, generator=gen, device="cuda").to(torch.bfloat16)
    ws = [(torch.randn(d, h, generator=gen, device="cuda") * d ** -0.5).to(torch.bfloat16)
          for _ in range(2 if gated else 1)]
    w2 = (torch.randn(h, o, generator=gen, device="cuda") * h ** -0.5).to(torch.bfloat16)
    dy = torch.randn(m, o, generator=gen, device="cuda").to(torch.bfloat16)
    return x, ws, w2, dy


def bwd_checks(gen) -> bool:
    ok = True
    for gated in (False, True):
        for m, d, h, o, act in [(100, 60, 300, 50, "relu"), (130, 64, 700, 96, "gelu"),
                                (300, 128, 1100, 128, "silu"), (64, 32, 128, 40, "identity"),
                                (260, 64, 200, 72, "silu"), (130, 96, 1000, 64, "relu"),
                                (3584, 768, 3072, 768, "gelu")]:
            x, ws, w2, dy = operands(gen, m, d, h, o, gated)
            wu = ws[1] if gated else None
            got = FM.bwd_bf16(x, ws[0], wu, w2, dy, act)
            want = (FM.fused_mlp_swiglu_bwd_plain(x, ws[0], wu, w2, dy, act) if gated
                    else FM.fused_mlp_bwd_plain(x, ws[0], w2, dy, act))
            label = f"{'B7' if gated else 'B6'} ({m}, {d}->{h}->{o}) {act}"
            ok &= compare(f"{label} dx", got[0], want[0])
            for i in range(1, len(got)):
                g, w = got[i].float(), want[i].float()
                rel = ((g - w).norm() / w.norm()).item()
                ratio = ((g - w).abs() / (2e-2 + 2e-2 * w.abs())).max().item()
                fine = g.shape == w.shape and bool(torch.isfinite(g).all()) and rel <= 1e-2
                print(f"{'ok  ' if fine else 'FAIL'} {label} dw[{i}]: rel {rel:.3g}, "
                      f"elementwise ratio {ratio:.3f}", flush=True)
                ok &= fine
            again = FM.bwd_bf16(x, ws[0], wu, w2, dy, act)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"{'ok  ' if same else 'FAIL'} {label}: two calls bitwise", flush=True)
            ok &= same
    return ok


def chain(x, w1, w2, dy, act):
    pre = x @ w1
    da = (dy @ w2.T) * DACTS[act](pre)
    return (da @ w1.T, x.T @ da, F.gelu(pre, approximate="tanh").T @ dy)


def times(gen, only) -> None:
    tiny = torch.zeros(1, device="cuda")
    print(f"time one launch's floor (fill_ of one float): {ms(lambda: tiny.fill_(1.0), 50):.4f} ms",
          flush=True)
    for label, (shape, dt, out_dt) in FOLDS.items() if only != "bwd" else ():
        x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
        nb = x.nbytes + x[0].numel() * torch.finfo(out_dt).bits // 8
        t = ms(lambda: K.queue_reduce(x, out_dtype=out_dt), 50)
        print(f"time B5 {label} {shape} {dt}->{out_dt}: {t:.4f} ms, torch.sum "
              f"{ms(lambda: torch.sum(x, dim=0), 50):.4f} ms, bound {1e3 * nb / 3.35e12:.4f} ms "
              f"(bytes)", flush=True)
        del x
    for m in (12000, 3584) if only != "reduce" else ():
        x, (w1,), w2, dy = operands(gen, m, 768, 3072, 768, False)
        flops = 5 * 2.0 * m * 768 * 3072
        parts = FM.bwd_bf16(x, w1, None, w2, dy, "gelu", parts=1)[:1] + \
            FM.bwd_bf16(x, w1, None, w2, dy, "gelu", parts=2)[1:]
        pb = sum(p.nbytes for p in parts)
        del parts
        print(f"time B6 ({m}, 768->3072->768) gelu: "
              f"{ms(lambda: FM.bwd_bf16(x, w1, None, w2, dy, 'gelu')):.4f} ms with folds (dX "
              f"{ms(lambda: FM.bwd_bf16(x, w1, None, w2, dy, 'gelu', parts=1)):.4f}, dW "
              f"{ms(lambda: FM.bwd_bf16(x, w1, None, w2, dy, 'gelu', parts=2)):.4f}), chain "
              f"{ms(lambda: chain(x, w1, w2, dy, 'gelu')):.4f} ms, bound "
              f"{1e3 * flops / 989e12:.4f} ms (operations), partial bytes {pb}, partials "
              f"{FM.mlp_bwd_partials(m, 3072)}", flush=True)
        del x, w1, w2, dy
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    subs = [sys.argv[i + 1] for i, a in enumerate(sys.argv) if a == "--sub"]
    if subs:
        variant(subs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    names = {"reduce": ["queue_reduce"], "bwd": ["queue_reduce", "fused_mlp_bwd"]}
    for name, info in _build.build(names.get(only, ["queue_reduce", "fused_mlp_bwd"])).items():
        print(f"{name}: nvcc {info['seconds']:.1f} s", flush=True)
        for ln in info["log"].splitlines():
            if "C75" in ln or "error" in ln or "spill" in ln and " 0 bytes spill" not in ln:
                print("   ", ln.strip()[:200], flush=True)
            elif "registers" in ln:
                print("   ", ln.strip()[:160], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--time-only" not in sys.argv:
        ok = ((only == "bwd" or reduce_checks(gen)) & (only == "reduce" or bwd_checks(gen)))
        if not ok:
            print("probe: checks failed", flush=True)
            return 1
    if "--check" not in sys.argv:
        times(gen, only)
    K.reset_launch_counts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
