#!/usr/bin/env python3
"""Build-and-compare probe of the tiled bf16 fused-MLP forward on one card.

    python3 tools/probe_tiled_mlp.py            # checks, then times
    python3 tools/probe_tiled_mlp.py --check    # checks only
    python3 tools/probe_tiled_mlp.py --time-only
    python3 tools/probe_tiled_mlp.py --sub 'constexpr int FW_CS = 8;=>constexpr int FW_CS = 4;'

Each --sub 'OLD=>NEW' builds a variant: a copy of csrc/ under
build/probe_csrc/<digest>/ with OLD (which must occur) replaced by NEW
in every source holding it.

Builds csrc/fused_mlp.cu and csrc/fused_mlp_bwd.cu (printing ptxas's
registers and spills for the TMA + wgmma kernels), holds the tiled form of
B1 (`fused_mlp_fwd`) and B2 (`fused_mlp_swiglu_fwd`) against the plain
version at odd and main-path widths (atol = rtol = 2e-2, relative error
1e-2), checks that two launches are bitwise alike and that a row's result
at M = 300 equals the same row at M = 65, checks B7 (which shares the
ring and fold) at one small shape, then times the tiled form, the plain
version and the cuBLAS chain at the three main-path shapes with CUDA
events.  Prints the card and its power limit first.  Needs one card.
"""
import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_mlp as FM  # noqa: E402

ACTS = {"relu": torch.relu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
        "silu": F.silu, "identity": lambda t: t}


def randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def operands(gen, m, d, h, o):
    return (randn(gen, m, d), randn(gen, d, h, scale=d ** -0.5),
            randn(gen, d, h, scale=d ** -0.5), randn(gen, h, o, scale=h ** -0.5))


def run(gated, x, w1, wu, w2, act):
    return (FM.forward_in_form("tiled", x, w1, wu, w2, act) if gated
            else FM.forward_in_form("tiled", x, w1, None, w2, act))


def plain(gated, x, w1, wu, w2, act):
    return (FM.fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, act) if gated
            else FM.fused_mlp_fwd_plain(x, w1, w2, act))


def compare(label, got, want, tol=2e-2, rel_tol=1e-2):
    g, w = got.float(), want.float()
    assert g.shape == w.shape and torch.isfinite(g).all(), (label, g.shape, w.shape)
    err = (g - w).abs()
    ratio = (err / (tol + tol * w.abs())).max().item()
    rel = ((g - w).norm() / w.norm()).item()
    ok = ratio <= 1 and rel <= rel_tol
    print(f"{'ok  ' if ok else 'FAIL'} {label}: max |err| {err.max().item():.4g}, "
          f"ratio {ratio:.3f}, rel {rel:.3g}", flush=True)
    return ok


def ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def checks(gen) -> bool:
    ok = True
    for gated in (False, True):
        for m, d, h, o, act in [(65, 60, 300, 50, "relu"), (130, 64, 2000, 96, "gelu"),
                                (300, 128, 1024, 128, "silu"), (257, 96, 1000, 72, "identity"),
                                (300, 256, 256, 256, "relu"), (520, 1152, 6912, 1152, "silu"),
                                (384, 4096, 14336, 4096, "identity")]:
            x, w1, wu, w2 = operands(gen, m, d, h, o)
            y = run(gated, x, w1, wu, w2, act)
            torch.cuda.synchronize()
            geo = FM.tiled_geometry(h)
            label = f"{'B2' if gated else 'B1'} ({m}, {d}->{h}->{o}) {act} {geo}"
            ok &= compare(label, y, plain(gated, x, w1, wu, w2, act))
            again = run(gated, x, w1, wu, w2, act)
            small = run(gated, x[:65].contiguous(), w1, wu, w2, act)
            same = torch.equal(y, again) and torch.equal(y[:65], small)
            print(f"{'ok  ' if same else 'FAIL'} {label}: two launches bitwise, rows at M={m} "
                  f"== M=65", flush=True)
            ok &= same
    x, wg, wu, wd = operands(gen, 260, 64, 200, 72)
    dy = randn(gen, 260, 72)
    for i, (g, w) in enumerate(zip(K.fused_mlp_swiglu_bwd(x, wg, wu, wd, dy, act="silu"),
                                   FM.fused_mlp_swiglu_bwd_plain(x, wg, wu, wd, dy, "silu"))):
        ok &= compare(f"B7 (260, 64->200->72) silu output {i}", g, w)
    return ok


def times(gen) -> None:
    for gated, (m, d, h, o, act) in [(True, (8192, 1152, 6912, 1152, "silu")),
                                      (True, (8192, 4096, 14336, 4096, "identity")),
                                      (False, (524288, 256, 256, 256, "relu")),
                                      (False, (12000, 768, 3072, 768, "gelu")),
                                      (False, (3584, 768, 3072, 768, "gelu"))]:
        x, w1, wu, w2 = operands(gen, m, d, h, o)
        if not gated:
            wu = None
        a = ACTS[act]
        chain = ((lambda: (a(x @ w1) * (x @ wu)) @ w2) if gated
                 else (lambda: a(x @ w1) @ w2))
        flops = 2.0 * m * d * h * (2 if gated else 1) + 2.0 * m * h * o
        nb = 2 * (x.numel() + w1.numel() * (2 if gated else 1) + w2.numel() + m * o)
        bound = 1e3 * max(flops / 989e12, nb / 3.35e12)
        raw = FM.forward_in_form("tiled", x, w1, wu, w2, act, fold=False)
        pb = raw.nbytes if raw.dtype == torch.float32 else 0
        del raw
        t = ms(lambda: run(gated, x, w1, wu, w2, act))
        print(f"time {'B2' if gated else 'B1'} ({m}, {d}->{h}->{o}) {act}: tiled {t:.4f} ms, "
              f"chain {ms(chain):.4f} ms, bound {bound:.4f} ms, partial bytes {pb}, "
              f"geometry {FM.tiled_geometry(h)}, resident clusters "
              f"{FM.tiled_resident(0, h, gated)}", flush=True)
        del x, w1, wu, w2
        torch.cuda.empty_cache()


def variant(subs: list[str]) -> None:
    """Point the kernel builder at a copy of csrc/ with each 'OLD=>NEW'
    substitution made."""
    digest = hashlib.sha256("\n".join(subs).encode()).hexdigest()[:12]
    dst = ROOT / "build" / "probe_csrc" / digest
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    for sub in subs:
        old, new = sub.split("=>")
        hits = [f for f in sorted(dst.iterdir()) if old in f.read_text()]
        if not hits:
            raise SystemExit(f"variant: {old!r} occurs in no source")
        for f in hits:
            f.write_text(f.read_text().replace(old, new))
            print(f"variant: {f.name}: {old!r} -> {new!r}", flush=True)
    _build.CSRC = dst


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
    for name, info in _build.build(["fused_mlp", "fused_mlp_bwd"]).items():
        print(f"{name}: nvcc {info['seconds']:.1f} s", flush=True)
        for ln in info["log"].splitlines():
            if "C75" in ln:
                print("   ", ln.strip(), flush=True)
            elif "wgmma" in ln or "spill" in ln or "registers" in ln or "error" in ln:
                print("   ", ln.strip()[:160], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--time-only" not in sys.argv and not checks(gen):
        print("probe: checks failed", flush=True)
        return 1
    if "--check" not in sys.argv:
        times(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
