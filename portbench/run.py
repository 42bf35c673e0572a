"""Run one benchmark cell once and print the contract's result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration
file, its workload file (`portbench/workloads/<cell>.json`) and the
driver that file names (`portbench/drivers/<driver>.py`) are found by
name.  The last line on standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device` and, last, `checks` (each
number compared with the reference, beside its limit); the same numbers
close standard error.  A run that cannot measure (no card, too few cards,
the program missing, a forbidden module loaded) exits non-zero and prints
no result.

Every cache the run's program builds lives at a fixed path inside the
checkout, under `build/` (the kernels' nvcc libraries in
`build/repro_torch_kernels`, as the program places them).
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (from /proc; the
    interpreter's own start-up is part of set-up)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"
# fixed cache directories inside the checkout, set before torch loads
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = bench.find_cell(args.workload)
        if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
            raise bench.BenchError("the program (src/repro_torch) is not in this checkout")
        import torch
        if not torch.cuda.is_available():
            raise bench.BenchError("no CUDA device: this benchmark measures the card")
        chips = int(cell.entry["chips"])
        if torch.cuda.device_count() < chips:
            raise bench.BenchError(f"{cell.name} needs {chips} cards, "
                                   f"{torch.cuda.device_count()} present")
        # every kernel library of the program, built (nvcc) at first use
        # into the checkout's build/ otherwise: a checkout's first run builds
        # them all, and no later run builds one
        from repro_torch.kernels import _build
        _build.build_all()
        drv = bench.driver(cell.workload["driver"])
        out = drv.run(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                      device=torch.device("cuda", 0), process_start=PROCESS_START)
        found = bench.forbidden_modules()
        if found:
            raise bench.BenchError(f"forbidden modules loaded in the run's process: {found}")
    except bench.BenchError as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = bench.result_line(cell, out, bool(args.trace), device)
    for note in out.notes:
        print(note, file=sys.stderr)
    print(f"correct {line['correct']} (attempted {out.attempted}, failed {out.failed})",
          file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
