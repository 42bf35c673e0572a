"""Readings that the limits of `correct` are set from, on the card: for each
seed, one short run of the cell in this process with its check, and the
control's reading on the same sample (the reference in e4m3, put in the
program's place).  Not part of a benchmark run.

    python3 portbench/calibrate.py --workload nerf.render --seconds 4 --seeds 101 102 103

Prints one JSON line per seed: {"seed", <check>: reading, <check>.control:
reading, "end_to_end": {...}}.  With `--kv8`, each seed instead runs the
program with its own float8 e4m3 KV cache (`kv_cache_dtype`), the program's
own step below the configuration's bfloat16, and its reading is printed as
<check>.kv8.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, serving  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--kv8", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload)
    drv = bench.driver(cell.workload["driver"])
    for seed in args.seeds:
        t0 = time.time()
        kw = {"program": serving.kv8_engine} if args.kv8 else {"control": bool(args.control)}
        out = drv.run(cell, seed=seed, seconds=args.seconds, traced=False,
                      device=torch.device("cuda", 0), process_start=t0, **kw)
        tag = ".kv8" if args.kv8 else ""
        row = {"seed": seed, "correct": out.correct, "failed": out.failed,
               **{c.name + tag: c.value for c in out.checks},
               **{k + tag: v for k, v in out.obs.get("check_stats", {}).items()},
               "end_to_end": out.end_to_end, "notes": out.notes}
        print(json.dumps(row), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
