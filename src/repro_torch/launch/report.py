"""Render the dry-run summary and the roofline table from the dry run's rows
(build/dryrun_torch/*.json), the counterpart of `repro/launch/report.py`.
Run after the sweep:

    PYTHONPATH=src python -m repro_torch.launch.report > build/dryrun_tables.md

Every number in the tables is a dry-run count per rank, or a count over
the H100's data-sheet rates (core/costmodel.py `roofline`): no time here
was measured.  Each row names the torch release it was counted on.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .dryrun import OUT_DIR


def load(directory: str = OUT_DIR) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def next_lever(r) -> str:
    """One sentence: what would move the dominant term down on the card."""
    d = r["roofline"]["dominant"]
    kind = ("train" if "train" in r["shape"]
            else "decode" if ("decode" in r["shape"] or "long" in r["shape"])
            else "prefill")
    if d == "memory" and kind == "decode":
        return ("the float8_e4m3fn KV cache (kv_cache_dtype) halves the streamed "
                "cache bytes; decode is cache-bandwidth-bound")
    if d == "memory" and kind == "train":
        return ("the count is unfused: torch.compile of the eager step would fuse "
                "the elementwise chains; the fused MLP kernels already keep the "
                "d_ff hidden tile on chip")
    if d == "memory":
        return ("fused attention (B3) keeps the score tile on chip where the "
                "chunked torch attention writes it; the fused MLP keeps the hidden "
                "tile in shared memory")
    if d == "collective":
        return ("fewer or overlapped FSDP all-gathers (fewer data shards of the "
                "weights), int8 gradient compression (optim/compression.py)")
    return ("near the compute bound: raise the per-card batch, or keep the MLP "
            "blocks on the fused wgmma kernels for tensor-core occupancy")


def torch_of(r) -> str:
    """The torch release a row was counted on (DTensor's strategies, and so
    a row's collectives and memory, differ between releases); rows written
    before the field existed say so."""
    return r.get("torch", "not recorded")


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def main(argv=None, out=sys.stdout):
    ap = argparse.ArgumentParser(description="dry-run tables")
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    rows = load(args.dir)
    ok = [r for r in rows if r.get("status") == "ok"]
    fail = [r for r in rows if r.get("status") != "ok"]
    single = [r for r in ok if r["mesh"] == "16x16"]
    multi = [r for r in ok if r["mesh"] == "2x16x16"]

    def p(*a):
        print(*a, file=out)

    p("### Dry-run summary (counts per rank; no time measured)\n")
    p(f"- cells traced OK: **{len(ok)}** "
      f"(single-pod {len(single)}, multi-pod {len(multi)}); failed: {len(fail)}")
    for r in fail:
        p(f"  - FAIL {r['arch']} x {r['shape']} ({r['mesh']}): {r['status'][:150]}")
    p("")
    p("| arch | shape | mesh | memory/card (GiB) | fits 80GB | colls/step "
      "| coll GiB/card | trace s | torch |")
    p("|---|---|---|---|---|---|---|---|---|")
    for r in ok:
        m = r["memory"]
        c = r["collectives"]
        p(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
          f"| {m['total_GiB_per_chip']:.2f} | {'Y' if m['fits_80GB'] else 'N'} "
          f"| {c['count']} | {c['total'] / 2**30:.2f} | {r['compile_s']} "
          f"| {torch_of(r)} |")
    p("")
    p("### Roofline table (single-pod 16x16, per card per step: counts over "
      "the H100's data-sheet rates)\n")
    p("| arch | shape | compute | memory | collective | dominant "
      "| useful-FLOPs ratio | roofline frac | next lever | torch |")
    p("|---|---|---|---|---|---|---|---|---|---|")
    for r in single:
        rf = r["roofline"]
        p(f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} "
          f"| {fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} "
          f"| **{rf['dominant']}** | {rf['useful_flops_ratio']:.2f} "
          f"| {rf['roofline_fraction']:.3f} | {next_lever(r)} | {torch_of(r)} |")
    p("")
    doms: dict[str, int] = {}
    for r in single:
        doms[r["roofline"]["dominant"]] = doms.get(r["roofline"]["dominant"], 0) + 1
    p(f"Dominant-term distribution (single-pod): {doms}")
    worst = sorted(single, key=lambda r: r["roofline"]["roofline_fraction"])[:3]
    p("Worst roofline fractions: "
      + ", ".join(f"{r['arch']}x{r['shape']}={r['roofline']['roofline_fraction']:.3f}"
                  for r in worst))
    colb = sorted(single, key=lambda r: -r["roofline"]["collective_s"])[:3]
    p("Most collective-bound: "
      + ", ".join(f"{r['arch']}x{r['shape']}={fmt_s(r['roofline']['collective_s'])}"
                  for r in colb))


if __name__ == "__main__":
    main()
