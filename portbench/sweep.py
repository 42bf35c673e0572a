"""The knee of an open-loop serving cell, found once on the card: the cell's
traffic at each of a few fixed rates, one engine each over the same
weights, in one process.  Not part of a benchmark run.

    python3 portbench/sweep.py --workload phi3.chat --seconds 30 --rates 3 4 5 6 7 8

Prints one JSON line per rate: requests due and finished in the window,
the waiting queue at a third, two thirds and the end of the window (a
queue that grows means the rate is past the knee), the p50 and p90 of
time to first token and time per output token, and output tokens/s.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, serving  # noqa: E402
from portbench.drivers import serve_open  # noqa: E402


class Watched(serving.OpenFeed):
    """The open loop, noting the waiting queue at thirds of the window."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.queue_at: list[int] = []

    def due(self, loop, now):
        super().due(loop, now)
        k = len(self.queue_at)
        if k < 3 and now >= loop.t0 + (k + 1) * loop.seconds / 3:
            self.queue_at.append(len(loop.eng.scheduler.waiting))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=20260101)
    args = ap.parse_args(argv)
    import torch
    device = torch.device("cuda", 0)
    cell = bench.find_cell(args.workload)
    cfg, wl = cell.config, cell.workload
    arch = serving.arch_config(cfg)
    params = serving.make_weights(torch, cfg, args.seed, device)
    for rate in args.rates:
        w = dict(wl, traffic=dict(wl["traffic"], rate_per_s=rate), drain_s=20)
        eng = serving.make_engine(arch, params, w)
        feed = Watched(w, args.seed, args.seconds, cfg["vocab_size"])
        serve_open.warm(eng, feed)
        loop = serving.Loop(torch, eng, seconds=args.seconds, drain_s=w["drain_s"],
                            traced=False, trace_ticks=0, device=device)
        t0 = time.time()
        loop.run(feed)
        win = loop.in_window()
        done = [s for s in win if s.done]
        ttft = [1e3 * (s.first - s.sent) for s in done]
        tpot = [1e3 * (s.last - s.first) / (s.n - 1) for s in done if s.n > 1]
        toks = sum(t["tokens"] for t in loop.ticks)
        row = {"rate": rate, "due": len(win), "finished": len(done),
               "waiting_at_thirds": feed.queue_at, "late_s": loop.late_s,
               "ttft_p50_ms": bench.quantile(ttft, 0.5) if ttft else None,
               "ttft_p90_ms": bench.quantile(ttft, 0.9) if ttft else None,
               "tpot_p50_ms": bench.quantile(tpot, 0.5) if tpot else None,
               "tpot_p90_ms": bench.quantile(tpot, 0.9) if tpot else None,
               "out_tok_s": toks / args.seconds,
               "pool_peak_blocks": loop.pool_peak,
               "step_ms": 1e3 * sum(t["t1"] - t["t0"] for t in loop.ticks)
               / max(1, sum(t["steps"] for t in loop.ticks)),
               "wall_s": time.time() - t0}
        print(json.dumps(row), flush=True)
        serving.free(torch, eng, loop)
        del eng, loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
