"""Serving launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-medium-14b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --reduced --device cpu --engine async --requests 16 --batch 4

``--engine`` picks the stack: ``paged`` (block-paged KV + chunked prefill,
the production default), ``async`` (the same engine behind the background
tick loop / streaming handles), or ``legacy`` (the contiguous-cache
baseline).  Weights are random, drawn from ``--seed`` on ``--device``
(default ``cuda``); ``--reduced`` serves the architecture's small f32
variant.  ``--num-blocks`` overrides the profiled pool capacity.

Fault drills: ``--fault-plan`` installs a scripted fault schedule, e.g.
``tick.step@4,tick.logits@6:rid=3``; ``--deadline-s`` puts a deadline on
every submission, ``--max-queue`` bounds admission, and ``--nan-guard``
enables the decode-logits guard.  The run prints ``health()`` and the
per-request failure breakdown at the end.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import get_model
from ..serve import (AsyncServingEngine, EngineError, PagedServingEngine,
                     ServeConfig, ServingEngine, parse_fault_plan)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--engine", choices=["paged", "async", "legacy"], default="paged")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size; default: profiling pass")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--fault-plan", default=None,
                    help="scripted fault schedule, e.g. "
                         "'tick.step@4,tick.logits@6:rid=3,pool.alloc@*'")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (DeadlineExceeded past it)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue (QueueFull backpressure)")
    ap.add_argument("--nan-guard", action="store_true",
                    help="fail slots whose decode logits go NaN/Inf")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    params = get_model(cfg).init(args.seed, device)
    prompts = [[2 + rid % 7, 11, 23] for rid in range(args.requests)]
    plan = parse_fault_plan(args.fault_plan) if args.fault_plan else ()
    sc = ServeConfig(max_len=args.max_len, batch=args.batch,
                     num_blocks=args.num_blocks, block_size=args.block_size,
                     prefill_chunk=args.prefill_chunk,
                     fault_plan=plan, fault_seed=args.fault_seed,
                     nan_guard=args.nan_guard, max_queue=args.max_queue,
                     default_deadline_s=args.deadline_s)

    t0 = time.perf_counter()
    failed = {}
    if args.engine == "legacy":
        eng = ServingEngine(cfg, params, sc, eos_id=-1)
        for rid, p in enumerate(prompts):
            eng.submit(rid, p)
        done = eng.run_until_done()
        extra = ""
    elif args.engine == "paged":
        eng = PagedServingEngine(cfg, params, sc, eos_id=-1)
        for rid, p in enumerate(prompts):
            eng.submit(p, rid=rid)
        done = eng.run_until_done()
        extra = f" stats={eng.stats()}"
        failed = eng.failed
    else:
        with AsyncServingEngine(cfg, params, sc, eos_id=-1) as aeng:
            handles = [aeng.submit(p) for p in prompts]
            done = {}
            for h in handles:
                try:
                    done[h.rid] = h.result(timeout=600)
                except EngineError as exc:
                    failed[h.rid] = exc
        eng = aeng.engine
        extra = f" stats={eng.stats()}"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in done.values())
    print(f"[{args.engine}] {cfg.name} on {device}: served {len(done)}/{args.requests} "
          f"requests, {toks} tokens in {dt:.1f}s ({toks / dt:.1f} tok/s){extra}")
    if args.engine != "legacy":
        print(f"health: {eng.health()}")
        for rid, err in sorted(failed.items()):
            print(f"  failed rid={rid}: {err!r}")
    return done


if __name__ == "__main__":
    main()
