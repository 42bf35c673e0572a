"""Block-size autotuning for the Hopper kernels.

A kernel's launch takes a few run-time knobs (`KernelConfig` in ops.py):
the decode kernels' split-K chunk, the float32 forms' hidden chunk and row
slice.  The right value depends on the shape and the card, so each kernel
module exposes a small candidate grid (`tile_candidates` in fused_mlp.py /
flash_attention.py / queue_reduce.py, every value one its launch accepts)
and the lowering pass searches it at first build: every candidate is timed
on synthesized operands of the site's shapes, the fastest wins, and the
choice is cached process-wide by (kernel, shape signature, device) so later
builds of the same site pay nothing.  A kernel whose geometry the source
fixes has a grid of one, which is cached without being timed.

`time_fn` is shared with the lowering verdict's microbenchmark
(core/lower.py): one untimed call absorbs builds (a library's nvcc, a
graph's upload), then the min over a few timed calls -- device time
between CUDA events on the current stream when an argument lives on the
card, the host clock on the CPU.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable

import torch
from torch.utils import _pytree as pytree

# A sleep kernel of this many clock cycles (~1 ms on an H100) holds the
# device before a timed call, so that the host queues the call and its
# events while the device waits: launch latency never shows in the events.
HOLD_CYCLES = 2_000_000


def _card(args: tuple) -> torch.device | None:
    """The CUDA device of the first tensor among `args` that lives on one."""
    for leaf in pytree.tree_leaves(args):
        if torch.is_tensor(leaf) and leaf.device.type == "cuda":
            return leaf.device
    return None


def device_seconds(run: Callable[[], Any]) -> float:
    """Device seconds of run() on the current stream: CUDA events around
    it, recorded behind a sleep kernel (HOLD_CYCLES)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def time_fn(fn: Callable, args: tuple, iters: int = 2) -> float:
    """Best-of-`iters` seconds of fn(*args); the untimed first call absorbs
    builds.  On the card each call is timed on the device
    (`device_seconds`); on the CPU with the host clock."""
    device = _card(args)
    fn(*args)
    best = float("inf")
    if device is None:
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(device):
        for _ in range(max(iters, 1)):
            best = min(best, device_seconds(lambda: fn(*args)))
    return best


class TuneCache:
    """Process-wide (kernel, shape, device) -> chosen-candidate store."""

    def __init__(self):
        self._store: dict[Any, dict] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        with self._lock:
            return len(self._store)

    def __contains__(self, key):
        with self._lock:
            return key in self._store

    def get(self, key):
        with self._lock:
            v = self._store.get(key)
            if v is None:
                self.misses += 1
            else:
                self.hits += 1
            return v

    def put(self, key, choice: dict) -> None:
        with self._lock:
            self._store[key] = choice

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"size": len(self._store), "hits": self.hits,
                    "misses": self.misses}

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


_TUNE = TuneCache()


def tune_cache() -> TuneCache:
    return _TUNE


def autotune(key: tuple, candidates: Iterable[dict],
             build: Callable[[dict], Callable], args: tuple,
             iters: int = 2) -> dict:
    """Pick the fastest candidate for one kernel site.

    `build(candidate)` returns the callable to time on `args`; `candidates`
    are dicts of KernelConfig knob overrides.  An empty grid gives {}; a
    cached key is returned as it was stored; a grid of one is stored
    without timing; otherwise the winner, with its measured `us`, is stored
    under `key`.  Neither a cached key nor a grid of one reads `args`."""
    cands = list(candidates)
    if not cands:
        return {}
    cached = _TUNE.get(key)
    if cached is not None:
        return cached
    if len(cands) == 1:
        choice = dict(cands[0])
        _TUNE.put(key, choice)
        return choice
    best, best_t = None, float("inf")
    for cand in cands:
        t = time_fn(build(cand), args, iters)
        if t < best_t:
            best, best_t = cand, t
    choice = dict(best)
    choice["us"] = best_t * 1e6
    _TUNE.put(key, choice)
    return choice
