"""Load balancing (paper SS5.3, Algorithm 2).

ILP:  maximize thrpt
      s.t.    thrpt <= r_i * s_i * t_i          (i = 1..n)
              thrpt * DRAM_bytes <= DRAM_peak
              thrpt * L2_bytes   <= L2_peak
              1 <= a_i <= #units
              sum_{i in SIMT}   a_i = #units
              sum_{i in TENSOR} a_i = #units

with r_i = ResourceScale(a_i) (linear core scaling) and s_i = Speedup(a_i)
= 1/u_i (operands from on-chip queues run the op at its compute-limited
rate).  The two typed sum-constraints encode the paper's over-subscription:
each unit co-hosts one MXU-type and one VPU-type stage (the pair is fused
into one kernel and the tensor-core and SIMT issue pipelines overlap).

The objective is min-max over stages with unit-granularity allocations, so an
exact solution follows from the classic exchange argument: repeatedly give a
unit to the currently-slowest stage of each resource pool.  `solve_allocation`
implements that (O(n_units * log n)); `brute_force` exists for tests.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass

from .costmodel import HwSpec, _peak
from .graph import MXU, VPU
from .pipeline import Pipeline, Stage


def _stage_unit_time(s: Stage, hw: HwSpec) -> float:
    """Time for the stage's whole work on ONE unit at compute-limited rate
    (the queue feeds it: Speedup = 1/u applied, i.e. no DRAM stall term)."""
    per_unit = _peak(s.resource, hw) / max(hw.n_units, 1)
    return s.flops / (per_unit * hw.eff) if s.flops else 0.0


def solve_allocation(pipe: Pipeline, hw: HwSpec) -> dict[str, int]:
    """Exact min-max allocation of units to stages, per resource pool."""
    alloc: dict[str, int] = {}
    for pool in (MXU, VPU):
        stages = [s for s in pipe.stages if s.resource == pool]
        if not stages:
            continue
        n = hw.n_units
        if len(stages) > n:
            # more stages than units: time-multiplex round-robin, 1 unit each
            for s in stages:
                alloc[s.name] = 1
            continue
        # start: 1 unit per stage, then greedily feed the slowest
        heap = [(-_stage_unit_time(s, hw) / 1, s.name, 1, _stage_unit_time(s, hw))
                for s in stages]
        heapq.heapify(heap)
        remaining = n - len(stages)
        for _ in range(remaining):
            negt, name, a, t1 = heapq.heappop(heap)
            a += 1
            heapq.heappush(heap, (-t1 / a, name, a, t1))
        while heap:
            _, name, a, _ = heapq.heappop(heap)
            alloc[name] = a
    return alloc


@dataclass
class BalanceResult:
    allocation: dict[str, int]
    throughput: float          # subgraph passes per second
    binding: str               # "stage:<name>" | "dram" | "onchip"


def balance(pipe: Pipeline, hw: HwSpec, dram_bytes: float,
            onchip_bytes: float) -> BalanceResult:
    """Full Algorithm 2: allocation + bandwidth-capped throughput."""
    alloc = solve_allocation(pipe, hw)
    worst_t, worst_name = 0.0, "none"
    for s in pipe.stages:
        t = _stage_unit_time(s, hw) / max(alloc.get(s.name, 1), 1)
        if t > worst_t:
            worst_t, worst_name = t, s.name
    t_dram = dram_bytes / hw.dram_bw if dram_bytes else 0.0
    t_onchip = onchip_bytes / hw.onchip_bw if onchip_bytes else 0.0
    t_total = max(worst_t, t_dram, t_onchip) or 1e-30
    binding = {worst_t: f"stage:{worst_name}", t_dram: "dram",
               t_onchip: "onchip"}[t_total] if t_total > 1e-30 else "none"
    return BalanceResult(alloc, 1.0 / t_total, binding)


def brute_force(pipe: Pipeline, hw: HwSpec, max_units: int = 8) -> dict[str, int]:
    """Exhaustive min-max allocation for small cases (test oracle)."""
    best: dict[str, int] = {}
    best_t = float("inf")
    pools = {}
    for pool in (MXU, VPU):
        pools[pool] = [s for s in pipe.stages if s.resource == pool]

    def options(stages):
        n = min(hw.n_units, max_units)
        if not stages:
            return [()]
        return [c for c in itertools.product(range(1, n + 1), repeat=len(stages))
                if sum(c) == n] or [tuple(1 for _ in stages)]

    for mx in options(pools[MXU]):
        for vp in options(pools[VPU]):
            t = 0.0
            a = {}
            for s, ai in zip(pools[MXU], mx):
                a[s.name] = ai
                t = max(t, _stage_unit_time(s, hw) / ai)
            for s, ai in zip(pools[VPU], vp):
                a[s.name] = ai
                t = max(t, _stage_unit_time(s, hw) / ai)
            if t < best_t:
                best_t, best = t, a
    return best
