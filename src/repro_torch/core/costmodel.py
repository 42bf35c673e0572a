"""Zero-latency analytic performance model (paper SS5.3) + roofline terms.

The paper's ILP is driven by exactly this kind of model: per-op bulk-sync
throughput from a roofline over the op's FLOPs and bytes, a ResourceScale
term for allocation, and Speedup(a_i)=1/u for operands arriving from on-chip
queues instead of DRAM.  One implementation serves

  * BSP / vertical-fusion / Kitsune execution-time estimates (paper Figs 10-14),
  * the lowering verdicts' estimate tier (lower.py),
  * the balance pass's allocations (balance.py),
  * the hardware-sensitivity study (`HwSpec.scaled`: the paper's 2x
    compute / 2x L2-bandwidth experiment),
  * the utilization-quadrant breakdown (paper Figs 3 / 13),
  * the (compute, memory, collective) roofline terms of one card,
  * the serving engine's per-tick KV traffic (`paged_decode_traffic`),

and `calibrate` fits its two free constants to measured wall-clock.

Two hardware specs ship: A100-class constants, which the model was
validated against (the paper's evaluation card), and H100 SXM constants,
the card this package runs on and its default.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .graph import MXU, VPU, Graph, Node
from .pipeline import Pipeline, PipelinedGraph
from .queue import NVLINK_QUEUE, queue_bandwidth


@dataclass(frozen=True)
class HwSpec:
    name: str
    n_units: int              # spatial allocation units (SMs)
    matrix_flops: float       # peak MXU/TensorCore FLOP/s (whole spec domain)
    vector_flops: float       # peak VPU/SIMT FLOP/s
    dram_bw: float            # off-chip bandwidth (B/s)
    onchip_bw: float          # queue-level bandwidth (L2) (B/s)
    onchip_capacity: float    # bytes of on-chip storage for queues/tiles
    # fraction of peak a single op realistically achieves under BSP
    eff: float = 0.85
    # per-kernel dispatch + barrier latency (launch + sync).  This term
    # produces the paper's 'Both Low' quadrant (Fig 3): tiny ops (DLRM's MLPs) are latency-bound under BSP.
    # Calibrated so subgraph speedups land in the paper's Fig-10 band.
    launch_s: float = 1.2e-6

    def scaled(self, *, compute: float = 1.0, onchip: float = 1.0,
               dram: float = 1.0) -> "HwSpec":
        """Sensitivity-study variants (paper SS6: 2x compute, 2x L2 BW, DRAM fixed)."""
        return replace(self, name=f"{self.name}[c{compute}x,l{onchip}x,d{dram}x]",
                       matrix_flops=self.matrix_flops * compute,
                       vector_flops=self.vector_flops * compute,
                       onchip_bw=self.onchip_bw * onchip,
                       dram_bw=self.dram_bw * dram)


# A100-class (paper's evaluation vehicle): 108 SMs, 312 TF/s bf16 TC,
# ~19.5 TF/s fp32 SIMT, 1.56 TB/s HBM, L2 BW ~= 3x DRAM (paper SS2), 40 MB L2.
A100 = HwSpec("A100", 108, 312e12, 19.5e12, 1.555e12, 4.7e12, 40e6)

# H100 SXM (NVIDIA data sheet, dense rates): 132 SMs, 989 TF/s bf16 tensor
# cores, 67 TF/s fp32 SIMT, 3.35 TB/s HBM3, 50 MB L2.  NVIDIA publishes no
# L2 bandwidth; like A100 it is modelled at ~3x DRAM (paper SS2).
H100 = HwSpec("H100", 132, 989e12, 67e12, 3.35e12, 3 * 3.35e12, 50e6)


# ---------------------------------------------------------------------------
# Per-op BSP times
# ---------------------------------------------------------------------------

def _peak(node_resource: str, hw: HwSpec) -> float:
    return hw.matrix_flops if node_resource == MXU else hw.vector_flops


def op_bytes_bsp(g: Graph, n: Node) -> float:
    """HBM bytes an op moves under bulk-synchronous execution."""
    in_bytes = sum(g.nodes[i].out.nbytes for i in n.inputs)
    return in_bytes + n.out.nbytes + n.weight_bytes


def op_time_bsp(g: Graph, n: Node, hw: HwSpec) -> float:
    if n.is_free:
        return 0.0
    if n.kind == "collective":
        # the bytes it sends (core/trace.py) through the NVLink queue level
        # (core/queue.py), its per-hop sync included; not vector work
        wire = n.attrs.get("wire_bytes", n.out.nbytes)
        return max(wire / queue_bandwidth(NVLINK_QUEUE, wire) if wire else 0.0,
                   hw.launch_s)
    t_compute = n.flops / (_peak(n.resource, hw) * hw.eff)
    t_mem = op_bytes_bsp(g, n) / hw.dram_bw
    return max(t_compute, t_mem, hw.launch_s)


def op_utilization(g: Graph, n: Node, hw: HwSpec) -> tuple[float, float]:
    """(compute_util, dram_util) under BSP -- drives the Fig 3/13 quadrants."""
    t = op_time_bsp(g, n, hw)
    if t == 0.0:
        return 0.0, 0.0
    t_c = n.flops / (_peak(n.resource, hw) * hw.eff)
    t_m = op_bytes_bsp(g, n) / hw.dram_bw
    return t_c / t, t_m / t  # latency-bound ops report low on both


# ---------------------------------------------------------------------------
# Subgraph times: BSP / vertical fusion / Kitsune
# ---------------------------------------------------------------------------

@dataclass
class SubgraphCost:
    mode: str
    time: float
    dram_bytes: float
    onchip_bytes: float
    detail: dict = field(default_factory=dict)


def cost_bsp(g: Graph, members: list[str], hw: HwSpec) -> SubgraphCost:
    """One kernel per op, every intermediate round-trips through DRAM."""
    t = sum(op_time_bsp(g, g.nodes[m], hw) for m in members)
    b = sum(op_bytes_bsp(g, g.nodes[m]) for m in members
            if not g.nodes[m].is_free)
    return SubgraphCost("bsp", t, b, 0.0)


def cost_vertical(g: Graph, members: list[str], hw: HwSpec) -> SubgraphCost:
    """Vertical-fusion model (TensorRT/AStitch/Welder, paper SS3 + SS6.1).

    Temporal multiplexing: op times still add (no MXU/VPU overlap).  An
    intermediate avoids its DRAM round trip only if the per-unit tile of it
    fits in on-chip capacity / n_units (each unit runs a data-parallel
    replica, so capacity divides -- the paper's footnote 1).  GEMM->GEMM
    chains with large hidden dims therefore spill, which is vertical fusion's
    coverage limitation (Fig 2a).
    """
    mset = set(members)
    per_unit_capacity = hw.onchip_capacity / max(hw.n_units, 1)
    dram = 0.0
    t = 0.0
    spilled: list[str] = []
    for m in members:
        n = g.nodes[m]
        if n.is_free:
            continue
        bytes_n = n.weight_bytes + n.out.nbytes
        # inputs from outside the fusion come from DRAM; inside: on-chip if fit
        for i in n.inputs:
            src = g.nodes[i]
            if i in mset and src.out.nbytes / max(hw.n_units, 1) <= per_unit_capacity:
                continue  # stays in a shared-memory tile
            if i in mset:
                spilled.append(i)
            dram += src.out.nbytes
            bytes_n += src.out.nbytes
        # output written to DRAM only if consumed outside or spills
        t_compute = n.flops / (_peak(n.resource, hw) * hw.eff)
        t += max(t_compute, bytes_n / hw.dram_bw)
        dram += n.weight_bytes + n.out.nbytes
    t += hw.launch_s  # one fused-kernel launch for the whole subgraph
    return SubgraphCost("vertical", t, dram, 0.0, {"spilled": spilled})


def cost_kernel_site(g: Graph, members: list[str], hw: HwSpec) -> SubgraphCost:
    """Roofline time of ONE fused dataflow kernel over `members` (a
    lower_kernels match site): intermediates internal to the match never
    leave the SM, so HBM traffic is external inputs + weights + outputs only;
    MXU and VPU work co-executes inside the kernel (the heterogeneous-CTA
    assumption), so compute terms take a max instead of summing.

    This is the kernel half of the lowering verdict (core/lower.py); the
    closure half is `cost_vertical` over the same members."""
    mset = set(members)
    mxu = vpu = 0.0
    ext = 0.0
    read: set[str] = set()
    for m in members:
        n = g.nodes[m]
        if n.is_free:
            continue
        if n.resource == MXU:
            mxu += n.flops
        else:
            vpu += n.flops
        ext += n.weight_bytes
        for i in n.inputs:
            if i not in mset and i not in read:
                read.add(i)
                ext += g.nodes[i].out.nbytes
        cons = g.consumers(m)
        if not cons or any(c.name not in mset for c in cons):
            ext += n.out.nbytes
    t = max(mxu / (hw.matrix_flops * hw.eff),
            vpu / (hw.vector_flops * hw.eff),
            ext / hw.dram_bw) + hw.launch_s
    return SubgraphCost("kernel", t, ext, 0.0)


def cost_kitsune(g: Graph, pipe: Pipeline, hw: HwSpec,
                 allocation: dict[str, int] | None = None) -> SubgraphCost:
    """Spatial dataflow: stages co-execute, tiles flow through on-chip queues.

    time = max( max_i t_i / (a_i * s_i),  DRAM bytes / BW,  queue bytes / BW )
    -- the continuous relaxation of the paper's Algorithm-2 objective; the
    integer allocation comes from balance.solve_allocation.
    """
    from .balance import solve_allocation  # local import avoids cycle
    if allocation is None:
        allocation = solve_allocation(pipe, hw)
    ext_dram = 0.0
    queue_bytes = sum(q.total_bytes * (1 + len(q.consumers)) for q in pipe.queues)
    member_ops = {o.name for s in pipe.stages for o in s.ops}
    stage_of = {o.name: s for s in pipe.stages for o in s.ops}
    for s in pipe.stages:
        ext_dram += s.weight_bytes
        for o in s.ops:
            for i in o.inputs:
                src_stage = stage_of.get(i)
                if i not in member_ops:
                    if not g.nodes[i].is_free or g.nodes[i].kind == "input":
                        ext_dram += g.nodes[i].out.nbytes  # first node reads from HBM
                # internal same-stage values live in registers/shared memory: free
            cons = g.consumers(o.name)
            if any(c.name not in member_ops for c in cons) or not cons:
                ext_dram += o.out.nbytes  # last node writes to HBM
    t_stage = 0.0
    for s in pipe.stages:
        a = max(allocation.get(s.name, 1), 1)
        per_unit = _peak(s.resource, hw) / max(hw.n_units, 1)
        t_stage = max(t_stage, s.flops / (per_unit * hw.eff * a))
    t = max(t_stage, ext_dram / hw.dram_bw, queue_bytes / hw.onchip_bw)
    t += hw.launch_s  # one cudaPipeline-style launch for the sf-node
    # The paper's selection rule #1 excludes bulk-sync-friendly subgraphs:
    # when spatial splitting loses to time-multiplexing (compute-bound
    # pipelines on few units -- e.g. llama-ctx at >50% of peak, paper
    # SS6.3), the compiler falls back to temporal (vertical) fusion --
    # Kitsune "preserves the benefits of vertical fusion" (paper SS3).
    members = [o.name for s in pipe.stages for o in s.ops]
    vert = cost_vertical(g, members, hw)
    if vert.time < t:
        return SubgraphCost("kitsune(temporal-fallback)", vert.time,
                            min(vert.dram_bytes, ext_dram), queue_bytes,
                            {"fallback": True, "pure_time": t})
    return SubgraphCost("kitsune", t, ext_dram, queue_bytes,
                        {"allocation": allocation, "pure_time": t})


# ---------------------------------------------------------------------------
# Whole-graph evaluation
# ---------------------------------------------------------------------------

@dataclass
class GraphCost:
    mode: str
    time: float
    dram_bytes: float
    subgraph_times: dict[str, float]
    bsp_time_outside: float


def evaluate(pg: PipelinedGraph, hw: HwSpec, mode: str) -> GraphCost:
    """End-to-end time: sf-nodes in `mode`, everything else BSP (paper Fig 11)."""
    g = pg.graph
    covered = {o.name for p in pg.pipelines for s in p.stages for o in s.ops}
    t_out, dram = 0.0, 0.0
    for n in g.topo():
        if n.name in covered or n.is_free:
            continue
        t_out += op_time_bsp(g, n, hw)
        dram += op_bytes_bsp(g, n)
    sub_times: dict[str, float] = {}
    t_sub = 0.0
    for p in pg.pipelines:
        members = [o.name for s in p.stages for o in s.ops]
        if mode == "bsp":
            c = cost_bsp(g, members, hw)
        elif mode == "vertical":
            c = cost_vertical(g, members, hw)
        elif mode == "kitsune":
            c = cost_kitsune(g, p, hw)
        else:
            raise ValueError(mode)
        sub_times[p.name] = c.time
        t_sub += c.time
        dram += c.dram_bytes
    return GraphCost(mode, t_out + t_sub, dram, sub_times, t_out)


def utilization_quadrants(pg: PipelinedGraph, hw: HwSpec, mode: str,
                          low: float = 0.33) -> dict[str, float]:
    """Fraction of runtime in the four (SM util x DRAM util) quadrants
    (paper Figs 3 and 13)."""
    g = pg.graph
    quad = {"both_low": 0.0, "low_sm": 0.0, "low_dram": 0.0, "neither_low": 0.0}
    covered = {o.name for p in pg.pipelines for s in p.stages for o in s.ops}

    def add(t: float, cu: float, du: float):
        if cu < low and du < low:
            quad["both_low"] += t
        elif cu < low:
            quad["low_sm"] += t
        elif du < low:
            quad["low_dram"] += t
        else:
            quad["neither_low"] += t

    for n in g.topo():
        if n.is_free or (mode == "kitsune" and n.name in covered):
            continue
        cu, du = op_utilization(g, n, hw)
        add(op_time_bsp(g, n, hw), cu, du)
    if mode == "kitsune":
        for p in pg.pipelines:
            c = cost_kitsune(g, p, hw)
            flops = sum(s.flops for s in p.stages)
            cu = flops / (hw.matrix_flops * hw.eff) / c.time if c.time else 0.0
            du = c.dram_bytes / hw.dram_bw / c.time if c.time else 0.0
            add(c.time, min(cu, 1.0), min(du, 1.0))
    total = sum(quad.values()) or 1.0
    return {k: v / total for k, v in quad.items()}


def calibrate(hw: HwSpec, samples) -> HwSpec:
    """Fit `eff` and `launch_s` to MEASURED wall-clock so the roofline
    estimates stop disagreeing with the card.

    `samples` is an iterable of (flops, dram_bytes, n_launches, measured_s)
    tuples -- e.g. one per measured app run.  We model

        measured ~= a * t_roof + b * n_launches,
        t_roof   =  max(flops / matrix_flops, dram_bytes / dram_bw),

    solve the least squares for (a, b), and read eff = 1/a (clamped to
    (0, 1]) and launch_s = b (clamped to [0, 10 ms]).  Fitted to CPU
    wall-clock it yields a tiny eff: the model then predicts host time."""
    rows, y = [], []
    for flops, dram_bytes, n_launches, measured_s in samples:
        t_roof = max(flops / hw.matrix_flops, dram_bytes / hw.dram_bw)
        rows.append([t_roof, float(max(n_launches, 1))])
        y.append(measured_s)
    if not rows:
        return hw
    coef, *_ = np.linalg.lstsq(np.asarray(rows, dtype=np.float64),
                               np.asarray(y, dtype=np.float64), rcond=None)
    a, b = float(coef[0]), float(coef[1])
    eff = min(max(1.0 / max(a, 1.0), 1e-6), 1.0) if a > 0 else hw.eff
    launch_s = min(max(b, 0.0), 1e-2)
    return replace(hw, name=f"{hw.name}[calibrated]", eff=eff, launch_s=launch_s)


# ---------------------------------------------------------------------------
# Roofline terms of one card
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


# One H100 SXM (NVIDIA data sheet, dense bf16): tensor-core peak and HBM3
# bandwidth; NVLink 4 has 18 links of 25 GB/s each way per card.
PEAK_FLOPS_PER_CHIP = H100.matrix_flops
HBM_BW_PER_CHIP = H100.dram_bw
NVLINK_BW_PER_LINK = 25e9
NVLINK_LINKS_PER_CHIP = 18
# Device memory of one H100 SXM (NVIDIA H100 data sheet: 80 GB HBM3): the
# dry run's capacity where no card is present to ask.
H100_HBM_BYTES = 80e9


def roofline(flops_per_chip: float, bytes_per_chip: float,
             collective_bytes_per_chip: float,
             links: int = NVLINK_LINKS_PER_CHIP, *,
             peak_flops: float = PEAK_FLOPS_PER_CHIP,
             hbm_bw: float = HBM_BW_PER_CHIP,
             link_bw: float = NVLINK_BW_PER_LINK) -> RooflineTerms:
    """Three roofline terms in seconds per step for one card: its FLOPs
    over the peak, its HBM bytes over the bandwidth, and the bytes it sends
    in collectives over `links` links of `link_bw` each.  Inputs are
    per-card quantities; the defaults are the H100's."""
    return RooflineTerms(
        compute_s=flops_per_chip / peak_flops,
        memory_s=bytes_per_chip / hbm_bw,
        collective_s=collective_bytes_per_chip / (link_bw * links),
    )


def paged_decode_traffic(*, batch: int, v_blocks: int, block_size: int,
                         n_steps: int, row_bytes: int, n_sites: int,
                         alloc_blocks: int | None = None) -> dict:
    """Per-tick KV bytes moved by the two paged-attention tick data paths
    (serve/engine.paged_tick).

    `row_bytes`: bytes of ONE pool row at ONE attention site (Hkv * D *
    itemsize); the returned totals cover both K and V across all `n_sites`
    (= groups * attn-layers-per-group) sites.

    gather: the pool->view materialization (read B*L rows, write B*L rows)
    happens once per tick, every decode step re-reads the dense view, and
    the trailing scatter reads the written columns and writes them back to
    their pages.
    native: every decode step reads only the table-resolved pages
    (`alloc_blocks` across the batch -- null-page references beyond a
    slot's allocation are not counted), and each step writes B rows straight
    to the pool.
    """
    view_rows = batch * v_blocks * block_size
    if alloc_blocks is None:
        alloc_blocks = batch * v_blocks
    alloc_rows = alloc_blocks * block_size
    writes = batch * n_steps
    gather_rows = 2 * view_rows + n_steps * view_rows + 2 * writes
    native_rows = n_steps * alloc_rows + writes
    # x2: K and V pools
    return {"gather_bytes": 2 * n_sites * row_bytes * gather_rows,
            "native_bytes": 2 * n_sites * row_bytes * native_rows}
