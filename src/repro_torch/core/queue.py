"""Kitsune queue primitives on the H100, the counterpart of
`repro/core/queue.py` (paper SS4.1).

The paper's queue is an L2-pinned, double-buffered ring with atomic
acquire/release.  On one card the port's kernels hand tiles between fused
stages through shared memory and L2 (kernels/); here the queue levels are
modelled for the Fig-5 reproduction: the paper's own A100 L2 queue, the
H100's L2 counterpart, and an NVLink ring between cards.

Across cards the ring queue is one process per rank: `ring_push` is one hop
to rank + 1 of the stage group (`batch_isend_irecv`), the counterpart of
`ppermute` inside `shard_map`, and `spatial_pipeline` is the GPipe-style
schedule over it: microbatch tiles stream through the stage ring, and in
steady state every stage computes at once -- Kitsune's "operators
co-execute across space" at the scale of cards.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import tree_map

# ---------------------------------------------------------------------------
# Analytic queue-performance model (reproduces the shape of paper Fig 5)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QueueLevel:
    name: str
    raw_bw: float        # B/s of the transport (L2 or NVLink)
    sync_overhead_s: float  # fixed acquire+release cost per payload
    capacity: float      # bytes before the queue spills to the next level
    spill_bw: float      # bandwidth once capacity is exceeded (HBM)


# A100 L2 queue constants from the paper (SS4.1): atomics sync, 40MB L2,
# spill to HBM at 1.5TB/s.
L2_QUEUE_A100 = QueueLevel("l2-a100", 4.7e12, 400e-9, 40e6, 1.555e12)
# H100 SXM, NVIDIA data-sheet values: 50 MB L2 spilling to 3.35 TB/s HBM3;
# the L2 rate is modelled at 3x HBM as core/costmodel.py's H100 models it
# (NVIDIA publishes none), the sync cost is the paper's atomics figure.
L2_QUEUE_H100 = QueueLevel("l2-h100", 3 * 3.35e12, 400e-9, 50e6, 3.35e12)
# H100 SXM NVLink 4 ring, NVIDIA data sheet: 900 GB/s per card (18 links).
# The ring's buffers sit in the 80 GB of HBM3, so it does not spill; the
# per-hop sync cost is a modelled ~1 us, not a data-sheet value.
NVLINK_QUEUE = QueueLevel("nvlink", 900e9, 1.0e-6, 80e9, 900e9)


def queue_bandwidth(level: QueueLevel, payload_bytes: float,
                    n_queues: int = 1, sync: bool = True) -> float:
    """Effective per-queue bandwidth for a payload size (Fig 5 analogue).

    time/payload = payload/raw_bw + sync_overhead; beyond capacity the
    transport degrades to spill bandwidth (the paper's >256KB L2 overflow).
    """
    total = payload_bytes * n_queues
    bw = level.raw_bw if total * 2 <= level.capacity else level.spill_bw
    per_queue_bw = bw / n_queues
    t = payload_bytes / per_queue_bw + (level.sync_overhead_s if sync else 0.0)
    return payload_bytes / t


# ---------------------------------------------------------------------------
# Collectives on a ring: the bytes one rank sends (the dry run's counts and
# the cost of a traced graph's collective nodes)
# ---------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

# the functional collectives (`_c10d_functional::*`) DTensor issues, by the
# reference's HLO kind; the ops of NO_WIRE move no bytes
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
NO_WIRE = frozenset({"wait_tensor", "_wrap_tensor_autograd"})


def collective_kind(op: str) -> str | None:
    """The ring-model kind of a functional collective (its op name); None
    for one of NO_WIRE.  An op the model has no kind for raises."""
    if op in NO_WIRE:
        return None
    kind = _COLLECTIVE_OPS.get(op)
    if kind is None:
        raise NotImplementedError(f"collective {op} has no ring-model kind")
    return kind


def collective_group(args):
    """(name, process group) of the group a functional collective's
    arguments name -- its last string argument -- or None where none is
    named (a wait)."""
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group
    return names[-1], _resolve_process_group(names[-1])


def wire_bytes(kind: str, nbytes: float, group_size: int) -> float:
    """Bytes one rank sends for a collective of `kind` whose result is
    `nbytes` on it, on a ring of `group_size` ranks (the reference's ring
    model, `src/repro/launch/dryrun.py` `collective_bytes`): AR 2S(n-1)/n;
    AG/A2A S(n-1)/n; RS S(n-1); permute S.  A group of one sends nothing."""
    n = group_size
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "collective-permute":
        return nbytes
    return nbytes * (n - 1) / n      # all-gather / all-to-all


# ---------------------------------------------------------------------------
# Inter-card ring queue + spatial device pipeline
# ---------------------------------------------------------------------------

def ring_spec(n: int, reverse: bool = False) -> list[tuple[int, int]]:
    """(source, destination) stage pairs of one ring hop."""
    if reverse:
        return [((i + 1) % n, i) for i in range(n)]
    return [(i, (i + 1) % n) for i in range(n)]


def ring_push(x: torch.Tensor, group=None) -> torch.Tensor:
    """One queue hop: every stage of `group` (default: the world) sends its
    tile to the next stage and returns the tile of the previous one."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + 1) % n) if group is not None else (me + 1) % n
    src = dist.get_global_rank(group, (me - 1) % n) if group is not None else (me - 1) % n
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def spatial_pipeline(stage_fn, n_stages: int, group=None):
    """Build this rank's pipelined apply over the stage group (default: the
    world; this rank's stage is its rank in the group).

    stage_fn(params_slice, x) -> y, with uniform x/y shapes across stages
    (residual-stream pipelining).  Returns fn(params, xs) where params has
    a leading stage axis of size 1 (this rank's slice) and xs is
    (n_micro, *tile), the same on every rank.

    Schedule: T = n_micro + n_stages - 1 ticks.  Each tick: every rank
    computes its stage on its current tile, then the ring queue advances
    (ring_push).  Stage 0 ingests microbatch t; the last stage emits
    microbatch t - (n_stages - 1).  The outputs live on the last stage and
    are broadcast by an all_reduce of the one-hot-masked buffer, so every
    rank returns the same value.
    """
    import torch.distributed as dist

    def pipelined(params, xs):
        stage = dist.get_rank(group)
        n_micro = xs.shape[0]
        total = n_micro + n_stages - 1
        p = tree_map(lambda t: t[0], params)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(total):
            inp = xs[min(t, n_micro - 1)] if stage == 0 else buf
            y = stage_fn(p, inp)
            m = t - (n_stages - 1)
            if stage == n_stages - 1 and m >= 0:
                outs[m] = y
            buf = ring_push(y, group)
        outs = outs * float(stage == n_stages - 1)
        dist.all_reduce(outs, group=group)
        return outs

    return pipelined


def _stage_slice(t: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's (1, ...) slice of a stage-stacked leaf: a DTensor's
    local shard (sharded on dim 0 over the stage axis), a plain tensor's
    row `stage`."""
    if hasattr(t, "to_local"):
        return t.to_local()
    return t[stage:stage + 1]


def make_spatial_pipeline(mesh, stage_fn, n_stages: int, axis_name: str = "stage"):
    """The spatial pipeline over `axis_name` of `mesh` (a DeviceMesh):
    fn(params_stacked, xs), params stage-sharded on their leading axis
    (each rank keeps its own slice), xs replicated."""
    group = mesh.get_group(axis_name)
    stage = mesh.get_local_rank(axis_name)
    fn = spatial_pipeline(stage_fn, n_stages, group)

    def run(params, xs):
        return fn(tree_map(lambda t: _stage_slice(t, stage), params), xs)

    return run
