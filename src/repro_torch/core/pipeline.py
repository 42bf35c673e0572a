"""Pipeline design (paper SS5.2, Algorithm 1).

Transforms each selected sf-node into a spatial pipeline:

  1. SplitReduction  -- reduction nodes become a parallel fan-in stage plus a
     final combining stage (the paper's queue-based reduction tree; the final
     stage lowers to the queue_reduce kernel).
  2. CreateQueue     -- every intermediate produced and consumed inside the
     sf-node gets an on-chip tile queue node between producer and consumers
     (double-buffered, in shared memory / L2).
  3. Epilogue fusion -- trivially-fusable (elementwise/norm directly after a
     GEMM with a single consumer) collapse into the producer stage, exactly
     like vertical fusion does *within* one pipeline stage.

Output: a PipelinedGraph whose stages are the load-balancing units for
Algorithm 2 (balance.py) and the pattern-matching units for the
`lower_kernels` pass (lower.py), which maps stage chains onto the
hand-written CUDA dataflow kernels in repro_torch/kernels/.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

from .graph import (MXU, VPU, Graph, Node, TensorSpec, program_struct_key)
from .patterns import Selection, SfNode

# Default on-chip queue payload: a (128 x 256) bf16 tile = 64 KiB -- the
# paper's measured sweet spot for queue bandwidth (SS4.1, Fig 5).
DEFAULT_TILE_BYTES = 64 * 1024
QUEUE_DEPTH = 2  # double buffering, as in the paper's Fig 4

# Reductions wider than this get split into fan-in + final stages.
SPLIT_REDUCTION_MIN = 8


@dataclass
class QueueSpec:
    name: str
    producer: str
    consumers: list[str]
    payload_bytes: int = DEFAULT_TILE_BYTES
    depth: int = QUEUE_DEPTH
    level: str = "vmem"  # "vmem" (intra-chip) | "ici" (inter-chip ring)
    total_bytes: float = 0.0  # total intermediate volume routed through queue


@dataclass
class Stage:
    """One pipeline stage: >=1 fused ops executing on one resource class."""
    name: str
    ops: list[Node]
    resource: str  # MXU | VPU

    @property
    def flops(self) -> float:
        return sum(n.flops for n in self.ops)

    @property
    def weight_bytes(self) -> float:
        return sum(n.weight_bytes for n in self.ops)

    @property
    def out(self) -> TensorSpec:
        return self.ops[-1].out


@dataclass
class Pipeline:
    """A pipelined sf-node: stages + queues, ready for load balancing."""
    name: str
    stages: list[Stage]
    queues: list[QueueSpec]
    sf: SfNode
    # Edges: stage name -> list of downstream stage names (via queues).
    edges: dict[str, list[str]] = field(default_factory=dict)

    def stage_by_op(self, op_name: str) -> Stage | None:
        for s in self.stages:
            if any(o.name == op_name for o in s.ops):
                return s
        return None


@dataclass
class PipelinedGraph:
    graph: Graph
    pipelines: list[Pipeline]

    @property
    def n_queues(self) -> int:
        return sum(len(p.queues) for p in self.pipelines)


def _split_reduction(g: Graph, n: Node, fanin: int) -> tuple[Node, Node]:
    """Algorithm 1 lines 2-6: replace reduction with fan-in + final stages."""
    partial = dataclasses.replace(
        n, name=n.name + ".fanin", kind="reduce_partial",
        flops=n.flops,  # the element visits happen in the fan-in stage
        attrs={**n.attrs, "fanin": fanin})
    final = dataclasses.replace(
        n, name=n.name + ".final", kind="reduce_final",
        inputs=[partial.name],
        flops=float(fanin * n.out.size),  # combine partials
        attrs={**n.attrs, "fanin": fanin})
    # splice into the graph preserving order
    new_nodes: dict[str, Node] = {}
    for name, node in g.nodes.items():
        if name == n.name:
            new_nodes[partial.name] = partial
            new_nodes[final.name] = final
        else:
            node.inputs = [final.name if i == n.name else i for i in node.inputs]
            new_nodes[name] = node
    g.nodes = new_nodes
    g.invalidate_index()
    return partial, final


def _is_epilogue_fusable(prod: Node, cons: Node, n_consumers: int) -> bool:
    """Trivially fusable: cheap VPU op directly after a GEMM, sole consumer."""
    return (prod.resource == MXU and cons.kind in ("elementwise", "norm", "softmax", "reshape")
            and n_consumers == 1)


# ---------------------------------------------------------------------------
# Algorithm 1 as individually-runnable compiler passes.
#
# The compiler front-door (core/compiler.py PassManager) runs these as named
# passes `split_reduction -> create_queues -> epilogue_fuse`; design_pipeline
# below is the convenience wrapper that runs them back to back.
# ---------------------------------------------------------------------------

@dataclass
class OpQueue:
    """An op-granularity queue intent (pre-epilogue-fusion).

    CreateQueue (Algorithm 1 step 2) operates before stages exist: every
    intermediate produced and consumed inside the sf-node gets one.  Epilogue
    fusion later collapses ops into stages; materialize_queues then drops
    intents whose endpoints landed in one stage and re-keys the rest."""
    producer: str
    consumers: list[str]
    total_bytes: float


def split_reductions(selection: Selection,
                     split_reduction_min: int = SPLIT_REDUCTION_MIN,
                     ) -> tuple[Graph, dict[str, list[str]]]:
    """Pass `split_reduction`: rewrite wide reductions in every sf-node into
    a parallel fan-in stage plus a final combining stage.

    Returns the rewritten working graph (a clone -- the caller's graph is
    never mutated) and the post-rewrite member list per sf-node."""
    g = selection.graph.clone()
    members_of: dict[str, list[str]] = {}
    for sf in selection.sf_nodes:
        members = list(sf.members)
        for m in list(members):
            n = g.nodes.get(m)
            if n is None or n.kind != "reduce" or n.attrs.get("keepdims"):
                continue
            if "_eval" in n.attrs:
                # traced non-sum reduction (max/argmax/multi-axis, from
                # core/trace.py): the generic fan-in/final rewrite assumes
                # single-axis sum semantics, so leave it whole
                continue
            if n.attrs.get("red_size", 0) >= split_reduction_min:
                partial, final = _split_reduction(g, n, fanin=min(
                    int(math.sqrt(n.attrs["red_size"])), 16))
                idx = members.index(m)
                members[idx:idx + 1] = [partial.name, final.name]
        members_of[sf.name] = members
    return g, members_of


def plan_queues(g: Graph, members: list[str]) -> list[OpQueue]:
    """Pass `create_queues`: one queue intent per intra-sf intermediate."""
    mset = set(members)
    out: list[OpQueue] = []
    for m in members:
        internal = [c.name for c in g.consumers(m) if c.name in mset]
        if internal:
            out.append(OpQueue(m, internal, float(g.nodes[m].out.nbytes)))
    return out


def fuse_epilogues(g: Graph, sf_name: str, members: list[str],
                   enable: bool = True) -> tuple[list[Stage], dict[str, Stage]]:
    """Pass `epilogue_fuse`: group member ops into pipeline stages.

    Trivially-fusable ops (cheap VPU op directly after a GEMM with a single
    consumer) collapse into the producer stage; with enable=False every op
    becomes its own stage (the unfused pipeline, useful for pass ablation)."""
    stages: list[Stage] = []
    op_to_stage: dict[str, Stage] = {}
    for m in members:
        n = g.nodes[m]
        fused = False
        if enable:
            for i in n.inputs:
                if i in op_to_stage:
                    prod_stage = op_to_stage[i]
                    prod_tail = prod_stage.ops[-1]
                    if _is_epilogue_fusable(prod_tail, n, len(g.consumers(i))):
                        prod_stage.ops.append(n)
                        op_to_stage[n.name] = prod_stage
                        fused = True
                        break
        if not fused:
            st = Stage(f"{sf_name}.s{len(stages)}", [n], n.resource)
            stages.append(st)
            op_to_stage[n.name] = st
    return stages, op_to_stage


def materialize_queues(sf_name: str, stages: list[Stage],
                       op_queues: list[OpQueue],
                       op_to_stage: dict[str, Stage],
                       tile_bytes: int = DEFAULT_TILE_BYTES,
                       ) -> tuple[list[QueueSpec], dict[str, list[str]]]:
    """Bind op-granularity queue intents to stage endpoints.

    Intents whose producer and all consumers were epilogue-fused into one
    stage vanish (the value stays in registers/shared memory of that stage)."""
    queues: list[QueueSpec] = []
    edges: dict[str, list[str]] = {s.name: [] for s in stages}
    for oq in op_queues:
        src = op_to_stage[oq.producer]
        dsts = {op_to_stage[c].name for c in oq.consumers
                if op_to_stage[c] is not src}
        if not dsts:
            continue  # consumer fused into same stage: register/shared-memory local
        queues.append(QueueSpec(
            name=f"{sf_name}.q{len(queues)}",
            producer=src.name,
            consumers=sorted(dsts),
            payload_bytes=tile_bytes,
            total_bytes=oq.total_bytes,
        ))
        edges[src.name] = sorted(set(edges[src.name]) | dsts)
    return queues, edges


# ---------------------------------------------------------------------------
# Structural program dedupe (graph-level CSE over lowerable programs)
# ---------------------------------------------------------------------------

@dataclass
class DedupeInfo:
    """Artifact of the `dedupe` pass: canonical structural keys over every
    lowerable program of the artifact (sf-node pipelines AND standalone ops).

    `struct_keys` maps program name -> `program_struct_key` (core/graph.py);
    the executor caches param-less programs under these keys, so a first
    run builds one program per `classes` bucket: N structurally equal
    unrolled layers cost ONE build, not N."""
    struct_keys: dict[str, str]
    classes: dict[str, list[str]] = field(default_factory=dict)

    def __post_init__(self):
        if not self.classes:
            for name, k in self.struct_keys.items():
                self.classes.setdefault(k, []).append(name)

    @property
    def n_programs(self) -> int:
        return len(self.struct_keys)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def hit_rate(self) -> float:
        """Fraction of programs served by another program's executable."""
        n = self.n_programs
        return (1.0 - self.n_classes / n) if n else 0.0

    def summary(self) -> str:
        dup = max((len(v) for v in self.classes.values()), default=0)
        return (f"{self.n_programs} programs -> {self.n_classes} classes "
                f"(hit rate {self.hit_rate():.2f}, largest class {dup})")


def dedupe_programs(g: Graph, members_of: dict[str, list[str]],
                    matches_of: dict[str, list] | None = None) -> DedupeInfo:
    """Pass `dedupe`: bucket the artifact's programs by structural identity.

    `members_of` gives the executable member list per sf-node program (empty
    for per-op backends); every non-free node outside an sf-node is its own
    single-op program.  `matches_of` carries the kernel matches the
    `lower_kernels` pass bound per sf-node -- match signatures enter the key
    so differently-lowered programs never share executables.  Free nodes
    (reshape/index/stack/output) never compile and are skipped."""
    matches_of = matches_of or {}
    struct_keys: dict[str, str] = {}
    covered: set[str] = set()
    for name, members in members_of.items():
        struct_keys[name] = program_struct_key(
            g, members, tuple(matches_of.get(name) or ()))
        covered.update(members)
    for n in g.topo():
        if n.name in covered or n.is_free:
            continue
        struct_keys[n.name] = program_struct_key(g, [n.name])
    return DedupeInfo(struct_keys)


def design_pipeline(selection: Selection,
                    tile_bytes: int = DEFAULT_TILE_BYTES,
                    split_reduction_min: int = SPLIT_REDUCTION_MIN) -> PipelinedGraph:
    """Algorithm 1 over every sf-node: the three passes back to back."""
    g, members_of = split_reductions(selection, split_reduction_min)
    pipelines: list[Pipeline] = []
    for sf in selection.sf_nodes:
        members = members_of[sf.name]
        op_queues = plan_queues(g, members)
        stages, op_to_stage = fuse_epilogues(g, sf.name, members)
        queues, edges = materialize_queues(sf.name, stages, op_queues,
                                           op_to_stage, tile_bytes)
        pipelines.append(Pipeline(sf.name, stages, queues, sf, edges))
    return PipelinedGraph(g, pipelines)
