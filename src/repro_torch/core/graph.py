"""Operator dataflow-graph IR for the Kitsune compiler.

This is an explicit, hand-built form of the operator graphs Kitsune extracts
with PyTorch Dynamo (paper SS5): a small, explicit DAG of DL operators with enough
metadata (shapes, FLOPs, bytes, resource class) for subgraph selection
(patterns.py), pipeline design (pipeline.py / Algorithm 1) and ILP load
balancing (balance.py / Algorithm 2).

Nodes are kept in topological (insertion) order -- the paper's pattern
matching operates on exactly this linearization.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np

# Resource classes: the paper's SIMT vs TENSOR CTA types.  The names are
# kept from the reference package so fingerprints agree across the two.
MXU = "MXU"
VPU = "VPU"

# Op kinds understood by the pattern library / executor.
OP_KINDS = (
    "input", "const",
    "linear",        # GEMM (+optional bias): MXU
    "matmul",        # raw GEMM: MXU
    "attention",     # fused attention block (MXU-dominant)
    "conv",          # convolution (MXU; modeled as GEMM)
    "elementwise",   # add/mul/activations: VPU
    "norm",          # layernorm / rmsnorm: VPU
    "softmax",       # VPU
    "reduce",        # sum/mean over an axis: VPU
    "reduce_partial",  # fan-in stage of a split reduction (Algorithm 1)
    "reduce_final",    # final stage of a split reduction
    "gather",        # embedding lookup / index -- excluded from sf-nodes (paper SS5.1)
    "scatter",       # excluded
    "concat",        # VPU
    "reshape",       # free
    "queue",         # inserted by pipeline design; carries tiles on-chip
    "collective",    # a cross-rank collective (core/trace.py imports
                     # DTensor's functional collectives as these): excluded
                     # from sf-nodes, costed on the NVLink queue level, and
                     # run as a program of its own in graph order
    "output",
)

_MXU_KINDS = {"linear", "matmul", "attention", "conv"}
_FREE_KINDS = {"input", "const", "reshape", "output", "queue"}


# Dtypes plain numpy cannot size without ml_dtypes: alias to a same-width type.
_DTYPE_ALIAS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
                "float8_e5m2": np.uint8, "float8_e4m3b11fnuz": np.uint8}


def _nbytes(shape: tuple[int, ...], dtype: str) -> int:
    itemsize = np.dtype(_DTYPE_ALIAS.get(dtype, dtype)).itemsize
    return int(math.prod(shape)) * itemsize


@dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: str = "bfloat16"

    @property
    def nbytes(self) -> int:
        return _nbytes(self.shape, self.dtype)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


@dataclass
class Node:
    name: str
    kind: str
    inputs: list[str] = field(default_factory=list)
    out: TensorSpec = TensorSpec((1,))
    flops: float = 0.0
    # Bytes of non-graph operands this node reads from HBM (weights/params).
    weight_bytes: float = 0.0
    attrs: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}")

    @property
    def resource(self) -> str:
        return MXU if self.kind in _MXU_KINDS else VPU

    @property
    def is_free(self) -> bool:
        return self.kind in _FREE_KINDS


class Graph:
    """A DAG of Nodes in topological (insertion) order."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: dict[str, Node] = {}
        # Lazily-built successors index: node name -> consumer names, in
        # insertion order.  Kept in sync incrementally by add(); any
        # out-of-band mutation of `nodes`/`inputs` must call
        # invalidate_index().  This turns consumers() from an O(N) rescan
        # (O(N^2) across selection/pipeline/executor loops) into O(deg).
        self._succ: dict[str, list[str]] | None = None

    # -- construction -----------------------------------------------------
    def add(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        for i in node.inputs:
            if i not in self.nodes:
                raise ValueError(f"node {node.name} references unknown input {i}")
        self.nodes[node.name] = node
        if self._succ is not None:
            self._succ[node.name] = []
            for i in dict.fromkeys(node.inputs):
                self._succ[i].append(node.name)
        return node

    def invalidate_index(self) -> None:
        """Drop the cached successors index after in-place graph surgery."""
        self._succ = None

    def _successors(self) -> dict[str, list[str]]:
        if self._succ is None:
            succ: dict[str, list[str]] = {k: [] for k in self.nodes}
            for n in self.nodes.values():
                for i in dict.fromkeys(n.inputs):
                    succ[i].append(n.name)
            self._succ = succ
        return self._succ

    # Convenience constructors with FLOP/byte accounting. ----------------
    def input(self, name: str, shape: Iterable[int], dtype: str = "bfloat16") -> Node:
        return self.add(Node(name, "input", [], TensorSpec(tuple(shape), dtype)))

    def linear(self, name: str, x: str, d_out: int, *, bias: bool = False,
               dtype: str | None = None) -> Node:
        xs = self.nodes[x].out
        d_in = xs.shape[-1]
        m = int(math.prod(xs.shape[:-1]))
        out = TensorSpec(xs.shape[:-1] + (d_out,), dtype or xs.dtype)
        wbytes = _nbytes((d_in, d_out), out.dtype) + (_nbytes((d_out,), out.dtype) if bias else 0)
        flops = 2.0 * m * d_in * d_out + (m * d_out if bias else 0)
        return self.add(Node(name, "linear", [x], out, flops, wbytes,
                             {"d_in": d_in, "d_out": d_out, "bias": bias}))

    def matmul(self, name: str, a: str, b: str, *, transpose_b: bool = False) -> Node:
        sa, sb = self.nodes[a].out, self.nodes[b].out
        m = int(math.prod(sa.shape[:-1]))
        k = sa.shape[-1]
        n = sb.shape[-2] if transpose_b else sb.shape[-1]
        out = TensorSpec(sa.shape[:-1] + (n,), sa.dtype)
        attrs = {"transpose_b": True} if transpose_b else {}
        return self.add(Node(name, "matmul", [a, b], out, 2.0 * m * k * n,
                             0.0, attrs))

    def elementwise(self, name: str, xs: list[str], fn: str = "add",
                    flop_per_elem: float = 1.0) -> Node:
        out = self.nodes[xs[0]].out
        return self.add(Node(name, "elementwise", list(xs), out,
                             flop_per_elem * out.size, 0.0, {"fn": fn}))

    def norm(self, name: str, x: str, kind: str = "rmsnorm") -> Node:
        out = self.nodes[x].out
        wbytes = _nbytes((out.shape[-1],), out.dtype)
        return self.add(Node(name, "norm", [x], out, 4.0 * out.size, wbytes, {"norm": kind}))

    def softmax(self, name: str, x: str) -> Node:
        out = self.nodes[x].out
        return self.add(Node(name, "softmax", [x], out, 5.0 * out.size))

    def reduce(self, name: str, x: str, axis: int, keepdims: bool = False) -> Node:
        xs = self.nodes[x].out
        shape = list(xs.shape)
        red = shape[axis]
        if keepdims:
            shape[axis] = 1
        else:
            shape.pop(axis % len(shape))
        out = TensorSpec(tuple(shape), xs.dtype)
        return self.add(Node(name, "reduce", [x], out, float(xs.size),
                             0.0, {"axis": axis, "red_size": red,
                                   "keepdims": keepdims}))

    def attention(self, name: str, q: str, k: str, v: str, *,
                  causal: bool = True, window: int | None = None) -> Node:
        qs, ks = self.nodes[q].out, self.nodes[k].out
        # shapes: (B, H, S, D) -- FLOPs = 2*B*H*S*S'*D * 2 (QK^T and PV)
        b, h, s, d = qs.shape
        skv = ks.shape[2]
        eff = min(window, skv) if window else skv
        frac = 0.5 if (causal and not window) else 1.0
        flops = 2 * 2.0 * b * h * s * eff * d * frac
        out = TensorSpec(qs.shape, qs.dtype)
        return self.add(Node(name, "attention", [q, k, v], out, flops,
                             0.0, {"causal": causal, "window": window}))

    def gather(self, name: str, table_shape: tuple[int, int], idx: str,
               dtype: str = "bfloat16") -> Node:
        xs = self.nodes[idx].out
        out = TensorSpec(xs.shape + (table_shape[1],), dtype)
        return self.add(Node(name, "gather", [idx], out, 0.0,
                             _nbytes(table_shape, dtype), {"table": table_shape}))

    def concat(self, name: str, xs: list[str], axis: int = -1) -> Node:
        specs = [self.nodes[x].out for x in xs]
        shape = list(specs[0].shape)
        shape[axis] = sum(s.shape[axis] for s in specs)
        return self.add(Node(name, "concat", list(xs), TensorSpec(tuple(shape), specs[0].dtype),
                             0.0, 0.0, {"axis": axis}))

    def output(self, name: str, x: str) -> Node:
        return self.add(Node(name, "output", [x], self.nodes[x].out))

    # -- structure queries -------------------------------------------------
    def topo(self) -> list[Node]:
        return list(self.nodes.values())

    def consumers(self, name: str) -> list[Node]:
        return [self.nodes[s] for s in self._successors()[name]]

    def successors_map(self) -> dict[str, list[str]]:
        return {k: list(v) for k, v in self._successors().items()}

    def is_contiguous(self, members: set[str]) -> bool:
        """Contiguity per Tarnawski et al. [47]: no path leaves the subgraph
        and re-enters it through an external node."""
        succ = self._successors()
        # External frontier reachable from members without passing through members.
        frontier = []
        for m in members:
            frontier += [s for s in succ[m] if s not in members]
        seen: set[str] = set()
        while frontier:
            u = frontier.pop()
            if u in seen:
                continue
            seen.add(u)
            for s in succ[u]:
                if s in members:
                    return False  # re-entered
                if s not in seen:
                    frontier.append(s)
        return True

    # -- aggregate stats ---------------------------------------------------
    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def intermediate_bytes(self) -> float:
        """Bytes of intermediate tensors written+read through HBM under BSP."""
        total = 0.0
        for n in self.nodes.values():
            if n.kind in ("input", "output", "const"):
                continue
            ncons = len(self.consumers(n.name))
            if ncons > 0:
                total += n.out.nbytes * (1 + ncons)  # one write + reads
        return total

    def clone(self) -> "Graph":
        g = Graph(self.name)
        for n in self.nodes.values():
            g.nodes[n.name] = dataclasses.replace(
                n, inputs=list(n.inputs), attrs=dict(n.attrs))
        return g

    def __repr__(self):
        return f"Graph({self.name}, {len(self.nodes)} nodes)"


def graph_fingerprint(g: Graph) -> str:
    """Stable content hash of a graph's structure + metadata.

    Keys the compiled-artifact cache: two graphs with identical nodes (names,
    kinds, wiring, shapes, attrs) map to the same executables.  Attr keys
    starting with "_" are implementation carriers (e.g. the traced-node eval
    closures from core/trace.py, whose repr embeds object addresses) and are
    excluded; traced nodes instead expose their semantics through the stable
    public `prim`/`params` attrs.

    This fingerprint is deliberately name- and order-SENSITIVE (it identifies
    one exact graph object across processes).  The CANONICAL identity used by
    the dedupe pass -- invariant to node naming and insertion-order jitter --
    is `structural_fingerprint` / `program_struct_key` below."""
    h = hashlib.sha256()
    for n in g.topo():
        attrs = sorted((k, v) for k, v in n.attrs.items()
                       if not k.startswith("_"))
        h.update(repr((n.name, n.kind, tuple(n.inputs), n.out.shape,
                       n.out.dtype, n.flops, n.weight_bytes, attrs)).encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Canonical structural identity (graph-level CSE / plan dedupe)
# ---------------------------------------------------------------------------

def _sha(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()


def node_struct_payload(n: Node) -> tuple:
    """Name-free structural payload of one node.

    Everything that determines the node's computation EXCEPT its wiring:
    kind, output shape/dtype, cost tags, and every public attr -- which for
    traced nodes includes `prim`/`params` (the exact primitive + static
    params), `lits` (baked literal operands, so `x + 1.0` never equals
    `x + 2.0`), and `lower_hint` (kernel-lowering configs).  Attr keys
    starting with "_" carry eval closures whose reprs embed object addresses
    and are excluded -- the property suite in tests/test_cse.py pins that
    re-traces hash identically."""
    attrs = tuple(sorted((k, repr(v)) for k, v in n.attrs.items()
                         if not k.startswith("_")))
    return (n.kind, n.out.shape, n.out.dtype, n.flops, n.weight_bytes, attrs)


def structural_hashes(g: Graph) -> dict[str, str]:
    """Per-node canonical hash: payload + recursively-hashed inputs.

    Because a node's hash depends only on WHAT it computes (payload) and the
    hashes of its producers -- never on node names or on where unrelated
    nodes sit in the insertion order -- two graphs that differ only by
    renaming or by a topology-preserving permutation of internal nodes get
    identical hash multisets.  Leaves (inputs/consts) are identified by
    their ordinal within their kind plus shape/dtype: the calling
    convention, not the name.  Const VALUES are runtime feeds (the executor
    feeds them like inputs), so they do not enter the hash -- baked literals
    do, via the `lits` attr in the payload."""
    hashes: dict[str, str] = {}
    counts = {"input": 0, "const": 0}
    for n in g.topo():
        if n.kind in ("input", "const"):
            i = counts[n.kind]
            counts[n.kind] = i + 1
            hashes[n.name] = _sha(repr(
                ("leaf", n.kind, i, n.out.shape, n.out.dtype)))
        else:
            hashes[n.name] = _sha(repr(
                (node_struct_payload(n), tuple(hashes[i] for i in n.inputs))))
    return hashes


def structural_fingerprint(g: Graph) -> str:
    """Whole-graph canonical fingerprint.

    Invariant to node naming and to insertion-order jitter among internal
    nodes (leaf order IS the calling convention and stays significant);
    sensitive to shapes, dtypes, baked consts, and lowering hints.  Hashes
    the sorted multiset of node hashes plus the ordered output hashes."""
    hashes = structural_hashes(g)
    outs = tuple(hashes[n.name] for n in g.topo() if n.kind == "output")
    return _sha(repr((sorted(hashes.values()), outs)))[:16]


def subgraph_interface(g: Graph, members: list[str],
                       match_internal: frozenset | set = frozenset(),
                       ) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(needs, exports) of the program executing `members` in order.

    `needs` is the ordered unique list of external values the program
    consumes; `exports` the members whose values are consumed outside the
    subgraph (or nowhere -- graph outputs).  `match_internal` names member
    values strictly internal to a kernel match (never exported by matcher
    contract).  This is the single source of truth for the executable
    calling convention: `_sf_program` (core/executor.py) builds the program
    from it and `program_struct_key` hashes it, so two programs with equal
    struct keys take/return the same slots in the same order."""
    mset = set(members)
    need = tuple(dict.fromkeys(
        i for m in members for i in g.nodes[m].inputs if i not in mset))
    exports = []
    for m in members:
        if m in match_internal:
            continue
        cons = g.consumers(m)
        if not cons or any(c.name not in mset for c in cons):
            exports.append(m)
    return need, tuple(exports)


def program_struct_key(g: Graph, members: list[str], matches=()) -> str:
    """Canonical identity of ONE lowerable program (sf-node or single op).

    Two programs with equal keys compute the same function of their
    positional inputs and return the same outputs in the same order, so the
    executor may bind them to ONE compiled executable (core/executor.py
    keys the cache with this when the dedupe pass runs).  Ingredients:

      * per-member `node_struct_payload` in schedule order,
      * wiring encoded positionally -- internal edges as member indices,
        external inputs as (slot in `needs`, shape, dtype),
      * export positions (which members leave the program, in which order),
      * kernel-match signatures (kernel name, meta incl. autotuned blocks,
        member positions covered, executability + verdict) -- differently
        lowered programs never share executables.

    Node names never enter the key; neither do const VALUES (runtime feeds)."""
    internal = {o for km in matches for o in km.ops if o != km.out}
    need, exports = subgraph_interface(g, members, internal)
    ext_pos = {nm: i for i, nm in enumerate(need)}
    mem_pos = {nm: i for i, nm in enumerate(members)}

    def ref(nm: str):
        if nm in mem_pos:
            return ("m", mem_pos[nm])
        spec = g.nodes[nm].out
        return ("x", ext_pos[nm], spec.shape, spec.dtype)

    body = tuple((node_struct_payload(g.nodes[m]),
                  tuple(ref(i) for i in g.nodes[m].inputs))
                 for m in members)
    match_sig = tuple(sorted(
        (km.kernel,
         tuple(sorted((k, repr(v)) for k, v in km.meta.items())),
         tuple(mem_pos[o] for o in km.ops), mem_pos[km.out],
         bool(getattr(km, "executable", True)),
         bool(getattr(km, "accepted", True)))
        for km in matches))
    out_sig = tuple(mem_pos[e] for e in exports)
    return _sha(repr((body, match_sig, out_sig)))[:16]
