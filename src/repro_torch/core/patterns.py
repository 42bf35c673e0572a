"""Subgraph selection (paper SS5.1).

Marks contiguous groups of operators ("sf-nodes") for dataflow execution by
pattern matching over the topological linearization of the graph -- the same
single-pass, regular-expression-over-op-kinds design the paper describes.

Exclusion rules (verbatim from the paper): nodes that are bulk-sync friendly
and nodes that index/gather across all data (embedding gathers) are excluded;
subgraph selection then reduces to pattern matching.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from .graph import Graph, Node

# Excluded kinds (paper's two exclusion rules).
_EXCLUDED = {"gather", "scatter", "input", "const", "output"}

# Single-letter codes make the pattern library literal regexes.
_CODE = {
    "linear": "L", "matmul": "L", "conv": "L",
    "attention": "A",
    "elementwise": "E", "concat": "E", "reshape": "E",
    "norm": "N", "softmax": "S",
    "reduce": "R", "reduce_partial": "R", "reduce_final": "R",
}


def _node_code(n: Node) -> str:
    # Kernel-hinted atomics (core/trace.py `atomic(..., lower=...)`) are
    # already fused dataflow blocks internally (e.g. the Fig-2c multicast
    # backward is five GEMMs in one node), so they anchor sf-nodes on their
    # own: code "K" + the `hinted_kernel` pattern.  Attention atomics keep
    # their "A" so the attention pipeline patterns still see them.
    if "lower_hint" in n.attrs and n.kind != "attention":
        return "K"
    return _CODE.get(n.kind, "?")

# Pattern library: regexes over the op-code string of a candidate segment.
# These express the paper's Fig-2 motifs plus attention / norm chains; adding
# a new pattern is one line (paper: "Adding new patterns is a trivial task").
PATTERN_LIBRARY: dict[str, str] = {
    # Fig 2(a): Linear -> Elementwise -> Linear (MLP with big hidden dim)
    "mlp": r"L[EN]*L",
    # Fig 2(b): producer feeding a reduction (split-K / batch-dim grads)
    "reduce_tail": r"[LEA][EN]*R",
    # Fig 2(c): multicast -- elementwise feeding >=2 GEMMs (checked on graph)
    "multicast": r"E?LL",
    # attention pipeline: (norm) qkv-proj -> attention -> out-proj
    "attention": r"N?L*AL?",
    # norm/elementwise epilogue chains around a GEMM
    "gemm_epilogue": r"[NE]*L[NES]+",
    "softmax_chain": r"LS[EL]*",
    # pure streaming chain of cheap ops (profitable: removes HBM round trips)
    "ew_chain": r"[NES]{2,}",
    # kernel-hinted atomic (fused MLP fwd/bwd from training traces): the
    # node itself is a dataflow pipeline, so any run containing one is
    # selected -- the lower_kernels pass then binds it to its kernel
    "hinted_kernel": r"K",
}


@dataclass
class SfNode:
    """A spatially-fused group of operators (one dataflow pipeline)."""
    name: str
    members: list[str]
    matched_patterns: list[str] = field(default_factory=list)

    def __len__(self):
        return len(self.members)


@dataclass
class Selection:
    graph: Graph
    sf_nodes: list[SfNode]

    @property
    def covered(self) -> set[str]:
        return {m for sf in self.sf_nodes for m in sf.members}

    def coverage(self) -> tuple[int, int]:
        """(#ops in sf-nodes, #groupable ops total) -- Table 2's 'Fusion Coverage'."""
        real = [n for n in self.graph.topo() if n.kind not in ("input", "const", "output")]
        return len(self.covered & {n.name for n in real}), len(real)


def _codes(nodes: list[Node]) -> str:
    return "".join(_node_code(n) for n in nodes)


def _match_patterns(code: str, library: dict[str, str]) -> list[str]:
    return [name for name, pat in library.items()
            if re.search(pat, code)]


def select_subgraphs(graph: Graph, min_size: int = 2,
                     patterns: "tuple[str, ...] | None" = None) -> Selection:
    """Single-pass sf-node selection over the topological order.

    Greedily accumulates maximal runs of non-excluded nodes, breaks runs at
    excluded nodes, then keeps runs that (a) match at least one library
    pattern, (b) satisfy the contiguity criterion, and (c) have >= min_size
    members. Runs failing contiguity are split at the offending node.

    `patterns` restricts matching to a subset of PATTERN_LIBRARY names
    (None = the whole library); unknown names raise KeyError.
    """
    if patterns is None:
        library = PATTERN_LIBRARY
    else:
        library = {name: PATTERN_LIBRARY[name] for name in patterns}
    sf_nodes: list[SfNode] = []
    run: list[Node] = []

    def flush():
        nonlocal run
        segment, run = run, []
        # Trim leading/trailing free nodes that add nothing to the pipeline.
        while segment and segment[0].kind == "reshape":
            segment.pop(0)
        while segment and segment[-1].kind == "reshape":
            segment.pop()
        if len(segment) < min_size:
            return
        members = {n.name for n in segment}
        if not graph.is_contiguous(members):
            # split at the midpoint and retry both halves (rare in practice)
            mid = len(segment) // 2
            for half in (segment[:mid], segment[mid:]):
                if len(half) >= min_size and graph.is_contiguous({n.name for n in half}):
                    _emit(half)
            return
        _emit(segment)

    def _emit(segment: list[Node]):
        pats = _match_patterns(_codes(segment), library)
        if not pats:
            return
        sf_nodes.append(SfNode(f"sf{len(sf_nodes)}", [n.name for n in segment], pats))

    for node in graph.topo():
        if node.kind in _EXCLUDED:
            flush()
            continue
        run.append(node)
    flush()
    return Selection(graph, sf_nodes)
