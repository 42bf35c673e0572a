"""`lower_kernels` pass: map pipelined sf-node stages onto the hand-written
Hopper kernels in repro_torch/kernels/.

The pass pattern-matches each pipeline's member ops (post split-reduction,
post epilogue-fusion) onto the kernels:

  * GEMM -> act -> GEMM chains            -> kernels.mlp (fused_mlp_fwd):
    the (M, H) hidden tile stays in shared memory, never touching HBM
  * gate/up dual-GEMM -> mul -> down GEMM -> kernels.mlp_swiglu
  * attention ops (sq == skv)             -> flash_attention
  * single-token causal attention (sq == 1) -> flash_decode
  * reduce_partial -> reduce_final pairs  -> queue_reduce: the fan-in
    partials fold through an f32 accumulator, one pass per queue pop
  * dX/dW multicast GEMMs in synthesized backward graphs -> fused_mlp_bwd
    (plan-only: those graphs are cost-model artifacts and carry no weights,
    so the match is recorded for analysis but never executed)
  * HINTED atomics in traced graphs (core/trace.py: the kernel ops of
    kernels/ops.py, and `atomic` / `atomic_vjp` ops with `lower=` hints,
    such as models/atoms.py installs for a training capture) -> EXECUTABLE
    kernel calls: fused_mlp / fused_mlp_swiglu forward, fused_mlp_bwd /
    fused_mlp_swiglu_bwd backward, flash_decode and paged_flash_decode.
    The hint pins the node's semantics, so the opacity of its eval closure
    is not a bar -- this is how the backward of a traced
    `torch.autograd.grad` training step runs the Fig 2(c) multicast kernels
    instead of replaying plain closures.

Every match is EXACT: a chain is only lowered when its intermediate values
are single-consumer-internal and the member ops' semantics are fully known,
so lowered execution is numerically interchangeable with the op-by-op path.
Anything that does not match falls back to the op-by-op path with a recorded
REASON -- `CompiledApp.describe()` prints which stages lowered and why others
did not.

Matching is necessary but NOT sufficient: a matched kernel may still lose
wall-clock to the op-by-op closure (launch overhead on tiny sites, the
plain version on the CPU).  Under `policy="auto"` (the compiler default)
every executable match also carries a profitability VERDICT: a roofline
estimate (`cost_kernel_site` vs `cost_vertical` on the compile's HwSpec,
H100 by default) decides clear-cut sites, and anything inside the
uncertainty band is settled by a one-shot compile-time microbenchmark of
both candidates on synthesized operands of the site's shapes, run on the
device the compile will run on -- on the card each candidate is captured as
a CUDA graph and its replays timed with CUDA events, as the plan would run
it.  Declined matches stay in the plan (visible in describe()) but run the
op-by-op closure.  Verdicts are cached process-wide by (policy, site
signature, HwSpec, device, capture) -- see executor.verdict_cache -- so
repeat compiles pay nothing.  `policy="always"` (the default for direct
`lower_pipelines` calls) lowers every match; `"cost"` is the estimate
alone.

On the CPU every kernel wrapper runs its plain version (the reference's
interpret mode): every in-cap site is measured and no tile is searched.  On
the card, under a policy other than "always", each executable match's tile
is searched over the knobs its Hopper launch takes (`tile_candidates` in
the kernel modules; choices cached in kernels.autotune).
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch

from ..kernels import (KernelConfig, attention, decode_attention,
                       launch_state, mlp, mlp_bwd, mlp_swiglu, mlp_swiglu_bwd,
                       paged_decode_attention, reduce, restore_launches)
from ..kernels.autotune import autotune, device_seconds, tune_cache
from ..kernels.flash_attention import decode_tile_candidates
from ..kernels.flash_attention import tile_candidates as attention_tiles
from ..kernels.fused_mlp import tile_candidates as mlp_tiles
from ..kernels.queue_reduce import tile_candidates as reduce_tiles
from . import cudagraph
from .costmodel import H100, HwSpec, cost_kernel_site, cost_vertical
from .executor import _eval_node, verdict_cache
from .graph import Graph, Node

# Activation names whose kernel implementation matches the executor's
# `_EW_FNS` exactly (same formulas on both sides).
_LOWERABLE_ACTS = ("relu", "gelu", "silu", "identity")

POLICIES = ("always", "cost", "auto")

# Estimate-tier uncertainty band (policy="auto" on the card): when the two
# roofline estimates are within this factor of each other, the analytic
# model cannot be trusted to pick a side and the site is microbenchmarked.
ESTIMATE_BAND = 1.5

# Measurement-tier decline bias: a measured kernel must beat the measured
# closure by this factor to be lowered.  Near-parity sites are exactly
# where lowering is not worth the risk of losing wall-clock.
MEASURE_MARGIN = 1.3

# Interleaved timing repetitions per candidate in the microbenchmark: the
# two candidates alternate (k, c, k, c, ...) and each keeps its min, so a
# load spike lands on both sides instead of biasing whichever candidate
# happened to be in flight.
MEASURE_REPS = 5

# Sites above these never microbenchmark: measuring means EXECUTING the
# site at compile time (the plain version, on the CPU), and full-width
# sites are both the ones the estimate decides best and the ones that cost
# most to run.  The tiny executable instances sit far below both caps.
MEASURE_CAP_BYTES = 64 << 20
MEASURE_CAP_FLOPS = 1e8


@dataclass(frozen=True)
class Target:
    """Where a lowering measures its verdicts and tiles: the device the
    compile will run on, and whether that compile's plans run as captured
    CUDA graphs (`CompilerOptions.capture`)."""
    device: torch.device
    capture: bool = True

    @property
    def interpret(self) -> bool:
        """The reference's interpret mode: off the card, where every kernel
        wrapper runs its plain version."""
        return self.device.type != "cuda"

    def name(self) -> str:
        return "cpu" if self.interpret else torch.cuda.get_device_name(self.device)


def target_for(device=None, capture: bool = True) -> Target:
    """The Target of a compile on `device` (None: the card when one is
    present, as the port's entry points default, else the CPU), with a
    CUDA device's index made explicit."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Target(device, capture)


def _kernel_cfg(target: Target, policy: str) -> KernelConfig:
    """The KernelConfig threaded through every matcher and kernel-call
    factory of one lowering.  The card searches tiles (autotune) under a
    policy that weighs sites; the CPU, where the wrappers run their plain
    versions, and "always", which lowers every match as the plan asks,
    launch the default tiles."""
    return KernelConfig(autotune=not target.interpret and policy != "always")


# ---------------------------------------------------------------------------
# plan datatypes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Verdict:
    """Profitability verdict for one executable kernel match.

    `source` records which tier decided: "cost" (roofline estimates were
    conclusive, or the site was too big or could not be synthesized to
    measure -- `note` says which), "measured" (the one-shot microbenchmark
    settled it).  A match lowered by policy ("always") has no verdict; its
    `verdict_table()` row says "forced".  Times are microseconds;
    measured fields stay None when the estimate tier decided."""
    decision: str                        # "lowered" | "declined"
    source: str                          # "cost" | "measured"
    est_kernel_us: float = 0.0
    est_closure_us: float = 0.0
    meas_kernel_us: float | None = None
    meas_closure_us: float | None = None
    note: str = ""

    @property
    def lowered(self) -> bool:
        return self.decision == "lowered"

    def reason(self) -> str:
        if self.source == "cost":
            why = f"; {self.note}" if self.note else ""
            return (f"cost est kernel {self.est_kernel_us:.1f}us vs "
                    f"closure {self.est_closure_us:.1f}us{why}")
        return (f"measured kernel {self.meas_kernel_us:.1f}us vs "
                f"closure {self.meas_closure_us:.1f}us")


@dataclass
class KernelMatch:
    """One group of sf-node member ops lowered onto one kernel call.

    `call(vals, params)` computes the value of `out` from the live value
    dict + param sub-dict; intermediate member values (strictly internal to
    the match) are never materialized.  `executable=False` marks plan-only
    matches (synthesized backward graphs, which cannot run at all).
    `verdict` is None until the profitability pass runs (policy !=
    always); a declined verdict keeps the match in the plan but routes
    execution to the op-by-op fallback.  `_factory(cfg)` rebuilds the call
    under another KernelConfig -- the block-size autotuner uses it to time
    candidates, and `tile` holds its choice (with the winner's `us` where
    it timed a grid of more than one)."""
    kernel: str
    ops: tuple[str, ...]
    out: str
    meta: dict = field(default_factory=dict)
    executable: bool = True
    verdict: Verdict | None = None
    tile: dict | None = None
    _call: Callable | None = None
    _factory: Callable | None = None

    @property
    def accepted(self) -> bool:
        return self.verdict is None or self.verdict.lowered

    def call(self, vals: dict, params: dict):
        return self._call(vals, params)

    def label(self) -> str:
        m = ",".join(f"{k}={v}" for k, v in sorted(self.meta.items()))
        return f"{self.kernel}[{m}]" if m else self.kernel


@dataclass
class PipelineLowering:
    """Lowering outcome for one sf-node pipeline."""
    sf_name: str
    matches: list[KernelMatch]
    fallbacks: dict[str, str]  # member op -> reason it stays on the op path
    tune_s: float = 0.0        # seconds spent searching tiles

    @property
    def lowered_ops(self) -> set[str]:
        return {o for m in self.matches if m.accepted for o in m.ops}


@dataclass
class LoweringPlan:
    """Per-pipeline kernel matches + fallback reasons (pass artifact)."""
    pipelines: dict[str, PipelineLowering]
    verdict_s: float = 0.0     # seconds spent deciding verdicts

    @property
    def tune_s(self) -> float:
        return sum(p.tune_s for p in self.pipelines.values())

    def matches_for(self, sf_name: str) -> list[KernelMatch]:
        pl = self.pipelines.get(sf_name)
        if pl is None:
            return []
        return [m for m in pl.matches if m.executable and m.accepted]

    def n_matches(self) -> int:
        return sum(len(p.matches) for p in self.pipelines.values())

    def lowered_ops(self) -> set[str]:
        return {o for p in self.pipelines.values() for o in p.lowered_ops}

    def kernels_used(self) -> list[str]:
        return sorted({m.kernel for p in self.pipelines.values()
                       for m in p.matches})

    def signature(self) -> tuple:
        """Hashable identity for program-cache keys: two compiles with
        different lowering decisions -- a declined site, another tile --
        must never share programs."""
        return tuple(
            (name, tuple((m.kernel, m.ops, m.executable, m.accepted,
                          tuple(sorted(m.meta.items())))
                         for m in pl.matches))
            for name, pl in sorted(self.pipelines.items()))

    def verdict_table(self) -> list[dict]:
        """Per-site verdict rows (describe surface)."""
        rows = []
        for name, pl in sorted(self.pipelines.items()):
            for m in pl.matches:
                v = m.verdict
                rows.append({
                    "pipeline": name, "kernel": m.kernel,
                    "ops": list(m.ops), "out": m.out,
                    "executable": m.executable,
                    "decision": "lowered" if m.accepted else "declined",
                    "source": v.source if v else "forced",
                    "est_kernel_us": v.est_kernel_us if v else None,
                    "est_closure_us": v.est_closure_us if v else None,
                    "meas_kernel_us": v.meas_kernel_us if v else None,
                    "meas_closure_us": v.meas_closure_us if v else None,
                    "note": v.note if v else "",
                    "tile": dict(m.tile) if m.tile is not None else None,
                })
        return rows

    def summary(self) -> str:
        n_ops = len(self.lowered_ops())
        n_fb = sum(len(p.fallbacks) for p in self.pipelines.values())
        kern = ",".join(self.kernels_used()) or "none"
        base = (f"{self.n_matches()} kernel matches ({kern}) covering "
                f"{n_ops} ops; {n_fb} ops on the op-by-op fallback path")
        verdicts = [m.verdict for p in self.pipelines.values()
                    for m in p.matches if m.verdict is not None]
        if verdicts:
            n_dec = sum(1 for v in verdicts if not v.lowered)
            n_meas = sum(1 for v in verdicts if v.source == "measured")
            base += (f"; verdicts: {len(verdicts) - n_dec} accepted, "
                     f"{n_dec} declined ({n_meas} measured) in "
                     f"{self.verdict_s:.3f} s")
        tuned = [m for p in self.pipelines.values() for m in p.matches
                 if m.tile is not None]
        if tuned:
            base += f"; {len(tuned)} tiles chosen in {self.tune_s:.3f} s"
        return base


# ---------------------------------------------------------------------------
# kernel-call closures
# ---------------------------------------------------------------------------

def _mlp_call(x_name: str, l1: str, l2: str, act: str, cfg) -> Callable:
    def call(vals, params):
        return mlp(vals[x_name], params[l1]["w"], params[l2]["w"], act=act, cfg=cfg)
    return call


def _swiglu_call(x_name: str, lg: str, lu: str, ld: str, act: str,
                 cfg) -> Callable:
    def call(vals, params):
        return mlp_swiglu(vals[x_name], params[lg]["w"], params[lu]["w"],
                          params[ld]["w"], act=act, cfg=cfg)
    return call


def _attention_call(node: Node, decode: bool, cfg) -> Callable:
    causal = bool(node.attrs.get("causal", True))
    q_name, k_name, v_name = node.inputs

    def call(vals, params):
        q, k, v = vals[q_name], vals[k_name], vals[v_name]
        if decode:
            return decode_attention(q, k, v, cfg=cfg)
        return attention(q, k, v, causal=causal, window=None, cfg=cfg)
    return call


def _queue_reduce_call(partial: Node, cfg) -> Callable:
    x_name = partial.inputs[0]

    def call(vals, params):
        part = _eval_node(partial, [vals[x_name]], None)  # (fanin, *rest)
        fan, rest = part.shape[0], part.shape[1:]
        r = int(np.prod(rest[:-1])) if len(rest) > 1 else 1
        c = int(rest[-1]) if rest else 1
        return reduce(part.reshape(fan, r, c), op="sum", cfg=cfg).reshape(rest)
    return call


_KNOBS = ("block_s", "f32_block_h", "f32_bwd_block_h", "f32_bwd_block_m")


def _node_cfg(meta: dict, cfg: KernelConfig) -> KernelConfig:
    """`cfg` with the tile a traced node's call asked for (its hint's knobs,
    or the tuned choice written over them)."""
    knobs = {k: meta[k] for k in _KNOBS if k in meta}
    return replace(cfg, **knobs) if knobs else cfg


def _atomic_mlp_fwd_call(inputs: list[str], meta: dict, cfg) -> Callable:
    x, w1, w2 = inputs
    act, cfg = meta["act"], _node_cfg(meta, cfg)

    def call(vals, params):
        return mlp(vals[x], vals[w1], vals[w2], act=act, cfg=cfg)
    return call


def _atomic_swiglu_fwd_call(inputs: list[str], meta: dict, cfg) -> Callable:
    x, wg, wu, wd = inputs
    act, cfg = meta["act"], _node_cfg(meta, cfg)

    def call(vals, params):
        return mlp_swiglu(vals[x], vals[wg], vals[wu], vals[wd], act=act, cfg=cfg)
    return call


def _atomic_mlp_bwd_call(inputs: list[str], meta: dict, cfg) -> Callable:
    x, w1, w2, dy = inputs
    act, cfg = meta["act"], _node_cfg(meta, cfg)

    def call(vals, params):
        return mlp_bwd(vals[x], vals[w1], vals[w2], vals[dy], act=act, cfg=cfg)
    return call


def _atomic_swiglu_bwd_call(inputs: list[str], meta: dict, cfg) -> Callable:
    x, wg, wu, wd, dy = inputs
    act, cfg = meta["act"], _node_cfg(meta, cfg)

    def call(vals, params):
        return mlp_swiglu_bwd(vals[x], vals[wg], vals[wu], vals[wd], vals[dy],
                              act=act, cfg=cfg)
    return call


def _decode_call(inputs: list[str], meta: dict, cfg) -> Callable:
    q, k, v, *valid = inputs
    cfg = _node_cfg(meta, cfg)

    def call(vals, params):
        vl = vals[valid[0]] if valid else meta.get("valid_int")
        return decode_attention(vals[q], vals[k], vals[v], valid_len=vl, cfg=cfg)
    return call


def _paged_decode_call(inputs: list[str], meta: dict, cfg) -> Callable:
    q, kp, vp, tbl, *valid = inputs
    bs, layer = int(meta["block_size"]), meta.get("layer")
    cfg = _node_cfg(meta, cfg)

    def call(vals, params):
        vl = vals[valid[0]] if valid else meta.get("valid_int")
        return paged_decode_attention(vals[q], vals[kp], vals[vp], vals[tbl],
                                      valid_len=vl, block_size=bs, layer=layer,
                                      cfg=cfg)
    return call


# ---------------------------------------------------------------------------
# matchers
# ---------------------------------------------------------------------------

# lower_hint family -> (kernel label, operand counts, call factory)
_HINTED_KERNELS: dict[str, tuple] = {
    "mlp_fwd": ("fused_mlp", (3,), _atomic_mlp_fwd_call),
    "swiglu_fwd": ("fused_mlp_swiglu", (4,), _atomic_swiglu_fwd_call),
    "mlp_bwd": ("fused_mlp_bwd", (4,), _atomic_mlp_bwd_call),
    "swiglu_bwd": ("fused_mlp_swiglu_bwd", (5,), _atomic_swiglu_bwd_call),
    # the decode ops carry their valid length as a tensor operand or, when
    # it was a python int, inside the node's params (meta "valid_int")
    "decode": ("flash_decode", (3, 4), _decode_call),
    "paged_decode": ("paged_flash_decode", (4, 5), _paged_decode_call),
}
_MLP_FAMILIES = ("mlp_fwd", "swiglu_fwd", "mlp_bwd", "swiglu_bwd")


def _try_hinted_atomic(g: Graph, n: Node, mset: set[str], taken: set[str],
                       note: Callable, cfg) -> KernelMatch | None:
    """Atomic nodes whose spec carries a kernel-lowering hint (core/trace.py
    `AtomicSpec.lower`).  The hint pins the node's semantics, so the opacity
    of its eval closure is NOT a bar: this is how traced training graphs get
    EXECUTABLE fused_mlp_bwd matches instead of the plan-only dX/dW analysis
    of synthesized backwards."""
    hint = n.attrs.get("lower_hint")
    if not hint:
        return None
    family, *opts = hint
    meta = dict(tuple(kv) for kv in opts)
    if family in ("attention_fwd", "attention_bwd"):
        # the training atomics keep attention single-node; the backward runs
        # the explicit recompute closure and the forward's window arrives as
        # a runtime operand -- both stay on the plain path, as in the
        # reference (no attention-backward kernel)
        note(n.name, "atomic attention: recompute/plain closure path "
                     "(window is a runtime operand; no backward kernel)")
        return None
    spec = _HINTED_KERNELS.get(family)
    if spec is None:
        note(n.name, f"unknown lower hint {family!r}")
        return None
    kernel, n_in, factory = spec
    if len(n.inputs) not in n_in:
        note(n.name, f"{kernel}: expected {' or '.join(map(str, n_in))} operands, "
                     f"got {len(n.inputs)}")
        return None
    if family in _MLP_FAMILIES:
        act = meta.get("act", "identity")
        if act not in _LOWERABLE_ACTS:
            note(n.name, f"{kernel}: act {act!r} has no kernel implementation")
            return None
        if len(g.nodes[n.inputs[0]].out.shape) < 2:
            note(n.name, f"{kernel}: input rank < 2")
            return None
    inputs = list(n.inputs)

    def make(c):
        return factory(inputs, meta, c)

    return KernelMatch(kernel, (n.name,), n.name, meta, _call=make(cfg),
                       _factory=make)


def _is_opaque(n: Node) -> bool:
    return "_eval" in n.attrs


def _sole_member_consumer(g: Graph, name: str, mset: set[str]) -> Node | None:
    cons = g.consumers(name)
    if len(cons) == 1 and cons[0].name in mset:
        return cons[0]
    return None


def _plain_linear(n: Node | None) -> bool:
    return (n is not None and n.kind == "linear" and not _is_opaque(n)
            and not n.attrs.get("bias"))


def _try_mlp(g: Graph, n: Node, mset: set[str], taken: set[str],
             note: Callable, cfg) -> KernelMatch | None:
    """L -> act -> L with single-consumer internals -> kernels.mlp."""
    if n.kind != "linear" or _is_opaque(n):
        return None
    if n.attrs.get("bias"):
        note(n.name, "fused_mlp: bias epilogue not supported by the kernel")
        return None
    if len(g.nodes[n.inputs[0]].out.shape) < 2:
        note(n.name, "fused_mlp: input rank < 2")
        return None
    act = _sole_member_consumer(g, n.name, mset)
    if (act is None or act.name in taken or act.kind != "elementwise"
            or _is_opaque(act) or len(act.inputs) != 1
            or act.attrs.get("fn") not in _LOWERABLE_ACTS):
        note(n.name, "lone GEMM: no single-consumer act->GEMM chain to fuse")
        return None
    l2 = _sole_member_consumer(g, act.name, mset)
    if not _plain_linear(l2) or l2.name in taken:
        note(n.name, "GEMM->act without a fusable second GEMM")
        return None
    fn = act.attrs["fn"]
    make = lambda c: _mlp_call(n.inputs[0], n.name, l2.name, fn, c)  # noqa: E731
    return KernelMatch(
        "fused_mlp", (n.name, act.name, l2.name), l2.name, {"act": fn},
        _call=make(cfg), _factory=make)


def _try_swiglu(g: Graph, n: Node, mset: set[str], taken: set[str],
                note: Callable, cfg) -> KernelMatch | None:
    """Gate/up dual GEMM -> elementwise mul -> down GEMM (Fig 2a SwiGLU
    shape; the builder's gate*up carries act=identity on the gate)."""
    if not _plain_linear(n) or len(g.nodes[n.inputs[0]].out.shape) < 2:
        return None
    ew = _sole_member_consumer(g, n.name, mset)
    if (ew is None or ew.name in taken or ew.kind != "elementwise"
            or _is_opaque(ew) or len(ew.inputs) != 2
            or ew.attrs.get("fn") != "mul"):
        return None
    other = ew.inputs[0] if ew.inputs[1] == n.name else ew.inputs[1]
    lu = g.nodes.get(other)
    if (not _plain_linear(lu) or lu.name in taken or lu.name not in mset
            or lu.inputs != n.inputs
            or _sole_member_consumer(g, lu.name, mset) is not ew):
        return None
    ld = _sole_member_consumer(g, ew.name, mset)
    if not _plain_linear(ld) or ld.name in taken:
        note(n.name, "dual-GEMM mul without a fusable down GEMM")
        return None
    lg, lu_ = (n.name, lu.name) if ew.inputs[0] == n.name else (lu.name, n.name)
    make = lambda c: _swiglu_call(n.inputs[0], lg, lu_, ld.name, "identity", c)  # noqa: E731
    return KernelMatch(
        "fused_mlp_swiglu", (n.name, lu.name, ew.name, ld.name), ld.name,
        {"act": "identity"}, _call=make(cfg), _factory=make)


def _try_attention(g: Graph, n: Node, mset: set[str], taken: set[str],
                   note: Callable, cfg) -> KernelMatch | None:
    if n.kind != "attention" or _is_opaque(n):
        return None
    if n.attrs.get("window"):
        note(n.name, "flash_attention: window mask not in executor semantics")
        return None
    shapes = [tuple(g.nodes[i].out.shape) for i in n.inputs]
    if len(shapes) != 3 or any(len(s) != 4 for s in shapes):
        note(n.name, "flash_attention: q/k/v must be rank-4")
        return None
    sq, skv = shapes[0][2], shapes[1][2]
    causal = bool(n.attrs.get("causal", True))
    if sq == 1 and causal:
        if skv % min(256, skv):
            # the Hopper kernel masks a ragged last chunk; the rule is kept
            # so plans agree with the reference package
            note(n.name, "flash_decode: kv length not tileable")
            return None
        make = lambda c: _attention_call(n, True, c)  # noqa: E731
        return KernelMatch("flash_decode", (n.name,), n.name, {"skv": skv},
                           _call=make(cfg), _factory=make)
    if causal and sq != skv:
        note(n.name, "flash_attention: causal offset needs sq == skv")
        return None
    if sq % min(128, sq) or skv % min(128, skv):
        # the Hopper kernel masks ragged tiles itself; the rule is kept so
        # plans agree with the reference package
        note(n.name, "flash_attention: sequence not tileable")
        return None
    make = lambda c: _attention_call(n, False, c)  # noqa: E731
    return KernelMatch("flash_attention", (n.name,), n.name,
                       {"causal": causal, "sq": sq}, _call=make(cfg), _factory=make)


def _try_queue_reduce(g: Graph, n: Node, mset: set[str], taken: set[str],
                      note: Callable, cfg) -> KernelMatch | None:
    if n.kind != "reduce_partial" or _is_opaque(n):
        return None
    fin = _sole_member_consumer(g, n.name, mset)
    if (fin is None or fin.name in taken or fin.kind != "reduce_final"
            or _is_opaque(fin) or fin.inputs != [n.name]):
        note(n.name, "queue_reduce: fan-in stage without its final stage")
        return None
    make = lambda c: _queue_reduce_call(n, c)  # noqa: E731
    return KernelMatch("queue_reduce", (n.name, fin.name), fin.name,
                       {"fanin": int(n.attrs.get("fanin", 0))},
                       _call=make(cfg), _factory=make)


def _try_mlp_bwd(g: Graph, n: Node, mset: set[str], taken: set[str],
                 note: Callable, cfg) -> KernelMatch | None:
    """Fig 2(c) multicast in SYNTHESIZED backward graphs: the upstream grad
    feeds both the dX GEMM and a dW GEMM.  Those graphs are cost-model-only
    (single-input matmuls, no weights), so the match is plan-only."""
    if n.kind != "matmul" or _is_opaque(n) or len(n.inputs) != 1:
        return None
    dname = n.inputs[0]
    dw = next((c for c in g.consumers(dname)
               if c.name != n.name and c.name in mset and c.name not in taken
               and c.kind == "matmul" and len(c.inputs) == 2
               and dname in c.inputs and not _is_opaque(c)), None)
    if dw is None:
        return None
    return KernelMatch("fused_mlp_bwd", (n.name, dw.name), n.name,
                       {"multicast": dname}, executable=False)


_MATCHERS = (_try_hinted_atomic, _try_attention, _try_queue_reduce,
             _try_swiglu, _try_mlp, _try_mlp_bwd)


# ---------------------------------------------------------------------------
# microbenchmark + autotune plumbing
# ---------------------------------------------------------------------------

class SiteNotSynthesizable(ValueError):
    """A match site's operands cannot be made up from the graph alone."""


def _external_inputs(g: Graph, km: KernelMatch) -> list[str]:
    """Graph values a match reads from outside itself, in first-use order."""
    opset = set(km.ops)
    ext: list[str] = []
    for op in km.ops:
        for i in g.nodes[op].inputs:
            if i not in opset and i not in ext:
                ext.append(i)
    return ext


def _param_kinds(n: Node) -> bool:
    return n.kind in ("linear", "norm", "gather") and not _is_opaque(n)


def _torch_dtype(name: str, what: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise SiteNotSynthesizable(f"{what} has dtype {name!r}")
    return dt


def _int_operands(g: Graph, km: KernelMatch) -> dict[str, Callable]:
    """Integer operands a decode kernel reads as data, made up so that a
    measurement reads what a real call reads: every position valid, and
    block tables that point at the pool's own pages.  Other integer
    operands are zeros."""
    ins = g.nodes[km.ops[0]].inputs
    if km.kernel == "flash_decode" and len(ins) == 4:
        s_len = g.nodes[ins[1]].out.shape[2]
        return {ins[3]: lambda shape, dt, gen, dev: torch.full(shape, s_len, dtype=dt,
                                                                device=dev)}
    if km.kernel == "paged_flash_decode":
        bs = int(km.meta["block_size"])
        pages = g.nodes[ins[1]].out.shape[0] // bs
        n_table = g.nodes[ins[3]].out.shape[1]
        ops = {ins[3]: lambda shape, dt, gen, dev: torch.randint(
            0, max(pages, 1), shape, generator=gen, device=dev).to(dt)}
        if len(ins) == 5:
            ops[ins[4]] = lambda shape, dt, gen, dev: torch.full(
                shape, n_table * bs, dtype=dt, device=dev)
        return ops
    return {}


def _synth_site(g: Graph, km: KernelMatch, device) -> tuple[dict, dict]:
    """Deterministic operands + weights of the site's shapes on `device`.

    Random (non-zero) floats from one seeded generator, weights in
    executor.init_params' layout (linear w=(d_in, d_out), norm g, gather
    table); integer operands are zeros but for the decode kernels' valid
    lengths and block tables (`_int_operands`).  Raises
    SiteNotSynthesizable for an operand no tensor can stand in for."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ints = _int_operands(g, km)

    def synth(name: str, shape, dtype: str, what: str) -> torch.Tensor:
        dt = _torch_dtype(dtype, what)
        shape = tuple(int(d) for d in shape)
        if dt.is_floating_point:
            return torch.randn(shape, generator=gen, device=device).to(dt)
        if name in ints:
            return ints[name](shape, dt, gen, device)
        return torch.zeros(shape, dtype=dt, device=device)

    vals = {}
    for name in _external_inputs(g, km):
        n = g.nodes[name]
        if "n_outs" in n.attrs:
            raise SiteNotSynthesizable(f"operand {name} is tuple-valued")
        vals[name] = synth(name, n.out.shape, n.out.dtype, f"operand {name}")
    params: dict[str, Any] = {}
    for op in km.ops:
        n = g.nodes[op]
        if not _param_kinds(n):
            continue
        dt = n.out.dtype
        if n.kind == "linear":
            params[op] = {"w": synth("", (n.attrs["d_in"], n.attrs["d_out"]), dt, op)}
            if n.attrs.get("bias"):
                params[op]["b"] = torch.zeros((n.attrs["d_out"],),
                                              dtype=_torch_dtype(dt, op), device=device)
        elif n.kind == "norm":
            params[op] = {"g": torch.ones((n.out.shape[-1],), dtype=_torch_dtype(dt, op),
                                          device=device)}
        elif n.kind == "gather":
            params[op] = {"table": synth("", n.attrs["table"], dt, op)}
    return vals, params


def _site_runner(g: Graph, km: KernelMatch, vals: dict, params: dict):
    """(make_kernel_fn, closure_fn, args): flat-argument callables over the
    synthesized operands and weights -- the kernel call, and the op-by-op
    closure of the same members."""
    names = list(vals)
    nv = len(names)
    pnames = [(op, k) for op, p in params.items() for k in p]
    args = tuple(vals[n] for n in names) + tuple(params[op][k] for op, k in pnames)

    def unpack(flat):
        v = dict(zip(names, flat[:nv]))
        p: dict[str, dict] = {}
        for (op, k), t in zip(pnames, flat[nv:]):
            p.setdefault(op, {})[k] = t
        return v, p

    def make_kernel_fn(call):
        def kernel_fn(*flat):
            v, p = unpack(flat)
            return call(v, p)
        return kernel_fn

    def closure_fn(*flat):
        v, p = unpack(flat)
        for op in km.ops:  # km.ops is topo-ordered by construction
            n = g.nodes[op]
            v[op] = _eval_node(n, [v[i] for i in n.inputs], p.get(op))
        return v[km.out]

    return make_kernel_fn, closure_fn, args


def _measurable(g: Graph, km: KernelMatch) -> bool:
    """Whether a site is small enough to execute at compile time."""
    flops = sum(float(g.nodes[op].flops) for op in km.ops)
    if flops > MEASURE_CAP_FLOPS:
        return False
    total = sum(g.nodes[i].out.nbytes for i in _external_inputs(g, km))
    total += sum(int(g.nodes[op].weight_bytes or 0) for op in km.ops)
    return total + g.nodes[km.out].out.nbytes <= MEASURE_CAP_BYTES


@contextlib.contextmanager
def _uncounted():
    """Launches inside do not count: the kernel counters say what a path
    ran, and a compile-time measurement is no part of any path."""
    state = launch_state()
    try:
        yield
    finally:
        restore_launches(state)


def _capture(fn: Callable, device, what: str) -> cudagraph.CapturedGraph:
    return cudagraph.CapturedGraph(fn, device, what=what, count_warm_up=False)


@contextlib.contextmanager
def _measuring(target: Target):
    """The scope of one site's timing: no grad, launches uncounted, and on
    the card never inside a capture, with the capture lock held throughout
    when the plans are captured (no other capture interleaves with the
    timed replays; it is taken before any cache lock, as every capture
    takes it)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        stack.enter_context(_uncounted())
        if not target.interpret:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a lowering measures its sites at compile time, "
                                   "never inside a CUDA graph capture")
            if target.capture:
                stack.enter_context(cudagraph.capture_lock())
        yield


def _timer(target: Target) -> Callable[[Callable], float]:
    """Seconds of one run of a runnable as the compile's plan pays them: on
    the card a replay's device time (`device_seconds`: the launch latency
    of the plan's one graph is not the site's), a walk's device time with
    the host's gaps between its launches (CUDA events around it); on the
    CPU the host clock."""
    if target.interpret:
        def host(run):
            t0 = time.perf_counter()
            run()
            return time.perf_counter() - t0
        return host
    if target.capture:
        return device_seconds

    def walk(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    return walk


def _measure_site(g: Graph, km: KernelMatch, target: Target) -> tuple[float, float]:
    """One-shot microbenchmark of the kernel call vs the op-by-op closure
    over the SAME member ops on synthesized operands, on the compile's
    device and as its plan runs (captured and replayed, or walked).
    Returns (kernel_s, closure_s); results are cached upstream in the
    verdict cache, so each unique site pays this once per process.

    The candidates are timed INTERLEAVED (min of MEASURE_REPS alternating
    runs each): back-to-back blocks would let one load spike decide the
    verdict."""
    vals, params = _synth_site(g, km, target.device)
    make_kernel_fn, closure_fn, args = _site_runner(g, km, vals, params)
    fns = {"kernel": make_kernel_fn(km._call), "closure": closure_fn}
    timed = _timer(target)
    captured = not target.interpret and target.capture
    with _measuring(target):
        if captured:   # each candidate replayed, as the compile's plan runs it
            runs = [_capture(lambda f=f: f(*args), target.device,
                             f"{what} of {km.kernel} at {km.out}").replay
                    for what, f in fns.items()]
        else:
            runs = [lambda f=f: f(*args) for f in fns.values()]
        t_kernel, t_closure = _interleaved(runs, timed)
        del runs      # the candidates' graphs go with their last references...
        if captured:
            torch.cuda.empty_cache()    # ...and their pools back to the card
    return t_kernel, t_closure


def _interleaved(runs: list, timed: Callable) -> list[float]:
    """One warm-up run of each (builds, first-use steps, a graph's upload),
    then the min of MEASURE_REPS timed runs each, taken in turns."""
    for run in runs:
        run()
    best = [float("inf")] * len(runs)
    for _ in range(MEASURE_REPS):
        for i, run in enumerate(runs):
            best[i] = min(best[i], timed(run))
    return best


def _shape_sig(g: Graph, km: KernelMatch) -> tuple:
    """Name-independent shape/dtype/structure identity of a match site."""
    relevant = ("fn", "act", "causal", "d_in", "d_out", "bias", "fanin",
                "transpose_b", "window", "n_outs", "lower_hint", "table")
    ext = tuple((tuple(g.nodes[i].out.shape), g.nodes[i].out.dtype)
                for i in _external_inputs(g, km))
    ops_sig = tuple(
        (g.nodes[op].kind, g.nodes[op].weight_bytes,
         tuple((k, tuple(v) if isinstance(v, list) else v)
               for k, v in sorted(g.nodes[op].attrs.items())
               if k in relevant))
        for op in km.ops)
    out = g.nodes[km.out].out
    return (km.kernel, tuple(sorted(km.meta.items())), ext, ops_sig,
            (tuple(out.shape), out.dtype))


def _tile_grid(g: Graph, km: KernelMatch) -> list[dict]:
    """Per-kernel knob grid for one match site (shapes read statically off
    the graph; the kernel modules own the grids)."""
    first = g.nodes[km.ops[0]]
    if km.kernel in ("fused_mlp", "fused_mlp_swiglu", "fused_mlp_bwd",
                     "fused_mlp_swiglu_bwd"):
        x = g.nodes[first.inputs[0]].out
        m = math.prod(x.shape[:-1])
        if first.kind == "linear":
            h = int(first.attrs["d_out"])
        else:  # hinted atomic: hidden width off the first weight operand
            h = int(g.nodes[first.inputs[1]].out.shape[-1])
        return mlp_tiles(m, h, x.dtype, gated="swiglu" in km.kernel,
                         backward=km.kernel.endswith("_bwd"))
    if km.kernel == "flash_attention":
        q, k = (g.nodes[i].out.shape for i in first.inputs[:2])
        return attention_tiles(q[2], k[2])
    if km.kernel == "flash_decode":
        return decode_tile_candidates(g.nodes[first.inputs[1]].out.shape[2])
    if km.kernel == "paged_flash_decode":
        # chunks cover whole pages of the slot's table, not of the pool
        bs = int(km.meta["block_size"])
        return decode_tile_candidates(g.nodes[first.inputs[3]].out.shape[1] * bs, bs)
    if km.kernel == "queue_reduce":
        rest = first.out.shape[1:]
        return reduce_tiles(math.prod(rest[:-1]) if len(rest) > 1 else 1)
    return []


def _tune_match(g: Graph, km: KernelMatch, cfg: KernelConfig,
                target: Target) -> KernelConfig:
    """Search the kernel's knob grid on synthesized operands on the
    compile's device; returns the winning KernelConfig (choices cached in
    kernels.autotune by name-independent site signature + device + capture
    flag; a grid of one is cached untimed).  The candidates differ only in
    one kernel's tile, so each is timed as a call (`time_fn`: on the card
    device time behind a sleep kernel, which hides the host's launch work,
    as a replay does).  A site whose operands cannot be synthesized keeps
    the default tile."""
    cands = _tile_grid(g, km)
    if not cands or km._factory is None:
        return cfg
    key = ("tune", _shape_sig(g, km), target.name(), target.capture)
    build, args = None, ()
    if len(cands) > 1 and key not in tune_cache():
        try:
            vals, params = _synth_site(g, km, target.device)
        except SiteNotSynthesizable:
            return cfg
        make_kernel_fn, _, args = _site_runner(g, km, vals, params)

        def build(cand):
            return make_kernel_fn(km._factory(replace(cfg, **cand)))
    with _measuring(replace(target, capture=False)):
        choice = autotune(key, cands, build, args, iters=MEASURE_REPS)
    km.tile = choice
    blocks = {k: v for k, v in choice.items() if k != "us"}
    if not blocks:
        return cfg
    km.meta.update(blocks)
    return replace(cfg, **blocks)


# ---------------------------------------------------------------------------
# profitability verdicts
# ---------------------------------------------------------------------------

def _verdict_key(g: Graph, km: KernelMatch, hw: HwSpec, target: Target,
                 policy: str) -> tuple:
    return ("verdict", policy, _shape_sig(g, km), hw, target.name(), target.capture)


def _decide(g: Graph, km: KernelMatch, hw: HwSpec, policy: str,
            target: Target) -> Verdict:
    """Two-tier profitability decision for one executable match.

    Tier 1 (roofline): `cost_kernel_site` vs `cost_vertical` over the same
    members on `hw`.  Conclusive on the card when the estimates differ by
    more than ESTIMATE_BAND.  Tier 2 (measurement): on the CPU the model
    cannot predict host wall-clock (both candidates run plain torch ops),
    so `policy="auto"` always falls through to the microbenchmark there --
    unless the site exceeds the MEASURE_CAP_* limits, where the estimate is
    the verdict.  A site whose operands cannot be synthesized keeps its
    estimate, and the verdict says why; any other failure of a measurement
    (a CUDA error, a kernel that does not build) raises."""
    members = list(km.ops)
    est_k = cost_kernel_site(g, members, hw).time * 1e6
    est_c = cost_vertical(g, members, hw).time * 1e6
    by_estimate = "lowered" if est_k <= est_c else "declined"
    if policy == "cost":
        return Verdict(by_estimate, "cost", est_k, est_c)
    if not target.interpret:
        if est_k * ESTIMATE_BAND <= est_c:
            return Verdict("lowered", "cost", est_k, est_c)
        if est_c * ESTIMATE_BAND <= est_k:
            return Verdict("declined", "cost", est_k, est_c)
    if not _measurable(g, km):
        # too big to execute at compile time -- the estimate is the verdict
        return Verdict(by_estimate, "cost", est_k, est_c)
    try:
        t_k, t_c = _measure_site(g, km, target)
    except SiteNotSynthesizable as exc:
        return Verdict(by_estimate, "cost", est_k, est_c, note=f"not measured: {exc}")
    mk, mc = t_k * 1e6, t_c * 1e6
    dec = "lowered" if mk * MEASURE_MARGIN <= mc else "declined"
    return Verdict(dec, "measured", est_k, est_c, mk, mc)


def _apply_verdicts(g: Graph, plan: LoweringPlan, hw: HwSpec, policy: str,
                    target: Target) -> None:
    vc = verdict_cache()
    t0 = time.perf_counter()
    for pl in plan.pipelines.values():
        for km in pl.matches:
            if not km.executable:
                continue
            key = _verdict_key(g, km, hw, target, policy)
            v = vc.get(key)
            if v is None:
                v = _decide(g, km, hw, policy, target)
                vc.put(key, v)
            km.verdict = v
            if not v.lowered:
                for op in km.ops:
                    pl.fallbacks.setdefault(
                        op, f"declined {km.kernel}: {v.reason()}")
    plan.verdict_s = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# pass body
# ---------------------------------------------------------------------------

def lower_pipeline(g: Graph, sf_name: str, members: list[str], *,
                   cfg: KernelConfig | None = None,
                   target: Target | None = None) -> PipelineLowering:
    """Greedy scan of the member list (topo order) against the kernel
    matchers; unmatched non-free ops get a fallback reason.  With
    `cfg.autotune` each executable match's tile is searched on `target`."""
    target = target or target_for()
    if cfg is None:
        cfg = _kernel_cfg(target, "always")
    mset = set(members)
    taken: set[str] = set()
    matches: list[KernelMatch] = []
    notes: dict[str, str] = {}
    tune_s = 0.0

    def note(op: str, why: str) -> None:
        notes.setdefault(op, why)

    for m in members:
        if m in taken:
            continue
        n = g.nodes[m]
        for matcher in _MATCHERS:
            km = matcher(g, n, mset, taken, note, cfg)
            if km is not None:
                if cfg.autotune and km.executable and km._factory is not None:
                    t0 = time.perf_counter()
                    km._call = km._factory(_tune_match(g, km, cfg, target))
                    tune_s += time.perf_counter() - t0
                matches.append(km)
                taken.update(km.ops)
                break
    fallbacks: dict[str, str] = {}
    for m in members:
        if m in taken:
            continue
        n = g.nodes[m]
        if n.is_free:
            continue
        if m in notes:
            fallbacks[m] = notes[m]
        elif _is_opaque(n):
            fallbacks[m] = ("traced node: closure semantics opaque to the "
                            "kernel matcher")
        else:
            fallbacks[m] = f"no kernel pattern for {n.kind}"
    return PipelineLowering(sf_name, matches, fallbacks, tune_s)


def lower_pipelines(g: Graph, members_of: dict[str, list[str]], *,
                    cfg: KernelConfig | None = None, hw: HwSpec | None = None,
                    policy: str = "always",
                    target: Target | None = None) -> LoweringPlan:
    """The `lower_kernels` pass body: one PipelineLowering per sf-node.

    `policy` selects the profitability gate on executable matches:
      * "always" -- every match lowers, at the default tiles unless `cfg`
        asks for autotuning (the default for direct calls, so
        kernel-coverage tests stay force-lowered),
      * "cost"   -- roofline estimates on `hw` (default H100) alone decide,
      * "auto"   -- estimates decide clear-cut sites, the uncertainty band
        (and every site on the CPU) falls through to a one-shot
        microbenchmark; the compiler's default.
    `target` is where verdicts and tiles are measured (default: the card
    when one is present, plans captured).  Verdicts are cached
    process-wide (executor.verdict_cache) by name-independent site
    signature, so repeat compiles pay nothing."""
    if policy not in POLICIES:
        raise ValueError(f"unknown lowering policy {policy!r} "
                         f"(known: {POLICIES})")
    target = target or target_for()
    if cfg is None:
        cfg = _kernel_cfg(target, policy)
    plan = LoweringPlan({name: lower_pipeline(g, name, members, cfg=cfg,
                                              target=target)
                         for name, members in members_of.items()})
    if policy != "always":
        _apply_verdicts(g, plan, hw if hw is not None else H100, policy, target)
    return plan
