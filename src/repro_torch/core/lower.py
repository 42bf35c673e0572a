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

Not ported yet (the reference has them): the "auto" lowering policy's
compile-time microbenchmark and the block-size autotuner.  Policies here:
"always" (the default) lowers every match, "cost"
lets the roofline model (`cost_kernel_site` vs `cost_vertical` on the
compile's HwSpec) accept or decline each site.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..kernels import (attention, decode_attention, mlp, mlp_bwd, mlp_swiglu,
                       mlp_swiglu_bwd, paged_decode_attention, reduce)
from .costmodel import H100, HwSpec, cost_kernel_site, cost_vertical
from .executor import _eval_node
from .graph import Graph, Node

# Activation names whose kernel implementation matches the executor's
# `_EW_FNS` exactly (same formulas on both sides).
_LOWERABLE_ACTS = ("relu", "gelu", "silu", "identity")

POLICIES = ("always", "cost")


# ---------------------------------------------------------------------------
# plan datatypes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Verdict:
    """Profitability verdict for one executable kernel match under the
    "cost" policy: the roofline estimates (microseconds) that decided it."""
    decision: str                        # "lowered" | "declined"
    source: str                          # "cost"
    est_kernel_us: float = 0.0
    est_closure_us: float = 0.0

    @property
    def lowered(self) -> bool:
        return self.decision == "lowered"

    def reason(self) -> str:
        return (f"cost est kernel {self.est_kernel_us:.1f}us vs "
                f"closure {self.est_closure_us:.1f}us")


@dataclass
class KernelMatch:
    """One group of sf-node member ops lowered onto one kernel call.

    `call(vals, params)` computes the value of `out` from the live value
    dict + param sub-dict; intermediate member values (strictly internal to
    the match) are never materialized.  `executable=False` marks plan-only
    matches (synthesized backward graphs, which cannot run at all).
    `verdict` is None unless the "cost" policy ran; a declined verdict keeps
    the match in the plan but routes execution to the op-by-op fallback."""
    kernel: str
    ops: tuple[str, ...]
    out: str
    meta: dict = field(default_factory=dict)
    executable: bool = True
    verdict: Verdict | None = None
    _call: Callable | None = None

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

    @property
    def lowered_ops(self) -> set[str]:
        return {o for m in self.matches if m.accepted for o in m.ops}


@dataclass
class LoweringPlan:
    """Per-pipeline kernel matches + fallback reasons (pass artifact)."""
    pipelines: dict[str, PipelineLowering]

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
        different lowering decisions must never share programs."""
        return tuple(
            (name, tuple((m.kernel, m.ops, m.executable, m.accepted)
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
            base += (f"; verdicts: {len(verdicts) - n_dec} accepted, "
                     f"{n_dec} declined")
        return base


# ---------------------------------------------------------------------------
# kernel-call closures
# ---------------------------------------------------------------------------

def _mlp_call(x_name: str, l1: str, l2: str, act: str) -> Callable:
    def call(vals, params):
        return mlp(vals[x_name], params[l1]["w"], params[l2]["w"], act=act)
    return call


def _swiglu_call(x_name: str, lg: str, lu: str, ld: str,
                 act: str) -> Callable:
    def call(vals, params):
        return mlp_swiglu(vals[x_name], params[lg]["w"], params[lu]["w"],
                          params[ld]["w"], act=act)
    return call


def _attention_call(node: Node, decode: bool) -> Callable:
    causal = bool(node.attrs.get("causal", True))
    q_name, k_name, v_name = node.inputs

    def call(vals, params):
        q, k, v = vals[q_name], vals[k_name], vals[v_name]
        if decode:
            return decode_attention(q, k, v)
        return attention(q, k, v, causal=causal, window=None)
    return call


def _queue_reduce_call(partial: Node) -> Callable:
    x_name = partial.inputs[0]

    def call(vals, params):
        part = _eval_node(partial, [vals[x_name]], None)  # (fanin, *rest)
        fan, rest = part.shape[0], part.shape[1:]
        r = int(np.prod(rest[:-1])) if len(rest) > 1 else 1
        c = int(rest[-1]) if rest else 1
        return reduce(part.reshape(fan, r, c), op="sum").reshape(rest)
    return call


def _atomic_mlp_fwd_call(inputs: list[str], meta: dict) -> Callable:
    x, w1, w2 = inputs
    act = meta["act"]

    def call(vals, params):
        return mlp(vals[x], vals[w1], vals[w2], act=act)
    return call


def _atomic_swiglu_fwd_call(inputs: list[str], meta: dict) -> Callable:
    x, wg, wu, wd = inputs
    act = meta["act"]

    def call(vals, params):
        return mlp_swiglu(vals[x], vals[wg], vals[wu], vals[wd], act=act)
    return call


def _atomic_mlp_bwd_call(inputs: list[str], meta: dict) -> Callable:
    x, w1, w2, dy = inputs
    act = meta["act"]

    def call(vals, params):
        return mlp_bwd(vals[x], vals[w1], vals[w2], vals[dy], act=act)
    return call


def _atomic_swiglu_bwd_call(inputs: list[str], meta: dict) -> Callable:
    x, wg, wu, wd, dy = inputs
    act = meta["act"]

    def call(vals, params):
        return mlp_swiglu_bwd(vals[x], vals[wg], vals[wu], vals[wd], vals[dy],
                              act=act)
    return call


def _decode_call(inputs: list[str], meta: dict) -> Callable:
    q, k, v, *valid = inputs

    def call(vals, params):
        vl = vals[valid[0]] if valid else meta.get("valid_int")
        return decode_attention(vals[q], vals[k], vals[v], valid_len=vl)
    return call


def _paged_decode_call(inputs: list[str], meta: dict) -> Callable:
    q, kp, vp, tbl, *valid = inputs
    bs, layer = int(meta["block_size"]), meta.get("layer")

    def call(vals, params):
        vl = vals[valid[0]] if valid else meta.get("valid_int")
        return paged_decode_attention(vals[q], vals[kp], vals[vp], vals[tbl],
                                      valid_len=vl, block_size=bs, layer=layer)
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
                       note: Callable) -> KernelMatch | None:
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
    return KernelMatch(kernel, (n.name,), n.name, meta,
                       _call=factory(list(n.inputs), meta))


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
             note: Callable) -> KernelMatch | None:
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
    return KernelMatch(
        "fused_mlp", (n.name, act.name, l2.name), l2.name, {"act": fn},
        _call=_mlp_call(n.inputs[0], n.name, l2.name, fn))


def _try_swiglu(g: Graph, n: Node, mset: set[str], taken: set[str],
                note: Callable) -> KernelMatch | None:
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
    return KernelMatch(
        "fused_mlp_swiglu", (n.name, lu.name, ew.name, ld.name), ld.name,
        {"act": "identity"},
        _call=_swiglu_call(n.inputs[0], lg, lu_, ld.name, "identity"))


def _try_attention(g: Graph, n: Node, mset: set[str], taken: set[str],
                   note: Callable) -> KernelMatch | None:
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
        return KernelMatch("flash_decode", (n.name,), n.name, {"skv": skv},
                           _call=_attention_call(n, True))
    if causal and sq != skv:
        note(n.name, "flash_attention: causal offset needs sq == skv")
        return None
    if sq % min(128, sq) or skv % min(128, skv):
        # the Hopper kernel masks ragged tiles itself; the rule is kept so
        # plans agree with the reference package
        note(n.name, "flash_attention: sequence not tileable")
        return None
    return KernelMatch("flash_attention", (n.name,), n.name,
                       {"causal": causal, "sq": sq},
                       _call=_attention_call(n, False))


def _try_queue_reduce(g: Graph, n: Node, mset: set[str], taken: set[str],
                      note: Callable) -> KernelMatch | None:
    if n.kind != "reduce_partial" or _is_opaque(n):
        return None
    fin = _sole_member_consumer(g, n.name, mset)
    if (fin is None or fin.name in taken or fin.kind != "reduce_final"
            or _is_opaque(fin) or fin.inputs != [n.name]):
        note(n.name, "queue_reduce: fan-in stage without its final stage")
        return None
    return KernelMatch("queue_reduce", (n.name, fin.name), fin.name,
                       {"fanin": int(n.attrs.get("fanin", 0))},
                       _call=_queue_reduce_call(n))


def _try_mlp_bwd(g: Graph, n: Node, mset: set[str], taken: set[str],
                 note: Callable) -> KernelMatch | None:
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
# profitability verdicts ("cost" policy)
# ---------------------------------------------------------------------------

def _decide(g: Graph, km: KernelMatch, hw: HwSpec) -> Verdict:
    members = list(km.ops)
    est_k = cost_kernel_site(g, members, hw).time * 1e6
    est_c = cost_vertical(g, members, hw).time * 1e6
    return Verdict("lowered" if est_k <= est_c else "declined", "cost",
                   est_k, est_c)


def _apply_verdicts(g: Graph, plan: LoweringPlan, hw: HwSpec) -> None:
    for pl in plan.pipelines.values():
        for km in pl.matches:
            if not km.executable:
                continue
            km.verdict = v = _decide(g, km, hw)
            if not v.lowered:
                for op in km.ops:
                    pl.fallbacks.setdefault(
                        op, f"declined {km.kernel}: {v.reason()}")


# ---------------------------------------------------------------------------
# pass body
# ---------------------------------------------------------------------------

def lower_pipeline(g: Graph, sf_name: str,
                   members: list[str]) -> PipelineLowering:
    """Greedy scan of the member list (topo order) against the kernel
    matchers; unmatched non-free ops get a fallback reason."""
    mset = set(members)
    taken: set[str] = set()
    matches: list[KernelMatch] = []
    notes: dict[str, str] = {}

    def note(op: str, why: str) -> None:
        notes.setdefault(op, why)

    for m in members:
        if m in taken:
            continue
        n = g.nodes[m]
        for matcher in _MATCHERS:
            km = matcher(g, n, mset, taken, note)
            if km is not None:
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
    return PipelineLowering(sf_name, matches, fallbacks)


def lower_pipelines(g: Graph, members_of: dict[str, list[str]], *,
                    hw: HwSpec | None = None,
                    policy: str = "always") -> LoweringPlan:
    """The `lower_kernels` pass body: one PipelineLowering per sf-node.

    `policy` selects the profitability gate on executable matches:
      * "always" -- every match lowers (the default),
      * "cost"   -- roofline estimates on `hw` (default H100) decide."""
    if policy not in POLICIES:
        raise ValueError(f"unknown lowering policy {policy!r} "
                         f"(known: {POLICIES})")
    plan = LoweringPlan({name: lower_pipeline(g, name, members)
                         for name, members in members_of.items()})
    if policy == "cost":
        _apply_verdicts(g, plan, hw if hw is not None else H100)
    return plan
