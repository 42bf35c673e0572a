"""FX -> Graph importer: the compiler's capture front-end, the counterpart
of `repro/core/trace.py`.

This is the port's form of Kitsune's Dynamo capture (paper SS5):
`trace(fn, *example_args)` records `fn` with
`torch.fx.experimental.proxy_tensor.make_fx(..., tracing_mode="fake")` --
the counterpart of `jax.make_jaxpr`: fake tensors, so no device work at
trace time, and aten-level nodes, autograd included, so a function that
calls `torch.autograd.grad` traces into its whole forward and backward --
and imports the FX graph into the operator-graph IR.  A function that
mutates a tensor is recorded again under `torch.func.functionalize`, which
turns its writes into out-of-place ops followed by a trailing `copy_` into
each written input; that `copy_` is a node of the graph, so running the
graph writes the caller's buffers as the function did.  (functionalize
refuses a function that calls autograd, such as a training step whose
model writes a buffer in place -- the MoE dispatch; that graph keeps its
in-place ops, which every executor runs in the recorded order.)  So
`repro_torch.compile(fn, example_inputs)` works on any PyTorch callable --
every architecture of `repro_torch.configs` among them -- and the whole
pass pipeline consumes the result unchanged.

Fidelity contract: every imported node carries an evaluation closure
(`attrs["_eval"]`) that calls the EXACT source op with its recorded
arguments, so executing the graph in any mode (bsp / vertical / kitsune)
computes what the function computes.  Fingerprints (executable-cache keys)
come from the stable public attrs `prim` (the `OpOverload` name) and
`params` (the op's non-tensor arguments), never from closure identities, so
re-tracing the same function re-uses cached executables.

Import rules (aten ops by name):

  * mm / bmm / addmm / baddbmm / convolution  -> matmul / conv
  * a single-dim floating `sum`               -> reduce, without a closure:
    eligible for the split-reduction pass; every other reduction keeps its
    closure and is never split
  * view / permute / expand / _to_copy / slice / select / detach / ...
                                              -> reshape (free)
  * gather / index / sort / topk / embedding  -> gather (excluded from
    sf-nodes, SS5.1)
  * scatter* / index_put / slice_scatter / copy_ / ... -> scatter (excluded)
  * cat / stack                               -> concat
  * everything else                           -> elementwise
  * `get_attr` tensors (closure weights)      -> const nodes, fed at run
    time by the TracedApp artifact
  * multi-output ops                          -> one tuple-valued node plus
    free projections
  * a custom op with an atomic spec           -> ONE node of the spec's kind
    with its `lower_hint`: the kernel ops of kernels/ops.py (their nodes
    run the plain version unless lowered) and the ops `atomic()` /
    `atomic_vjp()` make (their nodes run the wrapped function).
    `atomic_vjp` gives an op an autograd formula whose backward is a second
    atomic op, so a traced `torch.autograd.grad` keeps both directions as
    single, kernel-lowerable nodes.

The port's models loop over layers in Python, so a trace has no scan to
import: the reference's scan unrolling (`MAX_UNROLL_EQNS`, `roll_scans`)
has no counterpart here.
"""
from __future__ import annotations

import math
import operator
import re
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from ..kernels.ops import OP_SPECS, attention_flops
from .graph import Graph, Node, TensorSpec

__all__ = ["AtomicSpec", "TracedFunction", "atomic", "atomic_vjp",
           "attention_flops", "donate_outputs", "matmul_flops", "trace"]

# aten op classification (by op name, overload-independent) ------------------

_MXU_OPS = {"mm": "matmul", "bmm": "matmul", "addmm": "matmul",
            "baddbmm": "matmul", "convolution": "conv"}

_REDUCE_OPS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
               "prod", "any", "all", "var", "std", "var_mean", "logsumexp",
               "linalg_vector_norm", "norm"}

_FREE_OPS = {"view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
             "transpose", "t", "expand", "squeeze", "unsqueeze", "_to_copy",
             "slice", "select", "alias", "detach", "clone", "lift_fresh_copy",
             "as_strided", "unfold", "unbind", "split", "split_with_sizes",
             "chunk", "narrow", "constant_pad_nd", "contiguous", "flatten",
             "movedim", "diagonal", "view_copy", "permute_copy", "slice_copy",
             "select_copy", "t_copy", "transpose_copy", "unsqueeze_copy",
             "squeeze_copy", "expand_copy", "alias_copy", "detach_copy",
             "_unsafe_view_copy", "unbind_copy", "split_copy"}

_GATHER_OPS = {"gather", "index", "index_select", "embedding", "sort",
               "topk", "argsort", "take", "take_along_dim"}

_SCATTER_OPS = {"scatter", "scatter_add", "scatter_reduce", "index_put",
                "slice_scatter", "select_scatter", "diagonal_scatter",
                "as_strided_scatter", "copy_", "index_add", "index_copy",
                "masked_scatter", "slice_backward", "select_backward",
                "embedding_dense_backward"}

_CONCAT_OPS = {"cat", "stack"}

# flops per element of the elementwise fallback kind
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "sin", "cos", "tan", "erf", "erfc", "erfinv",
                   "rsqrt", "sqrt", "pow", "atan2", "silu", "gelu", "lgamma",
                   "digamma", "softplus", "_softmax", "_log_softmax"}


# ---------------------------------------------------------------------------
# atomic ops (recognisable fused blocks, e.g. attention or the fused MLP)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AtomicSpec:
    """What the importer records of an atomic op's node.

    kind   the node's op kind
    flops  flops(args, out_vals): its flop count from the op's arguments
           (fake tensors and non-tensor arguments) and its outputs
    lower  the kernel-lowering hint core/lower.py matches (a stable nested
           tuple, e.g. ("mlp_bwd", ("act", "gelu"))), or hint(*args)
    plain  what the node runs when it is not lowered: the op's function in
           torch ops, called with the op's arguments"""
    kind: str
    flops: Callable[[tuple, list], float] | None = None
    lower: tuple | Callable[..., tuple] | None = None
    plain: Callable | None = None

    def hint(self, args: tuple) -> tuple | None:
        return self.lower(*args) if callable(self.lower) else self.lower


def _kernel_spec(spec) -> AtomicSpec:
    return AtomicSpec(spec.kind, lambda args, outs, _f=spec.flops: _f(*args),
                      spec.lower, spec.plain)


# op name ("namespace::name") -> spec; the kernel ops first
_ATOMICS: dict[str, AtomicSpec] = {name: _kernel_spec(s)
                                   for name, s in OP_SPECS.items()}
_ATOMIC_NS = "repro_torch_atomic"
_ATOMIC_KINDS = ("attention", "matmul", "elementwise", "reduce", "norm",
                 "softmax", "conv", "gather")


class _Atomic:
    """A callable that runs `fn` as the custom op `repro_torch_atomic::<name>`
    (defined at its first call, when the number of tensor arguments is
    known).  Its fake rule runs `fn` on fake tensors; `backward`, if set,
    is the autograd formula."""

    def __init__(self, fn: Callable, qualname: str, spec: AtomicSpec,
                 n_out: int):
        self.fn = fn
        self.qualname = qualname
        self.spec = spec
        self.n_out = n_out
        self.op = None
        self.backward: Callable | None = None
        self.__name__ = qualname.split("::")[1]

    def define(self, n_in: int):
        if self.op is not None:
            if self.n_in != n_in:
                raise TypeError(f"{self.qualname} takes {self.n_in} tensors, got {n_in}")
            return self.op
        outs = "Tensor" if self.n_out == 1 else \
            "(" + ", ".join(["Tensor"] * self.n_out) + ")"
        schema = "(" + ", ".join(f"Tensor a{i}" for i in range(n_in)) + ") -> " + outs
        fn = self.fn
        op = torch.library.custom_op(self.qualname, lambda *a: fn(*a),
                                     mutates_args=(), schema=schema)
        op.register_fake(lambda *a: fn(*a))
        if self.backward is not None:
            op.register_autograd(self.backward, setup_context=_save_inputs)
        self.op, self.n_in = op, n_in
        return op

    def __call__(self, *args):
        if not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError(f"{self.qualname}: every argument must be a tensor "
                            f"(bind statics with functools.partial)")
        return self.define(len(args))(*args)


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


_ATOMIC_OPS: dict[str, _Atomic] = {}


def atomic(fn: Callable, kind: str, *, flops: Callable[[list, list], float] | None = None,
           lower: tuple | None = None, name: str | None = None,
           n_out: int = 1) -> Callable:
    """Wrap `fn` so that the tracer imports any call to it as ONE node of
    `kind`, whose eval closure runs `fn` itself -- how fused attention stays
    one "attention" node instead of dissolving into its einsum/softmax ops.

    `fn` takes tensors only (bind statics with functools.partial and encode
    them in `name`/`lower`, so distinct configs get distinct ops) and
    returns one tensor, or a tuple of `n_out`.  `flops(in_vals, out_vals)`
    estimates the node's flops from its tensor inputs and outputs.  `lower`
    tags the node with a kernel-lowering hint (`attrs["lower_hint"]`) that
    core/lower.py matches onto a kernel; the hint must fully determine the
    kernel call's static config (it enters the fingerprint attrs).

    The op's name is `repro_torch_atomic::<kind>_<name>`; a second atomic of
    one name and another function is refused."""
    if kind not in _ATOMIC_KINDS:
        raise ValueError(f"unsupported atomic kind {kind!r}")
    stem = re.sub(r"\W", "_", name or getattr(fn, "__name__", "fn"))
    qualname = f"{_ATOMIC_NS}::{kind}_{stem}"
    have = _ATOMIC_OPS.get(qualname)
    if have is not None:
        if have.fn is not fn:
            raise ValueError(f"atomic {qualname} is already defined for another "
                             f"function")
        return have
    user = flops

    def node_flops(args, outs):
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if user is not None:
            return user(ins, outs)
        return sum(2.0 * a.numel() for a in ins)

    spec = AtomicSpec(kind, node_flops, lower, fn)
    _ATOMICS[qualname] = spec
    _ATOMIC_OPS[qualname] = at = _Atomic(fn, qualname, spec, n_out)
    return at


def atomic_vjp(fn: Callable, bwd: Callable, kind: str, *,
               bwd_kind: str | None = None, n_diff: int | None = None,
               flops: Callable[[list, list], float] | None = None,
               bwd_flops: Callable[[list, list], float] | None = None,
               lower: tuple | None = None, bwd_lower: tuple | None = None,
               name: str | None = None) -> Callable:
    """A differentiable atomic: BOTH directions stay single nodes.

    `fn(*primals)` is the forward (one output); `bwd(*primals, cotangent)`
    returns the tuple of gradients of the first `n_diff` primals (default:
    all), without calling autograd (an op's body runs below it).  Each side
    is its own atomic op, and the forward's autograd formula calls the
    backward op, so a traced `torch.autograd.grad` holds the forward as one
    `kind` node and the backward as one `bwd_kind` node.  Primals past
    `n_diff` (e.g. a window operand) get no gradient."""
    stem = name or getattr(fn, "__name__", "fn")
    fwd_at = atomic(fn, kind, flops=flops, lower=lower, name=stem)
    if fwd_at.backward is not None:
        return fwd_at
    bwd_at = atomic(bwd, bwd_kind or kind, flops=bwd_flops, lower=bwd_lower,
                    name=f"{stem}_bwd", n_out=n_diff or 0)

    def backward(ctx, dy):
        saved = ctx.saved_tensors
        if not bwd_at.n_out:         # a gradient for every primal
            bwd_at.n_out = len(saved)
        grads = bwd_at(*saved, dy)
        grads = tuple(grads) if isinstance(grads, (tuple, list)) else (grads,)
        return grads + (None,) * (len(saved) - len(grads))

    fwd_at.backward = backward
    return fwd_at


def matmul_flops(name: str, ins: list, out) -> float:
    """2 M K N per product of an aten matmul / conv node."""
    if name == "convolution":
        return 2.0 * out.numel() * math.prod(ins[1].shape[1:])
    a, b = (ins[1], ins[2]) if name in ("addmm", "baddbmm") else (ins[0], ins[1])
    flops = 2.0 * math.prod(a.shape) * b.shape[-1]
    if name in ("addmm", "baddbmm"):
        flops += out.numel()
    return flops


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _spec(val) -> TensorSpec:
    return TensorSpec(tuple(int(d) for d in val.shape), _dtype_name(val.dtype))


class _Slot:
    """Where a graph value enters an op's argument structure."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __repr__(self):
        return f"%{self.i}"


def _template(obj, refs: list):
    """The op's arguments as plain lists / tuples / dicts with each fx Node
    replaced by a _Slot (appended to `refs` in order of appearance)."""
    if isinstance(obj, torch.fx.Node):
        refs.append(obj)
        return _Slot(len(refs) - 1)
    if isinstance(obj, (list, tuple)):
        out = [_template(a, refs) for a in obj]
        return out if isinstance(obj, list) else tuple(out)
    if isinstance(obj, dict):
        return {k: _template(v, refs) for k, v in obj.items()}
    return obj


def _fill(obj, vals):
    if type(obj) is _Slot:
        return vals[obj.i]
    if isinstance(obj, list):
        return [_fill(a, vals) for a in obj]
    if isinstance(obj, tuple):
        return tuple(_fill(a, vals) for a in obj)
    if isinstance(obj, dict):
        return {k: _fill(v, vals) for k, v in obj.items()}
    return obj


def _make_eval(fn: Callable, args: tuple, kwargs: dict) -> Callable:
    """Closure calling `fn` with the op's recorded arguments, the graph
    values slotted in; top-level slots alone take a fast path."""
    flat = all(type(a) is _Slot or not isinstance(a, (list, tuple, dict))
               for a in args) and not any(
        isinstance(v, (_Slot, list, tuple, dict)) for v in kwargs.values())
    if flat:
        pos = [(i, a.i) for i, a in enumerate(args) if type(a) is _Slot]
        base = list(args)

        def ev(*vals):
            a = list(base)
            for i, j in pos:
                a[i] = vals[j]
            return fn(*a, **kwargs)
        return ev

    def ev_nested(*vals):
        return fn(*_fill(args, vals), **_fill(kwargs, vals))
    return ev_nested


def _stable(obj) -> str:
    """Address-free repr of an op's non-tensor arguments (fingerprint
    input): the graph values show as %i."""
    r = repr(obj)
    return re.sub(r" at 0x[0-9a-f]+", "", r)


def _op_name(target) -> str:
    """aten::mm -> mm; repro_torch::fused_mlp_fwd -> the full name."""
    ns, name = target._schema.name.split("::")
    return name if ns == "aten" else f"{ns}::{name}"


def _is_simple_sum(target, args, kwargs, val, in_val) -> bool:
    """aten.sum over one dim, no keepdim, no dtype change, floating: the
    generic `reduce` kind's semantics (torch.sum(x, dim))."""
    if str(target) != "aten.sum.dim_IntList" or kwargs.get("dtype") is not None:
        return False
    dims = args[1] if len(args) > 1 else None
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    return (isinstance(dims, (list, tuple)) and len(dims) == 1 and not keepdim
            and in_val.dtype.is_floating_point and in_val.dtype == val.dtype)


# ---------------------------------------------------------------------------
# the importer
# ---------------------------------------------------------------------------

@dataclass
class TracedFunction:
    """A PyTorch callable imported into the Graph IR.

    `consts` hold the captured weights and constants keyed by their const
    node names -- the executor feeds them beside the positional inputs.
    `module` is the recorded FX GraphModule."""
    graph: Graph
    consts: dict[str, torch.Tensor]
    in_names: list[str]
    in_tree: Any
    out_names: list[str]
    out_tree: Any
    module: Any = None

    def feeds(self, *args) -> dict[str, torch.Tensor]:
        flat, tree = pytree.tree_flatten(args)
        if tree != self.in_tree:
            raise TypeError(f"argument structure {tree} does not match the "
                            f"traced structure {self.in_tree}")
        if len(flat) != len(self.in_names):
            raise TypeError(f"expected {len(self.in_names)} tensor args, "
                            f"got {len(flat)}")
        out = dict(zip(self.in_names, flat))
        out.update(self.consts)
        return out

    def unflatten_outputs(self, outputs: dict[str, torch.Tensor]):
        return pytree.tree_unflatten([outputs[n] for n in self.out_names],
                                     self.out_tree)


class _Importer:
    def __init__(self, name: str, module):
        self.g = Graph(name)
        self.m = module
        self.consts: dict[str, torch.Tensor] = {}
        self._by_id: dict[int, str] = {}
        self._n = 0

    def fresh(self, stem: str) -> str:
        self._n += 1
        return f"{stem}_{self._n}"

    def add_const(self, val: torch.Tensor) -> str:
        name = self._by_id.get(id(val))
        if name is None:
            name = self.fresh("const")
            self.g.add(Node(name, "const", [], _spec(val)))
            self.consts[name] = val
            self._by_id[id(val)] = name
        return name

    def run(self, in_names: list[str]) -> list[str]:
        env: dict[torch.fx.Node, str] = {}
        placeholders = iter(in_names)
        outs: list[str] = []
        # consts first, as the reference imports a jaxpr's constvars: make_fx
        # places each get_attr at its first use, where a const node (an
        # excluded kind) would cut the op run around it in two
        for fx in self.m.graph.nodes:
            if fx.op == "get_attr":
                val = getattr(self.m, fx.target)
                if not isinstance(val, torch.Tensor):
                    raise NotImplementedError(f"get_attr {fx.target}: not a tensor")
                env[fx] = self.add_const(val)
        for fx in self.m.graph.nodes:
            if fx.op in ("placeholder", "get_attr"):
                if fx.op == "placeholder":
                    env[fx] = next(placeholders)
            elif fx.op == "call_function":
                env[fx] = self.call(fx, env)
            elif fx.op == "output":
                for ref in pytree.tree_leaves(fx.args[0]):
                    if not isinstance(ref, torch.fx.Node):
                        raise TypeError(f"traced output {ref!r} is not a tensor")
                    outs.append(env[ref])
            else:
                raise NotImplementedError(f"fx node kind {fx.op} ({fx.target})")
        return outs

    def call(self, fx: torch.fx.Node, env: dict) -> str:
        target = fx.target
        if target is operator.getitem:
            src, i = fx.args
            node = self.g.add(Node(
                self.fresh(f"{env[src]}.o{i}"), "reshape", [env[src]],
                _spec(fx.meta["val"]), 0.0, 0.0,
                {"prim": "proj", "params": str(i),
                 "_eval": (lambda t, _i=i: t[_i])}))
            return node.name
        if not isinstance(target, torch._ops.OpOverload):
            raise NotImplementedError(f"cannot import {target!r}: not an aten or "
                                      f"custom op")
        refs: list = []
        args = _template(fx.args, refs)
        kwargs = _template(dict(fx.kwargs), refs)
        inputs = [env[r] for r in refs]
        in_vals = [r.meta.get("val") for r in refs]
        val = fx.meta["val"]
        name = _op_name(target)
        base = {"prim": str(target), "params": _stable((args, kwargs))}
        spec = _ATOMICS.get(target._schema.name)
        if spec is not None:
            return self._atomic(fx, target, spec, args, kwargs, inputs, in_vals, base)
        ev = _make_eval(target, args, kwargs)
        out_vals = list(val) if isinstance(val, (tuple, list)) else [val]
        size = float(sum(v.numel() for v in out_vals if isinstance(v, torch.Tensor)))
        if name in _MXU_OPS:
            return self._emit(fx, name, _MXU_OPS[name], inputs, base, ev,
                              matmul_flops(name, in_vals, val))
        if name in _REDUCE_OPS and len(refs) == 1:      # not max(a, b)
            x = in_vals[0]
            dims = args[1] if len(args) > 1 and isinstance(args[1], (list, tuple, int)) else []
            dims = [dims] if isinstance(dims, int) else list(dims)
            axis = int(dims[0]) % max(x.ndim, 1) if dims else 0
            attrs = {"axis": axis, "keepdims": False,
                     "red_size": int(math.prod(x.shape[d] for d in dims)) if dims
                     else int(x.numel())}
            if _is_simple_sum(target, fx.args, fx.kwargs, val, x):
                # generic kind semantics == torch.sum(x, dim): no closure,
                # so the split-reduction pass may rewrite it (Algorithm 1)
                return self._emit(fx, name, "reduce", inputs[:1], {**base, **attrs},
                                  None, float(x.numel()))
            return self._emit(fx, name, "reduce", inputs, {**base, **attrs}, ev,
                              float(x.numel()) if x is not None else size)
        if name in _CONCAT_OPS:
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            return self._emit(fx, name, "concat", inputs, {**base, "axis": dim}, ev, 0.0)
        if name in _GATHER_OPS:
            return self._emit(fx, name, "gather", inputs, base, ev, 0.0)
        if name in _SCATTER_OPS:
            return self._emit(fx, name, "scatter", inputs, base, ev, size)
        if name in _FREE_OPS:
            return self._emit(fx, name, "reshape", inputs, base, ev, 0.0)
        fpe = 4.0 if name in _TRANSCENDENTAL else 1.0
        return self._emit(fx, name, "elementwise", inputs, {**base, "fn": "identity"},
                          ev, fpe * size)

    def _emit(self, fx, stem: str, kind: str, inputs: list[str], attrs: dict,
              ev, flops: float) -> str:
        val = fx.meta["val"]
        if isinstance(val, (tuple, list)):
            tensors = [v for v in val if isinstance(v, torch.Tensor)]
            attrs["n_outs"] = len(val)
            # one TensorSpec per node: carry the LARGEST output so the byte
            # accounting is a lower bound that is not systematically tiny
            spec = max((_spec(v) for v in tensors), key=lambda s: s.nbytes)
        else:
            spec = _spec(val)
        if ev is not None:
            attrs["_eval"] = ev
        node = self.g.add(Node(self.fresh(re.sub(r"\W", "_", stem)), kind,
                               list(inputs), spec, float(flops), 0.0, attrs))
        return node.name

    def _atomic(self, fx, target, spec: AtomicSpec, args, kwargs, inputs,
                in_vals: list, base: dict) -> str:
        fake_args = tuple(_fill(args, in_vals))
        val = fx.meta["val"]
        outs = list(val) if isinstance(val, (tuple, list)) else [val]
        attrs = {**base, "atomic": target._schema.name}
        hint = spec.hint(fake_args)
        if hint is not None:
            attrs["lower_hint"] = hint
        flops = spec.flops(fake_args, outs) if spec.flops is not None else 0.0
        ev = _make_eval(spec.plain or target, args, kwargs)
        return self._emit(fx, _op_name(target).split("::")[-1], spec.kind, inputs,
                          attrs, ev, flops)


def _mutates(module) -> bool:
    return any(n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
               and n.target._schema.is_mutable for n in module.graph.nodes)


def _record(fn: Callable, flat: list, functional: bool):
    f = torch.func.functionalize(fn) if functional else fn
    with torch.enable_grad():
        return make_fx(f, tracing_mode="fake", _allow_non_fake_inputs=True)(*flat)


def trace(fn: Callable, *example_args, name: str | None = None) -> TracedFunction:
    """Import `fn` (traced on `example_args`) into a Graph.

    The example args may be any pytrees of tensors; later executions of
    the traced artifact must pass the same structure (same shapes => cached
    executables, zero new builds).  Values that depend on the data (a
    `.item()`, a nonzero count) cannot be traced: make_fx raises."""
    flat, in_tree = pytree.tree_flatten(example_args)
    for leaf in flat:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"trace: example inputs must be tensors, got "
                            f"{type(leaf).__name__}")
    # one tensor at two places of the inputs would be one graph input: the
    # trace takes a stand-in of its shape for every repeat (values do not
    # matter under fake tensors)
    seen: set[int] = set()
    flat = [torch.empty_like(t) if id(t) in seen or seen.add(id(t)) else t
            for t in flat]
    out_trees: list = []

    def flat_fn(*leaves):
        out = fn(*pytree.tree_unflatten(list(leaves), in_tree))
        leaves_out, tree = pytree.tree_flatten(out)
        out_trees.append(tree)
        for leaf in leaves_out:
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"trace: outputs must be tensors, got "
                                f"{type(leaf).__name__}")
        return leaves_out

    module = _record(flat_fn, flat, functional=False)
    if _mutates(module):
        try:
            module = _record(flat_fn, flat, functional=True)
        except RuntimeError:
            # functionalize refuses autograd inside the function: keep the
            # in-place ops, which every executor runs in recorded order
            pass
    imp = _Importer(name or getattr(fn, "__name__", "traced") or "traced", module)
    in_names = []
    placeholders = [n for n in module.graph.nodes if n.op == "placeholder"]
    for i, ph in enumerate(placeholders):
        nm = f"arg{i}"
        val = ph.meta["val"]
        imp.g.input(nm, tuple(int(d) for d in val.shape), _dtype_name(val.dtype))
        in_names.append(nm)
    out_refs = imp.run(in_names)
    out_names = [imp.g.output(f"out{i}", ref).name for i, ref in enumerate(out_refs)]
    if out_trees[-1].num_leaves != len(out_names):
        raise AssertionError("output arity mismatch between the capture and "
                             "the pytree")
    return TracedFunction(imp.g, imp.consts, in_names, in_tree, out_names,
                          out_trees[-1], module)


def _donate(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if d.untyped_storage().data_ptr() == v.untyped_storage().data_ptr():
        return v                     # v is d or a view of it
    return d.copy_(v)


def donate_outputs(tf: TracedFunction, donate: set[str] | frozenset[str]
                   ) -> list[tuple[str, str]]:
    """Reuse donated inputs' storage for the outputs: rewrite `tf.graph` so
    that each output value is copied into a donated input of its shape and
    dtype as soon as both exist and nothing reads the input (or a view of
    it) any more, and the output returns that input.  A step then never
    holds its old and new state side by side: each new leaf replaces its
    old one as it is made.  Outputs pair with the first unclaimed donated
    input of their spec in input order (a step's state leaves come back in
    the order they went in).  An input an output returns unchanged is not
    donated.  Returns the (input, output value) pairs."""
    g = tf.graph
    order = list(g.nodes)
    pos = {nm: i for i, nm in enumerate(order)}
    succ = g.successors_map()
    outputs = [n for n in g.topo() if n.kind == "output"]
    returned = {n.inputs[0] for n in outputs}

    def last_use(name: str) -> int:
        """Last reader of `name` or of any view made of it (free nodes)."""
        last, stack, seen = pos[name], [name], {name}
        while stack:
            for c in succ[stack.pop()]:
                node = g.nodes[c]
                if node.kind == "output":
                    continue
                last = max(last, pos[c])
                if node.kind == "reshape" and c not in seen:
                    seen.add(c)
                    stack.append(c)
        return last

    free = [nm for nm in tf.in_names if nm in donate and nm not in returned]
    pairs: list[tuple[str, str]] = []
    for out in outputs:
        v = out.inputs[0]
        if g.nodes[v].kind in ("input", "const") or any(p[1] == v for p in pairs):
            continue
        d = next((d for d in free if g.nodes[d].out == g.nodes[v].out), None)
        if d is not None:
            free.remove(d)
            pairs.append((d, v))
    if not pairs:
        return pairs
    after: dict[int, list[tuple[str, str]]] = {}
    for d, v in pairs:
        after.setdefault(max(pos[v], last_use(d)), []).append((d, v))
    copy_of: dict[str, str] = {}
    new = Graph(g.name)
    for i, nm in enumerate(order):
        n = g.nodes[nm]
        if n.kind == "output" and n.inputs[0] in copy_of:
            n = Node(n.name, "output", [copy_of[n.inputs[0]]], n.out)
        new.add(n)
        for d, v in after.get(i, ()):
            c = new.add(Node(f"donate_{len(copy_of)}", "scatter", [d, v],
                             g.nodes[v].out, 0.0, 0.0,
                             {"prim": "donate", "params": "", "_eval": _donate}))
            copy_of[v] = c.name
    tf.graph = new
    return pairs
