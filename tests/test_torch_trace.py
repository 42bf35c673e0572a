"""The capture front-end (repro_torch/core/trace.py): PyTorch callables
traced with make_fx under fake tensors, imported into the Graph IR and
compiled in all three modes, held against the raw functions and against
the reference package.

  * every zoo config `.reduced()`: the traced port function in bsp /
    vertical / kitsune equals the raw port function, which equals the
    reference's raw `zoo.build(...).fn` on the reference's weights and
    inputs carried across (`params_from_numpy`) -- float32 2e-4, the
    reference's tolerance (tests/test_kernels.py:25); repeat runs add no
    builds; a fresh retrace reuses the built programs;
  * the `grad` phase against `torch.autograd.grad` and the reference's raw
    `jax.grad` at 5e-4;
  * the graph invariants over generated functions (hypothesis), and the
    importer cases of tests/test_trace.py:169-260;
  * the kernels as `torch.library` ops: eager results bitwise the raw
    wrappers', fake rules agreeing with real outputs, a raw wrapper under a
    capture refused;
  * both serving engines with `compile_mode="kitsune"` against
    `compile_mode=None` and the reference engines' tokens.

The reference's own traced graphs are not the oracle: its traced-atomic
path fails under the installed jax (ROADMAP "Reference caveats"), so the
port is held to the reference's raw, untraced functions.  MoE configs
compare against the reference with its dropped-entry scatter corrected in
this process (tests/test_torch_families.py explains the defect).
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.models import zoo as j_zoo
from repro.serve import PagedServingEngine as JPagedEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

import repro_torch
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.executor import (_eval_node, lowering_count,
                                       params_from_numpy, tensor_from_numpy)
from repro_torch.core.graph import MXU
from repro_torch.core.trace import trace
from repro_torch.kernels import ops
from repro_torch.models import zoo
from repro_torch.serve import (PagedServingEngine, ServeConfig,
                               ServingEngine)
from repro_torch.tree import leaves

from test_torch_families import _dispatch_dropping_nowhere

NAMES = sorted(J_ARCHS)
MODES = ("bsp", "vertical", "kitsune")
TOL = 2e-4


def _flat(tree) -> list:
    """A result's leaves in one order for both packages (dict keys sorted
    in each): tensors of the port, arrays of the reference."""
    if torch.is_tensor(tree) or isinstance(tree, (jax.Array, np.ndarray)):
        return [tree]
    return leaves(tree) or jax.tree_util.tree_leaves(tree)


def _np(a) -> np.ndarray:
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def close(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


_MEMO: dict = {}


def case(name: str, phase: str = "forward"):
    """(port ZooFunction on the reference's weights and inputs, reference
    ZooFunction), one pair per (config, phase) for the whole module."""
    key = (name, phase)
    if key not in _MEMO:
        jzf = j_zoo.build(name, batch=1, seq=8, phase=phase)
        # the weights j_zoo.build closes over: its model.init at seed 0
        jparams = j_get_model(jzf.cfg).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        inputs = tuple(tensor_from_numpy(a, "cpu") for a in jzf.example_inputs)
        inputs = tuple(t.long() if not t.is_floating_point() else t for t in inputs)
        zf = zoo.build(name, batch=1, seq=8, phase=phase, params=params, inputs=inputs,
                       device="cpu")
        _MEMO[key] = (zf, jzf)
    return _MEMO[key]


@pytest.fixture
def corrected_dispatch(monkeypatch):
    monkeypatch.setattr(j_layers, "_dispatch_group", _dispatch_dropping_nowhere)


# ---------------------------------------------------------------------------
# the zoo, traced, against the raw port and reference functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_zoo_three_modes_match_raw_and_reference(name, corrected_dispatch):
    zf, jzf = case(name)
    with torch.no_grad():
        raw = zf.fn(*zf.example_inputs)
    close(raw, jzf.fn(*jzf.example_inputs))
    for mode in MODES:
        app = repro_torch.compile(zf.fn, zf.example_inputs, mode=mode)
        close(app(*zf.example_inputs), raw)
        before = lowering_count()
        rep = app.run(app.traced.feeds(*zf.example_inputs))
        assert lowering_count() == before, f"{name}/{mode}: a repeat run built programs"
        assert rep.cache_misses == 0
        if mode == "kitsune" and J_ARCHS[name].family not in ("moe", "ssm"):
            # every dense MLP block is a node bound to its forward kernel
            kern = {"encdec": "fused_mlp"}.get(J_ARCHS[name].family, "fused_mlp_swiglu")
            assert kern in app.lowering.kernels_used(), name


@pytest.mark.parametrize("name", ["gemma3-1b", "hymba-1.5b"])
def test_retrace_reuses_executables(name):
    """A fresh trace and compile of the same function hits the same cache
    entries (fingerprints from prim / params, not closure identities)."""
    zf, _ = case(name)
    app1 = repro_torch.compile(zf.fn, zf.example_inputs, mode="kitsune")
    app1(*zf.example_inputs)
    before = lowering_count()
    app2 = repro_torch.compile(zf.fn, zf.example_inputs, mode="kitsune")
    assert app2.fingerprint == app1.fingerprint
    app2(*zf.example_inputs)
    assert lowering_count() == before, "an identical retrace built programs"


def test_grad_trace_matches_autograd_and_jax_grad():
    """The training function (torch.autograd.grad inside) traces into its
    whole forward and backward and matches autograd and the reference's
    raw jax.grad."""
    zf, jzf = case("gemma3-1b", phase="grad")
    raw = zf.fn(*zf.example_inputs)
    close(raw, jzf.fn(*jzf.example_inputs), 5e-4)
    app = repro_torch.compile(zf.fn, zf.example_inputs, mode="kitsune")
    close(app(*zf.example_inputs), raw, 5e-4)
    assert {"fused_mlp_swiglu", "fused_mlp_swiglu_bwd"} <= set(app.lowering.kernels_used())


# ---------------------------------------------------------------------------
# structural invariants (hypothesis over generated functions)
# ---------------------------------------------------------------------------

_ACTS = {"tanh": torch.tanh, "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
         "relu": torch.relu}


def _gen_fn(depth, width, act, use_reduce, use_loop):
    rng = np.random.default_rng(depth * 7 + width)
    dims = [6] + [width] * depth
    ws = [torch.from_numpy(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3)
          for i in range(depth)]
    w_loop = torch.from_numpy(rng.standard_normal((width, width)).astype(np.float32) * 0.3)

    def fn(x):
        h = x
        for w in ws:
            h = _ACTS[act](h @ w)
        if use_loop:
            sums = []
            for _ in range(3):
                h = torch.tanh(h @ w_loop)
                sums.append(h.sum())
            h = h + torch.stack(sums).mean()
        if use_reduce:
            return h.sum(dim=0), h
        return h

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32))
    return fn, x


@settings(deadline=None, max_examples=12)
@given(depth=st.integers(min_value=1, max_value=3), width=st.sampled_from([4, 8, 16]),
       act=st.sampled_from(sorted(_ACTS)), use_reduce=st.booleans(),
       use_loop=st.booleans())
def test_traced_graph_invariants(depth, width, act, use_reduce, use_loop):
    fn, x = _gen_fn(depth, width, act, use_reduce, use_loop)
    tf = trace(fn, x)
    g = tf.graph
    # 1. topo() respects edges: producers strictly precede consumers
    pos = {n.name: i for i, n in enumerate(g.topo())}
    for n in g.topo():
        for i in n.inputs:
            assert pos[i] < pos[n.name], (i, n.name)
    # 2. the cached consumers index equals a fresh rescan
    fresh: dict[str, list[str]] = {k: [] for k in g.nodes}
    for n in g.topo():
        for i in dict.fromkeys(n.inputs):
            fresh[i].append(n.name)
    for k in g.nodes:
        assert [c.name for c in g.consumers(k)] == fresh[k], k
    # 3. each node's eager value has its recorded shape and dtype
    vals = dict(tf.feeds(x))
    for n in g.topo():
        if n.kind in ("input", "const"):
            continue
        v = _eval_node(n, [vals[i] for i in n.inputs], None)
        vals[n.name] = v
        if isinstance(v, (tuple, list)):
            assert n.attrs.get("n_outs") == len(v), n.name
            continue
        assert tuple(v.shape) == n.out.shape, n.name
        assert str(v.dtype).split(".")[-1] == n.out.dtype, n.name
    # and the whole eager walk reproduces the function
    got = tf.unflatten_outputs({nm: vals[nm] for nm in tf.out_names})
    close(got, fn(x), 1e-5)


# ---------------------------------------------------------------------------
# importer features
# ---------------------------------------------------------------------------

def test_atomic_attention_single_node():
    zf, _ = case("gemma3-1b")
    tf = trace(zf.fn, *zf.example_inputs)
    attn = [n for n in tf.graph.topo() if n.kind == "attention"]
    assert len(attn) == zf.cfg.n_layers          # one per layer
    for n in attn:
        assert n.resource == MXU and n.flops > 0
        assert "repro_torch_atomic" in n.attrs["atomic"]
        assert n.attrs["lower_hint"] == ("attention_fwd", ("causal", True))


def test_multi_output_op():
    def fn(x):
        v, i = torch.topk(x, 2)
        return v * 2.0, i

    x = torch.tensor([[3.0, 1.0, 2.0], [0.0, 5.0, 4.0]])
    app = repro_torch.compile(fn, (x,), mode="bsp")
    v, i = app(x)
    wv, wi = fn(x)
    assert torch.equal(v, wv) and torch.equal(i, wi)
    tuple_nodes = [n for n in app.graph.topo() if "n_outs" in n.attrs]
    assert tuple_nodes and tuple_nodes[0].kind == "gather"


def test_captured_consts_are_weights():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32))

    def fn(x):
        return x @ w

    x = torch.ones((2, 4))
    app = repro_torch.compile(fn, (x,), mode="bsp")
    consts = [n for n in app.graph.topo() if n.kind == "const"]
    assert any(c.out.shape == (4, 4) for c in consts)
    assert app.traced.consts[consts[0].name] is w
    assert app.init_params() == {}
    close(app(x), fn(x), 1e-6)


def test_traced_reduce_still_splits():
    """A plain float sum imports closure-free, so the split-reduction pass
    (Algorithm 1) rewrites it; other reductions stay whole."""
    def fn(x):
        return torch.tanh(x * x).sum(dim=0), x.amax(dim=0)

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32))
    app = repro_torch.compile(fn, (x,), mode="kitsune")
    kinds = [n.kind for n in app.pipelined.graph.topo()]
    assert "reduce_partial" in kinds
    prims = [n.attrs.get("prim") for n in app.pipelined.graph.topo()]
    assert "aten.amax.default" in prims
    assert "queue_reduce" in app.lowering.kernels_used()
    close(app(x), fn(x), 1e-5)


def test_bad_calls_rejected():
    with pytest.raises(TypeError):
        repro_torch.compile(lambda x: x)          # no example_inputs
    app = repro_torch.compile(lambda x: x * 2, (torch.ones(3),))
    with pytest.raises(TypeError):
        app(torch.ones(3), torch.ones(3))         # arity mismatch
    with pytest.raises(TypeError):
        repro_torch.compile(lambda x, n: x * n, (torch.ones(3), 2))   # a non-tensor leaf


def test_input_writes_reach_the_callers_buffer():
    """A function that writes its input traces through functionalize; the
    compiled graph's trailing copy writes the caller's tensor as the
    function does, in every mode."""
    def fn(cache, rows, x):
        cache[rows, 0] = torch.tanh(x)
        return cache[:, 0].sum(dim=0)

    rows = torch.tensor([1, 3])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4)).astype(np.float32))
    want_cache = torch.zeros(5, 2, 4)
    want = fn(want_cache, rows, x)
    for mode in MODES:
        app = repro_torch.compile(fn, (torch.zeros(5, 2, 4), rows, x), mode=mode)
        assert any(n.attrs.get("prim") == "aten.copy_.default" for n in app.graph.topo())
        cache = torch.zeros(5, 2, 4)
        close(app(cache, rows, x), want, 1e-6)
        assert torch.equal(cache, want_cache), mode


def test_raw_kernel_wrapper_refused_under_capture():
    w1, w2 = torch.ones(4, 8), torch.ones(8, 4)
    with pytest.raises(RuntimeError, match="under a capture"):
        trace(lambda x: K.fused_mlp_fwd(x, w1, w2, act="gelu"), torch.ones(2, 4))
    # through its op the same call is one node
    tf = trace(lambda x: K.mlp(x, w1, w2, act="gelu"), torch.ones(2, 4))
    assert [n.attrs["atomic"] for n in tf.graph.topo() if "atomic" in n.attrs] == \
        ["repro_torch::fused_mlp_fwd"]


# ---------------------------------------------------------------------------
# the kernels as torch.library ops
# ---------------------------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(5)

    def t(*shape, dtype=np.float32):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(dtype))

    x, w1, wu, w2, dy = t(6, 8), t(8, 16), t(8, 16), t(16, 8), t(6, 8)
    q, k, v = t(2, 4, 8, 16), t(2, 2, 8, 16), t(2, 2, 8, 16)
    qd = t(2, 4, 1, 16)
    kp, vp = t(5 * 4, 2, 16), t(5 * 4, 2, 16)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    valid = torch.tensor([5, 7], dtype=torch.int32)
    return [
        (ops.fused_mlp_fwd_op, (x, w1, w2, "gelu"), K.fused_mlp_fwd(x, w1, w2, act="gelu")),
        (ops.fused_mlp_swiglu_fwd_op, (x, w1, wu, w2, "silu"),
         K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act="silu")),
        (ops.fused_mlp_bwd_op, (x, w1, w2, dy, "gelu"), K.fused_mlp_bwd(x, w1, w2, dy, act="gelu")),
        (ops.fused_mlp_swiglu_bwd_op, (x, w1, wu, w2, dy, "silu"),
         K.fused_mlp_swiglu_bwd(x, w1, wu, w2, dy, act="silu")),
        (ops.flash_attention_op, (q, k, v, True, None), K.flash_attention(q, k, v, causal=True)),
        (ops.flash_decode_op, (qd, k, v, valid, None), K.flash_decode(qd, k, v, valid_len=valid)),
        (ops.flash_decode_op, (qd, k, v, None, 6), K.flash_decode(qd, k, v, valid_len=6)),
        (ops.paged_flash_decode_op, (qd, kp, vp, tables, valid, None, 4, None),
         K.paged_flash_decode(qd, kp, vp, tables, valid_len=valid, block_size=4)),
        (ops.queue_reduce_op, (t(3, 4, 8), "sum"), None),
    ]


def test_ops_equal_raw_wrappers_bitwise_and_fake_rules_agree():
    from torch._subclasses.fake_tensor import FakeTensorMode
    for op, args, want in _op_cases():
        got = op(*args)
        if want is None:
            want = K.queue_reduce(args[0], op=args[1])
        for g, w in zip(_flat(got), _flat(want)):
            assert torch.equal(g, w), op
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = op(*args)
        for f, g in zip(_flat(fake), _flat(got)):
            assert (f.shape, f.dtype) == (g.shape, g.dtype), op


def test_op_specs_cover_every_kernel():
    assert {name.split("::")[1] for name in ops.OP_SPECS} == {
        "fused_mlp_fwd", "fused_mlp_swiglu_fwd", "fused_mlp_bwd", "fused_mlp_swiglu_bwd",
        "flash_attention", "flash_decode", "paged_flash_decode", "queue_reduce"}
    for name in ops.OP_SPECS:
        ns, op_name = name.split("::")
        assert hasattr(getattr(torch.ops, ns), op_name)


# ---------------------------------------------------------------------------
# the engines through the compiler
# ---------------------------------------------------------------------------

PROMPTS = {1: [5, 6, 7], 2: [9, 8], 3: [3, 4, 5, 6]}


def _models(name):
    key = ("models", name)
    if key not in _MEMO:
        jcfg = j_get_config(name).reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        _MEMO[key] = (jcfg, jparams, get_config(name).reduced(),
                      params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    return _MEMO[key]


@pytest.mark.parametrize("name", ["gemma3-1b", "hymba-1.5b"])
def test_legacy_engine_compile_mode(name):
    jcfg, jparams, cfg, params = _models(name)

    def run(cls, sc_cls, c, p, **kw):
        eng = cls(c, p, sc_cls(max_len=12, batch=2, **kw))
        for rid, prompt in PROMPTS.items():
            eng.submit(rid, list(prompt))
        return eng, eng.run_until_done(max_ticks=40)

    _, base = run(ServingEngine, ServeConfig, cfg, params)
    eng, traced = run(ServingEngine, ServeConfig, cfg, params, compile_mode="kitsune")
    assert traced == base and set(base) == set(PROMPTS)
    assert run(JServingEngine, JServeConfig, jcfg, jparams)[1] == base
    # one trace serves every tick: the position is a device tensor operand
    assert eng._step.app.traced.module is not None
    before = lowering_count()
    run(ServingEngine, ServeConfig, cfg, params, compile_mode="kitsune")
    assert lowering_count() == before


@pytest.mark.parametrize("name", ["phi3-medium-14b", "hymba-1.5b"])
def test_paged_engine_compile_mode(name):
    jcfg, jparams, cfg, params = _models(name)
    kw = dict(max_len=24, batch=2, num_blocks=16, prefill_chunk=3)

    def run(cls, sc_cls, c, p, **extra):
        eng = cls(c, p, sc_cls(**kw, **extra), eos_id=-1)
        for rid, prompt in PROMPTS.items():
            eng.submit(list(prompt), rid=rid)
        return eng, eng.run_until_done()

    _, base = run(PagedServingEngine, ServeConfig, cfg, params)
    eng, traced = run(PagedServingEngine, ServeConfig, cfg, params, compile_mode="kitsune")
    assert traced == base
    assert run(JPagedEngine, JServeConfig, jcfg, jparams)[1] == base
    apps = [fn.app for fn in eng._steps.values()]
    assert apps and all(a.options.mode == "kitsune" for a in apps)
    if name == "phi3-medium-14b":
        # every attention site reads the pools through the paged kernel's node
        used = set().union(*(a.lowering.kernels_used() for a in apps))
        assert {"paged_flash_decode", "fused_mlp_swiglu"} <= used


def test_paged_decode_atom_lowers_to_paged_kernel():
    from repro_torch.models.atoms import paged_decode_atom
    rng = np.random.default_rng(7)
    bs = 4
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 16)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((6 * bs, 2, 16)).astype(np.float32))
              for _ in range(2))
    tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
    valid = torch.tensor([6, 11], dtype=torch.int32)
    atom = paged_decode_atom(bs)

    def fn(q, kp, vp, tables, valid):
        return atom(q, kp, vp, tables, valid) * 2.0

    app = repro_torch.compile(fn, (q, kp, vp, tables, valid), mode="kitsune")
    matches = [m for p in app.lowering.pipelines.values() for m in p.matches
               if m.kernel == "paged_flash_decode"]
    assert matches and all(m.executable and m.meta["block_size"] == bs for m in matches)
    want = K.ref.paged_decode_ref(q, kp, vp, tables, valid_len=valid, block_size=bs) * 2.0
    close(app(q, kp, vp, tables, valid), want, 1e-5)
