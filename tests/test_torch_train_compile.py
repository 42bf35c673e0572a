"""Dataflow training in the port: the full train step (forward, backward,
loss, optimizer) traced and compiled through the pass pipeline
(`repro_torch.train.compile_train_step`), held against the eager port
step and the reference package.

  * three steps of the compiled step equal the eager `make_train_step` and
    the reference's raw `make_train_step` (loss rtol 1e-4, parameter and
    optimizer trees 2e-4) on gemma3-1b, whisper-small and qwen1.5-32b
    `.reduced()`, with the reference's weights carried across; the plan
    holds EXECUTABLE fused-MLP matches in both directions (forward and
    backward kernels, under remat the recomputed forward too);
  * bsp == kitsune; a second step builds nothing;
  * donation: only the declared state leaves are donated, batch feeds
    never, two feeds sharing one storage never; the donated state is
    consumed (it holds the new state after the call);
  * the atoms: `mlp_atom` lowers both directions, `dataflow_training()`
    restores the originals, and the explicit attention backward equals
    autograd through `lm.chunked_attention`.

The reference's `compile_train_step` fails under the installed jax
(ROADMAP "Reference caveats"), so the reference side is its raw
`make_train_step`, as in tests/test_torch_train.py.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.optim import adamw as j_adamw
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_state as j_make_train_state
from repro.train import make_train_step as j_make_train_step

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.executor import lowering_count, params_from_numpy
from repro_torch.kernels import ref
from repro_torch.launch import train as launch_train
from repro_torch.models import atoms, encdec, layers, lm
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, compile_train_step, make_train_step
from repro_torch.tree import leaves, tree_map

TRAIN_ARCHS = ["gemma3-1b", "whisper-small", "qwen1.5-32b"]
_TC = TrainConfig(remat=False, xent_chunk=8)
_JTC = JTrainConfig(remat=False, xent_chunk=8)


def close(got, want, tol=2e-4):
    def arr(a):
        return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    np.testing.assert_allclose(arr(got), arr(want), rtol=tol, atol=tol)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


_MEMO: dict = {}


def case(name: str, seed: int = 0):
    """(port cfg, port state, port batch, reference cfg, reference params,
    reference batch): the reference's weights and one batch, carried
    across."""
    key = (name, seed)
    if key not in _MEMO:
        jcfg = j_get_config(name).reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(seed))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        rng = np.random.default_rng(seed + 1)
        arrays = {"tokens": rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)}
        if jcfg.family == "encdec":
            arrays["frame_embeds"] = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
        batch = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
                 for k, v in arrays.items()}
        jbatch = {k: jax.numpy.asarray(v) for k, v in arrays.items()}
        state = {"params": params, "opt": adamw(1e-3).init(params)}
        _MEMO[key] = (get_config(name).reduced(), state, batch, jcfg, jparams, jbatch)
    cfg, state, batch, jcfg, jparams, jbatch = _MEMO[key]
    return cfg, _clone(state), batch, jcfg, jparams, jbatch


def _matches(app) -> dict:
    out: dict = {}
    for p in app.lowering.pipelines.values():
        for m in p.matches:
            out.setdefault(m.kernel, []).append(m)
    return out


# ---------------------------------------------------------------------------
# the compiled step against the eager step and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_three_steps_match_eager_and_reference(name):
    cfg, state, batch, jcfg, jparams, jbatch = case(name)
    app = compile_train_step(cfg, adamw(1e-3), _TC, state=_clone(state), batch=batch,
                             compile_mode="kitsune", donate_state=True)
    kern = _matches(app)
    fwd, bwd = (("fused_mlp", "fused_mlp_bwd") if cfg.family == "encdec"
                else ("fused_mlp_swiglu", "fused_mlp_swiglu_bwd"))
    assert kern.get(fwd) and kern.get(bwd), f"{name}: {sorted(kern)}"
    assert all(m.executable for m in kern[fwd] + kern[bwd])
    assert len(kern[bwd]) == cfg.n_layers * (2 if cfg.family == "encdec" else 1)

    eager = make_train_step(cfg, adamw(1e-3), _TC)
    jstep = jax.jit(j_make_train_step(jcfg, j_adamw(1e-3), _JTC))
    jstate = j_make_train_state(jcfg, j_adamw(1e-3), jax.random.PRNGKey(0))
    s, es = state, _clone(state)
    for i in range(3):
        s, m = app(s, batch)
        es, em = eager(es, batch)
        jstate, jm = jstep(jstate, jbatch)
        np.testing.assert_allclose(float(m["loss"]), float(em["loss"]), rtol=1e-4,
                                   err_msg=f"{name} step {i}")
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"{name} step {i}")
    for a, b in zip(leaves(s), leaves(es)):
        close(a, b)
    for a, b in zip(leaves(s["params"]), jax.tree_util.tree_leaves(jstate["params"])):
        close(a, b)
    jm_, jv_ = zip(*jax.tree_util.tree_leaves(jstate["opt"].inner,
                                               is_leaf=lambda t: isinstance(t, tuple)))
    mv = leaves(s["opt"].inner)
    for a, b in zip(mv[0::2], jm_):
        close(a, b)
    for a, b in zip(mv[1::2], jv_):
        close(a, b)


def test_remat_recompute_is_a_lowered_node():
    """Under remat the forward MLP runs twice a step (forward, then its
    recompute in the backward): both are kernel nodes."""
    cfg, state, batch, *_ = case("gemma3-1b")
    app = compile_train_step(cfg, adamw(1e-3), TrainConfig(remat=True, xent_chunk=8),
                             state=state, batch=batch, donate_state=False)
    kern = _matches(app)
    assert len(kern["fused_mlp_swiglu"]) == 2 * cfg.n_layers
    assert len(kern["fused_mlp_swiglu_bwd"]) == cfg.n_layers


def test_bsp_mode_same_numerics():
    cfg, state, batch, *_ = case("gemma3-1b", seed=3)
    kit = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch,
                             compile_mode="kitsune", donate_state=False)
    bsp = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch,
                             compile_mode="bsp", donate_state=False)
    ks, km = kit(state, batch)
    bs, bm = bsp(state, batch)
    np.testing.assert_allclose(float(km["loss"]), float(bm["loss"]), rtol=1e-5)
    for a, b in zip(leaves(ks), leaves(bs)):
        close(a, b, 5e-4)


@pytest.mark.parametrize("first,then", [("kitsune", "bsp"), ("bsp", "kitsune")])
def test_with_mode_equals_a_fresh_compile(first, then):
    """`with_mode` compiles the same trace in another mode: its step is
    bitwise the step of a fresh `compile_train_step` in that mode."""
    cfg, state, batch, *_ = case("gemma3-1b", seed=8)
    app = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch,
                             compile_mode=first, donate_state=False)
    other = app.with_mode(then)
    fresh = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch,
                               compile_mode=then, donate_state=False)
    assert other.traced is app.traced and other.options.mode == then
    assert [r.name for r in other.pass_records] == [r.name for r in fresh.pass_records]
    (s, m), (fs, fm) = other(state, batch), fresh(state, batch)
    assert torch.equal(m["loss"], fm["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(s), leaves(fs)))


def test_second_step_builds_nothing():
    cfg, state, batch, *_ = case("qwen1.5-32b", seed=4)
    app = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch)
    s, _ = app(state, batch)
    before = lowering_count()
    app(s, batch)
    assert lowering_count() == before, "the training hot path built programs"


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------

def test_only_declared_state_feeds_donated():
    cfg, state, batch, *_ = case("gemma3-1b", seed=5)
    app = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch,
                             donate_state=True)
    n_state = len(torch.utils._pytree.tree_leaves(state))
    names = app.traced.in_names
    assert app.donate_feeds == set(names[:n_state])
    donated = {d for d, _ in app.donation}
    assert donated and donated <= app.donate_feeds
    assert not donated & set(names[n_state:]), "a batch feed was donated"
    # the donation copies are graph nodes, each after its input's last reader
    copies = [n for n in app.graph.topo() if n.attrs.get("prim") == "donate"]
    assert len(copies) == len(app.donation)
    assert "reused by outputs" in app.describe()


def test_donate_state_false_donates_nothing():
    cfg, state, batch, *_ = case("gemma3-1b", seed=6)
    app = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch,
                             donate_state=False)
    assert not app.donate_feeds and not app.donation
    assert not any(n.attrs.get("prim") == "donate" for n in app.graph.topo())


def test_donated_state_is_consumed():
    cfg, state, batch, *_ = case("qwen1.5-32b", seed=7)
    app = compile_train_step(cfg, adamw(1e-3), _TC, state=_clone(state), batch=batch,
                             donate_state=True)
    before = _clone(state)
    new, _ = app(state, batch)
    old_leaves, new_leaves = leaves(state), leaves(new)
    shared = [a for a, b in zip(old_leaves, new_leaves)
              if a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()]
    assert len(shared) == len(app.donation) > 0
    # the donated tensors now hold the new state, not the old
    assert any(not torch.equal(a, b) for a, b in zip(leaves(before), old_leaves))


def test_aliased_feed_buffers_never_donated():
    """Two feeds sharing ONE storage (tied state leaves) are not written in
    place: writing one would change the other."""
    def step(state, x):
        return {"a": state["a"] + x, "b": state["b"] * 2.0}

    shared = torch.ones((8, 8))
    x = torch.ones((8, 8))
    app = repro_torch.compile(step, ({"a": shared, "b": shared}, x), mode="bsp",
                              donate_argnums=(0,))
    out = app({"a": shared, "b": shared}, x)
    assert torch.all(out["a"] == 2.0) and torch.all(out["b"] == 2.0)
    assert torch.all(shared == 1.0), "an aliased buffer was written"
    # unaliased, the same app writes its state in place
    st = {"a": torch.ones((8, 8)), "b": torch.ones((8, 8))}
    out = app(st, x)
    assert out["a"].data_ptr() == st["a"].data_ptr() and torch.all(st["a"] == 2.0)


# ---------------------------------------------------------------------------
# the atoms
# ---------------------------------------------------------------------------

def test_mlp_atom_grad_lowers_both_directions():
    amlp = atoms.mlp_atom("gelu")
    rng = np.random.default_rng(0)
    x, w1, w2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * sc)
                 for s, sc in (((4, 8), 1.0), ((8, 16), 0.1), ((16, 8), 0.1)))

    def grads(fn):
        def g(w1, w2):
            live = [w1.detach().requires_grad_(), w2.detach().requires_grad_()]
            return torch.autograd.grad((fn(x, *live) ** 2).sum(), live)
        return g

    app = repro_torch.compile(grads(amlp), (w1, w2), mode="kitsune")
    used = app.lowering.kernels_used()
    assert "fused_mlp" in used and "fused_mlp_bwd" in used
    want = grads(lambda x, a, b: ref.mlp_ref(x, a, b, act="gelu"))(w1, w2)
    for g, w in zip(app(w1, w2), want):
        close(g, w)


def test_dataflow_training_restores_originals():
    orig = (layers.mlp_block, lm.chunked_attention, encdec.chunked_attention)
    with atoms.dataflow_training():
        assert layers.mlp_block is not orig[0]
        assert lm.chunked_attention is not orig[1]
        assert encdec.chunked_attention is not orig[2]
    assert (layers.mlp_block, lm.chunked_attention, encdec.chunked_attention) == orig


@pytest.mark.parametrize("causal,hq,hkv,sq,skv,window,chunk", [
    (True, 2, 2, 8, 8, None, 1024),
    (True, 4, 2, 12, 12, 5, 4),      # GQA, a window, chunks with a ragged last one
    (False, 4, 1, 6, 10, None, 4),   # cross attention, ragged chunks
    (True, 2, 1, 3, 9, None, 1024),  # causal, the ends aligned
])
def test_attention_atom_backward_matches_autograd(causal, hq, hkv, sq, skv, window, chunk):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, hq, sq, 16), (2, hkv, skv, 16), (2, hkv, skv, 16)))
    dy = torch.from_numpy(rng.standard_normal((2, hq, sq, 16)).astype(np.float32))
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    out = atoms.atomic_chunked_attention(*live, causal=causal, window=window, chunk=chunk)
    got = torch.autograd.grad(out, live, dy)
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = lm.chunked_attention(*live, causal=causal, window=window, chunk=chunk)
    want = torch.autograd.grad(want_out, live, dy)
    close(out, want_out, 1e-6)
    for g, w in zip(got, want):
        close(g, w)


def test_describe_shows_executable_backward():
    cfg, state, batch, *_ = case("whisper-small", seed=8)
    app = compile_train_step(cfg, adamw(1e-3), _TC, state=state, batch=batch,
                             donate_state=False)
    text = app.describe()
    assert "lowered fused_mlp_bwd" in text
    for line in text.splitlines():
        if "lowered fused_mlp_bwd" in line:
            assert "(plan-only)" not in line
    assert "atomic attention: recompute" in text


def test_launcher_compile_mode_on_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path / "ck"),
                       "--compile-mode", "kitsune"])
    out = capsys.readouterr().out
    assert "compiled (kitsune" in out and "fused_mlp_swiglu_bwd" in out
    assert "completed_steps': 2" in out
