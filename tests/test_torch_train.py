"""The port's training path (repro_torch kernels' backward, models' forward,
train step) held against the reference package on the same inputs.

Inputs and weights are made with numpy from a seed (weights through the
reference's `init_params` and `params_from_numpy`) and handed to both
packages.  The reference trains through `make_train_step` and `jax.grad`,
never through `compile_train_step` (its traced-atomic path fails under the
installed jax; ROADMAP "Reference caveats").  Tolerances: the reference's
kernel contract, float32 2e-4 and bfloat16 2e-2 (tests/test_kernels.py:25);
whole-model float32 comparisons 2e-4 as well.  On the CPU every kernel
wrapper runs its plain version; tests/test_torch_gpu.py holds the CUDA
kernels to those on the card.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import KernelConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_mlp import fused_mlp_bwd as pallas_mlp_bwd
from repro.kernels.fused_mlp import fused_mlp_swiglu_bwd as pallas_swiglu_bwd
from repro.models import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_state as jmake_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train.step import chunked_softmax_xent as jxent
from repro.train.step import loss_fn as jloss_fn

from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.executor import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ref as tref
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.train import (TrainConfig, chunked_softmax_xent, loss_fn,
                               make_train_step)
from repro_torch.tree import flatten, leaves

F32, BF16 = "float32", "bfloat16"
NP_DTYPES = {F32: np.float32, BF16: ml_dtypes.bfloat16}
TOL = {F32: 2e-4, BF16: 2e-2}
ACTS = ["gelu", "relu", "silu", "identity"]


def arrays(seed: int, dtype: str, *shapes, fan_in=False):
    """numpy arrays from one seed; with fan_in every array after the first
    is scaled by 1/sqrt(rows) so values stay O(1)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        a = rng.standard_normal(shape).astype(np.float32)
        if fan_in and i > 0:
            a /= np.sqrt(shape[0])
        out.append(a.astype(NP_DTYPES[dtype]))
    return out


def both(a):
    return jnp.asarray(a), tensor_from_numpy(a, "cpu")


def close(got, want, tol):
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# activation derivatives and the backward oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
def test_dacts_match_autograd_and_reference(act):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    jx, tx = both(x)
    got = tref.DACTS[act](tx)
    close(got, jref._DACTS[act](jx), 1e-5)
    t = tx.clone().requires_grad_()
    (auto,) = torch.autograd.grad(tref.ACTS[act](t).sum(), t)
    close(got, auto, 1e-5)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_backward_oracles_match_reference_and_pallas(act, dtype):
    """mlp_bwd_ref / mlp_swiglu_bwd_ref against repro.kernels.ref and the
    Pallas fused_mlp_bwd / fused_mlp_swiglu_bwd in interpret mode."""
    x, w1, wu, w2, dy = arrays(0, dtype, (256, 64), (64, 1024), (64, 1024), (1024, 64),
                               (256, 64), fan_in=True)
    (jx, tx), (jw1, tw1), (jwu, twu), (jw2, tw2), (jdy, tdy) = map(both, (x, w1, wu, w2, dy))
    tdy, jdy = tdy * 16, jdy * 16            # dy O(1): undo fan_in's 1/sqrt(256)
    blocks = dict(block_m=128, block_h=512, interpret=True)
    got = K.fused_mlp_bwd(tx, tw1, tw2, tdy, act=act)
    for want in (jref.mlp_bwd_ref(jx, jw1, jw2, jdy, act=act),
                 pallas_mlp_bwd(jx, jw1, jw2, jdy, act=act, **blocks)):
        for g, w in zip(got, want):
            assert g.dtype == tx.dtype
            close(g, w, TOL[dtype])
    got = K.fused_mlp_swiglu_bwd(tx, tw1, twu, tw2, tdy, act=act)
    for want in (jref.mlp_swiglu_bwd_ref(jx, jw1, jwu, jw2, jdy, act=act),
                 pallas_swiglu_bwd(jx, jw1, jwu, jw2, jdy, act=act, **blocks)):
        for g, w in zip(got, want):
            close(g, w, TOL[dtype])


@pytest.mark.parametrize("act", ACTS)
def test_ops_bwd_ragged_rows_against_pallas(act):
    """ops.mlp_bwd / mlp_swiglu_bwd with leading batch dims and M = 21 rows,
    against the reference's ops with use_pallas in interpret mode."""
    x, w1, wu, w2, dy = arrays(1, F32, (3, 7, 32), (32, 128), (32, 128), (128, 24),
                               (3, 7, 24), fan_in=True)
    (jx, tx), (jw1, tw1), (jwu, twu), (jw2, tw2), (jdy, tdy) = map(both, (x, w1, wu, w2, dy))
    cfg = KernelConfig(use_pallas=True, interpret=True)
    got = K.mlp_bwd(tx, tw1, tw2, tdy, act=act)
    assert got[0].shape == tx.shape
    for g, w in zip(got, jops.mlp_bwd(jx, jw1, jw2, jdy, act=act, cfg=cfg)):
        close(g, w, TOL[F32])
    got = K.mlp_swiglu_bwd(tx, tw1, twu, tw2, tdy, act=act)
    for g, w in zip(got, jops.mlp_swiglu_bwd(jx, jw1, jwu, jw2, jdy, act=act, cfg=cfg)):
        close(g, w, TOL[F32])


@pytest.mark.parametrize("act", ACTS)
def test_functions_grad_match_jax(act):
    """Gradients through K.mlp (the FusedMLP Function) against jax.grad of
    the reference's custom-VJP mlp (Pallas forward and backward in
    interpret mode), and through K.mlp_swiglu against jax.grad of
    ref.mlp_swiglu_ref."""
    x, w1, wu, w2, dy = arrays(2, F32, (2, 8, 16), (16, 64), (16, 64), (64, 16),
                               (2, 8, 16), fan_in=True)
    (jx, tx), (jw1, tw1), (jwu, twu), (jw2, tw2), (jdy, tdy) = map(both, (x, w1, wu, w2, dy))
    cfg = KernelConfig(use_pallas=True, interpret=True)
    want = jax.grad(lambda *a: jnp.vdot(jops.mlp(*a, act=act, cfg=cfg), jdy),
                    argnums=(0, 1, 2))(jx, jw1, jw2)
    ins = [t.clone().requires_grad_() for t in (tx, tw1, tw2)]
    for g, w in zip(torch.autograd.grad(K.mlp(*ins, act=act), ins, tdy), want):
        close(g, w, TOL[F32])
    want = jax.grad(lambda x, g, u, d: jnp.vdot(
        jref.mlp_swiglu_ref(x.reshape(-1, 16), g, u, d, act=act), jdy.reshape(-1, 16)),
        argnums=(0, 1, 2, 3))(jx, jw1, jwu, jw2)
    ins = [t.clone().requires_grad_() for t in (tx, tw1, twu, tw2)]
    for g, w in zip(torch.autograd.grad(K.mlp_swiglu(*ins, act=act), ins, tdy), want):
        close(g, w, TOL[F32])


def test_no_grad_path_builds_no_function_node():
    """Outside autograd the MLP wrappers call the forward kernel directly
    (no Function node): the serving path is unchanged."""
    x, w1, w2 = (tensor_from_numpy(a, "cpu")
                 for a in arrays(3, F32, (4, 16), (16, 32), (32, 16), fan_in=True))
    with torch.no_grad():
        assert K.mlp(x, w1, w2.requires_grad_()).grad_fn is None
    assert K.mlp(x, w1, w2).grad_fn is not None


# ---------------------------------------------------------------------------
# model forward, loss
# ---------------------------------------------------------------------------

_REF = {}


def reference(name: str):
    """(jax cfg, port cfg, jax params, port params) of `name`.reduced(),
    shared across tests (the reference init runs once per config)."""
    if name not in _REF:
        jcfg = jget_config(name).reduced()
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        _REF[name] = (jcfg, get_config(name).reduced(), jp,
                      params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _REF[name]


def batch_for(cfg, seed=1, b=2, s=12):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frame_embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
             for k, v in out.items()})


@pytest.mark.parametrize("name", ["gemma3-1b", "phi3-medium-14b", "qwen1.5-32b",
                                  "whisper-small"])
def test_forward_logits_match_reference(name):
    jcfg, cfg, jp, tp = reference(name)
    jb, tb = batch_for(cfg, s=40)           # gemma's reduced window is 32
    want = jget_model(jcfg).forward(jp, jb)
    with torch.no_grad():
        got = get_model(cfg).forward(tp, tb)
        hidden = get_model(cfg).forward(tp, tb, remat=True, return_hidden=True)
    assert got.shape == want.shape and hidden.shape == (*want.shape[:2], cfg.d_model)
    close(got, want, TOL[F32])


@pytest.mark.parametrize("n,chunk", [(17, 8), (32, 8), (9, 512)])
def test_losses_match_reference(n, chunk):
    """loss_fn and chunked_softmax_xent, with z_loss, on chunks that do and
    do not divide the sequence."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, n, 16)).astype(np.float32)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (2, n)).astype(np.int32)
    (jx, tx), (jt, tt) = both(x), both(table)
    jtok, ttok = jnp.asarray(toks), torch.from_numpy(toks.astype(np.int64))
    for z in (0.0, 1e-2):
        close(loss_fn(tx @ tt.T, ttok, z), jloss_fn(jx @ jt.T, jtok, z), 1e-5)
        close(chunked_softmax_xent(tx, tt, ttok, z, chunk=chunk),
              jxent(jx, jt, jtok, z, chunk=chunk), 1e-5)
    tx.requires_grad_()
    (g,) = torch.autograd.grad(chunked_softmax_xent(tx, tt, ttok, 1e-2, chunk=chunk), tx)
    close(g, jax.grad(lambda a: jxent(a, jt, jtok, 1e-2, chunk=chunk))(jx), 1e-5)


# ---------------------------------------------------------------------------
# the train step against the reference's make_train_step
# ---------------------------------------------------------------------------

def _train_pair(name: str, steps: int = 3):
    jcfg, cfg, jp, tp = reference(name)
    jb, tb = batch_for(cfg)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw(1e-3), JTrainConfig(remat=False,
                                                                      xent_chunk=8)))
    jstate = jmake_train_state(jcfg, jadamw(1e-3), jax.random.PRNGKey(0))
    tstep = make_train_step(cfg, adamw(1e-3), TrainConfig(remat=False, xent_chunk=8))
    tstate = {"params": tp, "opt": adamw(1e-3).init(tp)}
    for i in range(steps):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        close(tm["loss"], jm["loss"], TOL[F32])
        close(tm["grad_norm"], jm["grad_norm"], TOL[F32])
    return jstate, tstate


@pytest.mark.parametrize("name", ["gemma3-1b", "whisper-small", "qwen1.5-32b"])
def test_three_steps_match_reference(name):
    """Loss and grad norm per step, then parameters and AdamW moments."""
    jstate, tstate = _train_pair(name)
    want = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jstate["params"])]
    got = leaves(tstate["params"])
    assert len(want) == len(got)
    for g, w in zip(got, want):
        close(g, w, TOL[F32])
    jm, jv = zip(*jax.tree_util.tree_leaves(
        jstate["opt"].inner, is_leaf=lambda t: isinstance(t, tuple)))
    tmv = leaves(tstate["opt"].inner)
    for g, w in zip(tmv[0::2], jm):
        close(g, w, TOL[F32])
    for g, w in zip(tmv[1::2], jv):
        close(g, w, TOL[F32])
    assert int(tstate["opt"].step) == int(jstate["opt"].step) == 3


def _run(cfg, params, tc, steps=1, data_seed=1):
    opt = adamw(3e-3)
    step = make_train_step(cfg, opt, tc)
    state = {"params": params, "opt": opt.init(params)}
    _, tb = batch_for(cfg, seed=data_seed, b=4)
    losses = []
    for _ in range(steps):
        state, m = step(state, tb)
        losses.append(m["loss"].item())
    return losses, state


def test_microbatches_equal_one_batch():
    """tests/test_substrates.py:238 asserted within the port."""
    _, cfg, _, tp = reference("gemma3-1b")
    l1, s1 = _run(cfg, tp, TrainConfig(microbatches=1, remat=False))
    l2, s2 = _run(cfg, tp, TrainConfig(microbatches=2, remat=False))
    assert l1[0] == pytest.approx(l2[0], rel=1e-4)
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        close(a, b, 1e-4)


def test_remat_is_bitwise_on_cpu():
    for name in ("gemma3-1b", "whisper-small"):
        _, cfg, _, tp = reference(name)
        l1, s1 = _run(cfg, tp, TrainConfig(remat=False))
        l2, s2 = _run(cfg, tp, TrainConfig(remat=True))
        assert l1 == l2
        for (p, a), (_, b) in zip(flatten(s1), flatten(s2)):
            assert torch.equal(a, b), (name, p)


def test_loss_falls_on_reduced_gemma():
    """tests/test_substrates.py:225 asserted within the port: >= 0.3 in 20
    steps over 4 repeating batches of the synthetic stream."""
    from repro_torch.data import DataConfig, SyntheticLM
    _, cfg, _, tp = reference("gemma3-1b")
    step = make_train_step(cfg, adamw(3e-3), TrainConfig(remat=False))
    state = {"params": tp, "opt": adamw(3e-3).init(tp)}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    losses = []
    for i in range(20):
        state, m = step(state, {"tokens": torch.from_numpy(data.batch(i % 4)["tokens"])})
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.3, losses[::5]
