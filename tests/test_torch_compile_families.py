"""The compiled paths on the families beyond dense, held against the
reference package on the CPU (`.reduced()` configs, float32, the
reference's weights carried across by `params_from_numpy`): since the
executable cache binds every compiled program of the port, these paths go
through it too.

  * `compile_train_step` on llama4-maverick, grok-1, hymba, xlstm and
    pixtral: two kitsune steps equal two steps of the reference's raw
    `make_train_step` under `jax.jit` and two eager port steps (losses,
    parameters and optimizer moments within 2e-4); the MoE configs
    against the reference with its drop defect corrected
    (tests/test_torch_families.py `_dispatch_dropping_nowhere`);
  * both engines with `compile_mode` bsp, vertical and kitsune serve the
    reference engines' tokens on xlstm (no pages), maverick and grok-1
    (batch 1: MoE capacity routing couples the slots of a step, ROADMAP C)
    and pixtral.

The reference's own traced path fails under the installed jax (ROADMAP
"Reference caveats"), so its side is the raw step and the default
engines, as in tests/test_torch_train_compile.py and
tests/test_torch_serve_families.py.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.optim import adamw as j_adamw
from repro.serve import PagedServingEngine as JPagedEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step

from repro_torch.configs import get_config
from repro_torch.core.executor import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.serve import PagedServingEngine, ServeConfig, ServingEngine
from repro_torch.train import TrainConfig, compile_train_step, make_train_step
from repro_torch.tree import leaves, tree_map

from test_torch_families import _dispatch_dropping_nowhere

MAVERICK, GROK = "llama4-maverick-400b-a17b", "grok-1-314b"
PROMPTS = {1: [5, 6, 7], 2: [9, 8], 3: [3, 4, 5, 6]}

_MODELS: dict = {}
_REFERENCE: dict = {}


def close(got, want, tol=2e-4):
    def arr(a):
        return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    np.testing.assert_allclose(arr(got), arr(want), rtol=tol, atol=tol)


def models(arch):
    """(reference cfg, reference params, port cfg, port params): one set of
    weights in both packages."""
    if arch not in _MODELS:
        jcfg = j_get_config(arch).reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[arch] = jcfg, jparams, get_config(arch).reduced(), params
    return _MODELS[arch]


@pytest.mark.parametrize("arch", [MAVERICK, GROK, "hymba-1.5b", "xlstm-350m", "pixtral-12b"])
def test_compile_train_step_equals_eager(arch, monkeypatch):
    monkeypatch.setattr(j_layers, "_dispatch_group", _dispatch_dropping_nowhere)
    jcfg, jparams, cfg, params = models(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    jbatch = {"tokens": jax.numpy.asarray(tokens)}
    clone = lambda tree: tree_map(lambda t: t.clone(), tree)   # noqa: E731
    state = {"params": clone(params), "opt": adamw(1e-3).init(params)}
    app = compile_train_step(cfg, adamw(1e-3), TrainConfig(remat=False, xent_chunk=8),
                             state=clone(state), batch=batch)
    eager = make_train_step(cfg, adamw(1e-3), TrainConfig(remat=False, xent_chunk=8))
    jstep = jax.jit(j_make_train_step(jcfg, j_adamw(1e-3),
                                      JTrainConfig(remat=False, xent_chunk=8)))
    jstate = {"params": jparams, "opt": j_adamw(1e-3).init(jparams)}
    s, e = clone(state), clone(state)
    for i in range(2):
        s, m = app(s, batch)
        e, em = eager(e, batch)
        jstate, jm = jstep(jstate, jbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"{arch} step {i}")
        close(m["loss"], em["loss"])
    for a, b in zip(leaves(s), leaves(e)):
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


def _serve(pkg, arch, engine, **kw):
    """PROMPTS through one engine of `pkg` ("port" or "reference")."""
    jcfg, jparams, cfg, params = models(arch)
    cfg, params, sc_cls, legacy, paged = (
        (cfg, params, ServeConfig, ServingEngine, PagedServingEngine) if pkg == "port"
        else (jcfg, jparams, JServeConfig, JServingEngine, JPagedEngine))
    batch = 1 if arch in (MAVERICK, GROK) else 2
    if engine == "legacy":
        eng = legacy(cfg, params, sc_cls(max_len=12, batch=batch, **kw), eos_id=-1)
        for rid, prompt in PROMPTS.items():
            eng.submit(rid, list(prompt))
        return eng.run_until_done(max_ticks=60)
    eng = paged(cfg, params, sc_cls(max_len=24, batch=batch, num_blocks=16, prefill_chunk=3,
                                    **kw), eos_id=-1)
    for rid, prompt in PROMPTS.items():
        eng.submit(list(prompt), rid=rid)
    return eng.run_until_done()


@pytest.mark.parametrize("mode", ["bsp", "vertical", "kitsune"])
@pytest.mark.parametrize("engine", ["paged", "legacy"])
@pytest.mark.parametrize("arch", ["xlstm-350m", MAVERICK, GROK, "pixtral-12b"])
def test_engines_compile_mode_equal_eager(arch, engine, mode):
    if (arch, engine) not in _REFERENCE:
        _REFERENCE[arch, engine] = _serve("reference", arch, engine)
    want = _REFERENCE[arch, engine]
    assert set(want) == set(PROMPTS)
    assert _serve("port", arch, engine, compile_mode=mode) == want
