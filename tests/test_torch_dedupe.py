"""The dedupe pass changes no bit of a training step: the port's
`compile_train_step` on reduced qwen1.5-32b with 4 microbatches (batch
(4, 12), `TrainConfig(remat=False, xent_chunk=8, microbatches=4)`),
compiled with the dedupe pass and with `disable=("dedupe",)`, gives every
state and metric leaf `torch.equal` over two steps, while the pass keys the
unrolled microbatches' programs to fewer executables.

This is the port's side of the reference's
`tests/test_cse.py::TestDedupeDifferential::test_train_step_microbatches_bitwise`,
which fails under the installed jax (its traced-atomic path, ROADMAP
"Reference caveats"): the port is held to itself, not to that path.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, compile_train_step, make_train_state
from repro_torch.tree import leaves, tree_map

TC = TrainConfig(remat=False, xent_chunk=8, microbatches=4)
STEPS = 2


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.fixture(scope="module")
def runs():
    cfg = get_config("qwen1.5-32b").reduced()
    state = make_train_state(cfg, adamw(1e-3), seed=0, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 12))).long()}
    out = {}
    for name, kw in (("on", {}), ("off", {"disable": ("dedupe",)})):
        app = compile_train_step(cfg, adamw(1e-3), TC, state=_clone(state), batch=batch,
                                 compile_mode="kitsune", **kw)
        s, metrics = _clone(state), []
        for _ in range(STEPS):
            s, m = app(s, batch)
            metrics.append(m)
        out[name] = (app, s, metrics)
    return out


def test_state_and_metrics_bitwise_equal(runs):
    _, s_on, m_on = runs["on"]
    _, s_off, m_off = runs["off"]
    got, want = leaves(s_on) + leaves(m_on), leaves(s_off) + leaves(m_off)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(torch.isfinite(m["loss"]).all() for m in m_on)


def test_dedupe_shares_the_microbatch_programs(runs):
    """With the pass, structurally equal sf-programs of the four unrolled
    microbatches share one key; without it every program keeps its own."""
    app_on, app_off = runs["on"][0], runs["off"][0]
    sf = [p.name for p in app_on.pipelined.pipelines]
    keys = app_on.dedupe.struct_keys
    assert len(sf) >= TC.microbatches
    assert len({keys[n] for n in sf}) < len(sf)
    assert app_off.dedupe is None or not app_off.dedupe.struct_keys
