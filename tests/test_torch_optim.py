"""The port's optimizers, data pipeline, checkpointer, supervisor and
training launcher held against the reference package (optimizers, data)
and against the invariants the reference asserts within itself
(checkpoint round trips, crash and resume).

Float32 tolerances are 2e-4 unless a test states otherwise; the synthetic
token stream must be bit-equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import quantize_blockwise as jquantize

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, SyntheticLM, make_batches
from repro_torch.optim import (QTensor, adamw, clip_by_global_norm,
                               cosine_schedule, dequantize_blockwise,
                               quantize_blockwise)
from repro_torch.runtime import (FailureInjector, StragglerMonitor, Supervisor,
                                 TrainerCrash)
from repro_torch.tree import flatten, leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4


def trees(seed: int):
    """A small parameter tree and a matching gradient tree: numpy arrays,
    as (jax tree, torch tree) pairs."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 6), "b": (6,), "blk": {"k": (2, 5, 3), "s": (300,)}}

    def make(scale):
        def walk(d):
            return {k: walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v) * scale).astype(np.float32) for k, v in d.items()}
        return walk(shapes)

    def split(t):
        return (jax.tree.map(jnp.asarray, t),
                jax.tree.map(lambda a: torch.from_numpy(a.copy()), t))
    return split(make(1.0)), [split(make(0.5 + i)) for i in range(3)]


def close_trees(got, want, tol=TOL):
    w = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(want)]
    g = leaves(got)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=tol, atol=tol)


@pytest.mark.parametrize("make", [
    lambda m: m.adamw(1e-2, weight_decay=0.1),
    lambda m: m.adamw(m.cosine_schedule(1e-2, warmup=1, total=3), state_bits=8, block=64),
    lambda m: m.adafactor(1e-2)], ids=["adamw32", "adamw8", "adafactor"])
def test_optimizers_match_reference(make):
    import repro.optim as jo
    import repro_torch.optim as to
    (jp, tp), grads = trees(0)
    jopt, topt = make(jo), make(to)
    js, ts = jopt.init(jp), topt.init(tp)
    for jg, tg in grads:
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    close_trees(tp, jp)
    want, got = jax.tree_util.tree_leaves(js.inner), leaves(ts.inner)
    assert len(want) == len(got)
    for a, b in zip(got, want):
        # int8 moment codes may round to a neighbouring code
        tol = 1 if a.dtype == torch.int8 else TOL
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=TOL, atol=tol)
    assert int(ts.step) == int(js.step) == 3


def test_adamw_moments_are_distinct_buffers():
    (_, tp), _ = trees(1)
    for bits in (32, 8):
        for m, v in (s for s in _pairs(adamw(state_bits=bits).init(tp).inner)):
            a, b = (m.codes, v.codes) if bits == 8 else (m, v)
            assert a.data_ptr() != b.data_ptr()


def _pairs(inner):
    if isinstance(inner, dict):
        for v in inner.values():
            yield from _pairs(v)
    else:
        yield inner


def test_schedule_clip_quantize_match_reference():
    jlr, tlr = jcosine(3e-4, 20, 100), cosine_schedule(3e-4, 20, 100)
    for s in (0, 5, 19, 20, 21, 60, 99, 150):
        np.testing.assert_allclose(float(tlr(torch.tensor(s, dtype=torch.int32))),
                                   float(jlr(jnp.int32(s))), rtol=1e-6)
    _, grads = trees(2)
    for max_norm in (0.5, 1e3):
        jg, jn = jclip(grads[0][0], max_norm)
        tg, tn = clip_by_global_norm(grads[0][1], max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        close_trees(tg, jg, 1e-6)
    x = np.random.default_rng(3).standard_normal((7, 45)).astype(np.float32)
    q, jq = quantize_blockwise(torch.from_numpy(x), 64), jquantize(jnp.asarray(x), 64)
    assert isinstance(q, QTensor) and q.shape == (7, 45)
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_allclose(q.scales.numpy(), np.asarray(jq.scales), rtol=1e-7)
    np.testing.assert_allclose(dequantize_blockwise(q).numpy(), x, atol=np.abs(x).max() / 127)


def test_synthetic_tokens_bit_equal_reference():
    for cfg in (dict(vocab=256, seq_len=33, global_batch=8),
                dict(vocab=262144, seq_len=64, global_batch=4, n_shards=2, shard=1, seed=7)):
        ours, ref = SyntheticLM(DataConfig(**cfg)), JSyntheticLM(JDataConfig(**cfg))
        for step in (0, 1, 17):
            np.testing.assert_array_equal(ours.batch(step)["tokens"], ref.batch(step)["tokens"])
    it = make_batches(DataConfig(vocab=256, seq_len=8, global_batch=2), start_step=3)
    step, batch = next(it)
    it.close()
    assert step == 3
    np.testing.assert_array_equal(
        batch["tokens"], SyntheticLM(DataConfig(vocab=256, seq_len=8, global_batch=2)).batch(3)["tokens"])


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 300, generator=g).to(torch.bfloat16),
              "n": {"g": torch.randn(5, generator=g)}}
    return {"params": params, "opt": adamw(1e-2, state_bits=8, block=64).init(params)}


def test_checkpointer_round_trip_and_commit_marker(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    state = _state()
    for step in (1, 2, 3):
        ck.save(step, state, extra={"step": step})
    ck.wait()
    assert ck.committed_steps() == [2, 3]          # GC keeps the last two
    os.makedirs(tmp_path / "step_00000009.tmp")    # crash debris
    (tmp_path / "step_00000009.tmp" / "COMMITTED").write_text("ok")
    assert ck.latest_step() == 3 and ck.extra(3) == {"step": 3}
    got = ck.restore(3, _state(seed=1))
    for (pa, a), (pb, b) in zip(flatten(got), flatten(state)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    assert got["opt"].inner["w"][0].shape == (4, 300)
    os.remove(tmp_path / "step_00000003" / "COMMITTED")
    assert ck.latest_step() == 2


def _supervised(tmp_path, injector=None):
    opt = adamw(1e-1)
    target = torch.linspace(-1, 1, 12)

    def init_state():
        p = {"x": torch.zeros(12)}
        return {"params": p, "opt": opt.init(p)}

    def step_fn(state, step):
        g = {"x": state["params"]["x"] - target * (step + 1)}
        p, o = opt.update(g, state["opt"], state["params"])
        return {"params": p, "opt": o}

    sup = Supervisor(Checkpointer(str(tmp_path)), checkpoint_every=2, backoff_s=0.0)
    return sup.run(init_state=init_state, step_fn=step_fn, n_steps=7, injector=injector)


def test_supervisor_resumes_after_crash(tmp_path):
    """A crash at step 5 restores the committed step 3 and ends equal to an
    uninterrupted run (runtime/supervisor.py's contract)."""
    clean, rep0 = _supervised(tmp_path / "a")
    crashed, rep = _supervised(tmp_path / "b", FailureInjector(fail_at={5}))
    assert rep0["restarts"] == 0 and rep["restarts"] == 1 and rep["restored_from"] == [3]
    for (_, a), (_, b) in zip(flatten(clean), flatten(crashed)):
        assert torch.equal(a, b)

    def always(state, step):
        raise TrainerCrash("always")

    with pytest.raises(TrainerCrash):
        Supervisor(Checkpointer(str(tmp_path / "c")), max_restarts=0, backoff_s=0.0).run(
            init_state=lambda: {"x": torch.zeros(1)}, step_fn=always, n_steps=2)


def test_straggler_monitor():
    mon = StragglerMonitor(window=8, z_threshold=3.0, sustained=3)
    for _ in range(20):
        assert mon.record(0.1) is None
    kinds = [a["action"] for a in (mon.record(1.0) for _ in range(4)) if a]
    assert "increase_prefetch" in kinds and "flag_remesh" in kinds


def test_launcher_trains_reduced_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma3-1b", "--reduced",
         "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
         "--ckpt", str(tmp_path / "ck")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "step     0 loss" in out.stdout and "finished:" in out.stdout
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 2
