"""The port's executable cache held against the reference's on the CPU:

  * `cached_jit` builds when the reference's lowers: the same
    `lowering_count()` deltas for the same sequence of calls (a first call
    per shape, a repeat, a second instance with the same key, a new shape,
    a new key);
  * the bounded `ExecutableCache` answers the same sequence of
    `get_or_build` / `set_capacity` calls with the same `stats()` and the
    same key order (LRU on hit, eviction of the least recent);
  * a build runs outside the cache's lock: hits and other keys go on while
    it runs, a second caller of its key waits for that one build, and a
    failed build leaves nothing (the reference's counters, under its lock);
  * `ServeConfig.cache_capacity` warns, in both packages, when it shrinks a
    capacity another engine set;
  * the legacy engine, whose tick goes through `cached_jit`, serves the
    reference `ServingEngine`'s tokens at batch 4 on the dense `.reduced()`
    configs (its solo oracle at batch 1 is
    tests/test_torch_serve.py::test_legacy_engine_equals_reference_solo_oracle),
    and a second engine of the same config builds nothing.

On the CPU a build is the function itself; the CUDA graphs a build is on
the card are held in tests/test_torch_gpu.py.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_config as j_get_config
from repro.core.executor import ExecutableCache as JExecutableCache
from repro.core.executor import executable_cache as j_executable_cache
from repro.models import get_model as j_get_model
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.executor import (ExecutableCache, executable_cache,
                                       params_from_numpy)
from repro_torch.models import get_model
from repro_torch.serve import ServeConfig, ServingEngine

DENSE = ["phi3-medium-14b", "gemma3-1b"]


# ---------------------------------------------------------------------------
# cached_jit
# ---------------------------------------------------------------------------

def _deltas(cached_jit, lowering_count, fn, array, tag):
    """lowering_count() deltas of one call sequence through `cached_jit`."""
    a = cached_jit(fn, key=("cached_jit_test", tag))
    b = cached_jit(fn, key=("cached_jit_test", tag))
    c = cached_jit(fn, key=("cached_jit_test", tag, "other"))
    calls = [(a, (4, 8)), (a, (4, 8)), (b, (4, 8)), (a, (2, 8)), (b, (2, 8)),
             (c, (4, 8)), (c, (2, 8)), (a, (4, 8))]
    out = []
    for f, shape in calls:
        before = lowering_count()
        f(array(shape), array(shape[1:]))
        out.append(lowering_count() - before)
    return out


def test_cached_jit_builds_as_the_reference_lowers():
    tag = "builds_as_the_reference_lowers"
    want = _deltas(repro.cached_jit, repro.lowering_count,
                   lambda x, b: jnp.tanh(x) + b,
                   lambda s: jnp.ones(s, jnp.float32), tag)
    got = _deltas(repro_torch.cached_jit, repro_torch.lowering_count,
                  lambda x, b: torch.tanh(x) + b,
                  lambda s: torch.ones(s), tag)
    assert got == want == [1, 0, 0, 1, 0, 1, 1, 0]


def test_cached_jit_runs_the_function_on_the_cpu():
    rng = np.random.default_rng(0)
    x, b = rng.standard_normal((3, 5)), rng.standard_normal(5)
    f = repro_torch.cached_jit(lambda x, b: {"y": torch.tanh(x) + b, "n": x.sum()},
                               key=("cached_jit_value",), inplace_argnums=(1,))
    jf = repro.cached_jit(lambda x, b: {"y": jnp.tanh(x) + b, "n": x.sum()},
                          key=("cached_jit_value",))
    for _ in range(2):
        got = f(torch.from_numpy(x), torch.from_numpy(b))
        want = jf(jnp.asarray(x), jnp.asarray(b))
        for k in ("y", "n"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the bounded cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_bounded_cache_matches_reference(seed):
    """Random sequences of get_or_build and set_capacity on both caches:
    the same hits, misses, evictions, sizes and key order after each."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 5))
    ours, ref = ExecutableCache(capacity=cap), JExecutableCache(capacity=cap)
    for step in range(200):
        if rng.random() < 0.08:
            cap = None if rng.random() < 0.2 else int(rng.integers(1, 6))
            ours.set_capacity(cap)
            ref.set_capacity(cap)
        else:
            k = int(rng.integers(0, 8))
            assert ours.get_or_build(k, lambda: f"v{k}") == ref.get_or_build(k, lambda: f"v{k}")
        assert ours.stats() == ref.stats(), step
        assert ours.keys() == ref.keys(), step
        probe = int(rng.integers(0, 8))
        assert (probe in ours) == (probe in ref)
        assert ours.get(probe) == ref.get(probe)


def test_build_runs_outside_the_cache_lock():
    cache = ExecutableCache()
    cache.get_or_build("hit", lambda: "h")
    started, go = threading.Event(), threading.Event()

    def slow():
        started.set()
        assert go.wait(30)
        return "slow"

    got, again = {}, []
    first = threading.Thread(target=lambda: got.update(a=cache.get_or_build("slow", slow)))
    first.start()
    assert started.wait(30)
    assert cache.get_or_build("hit", lambda: "x") == "h"
    assert cache.get_or_build("other", lambda: "o") == "o"
    second = threading.Thread(target=lambda: got.update(
        b=cache.get_or_build("slow", lambda: again.append(1) or "again")))
    second.start()
    second.join(0.2)
    assert second.is_alive(), "a caller of the building key did not wait"
    go.set()
    first.join(30)
    second.join(30)
    assert got == {"a": "slow", "b": "slow"} and not again
    assert cache.stats() == {"size": 3, "hits": 2, "misses": 3, "evictions": 0,
                             "capacity": None}


def test_failed_build_leaves_nothing():
    def boom():
        raise ValueError("no build")

    ours, ref = ExecutableCache(), JExecutableCache()
    for cache in (ours, ref):
        with pytest.raises(ValueError):
            cache.get_or_build("k", boom)
        assert "k" not in cache
        assert cache.get_or_build("k", lambda: 1) == 1
    assert ours.stats() == ref.stats()
    with pytest.raises(RuntimeError, match="its own build"):
        ours.get_or_build("self", lambda: ours.get_or_build("self", lambda: 2))
    assert "self" not in ours


def test_cache_capacity_shrink_warns():
    """A config whose cache_capacity would shrink the capacity in force
    warns, in both packages, and sets it."""
    cfg = get_config("gemma3-1b").reduced()
    params = get_model(cfg).init(0, "cpu")
    jcfg = j_get_config("gemma3-1b").reduced()
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    for cache, engine, sc_cls, c, p in (
            (executable_cache(), ServingEngine, ServeConfig, cfg, params),
            (j_executable_cache(), JServingEngine, JServeConfig, jcfg, jparams)):
        cur = cache.stats()["capacity"]
        try:
            cache.set_capacity(64)
            with pytest.warns(UserWarning, match="shrink"):
                engine(c, p, sc_cls(max_len=8, batch=1, cache_capacity=8), eos_id=-1)
            assert cache.stats()["capacity"] == 8
        finally:
            cache.set_capacity(cur)


# ---------------------------------------------------------------------------
# the legacy engine through cached_jit
# ---------------------------------------------------------------------------

PROMPTS = {i: [3 + i, 17, 5 + 2 * i, 9][: 2 + i % 3] for i in range(6)}


@pytest.mark.parametrize("arch", DENSE)
def test_legacy_engine_batch4_matches_reference(arch):
    """Six requests through 4 slots of the legacy engine (refills on its
    shared clock included) give the reference engine's tokens; a second
    port engine of the same config builds nothing."""
    jcfg = j_get_config(arch).reduced()
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    def run(cls, sc_cls, c, p):
        eng = cls(c, p, sc_cls(max_len=16, batch=4), eos_id=-1)
        for rid, prompt in PROMPTS.items():
            eng.submit(rid, list(prompt))
        return eng.run_until_done(max_ticks=100)

    got = run(ServingEngine, ServeConfig, cfg, params)
    assert set(got) == set(PROMPTS)
    assert got == run(JServingEngine, JServeConfig, jcfg, jparams)
    before = repro_torch.lowering_count()
    assert run(ServingEngine, ServeConfig, cfg, params) == got
    assert repro_torch.lowering_count() == before
