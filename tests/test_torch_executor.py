"""The port's executor held against the reference's: all three modes of
`repro_torch.compile` against the same mode of `repro.compile` on the tiny
challenge apps, with the same feeds (numpy, from a seed) and the same
weights (the reference's `init_params` at unit scale, each linear weight
divided by sqrt(fan-in), carried over by `params_from_numpy`).  At the
default scale of 0.02 the apps without norms between their MLP layers
(dlrm, mgn, nerf) shrink their outputs to 1e-5..1e-3, under the tolerance;
fan-in weights keep every output's RMS above 0.08, and each comparison
asserts its reference's RMS is at least 10x the atol.  The reference's kitsune mode runs its Pallas kernels
in interpret mode (lowering_policy="always"); the port's runs its kernels'
plain versions on the CPU.  Tolerance rtol/atol 2e-3, as in
tests/test_lowering.py:32.  tests/test_torch_gpu.py runs the same path on
the card.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro
from benchmarks import apps as japps

import repro_torch
from repro_torch import apps as tapps
from repro_torch.core.executor import (GraphExecutor, executable_cache,
                                       lowering_count, params_from_numpy)

MODES = ("bsp", "vertical", "kitsune")
TINY_KW = {
    "dlrm": ("dlrm", dict(batch=16, emb_rows=64)),
    "mgn": ("meshgraphnets", dict(batch=16, steps=1)),
    "nerf": ("nerf", dict(rays=4, samples=4)),
    "graphcast": ("graphcast", dict(nodes=16, hidden=16, steps=1)),
    "llama": ("llama3_8b", dict(seq=4, batch=2, n_layers=1, d=16, ff=32,
                                hq=2, hkv=2, hd=8, vocab=32)),
}


def reference_graph(name):
    fn, kw = TINY_KW[name]
    return getattr(japps, fn)(**kw)


def jax_feeds(feeds: dict) -> dict:
    out = {}
    for k, t in feeds.items():
        a = t.numpy()
        out[k] = jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a)
    return out


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().cpu().numpy()
    return np.asarray(a, np.float32)


def reference_params(jg, seed: int = 0) -> dict:
    """The reference's weights with O(1) activations: unit-scale draws,
    each linear weight divided by sqrt(fan-in)."""
    params = repro.init_params(jg, jax.random.PRNGKey(seed), scale=1.0)
    return {n: {k: a / np.float32(np.sqrt(a.shape[0])) if k == "w" else a
                for k, a in leaves.items()} for n, leaves in params.items()}


def port_params(graph, seed: int = 0) -> dict:
    """The port's counterpart of `reference_params` (its own draws)."""
    params = repro_torch.init_params(graph, seed, device="cpu", scale=1.0)
    for leaves in params.values():
        if "w" in leaves:
            leaves["w"] /= leaves["w"].shape[0] ** 0.5
    return params


def assert_outputs_close(want: dict, got: dict, label: str, tol=2e-3):
    assert want.keys() == got.keys(), label
    for k in want:
        w = f32(want[k])
        rms = float(np.sqrt(np.mean(np.square(w))))
        assert rms >= 10 * tol, f"{label}: {k} has RMS {rms:.3g}, too small " \
                                f"for atol {tol} to tell outputs apart"
        np.testing.assert_allclose(f32(got[k]), w, rtol=tol, atol=tol,
                                   err_msg=f"{label}: {k}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(TINY_KW))
def test_mode_matches_reference_mode(name, mode):
    tg, feeds = tapps.tiny_instances("cpu", seed=1)[name]
    jg = reference_graph(name)
    jparams = reference_params(jg)
    want = repro.compile(jg, repro.CompilerOptions(
        mode=mode, lowering_policy="always")).run(jax_feeds(feeds),
                                                  jparams).outputs
    app = repro_torch.compile(tg, mode=mode)
    got = app.run(feeds, params_from_numpy(jparams, "cpu")).outputs
    assert_outputs_close(want, got, f"{name}/{mode}")
    if mode == "kitsune":
        assert app.lowering.n_matches() >= 1


@pytest.mark.parametrize("name", sorted(TINY_KW))
def test_second_run_builds_nothing(name):
    tg, feeds = tapps.tiny_instances("cpu", seed=2)[name]
    for mode in MODES:
        app = repro_torch.compile(tg, mode=mode)
        params = app.init_params(seed=0, device="cpu")
        first = app.run(feeds, params)
        before = lowering_count()
        rep = app.run(feeds, params)
        assert lowering_count() == before, f"{name}/{mode} rebuilt"
        assert rep.cache_misses == 0 and rep.cache_hits == rep.n_programs
        for k in first.outputs:
            torch.testing.assert_close(rep.outputs[k], first.outputs[k])
        # a fresh compile of the same graph reuses the same built programs
        again = repro_torch.compile(tg, mode=mode).run(feeds, params)
        assert lowering_count() == before and again.cache_misses == 0


def test_split_reduction_runs_queue_reduce_path():
    def graph(pkg):
        g = pkg.Graph("red")
        g.input("x", (64, 32, 16), "float32")
        g.elementwise("sq", ["x", "x"], "mul")
        g.reduce("batch_sum", "sq", axis=0)
        g.output("y", "batch_sum")
        return g

    x = np.random.default_rng(3).standard_normal((64, 32, 16)).astype(np.float32)
    want = repro.compile(graph(repro), mode="kitsune",
                         lowering_policy="always").run(
        {"x": jnp.asarray(x)}, {}).outputs
    app = repro_torch.compile(graph(repro_torch), mode="kitsune")
    assert "queue_reduce" in app.lowering.kernels_used()
    got = app.run({"x": torch.from_numpy(x)}, {}).outputs
    assert_outputs_close(want, got, "split reduction")


def test_kitsune_moves_fewer_boundary_bytes():
    tg, feeds = tapps.tiny_instances("cpu")["nerf"]
    params = repro_torch.init_params(tg, 0, device="cpu")
    b = repro_torch.compile(tg, mode="bsp").run(feeds, params)
    k = repro_torch.compile(tg, mode="kitsune").run(feeds, params)
    assert k.n_programs < b.n_programs
    assert 0 < k.bytes_accessed < b.bytes_accessed


def test_graph_executor_matches_compile():
    tg, feeds = tapps.tiny_instances("cpu")["graphcast"]
    params = port_params(tg)
    for mode in MODES:
        got = GraphExecutor(tg, mode).run(feeds, params).outputs
        want = repro_torch.compile(tg, mode="bsp").run(feeds, params).outputs
        assert_outputs_close(want, got, f"GraphExecutor/{mode}")


def test_params_from_numpy_bf16_round_trip():
    jg = reference_graph("nerf")
    jparams = repro.init_params(jg, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    tparams = params_from_numpy(jparams, "cpu")
    for name, leaves in jparams.items():
        for k, a in leaves.items():
            t = tparams[name][k]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(a).view(ml_dtypes.bfloat16).view(np.int16))
    # f32 -> an explicit target dtype
    t32 = params_from_numpy(repro.init_params(jg, jax.random.PRNGKey(4)),
                            "cpu", dtype=torch.bfloat16)
    assert t32["fc0"]["w"].dtype == torch.bfloat16


def test_init_params_is_seeded_and_shaped_like_reference():
    tg, _ = tapps.tiny_instances("cpu")["dlrm"]
    a = repro_torch.init_params(tg, 7, device="cpu")
    b = repro_torch.init_params(tg, 7, device="cpu")
    c = repro_torch.init_params(tg, 8, device="cpu")
    ref = repro.init_params(reference_graph("dlrm"), jax.random.PRNGKey(0))
    assert a.keys() == ref.keys()
    for name in a:
        for k in a[name]:
            assert tuple(a[name][k].shape) == ref[name][k].shape
            torch.testing.assert_close(a[name][k], b[name][k])
    assert not torch.equal(a["bot_fc0"]["w"], c["bot_fc0"]["w"])


def test_program_cache_counts_builds():
    tg, feeds = tapps.tiny_instances("cpu", seed=5)["mgn"]
    params = repro_torch.init_params(tg, 0, device="cpu")
    size = len(executable_cache())
    before = lowering_count()
    rep = repro_torch.compile(tg, mode="vertical").run(feeds, params)
    assert rep.n_programs == 1
    assert lowering_count() - before == len(executable_cache()) - size
