"""The port's profitability gate, block-size autotuner and cost-model
additions held against the reference's (tests/test_verdicts.py's
contract, on the port):

  * every executable match compiled under the default policy ("auto")
    carries a Verdict of tier "cost" or "measured"; a measured verdict
    lowers exactly where `meas_kernel_us * MEASURE_MARGIN <=
    meas_closure_us`;
  * with the same stubbed measurements on the same graph on A100, outside
    interpret mode, the port's `_decide` gives the reference's decision and
    tier, its estimates within 1e-6 relative;
  * the verdict cache hits on the same site under another graph name,
    misses on a change of dtype or HwSpec, and persists across compiles;
  * a declined site runs the op-by-op closure, equal to bsp and to the
    reference's outputs at f32 2e-4, and changes the executable key;
  * every tile candidate is a launch its wrapper takes, `autotune` caches
    and leaves a grid of one untimed, and a tuned call equals the closure;
  * `calibrate`, `HwSpec.scaled`, `roofline` and `utilization_quadrants`
    equal the reference's.

On the CPU every kernel wrapper runs its plain version (the reference's
interpret mode), so the measured tier times plain torch ops against plain
torch ops here: tests hold the mechanism (each verdict agrees with its own
numbers), never a timing.  tests/test_torch_gpu.py measures on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import A100 as JA100
from repro.core import calibrate as jcalibrate
from repro.core import costmodel as jcost
from repro.core import lower as jlower
from repro.kernels import KernelConfig as JKernelConfig
from repro.kernels import ref as jref

import repro_torch
from repro_torch import apps as tapps
from repro_torch.core import A100, H100, calibrate
from repro_torch.core import costmodel as tcost
from repro_torch.core import lower as lower_mod
from repro_torch.core.executor import _eval_node, params_from_numpy, verdict_cache
from repro_torch.core.lower import (MEASURE_MARGIN, Target, lower_pipelines,
                                    target_for)
from repro_torch.core.trace import trace
from repro_torch.kernels import KernelConfig, autotune, tune_cache
from repro_torch.kernels import fused_mlp as tfused
from repro_torch.kernels.flash_attention import (DECODE_MAX_BLOCK_S,
                                                 decode_tile_candidates,
                                                 page_block_s)
from repro_torch.kernels.flash_attention import tile_candidates as attention_tiles
from repro_torch.kernels.queue_reduce import tile_candidates as reduce_tiles
from repro_torch.models.atoms import paged_decode_atom

from test_torch_executor import (TINY_KW, assert_outputs_close, jax_feeds,
                                 reference_graph, reference_params)

MEMBERS = {"sf0": ["fc1", "act", "fc2"]}
CPU = Target(torch.device("cpu"))
# a card target for the decision logic alone: every test that uses it
# stubs the measurement, so nothing touches a device
CARD = Target(torch.device("cuda", 0))


def _mlp_g(pkg, dtype="float32", name="vg", m=16, d=32, h=64):
    g = pkg.Graph(name)
    g.input("x", (m, d), dtype)
    g.linear("fc1", "x", h)
    g.elementwise("act", ["fc1"], "gelu")
    g.linear("fc2", "act", d)
    g.output("y", "fc2")
    return g


def _lower_auto(g, **kw):
    return lower_pipelines(g, MEMBERS, policy="auto", target=CPU, **kw)


@pytest.fixture
def scratch_verdicts():
    """An empty verdict cache for the test; the process's verdicts come
    back after it, so a stubbed verdict never leaks into another test."""
    vc = verdict_cache()
    saved = dict(vc._store)
    vc.clear()
    yield vc
    vc.clear()
    vc._store.update(saved)


# --------------------------------------------------------------------------
# verdict cache
# --------------------------------------------------------------------------

class TestVerdictCache:
    def test_hit_on_same_site_name_independent(self):
        vc = verdict_cache()
        _lower_auto(_mlp_g(repro_torch, name="vc_a"))
        size0, h0, m0 = len(vc), vc.hits, vc.misses
        plan = _lower_auto(_mlp_g(repro_torch, name="vc_b"))
        assert len(vc) == size0, "repeat site must not grow the cache"
        assert vc.hits == h0 + 1 and vc.misses == m0
        (m,) = plan.pipelines["sf0"].matches
        assert m.verdict is not None and m.verdict.source in ("cost", "measured")

    def test_miss_on_dtype_change(self):
        vc = verdict_cache()
        _lower_auto(_mlp_g(repro_torch, "float32", name="vc_f32"))
        m0 = vc.misses
        _lower_auto(_mlp_g(repro_torch, "bfloat16", name="vc_bf16"))
        assert vc.misses == m0 + 1, "dtype change must be a new verdict"

    def test_miss_on_hw_change(self):
        g = _mlp_g(repro_torch, name="vc_hw")
        vc = verdict_cache()
        lower_pipelines(g, MEMBERS, policy="cost", hw=H100, target=CPU)
        m0, h0 = vc.misses, vc.hits
        lower_pipelines(g, MEMBERS, policy="cost", hw=A100, target=CPU)
        assert vc.misses == m0 + 1, "HwSpec change must be a new verdict"
        lower_pipelines(g, MEMBERS, policy="cost", hw=A100, target=CPU)
        assert vc.hits == h0 + 1

    def test_verdicts_persist_across_compiles(self):
        g, _ = tapps.tiny_instances("cpu")["llama"]
        repro_torch.compile(g, mode="kitsune")
        vc = verdict_cache()
        h0, m0 = vc.hits, vc.misses
        app2 = repro_torch.compile(g, mode="kitsune")
        assert vc.misses == m0, "repeat compile must not re-measure"
        assert vc.hits > h0
        assert all(m.verdict is not None and m.verdict.source in ("cost", "measured")
                   for p in app2.lowering.pipelines.values()
                   for m in p.matches if m.executable)


# --------------------------------------------------------------------------
# the decision logic, port against reference
# --------------------------------------------------------------------------

def _site(pkg, g):
    (km,) = pkg.core.lower.lower_pipelines(g, MEMBERS).pipelines["sf0"].matches
    return km


# (the MLP graph's shape, stubbed (kernel_s, closure_s), kernel estimate scale,
# (decision, tier)):
# the band's three cases on A100 -- the estimate lowers, the estimate
# declines (the kernel's estimate scaled up tenfold in both packages), the
# estimates tie within the band -- with the measured tier on both sides of
# MEASURE_MARGIN, and a site inside the band over the measurement caps
DECIDE_CASES = {
    "estimate_lowers": (dict(m=65536, d=16, h=4096), None, 1.0, ("lowered", "cost")),
    "estimate_declines": (dict(), None, 10.0, ("declined", "cost")),
    "measured_lowers": (dict(), (1e-6, 1.0e-6 * MEASURE_MARGIN * 1.01), 1.0,
                        ("lowered", "measured")),
    "measured_declines": (dict(), (1e-6, 1.0e-6 * MEASURE_MARGIN * 0.99), 1.0,
                          ("declined", "measured")),
    "over_the_caps": (dict(m=4096, d=4096, h=4096), None, 1.0, ("lowered", "cost")),
}


@pytest.mark.parametrize("case", sorted(DECIDE_CASES))
def test_decide_matches_reference(case, monkeypatch):
    shape, measured, kernel_scale, want = DECIDE_CASES[case]
    jg, tg = _mlp_g(repro, **shape), _mlp_g(repro_torch, **shape)
    jkm, tkm = _site(repro, jg), _site(repro_torch, tg)

    def stub(*_):
        if measured is None:
            raise AssertionError("the estimate should have decided")
        return measured

    monkeypatch.setattr(jlower, "_measure_site", stub)
    monkeypatch.setattr(lower_mod, "_measure_site", stub)
    for mod, cost in ((jlower, jcost), (lower_mod, tcost)):
        def scaled(g, members, hw, _f=cost.cost_kernel_site):
            c = _f(g, members, hw)
            c.time *= kernel_scale
            return c
        monkeypatch.setattr(mod, "cost_kernel_site", scaled)
    jv = jlower._decide(jg, jkm, JA100, JKernelConfig(use_pallas=True, interpret=False),
                        "auto")
    tv = lower_mod._decide(tg, tkm, A100, "auto", CARD)
    assert (tv.decision, tv.source) == (jv.decision, jv.source) == want
    assert tv.est_kernel_us == pytest.approx(jv.est_kernel_us, rel=1e-6)
    assert tv.est_closure_us == pytest.approx(jv.est_closure_us, rel=1e-6)
    assert (tv.meas_kernel_us, tv.meas_closure_us) == (jv.meas_kernel_us, jv.meas_closure_us)
    if tv.source == "measured":
        assert tv.lowered == (tv.meas_kernel_us * MEASURE_MARGIN <= tv.meas_closure_us)


def test_unsynthesizable_site_keeps_its_estimate_and_says_why(monkeypatch):
    """Only a site whose operands cannot be made up falls back to the
    estimate, and the verdict names the reason; any other failure of a
    measurement raises."""
    g = _mlp_g(repro_torch, name="unsynth")
    km = _site(repro_torch, g)

    def unsynth(*_):
        raise lower_mod.SiteNotSynthesizable("operand x is tuple-valued")

    monkeypatch.setattr(lower_mod, "_synth_site", unsynth)
    v = lower_mod._decide(g, km, A100, "auto", CPU)
    assert v.source == "cost" and "not measured: operand x is tuple-valued" in v.reason()

    def broken(*_):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(lower_mod, "_synth_site", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        lower_mod._decide(g, km, A100, "auto", CPU)


# --------------------------------------------------------------------------
# declined sites: the closure, numerically the same
# --------------------------------------------------------------------------

class TestDeclinedFallback:
    def test_declined_sites_match_bsp_and_reference(self, monkeypatch, scratch_verdicts):
        """Every site declined (the stub says the kernel loses by six orders
        of magnitude): outputs still equal bsp's and the reference's."""
        monkeypatch.setattr(lower_mod, "_measure_site", lambda *_: (1.0, 1e-6))
        tg, feeds = tapps.tiny_instances("cpu", seed=1)["nerf"]
        jg = reference_graph("nerf")
        jparams = reference_params(jg)
        params = params_from_numpy(jparams, "cpu")
        app = repro_torch.compile(tg, mode="kitsune")
        verdicts = [m.verdict for p in app.lowering.pipelines.values()
                    for m in p.matches if m.executable]
        assert verdicts and all(v is not None and not v.lowered for v in verdicts)
        assert all(app.lowering.matches_for(p) == [] for p in app.lowering.pipelines)
        got = app.run(feeds, params).outputs
        bsp = repro_torch.compile(tg, mode="bsp").run(feeds, params).outputs
        want = repro.compile(jg, repro.CompilerOptions(
            mode="kitsune", lowering_policy="always")).run(jax_feeds(feeds), jparams).outputs
        assert_outputs_close(bsp, got, "declined vs bsp", tol=2e-4)
        assert_outputs_close(want, got, "declined vs reference", tol=2e-4)
        text = app.describe()
        assert "[declined: measured kernel" in text
        assert any("declined" in why for p in app.lowering.pipelines.values()
                   for why in p.fallbacks.values())

    def test_declined_changes_executable_cache_identity(self, monkeypatch,
                                                        scratch_verdicts):
        """Accepted and declined lowerings never share programs: the plan
        signature carries each match's accepted flag, so the executable key
        of the same graph under the same options differs."""
        g = _mlp_g(repro_torch, name="sig_g")
        plan_forced = lower_pipelines(g, MEMBERS, target=CPU)  # policy=always
        monkeypatch.setattr(lower_mod, "_measure_site", lambda *_: (1.0, 1e-6))
        plan_declined = _lower_auto(g)
        assert plan_forced.signature() != plan_declined.signature()
        assert plan_forced.lowered_ops() == {"fc1", "act", "fc2"}
        assert plan_declined.lowered_ops() == set()
        declined = repro_torch.compile(g, mode="kitsune")
        scratch_verdicts.clear()
        monkeypatch.setattr(lower_mod, "_measure_site", lambda *_: (1e-6, 1.0))
        accepted = repro_torch.compile(g, mode="kitsune")
        assert declined.options.cache_key() == accepted.options.cache_key()
        assert declined._backend.key() != accepted._backend.key()
        assert accepted.lowering.lowered_ops() and not declined.lowering.lowered_ops()


# --------------------------------------------------------------------------
# the tiny apps under the default policy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dlrm", "llama", "graphcast"])
def test_tiny_apps_verdicts_follow_their_numbers(name):
    """Raw CPU timings jitter, so the mechanism is held: every measured
    verdict agrees with its own microbenchmark, and the app under "auto"
    gives the reference's outputs."""
    tg, feeds = tapps.tiny_instances("cpu", seed=1)[name]
    app = repro_torch.compile(tg, mode="kitsune")
    assert app.options.lowering_policy == "auto"
    rows = [r for r in app.lowering_verdicts() if r["executable"]]
    assert rows, f"{name}: no executable matches"
    for r in rows:
        assert r["source"] in ("cost", "measured")
        if r["source"] == "measured":
            want = ("lowered" if r["meas_kernel_us"] * MEASURE_MARGIN <= r["meas_closure_us"]
                    else "declined")
            assert r["decision"] == want, r
    jg = reference_graph(name)
    jparams = reference_params(jg)
    want = repro.compile(jg, repro.CompilerOptions(
        mode="kitsune", lowering_policy="always")).run(jax_feeds(feeds), jparams).outputs
    got = app.run(feeds, params_from_numpy(jparams, "cpu")).outputs
    assert_outputs_close(want, got, f"{name} under auto")


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------

class TestPolicies:
    def test_direct_lower_defaults_to_force_lower(self):
        plan = lower_pipelines(_mlp_g(repro_torch), MEMBERS, target=CPU)
        (m,) = plan.pipelines["sf0"].matches
        assert m.verdict is None and m.accepted and m.tile is None
        (row,) = [r for r in plan.verdict_table() if r["executable"]]
        assert row["decision"] == "lowered" and row["source"] == "forced"
        assert row["meas_kernel_us"] is None and row["meas_closure_us"] is None

    def test_cost_policy_pure_estimate(self):
        plan = lower_pipelines(_mlp_g(repro_torch, name="cp"), MEMBERS, policy="cost",
                               target=CPU)
        (m,) = plan.pipelines["sf0"].matches
        v = m.verdict
        assert v is not None and v.source == "cost"
        assert v.meas_kernel_us is None and v.meas_closure_us is None
        assert v.est_kernel_us > 0 and v.est_closure_us > 0
        # one fused kernel never costs more than the summed closure
        # roofline over the same members
        assert v.est_kernel_us <= v.est_closure_us and v.lowered

    def test_unknown_policy_rejected(self):
        with pytest.raises(ValueError):
            lower_pipelines(_mlp_g(repro_torch), MEMBERS, policy="sometimes")

    def test_compiler_options_policy_validated_and_keyed(self):
        with pytest.raises(ValueError):
            repro_torch.CompilerOptions(lowering_policy="never")
        auto = repro_torch.CompilerOptions(mode="kitsune")
        always = repro_torch.CompilerOptions(mode="kitsune", lowering_policy="always")
        assert auto.lowering_policy == "auto"
        assert auto.cache_key() != always.cache_key()

    def test_always_policy_through_compiler(self):
        g = _mlp_g(repro_torch, name="fp")
        app = repro_torch.compile(g, repro_torch.CompilerOptions(
            mode="kitsune", lowering_policy="always"))
        matches = [m for p in app.lowering.pipelines.values() for m in p.matches]
        assert matches and all(m.verdict is None for m in matches)
        assert app.lowering.lowered_ops() == {"fc1", "act", "fc2"}

    def test_cpu_target_never_tunes(self):
        """On the CPU the wrappers run their plain versions: no tile is
        searched under any policy, unless a KernelConfig asks."""
        assert target_for("cpu").interpret
        for policy in ("always", "cost", "auto"):
            assert not lower_mod._kernel_cfg(CPU, policy).autotune
        assert lower_mod._kernel_cfg(CARD, "auto").autotune
        assert not lower_mod._kernel_cfg(CARD, "always").autotune


# --------------------------------------------------------------------------
# block autotuning
# --------------------------------------------------------------------------

MLP_SHAPES = [(1, 8), (16, 48), (64, 128), (65, 200), (200, 600), (4096, 14336),
              (8192, 1152)]


class TestAutotune:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("gated", [False, True])
    def test_every_candidate_is_a_legal_launch(self, dtype, gated):
        """Each grid holds the default first, only values its launch takes
        (the source's tile multiples, within shared memory), and nothing
        else: the card test launches every one of them."""
        for m, h in MLP_SHAPES:
            h128, m64 = -(-h // 128) * 128, -(-m // 64) * 64
            fwd = tfused.tile_candidates(m, h, dtype, gated=gated)
            bwd = tfused.tile_candidates(m, h, dtype, gated=gated, backward=True)
            if dtype == "bfloat16":
                assert fwd == [{}] and bwd == [{}]
                continue
            if m <= tfused.SMALL_M:
                assert fwd == [{}]
            else:
                assert fwd[0] == {"f32_block_h": min(tfused.F32_BLOCK_H, h128)}
                for c in fwd:
                    bh = c["f32_block_h"]
                    assert bh % 128 == 0 and 0 < bh <= min(h128, tfused.F32_BLOCK_H)
                    assert tfused.f32_fwd_smem(bh, gated) <= 232448
            assert bwd[0] == {"f32_bwd_block_h": min(tfused.F32_BWD_BLOCK_H, h128),
                              "f32_bwd_block_m": tfused.F32_BWD_BLOCK_M}
            for c in bwd:
                bh, bm = c["f32_bwd_block_h"], c["f32_bwd_block_m"]
                assert bh % 128 == 0 and 0 < bh <= h128
                assert bm % 64 == 0 and (bm <= m64 or bm == tfused.F32_BWD_BLOCK_M)
                assert tfused.f32_bwd_smem(64, bh, gated, dw=False) <= 232448
                assert tfused.f32_bwd_smem(bm, 64, gated, dw=True) <= 232448
            assert len({tuple(sorted(c.items())) for c in bwd}) == len(bwd)

    def test_f32_grids_follow_the_sources_shared_memory(self):
        """The gated f32 dX chunk stays at 128 (256 overflows 227 KB), the
        ungated one reaches 256; the dW row slice 128 gated, 256 ungated."""
        gated = tfused.tile_candidates(4096, 4096, "float32", gated=True, backward=True)
        plain = tfused.tile_candidates(4096, 4096, "float32", gated=False, backward=True)
        assert {c["f32_bwd_block_h"] for c in gated} == {128}
        assert {c["f32_bwd_block_m"] for c in gated} == {64, 128}
        assert {c["f32_bwd_block_h"] for c in plain} == {128, 256}
        assert {c["f32_bwd_block_m"] for c in plain} == {64, 128, 192, 256}

    def test_decode_and_fixed_grids(self):
        for s_len in (4, 64, 100, 448, 512, 4096):
            cands = decode_tile_candidates(s_len)
            assert cands[0] == {"block_s": min(DECODE_MAX_BLOCK_S, s_len)}
            for c in cands:
                assert 0 < c["block_s"] <= min(DECODE_MAX_BLOCK_S, s_len)
        for s_len, bs in ((512, 16), (48, 16), (32, 8), (4096, 16), (64, 64)):
            cands = decode_tile_candidates(s_len, page_size=bs)
            assert cands[0] == {"block_s": page_block_s(s_len, bs, None)}
            for c in cands:
                b = c["block_s"]
                assert b % bs == 0 and s_len % b == 0 and b <= DECODE_MAX_BLOCK_S
                # page_block_s keeps a candidate as it is
                assert page_block_s(s_len, bs, b) == b
        assert attention_tiles(2048, 2048) == [{}] and reduce_tiles(1024) == [{}]

    def test_autotune_caches_and_a_grid_of_one_is_not_timed(self):
        built = []

        def build(cand):
            built.append(cand)
            return lambda x: x * cand.get("k", 1)

        args = (torch.ones(8),)
        assert autotune(("t", "empty"), [], build, args) == {}
        tc = tune_cache()
        one = autotune(("t", "one", id(built)), [{"k": 2}], build, args)
        assert one == {"k": 2} and built == []
        h0 = tc.hits
        assert autotune(("t", "one", id(built)), [{"k": 2}], build, args) == {"k": 2}
        assert tc.hits == h0 + 1
        two = autotune(("t", "two", id(built)), [{"k": 2}, {"k": 3}], build, args)
        assert built == [{"k": 2}, {"k": 3}] and two["us"] > 0
        assert two["k"] in (2, 3)
        again = autotune(("t", "two", id(built)), [{"k": 2}, {"k": 3}], build, ())
        assert again == two and len(built) == 2, "a cached key reads no args"

    def test_tuned_call_equals_the_closure(self):
        """An f32 site above SMALL_M rows has two hidden chunks to try: the
        choice lands in the match's meta, a second lowering reuses it, and
        the tuned call equals the op-by-op closure."""
        g = _mlp_g(repro_torch, name="at", m=200, d=32, h=200)
        cfg = KernelConfig(autotune=True)
        tc = tune_cache()
        plan = lower_pipelines(g, MEMBERS, cfg=cfg, target=CPU)
        (m,) = plan.pipelines["sf0"].matches
        assert m.meta["f32_block_h"] in (128, 256) and m.tile["us"] > 0
        h0 = tc.hits
        plan2 = lower_pipelines(g, MEMBERS, cfg=cfg, target=CPU)
        assert tc.hits > h0, "second lowering must reuse the tuned choice"
        (m2,) = plan2.pipelines["sf0"].matches
        assert m2.meta["f32_block_h"] == m.meta["f32_block_h"]
        vals, params = lower_mod._synth_site(g, m, "cpu")
        y = m.call(vals, params)
        v = dict(vals)
        for op in m.ops:
            n = g.nodes[op]
            v[op] = _eval_node(n, [v[i] for i in n.inputs], params.get(op))
        torch.testing.assert_close(y, v[m.out], rtol=2e-4, atol=2e-4)

    def test_paged_atom_autotune_winner_lands_in_meta(self):
        """The counterpart of the reference's
        test_paged_attention::test_autotune_winner_lands_in_meta: the traced
        paged_decode_atom lowered with autotune on is executable, keeps the
        hint's block_size, gains a block_s from its grid, and equals the
        reference's `ref.paged_decode_ref` (its traced path fails under the
        installed jax, so it is not the oracle)."""
        rng = np.random.default_rng(7)
        bs, v_blocks = 8, 4
        q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
        kp, vp = (rng.standard_normal((9 * bs, 2, 16)).astype(np.float32) for _ in range(2))
        tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
        valid = np.array([20, 31], np.int32)
        args = tuple(torch.from_numpy(a) for a in (q, kp, vp, tables, valid))
        atom = paged_decode_atom(bs)
        traced = trace(lambda *a: atom(*a), *args)
        g = traced.graph
        hinted = [n for n in g.nodes.values()
                  if n.attrs.get("lower_hint", (None,))[0] == "paged_decode"]
        assert len(hinted) == 1
        plan = lower_pipelines(g, {"p0": [hinted[0].name]}, policy="always",
                               cfg=KernelConfig(autotune=True), target=CPU)
        (km,) = [m for p in plan.pipelines.values() for m in p.matches]
        assert km.kernel == "paged_flash_decode" and km.executable
        assert km.meta["block_size"] == bs
        assert km.meta["block_s"] in {c["block_s"] for c in
                                      decode_tile_candidates(v_blocks * bs, page_size=bs)}
        got = km.call(dict(zip(hinted[0].inputs, args)), {})
        want = jref.paged_decode_ref(*(jnp.asarray(a) for a in (q, kp, vp, tables)),
                                     valid_len=jnp.asarray(valid), block_size=bs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# cost model
# --------------------------------------------------------------------------

SAMPLES = [(1e9, 1e6, 3), (5e9, 2e7, 10), (2e10, 1e8, 50), (1e8, 1e9, 7)]


class TestCostModel:
    @pytest.mark.parametrize("hw", [H100, A100], ids=lambda h: h.name)
    def test_calibrate_recovers_planted_constants(self, hw):
        true_eff, true_launch = 0.5, 5e-6
        samples = [(f, b, n, max(f / hw.matrix_flops, b / hw.dram_bw) / true_eff
                    + true_launch * n) for f, b, n in SAMPLES]
        fit = calibrate(hw, samples)
        assert fit.eff == pytest.approx(true_eff, rel=1e-3)
        assert fit.launch_s == pytest.approx(true_launch, rel=1e-3)
        assert "calibrated" in fit.name

    def test_calibrate_equals_the_reference_fit(self):
        rng = np.random.default_rng(5)
        samples = [(f, b, n, float(s)) for (f, b, n), s in
                   zip(SAMPLES, rng.uniform(1e-4, 1e-2, len(SAMPLES)))]
        mine, ref = calibrate(A100, samples), jcalibrate(JA100, samples)
        assert (mine.name, mine.eff, mine.launch_s) == (ref.name, ref.eff, ref.launch_s)

    def test_degenerate_fit_clamped(self):
        hw = calibrate(H100, [(1e9, 1e6, 1, 0.0), (2e9, 2e6, 2, 0.0)])
        assert 0.0 < hw.eff <= 1.0 and hw.launch_s >= 0.0
        assert calibrate(H100, []) is H100

    def test_scaled_equals_the_reference(self):
        for kw in ({"compute": 2.0}, {"onchip": 2.0}, {"compute": 2.0, "onchip": 2.0,
                                                       "dram": 0.5}):
            mine, ref = A100.scaled(**kw), JA100.scaled(**kw)
            assert (mine.name, mine.matrix_flops, mine.vector_flops, mine.dram_bw,
                    mine.onchip_bw, mine.onchip_capacity, mine.n_units) == \
                (ref.name, ref.matrix_flops, ref.vector_flops, ref.dram_bw,
                 ref.onchip_bw, ref.onchip_capacity, ref.n_units)

    @pytest.mark.parametrize("name", sorted(TINY_KW))
    def test_roofline_and_quadrants_equal_the_reference(self, name):
        tg = tapps.tiny_instances("cpu")[name][0]
        jg = reference_graph(name)
        opts = dict(mode="kitsune", lowering_policy="always")
        tapp = repro_torch.compile(tg, repro_torch.CompilerOptions(hw=A100, **opts))
        japp = repro.compile(jg, repro.CompilerOptions(hw=JA100, **opts))
        for mode in ("bsp", "kitsune"):
            mine = tcost.utilization_quadrants(tapp.pipelined, A100, mode)
            ref = jcost.utilization_quadrants(japp.pipelined, JA100, mode)
            assert mine.keys() == ref.keys()
            for k in ref:
                assert mine[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-15), (mode, k)
        for hw in (A100, A100.scaled(compute=2.0)):
            jhw = JA100.scaled(compute=2.0) if hw is not A100 else JA100
            assert tcost.utilization_quadrants(tapp.pipelined, hw, "kitsune") == \
                pytest.approx(jcost.utilization_quadrants(japp.pipelined, jhw, "kitsune"))
        flops = sum(n.flops for n in tg.nodes.values())
        nbytes = sum(tcost.op_bytes_bsp(tg, n) for n in tg.nodes.values() if not n.is_free)
        mine = tcost.roofline(flops, nbytes, 1e6, links=jcost.ICI_LINKS_PER_CHIP,
                              peak_flops=jcost.PEAK_FLOPS_PER_CHIP,
                              hbm_bw=jcost.HBM_BW_PER_CHIP, link_bw=jcost.ICI_BW_PER_LINK)
        ref = jcost.roofline(flops, nbytes, 1e6)
        assert (mine.compute_s, mine.memory_s, mine.collective_s) == \
            (ref.compute_s, ref.memory_s, ref.collective_s)
        assert (mine.dominant, mine.bound_s) == (ref.dominant, ref.bound_s)
        card = tcost.roofline(flops, nbytes, 0.0)
        assert card.compute_s == flops / 989e12 and card.memory_s == nbytes / 3.35e12
        assert math.isclose(card.bound_s, max(card.compute_s, card.memory_s))
