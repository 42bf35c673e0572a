"""The reference's fault scenarios (tests/test_faults.py) on the port's
serving engine, each held against the reference engine on the CPU.

Every scenario runs twice, once per package, on one set of reduced
gemma3-1b weights (drawn by the reference, carried across with
`params_from_numpy`), and the two runs must agree:

  * the injector: the same plan and seed fire at the same probes and leave
    the same history;
  * the engines: the same done and failed sets, the same (error type, site,
    tick, rid) for every failure, the same health, and the same tokens for
    every finished request -- which, where the reference's test holds a
    survivor to the fault-free run, must also equal the port's own
    fault-free run bit for bit;
  * the async engine and the request handles: the same terminal errors.

The chaos property draws at most 6 schedules, as the reference does.  The
card-side scenarios (the captured tick) are in tests/test_torch_gpu.py.
"""
import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serve as J
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model

import repro_torch.serve as P
from repro_torch.configs import get_config
from repro_torch.core.executor import params_from_numpy

MAX_LEN = 24
PROMPTS = {i: [3 + i, 17, 5] for i in range(4)}
SIDES = {"port": P, "ref": J}

# lazily built, shared by the fixtures and the hypothesis property (the
# conftest stand-in for hypothesis cannot take fixtures)
_CACHE: dict = {}


def _models(side: str):
    """(cfg, params) of `side`: one set of weights, drawn by the reference."""
    if "models" not in _CACHE:
        jcfg = j_get_config("gemma3-1b").reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _CACHE["models"] = {"ref": (jcfg, jparams),
                            "port": (get_config("gemma3-1b").reduced(), params)}
    return _CACHE["models"][side]


def _paged(side: str, **kw):
    clock = kw.pop("clock", None)
    cfg, params = _models(side)
    kw.setdefault("num_blocks", 16)
    sc = SIDES[side].ServeConfig(max_len=MAX_LEN, batch=2, **kw)
    ekw = {"clock": clock} if clock is not None else {}
    return SIDES[side].PagedServingEngine(cfg, params, sc, eos_id=-1, **ekw)


def _clean() -> dict:
    """The port's fault-free run of the config every scenario uses."""
    if "clean" not in _CACHE:
        eng = _paged("port")
        for rid, p in PROMPTS.items():
            eng.submit(p, rid=rid)
        _CACHE["clean"] = eng.run_until_done()
    return _CACHE["clean"]


@pytest.fixture(scope="module")
def clean():
    return _clean()


def _plan(side: str, *specs) -> tuple:
    """FaultSpecs of `side`'s class from (site, kwargs) pairs."""
    return tuple(SIDES[side].FaultSpec(site, **kw) for site, kw in specs)


def _failures(eng) -> dict:
    return {rid: (type(e).__name__, e.site, e.tick, e.rid) for rid, e in eng.failed.items()}


def _health(eng) -> tuple:
    h = eng.health()
    err = h["last_error"]
    return (h["state"], h["consecutive_failures"], h["ticks_since_progress"], h["ticks"],
            h["failed"], None if err is None else (type(err).__name__, err.site, err.tick,
                                                   err.rid))


def _run_faulted(side: str, *specs, **kw):
    eng = _paged(side, fault_plan=_plan(side, *specs), **kw)
    handles = {rid: eng.submit(p, rid=rid) for rid, p in PROMPTS.items()}
    return eng, handles, eng.run_until_done()


def _both(scenario) -> dict:
    """{side: scenario(side)} for both packages."""
    return {side: scenario(side) for side in SIDES}


def _assert_same(runs: dict, clean: dict | None = None, survivors=None) -> None:
    """Both engines ended alike: done (tokens included), failures, health,
    faults fired, pool drained; the survivors named (all of done by
    default) equal the port's fault-free run."""
    (eng, _, done), (jeng, _, jdone) = runs["port"], runs["ref"]
    assert done == jdone
    assert _failures(eng) == _failures(jeng)
    assert _health(eng) == _health(jeng)
    assert set(done) | set(eng.failed) == set(PROMPTS)
    assert not set(done) & set(eng.failed)
    if eng.injector is not None:
        assert eng.injector.history == jeng.injector.history
    assert eng.pool.check() == jeng.pool.check()
    assert eng.pool.check()["active"] == 0
    if clean is not None:
        for rid in (done if survivors is None else survivors):
            assert done[rid] == clean[rid], f"survivor {rid} diverged"


def test_clean_run_equals_reference(clean):
    jeng = _paged("ref")
    for rid, p in PROMPTS.items():
        jeng.submit(p, rid=rid)
    assert jeng.run_until_done() == clean


# ---------------------------------------------------------------------------
# injector mechanics (no engine)
# ---------------------------------------------------------------------------

class TestInjector:
    def test_unknown_site_rejected(self):
        for side in SIDES.values():
            with pytest.raises(ValueError, match="unknown fault site"):
                side.FaultSpec("pool.allok")
            with pytest.raises(ValueError, match="mode"):
                side.FaultSpec("tick.logits", mode="zero")
        assert P.SITES == J.SITES

    def test_unconditional_fires_every_probe(self):
        def run(side):
            inj = SIDES[side].FaultInjector(_plan(side, ("tick.step", {})))
            fires = [bool(inj.check("tick.step")) for _ in range(5)]
            return fires, inj.check("pool.alloc") is None, inj.fired("tick.step"), inj.history

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        assert runs["port"][:3] == ([True] * 5, True, 5)

    def test_tick_and_hit_schedules(self):
        def run(side):
            inj = SIDES[side].FaultInjector(_plan(side, ("tick.step", {"ticks": (2,)}),
                                                  ("pool.alloc", {"hits": (1, 3)})))
            fired_at = []
            for t in range(4):
                inj.advance(t)
                if inj.check("tick.step"):
                    fired_at.append(t)
            allocs = [bool(inj.check("pool.alloc")) for _ in range(5)]
            return fired_at, allocs, inj.history

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        fired_at, allocs, history = runs["port"]
        assert fired_at == [2] and allocs == [False, True, False, True, False]
        assert [h["site"] for h in history] == ["tick.step", "pool.alloc", "pool.alloc"]

    @pytest.mark.parametrize("seed", [7, 8])
    def test_probabilistic_schedule_is_seed_deterministic(self, seed):
        def run(side, s=seed):
            inj = SIDES[side].FaultInjector(_plan(side, ("tick.step", {"p": 0.3})), seed=s)
            return [bool(inj.check("tick.step")) for _ in range(64)], inj.history

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        fires = runs["port"][0]
        assert any(fires) and not all(fires)
        assert fires != _both(lambda side: run(side, seed + 100))["port"][0]

    def test_parse_fault_plan(self):
        text = "tick.step@4,tick.logits@6&9:rid=3:mode=inf,pool.alloc@*:p=0.5"
        plans = {side: SIDES[side].parse_fault_plan(text) for side in SIDES}
        assert [vars(s) for s in plans["port"]] == [vars(s) for s in plans["ref"]]
        assert plans["port"] == _plan("port", ("tick.step", {"ticks": (4,)}),
                                      ("tick.logits", {"ticks": (6, 9), "rid": 3,
                                                       "mode": "inf"}),
                                      ("pool.alloc", {"p": 0.5}))
        assert P.parse_fault_plan("tick.step@*")[0].unconditional
        for bad, match in (("tick.step", "site@ticks"),
                           ("tick.step@1:boom=2", "unknown fault option")):
            for side in SIDES.values():
                with pytest.raises(ValueError, match=match):
                    side.parse_fault_plan(bad)


# ---------------------------------------------------------------------------
# per-site isolation: one culprit fails, survivors stay bitwise clean
# ---------------------------------------------------------------------------

class TestSiteIsolation:
    def test_tick_step_fails_only_blamed_request(self, clean):
        runs = _both(lambda side: _run_faulted(side, ("tick.step", {"ticks": (3,), "rid": 1})))
        _assert_same(runs, clean)
        eng, handles, _ = runs["port"]
        assert _failures(eng) == {1: ("EngineError", "tick.step", 3, 1)}
        with pytest.raises(P.EngineError):
            handles[1].result(timeout=0)
        assert eng.health()["state"] == "healthy" and eng.injector.fired("tick.step") == 1

    def test_nan_guard_catches_poisoned_logits(self, clean):
        runs = _both(lambda side: _run_faulted(
            side, ("tick.logits", {"ticks": (6,), "rid": 0}), nan_guard=True))
        _assert_same(runs, clean)
        eng, handles, _ = runs["port"]
        assert set(eng.failed) == {0} and eng.failed[0].site == "tick.logits"
        assert handles[0].error() is eng.failed[0]

    def test_guard_off_poison_never_leaks_to_cotenants(self, clean):
        """The poisoned request streams a derailed token in both packages
        alike; every other request equals the clean run."""
        runs = _both(lambda side: _run_faulted(
            side, ("tick.logits", {"ticks": (6,), "rid": 0}), nan_guard=False))
        _assert_same(runs, clean, survivors=(1, 2, 3))
        assert runs["port"][0].failed == {}

    def test_pool_alloc_fault_recovers_by_preemption(self, clean):
        runs = _both(lambda side: _run_faulted(side, ("pool.alloc", {"hits": (3,)})))
        _assert_same(runs, clean)
        eng, _, done = runs["port"]
        assert eng.failed == {} and done == clean
        preempts = [r[0].stats()["scheduler"]["preemptions"] for r in runs.values()]
        assert preempts[0] == preempts[1] >= 1

    def test_prefill_chunk_transient_retries_clean(self, clean):
        runs = _both(lambda side: _run_faulted(side, ("prefill.chunk", {"ticks": (0,)})))
        _assert_same(runs, clean)
        assert runs["port"][2] == clean and runs["port"][0].injector.fired("prefill.chunk") == 1

    def test_prefill_chunk_persistent_fails_victim(self, clean):
        runs = _both(lambda side: _run_faulted(side, ("prefill.chunk", {})))
        _assert_same(runs, clean)
        eng, _, done = runs["port"]
        assert set(done) == {0} and set(eng.failed) == {1, 2, 3}
        assert all(e.site == "prefill.chunk" for e in eng.failed.values())


# ---------------------------------------------------------------------------
# degraded mode
# ---------------------------------------------------------------------------

class TestDegradedMode:
    def test_consecutive_failures_degrade_and_fail_everything(self):
        runs = _both(lambda side: _run_faulted(side, ("tick.step", {})))
        _assert_same(runs)
        for eng, handles, done in runs.values():
            assert done == {} and eng.health()["state"] == "degraded"
            assert eng.health()["consecutive_failures"] >= eng.sc.max_tick_retries
            assert all(h.done() and h.error() is not None for h in handles.values())
            assert eng.pending() == 0 and eng.tick() == 0

    def test_degraded_engine_rejects_new_work(self):
        def run(side):
            eng, _, _ = _run_faulted(side, ("tick.step", {}))
            hd = eng.submit([5, 6, 7], rid=99)
            with pytest.raises(SIDES[side].EngineError, match="degraded"):
                hd.result(timeout=0)
            err = hd.error()
            return hd.done(), type(err).__name__, err.site, err.tick, err.rid

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        assert runs["port"][:3] == (True, "EngineError", "engine.degraded")

    def test_degraded_tick_sweeps_late_racers(self):
        """A request that lands in the queue after the degraded transition
        is failed by the next tick in both packages."""
        def run(side):
            eng, _, _ = _run_faulted(side, ("tick.step", {}))
            hd = SIDES[side].RequestHandle(99, [5, 6, 7])
            eng.handles[99] = hd
            eng.scheduler.waiting.append(SIDES[side].Request(rid=99, prompt=[5, 6, 7],
                                                             handle=hd))
            pending = eng.pending()
            left = eng.tick()
            assert eng.failed[99] is hd.error()
            with pytest.raises(SIDES[side].EngineError, match="degraded"):
                hd.result(timeout=0)
            return pending, left, eng.pending(), hd.done(), _failures(eng)[99]

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        assert runs["port"][:4] == (1, 0, 0, True)
        assert runs["port"][4][1] == "engine.degraded"

    def test_blame_isolation_beats_degradation(self, clean):
        runs = _both(lambda side: _run_faulted(
            side, ("tick.step", {"ticks": (3,), "rid": 1}),
            ("tick.step", {"ticks": (8,), "rid": 2}),
            ("tick.step", {"ticks": (13,), "rid": 3})))
        _assert_same(runs, clean)
        eng = runs["port"][0]
        assert eng.health()["state"] == "healthy" and set(eng.failed) == {1, 2, 3}


# ---------------------------------------------------------------------------
# deadlines (a fake clock) and backpressure
# ---------------------------------------------------------------------------

class TestDeadlines:
    def test_queued_request_expires_before_prefill(self, clean):
        def run(side):
            now = [0.0]
            eng = _paged(side, clock=lambda: now[0])
            handles = {rid: eng.submit(PROMPTS[rid], rid=rid) for rid in (0, 1)}
            handles[2] = eng.submit(PROMPTS[2], rid=2, deadline_s=5.0)
            now[0] = 10.0
            done = eng.run_until_done()
            assert "queue" in str(eng.failed[2])
            assert eng.stats()["scheduler"]["expired"] == 1
            return eng, handles, done

        runs = _both(run)
        eng, handles, done = runs["port"]
        assert done == {0: clean[0], 1: clean[1]} == runs["ref"][2]
        assert _failures(eng) == _failures(runs["ref"][0]) == \
            {2: ("DeadlineExceeded", "engine.deadline", 0, 2)}
        with pytest.raises(P.DeadlineExceeded):
            handles[2].result(timeout=0)
        assert _health(eng) == _health(runs["ref"][0])

    def test_in_flight_request_evicted_at_deadline(self, clean):
        def run(side):
            now = [0.0]
            eng = _paged(side, clock=lambda: now[0])
            h0 = eng.submit(PROMPTS[0], rid=0, deadline_s=5.0)
            eng.submit(PROMPTS[1], rid=1)
            for _ in range(5):
                eng.tick()
            partial = h0.tokens()
            now[0] = 6.0
            done = eng.run_until_done()
            assert "in flight" in str(eng.failed[0])
            return eng, partial, done

        runs = _both(run)
        (eng, partial, done), (jeng, jpartial, jdone) = runs["port"], runs["ref"]
        assert partial == jpartial and len(partial) > 0
        assert done == jdone == {1: clean[1]}
        assert _failures(eng) == _failures(jeng)
        assert list(_failures(eng).values())[0][:2] == ("DeadlineExceeded", "engine.deadline")
        assert eng.pool.check()["active"] == 0

    def test_config_default_deadline_applies(self):
        def run(side):
            now = [0.0]
            eng = _paged(side, clock=lambda: now[0], default_deadline_s=5.0)
            eng.submit(PROMPTS[0], rid=0)
            now[0] = 10.0
            return eng.run_until_done(), _failures(eng)

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        assert runs["port"][1][0][0] == "DeadlineExceeded"


class TestBackpressure:
    def test_bounded_queue_raises_queue_full(self, clean):
        def run(side):
            eng = _paged(side, max_queue=2)
            eng.submit(PROMPTS[0], rid=0)
            eng.submit(PROMPTS[1], rid=1)
            with pytest.raises(SIDES[side].QueueFull) as ei:
                eng.submit(PROMPTS[2], rid=2)
            assert 2 not in eng.handles
            eng.tick()
            free = eng.scheduler.queue_free
            eng.submit(PROMPTS[2], rid=2)
            return ei.value.site, free, eng.run_until_done()

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        site, free, done = runs["port"]
        assert site == "engine.queue" and free == 2
        assert done == {rid: clean[rid] for rid in (0, 1, 2)}

    def test_preemption_requeue_exempt_from_bound(self):
        def run(side):
            eng = _paged(side, num_blocks=5, max_queue=1)
            eng.submit(PROMPTS[0], rid=0)
            eng.tick()
            eng.submit(PROMPTS[1], rid=1)
            eng.tick()
            eng.submit(PROMPTS[2], rid=2)
            done = eng.run_until_done()
            return (done, eng.stats()["scheduler"]["preemptions"], eng.pending(),
                    eng.pool.check())

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        done, preempts, pending, pool = runs["port"]
        assert set(done) == {0, 1, 2} and preempts >= 1 and pending == 0
        assert pool["active"] == 0


# ---------------------------------------------------------------------------
# async engine: terminal errors, result ordering, blocking submit
# ---------------------------------------------------------------------------

class TestAsyncFaults:
    @pytest.mark.timeout(120)
    def test_culprit_handle_raises_survivors_stream(self, clean):
        def run(side):
            plan = _plan(side, ("tick.step", {"ticks": (3,), "rid": 1}))
            with SIDES[side].AsyncServingEngine(engine=_paged(side, fault_plan=plan)) as eng:
                handles = {rid: eng.submit(p, rid=rid) for rid, p in PROMPTS.items()}
                with pytest.raises(SIDES[side].EngineError) as ei:
                    handles[1].result(timeout=120)
                outs = {rid: handles[rid].result(timeout=120) for rid in (0, 2, 3)}
            return (ei.value.site, ei.value.rid), outs, eng.engine.state

        runs = _both(run)
        assert runs["port"] == runs["ref"]
        blame, outs, state = runs["port"]
        assert blame == ("tick.step", 1) and state == "stopped"
        assert outs == {rid: clean[rid] for rid in (0, 2, 3)}

    @pytest.mark.timeout(60)
    def test_drain_raises_terminal_error_not_timeout(self):
        def run(side):
            inner = _paged(side)
            inner.tick = lambda: (_ for _ in ()).throw(ZeroDivisionError("bug"))
            inner._enter_degraded = lambda err: None     # keep work pending
            eng = SIDES[side].AsyncServingEngine(engine=inner)
            eng.submit(PROMPTS[0], rid=0)
            with pytest.raises(ZeroDivisionError):
                eng.drain(timeout=30)
            h = eng.health()
            eng.close()
            return type(h["loop_error"]).__name__, h.get("loop_alive")

        runs = _both(run)
        assert runs["port"] == runs["ref"] == ("ZeroDivisionError", False)

    @pytest.mark.timeout(60)
    def test_loop_death_degrades_engine_and_fails_handles(self):
        def run(side):
            inner = _paged(side)
            inner.tick = lambda: (_ for _ in ()).throw(RuntimeError("dead"))
            eng = SIDES[side].AsyncServingEngine(engine=inner)
            h = eng.submit(PROMPTS[0], rid=0)
            with pytest.raises(SIDES[side].EngineError, match="degraded"):
                h.result(timeout=30)
            eng.close()
            return inner.state, h.error().site

        runs = _both(run)
        assert runs["port"] == runs["ref"] == ("degraded", "engine.degraded")

    def test_result_prefers_stored_error_over_timeout(self):
        for side in SIDES.values():
            h = side.RequestHandle(7, [1, 2])
            h._fail(side.EngineError("boom", site="tick.step", tick=4, rid=7))
            with pytest.raises(side.EngineError, match="boom"):
                h.result(timeout=0)

    def test_result_timeout_names_rid_and_progress(self):
        for side in SIDES.values():
            h = side.RequestHandle(7, [1, 2])
            h._append(11)
            h._append(12)
            with pytest.raises(TimeoutError, match=r"request 7 .*2 tokens"):
                h.result(timeout=0.01)

    @pytest.mark.timeout(120)
    def test_blocking_submit_rides_out_backpressure(self, clean):
        def run(side):
            with SIDES[side].AsyncServingEngine(engine=_paged(side, max_queue=1)) as eng:
                handles = {rid: eng.submit(p, rid=rid, queue_timeout=60)
                           for rid, p in PROMPTS.items()}
                return {rid: h.result(timeout=120) for rid, h in handles.items()}

        runs = _both(run)
        assert runs["port"] == runs["ref"] == clean

    @pytest.mark.timeout(60)
    def test_submit_queue_full_immediate_and_timed(self):
        for side in SIDES:
            eng = SIDES[side].AsyncServingEngine(engine=_paged(side, max_queue=0))
            with pytest.raises(SIDES[side].QueueFull):
                eng.submit(PROMPTS[0], rid=0)
            with pytest.raises(SIDES[side].QueueFull):
                eng.submit(PROMPTS[0], rid=0, queue_timeout=0.3)
            eng.close()


# ---------------------------------------------------------------------------
# chaos property: random multi-site schedules
# ---------------------------------------------------------------------------

class TestChaosProperty:
    @pytest.mark.timeout(600)
    @settings(deadline=None, max_examples=6)
    @given(step_tick=st.integers(min_value=0, max_value=10),
           logits_tick=st.integers(min_value=0, max_value=10),
           alloc_hit=st.integers(min_value=0, max_value=20),
           chunk_p=st.floats(min_value=0.0, max_value=0.3),
           seed=st.integers(min_value=0, max_value=1 << 16))
    def test_engine_survives_random_schedules(self, step_tick, logits_tick, alloc_hit,
                                              chunk_p, seed):
        """Whatever the schedule, both packages end alike: the run
        terminates, every handle is terminal, done and failed partition the
        requests, the pool conserves its blocks, survivors are bitwise."""
        clean = _clean()

        def run(side):
            eng = _paged(side, fault_plan=_plan(
                side, ("tick.step", {"ticks": (step_tick,)}),
                ("tick.logits", {"ticks": (logits_tick,)}),
                ("pool.alloc", {"hits": (alloc_hit,)}),
                ("prefill.chunk", {"p": chunk_p})), fault_seed=seed, nan_guard=True)
            handles = {rid: eng.submit(p, rid=rid) for rid, p in PROMPTS.items()}
            done = eng.run_until_done(max_ticks=500)
            assert eng.pending() == 0
            assert all(h.done() for h in handles.values())
            assert all(isinstance(e, SIDES[side].EngineError) and e.site is not None
                       for e in eng.failed.values())
            return eng, handles, done

        runs = _both(run)
        _assert_same(runs, clean)
        assert runs["port"][0].health()["state"] in ("healthy", "degraded")
