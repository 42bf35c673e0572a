"""The port's serving path held against the reference package on the CPU:
phi3-medium-14b and gemma3-1b `.reduced()` (float32), with the reference's
weights carried across by `params_from_numpy`.

  * `decode_step` logits against the reference's `lm.decode_step` at 2e-4,
    dense-cache and paged-native forms (phi3's sites run the decode kernels'
    plain versions; gemma3's reduced layers are all windowed and run the
    grouped torch path, as the reference's gate does);
  * the paged engine's token streams equal the reference engine's for slot
    refill, preemption, chunked prefill, prefix-cache hits and view buckets;
    within the port, the native tick equals the gather tick bit for bit,
    the async engine equals the sync one, the legacy engine equals the
    reference's solo oracle, and a `tick.step` fault is blamed on its
    request as in the reference;
  * the BlockPool / Scheduler / PrefixCache copies answer the same operation
    sequences as the reference's.

The card-side engine check (kernels against the CPU) is in
tests/test_torch_gpu.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import lm as j_lm
from repro.serve import BlockPool as JBlockPool
from repro.serve import FaultSpec as JFaultSpec
from repro.serve import PagedServingEngine as JPagedEngine
from repro.serve import PrefixCache as JPrefixCache
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.executor import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, lm
from repro_torch.serve import (AsyncServingEngine, BlockPool, EngineError,
                               FaultSpec, PagedKVExecutor,
                               PagedServingEngine, PrefixCache, Request,
                               Scheduler, ServeConfig, ServingEngine)

ARCH_NAMES = ["phi3-medium-14b", "gemma3-1b"]
MAX_LEN = 24
PROMPTS = {i: [3 + i, 17, 5] for i in range(4)}
SHARED = [11, 7, 3, 9, 2, 6, 4, 8]            # one whole block (block_size 8)
PREFIX_PROMPTS = {0: SHARED + [5, 1], 1: SHARED + [5, 1], 2: SHARED + [13]}
# name -> (prompts, ServeConfig overrides, what the run must have exercised)
SCENARIOS = {
    "refill": (PROMPTS, {}, lambda st: st["peak_active"] == 2),
    "preemption": (PROMPTS, {"num_blocks": 5},
                   lambda st: st["scheduler"]["preemptions"] >= 1),
    "chunked_prefill": (PREFIX_PROMPTS, {"prefill_chunk": 3, "prefix_caching": False},
                        lambda st: st["ticks"] >= 4),
    "prefix_hits": (PREFIX_PROMPTS, {}, lambda st: st["prefix_cache"]["hits"] >= 1),
    "view_buckets": (PROMPTS, {"view_buckets": True}, lambda st: st["peak_active"] == 2),
}

_MEMO: dict = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def models(arch):
    """(reference cfg, reference params, port cfg, port params): one set of
    weights, drawn by the reference and carried across."""
    def build():
        jcfg = j_get_config(arch).reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        return jcfg, jparams, get_config(arch).reduced(), params
    return memo(("models", arch), build)


def serve(engine_cls, sc_cls, cfg, params, prompts, **kw):
    kw.setdefault("num_blocks", 16)
    eng = engine_cls(cfg, params, sc_cls(max_len=MAX_LEN, batch=2, **kw), eos_id=-1)
    for rid, p in prompts.items():
        eng.submit(list(p), rid=rid)
    return eng.run_until_done(), eng


def reference_run(arch, scenario):
    jcfg, jparams, _, _ = models(arch)
    prompts, kw, _ = SCENARIOS[scenario]
    return memo(("ref", arch, scenario),
                lambda: serve(JPagedEngine, JServeConfig, jcfg, jparams, prompts, **kw)[0])


# ---------------------------------------------------------------------------
# decode_step logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("form", ["dense_scalar", "dense_slots", "paged"])
def test_decode_step_logits_match_reference(arch, form):
    jcfg, jparams, cfg, params = models(arch)
    jm, m = j_get_model(jcfg), get_model(cfg)
    b, bs, steps = 3, 8, 6
    rng = np.random.default_rng(0)
    if form == "paged":
        pages = 12
        g, a, h, d = jcfg.n_layers, 1, jcfg.n_kv_heads, jcfg.head_dim
        jcache = {"kp": jax.numpy.zeros((pages * bs, g, a, h, d)),
                  "vp": jax.numpy.zeros((pages * bs, g, a, h, d))}
        cache = {"kp": torch.zeros(pages * bs, g, a, h, d),
                 "vp": torch.zeros(pages * bs, g, a, h, d)}
        tables = rng.permutation(np.arange(1, pages))[:b * 3].reshape(b, 3).astype(np.int32)
    else:
        jcache, cache = jm.init_cache(b, MAX_LEN), m.init_cache(b, MAX_LEN, device="cpu")
    start = np.array([0, 3, 5])
    for step in range(steps):
        tok = rng.integers(0, jcfg.vocab, b).astype(np.int32)
        pos = start + step
        kw, tkw = {}, {}
        if form == "dense_scalar":
            jpos, tpos = step, step
        else:
            jpos, tpos = jax.numpy.asarray(pos, jax.numpy.int32), torch.from_numpy(pos)
        if form == "paged":
            rows = tables[np.arange(b), pos // bs] * bs + pos % bs
            kw = dict(block_tables=jax.numpy.asarray(tables), block_size=bs,
                      kv_write_rows=jax.numpy.asarray(rows, jax.numpy.int32))
            tkw = dict(block_tables=torch.from_numpy(tables), block_size=bs,
                       kv_write_rows=torch.from_numpy(rows))
        want, jcache = jm.decode_step(jparams, jax.numpy.asarray(tok), jpos, jcache, **kw)
        got, cache = m.decode_step(params, torch.from_numpy(tok).long(), tpos, cache, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_layer_schedule_matches_reference():
    for name in sorted(ARCHS):
        sched = lm.layer_schedule(get_config(name))
        jsched = j_lm.layer_schedule(j_get_config(name))
        assert sched["window"] == np.asarray(jsched["window"]).tolist()
        np.testing.assert_array_equal(np.asarray(sched["theta"], np.float32),
                                      np.asarray(jsched["theta"]))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_engine_matches_reference(arch, scenario):
    _, _, cfg, params = models(arch)
    prompts, kw, exercised = SCENARIOS[scenario]
    done, eng = serve(PagedServingEngine, ServeConfig, cfg, params, prompts, **kw)
    assert done == reference_run(arch, scenario)
    assert exercised(eng.stats())
    assert eng.stats()["pool"]["active"] == 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_native_equals_gather_bitwise(arch, scenario):
    _, _, cfg, params = models(arch)
    prompts, kw, _ = SCENARIOS[scenario]
    native, eng = serve(PagedServingEngine, ServeConfig, cfg, params, prompts,
                        paged_attention="native", **kw)
    gather, _ = serve(PagedServingEngine, ServeConfig, cfg, params, prompts,
                      paged_attention="gather", **kw)
    assert native == gather
    tr = eng.stats()["kv_traffic"]
    assert tr["mode"] == "native" and tr["native_bytes_per_tick"] < tr["gather_bytes_per_tick"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_async_engine_matches_sync(arch):
    _, _, cfg, params = models(arch)
    sc = ServeConfig(max_len=MAX_LEN, batch=2, num_blocks=16)
    with AsyncServingEngine(cfg, params, sc, eos_id=-1) as eng:
        handles = [eng.submit(p, rid=rid) for rid, p in PROMPTS.items()]
        outs = {h.rid: h.result(timeout=120) for h in handles}
    assert outs == reference_run(arch, "refill")
    assert eng.engine.state == "stopped"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_legacy_engine_equals_reference_solo_oracle(arch):
    """Each request served alone through the legacy engine, in both
    packages; the paged engine's refilled slots equal it too."""
    jcfg, jparams, cfg, params = models(arch)
    got, want = {}, {}
    for rid, p in PROMPTS.items():
        for cls, sc_cls, c, pp, out in ((ServingEngine, ServeConfig, cfg, params, got),
                                        (JServingEngine, JServeConfig, jcfg, jparams, want)):
            eng = cls(c, pp, sc_cls(max_len=MAX_LEN, batch=1), eos_id=-1)
            eng.submit(rid, p)
            out.update(eng.run_until_done())
    assert got == want
    assert reference_run(arch, "refill") == got


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tick_step_fault_blamed_as_in_reference(arch):
    jcfg, jparams, cfg, params = models(arch)
    runs = {}
    for name, cls, sc_cls, spec, c, pp in (
            ("port", PagedServingEngine, ServeConfig, FaultSpec, cfg, params),
            ("ref", JPagedEngine, JServeConfig, JFaultSpec, jcfg, jparams)):
        plan = (spec("tick.step", ticks=(3,), rid=1),)
        runs[name] = serve(cls, sc_cls, c, pp, PROMPTS, fault_plan=plan)
    (done, eng), (jdone, jeng) = runs["port"], runs["ref"]
    assert done == jdone and set(eng.failed) == set(jeng.failed) == {1}
    err, jerr = eng.failed[1], jeng.failed[1]
    assert isinstance(err, EngineError)
    assert (err.site, err.tick, err.rid) == (jerr.site, jerr.tick, jerr.rid) == ("tick.step", 3, 1)
    with pytest.raises(EngineError):
        eng.handles[1].result(timeout=0)
    assert eng.health()["state"] == "healthy" and eng.injector.fired("tick.step") == 1
    assert eng.pool.check()["active"] == 0


def test_profile_fault_falls_back_to_floor_capacity():
    _, _, cfg, params = models("phi3-medium-14b")
    sc = ServeConfig(max_len=MAX_LEN, batch=2, fault_plan=(FaultSpec("executor.profile"),))
    eng = PagedServingEngine(cfg, params, sc, eos_id=-1)
    assert eng.pool.num_blocks == eng.max_blocks + sc.batch
    assert "executor.profile" in eng.stats()["profile_error"]


def test_executor_budget_on_cpu():
    """Off the card: the default budget, no activation term."""
    _, _, cfg, params = models("phi3-medium-14b")
    sc = ServeConfig(max_len=MAX_LEN, batch=2)
    ex = PagedKVExecutor(cfg, params, sc)
    assert ex.profile_run() == 0
    assert ex.page_shape == (cfg.n_layers, 1, cfg.n_kv_heads, cfg.head_dim)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in jax.tree.leaves(params, is_leaf=torch.is_tensor))
    n, swap = ex.get_max_allowed_kv_blocks()
    assert swap == 0 and n == (ex.DEFAULT_BUDGET - param_bytes) // ex.block_bytes


def test_unported_parts_refuse():
    """Every family is ported now: the ones this test once saw refused
    build, forward and decode; what the port still refuses is the
    encoder-decoder in the paged engine (a ValueError, as in the
    reference).  A tick through the compiler's executors
    (`compile_mode`) is ported: tests/test_torch_trace.py holds it."""
    for name in ("grok-1-314b", "xlstm-350m", "hymba-1.5b", "pixtral-12b"):
        cfg = get_config(name).reduced()
        m = get_model(cfg)
        params = m.init(seed=0, device="cpu")
        toks = torch.tensor([[3, 4, 5]])
        with torch.no_grad():
            assert m.forward(params, {"tokens": toks}).shape == (1, 3, cfg.vocab)
            logits, _ = m.decode_step(params, toks[:, 0], 0, m.init_cache(1, 8, device="cpu"))
        assert logits.shape == (1, cfg.vocab)
    whisper = get_config("whisper-small").reduced()
    cache = get_model(whisper).init_cache(1, 8, enc_len=4, device="cpu")
    assert sorted(cache) == ["k", "v", "xk", "xv"]
    with pytest.raises(ValueError, match="decoder-only"):
        PagedServingEngine(whisper, {}, ServeConfig(max_len=8, batch=1))


def test_configs_equal_reference():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_ARCHS[name])
        assert cfg.param_count() == J_ARCHS[name].param_count()


def test_launcher_serves_on_cpu(capsys):
    done = launch_serve.main(["--arch", "phi3-medium-14b", "--reduced", "--device",
                              "cpu", "--requests", "3", "--batch", "2",
                              "--max-len", "12"])
    assert sorted(done) == [0, 1, 2] and all(len(v) == 8 for v in done.values())
    assert "served 3/3 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# pure-Python copies: same operation sequences, same answers
# ---------------------------------------------------------------------------

def _outcome(fn):
    """("ok", result), or the name and message of the OutOfBlocks raised
    (each copy raises its own class)."""
    try:
        return ("ok", fn())
    except RuntimeError as exc:
        assert type(exc).__name__ == "OutOfBlocks"
        return ("OutOfBlocks", str(exc))


@pytest.mark.parametrize("seed", range(3))
def test_block_pool_and_prefix_cache_copies(seed):
    """Random alloc / decref / prefix insert / match sequences over an
    8-block pool (so eviction and exhaustion happen) on both copies."""
    rng = np.random.default_rng(seed)
    pools, caches = [], []
    for pool_cls, cache_cls in ((BlockPool, PrefixCache), (JBlockPool, JPrefixCache)):
        cache = [None]
        pool = pool_cls(8, 4, on_evict=lambda key, bid, c=cache: c[0].on_evict(key, bid))
        cache[0] = cache_cls(pool)
        pools.append(pool)
        caches.append(cache[0])
    held: list[list[int]] = []                 # reference-side requests' blocks
    prompts = [list(rng.integers(0, 5, 9)) for _ in range(4)]
    for _ in range(80):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(1, 4))
            res = [_outcome(lambda p=p: [p.alloc() for _ in range(n)]) for p in pools]
            assert res[0] == res[1]
            if res[0][0] == "ok":
                held.append(res[0][1])
        elif op == 1 and held:
            bids = held.pop(int(rng.integers(0, len(held))))
            for p in pools:
                for bid in bids:
                    p.decref(bid)
        elif op == 2 and held:
            prompt = prompts[int(rng.integers(0, len(prompts)))]
            bids = held[int(rng.integers(0, len(held)))]
            assert caches[0].insert(prompt, bids) == caches[1].insert(prompt, bids)
        else:
            prompt = prompts[int(rng.integers(0, len(prompts)))]
            got, want = caches[0].match(prompt), caches[1].match(prompt)
            assert got == want
            if got[0]:
                held.append(list(got[0]))
        assert pools[0].check() == pools[1].check()
        assert caches[0].stats() == caches[1].stats()


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_copy(seed):
    """Submissions, admissions against a pool, token plans, victims,
    requeues and deadline expiry answered identically."""
    rng = np.random.default_rng(seed)
    pools = [BlockPool(12, 4), JBlockPool(12, 4)]
    scheds = [Scheduler(block_size=4, prefill_chunk=3, token_budget=None, n_slots=3,
                        max_queue=6),
              JScheduler(block_size=4, prefill_chunk=3, token_budget=None, n_slots=3,
                         max_queue=6)]
    req_cls = (Request, JRequest)
    slots = [[None] * 3, [None] * 3]
    for t in range(40):
        n = int(rng.integers(1, 20))
        deadline = float(t + rng.integers(1, 6)) if rng.random() < 0.3 else None
        ok = [s.submit(rc(rid=t, prompt=list(range(n)), deadline=deadline))
              for s, rc in zip(scheds, req_cls)]
        assert ok[0] == ok[1]
        dead = [[r.rid for r in s.expire(float(t))] for s in scheds]
        assert dead[0] == dead[1]
        for side in (0, 1):
            for i in range(3):
                if slots[side][i] is None:
                    req = scheds[side].next_admission(pools[side])
                    if req is not None:
                        slots[side][i] = {"admit_seq": scheds[side].admit_seq,
                                          "seq": req.feed, "fed": 0, "req": req}
        plans = [s.plan(sl) for s, sl in zip(scheds, slots)]
        assert plans[0] == plans[1]
        for side in (0, 1):
            for i, k in enumerate(plans[side]):
                if slots[side][i] is not None:
                    slots[side][i]["fed"] += k
        if rng.random() < 0.3:
            victims = [s.pick_victim(sl) for s, sl in zip(scheds, slots)]
            assert victims[0] == victims[1]
            if victims[0] is not None:
                for side in (0, 1):
                    scheds[side].requeue(slots[side][victims[0]]["req"])
                    slots[side][victims[0]] = None
        for side in (0, 1):
            for i, s in enumerate(slots[side]):
                if s is not None and s["fed"] >= len(s["seq"]) + 2:
                    slots[side][i] = None
        assert scheds[0].stats() == scheds[1].stats()
        assert [r.rid for r in scheds[0].waiting] == [r.rid for r in scheds[1].waiting]
