"""Serving the model families beyond dense, held against the reference
package on the CPU: hymba-1.5b (attention + per-slot SSM state), xlstm-350m
(recurrent state only, no KV pages), pixtral-12b (the vlm backbone) and the
two MoE configs, `.reduced()` (float32), with the reference's weights
carried across by `params_from_numpy`.

  * the paged engine's token streams equal the reference engine's for slot
    refill, chunked prefill and preemption-by-recompute; MoE at batch 1,
    where no routing entry can drop, and at batch 2 against the reference
    with its drop defect corrected (tests/test_torch_families.py);
  * within the port: each request served alone equals its tokens in the
    batch with refill (recurrent state is per slot), the native tick equals
    the gather tick, a refilled slot's recurrent state starts from its
    initial value, prefix caching is off with recurrent state, and the
    xlstm engine keeps no pages;
  * the legacy engine serves every family, whisper included, as the
    reference's does.

The card-side checks (captured tick against eager, recurrent state kept
across a capture) are in tests/test_torch_gpu.py.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.serve import PagedServingEngine as JPagedEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.core.executor import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import PagedServingEngine, ServeConfig, ServingEngine

from test_torch_families import _dispatch_dropping_nowhere

RECURRENT = ["hymba-1.5b", "xlstm-350m"]
PAGED = ["hymba-1.5b", "xlstm-350m", "pixtral-12b"]
MOE = ["grok-1-314b", "llama4-maverick-400b-a17b"]
MAX_LEN = 24
PROMPTS = {i: [3 + i, 17, 5, 9, 2, 8][:3 + i % 4] for i in range(5)}
# name -> ServeConfig overrides (batch 2 unless set)
SCENARIOS = {"refill": {}, "chunked_prefill": {"prefill_chunk": 3},
             "preemption": {"num_blocks": 5}}

_MEMO: dict = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def models(arch):
    def build():
        jcfg = j_get_config(arch).reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        return jcfg, jparams, get_config(arch).reduced(), params
    return memo(("models", arch), build)


def serve(engine_cls, sc_cls, cfg, params, prompts, **kw):
    kw.setdefault("num_blocks", 16)
    kw.setdefault("batch", 2)
    eng = engine_cls(cfg, params, sc_cls(max_len=MAX_LEN, **kw), eos_id=-1)
    for rid, p in prompts.items():
        eng.submit(list(p), rid=rid)
    return eng.run_until_done(), eng


def port_run(arch, scenario, **kw):
    _, _, cfg, params = models(arch)
    return memo(("port", arch, scenario, tuple(sorted(kw.items()))),
                lambda: serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS,
                              **{**SCENARIOS[scenario], **kw}))


def reference_run(arch, scenario, **kw):
    jcfg, jparams, _, _ = models(arch)
    return memo(("ref", arch, scenario, tuple(sorted(kw.items()))),
                lambda: serve(JPagedEngine, JServeConfig, jcfg, jparams, PROMPTS,
                              **{**SCENARIOS[scenario], **kw})[0])


@pytest.mark.parametrize("arch,scenario", [
    (arch, scenario) for arch in PAGED for scenario in sorted(SCENARIOS)
    if not (arch == "xlstm-350m" and scenario == "preemption")])   # no pages to run out of
def test_paged_engine_matches_reference(arch, scenario):
    done, eng = port_run(arch, scenario)
    assert done == reference_run(arch, scenario)
    st = eng.stats()
    assert st["peak_active"] == 2
    if scenario == "preemption":
        assert st["scheduler"]["preemptions"] >= 1
    if eng.has_kv:
        assert st["pool"]["active"] == 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_at_batch_1_matches_reference(arch):
    """One slot: each routing entry has a capacity slot of its own (top-1,
    or top-2 over two distinct experts), so nothing drops."""
    done, _ = port_run(arch, "chunked_prefill", batch=1)
    assert done == reference_run(arch, "chunked_prefill", batch=1)


@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_matches_corrected_reference(arch, monkeypatch):
    """Two slots route in one group at capacity 1 per expert, so entries
    drop; the reference with dropped entries sent nowhere serves the
    port's tokens."""
    monkeypatch.setattr(j_layers, "_dispatch_group", _dispatch_dropping_nowhere)
    jcfg, jparams, _, _ = models(arch)
    want, _ = serve(JPagedEngine, JServeConfig, jcfg, jparams, PROMPTS)
    assert port_run(arch, "refill")[0] == want


@pytest.mark.parametrize("arch", PAGED)
def test_solo_equals_batched_with_refill(arch):
    """Each request served alone through a one-slot engine equals its
    tokens in the two-slot run, where later requests refill slots whose
    recurrent state an earlier request advanced."""
    _, _, cfg, params = models(arch)
    batched, _ = port_run(arch, "refill")
    for rid, p in PROMPTS.items():
        solo, _ = serve(PagedServingEngine, ServeConfig, cfg, params, {rid: p}, batch=1)
        assert solo[rid] == batched[rid]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "pixtral-12b", "llama4-maverick-400b-a17b"])
def test_native_equals_gather(arch):
    native, _ = port_run(arch, "chunked_prefill")
    gather, _ = port_run(arch, "chunked_prefill", paged_attention="gather")
    assert native == gather


@pytest.mark.parametrize("arch", RECURRENT)
def test_refilled_slot_state_starts_fresh(arch):
    """An admission writes the slot's initial state into the tick's own
    buffers (same tensors, in place) and leaves the other slot's alone."""
    _, _, cfg, params = models(arch)
    eng = PagedServingEngine(cfg, params, ServeConfig(max_len=MAX_LEN, batch=2, num_blocks=16),
                             eos_id=-1)
    buffers = {k: v.data_ptr() for k, v in eng.aux.items()}
    for t in eng.aux.values():
        t.fill_(7.0)
    eng.submit([3, 4, 5], rid=0)
    eng._admit()
    for name, t in eng.aux.items():
        assert t.data_ptr() == buffers[name]
        init = eng.aux_init[name]
        ax = 1 if name == "ssm" else 2
        assert torch.equal(t.select(ax, 0), init.select(ax, 0))
        assert bool((t.select(ax, 1) == 7.0).all())


def test_prefix_caching_off_with_recurrent_state():
    runs = {arch: port_run(arch, "refill")[1] for arch in ("hymba-1.5b", "pixtral-12b")}
    assert runs["hymba-1.5b"].sc.prefix_caching and not runs["hymba-1.5b"].prefix_enabled
    assert "prefix_cache" not in runs["hymba-1.5b"].stats()
    assert runs["pixtral-12b"].prefix_enabled


def test_xlstm_engine_keeps_no_pages():
    _, eng = port_run("xlstm-350m", "refill")
    assert not eng.has_kv and eng.pool is None and eng.kp is None and eng.tables is None
    st = eng.stats()
    assert "pool" not in st and "kv_traffic" not in st and st["ticks"] > 0
    assert sorted(eng.aux) == ["mC", "mm", "mn", "sc", "sm", "sn"]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m", "grok-1-314b", "whisper-small"])
def test_legacy_engine_serves_every_family(arch):
    """One request through a one-slot legacy engine in both packages
    (whisper with the zero cross cache `init_cache` gives)."""
    jcfg, jparams, cfg, params = models(arch)
    got, want = {}, {}
    for cls, sc_cls, c, pp, out in ((ServingEngine, ServeConfig, cfg, params, got),
                                    (JServingEngine, JServeConfig, jcfg, jparams, want)):
        eng = cls(c, pp, sc_cls(max_len=12, batch=1), eos_id=-1)
        eng.submit(0, PROMPTS[3])
        out.update(eng.run_until_done())
    assert got == want and len(got[0]) == 12 - len(PROMPTS[3]) - 1


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_launcher_serves_recurrent_families(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests",
                              "3", "--batch", "2", "--max-len", "12"])
    assert sorted(done) == [0, 1, 2] and all(len(v) == 8 for v in done.values())
    assert "served 3/3 requests" in capsys.readouterr().out
