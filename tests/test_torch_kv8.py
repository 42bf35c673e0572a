"""The float8_e4m3fn KV cache and the models' `kernels=` argument, held
against the reference package on the CPU (reduced configs in float32, the
reference's weights carried across by `params_from_numpy`):

  * `to_e4m3` is the reference's cast byte for byte, NaN past +-464 and
    for +-inf (torch's own cast saturates to +-448 there);
  * `init_cache` builds the reference's float8 shapes at half the bytes of
    a bfloat16 cache; whisper keeps its activation dtype;
  * six `decode_step`s and `prefill` with a float8 cache against the
    reference's: the cache bytes (at most 0.1 % of the written elements a
    single e4m3 step apart, where the f32 key or value lies on a rounding
    boundary) and the logits within 2e-4;
  * the decode kernels' plain versions on e4m3 K/V against the reference's
    `_grouped_decode` on the same cache (P stays in q's dtype: a case that
    P rounded to e4m3 would fail);
  * the engines with a float8 cache: the paged engine against the
    reference's, refill == solo and native == gather bitwise, half the KV
    traffic and about twice the pages of a bfloat16 cache, the legacy,
    async and traced (kitsune) engines against the paged one, and a
    bfloat16 and a float8 engine of one config side by side;
  * `kernels=`: `KernelConfig()` passed is bitwise the call without it, and
    a non-default `block_s` reaches every decode site.

Tolerances are the reference tests' (tests/test_kernels.py:25): float32
2e-4, bfloat16 2e-2.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.serve import PagedServingEngine as JPagedEngine
from repro.serve import ServeConfig as JServeConfig

from repro_torch.configs import get_config
from repro_torch.core.executor import params_from_numpy
from repro_torch.kernels import KernelConfig
from repro_torch.kernels.flash_attention import flash_decode_plain
from repro_torch.kernels.paged_attention import paged_flash_decode_plain
from repro_torch.kernels.ref import E4M3, paged_rows, to_e4m3
from repro_torch.models import check_decode, encdec, get_model, lm
from repro_torch.optim import adamw
from repro_torch.serve import (AsyncServingEngine, PagedKVExecutor,
                               PagedServingEngine, ServeConfig, ServingEngine,
                               paged_tick)
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.tree import flatten

# the kernel modules (the package re-exports functions of the same names)
FA = sys.modules["repro_torch.kernels.flash_attention"]
PA = sys.modules["repro_torch.kernels.paged_attention"]

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
FP8 = "float8_e4m3fn"
# the reduced configs the decode test runs: dense, the reference's own case
# (qwen), gemma3's windowed sites, hybrid, MoE (batch 1: one token a step
# routes without a drop), vlm
DECODE_ARCHS = {"phi3-medium-14b": 2, "qwen1.5-32b": 2, "gemma3-1b": 2, "hymba-1.5b": 2,
                "llama4-maverick-400b-a17b": 1, "pixtral-12b": 2}
ATTN_ARCHS = ["gemma3-1b", "grok-1-314b", "hymba-1.5b", "llama4-maverick-400b-a17b",
              "phi3-medium-14b", "pixtral-12b", "qwen1.5-32b", "yi-34b"]

_MEMO: dict = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def models(arch, kv=FP8):
    """(reference cfg, reference params, port cfg, port params) of the
    reduced config with kv_cache_dtype `kv`: one set of weights, drawn by
    the reference and carried across."""
    def build():
        jcfg = j_get_config(arch).reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jcfg, jparams, params = memo(("models", arch), build)
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv), jparams,
            dataclasses.replace(get_config(arch).reduced(), kv_cache_dtype=kv), params)


def to_torch(a) -> torch.Tensor:
    """A reference array as a torch tensor: float8 through its bytes."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(E4M3)
    return torch.from_numpy(np.array(a))


def to_jax(t: torch.Tensor):
    if t.dtype == E4M3:
        return jnp.asarray(t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                 else jnp.float32)


def e4m3_step_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many elements of two float8 tensors differ, each such pair one
    e4m3 step apart (asserted): neighbouring codes of one sign."""
    g = got.view(torch.uint8).reshape(-1).int()
    w = want.view(torch.uint8).reshape(-1).int()
    diff = g != w
    assert bool(((g[diff] - w[diff]).abs() == 1).all()), "a byte is more than one step off"
    return int(diff.sum())


def close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32) if not torch.is_tensor(got)
                               else got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the cast
# ---------------------------------------------------------------------------

def _same_bytes(got: torch.Tensor, want: np.ndarray) -> None:
    """Equal bytes, a NaN of either sign equal to a NaN of either sign."""
    g = got.view(torch.uint8).numpy()
    w = want.view(np.uint8)
    nan = (g & 0x7F) == 0x7F
    assert np.array_equal(nan, (w & 0x7F) == 0x7F)
    assert np.array_equal(g[~nan], w[~nan])


def test_to_e4m3_grid_matches_reference_cast():
    sub = 2.0 ** -9     # the smallest e4m3 subnormal
    grid = [0.0, -0.0, sub, -sub, sub / 2, 3 * sub / 2, 5 * sub / 2, 0.49 * sub, 0.51 * sub,
            7 * sub, 7.5 * sub, 2.0 ** -6, 15 * 2.0 ** -10, 448, -448, 464, -464, 464.01,
            -464.01, 480, -480, 1e4, -1e4, np.inf, -np.inf, np.nan, 1.0625, 1.1875, 3.0]
    x = np.array(grid, np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    got = to_e4m3(torch.from_numpy(x))
    _same_bytes(got, want)
    # torch's own cast saturates where the reference gives NaN
    assert torch.from_numpy(x[[17]]).to(E4M3).view(torch.uint8).item() == 0x7E
    assert got[17].view(torch.uint8).item() & 0x7F == 0x7F


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_e4m3_normals_match_reference_cast(dtype):
    x = (np.random.default_rng(0).standard_normal(100_000) * 100).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(to_jax(t).astype(jnp.float8_e4m3fn))
    got = to_e4m3(t)
    assert got.dtype == E4M3
    _same_bytes(got, want)
    assert ((got.view(torch.uint8) & 0x7F) == 0x7F).sum() > 0   # some pass 464


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_init_cache_float8_shapes_and_bytes(arch):
    jcfg, _, cfg, _ = models(arch)
    want = j_lm.init_cache(jcfg, 2, 16)
    got = lm.init_cache(cfg, 2, 16, device="cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
    bf16 = lm.init_cache(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert got["k"].dtype == E4M3 and got["k"].nbytes * 2 == bf16["k"].nbytes
    # the reference's own check: 1 byte an element against the config's dtype
    full = lm.init_cache(dataclasses.replace(cfg, kv_cache_dtype="bfloat16"), 2, 16,
                         device="cpu")
    assert full["k"].nbytes == got["k"].nbytes * full["k"].element_size()


def test_whisper_keeps_its_activation_dtype_cache():
    jcfg, _, cfg, _ = models("whisper-small")
    check_decode(cfg)
    got = encdec.init_cache(cfg, 2, 16, enc_len=8, device="cpu")
    want = get_model(cfg).init_cache(2, 16, enc_len=8, device="cpu")
    from repro.models import encdec as j_encdec
    jc = j_encdec.init_cache(jcfg, 2, 16, 8)
    for name in got:
        assert got[name].dtype == want[name].dtype == torch.float32, name
        assert str(jc[name].dtype) == "float32"


def test_check_decode_refuses_an_unknown_cache_dtype():
    cfg = dataclasses.replace(get_config("phi3-medium-14b").reduced(), kv_cache_dtype="int4")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        check_decode(cfg)
    check_decode(dataclasses.replace(cfg, kv_cache_dtype=FP8))


# ---------------------------------------------------------------------------
# decode and prefill against the reference's float8 cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(DECODE_ARCHS))
def test_decode_steps_match_reference_float8_cache(arch):
    jcfg, jparams, cfg, params = models(arch)
    b = DECODE_ARCHS[arch]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, 6)).astype(np.int32)
    jcache = j_lm.init_cache(jcfg, b, 16)
    cache = lm.init_cache(cfg, b, 16, device="cpu")
    assert cache["k"].dtype == E4M3
    apart = written = 0
    for t in range(6):
        want, jcache = j_lm.decode_step(jparams, jnp.asarray(toks[:, t]), jnp.int32(t),
                                        jcache, jcfg)
        with torch.no_grad():
            got, cache = lm.decode_step(params, torch.from_numpy(toks[:, t]).long(), t, cache,
                                        cfg)
        close(got, want)
        for name in ("k", "v"):
            apart += e4m3_step_apart(cache[name], to_torch(jcache[name]))
            written += cache[name][..., :t + 1, :].numel()
        for name in set(cache) - {"k", "v"}:
            close(cache[name], jcache[name])
    assert apart <= 1e-3 * written, (apart, written)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "qwen1.5-32b", "gemma3-1b", "hymba-1.5b",
                                  "pixtral-12b"])
def test_prefill_matches_reference_float8_cache(arch):
    jcfg, jparams, cfg, params = models(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    want, jcache = j_lm.prefill(jparams, jnp.asarray(toks), jcfg, max_len=16)
    with torch.no_grad():
        got, cache = lm.prefill(params, torch.from_numpy(toks).long(), cfg, max_len=16)
    close(got, want)
    assert cache["k"].dtype == E4M3
    apart = sum(e4m3_step_apart(cache[n], to_torch(jcache[n])) for n in ("k", "v"))
    assert apart <= 1e-3 * 2 * cache["k"][..., :10, :].numel()


# ---------------------------------------------------------------------------
# the decode kernels' plain versions on e4m3 K/V
# ---------------------------------------------------------------------------

def _fp8_case(seed, b=3, hq=8, hkv=2, s_len=40, d=16, scale=1.0):
    """q (f32), e4m3 K/V made by the reference's cast, ragged valid lengths."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((b, hkv, s_len, d)).astype(np.float32) * scale)
            .astype(jnp.float8_e4m3fn) for _ in range(2))
    valid = rng.integers(1, s_len + 1, b).astype(np.int32)
    return q, k, v, valid


def _grouped_ref(q, k, v, valid, hq, hkv, d):
    return np.asarray(j_layers._grouped_decode(
        jnp.asarray(q), k, v, jnp.asarray(valid), jnp.zeros_like(jnp.asarray(valid)),
        n_heads=hq, n_kv=hkv, head_dim=d, per_slot=True, out_dtype=jnp.float32))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_s", [8, 16, 256])
def test_plain_decode_on_e4m3_matches_grouped_reference(qdtype, block_s):
    b, hq, hkv, s_len, d = 3, 8, 2, 40, 16
    q, k, v, valid = _fp8_case(5, b, hq, hkv, s_len, d)
    qt = torch.from_numpy(q).to(qdtype)
    want = _grouped_ref(qt.float().numpy(), k, v, valid, hq, hkv, d)
    kt, vt, vl = to_torch(k), to_torch(v), torch.from_numpy(valid)
    got = flash_decode_plain(qt, kt, vt, valid_len=vl, block_s=block_s)
    assert got.dtype == qdtype
    close(got, want, TOL[qdtype])
    # the same rows through the block tables, 3-D and 5-D pools
    bs = 8
    v_blocks = s_len // bs
    pages = np.random.default_rng(6).permutation(np.arange(1, b * v_blocks + 1))
    tables = torch.from_numpy(pages.reshape(b, v_blocks).astype(np.int32))
    rows = paged_rows(tables, bs)
    kp = torch.zeros(((b * v_blocks + 1) * bs, hkv, d), dtype=E4M3)
    vp = torch.zeros_like(kp)
    kp[rows] = kt.transpose(1, 2)
    vp[rows] = vt.transpose(1, 2)
    paged = paged_flash_decode_plain(qt, kp, vp, tables, valid_len=vl, block_size=bs,
                                     block_s=block_s)
    close(paged, want, TOL[qdtype])
    five = (lambda p: torch.stack([torch.zeros_like(p), p], dim=1)[:, :, None])
    paged5 = paged_flash_decode_plain(qt, five(kp), five(vp), tables, valid_len=vl,
                                      block_size=bs, layer=(1, 0), block_s=block_s)
    assert torch.equal(paged5, paged)


def test_probabilities_stay_in_q_dtype(monkeypatch):
    """Rounding P to e4m3 (the reference's TPU kernels round it to V's
    dtype) would miss the reference's models by far more than 2e-4 here;
    rounding it to q's dtype (f32) meets it."""
    b, hq, hkv, s_len, d = 2, 4, 1, 64, 16
    q, k, v, valid = _fp8_case(8, b, hq, hkv, s_len, d, scale=0.3)
    want = _grouped_ref(q, k, v, valid, hq, hkv, d)
    args = (torch.from_numpy(q), to_torch(k), to_torch(v))
    kw = dict(valid_len=torch.from_numpy(valid), block_s=32)
    close(flash_decode_plain(*args, **kw), want)
    monkeypatch.setattr(FA, "p_dtype", lambda q, v: v.dtype)
    err = np.abs(flash_decode_plain(*args, **kw).numpy() - want).max()
    assert err > 10 * 2e-4, err


# ---------------------------------------------------------------------------
# engines with a float8 cache
# ---------------------------------------------------------------------------

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
}


def serve(engine_cls, sc_cls, cfg, params, prompts, **kw):
    kw.setdefault("num_blocks", 16)
    engine_kw = {k: kw.pop(k) for k in ("kernels",) if k in kw}
    eng = engine_cls(cfg, params, sc_cls(max_len=MAX_LEN, batch=2, **kw), eos_id=-1,
                     **engine_kw)
    for rid, p in prompts.items():
        eng.submit(list(p), rid=rid)
    return eng.run_until_done(), eng


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b"])
def test_paged_engine_matches_reference_float8(arch, scenario):
    jcfg, jparams, cfg, params = models(arch)
    prompts, kw, exercised = SCENARIOS[scenario]
    want, _ = serve(JPagedEngine, JServeConfig, jcfg, jparams, prompts, **kw)
    got, eng = serve(PagedServingEngine, ServeConfig, cfg, params, prompts, **kw)
    assert eng.kp.dtype == E4M3
    assert got == want
    if arch == "phi3-medium-14b" or scenario not in ("prefix_hits",):
        assert exercised(eng.stats())
    gather, _ = serve(PagedServingEngine, ServeConfig, cfg, params, prompts,
                      paged_attention="gather", **kw)
    assert gather == got


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b"])
def test_float8_refill_equals_solo_and_native_equals_gather_pools(arch):
    _, _, cfg, params = models(arch)
    batched, _ = serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS)
    for rid, p in PROMPTS.items():
        solo, _ = serve(PagedServingEngine, ServeConfig, cfg, params, {rid: p})
        assert solo[rid] == batched[rid]
    # one tick of each data path on the same pools: the same bytes
    _, eng = serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS)
    rng = np.random.default_rng(2)
    state = {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab, (2, 3))),
             "n_tok": torch.tensor([3, 2]), "pos": torch.tensor([5, 9]),
             "tables": torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)}
    outs = {}
    for mode in ("native", "gather"):
        pools = {"kp": eng.kp.clone(), "vp": eng.vp.clone(),
                 **{k: t.clone() for k, t in eng.aux.items()}}
        out = paged_tick(params, {**state, **pools}, cfg, block_size=8, n_steps=3, mode=mode)
        outs[mode] = (out["logits"], pools)
    assert torch.equal(outs["native"][0], outs["gather"][0])
    for name in ("kp", "vp"):
        assert torch.equal(outs["native"][1][name][8:].view(torch.uint8),
                           outs["gather"][1][name][8:].view(torch.uint8))


def legacy(cfg, params, prompts, **kw):
    """Each request alone through its own legacy engine (batch 1): its one
    shared position clock makes it the solo oracle only."""
    out = {}
    for rid, p in prompts.items():
        eng = ServingEngine(cfg, params, ServeConfig(max_len=MAX_LEN, batch=1), eos_id=-1,
                            **kw)
        eng.submit(rid, list(p))
        out.update(eng.run_until_done())
    return out, eng


def _bf16_pair(arch):
    """A bfloat16 config and its float8-cache twin, on one set of bfloat16
    weights."""
    _, _, cfg, params = models(arch, kv="bfloat16")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = jax.tree.map(lambda t: t.bfloat16(), params)
    return cfg16, dataclasses.replace(cfg16, kv_cache_dtype=FP8), p16


def test_float8_engine_halves_kv_traffic_and_doubles_capacity():
    cfg16, cfg8, p16 = _bf16_pair("phi3-medium-14b")
    traffic = {}
    for tag, cfg in (("bf16", cfg16), ("fp8", cfg8)):
        done, eng = serve(PagedServingEngine, ServeConfig, cfg, p16, PROMPTS)
        assert sorted(done) == sorted(PROMPTS) and not eng.failed
        traffic[tag] = eng.stats()["kv_traffic"]
    for key in ("native_bytes_per_tick", "gather_bytes_per_tick"):
        assert traffic["fp8"][key] * 2 == traffic["bf16"][key]
    budget = 64 << 20
    blocks = {tag: PagedKVExecutor(cfg, p16, ServeConfig(max_len=MAX_LEN, batch=2,
                                                         mem_budget_bytes=budget)
                                   ).get_max_allowed_kv_blocks()[0]
              for tag, cfg in (("bf16", cfg16), ("fp8", cfg8))}
    assert blocks["fp8"] >= 1.9 * blocks["bf16"], blocks


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b"])
def test_legacy_async_and_traced_engines_float8(arch):
    _, _, cfg, params = models(arch)
    paged, _ = serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS)
    with AsyncServingEngine(cfg, params, ServeConfig(max_len=MAX_LEN, batch=2, num_blocks=16),
                            eos_id=-1) as aeng:
        handles = {rid: aeng.submit(list(p), rid=rid) for rid, p in PROMPTS.items()}
        assert {rid: h.result(timeout=300) for rid, h in handles.items()} == paged
    traced, eng = serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS,
                        compile_mode="kitsune", lowering_policy="always")
    assert traced == paged
    if arch == "phi3-medium-14b":
        used = set().union(*(fn.app.lowering.kernels_used() for fn in eng._steps.values()))
        assert "paged_flash_decode" in used
    assert legacy(cfg, params, PROMPTS)[0] == paged


def test_bf16_and_float8_engines_side_by_side():
    """One config in two cache dtypes in one process: each legacy engine
    serves its own paged engine's tokens, in either order, and the two never
    share a cached_jit build."""
    cfg16, cfg8, p16 = _bf16_pair("phi3-medium-14b")
    want = {tag: serve(PagedServingEngine, ServeConfig, cfg, p16, PROMPTS)[0]
            for tag, cfg in (("bf16", cfg16), ("fp8", cfg8))}
    assert want["bf16"] != want["fp8"]
    keys = {}
    for tag in ("fp8", "bf16", "fp8"):
        got, eng = legacy(cfg8 if tag == "fp8" else cfg16, p16, PROMPTS)
        assert got == want[tag], tag
        keys[tag] = eng._step._key
    assert keys["fp8"] != keys["bf16"]


# ---------------------------------------------------------------------------
# kernels=
# ---------------------------------------------------------------------------

def test_kernel_config_keys_the_legacy_build():
    _, _, cfg, params = models("phi3-medium-14b")
    sc = ServeConfig(max_len=MAX_LEN, batch=1)
    a = ServingEngine(cfg, params, sc)
    b = ServingEngine(cfg, params, sc, kernels=KernelConfig(block_s=64))
    assert a._step._key != b._step._key and repr(KernelConfig(block_s=64)) in b._step._key


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-small", "phi3-medium-14b"])
def test_default_kernel_config_is_bitwise_the_call_without_it(arch):
    _, _, cfg, params = models(arch, kv="bfloat16")
    m = get_model(cfg)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6))).long()
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.from_numpy(
            rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    kc = KernelConfig()
    with torch.no_grad():
        assert torch.equal(m.forward(params, batch), m.forward(params, batch, kernels=kc))
        kw = {"enc_len": 8} if cfg.family == "encdec" else {}
        c1, c2 = m.init_cache(2, 8, device="cpu", **kw), m.init_cache(2, 8, device="cpu", **kw)
        for t in range(3):
            l1, _ = m.decode_step(params, toks[:, t], t, c1)
            l2, _ = m.decode_step(params, toks[:, t], t, c2, kernels=kc)
            assert torch.equal(l1, l2)
    opt = adamw(1e-3)
    tc = TrainConfig(remat=False)
    outs = []
    for extra in ({}, {"kernels": kc}):
        state = {"params": params, "opt": opt.init(params)}
        new, metrics = make_train_step(cfg, opt, tc, **extra)(state, batch)
        outs.append((metrics["loss"], flatten(new["params"])))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(outs[0][1], outs[1][1]))
    if cfg.family == "encdec":
        return
    for engine in ("paged", "legacy", "async"):
        runs = []
        for extra in ({}, {"kernels": kc}):
            if engine == "paged":
                runs.append(serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS,
                                  **extra)[0])
            elif engine == "legacy":
                runs.append(legacy(cfg, params, PROMPTS, **extra)[0])
            else:
                with AsyncServingEngine(cfg, params, ServeConfig(max_len=MAX_LEN, batch=2,
                                                                 num_blocks=16),
                                        eos_id=-1, **extra) as aeng:
                    hs = {rid: aeng.submit(list(p), rid=rid) for rid, p in PROMPTS.items()}
                    runs.append({rid: h.result(timeout=300) for rid, h in hs.items()})
        assert runs[0] == runs[1], engine
    state = {"tokens": toks[:, :3], "n_tok": torch.tensor([3, 1]), "pos": torch.tensor([0, 4]),
             "tables": torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)}
    pools = lm.init_cache(cfg, 1, 8, device="cpu")["k"]
    g, a, _, h, _, d = pools.shape
    outs = []
    for extra in ({}, {"kernels": kc}):
        kp = torch.zeros((7 * 8, g, a, h, d))
        out = paged_tick(params, {**state, "kp": kp, "vp": kp.clone()}, cfg, block_size=8,
                         n_steps=3, mode="native", **extra)
        outs.append(out["logits"])
    assert torch.equal(*outs)


def test_block_s_reaches_every_decode_site(monkeypatch):
    """KernelConfig(block_s=64) reaches both plain decode versions at every
    site (eager ticks) and the traced tick's decode nodes; the logits stay
    within 2e-4 of the reference's."""
    jcfg, jparams, cfg, params = models("phi3-medium-14b")
    kc = KernelConfig(block_s=64)
    seen = {"dense": [], "paged": []}
    dense, paged = FA.flash_decode_plain, PA.paged_flash_decode_plain

    def rec_dense(*a, block_s=256, **kw):
        seen["dense"].append(block_s)
        return dense(*a, block_s=block_s, **kw)

    def rec_paged(*a, block_s=None, **kw):
        seen["paged"].append(block_s)
        return paged(*a, block_s=block_s, **kw)
    monkeypatch.setattr(FA, "flash_decode_plain", rec_dense)
    monkeypatch.setattr(PA, "paged_flash_decode_plain", rec_paged)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    jcache = j_lm.init_cache(jcfg, 2, 16)
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    for t in range(4):
        want, jcache = j_lm.decode_step(jparams, jnp.asarray(toks[:, t]), jnp.int32(t),
                                        jcache, jcfg)
        with torch.no_grad():
            got, _ = lm.decode_step(params, torch.from_numpy(toks[:, t]).long(), t, cache,
                                    cfg, kernels=kc)
        close(got, want)
    _, eng = serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS, kernels=kc)
    assert eng.stats()["decode_steps"] > 0
    assert seen["dense"] and set(seen["dense"]) == {64}
    assert seen["paged"] and set(seen["paged"]) == {64}
    assert len(seen["paged"]) == cfg.n_layers * eng.stats()["decode_steps"]
    monkeypatch.undo()
    _, eng = serve(PagedServingEngine, ServeConfig, cfg, params, PROMPTS, kernels=kc,
                   compile_mode="kitsune", lowering_policy="always")
    hints = [n.attrs["lower_hint"] for fn in eng._steps.values() for n in fn.app.graph.topo()
             if n.attrs.get("lower_hint") and n.attrs["lower_hint"][0] == "paged_decode"]
    assert hints and all(("block_s", 64) in h for h in hints)


def test_autotune_searches_e4m3_pools():
    """A traced paged_decode_atom over e4m3 pools, lowered with the tile
    search on: its operands are synthesized in e4m3, the search key holds
    the pools' dtype apart from the same site over f32 pools, and the
    tuned site equals the plain version."""
    from repro_torch.core import lower as lower_mod
    from repro_torch.core.lower import Target, lower_pipelines
    from repro_torch.core.trace import trace
    from repro_torch.kernels.flash_attention import decode_tile_candidates
    from repro_torch.models.atoms import paged_decode_atom
    rng = np.random.default_rng(7)
    bs, v_blocks = 8, 4
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 16)).astype(np.float32))
    pools = [torch.from_numpy(rng.standard_normal((9 * bs, 2, 16)).astype(np.float32))
             for _ in range(2)]
    tables = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 7]], dtype=torch.int32)
    valid = torch.tensor([20, 31], dtype=torch.int32)
    sigs = {}
    for kv in ("float32", FP8):
        kp, vp = (to_e4m3(p) if kv == FP8 else p for p in pools)
        args = (q, kp, vp, tables, valid)
        atom = paged_decode_atom(bs)
        g = trace(lambda *a: atom(*a), *args).graph
        (hinted,) = [n for n in g.nodes.values()
                     if n.attrs.get("lower_hint", (None,))[0] == "paged_decode"]
        plan = lower_pipelines(g, {"p0": [hinted.name]}, policy="always",
                               cfg=KernelConfig(autotune=True), target=Target(torch.device("cpu")))
        (km,) = [m for p in plan.pipelines.values() for m in p.matches]
        assert km.meta["block_s"] in {c["block_s"] for c in
                                      decode_tile_candidates(v_blocks * bs, page_size=bs)}
        vals, _ = lower_mod._synth_site(g, km, "cpu")
        assert {str(t.dtype) for t in vals.values() if t.is_floating_point()} == (
            {"torch.float32", "torch.float8_e4m3fn"} if kv == FP8 else {"torch.float32"})
        sigs[kv] = lower_mod._shape_sig(g, km)
        got = km.call(dict(zip(hinted.inputs, args)), {})
        close(got, paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid, block_size=bs))
    assert sigs["float32"] != sigs[FP8] and FP8 in str(sigs[FP8])
