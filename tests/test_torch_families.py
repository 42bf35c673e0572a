"""The port's model families held against the reference package on the CPU:
all ten configs `.reduced()` (float32), with the reference's weights
carried across by `params_from_numpy`, at the reference tests' 2e-4.

  * the forward's logits (vlm with patch embeddings; MoE at the reference
    test's capacity factor 8, and at the default capacity against the
    reference with its drop defect corrected, see below), four
    `decode_step`s (logits and every cache entry: K/V, hymba's SSM state,
    xlstm's mLSTM and sLSTM state, whisper's cross cache), and `prefill`'s
    logits and cache;
  * the reference's own invariants, asserted within the port: decode ==
    forward (2e-3, the reference's tolerance), mLSTM parallel == recurrent,
    MoE group invariance; and prefill + one decode step == the forward;
  * the parameter trees `init_params` draws equal the reference's in
    structure, shape and dtype for every config.

A deliberate difference: where a routing entry overflows its expert's
capacity, the reference's dispatch still scatters a -1 into slot (expert 0,
position 0), which may overwrite the token kept there (scatter order with
duplicate indices is undefined); the port's dropped entries write nowhere.
`test_moe_dropped_entry_writes_nowhere` shows both behaviours; where the
comparison with the reference would route with drops, it is made against
the reference with `_dispatch_group` replaced, in this process only, by the
same function with its dropped entries sent nowhere (`corrected_dispatch`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import encdec as j_encdec
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.models import lm as j_lm

from repro_torch.configs import get_config
from repro_torch.core.executor import params_from_numpy
from repro_torch.models import encdec, get_model, lm
from repro_torch.models import layers as L

NAMES = sorted(J_ARCHS)
LM_NAMES = [n for n in NAMES if J_ARCHS[n].family != "encdec"]
MOE_NAMES = [n for n in NAMES if J_ARCHS[n].family == "moe"]
TOL = 2e-4
B, S = 2, 12

_MEMO: dict = {}


def models(arch):
    """(reference cfg, reference params, port cfg, port params): one set of
    weights, drawn by the reference and carried across."""
    if arch not in _MEMO:
        jcfg = j_get_config(arch).reduced()
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _MEMO[arch] = (jcfg, jparams, get_config(arch).reduced(), params)
    return _MEMO[arch]


def batches(cfg, seed=0):
    """The same inputs for both packages: (reference batch, port batch)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        arrays["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frame_embeds"] = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
          for k, v in arrays.items()}
    return jb, tb


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _dispatch_dropping_nowhere(tokens, logits, *, n_experts, top_k, cap):
    """The reference's `_dispatch_group` with one change: a routing entry
    past its expert's capacity scatters into a row outside the slot map
    (mode="drop" discards it) instead of into slot (0, 0)."""
    n_tok, _ = tokens.shape
    gate, eidx = jax.lax.top_k(logits, top_k)
    gate = jax.nn.softmax(gate, axis=-1)
    flat_e = eidx.reshape(-1)
    flat_g = gate.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(n_tok), top_k)
    onehot = jax.nn.one_hot(flat_e, n_experts, dtype=jnp.int32)
    pos_in_e = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    keep = pos_in_e < cap
    slot_tok = jnp.full((n_experts, cap), -1, jnp.int32)
    slot_tok = slot_tok.at[jnp.where(keep, flat_e, n_experts),
                           jnp.where(keep, pos_in_e, 0)].set(flat_t, mode="drop")
    dispatched = jnp.where(slot_tok[..., None] >= 0, tokens[jnp.maximum(slot_tok, 0)], 0)
    return dispatched, (flat_e, flat_g, flat_t, pos_in_e, keep)


@pytest.fixture
def corrected_dispatch(monkeypatch):
    monkeypatch.setattr(j_layers, "_dispatch_group", _dispatch_dropping_nowhere)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NAMES)
def test_init_params_tree_matches_reference(arch):
    jcfg, jparams, cfg, _ = models(arch)
    params = get_model(cfg).init(seed=1, device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert got == want


@pytest.mark.parametrize("arch", NAMES)
def test_forward_matches_reference(arch):
    jcfg, jparams, cfg, params = models(arch)
    jb, tb = batches(cfg)
    kw = {} if cfg.family == "encdec" else {"moe_cf": 8.0}
    want = j_get_model(jcfg).forward(jparams, jb, **kw)
    with torch.no_grad():
        got = get_model(cfg).forward(params, tb, **kw)
    assert got.shape == (B, S + (cfg.vision_tokens if cfg.family == "vlm" else 0), cfg.vocab)
    close(got, want)


@pytest.mark.parametrize("arch", MOE_NAMES)
def test_moe_forward_at_default_capacity_matches_corrected_reference(arch,
                                                                     corrected_dispatch):
    jcfg, jparams, cfg, params = models(arch)
    jb, tb = batches(cfg, seed=1)
    with torch.no_grad():
        close(lm.forward(params, tb["tokens"], cfg), j_lm.forward(jparams, jb["tokens"], jcfg))


def _caches(arch, jcfg, jparams, cfg, params, jb, tb, max_len):
    jm, m = j_get_model(jcfg), get_model(cfg)
    if cfg.family != "encdec":
        return jm.init_cache(B, max_len), m.init_cache(B, max_len, device="cpu")
    jcache = jm.init_cache(B, max_len, enc_len=16)
    cache = m.init_cache(B, max_len, enc_len=16, device="cpu")
    jenc = j_encdec.encode(jparams, jb["frame_embeds"], jcfg)
    jcache = j_encdec.build_cross_cache(jparams, jenc, jcfg, jcache)
    with torch.no_grad():
        enc = encdec.encode(params, tb["frame_embeds"], cfg)
        cache = encdec.build_cross_cache(params, enc, cfg, cache)
    return jcache, cache


@pytest.mark.parametrize("arch", NAMES)
def test_decode_steps_match_reference(arch):
    """Four steps from position 0: logits at every step, then every cache
    entry (MoE routing at capacity factor 8, as the reference's test
    decodes)."""
    jcfg, jparams, cfg, params = models(arch)
    jb, tb = batches(cfg)
    jcache, cache = _caches(arch, jcfg, jparams, cfg, params, jb, tb, max_len=16)
    kw = {} if cfg.family == "encdec" else {"moe_cf": 8.0}
    rng = np.random.default_rng(3)
    for t in range(4):
        tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
        want, jcache = j_get_model(jcfg).decode_step(jparams, jnp.asarray(tok), jnp.int32(t),
                                                     jcache, **kw)
        with torch.no_grad():
            got, cache = get_model(cfg).decode_step(params, torch.from_numpy(tok).long(), t,
                                                    cache, **kw)
        close(got, want)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        close(cache[name], jcache[name])


@pytest.mark.parametrize("arch", LM_NAMES)
def test_prefill_matches_reference(arch, corrected_dispatch):
    """Logits and every cache entry (the recurrent ones at their initial
    state, as the reference leaves them)."""
    jcfg, jparams, cfg, params = models(arch)
    jb, tb = batches(cfg)
    want, jcache = j_lm.prefill(jparams, jb["tokens"], jcfg, max_len=20)
    with torch.no_grad():
        got, cache = lm.prefill(params, tb["tokens"], cfg, max_len=20)
    close(got, want)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        close(cache[name], jcache[name])


def test_vlm_prefill_with_patch_embeds_then_decode_equals_forward():
    """The reference's prefill ropes only the text positions and fails on
    patch embeddings; the port's covers the whole sequence, so one decode
    step after it equals the forward over the sequence one token longer."""
    jcfg, jparams, cfg, params = models("pixtral-12b")
    jb, tb = batches(cfg)
    with pytest.raises(TypeError):
        j_lm.prefill(jparams, jb["tokens"], jcfg, max_len=40,
                     patch_embeds=jb["patch_embeds"])
    toks, pe = tb["tokens"], tb["patch_embeds"]
    with torch.no_grad():
        full = lm.forward(params, toks, cfg, patch_embeds=pe)
        logits, cache = lm.prefill(params, toks[:, :-1], cfg, max_len=40, patch_embeds=pe)
        close(logits, full[:, :-1].numpy())
        step, _ = lm.decode_step(params, toks[:, -1], cfg.vision_tokens + S - 1, cache, cfg)
    close(step, full[:, -1].numpy())


def test_moe_dropped_entry_writes_nowhere():
    """3 tokens, 2 experts, top-1, capacity 1: tokens 0 and 2 route to
    expert 0.  Token 0 keeps slot (0, 0) and token 2 is dropped.  The
    reference's dropped entry overwrites that slot with -1, so its
    dispatched row is zeros and token 0 loses its expert output; the
    port's keeps token 0 there."""
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((3, 8)).astype(np.float32)
    logits = np.array([[2.0, 0.0], [0.0, 2.0], [1.0, 0.0]], np.float32)
    jdisp, _ = j_layers._dispatch_group(jnp.asarray(tokens), jnp.asarray(logits),
                                        n_experts=2, top_k=1, cap=1)
    disp, _ = L._dispatch_group(torch.from_numpy(tokens)[None], torch.from_numpy(logits)[None],
                                n_experts=2, top_k=1, cap=1)
    assert not np.asarray(jdisp[0, 0]).any()                 # the reference's defect
    np.testing.assert_array_equal(disp[0, 0, 0].numpy(), tokens[0])
    np.testing.assert_array_equal(disp[0, 1, 0].numpy(), tokens[1])
    np.testing.assert_array_equal(np.asarray(jdisp[1, 0]), tokens[1])
    # through the whole block: token 0's output is its expert's, gated
    jp = j_layers.init_moe(jax.random.PRNGKey(1), 8, 16, 2, dtype=jnp.float32)
    jp = dict(jp, router=jnp.eye(8, 2, dtype=jnp.float32))
    x = np.zeros((1, 3, 8), np.float32)
    x[0, :, :2] = logits
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = j_layers.moe_block(jp, jnp.asarray(x), n_experts=2, top_k=1, capacity_factor=0.5,
                              num_groups=1)
    with torch.no_grad():
        got = L.moe_block(p, torch.from_numpy(x), n_experts=2, top_k=1, capacity_factor=0.5,
                          num_groups=1)
        e = {k: v[0] for k, v in p["experts"].items()}
        x0 = torch.from_numpy(x[0, :1])
        own = (torch.nn.functional.silu(x0 @ e["wg"]) * (x0 @ e["wu"])) @ e["wd"]
    assert not np.asarray(want[0, 0]).any() and np.asarray(want[0, 1]).any()
    close(got[0, 0], own[0].numpy(), 1e-6)
    close(got[0, 1:], np.asarray(want[0, 1:]), 1e-6)


def test_top_k_ties_take_the_lowest_index_first():
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 0.0, 5.0, 5.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        v, i = L.top_k_lowest_first(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the reference's invariants, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen1.5-32b", "grok-1-314b", "hymba-1.5b",
                                  "xlstm-350m"])
def test_decode_matches_forward(arch):
    _, _, cfg, params = models(arch)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (1, 8)))
    with torch.no_grad():
        full = lm.forward(params, toks, cfg, moe_cf=8.0)
        cache = lm.init_cache(cfg, 1, 32, device="cpu")
        steps = [lm.decode_step(params, toks[:, t], t, cache, cfg, moe_cf=8.0)[0]
                 for t in range(8)]
    close(torch.stack(steps, dim=1), full.numpy(), 2e-3)


def test_mlstm_parallel_equals_recurrent():
    d, h, b, s = 32, 4, 2, 12
    gen = torch.Generator().manual_seed(1)
    p = {k: v[0] for k, v in L.init_mlstm(gen, d, h, groups=1, dtype=torch.float32,
                                          device="cpu").items()}
    x = torch.randn((b, s, d), generator=gen) * 0.5
    hd = 2 * d // h
    state = (torch.zeros(b, h, hd, hd), torch.zeros(b, h, hd), torch.full((b, h), -1e30))
    outs = []
    with torch.no_grad():
        par = L.mlstm_block(p, x, n_heads=h)
        for t in range(s):
            y, state = L.mlstm_step(p, x[:, t:t + 1], h, state)
            outs.append(y[:, 0])
    close(torch.stack(outs, dim=1), par.numpy(), 1e-4)


def test_moe_group_invariance():
    """With capacity enough that nothing drops, the group count does not
    change the output."""
    gen = torch.Generator().manual_seed(1)
    p = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0])
         for k, v in L.init_moe(gen, 32, 64, 4, groups=1, dtype=torch.float32,
                                device="cpu").items()}
    x = torch.randn((2, 64, 32), generator=gen)
    with torch.no_grad():
        y1 = L.moe_block(p, x, n_experts=4, top_k=2, capacity_factor=8.0, num_groups=1)
        y4 = L.moe_block(p, x, n_experts=4, top_k=2, capacity_factor=8.0, num_groups=4)
    close(y1, y4.numpy(), 1e-5)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "hymba-1.5b", "xlstm-350m"])
def test_remat_equals_plain(arch):
    """The forward's loss and every gradient with each group under
    torch.utils.checkpoint equal those without, bit for bit."""
    _, _, cfg, params = models(arch)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 8)))
    runs = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_() for k, v in
                  jax.tree_util.tree_flatten_with_path(params)[0]}
        tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                            list(leaves.values()))
        loss = lm.forward(tree, toks, cfg, remat=remat).logsumexp(-1).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        runs.append((loss, grads))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, g1))
    assert sum(g is not None and bool(g.abs().max() > 0) for g in g0) > len(g0) // 2

