"""The port's models, train step and engines under a `Sharder` on a
DeviceMesh, every rank a gloo process on the CPU (the harness of
`test_torch_distributed.py`), held against the reference's GSPMD runs on 8
forced host devices (one subprocess per module, read back as .npz):

  * reduced gemma3-1b, two `make_train_step` steps on (2, 4) (8 ranks):
    losses and parameters against the reference's sharded step (2e-4) and
    against the port's NULL step; a leaf's local shard smaller than its
    global shape; every rank's local shard of `blocks/sub0/mlp/wg` equal to
    the reference's shard at the same mesh coordinates; and the MLP kernel
    ops (their plain versions on the CPU) reached on local shards, the
    gated MLP's weights split Megatron-style inside the op;
  * reduced grok-1 on (2, 4): the expert weights' spec (with "model", as
    the reference's), the block's "expert_weights" constraint putting the
    experts on "model", and the forward's logits against the reference's (the reference's
    dropped routing entries sent nowhere, as `test_torch_families.py`
    corrects them);
  * reduced whisper-small, one train step on (2, 2) (4 ranks), loss and
    parameters against the reference's sharded step: the two-matrix MLP
    kernels (B1 / B6) under DTensor;
  * every kernel op's DTensor rule on a (2, 2) mesh: batch, heads and
    both for B3 / B4 / B8, B5 off its reduced axis, the MLP ops tensor
    parallel with Partial outputs -- placements, the local shapes the plain
    version saw, and the full output against the plain call;
  * the legacy and paged engines under a (1, 2) sharder against the NULL
    engines' greedy tokens on the same prompts, for phi3, hymba, grok-1 and
    xlstm.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import ENV, ROOT, _ref_params, _rank_main, run_ranks  # noqa: E402

SEED = 0
TOL = 2e-4


REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import _axis_types_kw
from repro.configs import get_config
from repro.distributed.sharding import Sharder
from repro.models import get_model
from repro.models import layers as j_layers
from repro.optim import adamw
from repro.train import TrainConfig, make_train_step

out, seed = sys.argv[1], int(sys.argv[2])
rng = np.random.default_rng(seed)
res = {}

def mesh(shape, axes=("data", "model")):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), axes,
                             **_axis_types_kw(len(axes)))

def save_tree(prefix, tree):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(v)

def train(name, shape, steps, batch):
    cfg = get_config(name).reduced()
    params = get_model(cfg).init(jax.random.PRNGKey(0))
    save_tree(name + "/init", params)
    m = mesh(shape)
    sharder = Sharder(m)
    opt = adamw(1e-3)
    shard = sharder.params_shardings(params)
    state = {"params": jax.tree.map(jax.device_put, params, shard)}
    state["opt"] = opt.init(state["params"])
    step = jax.jit(make_train_step(cfg, opt, TrainConfig(remat=True), sharder=sharder))
    batch = {k: jax.device_put(jnp.asarray(v), sharder.data_sharding(v.ndim))
             for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    res[name + "/losses"] = np.array(losses)
    save_tree(name + "/final", state["params"])
    return m, state

# gemma3-1b: two steps on (2, 4); each mesh coordinate's shard of mlp/wg
tok = rng.integers(0, 256, (4, 32)).astype(np.int32)
res["gemma/tokens"] = tok
m, state = train("gemma3-1b", (2, 4), 2, {"tokens": tok})
w = state["params"]["blocks"]["sub0"]["mlp"]["wg"]
index = w.sharding.devices_indices_map(w.shape)
full = np.asarray(w)
for i in range(2):
    for j in range(4):
        res[f"gemma/wg_shard/{i}/{j}"] = full[index[m.devices[i, j]]]

# whisper-small: one step on (2, 2)
cfg = get_config("whisper-small").reduced()
tok = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
frames = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
res.update({"whisper/tokens": tok, "whisper/frames": frames})
train("whisper-small", (2, 2), 1, {"tokens": tok, "frame_embeds": frames})

# grok-1: the forward on (2, 4), dropped entries sent nowhere
def _dispatch_dropping_nowhere(tokens, logits, *, n_experts, top_k, cap):
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
j_layers._dispatch_group = _dispatch_dropping_nowhere
cfg = get_config("grok-1-314b").reduced()
model = get_model(cfg)
params = model.init(jax.random.PRNGKey(0))
save_tree("grok/init", params)
sharder = Sharder(mesh((2, 4)))
spec = sharder.params_shardings(params)["blocks"]["sub0"]["moe"]["experts"]["wg"].spec
res["grok/wg_spec"] = np.array(json.dumps([list(e) if isinstance(e, tuple) else e
                                           for e in spec]))
tok = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
res["grok/tokens"] = tok
res["grok/logits"] = np.asarray(jax.jit(lambda p, t: model.forward(
    p, {"tokens": t}, sharder=sharder))(params, tok))
np.savez(out, **res)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref_npz(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(out), str(SEED)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-4000:]
    return str(out)


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def _spy_kernels() -> list:
    """Record the shapes each MLP kernel's plain version (what a kernel op
    runs on the CPU) is called with: under DTensor, local shards."""
    from repro_torch.kernels import fused_mlp as fm
    calls = []
    for name in ("fused_mlp_fwd_plain", "fused_mlp_bwd_plain",
                 "fused_mlp_swiglu_fwd_plain", "fused_mlp_swiglu_bwd_plain"):
        orig = getattr(fm, name)

        def spy(*args, _orig=orig, _name=name):
            calls.append((_name, [tuple(a.shape) for a in args if torch.is_tensor(a)]))
            return _orig(*args)
        setattr(fm, name, spy)
    return calls


def _train(name, world, npz, shape, steps, batch_keys, null_too=False):
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Sharder, full_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import flatten
    ref = dict(np.load(npz))
    cfg = get_config(name).reduced()
    params = _ref_params(ref, name + "/init")
    batch = {k: torch.from_numpy(ref[f"{key}"]).long() if ref[key].dtype == np.int32
             else torch.from_numpy(ref[key]) for k, key in batch_keys.items()}
    opt = adamw(1e-3)
    tc = TrainConfig(remat=True)
    out = {}
    if null_too and torch.distributed.get_rank() == 0:
        step = make_train_step(cfg, opt, tc)
        state = {"params": params, "opt": opt.init(params)}
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out["null"] = (losses, dict(flatten(state["params"])))
    calls = _spy_kernels()
    sharder = Sharder(make_mesh(shape, ("data", "model"), "cpu"))
    step = make_train_step(cfg, opt, tc, sharder=sharder)
    dp = sharder.distribute(params)
    state = {"params": dp, "opt": opt.init(dp)}
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out.update(losses=losses, calls=calls,
               params={p: full_tensor(t) for p, t in flatten(state["params"])},
               local={p: (tuple(t.to_local().shape), tuple(t.shape), tuple(t.placements))
                      for p, t in flatten(state["params"])},
               wg=state["params"]["blocks" if "blocks" in params else "dec"]
               ["sub0" if "blocks" in params else "mlp"].get("mlp", {}).get("wg")
               if "blocks" in params else None)
    if out["wg"] is not None:
        out["wg"] = out["wg"].to_local()
    if torch.distributed.get_rank() != 0:
        out.pop("params")
    return out


def case_gemma(rank, world, npz):
    return _train("gemma3-1b", world, npz, (2, 4), 2, {"tokens": "gemma/tokens"},
                  null_too=True)


def case_whisper(rank, world, npz):
    return _train("whisper-small", world, npz, (2, 2), 1,
                  {"tokens": "whisper/tokens", "frame_embeds": "whisper/frames"})


def case_grok(rank, world, npz):
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    ref = dict(np.load(npz))
    cfg = get_config("grok-1-314b").reduced()
    sharder = Sharder(make_mesh((2, 4), ("data", "model"), "cpu"))
    params = sharder.distribute(_ref_params(ref, "grok/init"))
    wg = params["blocks"]["sub0"]["moe"]["experts"]["wg"]
    logits = lm.forward(params, torch.from_numpy(ref["grok/tokens"]).long(), cfg,
                        sharder=sharder)
    return {"logits": logits.full_tensor(), "wg_placements": tuple(wg.placements),
            "wg_spec": sharder.param_spec("blocks/sub0/moe/experts/wg", tuple(wg.shape)).spec,
            "wg_local": tuple(wg.to_local().shape), "wg_shape": tuple(wg.shape)}


def case_serve(rank, world, arch):
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.serve.engine import PagedServingEngine, ServeConfig, ServingEngine
    sharder = Sharder(make_mesh((1, 2), ("data", "model"), "cpu"))
    cfg = get_config(arch).reduced()
    params = get_model(cfg).init(0, "cpu")
    prompts = [[3, 5, 7], [11, 2], [9, 9, 4, 1]]
    out = {}
    for name, kw in (("null", {}), ("sharded", {"sharder": sharder})):
        eng = ServingEngine(cfg, params, ServeConfig(max_len=16, batch=2), **kw)
        for i, p in enumerate(prompts):
            eng.submit(i, p)
        out[("legacy", name)] = eng.run_until_done(60)
        if name == "sharded" and "k" in eng.cache:
            k = eng.cache["k"]
            out["cache"] = (tuple(k.placements), tuple(k.to_local().shape), tuple(k.shape))
        eng = PagedServingEngine(cfg, params, ServeConfig(max_len=16, batch=2, num_blocks=8,
                                                          max_new_tokens=6), **kw)
        for p in prompts:
            eng.submit(p)
        out[("paged", name)] = eng.run_until_done(60)
    return out


def case_ops(rank, world):
    """Each kernel op on DTensors of a (2, 2) mesh in every placement its
    rule offers: (output placements, the local shapes its plain version
    saw, the full output) per case, beside the plain call on full tensors."""
    import importlib
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    # the kernel modules (the package exports functions of the same names)
    fa, pa, qr = (importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("flash_attention", "paged_attention", "queue_reduce"))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    seen = []
    for mod, name in ((fa, "flash_attention_plain"), (fa, "flash_decode_plain"),
                      (pa, "paged_flash_decode_plain"), (qr, "queue_reduce_plain")):
        orig = getattr(mod, name)

        def spy(*args, _orig=orig, **kw):
            seen.append(tuple(args[0].shape))
            return _orig(*args, **kw)
        setattr(mod, name, spy)
    calls = _spy_kernels()
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def put(t, *pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    r, s0, s1 = Replicate(), Shard(0), Shard(1)
    q, k, v = rnd(4, 4, 16, 8), rnd(4, 2, 16, 8), rnd(4, 2, 16, 8)
    qd, kd, vd = rnd(4, 4, 1, 8), rnd(4, 2, 32, 8), rnd(4, 2, 32, 8)
    valid = torch.tensor([32, 9, 17, 1])
    kp, vp = rnd(48, 2, 8), rnd(48, 2, 8)
    tables = torch.tensor([[1, 2, 3, 4], [5, 0, 0, 0], [2, 1, 0, 0], [4, 0, 0, 0]],
                          dtype=torch.int32)
    x = rnd(3, 8, 6)
    xm, w1, w2 = rnd(8, 16), rnd(16, 32), rnd(32, 16)
    wg, wu, dy = rnd(16, 32), rnd(16, 32), rnd(8, 16)
    out = {}
    for name, pl in (("batch", (s0, r)), ("heads", (r, s1)), ("both", (s0, s1))):
        seen.clear()
        o = ops.attention(put(q, *pl), put(k, *pl), put(v, *pl), causal=True)
        out["attention", name] = (o.placements, list(seen), o.full_tensor())
        seen.clear()
        o = ops.decode_attention(put(qd, *pl), put(kd, *pl), put(vd, *pl),
                                 valid_len=put(valid, *(p if p == s0 else r for p in pl)))
        out["decode", name] = (o.placements, list(seen), o.full_tensor())
        seen.clear()
        pools = tuple(Shard(1) if p == s1 else r for p in pl)
        o = ops.paged_decode_attention(
            put(qd, *pl), put(kp, *pools), put(vp, *pools),
            put(tables, *(p if p == s0 else r for p in pl)),
            valid_len=put(valid, *(p if p == s0 else r for p in pl)), block_size=8)
        out["paged", name] = (o.placements, list(seen), o.full_tensor())
    seen.clear()
    o = ops.reduce(put(x, s1, Shard(2)))
    out["reduce", "rows/cols"] = (o.placements, list(seen), o.full_tensor())
    # the MLP ops, Megatron tensor parallel on "model" and rows on "data"
    calls.clear()
    y = ops.mlp(put(xm, s0, r), put(w1, r, s1), put(w2, r, s0), act="gelu")
    dx, dw1, dw2 = ops.mlp_bwd(put(xm, s0, r), put(w1, r, s1), put(w2, r, s0),
                               put(dy, s0, r), act="gelu")
    ys = ops.mlp_swiglu(put(xm, s0, r), put(wg, r, s1), put(wu, r, s1), put(w2, r, s0))
    out["mlp"] = ([t.placements for t in (y, dx, dw1, dw2, ys)], list(calls),
                  [t.full_tensor() for t in (y, dx, dw1, dw2, ys)])
    return out


CASES = {"gemma": case_gemma, "whisper": case_whisper, "grok": case_grok,
         "serve": case_serve, "ops": case_ops}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_gemma_sharded_train_step_matches_reference(ref_npz, tmp_path):
    from repro_torch.tree import flatten
    got = run_ranks("gemma", 8, tmp_path, script=__file__, npz=ref_npz)
    ref = dict(np.load(ref_npz))
    want = dict(flatten(_ref_params(ref, "gemma3-1b/final")))
    null_losses, null_params = got[0]["null"]
    for r, res in enumerate(got):
        _close(res["losses"], ref["gemma3-1b/losses"])
        _close(res["losses"], null_losses)
        # this rank's shard of mlp/wg is the reference's at the same coordinates
        i, j = divmod(r, 4)
        _close(res["wg"], ref[f"gemma/wg_shard/{i}/{j}"])
        local, full, _ = res["local"]["blocks/sub0/mlp/wg"]
        assert local != full and np.prod(local) * 8 == np.prod(full)
        # the gated MLP ops ran on local shards: rows over data (4 x 32 / 2),
        # the hidden dim over model (128 / 4), never gathered to full width
        fwd = [s for n, s in res["calls"] if n == "fused_mlp_swiglu_fwd_plain"]
        bwd = [s for n, s in res["calls"] if n == "fused_mlp_swiglu_bwd_plain"]
        assert fwd and bwd
        assert all(s == [(64, 64), (64, 32), (64, 32), (32, 64)] for s in fwd), fwd
        assert all(s[:4] == [(64, 64), (64, 32), (64, 32), (32, 64)] for s in bwd), bwd
    assert set(got[0]["params"]) == set(want)
    for p, t in got[0]["params"].items():
        _close(t, want[p])
        _close(t, null_params[p])


def test_whisper_sharded_train_step_matches_reference(ref_npz, tmp_path):
    from repro_torch.tree import flatten
    got = run_ranks("whisper", 4, tmp_path, script=__file__, npz=ref_npz)
    ref = dict(np.load(ref_npz))
    want = dict(flatten(_ref_params(ref, "whisper-small/final")))
    for res in got:
        _close(res["losses"], ref["whisper-small/losses"])
        fwd = [s for n, s in res["calls"] if n == "fused_mlp_fwd_plain"]
        bwd = [s for n, s in res["calls"] if n == "fused_mlp_bwd_plain"]
        assert fwd and bwd
        # B1 / B6 on local shards: w1 (64, 128 / 2), w2 (128 / 2, 64)
        assert all(s[1:3] == [(64, 64), (64, 64)] for s in fwd + bwd), (fwd, bwd)
    assert set(got[0]["params"]) == set(want)
    for p, t in got[0]["params"].items():
        _close(t, want[p])


def test_moe_expert_parallel_forward_matches_reference(ref_npz, tmp_path):
    from torch.distributed.tensor import Shard
    got = run_ranks("grok", 8, tmp_path, script=__file__, npz=ref_npz)
    ref = dict(np.load(ref_npz))
    want = tuple(json.loads(str(ref["grok/wg_spec"])))
    for res in got:
        # the reference's rule: an expert stack's wg keeps (din, dout) ->
        # (data, model); "expert_weights" pins E -> model inside the block
        assert res["wg_spec"] == want and "model" in want
        assert res["wg_placements"] == (Shard(2), Shard(3))
        assert res["wg_local"][3] * 4 == res["wg_shape"][3]
        _close(res["logits"], ref["grok/logits"])


def test_kernel_ops_run_on_local_shards(tmp_path):
    """Every op's DTensor rule on a (2, 2) mesh: the output placed as the
    rule says, the plain version (the kernel on the card) called on the
    local shards only, and the full output equal to the plain call's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.kernels.flash_attention import flash_attention_plain, flash_decode_plain
    from repro_torch.kernels.fused_mlp import (fused_mlp_bwd_plain, fused_mlp_fwd_plain,
                                               fused_mlp_swiglu_fwd_plain)
    from repro_torch.kernels.paged_attention import paged_flash_decode_plain
    from repro_torch.kernels.queue_reduce import queue_reduce_plain
    got = run_ranks("ops", 4, tmp_path, script=__file__)
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    q, k, v = rnd(4, 4, 16, 8), rnd(4, 2, 16, 8), rnd(4, 2, 16, 8)
    qd, kd, vd = rnd(4, 4, 1, 8), rnd(4, 2, 32, 8), rnd(4, 2, 32, 8)
    valid = torch.tensor([32, 9, 17, 1])
    kp, vp = rnd(48, 2, 8), rnd(48, 2, 8)
    tables = torch.tensor([[1, 2, 3, 4], [5, 0, 0, 0], [2, 1, 0, 0], [4, 0, 0, 0]],
                          dtype=torch.int32)
    x = rnd(3, 8, 6)
    xm, w1, w2 = rnd(8, 16), rnd(16, 32), rnd(32, 16)
    wg, wu, dy = rnd(16, 32), rnd(16, 32), rnd(8, 16)
    want = {"attention": flash_attention_plain(q, k, v, causal=True),
            "decode": flash_decode_plain(qd, kd, vd, valid_len=valid),
            "paged": paged_flash_decode_plain(qd, kp, vp, tables, valid_len=valid,
                                              block_size=8)}
    r, s0, s1 = Replicate(), Shard(0), Shard(1)
    local = {"batch": (2, 4), "heads": (4, 2), "both": (2, 2)}   # q's (B, Hq) a rank
    for res in got:
        for op in ("attention", "decode", "paged"):
            for name, pl in (("batch", (s0, r)), ("heads", (r, s1)), ("both", (s0, s1))):
                placements, seen, full = res[op, name]
                assert placements == pl, (op, name, placements)
                assert seen and all(s[:2] == local[name] for s in seen), (op, name, seen)
                _close(full, want[op])
        placements, seen, full = res["reduce", "rows/cols"]
        assert placements == (Shard(0), Shard(1)) and seen == [(3, 4, 3)]
        _close(full, queue_reduce_plain(x))
        placements, calls, fulls = res["mlp"]
        # the hidden dim split over model (32 / 2), rows over data (8 / 2):
        # y and dx Partial sums over the hidden shards, dW1 / dW2 sharded
        assert placements[0] == (s0, Partial()) and placements[1] == (s0, Partial())
        assert placements[2] == (Partial(), s1) and placements[3] == (Partial(), s0)
        assert [c[1][:3] for c in calls] == [[(4, 16), (16, 16), (16, 16)]] * 3
        dx_w, dw1_w, dw2_w = fused_mlp_bwd_plain(xm, w1, w2, dy, "gelu")
        for got_t, want_t in zip(fulls, (fused_mlp_fwd_plain(xm, w1, w2, "gelu"), dx_w,
                                         dw1_w, dw2_w,
                                         fused_mlp_swiglu_fwd_plain(xm, wg, wu, w2, "silu"))):
            _close(got_t, want_t)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b", "grok-1-314b",
                                  "xlstm-350m"])
def test_sharded_engines_match_null_engines(arch, tmp_path):
    """Dense, hybrid (per-slot SSM state, reset on refill), MoE (decode's
    one routing group) and xlstm (no KV: the page-less engine)."""
    from torch.distributed.tensor import Replicate, Shard
    got = run_ranks("serve", 2, tmp_path, script=__file__, arch=arch)
    for res in got:
        assert res[("legacy", "sharded")] == res[("legacy", "null")]
        assert res[("paged", "sharded")] == res[("paged", "null")]
        assert len(res[("paged", "null")]) == 3
        assert all(len(v) for v in res[("legacy", "null")].values())
        if arch != "xlstm-350m":
            placements, local, full = res["cache"]
            # batch whole on a 1-wide data axis, the 2 KV heads over model
            assert placements == (Replicate(), Shard(3)) and local[3] * 2 == full[3]
    assert got[0] == got[1]


if __name__ == "__main__":
    _rank_main(CASES)
