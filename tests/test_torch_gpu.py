"""The port on the card: every CUDA kernel against its plain version, and
the kitsune mode of the tiny challenge apps against bsp with the lowered
sites' launches counted.  All tests carry the `gpu` marker and skip where
no CUDA device is present; this file imports neither jax nor the reference
package, so it also runs where only PyTorch is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-4, bfloat16 2e-2 (tests/test_kernels.py:25); whole
apps 2e-3 in float32 (tests/test_lowering.py:32), with weights divided by
sqrt(fan-in) so that every output's RMS stays well above that tolerance.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import apps
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 flash_decode_plain,
                                                 page_block_s)
from repro_torch.kernels.fused_mlp import (fused_mlp_bwd_plain, fused_mlp_fwd_plain,
                                           fused_mlp_swiglu_bwd_plain,
                                           fused_mlp_swiglu_fwd_plain)
from repro_torch.kernels.paged_attention import paged_flash_decode_plain
from repro_torch.kernels.queue_reduce import queue_reduce_plain
from repro_torch.kernels.ref import paged_rows
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.serve import PagedServingEngine, ServeConfig
from repro_torch.train import TrainConfig, make_train_state, make_train_step
from repro_torch.tree import flatten

pytestmark = pytest.mark.gpu
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tensors(cuda, seed, dtype, *shapes, fan_in=False):
    """Seeded numpy draws as CUDA tensors of `dtype`; with fan_in, every
    tensor after the first is scaled by 1/sqrt(rows) so values stay O(1)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        a = rng.standard_normal(shape).astype(np.float32)
        if fan_in and i > 0:
            a /= np.sqrt(shape[0])
        out.append(torch.from_numpy(a).to(cuda, DTYPES[dtype]))
    return out


def to_device(tree: dict, device) -> dict:
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,d,h,o,act", [(100, 60, 300, 50, "relu"),
                                         (130, 64, 2000, 96, "gelu"),
                                         (256, 128, 1024, 128, "silu")])
def test_fused_mlp_kernels(cuda, m, d, h, o, act, dtype):
    x, w1, wu, w2 = tensors(cuda, 1, dtype, (m, d), (d, h), (d, h), (h, o),
                            fan_in=True)
    before = K.launch_counts()
    close(K.fused_mlp_fwd(x, w1, w2, act=act),
          fused_mlp_fwd_plain(x, w1, w2, act), TOL[dtype])
    close(K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act=act),
          fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, act), TOL[dtype])
    after = K.launch_counts()
    assert after["fused_mlp"] == before["fused_mlp"] + 1
    assert after["fused_mlp_swiglu"] == before["fused_mlp_swiglu"] + 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 8, 2, 200, 200, 64, True),
                                   (2, 4, 4, 256, 256, 128, False),
                                   (1, 2, 1, 70, 130, 8, False)])
def test_flash_attention_kernel(cuda, shape, dtype):
    b, hq, hkv, sq, skv, d, causal = shape
    q, k, v = tensors(cuda, 2, dtype, (b, hq, sq, d), (b, hkv, skv, d),
                      (b, hkv, skv, d))
    close(K.flash_attention(q, k, v, causal=causal),
          flash_attention_plain(q, k, v, causal=causal), TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_queue_reduce_kernel(cuda, op, dtype):
    (x,) = tensors(cuda, 3, dtype, (16, 33, 70))
    close(K.queue_reduce(x, op=op), queue_reduce_plain(x, op), TOL[dtype])
    close(K.queue_reduce(x, op=op, out_dtype=torch.float32),
          queue_reduce_plain(x, op, torch.float32), TOL[dtype])


@pytest.mark.parametrize("name", ["dlrm", "mgn", "nerf", "graphcast", "llama"])
def test_kitsune_on_card_launches_kernels(cuda, name):
    graph, feeds = apps.tiny_instances(cuda, seed=6)[name]
    params = repro_torch.init_params(graph, 0, device=cuda, scale=1.0)
    for leaves in params.values():
        if "w" in leaves:
            leaves["w"] /= leaves["w"].shape[0] ** 0.5
    want = repro_torch.compile(graph, mode="bsp").run(feeds, params).outputs
    app = repro_torch.compile(graph, mode="kitsune")
    before = K.launch_counts()
    got = app.run(feeds, params).outputs
    after = K.launch_counts()
    for k in want:
        assert want[k].float().square().mean().sqrt() >= 2e-2, k
        close(got[k], want[k], 2e-3)
    for m in (m for pl in app.lowering.pipelines.values() for m in pl.matches
              if m.executable):
        assert after[m.kernel] > before[m.kernel], m.kernel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 40, 10, 512, 128, "slots"),
                                   (2, 4, 1, 300, 256, "int"),
                                   (2, 4, 2, 24, 16, "slots"),
                                   (1, 8, 8, 70, 64, None)])
def test_flash_decode_kernel(cuda, shape, dtype):
    """Ragged per-slot, scalar and absent valid lengths; S not a multiple of
    the 256-row chunk; head dims 16..256; 1..4 query heads per kv head."""
    b, hq, hkv, s_len, d, valid = shape
    q, k, v = tensors(cuda, 4, dtype, (b, hq, 1, d), (b, hkv, s_len, d),
                      (b, hkv, s_len, d))
    if valid == "slots":
        valid = torch.from_numpy(np.random.default_rng(5).integers(
            1, s_len + 1, b).astype(np.int32)).to(cuda)
    elif valid == "int":
        valid = s_len - 37
    before = K.launch_counts()["flash_decode"]
    close(K.flash_decode(q, k, v, valid_len=valid),
          flash_decode_plain(q, k, v, valid_len=valid), TOL[dtype])
    assert K.launch_counts()["flash_decode"] == before + 1


def _paged_case(cuda, dtype, *, b=8, hq=40, hkv=10, d=128, bs=16, v_blocks=32,
                pages=300, sites=(3, 2)):
    """A (P, G, A, Hkv, D) pool, tables over distinct pages with null-page
    tails past each slot's allocation, ragged valid lengths."""
    rng = np.random.default_rng(6)
    q, kp, vp = tensors(cuda, 7, dtype, (b, hq, 1, d),
                        (pages * bs, *sites, hkv, d), (pages * bs, *sites, hkv, d))
    valid = rng.integers(1, v_blocks * bs + 1, b)
    perm = rng.permutation(np.arange(1, pages))[:b * v_blocks].reshape(b, v_blocks)
    alloc = -(-valid // bs)
    perm[np.arange(v_blocks)[None, :] >= alloc[:, None]] = 0
    tables = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    return q, kp, vp, tables, torch.from_numpy(valid.astype(np.int32)).to(cuda)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_flash_decode_kernel(cuda, dtype):
    """Against the plain version on 5-D and 3-D pools, and bitwise equal to
    gathering the view and running the flash_decode kernel on it."""
    q, kp, vp, tables, valid = _paged_case(cuda, dtype)
    bs = 16
    for site in ((0, 0), (2, 1)):
        got = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid,
                                   block_size=bs, layer=site)
        close(got, paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                            block_size=bs, layer=site), TOL[dtype])
        k3 = kp[:, site[0], site[1]].contiguous()
        v3 = vp[:, site[0], site[1]].contiguous()
        assert torch.equal(got, K.paged_flash_decode(q, k3, v3, tables,
                                                     valid_len=valid, block_size=bs))
        rows = paged_rows(tables, bs)
        ck = k3[rows].transpose(1, 2).contiguous()
        cv = v3[rows].transpose(1, 2).contiguous()
        for block_s in (16, 64, None):
            paged = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid,
                                         block_size=bs, layer=site, block_s=block_s)
            dense = K.flash_decode(q, ck, cv, valid_len=valid,
                                   block_s=page_block_s(ck.shape[2], bs, block_s))
            assert torch.equal(paged, dense), (site, block_s)


def test_decode_kernels_refuse_unconverted_operands(cuda):
    """On the card the decode wrappers take int32 device tensors as they
    are and raise on anything else, instead of converting at every site."""
    q, kp, vp, tables, valid = _paged_case(cuda, "float32", b=2, v_blocks=4, pages=16)
    site = dict(block_size=16, layer=(0, 0))
    with pytest.raises(ValueError, match="valid_len"):
        K.paged_flash_decode(q, kp, vp, tables, valid_len=valid.long(), **site)
    with pytest.raises(ValueError, match="tables"):
        K.paged_flash_decode(q, kp, vp, tables.long(), valid_len=valid, **site)
    k = torch.zeros((2, 10, 64, 128), device=cuda)
    with pytest.raises(ValueError, match="valid_len"):
        K.flash_decode(q, k, k, valid_len=valid.cpu())


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma3-1b"])
def test_reduced_engine_on_card_equals_cpu(cuda, arch):
    """The paged engine on the card (decode kernels) and on the CPU (their
    plain versions) serve the same tokens from the same f32 weights."""
    cfg = get_config(arch).reduced()
    params = get_model(cfg).init(0, "cpu")
    prompts = {i: [3 + i, 17, 5, 9, 2 + i] for i in range(6)}
    outs = {}
    for dev, p in (("cpu", params), ("cuda", to_device(params, cuda))):
        sc = ServeConfig(max_len=32, batch=4, num_blocks=24, prefill_chunk=3)
        eng = PagedServingEngine(cfg, p, sc, eos_id=-1)
        for rid, pr in prompts.items():
            eng.submit(pr, rid=rid)
        before = K.launch_counts()
        outs[dev] = eng.run_until_done()
        launched = K.launch_counts()["paged_flash_decode"] - before["paged_flash_decode"]
        if dev == "cuda" and arch == "phi3-medium-14b":
            assert launched == cfg.n_layers * eng.stats()["decode_steps"]
    assert outs["cpu"] == outs["cuda"]


# ---------------------------------------------------------------------------
# training: the backward kernels, the autograd Functions, a train step
# ---------------------------------------------------------------------------

BWD_SHAPES = [(100, 60, 300, 50, "relu"),       # no 16-byte rows, one chunk
              (130, 64, 700, 96, "gelu"),       # ragged H over 512 / 128 chunks
              (300, 128, 1100, 128, "silu"),    # ragged M over 256 / 128 slices
              (64, 32, 128, 40, "identity")]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,d,h,o,act", BWD_SHAPES)
def test_fused_mlp_bwd_kernels(cuda, m, d, h, o, act, dtype):
    """B6 and B7 against their plain versions (kernels/ref.py), ragged M
    and H included; one launch each."""
    x, w1, wu, w2, dy = tensors(cuda, 8, dtype, (m, d), (d, h), (d, h), (h, o), (m, o),
                                fan_in=True)
    dy = dy * m ** 0.5                   # undo fan_in's 1/sqrt(m): dy is O(1) too
    before = K.launch_counts()
    rows_before = K.launches_by_rows("fused_mlp_bwd").get(m, 0)
    for got, want in zip(K.fused_mlp_bwd(x, w1, w2, dy, act=act),
                         fused_mlp_bwd_plain(x, w1, w2, dy, act)):
        assert got.dtype == want.dtype and got.shape == want.shape
        close(got, want, TOL[dtype])
    for got, want in zip(K.fused_mlp_swiglu_bwd(x, w1, wu, w2, dy, act=act),
                         fused_mlp_swiglu_bwd_plain(x, w1, wu, w2, dy, act)):
        assert got.dtype == want.dtype and got.shape == want.shape
        close(got, want, TOL[dtype])
    after = K.launch_counts()
    assert after["fused_mlp_bwd"] == before["fused_mlp_bwd"] + 1
    assert after["fused_mlp_swiglu_bwd"] == before["fused_mlp_swiglu_bwd"] + 1
    assert K.launches_by_rows("fused_mlp_bwd")[m] == rows_before + 1


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_functions_grad_on_card(cuda, gated):
    """K.mlp / K.mlp_swiglu under autograd (forward kernel, backward kernel)
    against autograd of the plain forward, float32."""
    x, w1, wu, w2, dy = tensors(cuda, 9, "float32", (3, 70, 96), (96, 600), (96, 600),
                                (600, 80), (3, 70, 80), fan_in=True)
    ins = [x, w1, wu, w2] if gated else [x, w1, w2]
    ins = [t.clone().requires_grad_() for t in ins]
    if gated:
        y = K.mlp_swiglu(*ins, act="silu")
        y_ref = fused_mlp_swiglu_fwd_plain(ins[0].reshape(-1, 96), *ins[1:], "silu")
    else:
        y = K.mlp(*ins, act="gelu")
        y_ref = fused_mlp_fwd_plain(ins[0].reshape(-1, 96), *ins[1:], "gelu")
    got = torch.autograd.grad(y, ins, dy)
    want = torch.autograd.grad(y_ref, ins, dy.reshape(-1, 80))
    for g, w in zip(got, want):
        close(g, w, TOL["float32"])


def _train(cfg, device, steps=3, seed=0):
    opt = adamw(1e-3)
    state = make_train_state(cfg, opt, seed=seed, device="cpu")
    state = {"params": to_device(state["params"], device),
             "opt": opt.init(to_device(state["params"], device))}
    step = make_train_step(cfg, opt, TrainConfig(xent_chunk=8))
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))).to(device)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.from_numpy(
            rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)).to(device)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    return losses, state


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-small"])
def test_reduced_train_on_card_equals_cpu(cuda, arch):
    """Three remat'd train steps of the reduced (f32) config on the card
    (kernels) and on the CPU (plain versions): losses and every parameter
    within 2e-4; two card runs give bitwise-equal losses."""
    cfg = get_config(arch).reduced()
    cpu_l, cpu_s = _train(cfg, "cpu")
    card_l, card_s = _train(cfg, cuda)
    np.testing.assert_allclose(card_l, cpu_l, rtol=2e-4, atol=2e-4)
    for (path, c), (_, g) in zip(flatten(cpu_s["params"]), flatten(card_s["params"])):
        close(g.cpu(), c, 2e-4)
    assert _train(cfg, cuda)[0] == card_l


def test_card_training_never_calls_plain(cuda, monkeypatch):
    """On the card the training path launches kernels only: every *_plain
    function of the kernel modules is patched to raise."""
    def boom(*_, **__):
        raise AssertionError("a plain version ran on the card path")

    for mod in {fn.__module__ for fn in K.KERNELS.values()}:
        module = __import__(mod, fromlist=["_"])
        for name in [n for n in vars(module) if n.endswith("_plain")]:
            monkeypatch.setattr(module, name, boom)
    before = K.launch_counts()
    losses, _ = _train(get_config("gemma3-1b").reduced(), cuda, steps=1)
    after = K.launch_counts()
    n = get_config("gemma3-1b").reduced().n_layers
    assert after["fused_mlp_swiglu_bwd"] - before["fused_mlp_swiglu_bwd"] == n
    assert after["fused_mlp_swiglu"] - before["fused_mlp_swiglu"] == 2 * n   # + remat
    assert np.isfinite(losses).all()
