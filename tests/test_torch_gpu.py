"""The port on the card: every CUDA kernel against its plain version, the
kitsune mode of the tiny challenge apps against bsp with the lowered
sites' launches counted, and the paged engine's captured tick (CUDA graphs)
against eager `paged_tick`, under the reference's fault scenarios and for
the recurrent families (hymba's SSM state, xlstm's page-less engine); MoE
routing under capture; whisper decode on the card against the CPU; the
default lowering policy's measured verdicts (CUDA-event times, declined
sites launching nothing, no graph pool left behind, both caches hit on a
second compile) and every tile candidate's launch against its plain
version.  All
tests carry the `gpu` marker and skip where no CUDA device is present; this
file imports neither jax nor the reference package, so it also runs where
only PyTorch is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-4, bfloat16 2e-2 (tests/test_kernels.py:25); whole
apps 2e-3 in float32 (tests/test_lowering.py:32), with weights divided by
sqrt(fan-in) so that every output's RMS stays well above that tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import apps
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (decode_tile_candidates,
                                                 flash_attention_plain,
                                                 flash_decode_plain,
                                                 page_block_s)
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels.fused_mlp import (SMALL_M, fused_mlp_bwd_plain,
                                           fused_mlp_fwd_plain, fused_mlp_swiglu_bwd_plain,
                                           fused_mlp_swiglu_fwd_plain, fwd_form)
from repro_torch.kernels.paged_attention import paged_flash_decode_plain
from repro_torch.kernels.queue_reduce import queue_reduce_plain, sequential_fold
from repro_torch.kernels.ref import paged_rows, to_e4m3
from repro_torch.models import encdec, get_model
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.serve import (AsyncServingEngine, CapturedTick, FaultSpec,
                               PagedServingEngine, ServeConfig, TickGraphError,
                               paged_tick)
from repro_torch.serve import engine as engine_module
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


# (Din, H, Dout, act) for the small-M form: rows of 60 or 100 values (not
# whole 16-byte pieces in either dtype), H not a multiple of a block's
# 16-column hidden tiles (300, 1000) nor of 8, and a width wide enough for
# several clusters (2000)
SMALL_M_WIDTHS = [(60, 300, 50, "relu"), (100, 1000, 72, "silu"), (64, 2000, 96, "gelu")]


def _mlp_case(cuda, seed, dtype, m, d, h, o):
    return tensors(cuda, seed, dtype, (m, d), (d, h), (d, h), (h, o), fan_in=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("m", [1, 3, 8, 16, SMALL_M, SMALL_M + 1])
def test_fused_mlp_small_m_form(cuda, m, gated, dtype):
    """Both forward kernels at decode row counts against their plain
    versions: the small-M form up to SMALL_M rows, the tiled form from
    SMALL_M + 1, each launch counted under its form."""
    for i, (d, h, o, act) in enumerate(SMALL_M_WIDTHS):
        x, w1, wu, w2 = _mlp_case(cuda, 20 + i, dtype, m, d, h, o)
        before = K.launches_by_form("fused_mlp_swiglu" if gated else "fused_mlp")
        if gated:
            got = K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act=act)
            want = fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, act)
        else:
            got, want = K.fused_mlp_fwd(x, w1, w2, act=act), fused_mlp_fwd_plain(x, w1, w2, act)
        assert got.dtype == want.dtype and got.shape == want.shape
        close(got, want, TOL[dtype])
        after = K.launches_by_form("fused_mlp_swiglu" if gated else "fused_mlp")
        form = fwd_form(m)
        assert form == ("small_m" if m <= SMALL_M else "tiled")
        assert after.get(form, 0) == before.get(form, 0) + 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_mlp_small_m_at_phi3_widths(cuda, dtype):
    """The decode shapes of the serving path, (8 and 64, 5120 -> 17920 ->
    5120) silu, in the small-M form against the plain version."""
    x, wg, wu, wd = _mlp_case(cuda, 30, dtype, SMALL_M, 5120, 17920, 5120)
    for m in (8, SMALL_M):
        xm = x[:m].contiguous()
        close(K.fused_mlp_swiglu_fwd(xm, wg, wu, wd, act="silu"),
              fused_mlp_swiglu_fwd_plain(xm, wg, wu, wd, "silu"), TOL[dtype])


# (Din, H, Dout, gated, act) of the other models whose decode takes the
# small-M form: hymba-1.5b's FFN, llama4-maverick's dense layer, whisper-
# small's decoder MLP (ungated gelu)
FAMILY_WIDTHS = {"hymba": (1600, 5504, 1600, True, "silu"),
                 "maverick": (5120, 16384, 5120, True, "silu"),
                 "whisper_decode": (768, 3072, 768, False, "gelu")}


@pytest.mark.parametrize("m", [8, SMALL_M])
@pytest.mark.parametrize("family", sorted(FAMILY_WIDTHS))
def test_fused_mlp_small_m_at_family_widths(cuda, family, m):
    """The small-M form at the other served models' widths, bfloat16, at 8
    and 64 decode rows, against the plain version."""
    d, h, o, gated, act = FAMILY_WIDTHS[family]
    x, w1, wu, w2 = _mlp_case(cuda, 33, "bfloat16", m, d, h, o)
    if gated:
        got, want = (K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act=act),
                     fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, act))
    else:
        got, want = K.fused_mlp_fwd(x, w1, w2, act=act), fused_mlp_fwd_plain(x, w1, w2, act)
    close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("gated", [False, True])
def test_fused_mlp_small_m_rows_independent(cuda, gated, dtype):
    """A row's output does not depend on the other rows nor on how many
    there are (what solo == batched serving rests on): row 0 is bitwise the
    same when rows 1.. are replaced by other rows, and when x is row 0
    alone; two runs are bitwise equal."""
    d, h, o, act = SMALL_M_WIDTHS[1]
    x, w1, wu, w2 = _mlp_case(cuda, 31, dtype, 8, d, h, o)
    (other,) = tensors(cuda, 32, dtype, (7, d))

    def run(xs):
        return (K.fused_mlp_swiglu_fwd(xs, w1, wu, w2, act=act) if gated
                else K.fused_mlp_fwd(xs, w1, w2, act=act))
    y = run(x)
    assert torch.equal(y, run(x))
    assert torch.equal(y[0], run(torch.cat([x[:1], other]))[0])
    assert torch.equal(y[:1], run(x[:1].contiguous()))


@pytest.mark.parametrize("m", [8, SMALL_M])
def test_fused_mlp_small_m_beyond_one_wave(cuda, m):
    """A hidden width no resident grid covers (32000: 2000 tiles of 16) takes
    waves of clusters and folds each output tile in the blocks that brought
    its partials, once all are in (`SmallPlan.fold` 1, the fold that waits
    for no other block): bf16 against the plain version, and row 0 bitwise
    the same alone."""
    x, wg, wu, wd = _mlp_case(cuda, 35, "bfloat16", m, 64, 32000, 64)
    plan, _ = FM.small_m_plan(cuda.index or 0, 64, 32000, 64, 1, True)
    assert plan.fold == 1 and plan.partials > 1
    y = K.fused_mlp_swiglu_fwd(x, wg, wu, wd, act="silu")
    close(y, fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "silu"), TOL["bfloat16"])
    assert torch.equal(y[0], K.fused_mlp_swiglu_fwd(x[:1].contiguous(), wg, wu, wd, act="silu")[0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_mlp_small_m_rows_independent_at_phi3_widths(cuda, dtype):
    """At the serving cells' (64, 5120 -> 17920 -> 5120): row 0 at M = 64 is
    bitwise row 0 at M = 1 and at M = 8, two launches are bitwise equal, and
    where the plan leaves partials the output is bitwise their sequential
    f32 fold (the in-launch fold in bfloat16, queue_reduce in float32),
    the partials taken unfolded through forward_in_form."""
    x, wg, wu, wd = _mlp_case(cuda, 34, dtype, SMALL_M, 5120, 17920, 5120)

    def run(xs):
        return K.fused_mlp_swiglu_fwd(xs, wg, wu, wd, act="silu")
    y = run(x)
    assert torch.equal(y, run(x))
    assert torch.equal(y[0], run(x[:1].contiguous())[0])
    assert torch.equal(y[0], run(x[:8].contiguous())[0])
    plan, _ = FM.small_m_plan(cuda.index or 0, 5120, 17920, 5120,
                              0 if dtype == "float32" else 1, True)
    raw = FM.forward_in_form("small_m", x, wg, wu, wd, "silu", fold=False)
    if plan.partials > 1:
        assert raw.shape == (plan.partials, SMALL_M, 5120) and raw.dtype == torch.float32
        assert torch.equal(y, sequential_fold(raw, y.dtype))
    else:
        assert torch.equal(y, raw)


def test_fused_mlp_small_m_on_two_streams_at_once(cuda):
    """The small-M form launched on two streams that run at once, at the
    serving cells' widths and 64 rows, where each grid is as large as the
    card holds and shares its fold over the grid (`SmallPlan.fold` 2): each
    stream folds on a workspace of its own, and a grid that finds part of
    the card held by the other stream's blocks stops waiting for them and
    finishes, so every output is bitwise its launch on one stream."""
    x, wg, wu, wd = _mlp_case(cuda, 36, "bfloat16", SMALL_M, 5120, 17920, 5120)
    plan, _ = FM.small_m_plan(cuda.index or 0, 5120, 17920, 5120, 1, True)
    assert plan.fold == 2 and plan.partials > 1
    xs = [x, torch.flip(x, [0]).contiguous()]
    want = [K.fused_mlp_swiglu_fwd(xi, wg, wu, wd, act="silu") for xi in xs]
    main = torch.cuda.current_stream(cuda)
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    got = [[], []]
    for st in streams:
        st.wait_stream(main)
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(K.fused_mlp_swiglu_fwd(xs[i], wg, wu, wd, act="silu"))
    for st in streams:
        main.wait_stream(st)
    torch.cuda.synchronize(cuda)
    assert len(FM._fold_workspaces) >= 3
    for ys, y0 in zip(got, want):
        assert all(torch.equal(y, y0) for y in ys)


# (Din, H, Dout) for the tiled bf16 form: widths TMA cannot read as they are
# (60, 300, 50; 100, 1000, 72; 96, 6900, 40 -- padded to multiples of 8),
# H that one block takes (300), H over one cluster of 8 (1000, 2000) and H
# over several clusters, each leaving an f32 partial (6900)
TILED_WIDTHS = [(60, 300, 50), (100, 1000, 72), (64, 2000, 96), (96, 6900, 40)]
ACTS = ["identity", "relu", "gelu", "silu"]


def _tiled(gated, x, w1, wu, w2, act):
    return (K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act=act) if gated
            else K.fused_mlp_fwd(x, w1, w2, act=act))


@pytest.mark.parametrize("m", [65, 130, 300])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("gated", [False, True])
def test_fused_mlp_tiled_form(cuda, gated, act, m):
    """The bf16 tiled form (TMA + wgmma) of B1 and B2 against the plain
    version, every activation, at widths that need padding and widths
    spread over clusters, each launch counted under "tiled"."""
    name = "fused_mlp_swiglu" if gated else "fused_mlp"
    for i, (d, h, o) in enumerate(TILED_WIDTHS):
        x, w1, wu, w2 = _mlp_case(cuda, 40 + i, "bfloat16", m, d, h, o)
        before = K.launches_by_form(name).get("tiled", 0)
        got = _tiled(gated, x, w1, wu, w2, act)
        want = (fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, act) if gated
                else fused_mlp_fwd_plain(x, w1, w2, act))
        assert got.dtype == want.dtype and got.shape == want.shape
        close(got, want, TOL["bfloat16"])
        assert K.launches_by_form(name)["tiled"] == before + 1


@pytest.mark.parametrize("gated", [False, True])
def test_fused_mlp_tiled_rows_independent(cuda, gated):
    """A row's result does not depend on M: rows 0..64 of x at M = 300 are
    bitwise those of the first 65 rows alone, and two launches give the
    same bits (the geometry is a function of the widths, the fold runs in
    rank order, no atomics)."""
    for i, (d, h, o) in enumerate(TILED_WIDTHS):
        x, w1, wu, w2 = _mlp_case(cuda, 50 + i, "bfloat16", 300, d, h, o)
        y = _tiled(gated, x, w1, wu, w2, "silu")
        assert torch.equal(y, _tiled(gated, x, w1, wu, w2, "silu"))
        assert torch.equal(y[:65], _tiled(gated, x[:65].contiguous(), w1, wu, w2, "silu"))


@pytest.mark.parametrize("h,cs,partials", [(300, 1, 1), (2000, 8, 1), (6900, 8, 2),
                                           (14336, 8, 4)])
def test_fused_mlp_tiled_partials(cuda, h, cs, partials):
    """The tiled form leaves the partials its source counts: none (y in
    bf16) where one block or one cluster spans H, one f32 partial per
    cluster otherwise -- at Llama3-8B's 14336, 4."""
    geo = FM.tiled_geometry(h)
    assert (geo.cs, geo.partials) == (cs, partials)
    x, w1, wu, w2 = _mlp_case(cuda, 60, "bfloat16", 130, 64, h, 40)
    raw = FM.forward_in_form("tiled", x, w1, wu, w2, "silu", fold=False)
    if partials == 1:
        assert raw.shape == (130, 40) and raw.dtype == torch.bfloat16
    else:
        assert raw.shape == (partials, 130, 40) and raw.dtype == torch.float32


@pytest.mark.parametrize("gated", [False, True])
def test_fused_mlp_f32_keeps_simt_kernel(cuda, gated, monkeypatch):
    """float32 above SMALL_M runs the SIMT kernel, never the bf16 tiled
    form, and holds the plain version to 2e-4."""
    def refuse(*_, **__):
        raise AssertionError("float32 reached the bf16 tiled form")

    monkeypatch.setattr(FM, "_launch_tiled", refuse)
    for i, (d, h, o) in enumerate(TILED_WIDTHS[:3]):
        x, w1, wu, w2 = _mlp_case(cuda, 70 + i, "float32", 300, d, h, o)
        got = _tiled(gated, x, w1, wu, w2, "gelu")
        want = (fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, "gelu") if gated
                else fused_mlp_fwd_plain(x, w1, w2, "gelu"))
        close(got, want, TOL["float32"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 8, 2, 200, 200, 64, True),
                                   (2, 4, 4, 256, 256, 128, False),
                                   (1, 2, 1, 70, 130, 8, False),
                                   (1, 2, 1, 70, 130, 60, True),
                                   (1, 4, 1, 300, 300, 80, True),
                                   (1, 8, 1, 333, 333, 128, True),
                                   (2, 8, 1, 200, 500, 128, False),
                                   (1, 4, 2, 300, 300, 128, True, 100),
                                   (1, 4, 2, 300, 300, 64, False, 130),
                                   (1, 2, 2, 2048, 2048, 128, True)])
def test_flash_attention_kernel(cuda, shape, dtype):
    """Head dims 64, 128 and padded ones (8, 80; 60, which the wrapper pads
    to a multiple of 8 for TMA); Sq not a multiple of the 128-row query
    tile; Skv != Sq without the causal mask; query groups of 1, 4 and 8;
    sliding windows whose edge crosses a 128-key tile; a long causal
    sequence."""
    b, hq, hkv, sq, skv, d, causal, *window = shape
    window = window[0] if window else None
    q, k, v = tensors(cuda, 2, dtype, (b, hq, sq, d), (b, hkv, skv, d),
                      (b, hkv, skv, d))
    before = K.launch_counts()["flash_attention"]
    close(K.flash_attention(q, k, v, causal=causal, window=window),
          flash_attention_plain(q, k, v, causal=causal, window=window), TOL[dtype])
    assert K.launch_counts()["flash_attention"] == before + 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_queue_reduce_kernel(cuda, op, dtype):
    (x,) = tensors(cuda, 3, dtype, (16, 33, 70))
    close(K.queue_reduce(x, op=op), queue_reduce_plain(x, op), TOL[dtype])
    close(K.queue_reduce(x, op=op, out_dtype=torch.float32),
          queue_reduce_plain(x, op, torch.float32), TOL[dtype])


def _fold_input(cuda, shape, dtype: str, offset):
    """Seeded (N, R, C) values; with `offset`, a contiguous view that starts
    one element into its storage (a base that is not 16-byte aligned)."""
    n = int(np.prod(shape))
    (flat,) = tensors(cuda, 11, dtype, (n + offset,))
    return flat[offset:].view(shape)


# (N, R, C, in dtype, out dtype): B2's decode fold, a single payload, and
# payload strides that are not a multiple of 16 bytes
FOLD_SHAPES = [(63, 8, 5120, "float32", "bfloat16"), (1, 40, 96, "float32", "float32"),
               (16, 33, 70, "bfloat16", "bfloat16"), (5, 3, 7, "float32", "bfloat16"),
               (16, 1024, 256, "bfloat16", "float32")]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_queue_reduce_bitwise_sequential_fold(cuda, shape, offset):
    """The counted wrapper equals the sequential f32 fold bit for bit, on
    any base and payload stride, and counts one launch."""
    *nrc, dt, out_dt = shape
    x = _fold_input(cuda, tuple(nrc), dt, offset)
    before = K.launch_counts()["queue_reduce"]
    assert torch.equal(K.queue_reduce(x, out_dtype=DTYPES[out_dt]),
                       sequential_fold(x, DTYPES[out_dt]))
    assert K.launch_counts()["queue_reduce"] == before + 1


def test_queue_reduce_long_stream_bitwise(cuda):
    """B2's Llama fold (537 MB, outputs enough to fill the card) is still
    bitwise the sequential fold."""
    x = torch.randn(4, 8192, 4096, generator=torch.Generator(device=cuda).manual_seed(12),
                    device=cuda)
    assert torch.equal(K.queue_reduce(x, out_dtype=torch.bfloat16),
                       sequential_fold(x, torch.bfloat16))


@pytest.mark.parametrize("op,fn", [("max", torch.amax), ("min", torch.amin)])
@pytest.mark.parametrize("shape", FOLD_SHAPES[:4])
def test_queue_reduce_nan_propagates(cuda, shape, op, fn):
    """max and min propagate a NaN as torch.amax / amin do, and otherwise
    equal them."""
    *nrc, dt, out_dt = shape
    x = _fold_input(cuda, tuple(nrc), dt, 0).clone()
    x.view(-1)[x.numel() // 3] = float("nan")
    want = fn(x.float(), dim=0).to(DTYPES[out_dt]).float()
    got = K.queue_reduce(x, op=op, out_dtype=DTYPES[out_dt]).float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert got.isnan().any()


@pytest.mark.parametrize("name", ["dlrm", "mgn", "nerf", "graphcast", "llama"])
def test_kitsune_on_card_launches_kernels(cuda, name):
    graph, feeds = apps.tiny_instances(cuda, seed=6)[name]
    params = repro_torch.init_params(graph, 0, device=cuda, scale=1.0)
    for leaves in params.values():
        if "w" in leaves:
            leaves["w"] /= leaves["w"].shape[0] ** 0.5
    want = repro_torch.compile(graph, mode="bsp").run(feeds, params).outputs
    app = repro_torch.compile(graph, mode="kitsune", lowering_policy="always")
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
                                   (1, 8, 8, 70, 64, None),
                                   (8, 40, 10, 4096, 128, "slots"),
                                   (2, 3, 1, 512, 128, 1),
                                   (2, 5, 1, 512, 64, 256),
                                   (2, 6, 1, 512, 32, 512),
                                   (2, 7, 1, 300, 128, "slots"),
                                   (2, 8, 1, 300, 256, "slots")])
def test_flash_decode_kernel(cuda, shape, dtype):
    """Ragged per-slot, scalar and absent valid lengths, and valid lengths 1,
    the 256-row chunk and S; S not a multiple of the chunk; S = 4096; head
    dims 16..256; 1..8 query heads per kv head."""
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
# the paged engine's captured tick (one CUDA graph per bucket)
# ---------------------------------------------------------------------------

SERVE_PROMPTS = {i: [3 + i, 17, 5, 9, 2 + i] for i in range(6)}
FAULT_PROMPTS = {i: [3 + i, 17, 5] for i in range(4)}


def _card_engine(cuda, arch="phi3-medium-14b", **kw):
    """The reduced (f32) config's engine on the card, and its cfg and
    params; kw overrides the ServeConfig."""
    cfg = get_config(arch).reduced()
    params = to_device(get_model(cfg).init(0, "cpu"), cuda)
    sc = dict(max_len=32, batch=4, num_blocks=24, prefill_chunk=3)
    sc.update(kw)
    return cfg, params, PagedServingEngine(cfg, params, ServeConfig(**sc), eos_id=-1)


def _serve(eng, prompts=SERVE_PROMPTS):
    handles = {rid: eng.submit(list(p), rid=rid) for rid, p in prompts.items()}
    return handles, eng.run_until_done()


def _tick_state(eng, cfg, c, seed):
    """A host tick state of chunk width c: ragged n_tok (one slot idle),
    positions 0-15 and distinct pages per slot."""
    rng = np.random.default_rng(seed)
    b, v = eng.sc.batch, eng.max_blocks
    n_tok = rng.integers(1, c + 1, b)
    n_tok[1] = 0
    tables = 1 + np.arange(b * v).reshape(b, v) % eng.pool.num_blocks
    return {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab, (b, c))),
            "n_tok": torch.from_numpy(n_tok), "pos": torch.from_numpy(rng.integers(0, 16, b)),
            "tables": torch.from_numpy(tables.astype(np.int32))}


def _pages(pool, eng):
    """Every page but the null page: page 0 takes the masked writes of every
    idle slot, in an order the scatter leaves undefined, and is never read
    unmasked."""
    return pool[eng.sc.block_size:]


@pytest.mark.parametrize("mode", ["native", "gather"])
@pytest.mark.parametrize("c", [1, 3])
def test_captured_tick_equals_eager(cuda, mode, c):
    """One replay of the (c, max_blocks) graph against eager `paged_tick`
    on copies of the same pools: tokens, positions, logits and every page
    bitwise equal."""
    cfg, params, eng = _card_engine(cuda, paged_attention=mode)
    _serve(eng)                                   # pools hold a finished run's pages
    step = eng._get_step(c, eng.max_blocks)
    assert isinstance(step, CapturedTick)
    state = _tick_state(eng, cfg, c, seed=c)
    kp, vp = eng.kp.clone(), eng.vp.clone()
    want = paged_tick(params, {**{k: t.to(cuda) for k, t in state.items()}, "kp": kp, "vp": vp},
                      cfg, block_size=eng.sc.block_size, n_steps=c, mode=mode)
    got = step({**state, "kp": eng.kp, "vp": eng.vp})
    for key in ("tokens_next", "pos", "logits"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(_pages(eng.kp, eng), _pages(kp, eng))
    assert torch.equal(_pages(eng.vp, eng), _pages(vp, eng))


def test_replays_count_the_captured_launches(cuda):
    """The counters do not move while a graph is captured, and N replays
    add N times what one eager tick launches, per kernel and per form."""
    cfg, params, eng = _card_engine(cuda)
    state = _tick_state(eng, cfg, 3, seed=0)
    before = K.launch_counts()
    forms = K.launches_by_form("fused_mlp_swiglu")
    paged_tick(params, {**{k: t.to(cuda) for k, t in state.items()}, "kp": eng.kp.clone(),
                        "vp": eng.vp.clone()}, cfg, block_size=eng.sc.block_size, n_steps=3,
               mode="native")
    eager = {k: n - before[k] for k, n in K.launch_counts().items()}
    eager_forms = {f: n - forms.get(f, 0)
                   for f, n in K.launches_by_form("fused_mlp_swiglu").items()}
    assert eager["paged_flash_decode"] == 3 * cfg.n_layers
    at_capture = K.launch_counts()
    step = eng._get_step(3, eng.max_blocks)
    assert K.launch_counts() == at_capture
    forms = K.launches_by_form("fused_mlp_swiglu")
    for _ in range(4):
        step({**state, "kp": eng.kp, "vp": eng.vp})
    assert {k: n - at_capture[k] for k, n in K.launch_counts().items()} == \
        {k: 4 * n for k, n in eager.items()}
    assert {f: n - forms.get(f, 0) for f, n in K.launches_by_form("fused_mlp_swiglu").items()
            if n != forms.get(f, 0)} == {f: 4 * n for f, n in eager_forms.items() if n}
    assert eng.graph_stats()["replays"] == 4


@pytest.mark.parametrize("mode", ["native", "gather"])
def test_capture_between_live_ticks_keeps_pages(cuda, mode):
    """Capturing a new bucket in the middle of a run changes no page but
    the null page, and the run still serves the clean run's tokens."""
    _, _, clean_eng = _card_engine(cuda, paged_attention=mode)
    _, clean = _serve(clean_eng)
    _, _, eng = _card_engine(cuda, paged_attention=mode)
    for rid, p in SERVE_PROMPTS.items():
        eng.submit(list(p), rid=rid)
    for _ in range(4):
        eng.tick()
    kp, vp = eng.kp.clone(), eng.vp.clone()
    eng._get_step(2, eng.max_blocks)              # a bucket the run never uses
    assert torch.equal(_pages(eng.kp, eng), _pages(kp, eng))
    assert torch.equal(_pages(eng.vp, eng), _pages(vp, eng))
    assert eng.run_until_done() == clean


def test_every_card_tick_replays_a_graph(cuda):
    """No eager tick on the card: every tick that ran a step replayed a
    graph, one per bucket met, and the tokens equal the CPU's."""
    cfg, params, eng = _card_engine(cuda)
    _, done = _serve(eng)
    st = eng.stats()
    assert all(isinstance(fn, CapturedTick) for fn in eng._steps.values())
    assert set(eng._steps) == {(1, eng.max_blocks), (3, eng.max_blocks)}
    assert st["graphs"]["graphs"] == 2
    assert st["graphs"]["replays"] == st["kv_traffic"]["ticks"] == st["ticks"]
    assert st["graphs"]["pool_bytes"] > 0
    cpu = PagedServingEngine(cfg, get_model(cfg).init(0, "cpu"), eng.sc, eos_id=-1)
    assert _serve(cpu)[1] == done


FAULT_CASES = {
    "tick.step": (("tick.step", dict(ticks=(3,), rid=1)), {}, {1}),
    "tick.logits": (("tick.logits", dict(ticks=(6,), rid=0)), {"nan_guard": True}, {0}),
    "pool.alloc": (("pool.alloc", dict(hits=(3,))), {}, set()),
    "prefill.chunk": (("prefill.chunk", dict(ticks=(0,))), {}, set()),
    "prefill.chunk_persistent": (("prefill.chunk", {}), {}, {1, 2, 3}),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_sites_on_captured_engine(cuda, case):
    """The reference's fault scenarios on the captured engine: the culprit
    (and only it) fails at its site, survivors equal the clean captured
    run bitwise, the pool drains, the engine stays healthy."""
    (site, spec), kw, failed = FAULT_CASES[case]
    small = dict(max_len=24, batch=2, num_blocks=16)
    _, _, clean_eng = _card_engine(cuda, **small)
    _, clean = _serve(clean_eng, FAULT_PROMPTS)
    _, _, eng = _card_engine(cuda, **small, fault_plan=(FaultSpec(site, **spec),), **kw)
    handles, done = _serve(eng, FAULT_PROMPTS)
    assert set(eng.failed) == failed
    assert all(e.site == site for e in eng.failed.values())
    assert set(done) | failed == set(FAULT_PROMPTS)
    for rid, out in done.items():
        assert out == clean[rid], f"survivor {rid} diverged"
    assert all(h.done() for h in handles.values())
    assert eng.pool.check()["active"] == 0 and eng.health()["state"] == "healthy"
    assert eng.stats()["graphs"]["replays"] > 0


def test_async_card_run_equals_sync(cuda):
    """The async engine captures on its tick thread and serves the sync
    engine's tokens."""
    _, _, sync = _card_engine(cuda)
    _, want = _serve(sync)
    _, _, inner = _card_engine(cuda)
    with AsyncServingEngine(engine=inner) as eng:
        handles = {rid: eng.submit(list(p), rid=rid) for rid, p in SERVE_PROMPTS.items()}
        got = {rid: h.result(timeout=300) for rid, h in handles.items()}
    assert got == want
    assert inner.stats()["graphs"]["replays"] == inner.stats()["ticks"]


def test_sync_inside_tick_raises_out_of_tick(cuda, monkeypatch):
    """A host sync inside the captured tick breaks the capture: tick()
    raises TickGraphError, no request is blamed, nothing retries eagerly,
    and every handle reaches a terminal state."""
    real = engine_module.paged_tick

    def syncing_tick(*args, **kw):
        out = real(*args, **kw)
        out["pos"].sum().item()                     # a device -> host sync
        return out

    monkeypatch.setattr(engine_module, "paged_tick", syncing_tick)
    _, _, eng = _card_engine(cuda)
    handles = {rid: eng.submit(list(p), rid=rid) for rid, p in SERVE_PROMPTS.items()}
    with pytest.raises(TickGraphError, match="capturing the tick"):
        eng.tick()
    assert eng.health()["state"] == "degraded"
    assert eng._steps == {}
    assert all(e.site == "engine.degraded" for e in eng.failed.values())
    assert set(eng.failed) == set(SERVE_PROMPTS)
    assert all(h.done() and h.error() is not None for h in handles.values())
    assert eng.tick() == 0                          # degraded: no tick runs


# ---------------------------------------------------------------------------
# the model families beyond dense: recurrent state under capture, MoE
# routing under capture, the decode kernels at hymba's and maverick's groups
# ---------------------------------------------------------------------------

RECURRENT = ["hymba-1.5b", "xlstm-350m"]


def _family_tick_state(eng, cfg, c, seed):
    """`_tick_state` for any family: no tables where the engine has no KV."""
    rng = np.random.default_rng(seed)
    b = eng.sc.batch
    n_tok = rng.integers(1, c + 1, b)
    n_tok[1] = 0
    state = {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab, (b, c))),
             "n_tok": torch.from_numpy(n_tok), "pos": torch.from_numpy(rng.integers(0, 16, b))}
    if eng.has_kv:
        v = eng.max_blocks
        tables = 1 + np.arange(b * v).reshape(b, v) % eng.pool.num_blocks
        state["tables"] = torch.from_numpy(tables.astype(np.int32))
    return state


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("c", [1, 3])
def test_recurrent_captured_tick_equals_eager(cuda, arch, c):
    """One replay against eager `paged_tick` on copies of the pools and of
    the recurrent state: tokens, positions, logits, every page and every
    state entry bitwise equal (one slot idle, so the masked writes run)."""
    cfg, params, eng = _card_engine(cuda, arch)
    _serve(eng)                                   # state holds a finished run's
    step = eng._get_step(c, eng.max_blocks if eng.has_kv else 0)
    assert isinstance(step, CapturedTick)
    state = _family_tick_state(eng, cfg, c, seed=c)
    copies = {k: t.clone() for k, t in eng.aux.items()}
    if eng.has_kv:
        copies.update(kp=eng.kp.clone(), vp=eng.vp.clone())
    want = paged_tick(params, {**{k: t.to(cuda) for k, t in state.items()}, **copies}, cfg,
                      block_size=eng.sc.block_size, n_steps=c, mode="native")
    got = step(state)
    for key in ("tokens_next", "pos", "logits"):
        assert torch.equal(got[key], want[key]), key
    for name in eng.aux:
        assert torch.equal(eng.aux[name], copies[name]), name
    if eng.has_kv:
        assert torch.equal(_pages(eng.kp, eng), _pages(copies["kp"], eng))


@pytest.mark.parametrize("arch", RECURRENT)
def test_capture_between_live_ticks_keeps_recurrent_state(cuda, arch):
    """Capturing a new bucket in the middle of a run leaves every slot's
    recurrent state (and every page but the null page) bitwise as it was,
    and the run still serves the clean run's tokens."""
    _, _, clean_eng = _card_engine(cuda, arch)
    _, clean = _serve(clean_eng)
    _, _, eng = _card_engine(cuda, arch)
    for rid, p in SERVE_PROMPTS.items():
        eng.submit(list(p), rid=rid)
    for _ in range(4):
        eng.tick()
    aux = {k: t.clone() for k, t in eng.aux.items()}
    pages = _pages(eng.kp, eng).clone() if eng.has_kv else None
    eng._get_step(2, eng.max_blocks if eng.has_kv else 0)    # a bucket the run never uses
    for name, t in aux.items():
        assert torch.equal(eng.aux[name], t), name
    if eng.has_kv:
        assert torch.equal(_pages(eng.kp, eng), pages)
    assert eng.run_until_done() == clean


@pytest.mark.parametrize("arch", RECURRENT + ["llama4-maverick-400b-a17b", "pixtral-12b"])
def test_reduced_family_engine_on_card_equals_cpu(cuda, arch):
    """Captured on the card, eager on the CPU, the same f32 weights: the
    same tokens; every card tick replays a graph."""
    cfg = get_config(arch).reduced()
    params = get_model(cfg).init(0, "cpu")
    outs = {}
    for dev, p in (("cpu", params), ("cuda", to_device(params, cuda))):
        sc = ServeConfig(max_len=32, batch=4, num_blocks=24, prefill_chunk=3)
        eng = PagedServingEngine(cfg, p, sc, eos_id=-1)
        outs[dev] = _serve(eng)[1]
        if dev == "cuda":
            st = eng.stats()
            assert st["graphs"]["replays"] == st["ticks"] > 0
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_block_under_capture(cuda, top_k):
    """Dispatch, expert products and combine captured in a CUDA graph (no
    host sync on the way) equal the eager block bit for bit, on the
    captured inputs and on new ones copied into the graph's buffer."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = L.init_moe(gen, 64, 128, 16, groups=1, dtype=torch.bfloat16, device=cuda)
    p = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0])
         for k, v in p.items()}
    xs = [torch.randn((8, 1, 64), generator=gen, device=cuda).to(torch.bfloat16)
          for _ in range(2)]

    def block(x):
        return L.moe_block(p, x, n_experts=16, top_k=top_k, num_groups=1)

    static = xs[0].clone()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        block(static)
    torch.cuda.current_stream(cuda).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = block(static)
    for x in xs:
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize(cuda)
        assert torch.equal(out, block(x))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d,sites", [(25, 5, 64, (32, 1)), (40, 8, 128, (1, 2))])
def test_decode_kernels_at_five_query_heads_per_kv_head(cuda, dtype, hq, hkv, d, sites):
    """hymba's (25 q / 5 kv heads of 64) and maverick's (40 / 8 of 128)
    decode: G = 5 in the kernels' 8-row group bucket.  paged_flash_decode
    against its plain version and bitwise equal to gathering the view and
    running flash_decode, which is held to its plain version too."""
    q, kp, vp, tables, valid = _paged_case(cuda, dtype, hq=hq, hkv=hkv, d=d, sites=sites,
                                           pages=300)
    bs, site = 16, (sites[0] - 1, sites[1] - 1)
    got = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs, layer=site)
    close(got, paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid, block_size=bs,
                                        layer=site), TOL[dtype])
    rows = paged_rows(tables, bs)
    ck = kp[rows, site[0], site[1]].transpose(1, 2).contiguous()
    cv = vp[rows, site[0], site[1]].transpose(1, 2).contiguous()
    dense = K.flash_decode(q, ck, cv, valid_len=valid, block_s=page_block_s(ck.shape[2], bs, None))
    assert torch.equal(got, dense)
    close(dense, flash_decode_plain(q, ck, cv, valid_len=valid), TOL[dtype])


def test_whisper_decode_on_card_equals_cpu(cuda):
    """The reduced whisper's cross cache and four decode steps: the card
    (flash_decode at every layer, fused_mlp's small-M form) against the CPU
    (their plain versions), f32."""
    cfg = get_config("whisper-small").reduced()
    params = get_model(cfg).init(0, "cpu")
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    logits = {}
    for dev, p in (("cpu", params), ("cuda", to_device(params, cuda))):
        with torch.no_grad():
            enc = encdec.encode(p, frames.to(dev), cfg)
            cache = encdec.build_cross_cache(
                p, enc, cfg, encdec.init_cache(cfg, 2, 16, enc_len=24, device=dev))
            tok = torch.tensor([3, 5], device=dev)
            steps = []
            before = K.launch_counts()
            for t in range(4):
                lg, cache = encdec.decode_step(p, tok, t, cache, cfg)
                tok = lg.argmax(-1)
                steps.append(lg.cpu())
            if dev == "cuda":
                after = K.launch_counts()
                assert after["flash_decode"] - before["flash_decode"] == 4 * cfg.n_layers
                assert after["fused_mlp"] - before["fused_mlp"] == 4 * cfg.n_layers
        logits[dev] = torch.stack(steps)
    close(logits["cuda"], logits["cpu"], TOL["float32"])


# ---------------------------------------------------------------------------
# training: the backward kernels, the autograd Functions, a train step
# ---------------------------------------------------------------------------

BWD_SHAPES = [(100, 60, 300, 50, "relu"),       # no 16-byte rows, one chunk
              (130, 64, 700, 96, "gelu"),       # ragged H over 384 / 192 / 128 chunks
              (300, 128, 1100, 128, "silu"),    # ragged M over 256 / 128 slices
              (64, 32, 128, 40, "identity"),
              (260, 64, 200, 72, "silu"),       # ragged M over 128-row tiles and 256-row spans
              (130, 96, 1000, 64, "relu")]      # ragged H over 192-wide chunks


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,d,h,o,act", BWD_SHAPES)
def test_fused_mlp_bwd_kernels(cuda, m, d, h, o, act, dtype):
    """B6 and B7 against their plain versions (kernels/ref.py), ragged M
    and H included; one launch each; a second call of each is bitwise
    equal."""
    x, w1, wu, w2, dy = tensors(cuda, 8, dtype, (m, d), (d, h), (d, h), (h, o), (m, o),
                                fan_in=True)
    dy = dy * m ** 0.5                   # undo fan_in's 1/sqrt(m): dy is O(1) too
    before = K.launch_counts()
    rows_before = K.launches_by_rows("fused_mlp_bwd").get(m, 0)
    for got, want in zip(K.fused_mlp_bwd(x, w1, w2, dy, act=act),
                         fused_mlp_bwd_plain(x, w1, w2, dy, act)):
        assert got.dtype == want.dtype and got.shape == want.shape
        close(got, want, TOL[dtype])
    gated = K.fused_mlp_swiglu_bwd(x, w1, wu, w2, dy, act=act)
    for got, want in zip(gated, fused_mlp_swiglu_bwd_plain(x, w1, wu, w2, dy, act)):
        assert got.dtype == want.dtype and got.shape == want.shape
        close(got, want, TOL[dtype])
    after = K.launch_counts()
    assert after["fused_mlp_bwd"] == before["fused_mlp_bwd"] + 1
    assert after["fused_mlp_swiglu_bwd"] == before["fused_mlp_swiglu_bwd"] + 1
    for a, b in zip(gated, K.fused_mlp_swiglu_bwd(x, w1, wu, w2, dy, act=act)):
        assert torch.equal(a, b)
    assert K.launches_by_rows("fused_mlp_bwd")[m] == rows_before + 1
    ungated = K.fused_mlp_bwd(x, w1, w2, dy, act=act)
    for a, b in zip(ungated, K.fused_mlp_bwd(x, w1, w2, dy, act=act)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,h,want", [(8192, 6912, (18, 4)), (300, 1100, (3, 1)),
                                      (100, 300, (1, 1)), (2049, 14336, (38, 2))])
def test_swiglu_bwd_partials(cuda, m, h, want):
    """The gated bf16 backward leaves one f32 partial per cluster, as its
    source counts them: dX over clusters of 2 hidden chunks of 192 (H
    padded to a multiple of 8), dW over clusters of 8 row spans of 256 --
    at gemma3-1b's 8192 x 6912, 18 and 4.  The unfolded call returns
    buffers of exactly those counts."""
    assert FM.swiglu_bwd_partials(m, h) == want
    if m * h > 1 << 22:
        return
    x, wg, wu, wd, dy = tensors(cuda, 9, "bfloat16", (m, 64), (64, h), (64, h), (h, 64),
                                (m, 64), fan_in=True)
    dx, pg, pu, pd = FM.bwd_bf16(x, wg, wu, wd, dy, "silu", parts=1)
    assert dx.shape[0] == want[0] and pg.shape[0] == pu.shape[0] == pd.shape[0] == want[1]


# the ungated bf16 backward's partials at BWD_SHAPES: dX one per cluster of
# 2 hidden chunks of 384 columns, dW one per cluster of 8 row spans of 256
MLP_BWD_PARTIALS = [(1, 1), (1, 1), (2, 1), (1, 1), (1, 1), (2, 1)]


@pytest.mark.parametrize("m,h,want", [(12000, 3072, (4, 6)), (3584, 3072, (4, 2))]
                         + [(m, h, w) for (m, _, h, _, _), w in zip(BWD_SHAPES, MLP_BWD_PARTIALS)])
def test_mlp_bwd_partials(cuda, m, h, want):
    """The ungated bf16 backward leaves the partials its source counts: dX
    over clusters of 2 hidden chunks of 384 (twice the gated form's 192,
    which halves them), dW over clusters of 8 row spans of 256 -- at
    whisper-small's encoder 4 and 6, at its decoder 4 and 2.  The unfolded
    calls return buffers of exactly those counts."""
    assert FM.mlp_bwd_partials(m, h) == want
    x, w1, w2, dy = tensors(cuda, 10, "bfloat16", (m, 64), (64, h), (h, 64), (m, 64), fan_in=True)
    dx = FM.bwd_bf16(x, w1, None, w2, dy, "gelu", parts=1)[0]
    _, p1, p2 = FM.bwd_bf16(x, w1, None, w2, dy, "gelu", parts=2)
    assert dx.shape[0] == want[0] and p1.shape[0] == p2.shape[0] == want[1]


@pytest.mark.parametrize("act", ACTS)
def test_mlp_bwd_bf16_runs_wgmma(cuda, act, monkeypatch):
    """bf16 fused_mlp_bwd runs the TMA + wgmma kernels, never the float32
    WMMA ones (their entry points are patched to raise): against the plain
    version with test_fused_mlp_bwd_kernels' tolerances at BWD_SHAPES, every
    activation, one launch counted per call, two calls bitwise equal."""
    def refuse():
        raise AssertionError("bf16 reached the WMMA backward")

    monkeypatch.setattr(FM, "_bwd_kernels", refuse)
    for i, (m, d, h, o, _) in enumerate(BWD_SHAPES):
        x, w1, w2, dy = tensors(cuda, 12 + i, "bfloat16", (m, d), (d, h), (h, o), (m, o),
                                fan_in=True)
        dy = dy * m ** 0.5                   # undo fan_in's 1/sqrt(m): dy is O(1) too
        before = K.launch_counts()["fused_mlp_bwd"]
        got = K.fused_mlp_bwd(x, w1, w2, dy, act=act)
        assert K.launch_counts()["fused_mlp_bwd"] == before + 1
        for g, w in zip(got, fused_mlp_bwd_plain(x, w1, w2, dy, act)):
            assert g.dtype == w.dtype and g.shape == w.shape
            close(g, w, TOL["bfloat16"])
        for a, b in zip(got, K.fused_mlp_bwd(x, w1, w2, dy, act=act)):
            assert torch.equal(a, b)


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


# ---------------------------------------------------------------------------
# the kernels as torch.library ops, and the capture front-end on the card
# ---------------------------------------------------------------------------

def _op_cases(cuda, dtype):
    from repro_torch.kernels import ops
    x, w1, wu, w2, dy = tensors(cuda, 21, dtype, (200, 64), (64, 512), (64, 512),
                                (512, 96), (200, 96), fan_in=True)
    xs = tensors(cuda, 22, dtype, (8, 64))[0]
    q, k, v = tensors(cuda, 23, dtype, (2, 4, 128, 64), (2, 2, 128, 64), (2, 2, 128, 64))
    qd = tensors(cuda, 24, dtype, (4, 8, 1, 128))[0]
    kd, vd = tensors(cuda, 25, dtype, (4, 2, 300, 128), (4, 2, 300, 128))
    valid = torch.tensor([1, 77, 300, 150], dtype=torch.int32, device=cuda)
    kp, vp = tensors(cuda, 26, dtype, (40 * 16, 2, 128), (40 * 16, 2, 128))
    tables = torch.arange(1, 33, dtype=torch.int32, device=cuda).reshape(4, 8)
    parts = tensors(cuda, 27, "float32", (6, 200, 96))[0]
    return [
        (ops.fused_mlp_fwd_op, (x, w1, w2, "gelu"), lambda: K.fused_mlp_fwd(x, w1, w2, act="gelu")),
        (ops.fused_mlp_fwd_op, (xs, w1, w2, "relu"), lambda: K.fused_mlp_fwd(xs, w1, w2, act="relu")),
        (ops.fused_mlp_swiglu_fwd_op, (x, w1, wu, w2, "silu"),
         lambda: K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act="silu")),
        (ops.fused_mlp_bwd_op, (x, w1, w2, dy, "gelu"),
         lambda: K.fused_mlp_bwd(x, w1, w2, dy, act="gelu")),
        (ops.fused_mlp_swiglu_bwd_op, (x, w1, wu, w2, dy, "silu"),
         lambda: K.fused_mlp_swiglu_bwd(x, w1, wu, w2, dy, act="silu")),
        (ops.flash_attention_op, (q, k, v, True, None),
         lambda: K.flash_attention(q, k, v, causal=True)),
        (ops.flash_decode_op, (qd, kd, vd, valid, None),
         lambda: K.flash_decode(qd, kd, vd, valid_len=valid)),
        (ops.flash_decode_op, (qd, kd, vd, None, 200),
         lambda: K.flash_decode(qd, kd, vd, valid_len=200)),
        (ops.paged_flash_decode_op, (qd, kp, vp, tables, valid.clamp(max=128), None, 16, None),
         lambda: K.paged_flash_decode(qd, kp, vp, tables, valid_len=valid.clamp(max=128),
                                      block_size=16)),
        (ops.queue_reduce_op, (parts, "sum"), lambda: K.queue_reduce(parts, op="sum")),
    ]


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ops_equal_ctypes_launch_bitwise(cuda, dtype):
    """Each custom op against its wrapper's ctypes launch on the same
    inputs: bitwise equal, and each op launches its kernel once."""
    for op, args, raw in _op_cases(cuda, dtype):
        before = K.launch_counts()
        got = op(*args)
        moved = {n: c - before[n] for n, c in K.launch_counts().items() if c != before[n]}
        want = raw()
        torch.cuda.synchronize()
        for g, w in zip(_flat(got), _flat(want)):
            assert torch.equal(g, w), op
        assert moved, op


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_fake_rules_match_real_outputs(cuda, dtype):
    """A capture sees only the fake rules: shape, dtype and stride of
    every output as the real op gives them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for op, args, _ in _op_cases(cuda, dtype):
        real = _flat(op(*args))
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = _flat(op(*args))
        for f, r in zip(fake, real):
            assert (f.shape, f.dtype, f.stride(), f.device) == \
                (r.shape, r.dtype, r.stride(), r.device), op


def test_compiled_train_step_launches_hinted_kernels(cuda):
    """compile_train_step on the reduced (f32) gemma3 on the card: the
    kitsune step launches B2 twice a layer (remat) and B7 once, and three
    steps equal the eager step's within 2e-4."""
    from repro_torch.train import compile_train_step
    cfg = get_config("gemma3-1b").reduced()
    opt = adamw(1e-3)
    state = make_train_state(cfg, opt, seed=0, device="cpu")
    state = {"params": to_device(state["params"], cuda),
             "opt": opt.init(to_device(state["params"], cuda))}
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))).to(cuda)}
    tc = TrainConfig(xent_chunk=8)
    eager = make_train_step(cfg, opt, tc)
    clone = lambda tree: torch.utils._pytree.tree_map(lambda t: t.clone(), tree)   # noqa: E731
    app = compile_train_step(cfg, opt, tc, state=clone(state), batch=batch,
                             lowering_policy="always")
    s, es = clone(state), clone(state)
    for _ in range(3):
        before = K.launch_counts()
        s, m = app(s, batch)
        after = K.launch_counts()
        es, em = eager(es, batch)
        assert after["fused_mlp_swiglu"] - before["fused_mlp_swiglu"] == 2 * cfg.n_layers
        assert after["fused_mlp_swiglu_bwd"] - before["fused_mlp_swiglu_bwd"] == cfg.n_layers
        np.testing.assert_allclose(m["loss"].item(), em["loss"].item(), rtol=1e-4)
    for (_, a), (_, b) in zip(flatten(s), flatten(es)):
        close(a, b, 2e-4)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b"])
def test_engines_compile_mode_on_card(cuda, arch):
    """Both engines with compile_mode="kitsune" on the card give the
    eager engines' tokens, and the traced paged tick launches the paged
    decode kernel."""
    from repro_torch.serve import ServingEngine
    cfg, params, eager = _card_engine(cuda, arch)
    _, want = _serve(eager)
    _, _, traced = _card_engine(cuda, arch, compile_mode="kitsune",
                                lowering_policy="always")
    before = K.launch_counts()
    _, got = _serve(traced)
    assert got == want
    if arch == "phi3-medium-14b":
        assert K.launch_counts()["paged_flash_decode"] > before["paged_flash_decode"]

    def legacy(mode):
        eng = ServingEngine(cfg, params, ServeConfig(max_len=16, batch=2, compile_mode=mode,
                                                     lowering_policy="always"),
                            eos_id=-1)
        for rid, p in list(SERVE_PROMPTS.items())[:3]:
            eng.submit(rid, list(p))
        return eng.run_until_done(max_ticks=60)
    assert legacy("kitsune") == legacy(None)


def test_tick_graph_captures_the_ops(cuda):
    """With the kernels registered as ops, the paged tick still captures
    into a CUDA graph, and the capture recorded the ops' kernels."""
    _, _, eng = _card_engine(cuda)
    _serve(eng)
    ticks = [t for t in eng._steps.values() if isinstance(t, CapturedTick)]
    assert ticks and all(t.replays > 0 for t in ticks)
    launched = set().union(*(t.launches for t in ticks))
    assert {"fused_mlp_swiglu", "paged_flash_decode"} <= launched


# ---------------------------------------------------------------------------
# the executable cache on the card: captured plans and cached_jit graphs
# ---------------------------------------------------------------------------

def _train_case(cuda, arch, dtype, batch=4, seq=32):
    """The reduced config in `dtype` on the card: (cfg, optimizer, state,
    batch); 4 x 32 tokens put the MLP blocks' forward in its tiled form."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    opt = adamw(1e-3)
    state = make_train_state(cfg, opt, seed=0, device=cuda)
    rng = np.random.default_rng(1)
    data = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))).to(cuda)}
    if cfg.family == "encdec":
        data["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, seq, cfg.d_model), dtype=np.float32)).to(cuda)
    return cfg, opt, state, data


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-small"])
def test_captured_train_step_bitwise_uncaptured(cuda, arch, dtype):
    """compile_train_step on the card: every step after the first replays
    the captured plan, builds nothing and launches what the walk launches,
    and three captured steps equal three uncaptured steps
    (`CompilerOptions(capture=False)`) bit for bit, state and metrics."""
    from repro_torch.train import compile_train_step
    cfg, opt, state, data = _train_case(cuda, arch, dtype)
    clone = lambda tree: torch.utils._pytree.tree_map(lambda t: t.clone(), tree)   # noqa: E731
    app = compile_train_step(cfg, opt, TrainConfig(xent_chunk=8), state=clone(state),
                             batch=data)
    walk = app.uncaptured()
    s, w = clone(state), clone(state)
    for i in range(3):
        builds = repro_torch.lowering_count()
        before = K.launch_counts()
        s, m = app(s, data)
        mid = K.launch_counts()
        w, mw = walk(w, data)
        after = K.launch_counts()
        if i:
            assert repro_torch.lowering_count() == builds
        assert {k: mid[k] - before[k] for k in mid} == {k: after[k] - mid[k] for k in mid}
        for (path, a), (_, b) in zip(flatten({"s": s, "m": m}), flatten({"s": w, "m": mw})):
            assert torch.equal(a, b), (i, path)
    st = app.capture_stats()
    assert st["graphs"] == 1 and st["replays"] == 2 and st["pool_bytes"] > 0
    assert walk.capture_stats()["graphs"] == 0
    assert "captured 1 plans" in app.describe()


def test_run_and_tick_phases_on_the_card_are_host_ranges(cuda):
    """A compiled app's replays and a cached_jit graph's replays time their
    stage, launch and outputs phases; a profiled replay of each and a
    profiled replayed tick show their `repro_torch.*` ranges on the host
    alone, nothing of them on the device's timeline; and the tick's wait
    for its read-back holds the device's time."""
    from repro_torch import cached_jit
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    phases = ("stage", "launch", "outputs")
    tg, feeds = apps.tiny_instances("cuda", seed=1)["nerf"]
    app = repro_torch.compile(tg, mode="kitsune")
    params = app.init_params(seed=0, device="cuda")
    for _ in range(3):
        app.run(feeds, params)
    st = app.capture_stats()
    assert st["runs"] == 3 and st["replays"] == 2
    assert st["run_s"] > st["key_s"] > 0 and all(st[p + "_s"] > 0 for p in phases)
    f = cached_jit(lambda x: (x @ x).relu(), key=("test_run_and_tick_phases",))
    x = torch.randn(64, 64, device=cuda)
    assert all(f.graph_stats()[p + "_s"] == 0.0 for p in phases)
    f(x)                                              # builds: no replay, no phases
    f(x)
    gs = f.graph_stats()
    assert gs["replays"] == 1 and all(gs[p + "_s"] > 0 for p in phases)
    _, _, eng = _card_engine(cuda)
    _serve(eng)
    eng.submit([3, 17, 5], max_new_tokens=4)
    eng.tick()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        app.run(feeds, params)
        f(x)
        eng.tick()
        torch.cuda.synchronize()
    ranges = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    assert {e.device_type for e in ranges} == {torch.autograd.DeviceType.CPU}
    assert {e.name for e in ranges} == (
        {f"repro_torch.kitsune.{p}" for p in ("run", "key", *phases)}
        | {f"repro_torch.graph.{p}" for p in phases}
        | {f"repro_torch.serve.{p}" for p in ("tick", "admit", "plan", "stage", "launch",
                                              "wait", "emit")})
    tick = eng.stats()["tick"]
    assert tick["wait_s"] > 0 and tick["launch_s"] > 0


def test_captured_paged_compile_tick_bitwise_uncaptured(cuda):
    """The paged engine's compile_mode tick: a replay of a bucket's
    captured plan on the engine's pools equals that plan's uncaptured walk
    on copies of them -- tokens, positions, logits and every page but the
    null page."""
    cfg, params, eng = _card_engine(cuda, compile_mode="kitsune")
    _serve(eng)
    for (c, v), step in sorted(eng._steps.items()):
        state = _tick_state(eng, cfg, c, seed=c)
        held = {"kp": eng.kp.clone(), "vp": eng.vp.clone()}
        feed = {k: t.to(cuda) for k, t in state.items()}
        want = step.app.uncaptured()(params, held, feed)
        replays = step.app.capture_stats()["replays"]
        got = step({**state, "kp": eng.kp, "vp": eng.vp})
        assert step.app.capture_stats()["replays"] == replays + 1
        for key in ("tokens_next", "pos", "logits"):
            assert torch.equal(got[key], want[key]), (c, key)
        assert torch.equal(_pages(eng.kp, eng), _pages(held["kp"], eng))
        assert torch.equal(_pages(eng.vp, eng), _pages(held["vp"], eng))


def test_cached_jit_on_card(cuda):
    """cached_jit's graph: a second call builds nothing and replays; a
    returned output survives the next call; an in-place argument moved to
    another address builds anew and the graph never writes the old one;
    a copied argument is never written."""
    from repro_torch import cached_jit

    def step(buf, x):
        buf.add_(x)
        return {"y": buf * 2.0, "buf": buf}

    f = cached_jit(step, key=("test_cached_jit_on_card",), inplace_argnums=(0,))
    buf = torch.zeros(64, device=cuda)
    x1, x2 = (torch.full((64,), v, device=cuda) for v in (1.0, 2.0))
    before = repro_torch.lowering_count()
    out1 = f(buf, x1)                                 # builds: eager on the capture stream
    assert repro_torch.lowering_count() == before + 1
    out2 = f(buf, x2)                                 # replays
    assert repro_torch.lowering_count() == before + 1
    torch.cuda.synchronize()
    assert torch.all(out1["y"] == 2.0) and torch.all(out2["y"] == 6.0)
    assert out2["buf"] is buf and torch.all(buf == 3.0)
    assert torch.all(x2 == 2.0)
    moved = torch.zeros(64, device=cuda)
    out3 = f(moved, x1)
    assert repro_torch.lowering_count() == before + 2
    out4 = f(moved, x1)
    torch.cuda.synchronize()
    assert torch.all(buf == 3.0), "the graph wrote the in-place tensor it no longer owns"
    assert torch.all(moved == 2.0) and torch.all(out3["y"] == 2.0) and torch.all(out4["y"] == 4.0)
    assert torch.all(out2["y"] == 6.0)


def test_host_sync_in_a_plan_raises_and_never_walks(cuda, monkeypatch):
    """A node that syncs the host fails the plan's capture with
    GraphCaptureError naming its program; the next run raises again
    without running any program; random ops on the device work after the
    failed capture."""
    from repro_torch.core import GraphCaptureError
    from repro_torch.core import executor as ex
    calls = []

    def syncing_relu(x):
        calls.append(1)
        return torch.relu(x) + 0.0 * x.sum().item()

    monkeypatch.setitem(ex._EW_FNS, "relu", syncing_relu)
    graph, feeds = apps.tiny_instances(cuda)["dlrm"]
    params = repro_torch.init_params(graph, seed=0, device=cuda)
    app = repro_torch.compile(graph, mode="bsp")
    relus = [n.name for n in graph.topo() if n.attrs.get("fn") == "relu"]
    with pytest.raises(GraphCaptureError, match=f"in program ({'|'.join(relus)})"):
        app.run(feeds, params)
    n = len(calls)
    with pytest.raises(GraphCaptureError):
        app.run(feeds, params)
    assert len(calls) == n, "a failed plan ran eagerly"
    assert torch.randn(8, device=cuda).isfinite().all()   # the device's generator works


def test_evicted_graph_frees_its_pool(cuda):
    """A cached_jit graph evicted from a bounded executable cache gives its
    graph memory pool back to the card."""
    import gc
    from repro_torch import cached_jit
    from repro_torch.core.cudagraph import pool_bytes
    from repro_torch.core.executor import executable_cache
    cache = executable_cache()
    cap = cache.stats()["capacity"]
    x = torch.randn(4096, 4096, device=cuda)
    f = cached_jit(lambda x: (x @ x).relu().sum(), key=("test_evicted_graph_frees_its_pool",))
    f(x)
    key = next(k for k in cache.keys() if k[:2] == ("cached_jit", "test_evicted_graph_frees_its_pool"))
    pool = cache.get(key).pool
    assert pool_bytes(pool) >= 64 << 20
    g = cached_jit(lambda y: y + 1.0, key=("test_evicted_graph_frees_its_pool", "other"))
    g(x[0])
    try:
        cache.set_capacity(1)                 # keeps only g's graph, the most recent
        assert key not in cache and cache.stats()["evictions"] >= 1
        gc.collect()
        torch.cuda.empty_cache()
        assert pool_bytes(pool) == 0
    finally:
        cache.set_capacity(cap)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma3-1b"])
def test_legacy_engine_replays_its_tick(cuda, arch):
    """The legacy engine on the card ticks through cached_jit: one graph,
    every tick after the first a replay, the CPU engine's tokens."""
    from repro_torch.core.executor import executable_cache
    from repro_torch.serve import ServingEngine
    cfg = get_config(arch).reduced()
    cpu_params = get_model(cfg).init(0, "cpu")
    outs = {}
    for dev, p in (("cpu", cpu_params), ("cuda", to_device(cpu_params, cuda))):
        eng = ServingEngine(cfg, p, ServeConfig(max_len=16, batch=2), eos_id=-1)
        for rid, prompt in list(SERVE_PROMPTS.items())[:3]:
            eng.submit(rid, list(prompt))
        before, keys = repro_torch.lowering_count(), set(executable_cache().keys())
        outs[dev] = eng.run_until_done(max_ticks=60)
        if dev == "cuda":
            assert repro_torch.lowering_count() == before + 1
            new = [k for k in executable_cache().keys() if k not in keys]
            assert len(new) == 1 and new[0][:5] == ("cached_jit", "serve_step", cfg.name, 2, 16)
            assert executable_cache().get(new[0]).replays == eng.pos - 1
    assert outs["cpu"] == outs["cuda"]


def test_dropped_legacy_engine_frees_its_graph(cuda):
    """The legacy engine's cached_jit graph reads that engine's cache at its
    address: it serves no other engine, and it leaves the executable cache,
    its pool going back to the card, when the engine is collected."""
    import gc
    from repro_torch.core.cudagraph import pool_bytes
    from repro_torch.core.executor import executable_cache
    from repro_torch.serve import ServingEngine
    cfg = get_config("gemma3-1b").reduced()
    params = get_model(cfg).init(0, cuda)
    eng = ServingEngine(cfg, params, ServeConfig(max_len=16, batch=2), eos_id=-1)
    eng.submit(0, [3, 4, 5])
    eng.run_until_done(max_ticks=20)
    st = eng.graph_stats()
    assert st["graphs"] == 1 and st["replays"] == eng.pos - 1 and st["pool_bytes"] > 0
    assert st["warm_up_s"] > 0 and st["capture_s"] > 0
    (graph,) = eng._step.graphs()
    key = next(k for k in executable_cache().keys() if executable_cache().get(k) is graph)
    pool = graph.pool
    del graph, eng
    gc.collect()
    torch.cuda.empty_cache()
    assert key not in executable_cache()
    assert pool_bytes(pool) == 0


# ---------------------------------------------------------------------------
# the default lowering policy on the card: verdicts and tuned tiles
# ---------------------------------------------------------------------------

def _mlp_graph(name, m=16, d=32, h=64, dtype="float32"):
    g = repro_torch.Graph(name)
    g.input("x", (m, d), dtype)
    g.linear("fc1", "x", h)
    g.elementwise("act", ["fc1"], "gelu")
    g.linear("fc2", "act", d)
    g.output("y", "fc2")
    return g


@pytest.fixture
def scratch_verdicts():
    """Empty verdict and tune caches for the test, the process's entries
    back after it."""
    from repro_torch.core.executor import verdict_cache
    caches = (verdict_cache(), K.tune_cache())
    saved = [dict(c._store) for c in caches]
    for c in caches:
        c.clear()
    yield caches
    for c, store in zip(caches, saved):
        c.clear()
        c._store.update(store)


def test_measured_verdict_on_card_carries_cuda_event_times(cuda, scratch_verdicts,
                                                           monkeypatch):
    """A tiny site's estimates tie inside the band, so "auto" measures it
    on the card: both candidates captured and their replays timed with
    CUDA events, the decision following its own numbers, and no launch of
    the measurement counted."""
    from repro_torch.core import lower as lower_mod
    events, event = [], torch.cuda.Event

    def counting(*a, **kw):
        events.append(event(*a, **kw))
        return events[-1]

    monkeypatch.setattr(torch.cuda, "Event", counting)
    before = K.launch_counts()
    app = repro_torch.compile(_mlp_graph("card_measured"), mode="kitsune")
    assert K.launch_counts() == before
    (row,) = [r for r in app.lowering_verdicts() if r["executable"]]
    assert row["source"] == "measured" and row["meas_kernel_us"] > 0
    assert row["meas_closure_us"] > 0
    assert len(events) >= 4 * lower_mod.MEASURE_REPS
    assert (row["decision"] == "lowered") == (
        row["meas_kernel_us"] * lower_mod.MEASURE_MARGIN <= row["meas_closure_us"])
    assert f"measured kernel {row['meas_kernel_us']:.1f}us" in app.describe()


def test_declined_site_launches_no_kernel(cuda, scratch_verdicts, monkeypatch):
    """Every site declined (stubbed measurements): the run launches no
    kernel and equals bsp."""
    from repro_torch.core import lower as lower_mod
    monkeypatch.setattr(lower_mod, "_measure_site", lambda *_: (1.0, 1e-6))
    graph, feeds = apps.tiny_instances(cuda, seed=6)["nerf"]
    params = repro_torch.init_params(graph, 0, device=cuda, scale=1.0)
    for leaves in params.values():
        if "w" in leaves:
            leaves["w"] /= leaves["w"].shape[0] ** 0.5
    app = repro_torch.compile(graph, mode="kitsune")
    assert all(not m.accepted for p in app.lowering.pipelines.values() for m in p.matches
               if m.executable)
    before = K.launch_counts()
    got = app.run(feeds, params).outputs
    assert K.launch_counts() == before
    want = repro_torch.compile(graph, mode="bsp").run(feeds, params).outputs
    for k in want:
        close(got[k], want[k], 2e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_tile_candidate_launches_and_equals_plain(cuda, dtype):
    """Each candidate of each grid is a launch its wrapper takes: the f32
    MLP forms' chunks and slices, the decode chunks of B4 and B8 at phi3's
    decode shape, each against the plain version at the same tile."""
    tol = TOL[dtype]
    for m, d, h, o in ((200, 64, 600, 96), (300, 128, 1100, 64)):
        x, w1, wu, w2, dy = tensors(cuda, 9, dtype, (m, d), (d, h), (d, h), (h, o), (m, o),
                                    fan_in=True)
        for gated in (False, True):
            for c in FM.tile_candidates(m, h, dtype, gated=gated):
                kw = {"f32_block_h": c["f32_block_h"]} if c else {}
                got = (K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act="silu", **kw) if gated
                       else K.fused_mlp_fwd(x, w1, w2, act="gelu", **kw))
                want = (fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, "silu") if gated
                        else fused_mlp_fwd_plain(x, w1, w2, "gelu"))
                close(got, want, tol)
            for c in FM.tile_candidates(m, h, dtype, gated=gated, backward=True):
                kw = ({"f32_block_h": c["f32_bwd_block_h"], "f32_block_m": c["f32_bwd_block_m"]}
                      if c else {})
                if gated:
                    got = K.fused_mlp_swiglu_bwd(x, w1, wu, w2, dy, act="silu", **kw)
                    want = fused_mlp_swiglu_bwd_plain(x, w1, wu, w2, dy, "silu")
                else:
                    got = K.fused_mlp_bwd(x, w1, w2, dy, act="gelu", **kw)
                    want = fused_mlp_bwd_plain(x, w1, w2, dy, "gelu")
                if dtype == "float32":
                    for g_, w_ in zip(got, want):
                        close(g_, w_, tol)
                else:   # bf16 dW: the relative-norm bound (ROADMAP C)
                    close(got[0], want[0], tol)
                    for g_, w_ in zip(got[1:], want[1:]):
                        assert (g_.float() - w_.float()).norm() <= 1e-2 * w_.float().norm()
    b, hq, hkv, s_len, d, bs = 8, 40, 10, 512, 128, 16
    q, k, v = tensors(cuda, 10, dtype, (b, hq, 1, d), (b, hkv, s_len, d), (b, hkv, s_len, d))
    valid = torch.randint(1, s_len + 1, (b,), generator=torch.Generator().manual_seed(3)
                          ).to(cuda, torch.int32)
    for c in decode_tile_candidates(s_len):
        close(K.flash_decode(q, k, v, valid_len=valid, block_s=c["block_s"]),
              flash_decode_plain(q, k, v, valid_len=valid, block_s=c["block_s"]), tol)
    v_blocks = s_len // bs
    rows = (b * v_blocks + 1) * bs
    kp, vp = tensors(cuda, 11, dtype, (rows, hkv, d), (rows, hkv, d))
    tables = (1 + torch.randperm(b * v_blocks, generator=torch.Generator().manual_seed(4))
              ).to(cuda, torch.int32).reshape(b, v_blocks)
    for c in decode_tile_candidates(s_len, page_size=bs):
        close(K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs,
                                   block_s=c["block_s"]),
              paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid, block_size=bs,
                                       block_s=c["block_s"]), tol)


def test_tuned_decode_sites_equal_their_plain_versions(cuda, scratch_verdicts):
    """B4 and B8 traced at phi3's decode shape and compiled under "auto":
    the tile is searched on the card, the winner is one of the grid's, and
    the compiled site equals the plain version at the bf16 limits."""
    from repro_torch.models.atoms import paged_decode_atom
    b, hq, hkv, s_len, d, bs = 8, 40, 10, 512, 128, 16
    q, k, v = tensors(cuda, 12, "bfloat16", (b, hq, 1, d), (b, hkv, s_len, d),
                      (b, hkv, s_len, d))
    valid = torch.randint(1, s_len + 1, (b,), generator=torch.Generator().manual_seed(5)
                          ).to(cuda, torch.int32)
    dense = repro_torch.compile(lambda q, k, v, n: K.decode_attention(q, k, v, valid_len=n) * 2.0,
                                (q, k, v, valid), mode="kitsune")
    (km,) = [m for p in dense.lowering.pipelines.values() for m in p.matches]
    grid = [c["block_s"] for c in decode_tile_candidates(s_len)]
    assert km.kernel == "flash_decode" and km.meta["block_s"] in grid and km.tile["us"] > 0
    close(dense(q, k, v, valid), flash_decode_plain(q, k, v, valid_len=valid) * 2.0, 2e-2)
    v_blocks = s_len // bs
    rows = (b * v_blocks + 1) * bs
    kp, vp = tensors(cuda, 13, "bfloat16", (rows, hkv, d), (rows, hkv, d))
    tables = (1 + torch.randperm(b * v_blocks, generator=torch.Generator().manual_seed(6))
              ).to(cuda, torch.int32).reshape(b, v_blocks)
    atom = paged_decode_atom(bs)
    paged = repro_torch.compile(lambda *a: atom(*a) * 2.0, (q, kp, vp, tables, valid),
                                mode="kitsune")
    (km,) = [m for p in paged.lowering.pipelines.values() for m in p.matches]
    grid = [c["block_s"] for c in
            decode_tile_candidates(s_len, page_size=bs)]
    assert km.kernel == "paged_flash_decode" and km.meta["block_s"] in grid
    close(paged(q, kp, vp, tables, valid),
          paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid, block_size=bs) * 2.0,
          2e-2)


def test_measurement_leaves_no_pool_behind(cuda, monkeypatch):
    """The measurement's captured candidates are freed, their graph pools
    given back to the card, before the compile returns."""
    import gc
    from repro_torch.core import lower as lower_mod
    from repro_torch.core.cudagraph import pool_bytes
    pools = []
    capture = lower_mod._capture

    def recording(*a, **kw):
        g = capture(*a, **kw)
        pools.append(g.pool)
        return g

    monkeypatch.setattr(lower_mod, "_capture", recording)
    g = _mlp_graph("card_pools", m=512, d=256, h=1024)
    (km,) = lower_mod.lower_pipelines(g, {"sf0": ["fc1", "act", "fc2"]}).pipelines[
        "sf0"].matches
    t_k, t_c = lower_mod._measure_site(g, km, lower_mod.target_for(cuda))
    assert t_k > 0 and t_c > 0 and len(pools) == 2
    gc.collect()
    assert pool_bytes(*pools) == 0


def test_second_compile_adds_no_verdict_and_no_tune_miss(cuda, scratch_verdicts):
    """A second compile of the same tiny apps on the card hits both caches
    at every site: no verdict decided, no tile searched."""
    vc, tc = scratch_verdicts
    for name, (graph, _) in apps.tiny_instances(cuda).items():
        repro_torch.compile(graph, mode="kitsune")
    v0, t0 = vc.stats(), tc.stats()
    assert v0["size"] > 0 and t0["size"] > 0
    for name, (graph, _) in apps.tiny_instances(cuda).items():
        app = repro_torch.compile(graph, mode="kitsune")
        assert all(m.tile is not None for p in app.lowering.pipelines.values()
                   for m in p.matches if m.executable), name
    v1, t1 = vc.stats(), tc.stats()
    assert (v1["size"], v1["misses"]) == (v0["size"], v0["misses"]) and v1["hits"] > v0["hits"]
    assert (t1["size"], t1["misses"]) == (t0["size"], t0["misses"]) and t1["hits"] > t0["hits"]


# ---------------------------------------------------------------------------
# the float8 KV cache: B4 and B8 reading e4m3 K/V
# ---------------------------------------------------------------------------

E4M3 = torch.float8_e4m3fn


def _e4m3(t):
    return to_e4m3(t.float())


def _close_e4m3(got, want, dtype):
    """The q dtype's bound; in bf16 also the relative error 1e-2 (chip_smoke's
    REL_TOL), since outputs that average many rows of V are small."""
    close(got, want, TOL[dtype])
    if dtype == "bfloat16":
        g, w = got.float(), want.float()
        assert ((g - w).norm() / w.norm()).item() <= 1e-2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 40, 10, 512, 128),
                                   (8, 25, 5, 512, 64),
                                   (2, 8, 8, 300, 128),
                                   (3, 16, 2, 200, 64),
                                   (2, 8, 1, 4096, 128)])
def test_flash_decode_e4m3_kernel(cuda, shape, dtype):
    """B4 with e4m3 K/V beside a bf16 or f32 q against its plain version at
    every block_s of its grid: G 1, 5 and 8, D 64 and 128, ragged valid
    lengths, a ragged last chunk (S = 300, 200); launches counted by K/V
    dtype; two calls bitwise alike."""
    b, hq, hkv, s_len, d = shape
    q, k, v = tensors(cuda, 11, dtype, (b, hq, 1, d), (b, hkv, s_len, d), (b, hkv, s_len, d))
    k, v = _e4m3(k), _e4m3(v)
    valid = torch.from_numpy(np.random.default_rng(12).integers(
        1, s_len + 1, b).astype(np.int32)).to(cuda)
    for cand in decode_tile_candidates(s_len):
        block_s = cand["block_s"]
        before = K.launches_by_dtype("flash_decode").get("float8_e4m3fn", 0)
        got = K.flash_decode(q, k, v, valid_len=valid, block_s=block_s)
        assert K.launches_by_dtype("flash_decode")["float8_e4m3fn"] == before + 1
        assert got.dtype == q.dtype
        _close_e4m3(got, flash_decode_plain(q, k, v, valid_len=valid, block_s=block_s), dtype)
        assert torch.equal(got, K.flash_decode(q, k, v, valid_len=valid, block_s=block_s))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(40, 10, 128), (25, 5, 64), (8, 8, 64)])
def test_paged_flash_decode_e4m3_kernel(cuda, dtype, hq, hkv, d):
    """B8 with e4m3 pools, 5-D and 3-D, against its plain version at every
    block_s of its grid, and bitwise equal to gathering the view and running
    B4 on it at the same chunk size."""
    q, kp, vp, tables, valid = _paged_case(cuda, dtype, hq=hq, hkv=hkv, d=d, pages=280)
    kp, vp = _e4m3(kp), _e4m3(vp)
    bs = 16
    s_len = tables.shape[1] * bs
    for site in ((0, 0), (2, 1)):
        k3 = kp[:, site[0], site[1]].contiguous()
        v3 = vp[:, site[0], site[1]].contiguous()
        rows = paged_rows(tables, bs)
        ck = k3[rows].transpose(1, 2).contiguous()
        cv = v3[rows].transpose(1, 2).contiguous()
        for cand in decode_tile_candidates(s_len, page_size=bs):
            block_s = cand["block_s"]
            before = K.launches_by_dtype("paged_flash_decode").get("float8_e4m3fn", 0)
            got = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs,
                                       layer=site, block_s=block_s)
            assert K.launches_by_dtype("paged_flash_decode")["float8_e4m3fn"] == before + 1
            _close_e4m3(got, paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                                      block_size=bs, layer=site,
                                                      block_s=block_s), dtype)
            assert torch.equal(got, K.paged_flash_decode(q, k3, v3, tables, valid_len=valid,
                                                         block_size=bs, block_s=block_s))
            assert torch.equal(got, K.flash_decode(q, ck, cv, valid_len=valid,
                                                   block_s=page_block_s(s_len, bs, block_s)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_e4m3_nan_bytes_past_valid_never_reach_the_output(cuda, dtype):
    """NaN bytes (0x7f) in every row at or past a slot's valid length -- the
    dense view's tail, and the null page and the freed pages a table points
    at past its allocation -- leave both kernels' outputs bitwise as they
    are with zeros there."""
    b, hq, hkv, s_len, d = 4, 16, 4, 300, 128
    q, k, v = tensors(cuda, 13, dtype, (b, hq, 1, d), (b, hkv, s_len, d), (b, hkv, s_len, d))
    k, v = _e4m3(k), _e4m3(v)
    valid = torch.tensor([1, 77, 256, 300], dtype=torch.int32, device=cuda)
    past = (torch.arange(s_len, device=cuda)[None, :] >= valid[:, None])[:, None, :, None]

    def fill(t, mask, byte):
        return t.view(torch.uint8).masked_fill(mask, byte).view(E4M3)

    for block_s in (64, 256):
        want = K.flash_decode(q, fill(k, past, 0), fill(v, past, 0), valid_len=valid,
                              block_s=block_s)
        got = K.flash_decode(q, fill(k, past, 0x7F), fill(v, past, 0x7F), valid_len=valid,
                             block_s=block_s)
        assert torch.isfinite(got).all() and torch.equal(got, want)
    q, kp, vp, tables, valid = _paged_case(cuda, dtype, b=4, pages=140)
    bs = 16
    kp, vp = _e4m3(kp), _e4m3(vp)
    owned = set(tables.flatten().tolist()) - {0}
    free = torch.tensor([p not in owned for p in range(kp.shape[0] // bs)], device=cuda)
    bad = free.repeat_interleave(bs)
    rows = paged_rows(tables, bs)
    for i in range(tables.shape[0]):   # the rows of a slot's last page past its valid length
        tail = rows[i, int(valid[i]):]
        bad[tail[tail >= bs]] = True
    bad = bad[:, None, None, None, None]
    want = K.paged_flash_decode(q, fill(kp, bad, 0), fill(vp, bad, 0), tables,
                                valid_len=valid, block_size=bs, layer=(1, 1))
    got = K.paged_flash_decode(q, fill(kp, bad, 0x7F), fill(vp, bad, 0x7F), tables,
                               valid_len=valid, block_size=bs, layer=(1, 1))
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_reduced_fp8_engine_on_card_equals_cpu(cuda):
    """The reduced phi3 config (f32) with a float8 cache: the paged engine on
    the card (captured ticks, B8 reading e4m3 pools, 1 launch a layer and
    decode step) serves the CPU engine's tokens from the same weights."""
    cfg = dataclasses.replace(get_config("phi3-medium-14b").reduced(),
                              kv_cache_dtype="float8_e4m3fn")
    params = get_model(cfg).init(0, "cpu")
    outs = {}
    for dev, p in (("cpu", params), ("cuda", to_device(params, cuda))):
        sc = ServeConfig(max_len=32, batch=4, num_blocks=24, prefill_chunk=3)
        eng = PagedServingEngine(cfg, p, sc, eos_id=-1)
        assert eng.kp.dtype == E4M3
        for rid, pr in SERVE_PROMPTS.items():
            eng.submit(pr, rid=rid)
        before = K.launches_by_dtype("paged_flash_decode").get("float8_e4m3fn", 0)
        outs[dev] = eng.run_until_done()
        launched = K.launches_by_dtype("paged_flash_decode").get("float8_e4m3fn", 0) - before
        if dev == "cuda":
            assert launched == cfg.n_layers * eng.stats()["decode_steps"]
    assert outs["cpu"] == outs["cuda"]


def test_dry_run_flops_equal_a_real_step_on_the_card(cuda):
    """Phase 14b at a reduced size: the dry run of a bf16 gemma3 train step
    (2 layers, d 256, 4 x 128 tokens) at world size 1 counts exactly the
    FLOPs the same counter records around the real step on the card (B2
    and B7 launched), with no collective in either."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=2, window_pattern="LG",
                              vocab=2048, d_ff=512, d_model=256, n_heads=4, n_kv_heads=1,
                              head_dim=64)
    shape = InputShape("mini_train", 128, 4, "train")
    opt, tc = adamw(1e-3), TrainConfig(remat=True)
    with dryrun.fake_world(1):
        counts = dryrun.count_step(cfg, shape, make_mesh((1, 1), ("data", "model"), "cuda"),
                                   opt_kind="adamw", tc=tc)
    state = make_train_state(cfg, opt, seed=0, device=cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 128), device=cuda, dtype=torch.int32)}
    K.reset_launch_counts()
    with dryrun.CostCounter() as counter:
        make_train_step(cfg, opt, tc)(state, batch)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    assert counter.flops == counts.flops > 0
    assert counter.records == counts.records == []
    assert launches["fused_mlp_swiglu"] and launches["fused_mlp_swiglu_bwd"]
