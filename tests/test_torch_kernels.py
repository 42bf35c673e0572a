"""The port's kernels (repro_torch.kernels) held against the reference
package on the same inputs.

On the CPU each kernel wrapper runs its plain PyTorch version; it is held
against `repro.kernels.ref` and against the Pallas kernel in interpret mode
(as tests/test_kernels.py runs it), on that file's shapes.  Inputs are made
with numpy from a seed and handed to both packages.  Tolerances are the
reference's (tests/test_kernels.py:25): float32 2e-4, bfloat16 2e-2.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""
import contextlib
import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.fused_mlp import fused_mlp_fwd as pallas_mlp
from repro.kernels.fused_mlp import fused_mlp_swiglu_fwd as pallas_swiglu
from repro.kernels.queue_reduce import queue_reduce as pallas_reduce

from repro_torch import kernels as K
from repro_torch.core.executor import tensor_from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels.fused_mlp import (SMALL_M, fused_mlp_fwd_plain,
                                           fused_mlp_swiglu_fwd_plain, fwd_form)
from repro_torch.kernels.queue_reduce import queue_reduce_plain, sequential_fold

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> dict:
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def arrays(seed: int, dtype: str, *shapes, scale=None):
    """numpy arrays of `dtype` from one seed; weights (scale='fan_in') are
    scaled by 1/sqrt(rows) so every value stays O(1)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        a = rng.standard_normal(shape).astype(np.float32)
        if scale == "fan_in" and i > 0:
            a /= np.sqrt(shape[0])
        out.append(a.astype(DTYPES[dtype][0]))
    return out


def both(a: np.ndarray):
    """(jax array, torch CPU tensor) holding the same values."""
    return jnp.asarray(a), tensor_from_numpy(a, "cpu")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().cpu().numpy()
    return np.asarray(a, np.float32)


def close(got, want, dtype: str):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dtype))


# ---------------------------------------------------------------------------
# fused MLP (B1) and SwiGLU (B2)
# ---------------------------------------------------------------------------

class TestFusedMLP:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("m,d,h,o", [(128, 64, 512, 64),
                                         (256, 128, 1024, 96),
                                         (128, 32, 512, 32)])
    def test_fwd_matches_reference(self, m, d, h, o, dtype):
        x, w1, w2 = arrays(0, dtype, (m, d), (d, h), (h, o), scale="fan_in")
        (jx, tx), (jw1, tw1), (jw2, tw2) = both(x), both(w1), both(w2)
        got = K.fused_mlp_fwd(tx, tw1, tw2, act="gelu")
        close(got, jref.mlp_ref(jx, jw1, jw2, "gelu"), dtype)
        close(got, pallas_mlp(jx, jw1, jw2, act="gelu", block_m=128,
                              block_h=256, interpret=True), dtype)

    @pytest.mark.parametrize("act", ["gelu", "relu", "silu", "identity"])
    def test_activations(self, act):
        x, w1, w2 = arrays(1, "float32", (128, 32), (32, 256), (256, 32),
                           scale="fan_in")
        (jx, tx), (jw1, tw1), (jw2, tw2) = both(x), both(w1), both(w2)
        got = K.fused_mlp_fwd(tx, tw1, tw2, act=act)
        close(got, jref.mlp_ref(jx, jw1, jw2, act), "float32")
        close(got, pallas_mlp(jx, jw1, jw2, act=act, block_m=128,
                              block_h=128, interpret=True), "float32")

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("act", ["silu", "identity"])
    def test_swiglu_matches_reference(self, act, dtype):
        x, wg, wu, wd = arrays(2, dtype, (128, 64), (64, 512), (64, 512),
                               (512, 64), scale="fan_in")
        (jx, tx), (jg, tg), (ju, tu), (jd, td) = map(both, (x, wg, wu, wd))
        got = K.fused_mlp_swiglu_fwd(tx, tg, tu, td, act=act)
        close(got, jref.mlp_swiglu_ref(jx, jg, ju, jd, act=act), dtype)
        close(got, pallas_swiglu(jx, jg, ju, jd, act=act, block_m=128,
                                 block_h=128, interpret=True), dtype)

    def test_ops_leading_batch_dims(self):
        x, w1, w2 = arrays(3, "float32", (4, 32, 64), (64, 256), (256, 64),
                           scale="fan_in")
        (jx, tx), (jw1, tw1), (jw2, tw2) = both(x), both(w1), both(w2)
        got = K.mlp(tx, tw1, tw2)
        want = jref.mlp_ref(jx.reshape(-1, 64), jw1, jw2, "gelu")
        assert got.shape == (4, 32, 64)
        close(got.reshape(-1, 64), want, "float32")
        xs = arrays(4, "float32", (2, 8, 64), (64, 128), (64, 128), (128, 16),
                    scale="fan_in")
        (jx, tx), (jg, tg), (ju, tu), (jd, td) = map(both, xs)
        got = K.mlp_swiglu(tx, tg, tu, td)
        assert got.shape == (2, 8, 16)
        close(got.reshape(-1, 16),
              jref.mlp_swiglu_ref(jx.reshape(-1, 64), jg, ju, jd), "float32")


# ---------------------------------------------------------------------------
# flash attention (B3)
# ---------------------------------------------------------------------------

class TestFlashAttention:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_reference(self, causal, dtype):
        q, k, v = arrays(5, dtype, *[(2, 4, 256, 64)] * 3)
        (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
        got = K.flash_attention(tq, tk, tv, causal=causal)
        close(got, jref.attention_ref(jq, jk, jv, causal=causal), dtype)
        close(got, pallas_attention(jq, jk, jv, causal=causal,
                                    interpret=True), dtype)

    def test_gqa_groups(self):
        q, k, v = arrays(6, "float32", (2, 8, 128, 32), (2, 2, 128, 32),
                         (2, 2, 128, 32))
        (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
        got = K.flash_attention(tq, tk, tv, causal=True)
        close(got, jref.attention_ref(jq, jk, jv, causal=True), "float32")
        close(got, pallas_attention(jq, jk, jv, causal=True, interpret=True),
              "float32")

    @pytest.mark.parametrize("window", [64, 128])
    def test_sliding_window(self, window):
        q, k, v = arrays(7, "float32", *[(1, 2, 256, 32)] * 3)
        (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
        got = K.flash_attention(tq, tk, tv, causal=True, window=window)
        close(got, jref.attention_ref(jq, jk, jv, causal=True, window=window),
              "float32")
        close(got, pallas_attention(jq, jk, jv, causal=True, window=window,
                                    interpret=True), "float32")

    def test_causal_mask_is_start_aligned(self):
        """sq != skv: the kernel's causal mask aligns starts (TPU kernel
        semantics), the oracle's aligns ends -- which is why lowering
        requires sq == skv."""
        q, k, v = arrays(8, "float32", (1, 2, 64, 32), (1, 2, 128, 32),
                         (1, 2, 128, 32))
        (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
        got = K.flash_attention(tq, tk, tv, causal=True)
        close(got, pallas_attention(jq, jk, jv, causal=True, block_q=64,
                                    interpret=True), "float32")
        close(tref.attention_ref(tq, tk, tv, causal=True),
              jref.attention_ref(jq, jk, jv, causal=True), "float32")


# ---------------------------------------------------------------------------
# queue_reduce (B5)
# ---------------------------------------------------------------------------

class TestQueueReduce:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("op", ["sum", "max", "min"])
    def test_matches_reference(self, op, dtype):
        (x,) = arrays(9, dtype, (16, 64, 128))
        jx, tx = both(x)
        got = K.queue_reduce(tx, op=op)
        assert got.dtype == DTYPES[dtype][2]
        close(got, jref.reduce_ref(jx, op), dtype)
        close(got, pallas_reduce(jx, op=op, block_rows=32, interpret=True),
              dtype)
        close(K.reduce(tx, op=op), jref.reduce_ref(jx, op), dtype)

    def test_out_dtype_folds_f32_partials(self):
        (x,) = arrays(10, "float32", (14, 8, 16))
        got = K.queue_reduce(tensor_from_numpy(x, "cpu"),
                             out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        want = x.sum(axis=0).astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# the oracles themselves, and the wrapper rule
# ---------------------------------------------------------------------------

class TestOracles:
    @pytest.mark.parametrize("valid", [None, 300, "per_slot"])
    def test_decode_ref(self, valid):
        q, k, v = arrays(11, "float32", (2, 8, 1, 64), (2, 2, 512, 64),
                         (2, 2, 512, 64))
        (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
        vl = np.array([17, 400]) if valid == "per_slot" else valid
        got = tref.decode_ref(tq, tk, tv, valid_len=vl)
        close(got, jref.decode_ref(jq, jk, jv, valid_len=vl), "float32")

    @pytest.mark.parametrize("window", [None, 48])
    def test_attention_ref_end_aligned(self, window):
        q, k, v = arrays(12, "float32", (1, 4, 32, 16), (1, 2, 96, 16),
                         (1, 2, 96, 16))
        (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
        close(tref.attention_ref(tq, tk, tv, causal=True, window=window),
              jref.attention_ref(jq, jk, jv, causal=True, window=window),
              "float32")

    def test_plain_versions_are_what_cpu_wrappers_run(self):
        x, w1, w2, wu = arrays(13, "float32", (16, 8), (8, 32), (32, 8),
                               (8, 32), scale="fan_in")
        tx, tw1, tw2, twu = (tensor_from_numpy(a, "cpu") for a in (x, w1, w2, wu))
        torch.testing.assert_close(K.fused_mlp_fwd(tx, tw1, tw2, act="relu"),
                                   fused_mlp_fwd_plain(tx, tw1, tw2, "relu"))
        torch.testing.assert_close(K.fused_mlp_swiglu_fwd(tx, tw1, twu, tw2),
                                   fused_mlp_swiglu_fwd_plain(tx, tw1, twu, tw2))
        q = tensor_from_numpy(arrays(14, "float32", (1, 2, 16, 8))[0], "cpu")
        torch.testing.assert_close(K.flash_attention(q, q, q),
                                   flash_attention_plain(q, q, q))
        r = q.reshape(2, 16, 8)
        torch.testing.assert_close(K.queue_reduce(r), queue_reduce_plain(r))

    def test_non_cpu_tensor_never_falls_back(self):
        """A tensor off the CPU launches the kernel or raises: a `meta`
        tensor is neither, so each wrapper raises and counts nothing."""
        K.reset_launch_counts()
        x = torch.empty(64, 32, device="meta")
        w1, w2 = torch.empty(32, 64, device="meta"), torch.empty(64, 32, device="meta")
        q = torch.empty(1, 2, 64, 32, device="meta")
        calls = [lambda: K.fused_mlp_fwd(x, w1, w2),
                 lambda: K.fused_mlp_swiglu_fwd(x, w1, w1, w2),
                 lambda: K.flash_attention(q, q, q),
                 lambda: K.queue_reduce(q[0]),
                 lambda: K.fused_mlp_bwd(x, w1, w2, x),
                 lambda: K.fused_mlp_swiglu_bwd(x, w1, w1, w2, x)]
        for call in calls:
            with pytest.raises(ValueError, match="CUDA device"):
                call()
        assert set(K.launch_counts().values()) == {0}
        assert K.launches_by_rows("fused_mlp_bwd") == {}
        assert K.launches_by_rows("fused_mlp_swiglu_bwd") == {}

    def test_reset_clears_launches_by_form(self, monkeypatch):
        """The forward kernels' counts by form are zeroed with the totals."""
        monkeypatch.setattr(K.fused_mlp_swiglu_fwd, "launches_by_form",
                            {"small_m": 40, "tiled": 2})
        monkeypatch.setattr(K.fused_mlp_swiglu_fwd, "launches", 42)
        assert K.launches_by_form("fused_mlp_swiglu") == {"small_m": 40, "tiled": 2}
        K.reset_launch_counts()
        assert K.launches_by_form("fused_mlp_swiglu") == {}
        assert K.launches_by_form("fused_mlp") == {}
        assert K.launch_counts()["fused_mlp_swiglu"] == 0

    def test_reset_clears_launches_by_rows(self, monkeypatch):
        """The backward kernels' counts by input rows are zeroed with the
        totals."""
        monkeypatch.setattr(K.fused_mlp_bwd, "launches_by_rows", {12000: 36, 3584: 36})
        monkeypatch.setattr(K.fused_mlp_bwd, "launches", 72)
        assert K.launches_by_rows("fused_mlp_bwd") == {12000: 36, 3584: 36}
        K.reset_launch_counts()
        assert K.launches_by_rows("fused_mlp_bwd") == {}
        assert K.launch_counts()["fused_mlp_bwd"] == 0

    def test_build_needs_nvcc_and_hashes_sources(self, monkeypatch):
        names = _build.sources()
        assert names == ["flash_attention", "flash_decode", "fused_mlp",
                         "fused_mlp_bwd", "paged_attention", "queue_reduce"]
        paths = {_build._library_path(n) for n in names}
        assert len(paths) == 6 and all(p.suffix == ".so" for p in paths)
        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.os, "access", lambda *a: False)
        monkeypatch.setattr(_build, "_library_path",
                            lambda n: _build.BUILD_DIR / "missing" / f"{n}.so")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(["queue_reduce"])


@pytest.mark.parametrize("n_blocks,block_s,want", [(160, 256, 2), (1280, 256, 1),
                                                   (10, 256, 2), (10, 16, 1),
                                                   (1, 128, 1)])
def test_decode_splits_cover_the_card(monkeypatch, n_blocks, block_s, want):
    """Blocks per split-K chunk depend on the grid alone (so the dense and
    paged decode kernels split alike): enough for two blocks per SM of a
    132-SM card, at most DECODE_MAX_SPLIT, and at most one per 128 rows of
    the chunk (16 rows for each of a block's 8 warps)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(fa, "_sm_count", lambda device: 132)
    got = fa.decode_splits(torch.device("cuda"), n_blocks, block_s)
    assert got == want and 1 <= got <= fa.DECODE_MAX_SPLIT


@pytest.mark.parametrize("m,form", [(1, "small_m"), (8, "small_m"), (SMALL_M, "small_m"),
                                    (SMALL_M + 1, "tiled"), (8192, "tiled")])
def test_forward_form_follows_rows(m, form):
    """The forward's form is a function of x's rows alone: the small-M form
    up to SMALL_M rows (phi3's 8 decode slots take it), the tiled form
    above; the counter by form follows the same rule."""
    assert fwd_form(m) == form


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("form", ["small_m", "tiled"])
def test_forward_counts_the_form_launched(monkeypatch, gated, form):
    """A forward wrapper counts its launch under the form the launch
    reports, not the one the routing rule would pick for x's rows (8 rows
    here, which the rule sends to the small-M form).  x lies on the meta
    device so that the wrapper takes its launch path with no card."""
    name, fn = (("fused_mlp_swiglu", K.fused_mlp_swiglu_fwd) if gated
                else ("fused_mlp", K.fused_mlp_fwd))
    x, w = torch.empty(8, 16, device="meta"), torch.empty(16, 16, device="meta")
    y = torch.empty(8, 16, device="meta")
    folded = "kernel" if form == "small_m" else None
    monkeypatch.setattr(FM, "_launch", lambda *args, **kw: (y, form, folded))
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_by_form", {})
    monkeypatch.setattr(fn, "launches_by_fold", {})
    got = fn(x, w, w, w) if gated else fn(x, w, w)
    assert got is y
    assert K.launch_counts()[name] == 1
    assert K.launches_by_form(name) == {form: 1}
    assert K.launches_by_fold(name) == ({} if folded is None else {folded: 1})


class _FakeSmall:
    """Stands in for the small-M form's ctypes entry points and queue_reduce
    (csrc/fused_mlp.cu is built only where nvcc and a card exist): the plan
    entry point fills in `plan` and records the widths it was asked for, the
    launch entry point records what `_launch_small` hands it.  x lies on the
    meta device, so `_launch_small` takes its launch path with no card."""

    def __init__(self, monkeypatch, plan):
        self.plans, self.runs, self.folds = [], [], []
        self.stream = 0
        monkeypatch.setattr(FM._build, "cuda_operands",
                            lambda what, *ts: _build.DTYPE_CODES[ts[0].dtype])
        monkeypatch.setattr(FM._build, "stream_of", lambda t: self.stream)
        monkeypatch.setattr(FM.torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(FM, "_fold_workspaces", {})
        FM.small_m_plan.cache_clear()     # the plans below are the fake's

        def plan_fn(*args):
            self.plans.append(args[:5])
            for i, v in enumerate(plan):
                args[5][i] = v

        def tickets_fn(n):
            n._obj.value = 4096 + 2
        monkeypatch.setattr(FM, "_small_kernels",
                            lambda: (plan_fn, lambda *args: self.runs.append(args), tickets_fn))

        def fold(p, op="sum", out_dtype=None):
            self.folds.append((tuple(p.shape), p.dtype, op, out_dtype))
            return torch.empty(p.shape[1:], dtype=out_dtype, device=p.device)
        monkeypatch.setattr(FM, "queue_reduce", fold)


# (plan, dtype): one cluster writes y; bf16 folds its partials in the
# launch; float32 leaves them to queue_reduce
SMALL_PLANS = [(FM.SmallPlan(ht=2, cs=8, nb=8, ds=64, hr_pad=256, fold=0), torch.bfloat16),
               (FM.SmallPlan(ht=10, cs=8, nb=112, ds=640, hr_pad=1280, fold=1), torch.bfloat16),
               (FM.SmallPlan(ht=9, cs=2, nb=126, ds=2560, hr_pad=288, fold=0), torch.float32)]


@pytest.mark.parametrize("plan,dtype", SMALL_PLANS)
@pytest.mark.parametrize("gated", [False, True])
def test_small_m_folds_where_the_plan_says(monkeypatch, plan, dtype, gated):
    """The small-M wrapper calls queue_reduce exactly when the plan leaves
    more than one partial and does not fold them in the launch; it hands
    the launch y (where the launch writes or folds it) and the f32
    partials (where there are any), and counts the launch by where its
    partials were folded.  fold=False leaves the partials unfolded."""
    fake = _FakeSmall(monkeypatch, plan)
    name, fn = (("fused_mlp_swiglu", K.fused_mlp_swiglu_fwd) if gated
                else ("fused_mlp", K.fused_mlp_fwd))
    K.reset_launch_counts()
    x, w1, w2 = _meta((SMALL_M, 64), (64, 1024), (1024, 128), dtype=dtype)
    y = fn(x, w1, w1, w2) if gated else fn(x, w1, w2)
    assert y.shape == (SMALL_M, 128) and y.dtype == dtype
    (run,) = fake.runs
    many, queued = plan.partials > 1, plan.partials > 1 and not plan.fold
    assert (run[4] is None) == queued and (run[5] is None) == (not many)
    assert (run[14] is None) == (queued or not many)    # the fold's workspace
    assert fake.folds == ([((plan.partials, SMALL_M, 128), torch.float32, "sum", dtype)]
                          if queued else [])
    where = "queue_reduce" if queued else "kernel" if many else "none"
    assert K.launches_by_fold(name) == {where: 1}
    assert K.launches_by_form(name) == {"small_m": 1}
    raw = FM.forward_in_form("small_m", x, w1, w1 if gated else None, w2, "silu", fold=False)
    assert fake.runs[1][4] is None if many else fake.runs[1][4] is not None
    assert fake.runs[1][14] is None                    # no fold, no workspace
    assert raw.shape == ((plan.partials, SMALL_M, 128) if many else (SMALL_M, 128))
    assert len(fake.folds) == int(queued)              # fold=False folds nothing
    assert K.launches_by_fold(name) == {where: 1}      # forward_in_form is uncounted
    K.reset_launch_counts()
    assert K.launches_by_fold(name) == {}
    FM.small_m_plan.cache_clear()


@pytest.mark.parametrize("gated", [False, True])
def test_small_m_plan_is_a_function_of_the_widths(monkeypatch, gated):
    """The small-M plan is asked for with the widths alone (bfloat16's
    padded to multiples of 8, as TMA reads them), once per device and
    widths: every row count from 1 to SMALL_M hands the launch the same
    plan array, and the launch gets the padded widths and x's rows."""
    plan = FM.SmallPlan(ht=10, cs=8, nb=112, ds=640, hr_pad=1280, fold=1)
    fake = _FakeSmall(monkeypatch, plan)
    w1, wu, w2 = _meta((60, 1000), (60, 1000), (1000, 50))
    for m in (1, 8, 17, SMALL_M):
        (x,) = _meta((m, 60))
        y = FM.forward_in_form("small_m", x, w1, wu if gated else None, w2, "silu")
        assert y.shape == (m, 50)
    code = _build.DTYPE_CODES[torch.bfloat16]
    assert fake.plans == [(64, 1000, 56, code, int(gated))]
    assert len({id(r[13]) for r in fake.runs}) == 1
    assert [r[6:10] for r in fake.runs] == [(m, 64, 1000, 56) for m in (1, 8, 17, SMALL_M)]
    assert list(fake.runs[0][13]) == list(plan)
    FM.small_m_plan.cache_clear()


def test_small_m_fold_workspace_is_one_per_stream(monkeypatch):
    """The in-launch fold counts on a workspace of the wrapper's: one per
    device and stream, zeroed once and handed to every launch on that
    stream (the launch leaves it zero), another on another stream, so that
    launches on two streams never share tickets."""
    plan = FM.SmallPlan(ht=10, cs=8, nb=112, ds=640, hr_pad=1280, fold=2)
    fake = _FakeSmall(monkeypatch, plan)
    x, w1, w2 = _meta((SMALL_M, 64), (64, 1024), (1024, 128))
    for stream in (7, 7, 9, 7):
        fake.stream = stream
        K.fused_mlp_swiglu_fwd(x, w1, w1, w2)
    spaces = FM._fold_workspaces
    assert sorted(spaces) == [(None, 7), (None, 9)]
    assert all(ws.dtype == torch.int32 and ws.shape == (4096 + 2,) for ws in spaces.values())
    assert [r[15] for r in fake.runs] == [7, 7, 9, 7]
    K.reset_launch_counts()
    FM.small_m_plan.cache_clear()


class _FakeTiled:
    """Stands in for the tiled forward's ctypes entry points and its fold
    (csrc/fused_mlp.cu is built only where nvcc and a card exist): records
    what `_launch` hands them.  x lies on the meta device, so `_launch`
    takes its launch path with no card."""

    def __init__(self, monkeypatch, geometry):
        self.runs, self.folds, self.f32_runs = [], [], []
        monkeypatch.setattr(FM._build, "cuda_operands",
                            lambda what, *ts: _build.DTYPE_CODES[ts[0].dtype])
        monkeypatch.setattr(FM._build, "stream_of", lambda t: 0)
        monkeypatch.setattr(FM.torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(FM, "tiled_geometry", lambda hdim: geometry)
        monkeypatch.setattr(FM, "tiled_resident", lambda device, hdim, gated: 15)
        monkeypatch.setattr(FM, "_tiled_kernels",
                            lambda: (None, None, lambda *args: self.runs.append(args)))
        monkeypatch.setattr(FM, "_kernel", lambda: lambda *args: self.f32_runs.append(args))

        def fold(p, op="sum", out_dtype=None):
            self.folds.append((tuple(p.shape), p.dtype, op, out_dtype))
            return torch.empty(p.shape[1:], dtype=out_dtype, device=p.device)
        monkeypatch.setattr(FM, "queue_reduce", fold)


def _meta(*shapes, dtype=torch.bfloat16):
    return [torch.empty(*s, dtype=dtype, device="meta") for s in shapes]


@pytest.mark.parametrize("partials", [1, 3])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("widths", [(64, 1024, 128), (60, 1000, 50)])
def test_tiled_forward_sizes_partials_by_source(monkeypatch, partials, gated, widths):
    """The bf16 tiled forward allocates exactly the partials the source's
    geometry reports -- y itself (m, Dout padded to 8) in bf16 for one, f32
    (partials, m, Dout8) otherwise -- folds them only when there is more
    than one, pads widths that are not multiples of 8 and slices y back."""
    d, h, o = widths
    o8 = -(-o // 8) * 8
    fake = _FakeTiled(monkeypatch, FM.TiledGeometry(nj=7, cs=8, partials=partials, st=2))
    x, w1, wu, w2 = _meta((130, d), (d, h), (d, h), (h, o))
    y = (K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act="silu") if gated
         else K.fused_mlp_fwd(x, w1, w2, act="gelu"))
    assert y.shape == (130, o) and y.dtype == torch.bfloat16
    assert len(fake.runs) == 1 and not fake.f32_runs
    run = fake.runs[0]
    assert run[5:9] == (130, -(-d // 8) * 8, -(-h // 8) * 8, o8)
    assert run[9] == int(gated) and (run[2] is None) == (not gated)
    assert run[11] == 15                                 # the resident clusters
    if partials == 1:
        assert fake.folds == []
    else:
        assert fake.folds == [((partials, 130, o8), torch.float32, "sum", torch.bfloat16)]
    raw = FM.forward_in_form("tiled", x, w1, wu if gated else None, w2, "silu", fold=False)
    assert raw.shape == ((130, o8) if partials == 1 else (partials, 130, o8))
    assert raw.dtype == (torch.bfloat16 if partials == 1 else torch.float32)


@pytest.mark.parametrize("gated", [False, True])
def test_forward_dtypes_reach_their_own_entry_points(monkeypatch, gated):
    """Above SMALL_M, bfloat16 launches the TMA + wgmma tiled form
    (repro_fused_mlp_tiled) and float32 the SIMT kernel
    (repro_fused_mlp_fwd), one launch each, counted under "tiled"."""
    fake = _FakeTiled(monkeypatch, FM.TiledGeometry(nj=4, cs=1, partials=1, st=5))
    name, fn = (("fused_mlp_swiglu", K.fused_mlp_swiglu_fwd) if gated
                else ("fused_mlp", K.fused_mlp_fwd))
    K.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        x, w1, w2 = _meta((SMALL_M + 1, 64), (64, 256), (256, 64), dtype=dtype)
        fn(x, w1, w1, w2) if gated else fn(x, w1, w2)
    assert len(fake.runs) == 1 and len(fake.f32_runs) == 1
    assert fake.f32_runs[0][9] == _build.DTYPE_CODES[torch.float32]
    assert K.launch_counts()[name] == 2
    assert K.launches_by_form(name) == {"tiled": 2}
    K.reset_launch_counts()


def test_forward_launches_by_rows_are_counted_and_reset(monkeypatch):
    """fused_mlp_fwd counts its launches by x's rows (whisper's encoder and
    decoder blocks run one width at two row counts), and
    reset_launch_counts clears them with the totals."""
    _FakeTiled(monkeypatch, FM.TiledGeometry(nj=6, cs=8, partials=1, st=3))
    K.reset_launch_counts()
    for rows in (1500, 448, 448):
        x, w1, w2 = _meta((rows, 64), (64, 128), (128, 64))
        K.fused_mlp_fwd(x, w1, w2, act="gelu")
    assert K.launches_by_rows("fused_mlp") == {1500: 1, 448: 2}
    assert K.launch_counts()["fused_mlp"] == 3
    K.reset_launch_counts()
    assert K.launches_by_rows("fused_mlp") == {}
    assert K.launches_by_rows("fused_mlp_swiglu") == {}
    assert K.launch_counts()["fused_mlp"] == 0


class _FakeBwd:
    """Stands in for the backward's ctypes entry points and its folds
    (csrc/fused_mlp_bwd.cu is built only where nvcc and a card exist):
    records what `_launch_bwd` hands them.  The operands lie on the meta
    device, so the wrappers take their launch path with no card."""

    def __init__(self, monkeypatch, partials):
        self.wgmma, self.dx, self.dw, self.folds = [], [], [], []
        monkeypatch.setattr(FM._build, "cuda_operands",
                            lambda what, *ts: _build.DTYPE_CODES[ts[0].dtype])
        monkeypatch.setattr(FM._build, "stream_of", lambda t: 0)
        monkeypatch.setattr(FM.torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(FM, "mlp_bwd_partials", lambda m, h: partials)
        monkeypatch.setattr(FM, "swiglu_bwd_partials", lambda m, h: partials)
        monkeypatch.setattr(FM, "_wgmma_bwd_kernel", lambda: lambda *a: self.wgmma.append(a))
        monkeypatch.setattr(FM, "_bwd_kernels", lambda: (lambda *a: self.dx.append(a),
                                                         lambda *a: self.dw.append(a)))

        def fold(p, op="sum", out_dtype=None):
            self.folds.append((tuple(p.shape), p.dtype, op, out_dtype))
            return torch.empty(p.shape[1:], dtype=out_dtype, device=p.device)
        monkeypatch.setattr(FM, "queue_reduce", fold)


def _bwd_call(gated, m, d, h, o, dtype):
    x, w1, wu, w2, dy = _meta((m, d), (d, h), (d, h), (h, o), (m, o), dtype=dtype)
    return (K.fused_mlp_swiglu_bwd(x, w1, wu, w2, dy, act="silu") if gated
            else K.fused_mlp_bwd(x, w1, w2, dy, act="gelu"))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("widths", [(64, 1024, 128), (60, 1000, 50)])
def test_bf16_bwd_sizes_partials_by_source(monkeypatch, gated, widths):
    """The bf16 backward (B6 ungated, B7 gated) launches the TMA + wgmma
    entry point once with widths padded to multiples of 8, allocates
    exactly the partials its source reports (dX (n_dx, m, Din8); dW1 -- and
    dWu -- transposed (n_dw, H8, Din8); dW2 (n_dw, H8, Dout8)), folds each
    with queue_reduce into the operands' dtype, and slices and transposes
    the gradients back to the operands' shapes."""
    d, h, o = widths
    d8, h8, o8 = (-(-n // 8) * 8 for n in widths)
    fake = _FakeBwd(monkeypatch, (3, 2))
    out = _bwd_call(gated, 130, d, h, o, torch.bfloat16)
    assert len(fake.wgmma) == 1 and not fake.dx and not fake.dw
    run = fake.wgmma[0]
    assert run[9:13] == (130, d8, h8, o8)
    assert run[13] == int(gated) and run[14] == FM.ACT_CODES["silu" if gated else "gelu"]
    assert run[15] == 3                                  # both kernels
    assert (run[2] is None) == (not gated) and (run[7] is None) == (not gated)
    want = [((3, 130, d8), torch.float32, "sum", torch.bfloat16)]
    want += [((2, h8, d8), torch.float32, "sum", torch.bfloat16)] * (2 if gated else 1)
    want += [((2, h8, o8), torch.float32, "sum", torch.bfloat16)]
    assert fake.folds == want
    shapes = [(130, d), (d, h)] + [(d, h)] * gated + [(h, o)]
    assert [tuple(t.shape) for t in out] == shapes
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in out)


@pytest.mark.parametrize("parts", [1, 2])
def test_bf16_bwd_parts_return_partials_unfolded(monkeypatch, parts):
    """bwd_bf16(parts=1|2) launches one kernel and returns its f32 partials
    as written, with no fold: (dx, p1, p2) ungated."""
    fake = _FakeBwd(monkeypatch, (4, 6))
    x, w1, w2, dy = _meta((100, 64), (64, 3072), (3072, 64), (100, 64))
    dx, p1, p2 = FM.bwd_bf16(x, w1, None, w2, dy, "gelu", parts=parts)
    assert fake.wgmma[0][15] == parts and not fake.folds
    assert (dx.shape, p1.shape, p2.shape) == ((4, 100, 64), (6, 3072, 64), (6, 3072, 64))
    assert dx.dtype == p1.dtype == p2.dtype == torch.float32


@pytest.mark.parametrize("gated", [False, True])
def test_f32_bwd_keeps_wmma_kernels(monkeypatch, gated):
    """float32 (gated and ungated) still launches repro_fused_mlp_bwd_dx and
    _dw, never the bf16 TMA + wgmma entry point, with partials over hidden
    chunks and row slices of F32_BWD_BLOCK_H / F32_BWD_BLOCK_M."""
    fake = _FakeBwd(monkeypatch, (3, 2))
    out = _bwd_call(gated, 300, 64, 700, 40, torch.float32)
    assert not fake.wgmma and len(fake.dx) == len(fake.dw) == 1
    assert fake.dx[0][10:12] == (_build.DTYPE_CODES[torch.float32], int(gated))
    assert fake.dx[0][13] == FM.F32_BWD_BLOCK_H and fake.dw[0][15] == FM.F32_BWD_BLOCK_M
    n_split, n_ms = -(-700 // FM.F32_BWD_BLOCK_H), -(-300 // FM.F32_BWD_BLOCK_M)
    assert fake.folds[0][0] == (n_split, 300, 64) and fake.folds[1][0] == (n_ms, 64, 700)
    want = [(300, 64), (64, 700)] + [(64, 700)] * gated + [(700, 40)]
    assert [tuple(t.shape) for t in out] == want


def test_card_bwd_never_runs_plain(monkeypatch):
    """A tensor off the CPU never reaches the backward's plain versions (patched
    to raise): both wrappers, both dtypes, launch their kernels and count."""
    def boom(*_, **__):
        raise AssertionError("a plain version ran for a non-CPU operand")

    _FakeBwd(monkeypatch, (1, 1))
    monkeypatch.setattr(FM, "fused_mlp_bwd_plain", boom)
    monkeypatch.setattr(FM, "fused_mlp_swiglu_bwd_plain", boom)
    K.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        for gated in (False, True):
            _bwd_call(gated, 64, 32, 128, 40, dtype)
    assert K.launch_counts()["fused_mlp_bwd"] == K.launch_counts()["fused_mlp_swiglu_bwd"] == 2
    K.reset_launch_counts()


class _FakeReduce:
    """Stands in for queue_reduce's ctypes entry point (csrc/queue_reduce.cu
    is built only where nvcc and a card exist): records what each launch
    hands it."""

    def __init__(self, monkeypatch, sms=132):
        self.runs = []
        QR = importlib.import_module("repro_torch.kernels.queue_reduce")
        monkeypatch.setattr(QR._build, "cuda_operands",
                            lambda what, *ts: _build.DTYPE_CODES[ts[0].dtype])
        monkeypatch.setattr(QR._build, "stream_of", lambda t: 0)
        monkeypatch.setattr(QR._build, "sm_count", lambda device: sms)
        monkeypatch.setattr(QR.torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(QR, "_kernel", lambda: lambda *a: self.runs.append(a))
        monkeypatch.setattr(QR, "queue_reduce_plain", _plain_refused)


def _plain_refused(*_, **__):
    raise AssertionError("a plain version ran for a non-CPU operand")


@pytest.mark.parametrize("shape,dtype,offset", [
    ((63, 8, 5120), torch.float32, 0),       # B2's decode fold: 10 MB
    ((16, 1024, 256), torch.bfloat16, 0),    # the compiler's fan-in
    ((4, 8192, 4096), torch.float32, 0),     # B2's Llama fold: 537 MB
    ((18, 8192, 1152), torch.float32, 0),    # B7's dX partials at gemma3-1b
    ((4, 8192, 4096), torch.float32, 1),     # a base that is not 16-byte aligned
    ((64, 1, 1048579), torch.float32, 0)])   # a payload stride of 4 mod 16 bytes
def test_queue_reduce_hands_entry_point_sizes(monkeypatch, shape, dtype, offset):
    """A non-CPU x of any base and payload stride reaches the one entry
    point (never the plain version) with N, R * C, the dtype and op codes
    and the card's SM count as the host caches it, and counts one launch."""
    fake = _FakeReduce(monkeypatch, sms=132)
    n = int(np.prod(shape))
    x = torch.empty(n + offset, dtype=dtype, device="meta")[offset:].view(shape)
    monkeypatch.setattr(K.queue_reduce, "launches", 0)
    out = K.queue_reduce(x, op="max", out_dtype=torch.bfloat16)
    assert out.shape == shape[1:] and out.dtype == torch.bfloat16
    assert K.queue_reduce.launches == 1
    (run,) = fake.runs
    assert run[2:8] == (shape[0], shape[1] * shape[2], _build.DTYPE_CODES[dtype],
                        _build.DTYPE_CODES[torch.bfloat16], 1, 132)


@pytest.mark.parametrize("shape", [(16, 64, 128), (3, 40, 96), (1, 32, 8)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sequential_fold_is_the_pallas_order(shape, dtype):
    """sequential_fold, the oracle the card's kernel is held to bit for
    bit, equals the TPU kernel (interpret mode: one payload a grid step into
    an f32 accumulator) bit for bit on the same values."""
    (x,) = arrays(15, dtype, shape)
    jx, tx = both(x)
    got = sequential_fold(tx)
    want = np.asarray(pallas_reduce(jx, op="sum", block_rows=8, interpret=True))
    assert got.dtype == DTYPES[dtype][2]
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
