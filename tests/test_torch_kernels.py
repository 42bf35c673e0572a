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
from repro_torch.kernels.fused_mlp import (fused_mlp_fwd_plain,
                                           fused_mlp_swiglu_fwd_plain)
from repro_torch.kernels.queue_reduce import queue_reduce_plain

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
