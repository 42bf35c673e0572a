"""The port's decode kernels (`flash_decode`, `paged_flash_decode`,
`combine_partials`) and the paged-decode traffic model, held against the
reference package on the same numpy-seeded inputs.

On the CPU each wrapper runs its kernel's plain version (chunk partials with
probabilities rounded to V's dtype, merged by `combine_partials`); the
reference runs its Pallas kernels in interpret mode.  Tolerances are the
reference's (tests/test_kernels.py:25): float32 2e-4, bfloat16 2e-2.  The
card-side checks of the CUDA kernels are in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.costmodel import paged_decode_traffic as j_traffic
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import combine_partials as j_combine
from repro.kernels.flash_attention import flash_decode as j_flash_decode
from repro.kernels.flash_attention import page_block_s as j_page_block_s
from repro.kernels.paged_attention import paged_flash_decode as j_paged

from repro_torch import kernels as K
from repro_torch.core.costmodel import paged_decode_traffic
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_decode_plain, page_block_s
from repro_torch.kernels.paged_attention import paged_flash_decode_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def draw(seed, dtype, *shapes):
    """Each shape drawn from one numpy generator, as (jax, torch) pairs of
    `dtype` (both round the same float32 values to bfloat16)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a, jd), torch.from_numpy(a).to(td)))
    return out


def close(got: torch.Tensor, want, tol):
    """allclose against a jax array or a torch tensor, in float32."""
    want = (want.float().numpy() if torch.is_tensor(want)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def valid_args(kind: str, b: int, s_len: int):
    """(reference valid_len, port valid_len) for a static python int, a
    0-d runtime scalar, or a per-slot (B,) vector."""
    if kind == "static":
        return s_len - 5, s_len - 5
    if kind == "scalar":
        return jnp.asarray(s_len - 9, jnp.int32), torch.tensor(s_len - 9)
    v = np.random.default_rng(b).integers(1, s_len + 1, b).astype(np.int32)
    return jnp.asarray(v), torch.from_numpy(v)


class TestFlashDecode:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("valid", ["static", "scalar", "slots"])
    @pytest.mark.parametrize("group", [1, 2, 4])
    def test_matches_pallas(self, group, valid, dtype):
        b, hkv, s_len, d = 2, 2, 64, 16
        (jq, tq), (jk, tk), (jv, tv) = draw(1, dtype, (b, hkv * group, 1, d),
                                            (b, hkv, s_len, d), (b, hkv, s_len, d))
        jvl, tvl = valid_args(valid, b, s_len)
        want = j_flash_decode(jq, jk, jv, valid_len=jvl, block_s=16,
                              interpret=True)
        got = K.flash_decode(tq, tk, tv, valid_len=tvl, block_s=16)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        close(got, want, TOL[dtype])
        assert torch.equal(got, flash_decode_plain(tq, tk, tv, valid_len=tvl,
                                                   block_s=16))

    @pytest.mark.parametrize("s_len,block_s", [(70, 16), (300, 256), (24, 256)])
    def test_ragged_chunks_match_decode_ref(self, s_len, block_s):
        """Lengths that no chunk size divides (the Pallas kernel asserts
        divisibility; the port masks the last chunk) against both oracles."""
        (jq, tq), (jk, tk), (jv, tv) = draw(2, "float32", (3, 8, 1, 32),
                                            (3, 2, s_len, 32), (3, 2, s_len, 32))
        jvl, tvl = valid_args("slots", 3, s_len)
        got = K.flash_decode(tq, tk, tv, valid_len=tvl, block_s=block_s)
        close(got, jref.decode_ref(jq, jk, jv, valid_len=jvl), 2e-4)
        close(got, ref.decode_ref(tq, tk, tv, valid_len=tvl), 2e-4)

    def test_decode_attention_op_matches_reference_op(self):
        (jq, tq), (jk, tk), (jv, tv) = draw(3, "float32", (2, 4, 1, 16),
                                            (2, 2, 40, 16), (2, 2, 40, 16))
        jvl, tvl = valid_args("slots", 2, 40)
        close(K.decode_attention(tq, tk, tv, valid_len=tvl),
              jops.decode_attention(jq, jk, jv, valid_len=jvl), 2e-4)


def paged_case(seed, dtype, *, b=3, v_blocks=4, bs=8, hq=4, hkv=2, d=16,
               pages=16, sites=None):
    """One decode site: pools (3-D, or 5-D with `sites` = (G, A)), tables
    over distinct pages with null-page tails past each slot's allocation
    (as the engine leaves them), ragged valid lengths."""
    pool = (pages * bs, *(sites or ()), hkv, d)
    (jq, tq), (jkp, tkp), (jvp, tvp) = draw(seed, dtype, (b, hq, 1, d), pool, pool)
    rng = np.random.default_rng(seed + 100)
    valid = rng.integers(1, v_blocks * bs + 1, b).astype(np.int32)
    tables = rng.permutation(np.arange(1, pages))[:b * v_blocks].reshape(b, v_blocks)
    tables[np.arange(v_blocks)[None, :] >= -(-valid // bs)[:, None]] = 0
    tables = tables.astype(np.int32)
    return ((jq, jkp, jvp, jnp.asarray(tables), jnp.asarray(valid)),
            (tq, tkp, tvp, torch.from_numpy(tables), torch.from_numpy(valid)))


class TestPagedFlashDecode:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("form", ["3d", "5d"])
    def test_matches_pallas_and_oracles(self, form, dtype):
        sites, layer = ((2, 3), (1, 2)) if form == "5d" else (None, None)
        (jq, jkp, jvp, jt, jvl), (tq, tkp, tvp, tt, tvl) = paged_case(
            4, dtype, sites=sites)
        want = j_paged(jq, jkp, jvp, jt, valid_len=jvl, block_size=8,
                       layer=layer, interpret=True)
        got = K.paged_flash_decode(tq, tkp, tvp, tt, valid_len=tvl,
                                   block_size=8, layer=layer)
        close(got, want, TOL[dtype])
        close(got, jref.paged_decode_ref(jq, jkp, jvp, jt, valid_len=jvl,
                                         block_size=8, layer=layer), TOL[dtype])
        close(got, ref.paged_decode_ref(tq, tkp, tvp, tt, valid_len=tvl,
                                        block_size=8, layer=layer), TOL[dtype])

    @pytest.mark.parametrize("block_s", [8, 16, 32, None])
    def test_bitwise_equals_gather_and_flash_decode(self, block_s):
        """The invariant the card holds the CUDA kernels to, on the plain
        versions: reading through the table equals gathering the view and
        running flash_decode at the same chunk size, bit for bit."""
        _, (tq, tkp, tvp, tt, tvl) = paged_case(5, "float32")
        rows = ref.paged_rows(tt, 8)
        ck, cv = tkp[rows].transpose(1, 2), tvp[rows].transpose(1, 2)
        got = K.paged_flash_decode(tq, tkp, tvp, tt, valid_len=tvl,
                                   block_size=8, block_s=block_s)
        want = K.flash_decode(tq, ck, cv, valid_len=tvl,
                              block_s=page_block_s(ck.shape[2], 8, block_s))
        assert torch.equal(got, want)
        assert torch.equal(got, paged_flash_decode_plain(
            tq, tkp, tvp, tt, valid_len=tvl, block_size=8, block_s=block_s))

    def test_paged_rows_and_op_match_reference(self):
        (jq, jkp, jvp, jt, jvl), (tq, tkp, tvp, tt, tvl) = paged_case(6, "float32")
        np.testing.assert_array_equal(ref.paged_rows(tt, 8).numpy(),
                                      np.asarray(jref.paged_rows(jt, 8)))
        close(K.paged_decode_attention(tq, tkp, tvp, tt, valid_len=tvl, block_size=8),
              jops.paged_decode_attention(jq, jkp, jvp, jt, valid_len=jvl,
                                          block_size=8), 2e-4)


@pytest.mark.parametrize("n_s", [1, 3])
def test_combine_partials_matches_reference(n_s):
    rng = np.random.default_rng(7)
    o = rng.standard_normal((4, n_s, 2, 16)).astype(np.float32)
    m = rng.standard_normal((4, n_s, 2, 1)).astype(np.float32)
    l = rng.uniform(0.5, 3.0, (4, n_s, 2, 1)).astype(np.float32)
    m[0, :] = -1e30                       # a row whose every chunk is masked
    l[1, :] = 0.0                         # a zero normaliser reads as 1
    got = K.combine_partials(torch.from_numpy(o), torch.from_numpy(m),
                             torch.from_numpy(l))
    want = j_combine(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(batch=8, v_blocks=32, block_size=16, n_steps=16, row_bytes=2560, n_sites=40),
    dict(batch=2, v_blocks=3, block_size=8, n_steps=1, row_bytes=128, n_sites=2,
         alloc_blocks=3),
    dict(batch=4, v_blocks=7, block_size=4, n_steps=3, row_bytes=64, n_sites=6,
         alloc_blocks=0)])
def test_paged_decode_traffic_equals_reference(kw):
    assert paged_decode_traffic(**kw) == j_traffic(**kw)


def test_page_block_s_equals_reference():
    for s_len in (8, 24, 64, 96, 512, 4096):
        for page in (1, 8, 16):
            if s_len % page:
                continue
            for want in (None, 8, 16, 100, 256):
                assert (page_block_s(s_len, page, want)
                        == j_page_block_s(s_len, page, want))
