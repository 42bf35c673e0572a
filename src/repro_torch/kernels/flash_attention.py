"""Dataflow attention kernels.

`flash_attention`: K/V tiles stream past a running online-softmax state
(m, l, O) -- a 2-deep queue between a QK^T producer stage and a PV consumer
stage.  The (S, S) score matrix never exists in HBM (the BSP baseline writes
it twice).

`flash_decode`: single-token decode split over the KV sequence (Fig 2b):
each chunk of keys emits f32 partials (o, m, l) and `combine_partials`, the
queue_reduce-style final stage, merges them -- reduction-dimension
parallelism that eases the pressure on batch size.

Replace `repro/kernels/flash_attention.py` `flash_attention` and
`flash_decode` + `combine_partials` (TPU, Pallas) with
csrc/flash_attention.cu and csrc/flash_decode.cu.  A CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
# flash_decode / paged_flash_decode limits (csrc/common.cuh DEC_*): query
# heads per kv head, head dim (a multiple of 8), keys per split-K chunk.
DECODE_MAX_GROUP = 8
DECODE_MAX_HEAD_DIM = 256
DECODE_MAX_BLOCK_S = 256
# blocks one chunk may be spread over (DEC_MAX_SPLIT), and the rows each of
# their 8 warps keeps at least
DECODE_MAX_SPLIT = 8
_DECODE_WARP_ROWS = 16


@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function(
        "flash_attention", "repro_flash_attention",
        [v, v, v, v] + [i] * 6 + [ctypes.c_float, i, i, i, v])


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: f32 scores, the causal mask
    start-aligned (query i sees keys <= i), masked scores NEG_INF,
    probabilities rounded to v's dtype before P @ V, a zero normaliser
    read as 1."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if k.shape[1] != hq:
        k = k.repeat_interleave(hq // k.shape[1], dim=1)
        v = v.repeat_interleave(hq // v.shape[1], dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return ((p.to(v.dtype).float() @ v.float()) / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); Hq % Hkv == 0 (query-head
    groups share a kv head), D <= 128."""
    _build.refuse_capture("flash_attention", q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    code = _build.cuda_operands("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q, k, v must be rank-4 and k, v "
                         "of one shape")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not fit (need equal batch and "
                         f"head dim <= {MAX_HEAD_DIM}, Hq % Hkv == 0)")
    scale = scale if scale is not None else d ** -0.5
    dk = d
    misaligned = any(t.data_ptr() % 16 for t in (q, k, v))
    if q.dtype == torch.bfloat16 and (d % 8 or misaligned):
        # TMA reads rows of a multiple of 16 bytes from 16-byte aligned bases
        dk = -(-d // 8) * 8
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel():
        with torch.cuda.device(q.device):
            _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, skv, dk, scale,
                      int(causal), int(window) if window else 0, code,
                      _build.stream_of(q))
        flash_attention.launches += 1
    return out if dk == d else out[..., :d].contiguous()


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# decode: split-K over the KV sequence (Fig 2b)
# ---------------------------------------------------------------------------

def page_block_s(s_len: int, page_size: int, block_s: int | None) -> int:
    """Align a split-K chunk size to page boundaries: the largest multiple of
    `page_size` that is <= min(block_s or 256, s_len) and divides `s_len`
    exactly (s_len is always a whole number of pages, so this terminates at
    `page_size`).  paged_flash_decode chunks own whole pages."""
    want = block_s if block_s is not None else 256
    want = max(page_size, (min(want, s_len) // page_size) * page_size)
    while s_len % want:
        want -= page_size
    return want


def tile_candidates(sq: int, skv: int) -> list[dict]:
    """Autotune grid of flash_attention: its tiles (128 query rows, 128
    keys a stage, two consumer warpgroups) are fixed in the source, so a
    grid of one, the default."""
    return [{}]


def decode_tile_candidates(s_len: int, page_size: int | None = None) -> list[dict]:
    """Autotune grid of the decode kernels' split-K chunk (`block_s`), the
    default first.  flash_decode over s_len keys: chunks of 64, 128 and
    256 keys, a chunk no longer than s_len (the default, min(256, s_len),
    is the longest).  paged_flash_decode (`page_size` given, s_len a whole
    number of pages): 1, 2, 4, ... pages a chunk up to DECODE_MAX_BLOCK_S
    rows, each dividing s_len, so that `page_block_s` keeps it as it is,
    and its default `page_block_s(s_len, page_size, None)`.  The grids
    count rows, so they hold for e4m3 K/V as for bf16 or f32; a tuned
    choice is keyed by the operands' dtypes (core/lower.py `_shape_sig`)."""
    if page_size is None:
        default = min(DECODE_MAX_BLOCK_S, s_len)
        sizes = [default] + [b for b in (64, 128, 256) if b < default]
    else:
        default = page_block_s(s_len, page_size, None)
        sizes, pages = [default], 1
        while pages * page_size <= DECODE_MAX_BLOCK_S:
            if s_len % (pages * page_size) == 0:
                sizes.append(pages * page_size)
            pages *= 2
    return [{"block_s": b} for b in dict.fromkeys(sizes)]


def combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     axis: int = 1) -> torch.Tensor:
    """Merge split-softmax partials: the queue_reduce 'final' stage, in
    torch ops (flash_decode's CUDA path merges with its own kernel).

    o: (..., n_chunks, ..., d) partial weighted sums; m, l: running max /
    sum, with a trailing axis of 1."""
    m_g = m.amax(dim=axis, keepdim=True)
    w = torch.exp(m - m_g)
    l_g = (l * w).sum(dim=axis)
    o_g = (o * w).sum(dim=axis)
    l_g = torch.where(l_g == 0, torch.ones_like(l_g), l_g)
    return o_g / l_g


def _valid_lengths(valid_len, b: int, s_len: int, device) -> torch.Tensor:
    """valid_len (None, an int, a 0-d or a (B,) tensor) as a (B,) int64
    tensor on `device`."""
    if valid_len is None:
        valid_len = s_len
    if isinstance(valid_len, int):
        return torch.full((b,), valid_len, dtype=torch.int64, device=device)
    return valid_len.to(device=device, dtype=torch.int64).reshape(-1).expand(b)


def device_valid(what: str, valid_len, b: int, device) -> torch.Tensor:
    """The decode kernels' valid-length operand: a python int broadcast to
    an int32 (B,) tensor, or an int32 (B,) contiguous tensor on `device`,
    taken as it is.  Anything else raises: the caller converts once per
    decode step, not once per attention site."""
    if isinstance(valid_len, int):
        return torch.full((b,), valid_len, dtype=torch.int32, device=device)
    if not (torch.is_tensor(valid_len) and valid_len.dtype == torch.int32
            and valid_len.shape == (b,) and valid_len.device == device
            and valid_len.is_contiguous()):
        got = (f"{valid_len.dtype} {tuple(valid_len.shape)} on {valid_len.device}"
               if torch.is_tensor(valid_len) else type(valid_len).__name__)
        raise ValueError(f"{what}: valid_len must be an int or an int32 ({b},) "
                         f"tensor on {device}, got {got}")
    return valid_len


def p_dtype(q, v) -> torch.dtype:
    """The dtype the decode kernels round probabilities to before P @ V:
    v's, which is q's, except for float8 K/V, where it stays q's (the
    reference's models decode a float8 cache with P in f32; 3 mantissa bits
    of each probability would be the reference's TPU kernels' rounding)."""
    return q.dtype if v.dtype == _build.KV8 else v.dtype


def decode_partials_plain(q, k, v, valid, block_s: int, scale: float):
    """The chunk kernel's function in torch ops: for each of the
    ceil(S / block_s) chunks (a ragged last chunk padded and masked), f32
    scores times `scale`, positions >= valid scored NEG_INF, m = max,
    p = exp(s - m), l = sum p, o = p (rounded to `p_dtype`) @ v.  K/V may
    be float8_e4m3fn (read as f32).  Returns o (B*Hkv, n_s, G, D), m and l
    (B*Hkv, n_s, G, 1), all f32."""
    b, hq, _, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    g = hq // hkv
    n_s = -(-s_len // block_s)
    pad = n_s * block_s - s_len
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qg = q.reshape(b, hkv, g, d).float()
    kc = k.reshape(b, hkv, n_s, block_s, d).float()
    s = torch.einsum("bhgd,bhcsd->bhcgs", qg, kc) * scale
    pos = torch.arange(n_s * block_s, device=q.device).reshape(n_s, 1, block_s)
    lim = valid.clamp(max=s_len).reshape(b, 1, 1, 1, 1)
    s = torch.where(pos < lim, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhcgs,bhcsd->bhcgd", p.to(p_dtype(q, v)).float(),
                     v.reshape(b, hkv, n_s, block_s, d).float())
    return (o.reshape(b * hkv, n_s, g, d), m.reshape(b * hkv, n_s, g, 1),
            l.reshape(b * hkv, n_s, g, 1))


def flash_decode_plain(q, k, v, *, valid_len=None, scale: float | None = None,
                       block_s: int = 256) -> torch.Tensor:
    """flash_decode's function in torch ops: chunk partials, then
    `combine_partials`, the result in q's dtype."""
    b, hq, _, d = q.shape
    s_len = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    valid = _valid_lengths(valid_len, b, s_len, q.device)
    o, m, l = decode_partials_plain(q, k, v, valid, min(block_s, s_len), scale)
    return combine_partials(o, m, l).reshape(b, hq, 1, d).to(q.dtype)


@functools.cache
def _decode_kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function(
        "flash_decode", "repro_flash_decode",
        [v, v, v, v, i, v, v, v, v] + [i] * 7 + [ctypes.c_float, i, v])


@functools.cache
def decode_allowed(lib: str, device: int, code: int) -> None:
    """Raise the shared-memory limit of decode library `lib`'s kernels
    ("flash_decode" or "paged_attention") for one dtype on one device, once:
    the launches themselves then call no runtime function but the launch,
    as a launch captured into a CUDA graph should."""
    symbol = {"flash_decode": "repro_flash_decode_allow",
              "paged_attention": "repro_paged_decode_allow"}[lib]
    with torch.cuda.device(device):
        _build.kernel_function(lib, symbol, [ctypes.c_int])(code)


def decode_operands(what: str, q, k, v) -> int:
    """`_build.cuda_operands` for q (float32 or bfloat16) and K/V (q's dtype
    or float8_e4m3fn), plus the decode kernels' own limits on q
    (B, Hq, 1, D) and 16-byte aligned operands; returns the pair's code."""
    code = _build.cuda_operands(what, q, kv=(k, v))
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"{what}: q must be (B, Hq, 1, D), got {tuple(q.shape)}")
    d = q.shape[3]
    if d % 8 or not 0 < d <= DECODE_MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8 and "
                         f"<= {DECODE_MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return code


_sm_count = _build.sm_count


def decode_splits(device: torch.device, n_blocks: int, block_s: int) -> int:
    """Blocks each split-K chunk is spread over: enough that a grid of
    `n_blocks` chunks gives every SM of the card two blocks, while each
    block's 8 warps keep at least 16 rows of a full chunk.  A function of
    the grid alone, so the dense and paged kernels split alike."""
    want = -(-2 * _sm_count(device) // n_blocks)
    return max(1, min(want, DECODE_MAX_SPLIT, block_s // (8 * _DECODE_WARP_ROWS)))


def decode_scratch(q, hkv: int, n_part: int):
    """f32 partials (o, m, l) of a split-K decode launch: `n_part` per
    (batch, kv head), chunks times their splits."""
    b, hq, _, d = q.shape
    g = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((b * hkv, n_part, g, d), **f32),
            torch.empty((b * hkv, n_part, g), **f32),
            torch.empty((b * hkv, n_part, g), **f32))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 valid_len=None, scale: float | None = None,
                 block_s: int = 256) -> torch.Tensor:
    """Decode attention: q (B, Hq, 1, D), k/v (B, Hkv, S, D), Hq a multiple
    of Hkv (at most 8 query heads per kv head), D a multiple of 8 up to 256;
    q float32 or bfloat16, k/v q's dtype or float8_e4m3fn (the float8 KV
    cache, read in the kernel: no cast of K/V before the launch).

    The KV sequence is split into chunks of min(block_s, S) <= 256 keys,
    each emitting (o, m, l); a ragged last chunk is masked.  `valid_len`
    masks cache positions >= valid: None (all S), a python int, or a
    per-sequence (B,) tensor (the serving engine's per-slot position clock;
    on the card an int32 tensor on q's device, see `device_valid`; the CPU
    version also takes a 0-d tensor or another integer dtype).
    """
    _build.refuse_capture("flash_decode", q)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, valid_len=valid_len, scale=scale,
                                  block_s=block_s)
    code = decode_operands("flash_decode", q, k, v)
    b, hq, _, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    hkv, s_len = k.shape[1], k.shape[2]
    if hq % hkv or hq // hkv > DECODE_MAX_GROUP or s_len == 0:
        raise ValueError(f"flash_decode: need Hq % Hkv == 0, Hq / Hkv <= "
                         f"{DECODE_MAX_GROUP} and S > 0, got Hq={hq}, "
                         f"Hkv={hkv}, S={s_len}")
    block_s = min(block_s, s_len)
    if not 0 < block_s <= DECODE_MAX_BLOCK_S:
        raise ValueError(f"flash_decode: block_s {block_s} not in "
                         f"(0, {DECODE_MAX_BLOCK_S}]")
    if valid_len is None or isinstance(valid_len, int):
        valid, valid_all = None, s_len if valid_len is None else valid_len
    else:
        valid, valid_all = device_valid("flash_decode", valid_len, b, q.device), 0
    n_s = -(-s_len // block_s)
    n_split = decode_splits(q.device, b * hkv * n_s, block_s)
    o, m, l = decode_scratch(q, hkv, n_s * n_split)
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    decode_allowed("flash_decode", q.device.index, code)
    with torch.cuda.device(q.device):
        _decode_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         None if valid is None else valid.data_ptr(), valid_all,
                         o.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
                         b, hkv, hq // hkv, s_len, d, block_s, n_split, scale, code,
                         _build.stream_of(q))
    flash_decode.launches += 1
    count_kv_dtype(flash_decode, k)
    return out


def count_kv_dtype(kernel, k: torch.Tensor) -> None:
    """A decode launch's count by its K/V dtype ("bfloat16", "float32",
    "float8_e4m3fn"): `kernels.launches_by_dtype`."""
    name = str(k.dtype).removeprefix("torch.")
    kernel.launches_by_dtype[name] = kernel.launches_by_dtype.get(name, 0) + 1


flash_decode.launches = 0
flash_decode.launches_by_dtype = {}
