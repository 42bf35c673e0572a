"""Block-table-native paged-attention decode.

`paged_flash_decode` is `flash_decode` with the dense-view gather pushed
into the kernel's address generation: K/V stay in the serving engine's flat
page pools and each split-K chunk resolves its pages through the slot's
block table.  For a given chunk size the output is bitwise equal to
gathering the view with `rows = table * bs + offset` and running
`flash_decode` on it: both kernels run one chunk function
(csrc/common.cuh `decode_chunk`).

Replaces `repro/kernels/paged_attention.py` `paged_flash_decode` (TPU,
Pallas) with csrc/paged_attention.cu.  A CPU tensor runs the plain version;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import (DECODE_MAX_BLOCK_S, DECODE_MAX_GROUP, count_kv_dtype,
                              decode_allowed, decode_operands, decode_scratch,
                              decode_splits, device_valid, flash_decode_plain,
                              page_block_s)
from .ref import paged_rows


def paged_flash_decode_plain(q, kp, vp, tables, *, valid_len, block_size: int,
                             layer: tuple | None = None,
                             scale: float | None = None,
                             block_s: int | None = None) -> torch.Tensor:
    """The kernel's function in torch ops: gather the view through the
    table, then flash_decode's plain chunk math at the page-aligned chunk
    size."""
    rows = paged_rows(tables, block_size)
    if kp.ndim == 5:
        g_i, a_i = layer
        k, v = kp[rows, g_i, a_i], vp[rows, g_i, a_i]
    else:
        k, v = kp[rows], vp[rows]
    block_s = page_block_s(rows.shape[1], block_size, block_s)
    return flash_decode_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                              valid_len=valid_len, scale=scale,
                              block_s=block_s)


@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function(
        "paged_attention", "repro_paged_decode",
        [v, v, v, v, i, v, v, v, v, v] + [i] * 9
        + [ctypes.c_longlong, ctypes.c_float, i, v])


def paged_flash_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       tables: torch.Tensor, *, valid_len, block_size: int,
                       layer: tuple | None = None, scale: float | None = None,
                       block_s: int | None = None) -> torch.Tensor:
    """Decode attention straight out of the page pools.

    q: (B, Hq, 1, D); kp/vp: flat page pools, either one attention site's
    rows (P, Hkv, D) or the engine's full pools (P, G, A, Hkv, D) with
    `layer=(g, a)` selecting the site, in q's dtype or float8_e4m3fn (the
    float8 KV cache, read in the kernel).  tables: (B, V) physical page ids per
    slot (page p covers pool rows [p*block_size, (p+1)*block_size)); entries
    beyond a slot's allocation point at the null page 0.  valid_len: per-slot
    (B,) position clock (or a python int); positions >= valid are masked.
    On the card, tables and valid_len are int32 tensors on q's device.
    `block_s` is aligned to whole pages by `page_block_s`."""
    _build.refuse_capture("paged_flash_decode", q)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid_len,
                                        block_size=block_size, layer=layer,
                                        scale=scale, block_s=block_s)
    code = decode_operands("paged_flash_decode", q, kp, vp)
    b, hq, _, d = q.shape
    if kp.shape != vp.shape or kp.shape[-1] != d:
        raise ValueError(f"paged_flash_decode: pools {tuple(kp.shape)} / "
                         f"{tuple(vp.shape)} do not fit q {tuple(q.shape)}")
    if kp.ndim == 5:
        if layer is None:
            raise ValueError("paged_flash_decode: 5-D pools need layer=(g, a)")
        g_i, a_i = layer
        _, n_g, n_a, hkv, _ = kp.shape
        if not (0 <= g_i < n_g and 0 <= a_i < n_a):
            raise ValueError(f"paged_flash_decode: layer {layer} outside "
                             f"({n_g}, {n_a})")
        plane_stride, plane_base = n_g * n_a * hkv, (g_i * n_a + a_i) * hkv
    elif kp.ndim == 3 and layer is None:
        hkv = kp.shape[1]
        plane_stride, plane_base = hkv, 0
    else:
        raise ValueError("paged_flash_decode: pools are (P, Hkv, D), or "
                         "(P, G, A, Hkv, D) with layer=(g, a)")
    if hq % hkv or hq // hkv > DECODE_MAX_GROUP:
        raise ValueError(f"paged_flash_decode: Hq={hq} over Hkv={hkv} kv heads "
                         f"(at most {DECODE_MAX_GROUP} per kv head)")
    if (tables.ndim != 2 or tables.shape[0] != b or tables.shape[1] == 0
            or tables.dtype != torch.int32 or tables.device != q.device
            or not tables.is_contiguous()):
        raise ValueError(f"paged_flash_decode: tables must be a contiguous "
                         f"int32 ({b}, V) tensor on {q.device}, got {tables.dtype} "
                         f"{tuple(tables.shape)} on {tables.device}")
    bs, n_table = int(block_size), tables.shape[1]
    block_s = page_block_s(n_table * bs, bs, block_s)
    if block_s > DECODE_MAX_BLOCK_S:
        raise ValueError(f"paged_flash_decode: pages of {bs} rows exceed a "
                         f"{DECODE_MAX_BLOCK_S}-row chunk")
    valid = device_valid("paged_flash_decode", valid_len, b, q.device)
    n_s = n_table * bs // block_s
    n_split = decode_splits(q.device, b * hkv * n_s, block_s)
    o, m, l = decode_scratch(q, hkv, n_s * n_split)
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    decode_allowed("paged_attention", q.device.index, code)
    with torch.cuda.device(q.device):
        _kernel()(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
                  n_table, valid.data_ptr(), o.data_ptr(), m.data_ptr(),
                  l.data_ptr(), out.data_ptr(), b, hkv, hq // hkv, d, bs,
                  block_s, n_split, plane_stride, plane_base, kp.shape[0], scale,
                  code, _build.stream_of(q))
    paged_flash_decode.launches += 1
    count_kv_dtype(paged_flash_decode, kp)
    return out


paged_flash_decode.launches = 0
paged_flash_decode.launches_by_dtype = {}
