"""Dataflow-fused MLP kernels -- the paper's Fig 2(a) forward and its
Fig 2(c) multicast backward.

    Y = act(X @ W1) @ W2                     (fused_mlp_fwd)
    Y = (act(X @ Wg) * (X @ Wu)) @ Wd        (fused_mlp_swiglu_fwd)
    (dX, dW1, dW2) of the first              (fused_mlp_bwd)
    (dX, dWg, dWu, dWd) of the second        (fused_mlp_swiglu_bwd)

Replace `repro/kernels/fused_mlp.py` `fused_mlp_fwd` and
`fused_mlp_swiglu_fwd` (TPU, Pallas) with csrc/fused_mlp.cu.  The (M, H)
hidden tensor never reaches HBM.  Two forms, chosen by x's rows alone
(`fwd_form`): up to SMALL_M rows (decode) a cluster of blocks shares a
hidden range, each block builds its part of the hidden chunk with the
weights as mma's 16-row operand and the tokens as its 8-wide N, the
cluster exchanges the parts through distributed shared memory and each
block multiplies the whole chunk into its columns of W2; in bfloat16 the
launch also folds the clusters' f32 partials itself (`SmallPlan.fold`),
float32 leaves them to `queue_reduce`.  Above SMALL_M,
bfloat16 runs the tiled form on TMA + wgmma: a block builds t = act(x @ wg)
* (x @ wu) for 128 rows and a chunk of up to 448 hidden columns into
shared memory and multiplies it into 128-column tiles of y, which a cluster
of 8 blocks over consecutive chunks folds through distributed shared
memory.  Its geometry is a function of the hidden width alone
(`tiled_geometry`): H <= 448 takes one block and writes y itself; wider,
one f32 partial per cluster (2 at gemma3-1b's 6912, 4 at Llama's 14336).
float32 runs a SIMT kernel (FMA), one f32 partial per hidden chunk of
F32_BLOCK_H.  Partials are folded by `queue_reduce` into the output dtype;
the csrc header counts their bytes.

The backward kernels (csrc/fused_mlp_bwd.cu) replace `fused_mlp_bwd` and
`fused_mlp_swiglu_bwd` the same way: the hidden tiles are recomputed from X,
dY and the weights into shared memory; dX comes out as f32 partials over
hidden chunks, each dW as f32 partials over row slices, and `queue_reduce`
folds both in a fixed order.  bfloat16 (both forms) runs on TMA and wgmma
with 128-row tiles, and a cluster of blocks sums its partials over
distributed shared memory before writing them (`swiglu_bwd_partials`,
`mlp_bwd_partials`); float32 runs WMMA kernels.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, ref
from .queue_reduce import queue_reduce

ACT_CODES = {"identity": 0, "relu": 1, "gelu": 2, "silu": 3}

# float32's hidden chunk per block (the SIMT kernel): its 64 rows of it
# fit in shared memory beside the 3-stage staging tiles (191 KB of the
# 227 KB a block may use).  bfloat16's chunks are the tiled form's own
# (`tiled_geometry`).
F32_BLOCK_H = 256

# Rows at or below which the forward runs its small-M form (csrc/fused_mlp.cu
# `small_m_kernel`: the weights as mma's 16-row operand, the token rows as
# its 8-wide N, one cluster per hidden range); above it, the 128-row tiled
# form.  64 is the form's capacity: on the H100 it is faster than the tiled
# form at every M it takes (PERF.md, the crossover at phi3 widths;
# chip_smoke.py phase 3 fails if that stops holding).
SMALL_M = 64


def fwd_form(m: int) -> str:
    """Which forward form serves x with m rows: "small_m" or "tiled"."""
    return "small_m" if m <= SMALL_M else "tiled"

# The kernels' function in plain torch ops (the oracles hold the same math:
# f32 products, the hidden tile rounded to x's dtype before the second GEMM).
fused_mlp_fwd_plain = ref.mlp_ref
fused_mlp_swiglu_fwd_plain = ref.mlp_swiglu_ref
fused_mlp_bwd_plain = ref.mlp_bwd_ref
fused_mlp_swiglu_bwd_plain = ref.mlp_swiglu_bwd_ref

# float32 backward tiles (the WMMA kernels): the dX kernel's hidden chunk
# (its 64 rows of da, or of dg and du, sit in shared memory beside the
# staging ring) and the dW kernel's row slice (t and da, or t, dg and du,
# for that many rows of a 64-wide hidden chunk).  bfloat16's tiles are the
# TMA + wgmma kernels' own (`mlp_bwd_partials`, `swiglu_bwd_partials`).
F32_BWD_BLOCK_H = 128
F32_BWD_BLOCK_M = 128

# The float32 kernels' shared memory, as their sources lay it out
# (csrc/fused_mlp.cu `MlpSmem<float>`, csrc/fused_mlp_bwd.cu
# `BwdSmem<float>`), against the 227 KB a block may use: a tile whose
# layout does not fit is no legal launch, so no grid holds it.
_SMEM_MAX = 232448
_F32_PAD = 4                     # Pad<float>: 16 bytes of padding per row


def _align128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def f32_fwd_smem(block_h: int, gated: bool) -> int:
    """Bytes of shared memory the f32 forward takes at hidden chunk
    block_h: the 64-row hidden chunk, then 3 staging slots of (X tile
    64 x 32, W tile 32 x 128[, Wu tile]) or the f32 epilogue tile."""
    xb = _align128(64 * (32 + _F32_PAD) * 4)
    wb = _align128(32 * (128 + _F32_PAD) * 4)
    staging = 3 * (xb + wb + (wb if gated else 0))
    return _align128(64 * (block_h + _F32_PAD) * 4) + max(
        staging, _align128(64 * (128 + 4) * 4))


def f32_bwd_smem(rows: int, cols: int, gated: bool, dw: bool) -> int:
    """Bytes of shared memory the f32 backward takes: the dX kernel's
    (rows 64, cols = its hidden chunk, one chunk per hidden operand) or
    the dW kernel's (rows = its row slice, cols 64, t beside them), then 2
    staging slots or the f32 epilogue tile."""
    chunks = (3 if gated else 2) if dw else (2 if gated else 1)
    ring = chunks * _align128(rows * (cols + _F32_PAD) * 4)
    a = _align128(max(64 * (32 + _F32_PAD), 32 * (128 + _F32_PAD)) * 4)
    b = _align128(max(32 * (128 + _F32_PAD), 128 * (32 + _F32_PAD)) * 4)
    staging = 2 * (a + b + (b if gated else 0))
    return ring + max(staging, _align128(128 * (64 + 4) * 4))


def tile_candidates(m: int, hdim: int, dtype: str, *, gated: bool,
                    backward: bool = False) -> list[dict]:
    """Autotune grid of a fused-MLP site with m rows, hidden width hdim and
    dtype ("float32", "bfloat16", ...): every candidate a launch the
    wrapper takes, the default first.  Only the float32 forms take a tile
    at run time: the forward's hidden chunk (a multiple of 128 up to
    F32_BLOCK_H, above SMALL_M rows) and the backward's dX hidden chunk
    (multiples of 128 up to 256) and dW row slice (multiples of 64 up to
    256), each where its shared memory fits.  The bf16 forms' and the
    small-M form's geometry is fixed by the widths in the source: a grid
    of one, the default."""
    h128, m64 = -(-hdim // 128) * 128, -(-m // 64) * 64
    if dtype != "float32" or (not backward and m <= SMALL_M):
        return [{}]
    if not backward:
        default = min(F32_BLOCK_H, h128)
        return [{"f32_block_h": bh} for bh in
                dict.fromkeys([default, *range(128, F32_BLOCK_H + 1, 128)])
                if bh <= h128 and f32_fwd_smem(bh, gated) <= _SMEM_MAX]
    default_h = min(F32_BWD_BLOCK_H, h128)
    hs = [bh for bh in dict.fromkeys([default_h, 128, 256])
          if bh <= h128 and f32_bwd_smem(64, bh, gated, dw=False) <= _SMEM_MAX]
    ms = [bm for bm in dict.fromkeys([F32_BWD_BLOCK_M, 64, 128, 192, 256])
          if (bm <= m64 or bm == F32_BWD_BLOCK_M)
          and f32_bwd_smem(bm, 64, gated, dw=True) <= _SMEM_MAX]
    return [{"f32_bwd_block_h": bh, "f32_bwd_block_m": bm} for bh in hs for bm in ms]

@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function("fused_mlp", "repro_fused_mlp_fwd",
                                  [v, v, v, v, v] + [i] * 9 + [v])


@functools.cache
def _tiled_kernels():
    v, i, p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    geometry = _build.kernel_function("fused_mlp", "repro_fused_mlp_tiled_geometry", [i, p])
    resident = _build.kernel_function("fused_mlp", "repro_fused_mlp_tiled_resident",
                                      [i, i, p])
    run = _build.kernel_function("fused_mlp", "repro_fused_mlp_tiled",
                                 [v] * 5 + [i] * 7 + [v])
    return geometry, resident, run


class TiledGeometry(NamedTuple):
    """The tiled bf16 form's geometry for one hidden width, as its source
    (csrc/fused_mlp.cu `tiled_geometry`) computes it from the width alone:
    64-wide hidden sub-chunks per block, blocks per cluster, the f32
    partials it leaves for queue_reduce (1: it writes y itself), and its
    ring's stages."""
    nj: int
    cs: int
    partials: int
    st: int


@functools.cache
def tiled_geometry(hdim: int) -> TiledGeometry:
    """The tiled bf16 form's geometry at hidden width hdim (padded to a
    multiple of 8, as the launch pads it)."""
    geo = (ctypes.c_int * 4)()
    _tiled_kernels()[0](-(-hdim // 8) * 8, geo)
    return TiledGeometry(*geo)


@functools.cache
def tiled_resident(device: int, hdim: int, gated: bool) -> int:
    """Clusters of the tiled bf16 form resident on a device at once (the
    persistent grid's size) at hidden width hdim; asking the source also
    allows the kernel its shared memory there."""
    n = ctypes.c_int()
    with torch.cuda.device(device):
        _tiled_kernels()[1](-(-hdim // 8) * 8, int(gated), ctypes.byref(n))
    return n.value


@functools.cache
def _small_kernels():
    v, i, p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    plan = _build.kernel_function("fused_mlp", "repro_fused_mlp_small_plan",
                                  [i] * 5 + [p])
    run = _build.kernel_function("fused_mlp", "repro_fused_mlp_small",
                                 [v] * 6 + [i] * 7 + [p, v, v])
    tickets = _build.kernel_function("fused_mlp", "repro_fused_mlp_small_tickets", [p])
    return plan, run, tickets


_fold_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def _fold_workspace(x: torch.Tensor) -> torch.Tensor:
    """The small-M form's in-launch fold workspace for launches on x's
    current stream: its tickets are zero between launches (the launch that
    used them resets them), and each stream has its own, so launches on two
    streams that run at once never count on each other's.  A CUDA graph
    keeps the workspace of the stream it was captured on."""
    key = (x.device.index, _build.stream_of(x))
    ws = _fold_workspaces.get(key)
    if ws is None:
        n = ctypes.c_int()
        _small_kernels()[2](ctypes.byref(n))
        ws = _fold_workspaces[key] = torch.zeros(n.value, dtype=torch.int32, device=x.device)
    return ws


class SmallPlan(NamedTuple):
    """The small-M form's launch geometry for one set of widths on one
    device (csrc/fused_mlp.cu `small_plan`): hidden tiles per block, blocks
    per cluster, blocks, output columns per member, padded hidden range,
    and where its partials are folded -- 0: by queue_reduce (float32); 1: in
    the launch, each output tile by the block that brought its last
    partial; 2: in the launch, shared over the grid (bfloat16)."""
    ht: int
    cs: int
    nb: int
    ds: int
    hr_pad: int
    fold: int

    @property
    def partials(self) -> int:
        """The f32 partials the launch writes, one per cluster (1: it
        writes y itself); with `fold` it sums them into y too, else they
        are left for queue_reduce."""
        return self.nb // self.cs


@functools.cache
def small_m_plan(device: int, d_in: int, hdim: int, d_out: int, code: int,
                 gated: bool) -> tuple[SmallPlan, ctypes.Array]:
    """The small-M form's plan on a device, and the same six ints as the
    array each launch hands back: a function of the widths (bfloat16's
    padded to multiples of 8, as `_launch_small` pads them), never of M.
    Asking the source also sets the form's shared-memory limit there."""
    arr = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _small_kernels()[0](d_in, hdim, d_out, code, int(gated), arr)
    return SmallPlan(*arr), arr


@functools.cache
def _bwd_partials_fns():
    p = ctypes.POINTER(ctypes.c_int)
    return {gated: _build.kernel_function("fused_mlp_bwd", symbol, [ctypes.c_int] * 2 + [p, p])
            for gated, symbol in ((True, "repro_swiglu_bwd_partials"),
                                  (False, "repro_mlp_bwd_partials"))}


def _bwd_partials(m: int, hdim: int, gated: bool) -> tuple[int, int]:
    n_dx, n_dw = ctypes.c_int(), ctypes.c_int()
    _bwd_partials_fns()[gated](m, -(-hdim // 8) * 8, ctypes.byref(n_dx), ctypes.byref(n_dw))
    return n_dx.value, n_dw.value


def swiglu_bwd_partials(m: int, hdim: int) -> tuple[int, int]:
    """(dX partials, dW partials) the gated bf16 backward writes at m rows
    and hidden width hdim, as its source counts them: one per cluster of
    hidden chunks, one per cluster of row spans."""
    return _bwd_partials(m, hdim, True)


def mlp_bwd_partials(m: int, hdim: int) -> tuple[int, int]:
    """The same for the ungated bf16 backward, whose dX chunks are twice
    as wide (it keeps one hidden tensor on chip where the gated form keeps
    two): half the dX partials, the same dW partials."""
    return _bwd_partials(m, hdim, False)


@functools.cache
def _bwd_kernels():
    v, i = ctypes.c_void_p, ctypes.c_int
    dx = _build.kernel_function("fused_mlp_bwd", "repro_fused_mlp_bwd_dx",
                                [v] * 6 + [i] * 8 + [v])
    dw = _build.kernel_function("fused_mlp_bwd", "repro_fused_mlp_bwd_dw",
                                [v] * 8 + [i] * 8 + [v])
    return dx, dw


def _check(what: str, x, w1, wu, w2, act: str, dy=None):
    """Validate the operands of a fused-MLP kernel; returns the dtype code
    and (M, Din, H, Dout)."""
    ws = (w1, w2) if wu is None else (w1, wu, w2)
    extra = () if dy is None else (dy,)
    code = _build.cuda_operands(what, x, *ws, *extra)
    if act not in ACT_CODES:
        raise ValueError(f"{what}: act {act!r} has no kernel implementation")
    if x.ndim != 2 or any(w.ndim != 2 for w in ws + extra):
        raise ValueError(f"{what}: x, weights and dy must be 2-D")
    m, d_in = x.shape
    hdim, d_out = w1.shape[1], w2.shape[1]
    if (w1.shape[0] != d_in or w2.shape[0] != hdim
            or (wu is not None and wu.shape != w1.shape)
            or (dy is not None and dy.shape != (m, d_out))):
        raise ValueError(f"{what}: shapes do not chain: x {tuple(x.shape)}, "
                         f"weights {[tuple(w.shape) for w in ws]}"
                         + ("" if dy is None else f", dy {tuple(dy.shape)}"))
    if min(m, d_in, hdim, d_out) == 0:
        raise ValueError(f"{what}: empty operand")
    return code, (m, d_in, hdim, d_out)


def _launch_small(x, w1, wu, w2, act: str, code: int, dims, fold: bool = True):
    """The small-M form: (y, where its f32 partials were folded -- "kernel"
    in the launch, "queue_reduce", or "none" where the launch wrote y
    itself).  fold=False returns the partials as the launch wrote them,
    unfolded, where it leaves more than one.  bfloat16 widths that are not
    multiples of 8 are zero-padded for TMA and y sliced back."""
    m, d_in, hdim, d_out = dims
    if x.dtype == torch.bfloat16:
        d_in, hdim, d_out = (-(-n // 8) * 8 for n in dims[1:])
        x, w1, w2 = _padded(x, m, d_in), _padded(w1, d_in, hdim), _padded(w2, hdim, d_out)
        wu = None if wu is None else _padded(wu, d_in, hdim)
    plan, arr = small_m_plan(x.device.index, d_in, hdim, d_out, code, wu is not None)
    many = plan.partials > 1
    in_kernel = many and fold and bool(plan.fold)
    y = (torch.empty((m, d_out), dtype=x.dtype, device=x.device)
         if not many or in_kernel else None)
    part = (torch.empty((plan.partials, m, d_out), dtype=torch.float32, device=x.device)
            if many else None)
    tickets = _fold_workspace(x).data_ptr() if in_kernel else None
    with torch.cuda.device(x.device):
        _small_kernels()[1](x.data_ptr(), w1.data_ptr(),
                            None if wu is None else wu.data_ptr(), w2.data_ptr(),
                            None if y is None else y.data_ptr(),
                            None if part is None else part.data_ptr(), m, d_in, hdim, d_out,
                            code, int(wu is not None), ACT_CODES[act], arr, tickets,
                            _build.stream_of(x))
    if many and not fold:
        return part, "none"
    where = "kernel" if in_kernel else "none"
    if y is None:
        y, where = queue_reduce(part, op="sum", out_dtype=x.dtype), "queue_reduce"
    return (y if d_out == dims[3] else y[:, :dims[3]].contiguous()), where


def forward_in_form(form: str, x, w1, wu, w2, act: str, fold: bool = True):
    """The forward kernel in the given form ("small_m", which takes at most
    SMALL_M rows, or "tiled"), uncounted: phase 3 of chip_smoke.py times
    the two forms against each other with it.  wu None is the ungated MLP.
    fold=False returns the kernel's output as it wrote it: its f32
    partials, or y where it leaves one (padded to widths of 8 in the
    bfloat16 tiled form); the small-M form in bfloat16 then leaves its
    partials unfolded instead of folding them in the launch."""
    what = "fused_mlp" if wu is None else "fused_mlp_swiglu"
    return _launch(what, x, w1, wu, w2, act, form, fold)[0]


def _launch_f32(x, w1, wu, w2, act: str, code: int, dims, block_h: int = F32_BLOCK_H):
    """The SIMT kernel (float32): hidden chunks of block_h (a multiple of
    128, cut to the hidden width), one f32 partial each."""
    m, d_in, hdim, d_out = dims
    bh = min(block_h, -(-hdim // 128) * 128)
    n_split = -(-hdim // bh)
    if n_split == 1:
        out = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((n_split, m, d_out), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _kernel()(x.data_ptr(), w1.data_ptr(), None if wu is None else wu.data_ptr(),
                  w2.data_ptr(), out.data_ptr(), m, d_in, hdim, d_out, code,
                  int(wu is not None), ACT_CODES[act], bh, int(n_split == 1),
                  _build.stream_of(x))
    return out if n_split == 1 else queue_reduce(out, op="sum", out_dtype=x.dtype)


def _launch_tiled(x, w1, wu, w2, act: str, dims, fold: bool = True):
    """The tiled bfloat16 form (TMA + wgmma): operands zero-padded to widths
    of 8 where TMA cannot read them as they are, buffers sized by the
    source's geometry, its partials folded only where it leaves more than
    one."""
    m, d_in, hdim, d_out = dims
    d8, h8, o8 = (-(-n // 8) * 8 for n in (d_in, hdim, d_out))
    xp, w1p, w2p = _padded(x, m, d8), _padded(w1, d8, h8), _padded(w2, h8, o8)
    wup = None if wu is None else _padded(wu, d8, h8)
    geo = tiled_geometry(h8)
    clusters = tiled_resident(x.device.index, h8, wu is not None)
    if geo.partials == 1:
        out = torch.empty((m, o8), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((geo.partials, m, o8), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _tiled_kernels()[2](xp.data_ptr(), w1p.data_ptr(),
                            None if wup is None else wup.data_ptr(), w2p.data_ptr(),
                            out.data_ptr(), m, d8, h8, o8, int(wu is not None),
                            ACT_CODES[act], clusters, _build.stream_of(x))
    if not fold:
        return out
    if geo.partials > 1:
        out = queue_reduce(out, op="sum", out_dtype=x.dtype)
    return out if o8 == d_out else out[:, :d_out].contiguous()


def _launch(what: str, x, w1, wu, w2, act: str, form: str | None = None,
            fold: bool = True, f32_block_h: int = F32_BLOCK_H):
    """(y, the form that computed it, where the small-M form's partials were
    folded: "kernel", "queue_reduce" or "none"; None for the tiled form)."""
    code, dims = _check(what, x, w1, wu, w2, act)
    form = form or fwd_form(dims[0])
    if form == "small_m":
        if dims[0] > SMALL_M:
            raise ValueError(f"{what}: the small-M form takes at most {SMALL_M} rows")
        y, where = _launch_small(x, w1, wu, w2, act, code, dims, fold)
        return y, "small_m", where
    if x.dtype == torch.float32:
        if not fold:
            raise ValueError("fold=False is the small-M and bfloat16 tiled forms'")
        return _launch_f32(x, w1, wu, w2, act, code, dims, f32_block_h), "tiled", None
    return _launch_tiled(x, w1, wu, w2, act, dims, fold), "tiled", None


def _count_fwd(fn, form: str, x, folded: str | None) -> None:
    """One launch of a forward wrapper's kernel, counted in total, by the
    form `_launch` launched, by x's rows (whisper's encoder and decoder run
    one width at two row counts) and, for the small-M form, by where its
    partials were folded (`_launch_small`)."""
    fn.launches += 1
    fn.launches_by_form[form] = fn.launches_by_form.get(form, 0) + 1
    fn.launches_by_rows[x.shape[0]] = fn.launches_by_rows.get(x.shape[0], 0) + 1
    if folded is not None:
        fn.launches_by_fold[folded] = fn.launches_by_fold.get(folded, 0) + 1


def fused_mlp_fwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
                  act: str = "gelu", f32_block_h: int = F32_BLOCK_H) -> torch.Tensor:
    """act(x @ w1) @ w2 for 2-D x, the hidden tensor kept on chip.
    f32_block_h: the float32 tiled form's hidden chunk (`tile_candidates`)."""
    _build.refuse_capture("fused_mlp_fwd", x)
    if x.device.type == "cpu":
        return fused_mlp_fwd_plain(x, w1, w2, act)
    y, form, folded = _launch("fused_mlp", x, w1, None, w2, act, f32_block_h=f32_block_h)
    _count_fwd(fused_mlp_fwd, form, x, folded)
    return y


def fused_mlp_swiglu_fwd(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                         wd: torch.Tensor, *, act: str = "silu",
                         f32_block_h: int = F32_BLOCK_H) -> torch.Tensor:
    """(act(x @ wg) * (x @ wu)) @ wd -- SwiGLU with act=silu; the builder
    graphs' plain gate*up form lowers here with act=identity."""
    _build.refuse_capture("fused_mlp_swiglu_fwd", x)
    if x.device.type == "cpu":
        return fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, act)
    y, form, folded = _launch("fused_mlp_swiglu", x, wg, wu, wd, act,
                              f32_block_h=f32_block_h)
    _count_fwd(fused_mlp_swiglu_fwd, form, x, folded)
    return y


@functools.cache
def _wgmma_bwd_kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel_function("fused_mlp_bwd", "repro_mlp_bwd_wgmma",
                                  [v] * 9 + [i] * 7 + [v])


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t itself where TMA can read it (the shape wanted, 16-byte aligned),
    else a zero-padded copy: zero rows and columns of the operands add
    nothing to any gradient."""
    if t.shape == (rows, cols) and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def bwd_bf16(x, w1, wu, w2, dy, act: str, parts: int = 3):
    """(dx, dw1[, dwu], dw2) of the bf16 backward -- ungated where wu is
    None (B6), gated otherwise (B7) -- on the TMA + wgmma kernels, then the
    folds, uncounted (fused_mlp_bwd and fused_mlp_swiglu_bwd count their
    calls).  Widths that are not multiples of 8 are zero-padded for TMA and
    sliced back off; dW1 (dWg, dWu) comes back from its transposed (H, Din)
    partial.  parts 1 or 2 launches only the dX or only the dW kernel and
    returns the f32 partials (dx, p1[, pu], p2) unfolded: chip_smoke.py
    times the two kernels apart with it."""
    gated = wu is not None
    (m, d_in), hdim, d_out = x.shape, w1.shape[1], w2.shape[1]
    d8, h8, o8 = (-(-n // 8) * 8 for n in (d_in, hdim, d_out))
    xp, dyp = _padded(x, m, d8), _padded(dy, m, o8)
    w1p, w2p = _padded(w1, d8, h8), _padded(w2, h8, o8)
    wup = _padded(wu, d8, h8) if gated else None
    n_dx, n_dw = (swiglu_bwd_partials if gated else mlp_bwd_partials)(m, hdim)
    dev, f32 = x.device, torch.float32
    dx = torch.empty((n_dx, m, d8), dtype=f32, device=dev)
    p1 = torch.empty((n_dw, h8, d8), dtype=f32, device=dev)
    pu = torch.empty((n_dw, h8, d8), dtype=f32, device=dev) if gated else None
    p2 = torch.empty((n_dw, h8, o8), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _wgmma_bwd_kernel()(xp.data_ptr(), w1p.data_ptr(), wup.data_ptr() if gated else None,
                            w2p.data_ptr(), dyp.data_ptr(), dx.data_ptr(), p1.data_ptr(),
                            pu.data_ptr() if gated else None, p2.data_ptr(), m, d8, h8, o8,
                            int(gated), ACT_CODES[act], parts, _build.stream_of(x))
    p_in = (p1, pu) if gated else (p1,)
    if parts != 3:
        return (dx, *p_in, p2)
    dx = queue_reduce(dx, op="sum", out_dtype=x.dtype)[:, :d_in]
    dw_in = [queue_reduce(p, op="sum", out_dtype=w1.dtype)[:hdim, :d_in].t() for p in p_in]
    dw2 = queue_reduce(p2, op="sum", out_dtype=w2.dtype)[:hdim, :d_out]
    return tuple(t.contiguous() for t in (dx, *dw_in, dw2))


def _launch_bwd(what: str, x, w1, wu, w2, dy, act: str,
                block_h: int = F32_BWD_BLOCK_H, block_m: int = F32_BWD_BLOCK_M):
    """(dx, dw1[, dwu], dw2): both backward kernels, then the folds.
    block_h / block_m: the float32 dX kernel's hidden chunk (a multiple of
    128, cut to the hidden width) and the dW kernel's row slice (a
    multiple of 64)."""
    code, (m, d_in, hdim, d_out) = _check(what, x, w1, wu, w2, act, dy)
    if x.dtype == torch.bfloat16:
        return bwd_bf16(x, w1, wu, w2, dy, act)
    # float32: the WMMA kernels
    gated = wu is not None
    dev, f32 = x.device, torch.float32
    bh = min(block_h, -(-hdim // 128) * 128)
    n_split = -(-hdim // bh)
    n_ms = -(-m // block_m)
    dx = torch.empty((n_split, m, d_in), dtype=f32, device=dev)
    p1 = torch.empty((n_ms, d_in, hdim), dtype=f32, device=dev)
    pu = torch.empty((n_ms, d_in, hdim), dtype=f32, device=dev) if gated else None
    p2 = torch.empty((n_ms, hdim, d_out), dtype=f32, device=dev)
    wu_ptr = wu.data_ptr() if gated else None
    k_dx, k_dw = _bwd_kernels()
    stream = _build.stream_of(x)
    with torch.cuda.device(dev):
        k_dx(x.data_ptr(), w1.data_ptr(), wu_ptr, w2.data_ptr(), dy.data_ptr(),
             dx.data_ptr(), m, d_in, hdim, d_out, code, int(gated),
             ACT_CODES[act], bh, stream)
        k_dw(x.data_ptr(), w1.data_ptr(), wu_ptr, w2.data_ptr(), dy.data_ptr(),
             p1.data_ptr(), None if pu is None else pu.data_ptr(), p2.data_ptr(),
             m, d_in, hdim, d_out, code, int(gated), ACT_CODES[act],
             block_m, stream)
    dx = queue_reduce(dx, op="sum", out_dtype=x.dtype)
    dws = [queue_reduce(p1, op="sum", out_dtype=w1.dtype)]
    if gated:
        dws.append(queue_reduce(pu, op="sum", out_dtype=wu.dtype))
    dws.append(queue_reduce(p2, op="sum", out_dtype=w2.dtype))
    return (dx, *dws)


def _count_bwd(fn, x) -> None:
    """One launch of a backward wrapper's kernels, counted in total and by
    x's rows (a model's blocks of one width run at several row counts, as
    whisper's encoder and decoder do)."""
    fn.launches += 1
    fn.launches_by_rows[x.shape[0]] = fn.launches_by_rows.get(x.shape[0], 0) + 1


def fused_mlp_bwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  dy: torch.Tensor, *, act: str = "gelu",
                  f32_block_h: int = F32_BWD_BLOCK_H, f32_block_m: int = F32_BWD_BLOCK_M):
    """(dx, dw1, dw2) of act(x @ w1) @ w2 for 2-D x and dy: the recomputed
    hidden tile feeds the dX GEMM and both dW GEMMs (Fig 2c).  The f32_*
    knobs are the float32 kernels' tiles (`tile_candidates`)."""
    _build.refuse_capture("fused_mlp_bwd", x)
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, w1, w2, dy, act)
    out = _launch_bwd("fused_mlp_bwd", x, w1, None, w2, dy, act, f32_block_h, f32_block_m)
    _count_bwd(fused_mlp_bwd, x)
    return out


def fused_mlp_swiglu_bwd(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                         wd: torch.Tensor, dy: torch.Tensor, *, act: str = "silu",
                         f32_block_h: int = F32_BWD_BLOCK_H,
                         f32_block_m: int = F32_BWD_BLOCK_M):
    """(dx, dwg, dwu, dwd) of (act(x @ wg) * (x @ wu)) @ wd: the gated
    multicast, one recomputed (t, dg, du) tile set per row slice feeding all
    three weight-gradient GEMMs."""
    _build.refuse_capture("fused_mlp_swiglu_bwd", x)
    if x.device.type == "cpu":
        return fused_mlp_swiglu_bwd_plain(x, wg, wu, wd, dy, act)
    out = _launch_bwd("fused_mlp_swiglu_bwd", x, wg, wu, wd, dy, act, f32_block_h,
                      f32_block_m)
    _count_bwd(fused_mlp_swiglu_bwd, x)
    return out


fused_mlp_fwd.launches = 0
fused_mlp_swiglu_fwd.launches = 0
fused_mlp_bwd.launches = 0
fused_mlp_swiglu_bwd.launches = 0
fused_mlp_bwd.launches_by_rows = {}
fused_mlp_fwd.launches_by_form = {}
fused_mlp_swiglu_fwd.launches_by_form = {}
fused_mlp_fwd.launches_by_rows = {}
fused_mlp_swiglu_fwd.launches_by_rows = {}
fused_mlp_fwd.launches_by_fold = {}
fused_mlp_swiglu_fwd.launches_by_fold = {}
fused_mlp_swiglu_bwd.launches_by_rows = {}
