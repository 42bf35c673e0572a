// Fused MLP backward on Hopper: the Fig 2(c) multicast, for
// Y = act(X @ W1) @ W2 and the gated Y = (act(X @ Wg) * (X @ Wu)) @ Wd.
//
// Replaces the TPU kernels src/repro/kernels/fused_mlp.py `fused_mlp_bwd`
// (_bwd_dx_kernel, _bwd_dw_kernel) and `fused_mlp_swiglu_bwd`
// (_bwd_dx_kernel_swiglu, _bwd_dw_kernel_swiglu).
//
// What must hold: the (M, H) hidden tensors -- pre/t/da, or g/u/t/dg/du --
// never reach HBM.  Each tile of them is recomputed from X, dY and the
// weights ("queue recompute beats HBM spill") into shared memory and
// consumed there.  The TPU kernels keep f32 accumulators in VMEM across a
// sequential grid axis: (block_m, Din) for dX, (Din, block_h) +
// (block_h, Dout) per dW output for dW -- 0.6-1.8 MB at gemma3-1b's widths
// against the 227 KB of shared memory a block may use -- so that design
// does not carry over.  As in csrc/fused_mlp.cu, H (dX) or M (dW) is split
// across blocks and the blocks write f32 partials that the queue_reduce
// kernel folds in a fixed order (no atomics: two runs give the same bits).
//
//   recompute_tile: for RM = 64 rows and RN hidden columns, dt = dY @ W2^T
//     (B operand stored transposed), pre = X @ W1 (and u = X @ Wu), then in
//     registers da = dt * act'(pre), t = act(pre) -- gated: dg = dt * u *
//     act'(g), du = dt * act(g), t = act(g) * u -- each rounded to the
//     input dtype into a shared-memory chunk (the rounding points of the
//     plain version, kernels/ref.py).
//   dX kernel, block (64-row tile, BH-wide hidden chunk): recompute da (or
//     dg, du) for the chunk, then dX += da @ W1^T (+ du @ Wu^T) one
//     128-column output tile at a time; f32 partials (n_split, M, Din).
//   dW kernel, block (64-wide hidden chunk, MS-row slice of M): recompute
//     t and da (or t, dg, du) for all MS rows once, then every output tile:
//     dW1 = X^T da (gated: dWg = X^T dg and dWu = X^T du from ONE staged X
//     tile), dW2 = t^T dY; f32 partials (n_ms, ...) per output.
//
// Work: 11 GEMMs for the gated form (dX: 5, dW: 6, the TPU kernels' count;
// the function needs 8, but each kernel recomputes g, u and dt for its own
// tiles) and 7 for the two-matrix one (the function needs 5); at gemma3-1b's
// training shape (M 8192, 1152 -> 6912 -> 1152) the gated form is 1.44
// TFLOP, at whisper-small's encoder (M 12000, 768 -> 3072 -> 768) the
// ungated one 0.40 TFLOP, tensor-core bound on the card.  Two
// implementations:
//
// float32 (both forms): the kernels above, WMMA (mma.sync) from
// cp.async-staged tiles, 64-row recompute tiles; partials add 2 * 4 *
// (n_split * M * Din + n_ms * |dW|) bytes (n_split = H / 128, n_ms = M /
// 128).
//
// bfloat16 (both forms): mlp_bwd_dx_wgmma<GATED> and mlp_bwd_dw_wgmma<GATED>.
// 384 threads a block: a producer warpgroup whose thread 0 keeps TMA loads
// of 64 x 64 boxes (128-byte swizzle) in flight through a ring of full /
// empty mbarriers, and two consumer warpgroups of 64 rows each running
// wgmma out of the boxes (128-row tiles).  Transposed operands need no
// copy: X, dY and the weight boxes are read K-major or MN-major as each
// product needs (g = X Wg reads Wg MN-major; dX = dg Wg^T reads the same
// Wg boxes K-major; dWg^T = dg^T X reads the hidden atoms and X MN-major).
// The hidden values (dg, du, t gated; da, t ungated) are rounded to bf16
// into swizzled shared atoms that are the next products' operands -- the
// (M, H) tensors stay on chip.
//   dX: block (64 DX_NJ hidden columns, 128 rows) recomputes dg, du (or da)
//     for its chunk (dt = dY Wd^T, g, u: 3 GEMMs; ungated dt, pre: 2), then
//     dX = dg Wg^T + du Wu^T (or da W1^T), 128 columns a pass.  The gate's
//     atoms are two a sub-chunk more, so DX_NJ is 3 gated and 6 ungated;
//     ungated, the recompute takes two sub-chunks at a time (m64n128
//     products), so each step's dY or X boxes serve 128 hidden columns.
//   dW: block (64 hidden columns, 256 rows) recomputes dg, du, t (or da,
//     t) for its rows, then dWg^T = dg^T X, dWu^T = du^T X and dWd = t^T dY
//     (3), or dW1^T = da^T X and dW2 = t^T dY (2), 128 columns a pass.  The
//     atoms the gate frees buy the ungated form a third ring stage.
// A thread-block cluster (2 dX blocks over consecutive hidden chunks of
// one row tile; 8 dW blocks over consecutive row spans of one chunk) folds
// each pass's f32 accumulators over distributed shared memory in rank
// order (two reduce buffers, one cluster barrier a round) before writing:
// one partial per cluster goes to queue_reduce.  At gemma3-1b's shape the
// partials are dX 18 x 8192 x 1152 x 4 B = 0.68 GB and dW 4 x 3 x 6912 x
// 1152 x 4 B = 0.38 GB written (and read once by the folds); at whisper's
// encoder dX 4 x 12000 x 768 x 4 B = 0.15 GB and dW 6 x 2 x 3072 x 768 x 4
// B = 0.11 GB.  The folds' cluster barriers cost about as much as the
// products (build-and-compare probes; PERF.md), which is why dX's clusters
// are 2 blocks, not 4.  Every sum runs in a fixed order (no float atomics),
// so two runs give the same bits.  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W: PERF.md (chip_smoke.py phase 3).
#include <cooperative_groups.h>

#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"
#include "wg_ring.cuh"

using namespace kt;

namespace {

constexpr int NW = 8, NT = NW * 32;
constexpr int BK = 32;   // k-step of every staged GEMM
constexpr int RM = 64;   // rows of a recompute tile
constexpr int OT = 128;  // width of a dX / dW output tile
constexpr int kStages = 2;  // staging slots of the float32 kernels

template <typename T> struct BwdArgs {
  const T *X, *W1, *WU, *W2, *dY;
  int M, Din, H, Dout, act;
  bool vx, vw, v2, vy;  // 16-byte copies possible (vec_ok)
};

// Shared memory: `nchunks` chunks of rows x cols (hidden values in T), then
// a ring of kStages staging slots of three regions (A, B, B2); the f32
// epilogue tile Cs aliases the ring.
template <typename T>
struct BwdSmem {
  int ldk;
  size_t chunk, ring, a, b, slot, total;  // chunk/ring: bytes; a/b/slot: elements
  __host__ __device__ BwdSmem(int rows, int cols, int nchunks, bool gated) {
    constexpr int P = Pad<T>::v;
    ldk = cols + P;
    chunk = align128(size_t(rows) * ldk * sizeof(T));
    ring = nchunks * chunk;
    size_t ae = size_t(RM) * (BK + P), ae2 = size_t(BK) * (OT + P);
    size_t be = size_t(BK) * (OT + P), be2 = size_t(OT) * (BK + P);
    a = align128((ae > ae2 ? ae : ae2) * sizeof(T)) / sizeof(T);
    b = align128((be > be2 ? be : be2) * sizeof(T)) / sizeof(T);
    slot = a + b + (gated ? b : 0);
    size_t staging = kStages * slot * sizeof(T);
    // the largest f32 epilogue tile: OT x (HW + 4) of dW1, >= RM x (OT + 4)
    size_t cs = align128(size_t(OT) * (OT / 2 + 4) * sizeof(float));
    total = ring + (staging > cs ? staging : cs);
  }
};

// Store accumulator `acc` (R x C) rounded to T at dst (leading dim ldk),
// through the f32 tile Cs.
template <typename T, int R, int C, typename Acc>
__device__ void put_tile(const Acc& acc, float* Cs, T* dst, int ldk) {
  acc.store(Cs, C + 4);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * C; idx += NT) {
    int r = idx / C, c = idx % C;
    dst[r * ldk + c] = from_f<T>(Cs[r * (C + 4) + c]);
  }
  __syncthreads();
}

// Store accumulator `acc` (R x C) as f32 to out[(r0 + r) * ld + c0 + c],
// masked to [0, nrows) x [0, ncols), through Cs.
template <int R, int C, typename Acc>
__device__ void put_f32(const Acc& acc, float* Cs, float* out, size_t ld, int r0, int c0,
                        int nrows, int ncols) {
  acc.store(Cs, C + 4);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * C; idx += NT) {
    int r = idx / C, c = idx % C;
    if (r0 + r < nrows && c0 + c < ncols) out[size_t(r0 + r) * ld + c0 + c] = Cs[r * (C + 4) + c];
  }
  __syncthreads();
}

// One staged GEMM loop over a ring of STG slots: for kt < nk,
// stage(kt, slot) issues the copies of step kt into `slot` (no commit),
// mma(slot, kt) consumes them.  Ends with every copy landed and every
// thread past its last mma, so the ring (and Cs over it) is free.
template <typename T, int STG, typename Stage, typename Mma>
__device__ void pipeline(T* ring, size_t slot, int nk, Stage stage, Mma mma) {
  for (int s = 0; s < STG - 1; ++s) {
    if (s < nk) stage(s, ring + (s % STG) * slot);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STG - 2>();  // step kt landed
    __syncthreads();           // ... for every thread; slot (kt - 1) is free
    const int nx = kt + STG - 1;
    if (nx < nk) stage(nx, ring + (nx % STG) * slot);
    cp_async_commit();
    mma(ring + (kt % STG) * slot, kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Recompute rows [m0, m0 + RM) x hidden columns [h0, h0 + RN) (columns at
// or past hend, rows at or past M come out 0) into the chunks: d0 = da or
// dg, d1 = du (gated), tdst = t (or null), each at leading dim ldk.
template <typename T, bool GATED, int RN>
__device__ void recompute_tile(const BwdArgs<T>& a, int m0, int h0, int hend, T* ring,
                               const BwdSmem<T>& L, float* Cs, T* tdst, T* d0, T* d1) {
  constexpr int P = Pad<T>::v, LDA = BK + P, LDW = RN + P, STG = kStages;
  BlockAcc<T, RM, RN, NW, true, 2> dt;
  dt.zero();
  // dt = dY[m0 : m0 + RM, :] @ W2[h0 : h0 + RN, :]^T
  pipeline<T, STG>(
      ring, L.slot, (a.Dout + BK - 1) / BK,
      [&](int kt, T* s) {
        load_tile<T, RM, BK, NT>(s, LDA, a.dY, a.Dout, m0, kt * BK, a.M, a.Dout, a.vy);
        load_tile<T, RN, BK, NT>(s + L.a, LDA, a.W2, a.Dout, h0, kt * BK, hend, a.Dout, a.v2);
      },
      [&](T* s, int) { dt.template mma<BK>(s, LDA, s + L.a, LDA); });
  // pre (g) = X @ W1[:, h0 : h0 + RN], u = X @ Wu[...]
  BlockAcc<T, RM, RN, NW, false, 2> g, u;
  g.zero();
  if constexpr (GATED) u.zero();
  pipeline<T, STG>(
      ring, L.slot, (a.Din + BK - 1) / BK,
      [&](int kt, T* s) {
        load_tile<T, RM, BK, NT>(s, LDA, a.X, a.Din, m0, kt * BK, a.M, a.Din, a.vx);
        load_tile<T, BK, RN, NT>(s + L.a, LDW, a.W1, a.H, kt * BK, h0, a.Din, hend, a.vw);
        if constexpr (GATED)
          load_tile<T, BK, RN, NT>(s + L.a + L.b, LDW, a.WU, a.H, kt * BK, h0, a.Din, hend, a.vw);
      },
      [&](T* s, int) {
        g.template mma<BK>(s, LDA, s + L.a, LDW);
        if constexpr (GATED) u.template mma<BK>(s, LDA, s + L.a + L.b, LDW);
      });
  // elementwise, in registers: g <- da | dg, u <- du, dt <- t
#pragma unroll
  for (int k = 0; k < decltype(g)::NE; ++k) {
    const float pre = g.el(k), d = dt.el(k);
    if constexpr (GATED) {
      const float uv = u.el(k), sg = act_apply(a.act, pre);
      g.el(k) = d * uv * dact_apply(a.act, pre);
      u.el(k) = d * sg;
      dt.el(k) = sg * uv;
    } else {
      g.el(k) = d * dact_apply(a.act, pre);
      dt.el(k) = act_apply(a.act, pre);
    }
  }
  put_tile<T, RM, RN>(g, Cs, d0, L.ldk);
  if constexpr (GATED) put_tile<T, RM, RN>(u, Cs, d1, L.ldk);
  if (tdst) put_tile<T, RM, RN>(dt, Cs, tdst, L.ldk);
}

// dX: block (blockIdx.x: 64-row tile, blockIdx.y: hidden chunk of BH).
template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
mlp_bwd_dx_kernel(BwdArgs<T> a, float* __restrict__ out, int BH) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = Pad<T>::v, LDB = BK + P, STG = kStages;
  const BwdSmem<T> L(RM, BH, GATED ? 2 : 1, GATED);
  T* D0 = reinterpret_cast<T*>(smem);
  T* D1 = reinterpret_cast<T*>(smem + L.chunk);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  float* Cs = reinterpret_cast<float*>(smem + L.ring);
  const int m0 = blockIdx.x * RM, h0 = blockIdx.y * BH;
  const int hn = min(BH, a.H - h0);

  for (int hc = 0; hc < hn; hc += OT)
    recompute_tile<T, GATED, OT>(a, m0, h0 + hc, h0 + hn, ring, L, Cs, nullptr, D0 + hc, D1 + hc);

  // dX[m0 : m0 + RM, n0 : n0 + OT] = da @ W1[n0 : n0 + OT, chunk]^T (+ du @ Wu^T)
  const int nk = (hn + BK - 1) / BK;  // chunk columns past hn are zero
  for (int n0 = 0; n0 < a.Din; n0 += OT) {
    BlockAcc<T, RM, OT, NW, true, 2> acc;
    acc.zero();
    pipeline<T, STG>(
        ring, L.slot, nk,
        [&](int kt, T* s) {
          load_tile<T, OT, BK, NT>(s + L.a, LDB, a.W1, a.H, n0, h0 + kt * BK, a.Din, h0 + hn, a.vw);
          if constexpr (GATED)
            load_tile<T, OT, BK, NT>(s + L.a + L.b, LDB, a.WU, a.H, n0, h0 + kt * BK, a.Din,
                                     h0 + hn, a.vw);
        },
        [&](T* s, int kt) {
          acc.template mma<BK>(D0 + kt * BK, L.ldk, s + L.a, LDB);
          if constexpr (GATED) acc.template mma<BK>(D1 + kt * BK, L.ldk, s + L.a + L.b, LDB);
        });
    acc.store(Cs, OT + 4);
    __syncthreads();
    put_f32<RM, OT>(acc, Cs, out + size_t(blockIdx.y) * a.M * a.Din, a.Din, m0, n0, a.M, a.Din);
  }
}

// dW: block (blockIdx.x: hidden chunk of HW = 64, blockIdx.y: MS-row slice).
constexpr int HW = 64;

template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
mlp_bwd_dw_kernel(BwdArgs<T> a, float* __restrict__ p1, float* __restrict__ pu,
                  float* __restrict__ p2, int MS) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = Pad<T>::v, LDS = OT + P, STG = kStages;
  const BwdSmem<T> L(MS, HW, GATED ? 3 : 2, GATED);
  T* Tc = reinterpret_cast<T*>(smem);
  T* D0 = reinterpret_cast<T*>(smem + L.chunk);
  T* D1 = reinterpret_cast<T*>(smem + 2 * L.chunk);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  float* Cs = reinterpret_cast<float*>(smem + L.ring);
  const int h0 = blockIdx.x * HW, hend = min(a.H, h0 + HW);
  const int mb = blockIdx.y * MS, rows = min(MS, a.M - mb);

  // one recompute of (t, da | dg, du) per row, multicast to every GEMM below
  for (int mt = 0; mt < rows; mt += RM) {
    const size_t o = size_t(mt) * L.ldk;
    recompute_tile<T, GATED, HW>(a, mb + mt, h0, hend, ring, L, Cs, Tc + o, D0 + o, D1 + o);
  }
  const int nk = (rows + BK - 1) / BK;  // chunk rows past `rows` are zero

  // dW1 (dWg, dWu) [n0 : n0 + OT, h0 : h0 + HW] over this slice's rows
  for (int n0 = 0; n0 < a.Din; n0 += OT) {
    BlockAcc<T, OT, HW, NW, false, 4, true> ag, au;
    ag.zero();
    if constexpr (GATED) au.zero();
    pipeline<T, STG>(
        ring, L.slot, nk,
        [&](int kt, T* s) {
          load_tile<T, BK, OT, NT>(s, LDS, a.X, a.Din, mb + kt * BK, n0, a.M, a.Din, a.vx);
        },
        [&](T* s, int kt) {
          ag.template mma<BK>(s, LDS, D0 + kt * BK * L.ldk, L.ldk);
          if constexpr (GATED) au.template mma<BK>(s, LDS, D1 + kt * BK * L.ldk, L.ldk);
        });
    float* base = p1 + size_t(blockIdx.y) * a.Din * a.H;
    put_f32<OT, HW>(ag, Cs, base, a.H, n0, h0, a.Din, a.H);
    if constexpr (GATED)
      put_f32<OT, HW>(au, Cs, pu + size_t(blockIdx.y) * a.Din * a.H, a.H, n0, h0, a.Din, a.H);
  }
  // dW2 [h0 : h0 + HW, n0 : n0 + OT] = t^T dY over this slice's rows
  for (int n0 = 0; n0 < a.Dout; n0 += OT) {
    BlockAcc<T, HW, OT, NW, false, 2, true> ad;
    ad.zero();
    pipeline<T, STG>(
        ring, L.slot, nk,
        [&](int kt, T* s) {
          load_tile<T, BK, OT, NT>(s, LDS, a.dY, a.Dout, mb + kt * BK, n0, a.M, a.Dout, a.vy);
        },
        [&](T* s, int kt) { ad.template mma<BK>(Tc + kt * BK * L.ldk, L.ldk, s, LDS); });
    put_f32<HW, OT>(ad, Cs, p2 + size_t(blockIdx.y) * a.H * a.Dout, a.Dout, h0, n0, a.H,
                    a.Dout);
  }
}

template <typename T>
BwdArgs<T> make_args(const void* x, const void* w1, const void* wu, const void* w2,
                     const void* dy, int M, int Din, int H, int Dout, int act, bool gated) {
  BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(wu),
               static_cast<const T*>(w2), static_cast<const T*>(dy), M, Din, H, Dout, act};
  // the kernels' vec_ok, evaluated once on the host
  auto ok = [](const void* p, int ld) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % (16 / int(sizeof(T))) == 0;
  };
  a.vx = ok(x, Din);
  a.vw = ok(w1, H) && (!gated || ok(wu, H));
  a.v2 = ok(w2, Dout);
  a.vy = ok(dy, Dout);
  return a;
}

// Allow `smem` bytes of dynamic shared memory (at most the 227 KB a block
// may use on the H100).
template <typename Kern>
int allow_smem(Kern kern, size_t smem) {
  if (smem > 232448) return int(cudaErrorInvalidValue);
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <typename T, bool GATED>
int launch_dx(const BwdArgs<T>& a, float* out, int bh, cudaStream_t st) {
  const BwdSmem<T> L(RM, bh, GATED ? 2 : 1, GATED);
  auto kern = mlp_bwd_dx_kernel<T, GATED>;
  dim3 grid((a.M + RM - 1) / RM, (a.H + bh - 1) / bh);
  if (int e = allow_smem(kern, L.total)) return e;
  kern<<<grid, NT, L.total, st>>>(a, out, bh);
  return int(cudaGetLastError());
}

template <typename T, bool GATED>
int launch_dw(const BwdArgs<T>& a, float* p1, float* pu, float* p2, int ms, cudaStream_t st) {
  const BwdSmem<T> L(ms, HW, GATED ? 3 : 2, GATED);
  auto kern = mlp_bwd_dw_kernel<T, GATED>;
  dim3 grid((a.H + HW - 1) / HW, (a.M + ms - 1) / ms);
  if (int e = allow_smem(kern, L.total)) return e;
  kern<<<grid, NT, L.total, st>>>(a, p1, pu, p2, ms);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 forms on TMA + wgmma (B7 gated, B6 ungated), partials folded
// across clusters
// ---------------------------------------------------------------------------

constexpr int SLOT = 4 * ATOM;        // a ring stage: the largest step's boxes
constexpr int RB_N = 32;              // accumulator floats per thread per reduce round
constexpr int DX_ST = 2;              // dX ring stages
constexpr int DW_MS = 256;            // rows per dW block
constexpr int DX_CLUSTER = 2;         // dX blocks (hidden chunks of one row tile) per cluster
constexpr int DW_CLUSTER = 8;         // dW blocks (row spans of one hidden chunk) per cluster
// 64-wide hidden sub-chunks per dX block.  Its atoms are dg and du (gated)
// or da alone, two a sub-chunk each, so the ungated form takes twice the
// sub-chunks in the same shared memory, which halves its dX partials.
template <bool GATED> constexpr int DX_NJ = GATED ? 3 : 6;
// dW ring stages.  A span's atoms are dg, du and t (gated) or da and t, one
// per 64 rows each; the ungated form spends the atoms the gate frees on a
// third stage (two leave the ring's loads setting the pace).
template <bool GATED> constexpr int DW_ST = GATED ? 2 : 3;
// dynamic shared memory: the hidden atoms, the ring, the two reduce
// buffers, the ring's full and empty barriers, and slack to align the base
// to 1024
constexpr int RB_FLOATS = 2 * CONSUMER_NT * RB_N;
constexpr int wg_smem(int atoms, int stages) {
  return atoms * ATOM + stages * SLOT + RB_FLOATS * 4 + 16 * stages + 1024;
}
template <bool GATED> constexpr int DX_SMEM = wg_smem((GATED ? 4 : 2) * DX_NJ<GATED>, DX_ST);
template <bool GATED>
constexpr int DW_SMEM = wg_smem((GATED ? 3 : 2) * (DW_MS / 64), DW_ST<GATED>);
static_assert(DX_SMEM<true> <= 232448 && DW_SMEM<true> <= 232448 && DX_SMEM<false> <= 232448 &&
                  DW_SMEM<false> <= 232448,
              "a block may use 227 KB");
static_assert(DW_MS % 128 == 0 && RB_N % (2 * DX_CLUSTER) == 0 && RB_N % (2 * DW_CLUSTER) == 0,
              "whole 128-row tiles; every member folds whole pairs");

// Fold this consumer thread's N accumulator floats over the CS blocks of
// the cluster in rank order (`cluster_fold`) and store the sums as f32 at
// out[(row0 + row) * ld + col0 + col], masked to rows < nrows, columns <
// ncols.
template <int N, int CS>
__device__ __forceinline__ void cluster_store(const float* acc, float* rb, int& round, float* out,
                                              size_t ld, int row0, int col0, int nrows,
                                              int ncols) {
  auto buffer = [&](int r) { return rb + (r & 1) * CONSUMER_NT * RB_N; };
  cluster_fold<N, CS, RB_N>(acc, buffer, round, [&](int e, float v0, float v1) {
    put_f32_pair(out, ld, row0 + acc_row(e), col0 + acc_col(e), nrows, ncols, v0, v1);
  });
}

struct WgArgs {
  int M, Din, H, Dout, act;
};

// The tensor maps of X, dY and the weights: w1 (Wg gated), wu (gated only)
// and w2 (Wd gated).
struct WgMaps {
  const CUtensorMap *x, *dy, *w1, *wu, *w2;
};

// Recompute of a 128-row tile (rows m0..) against the 64 hidden columns
// from hj, warpgroup w taking rows m0 + 64 w: nkd steps of
// dt = dY W2[hj.., :]^T (dY boxes K-major as A, a W2 box K-major as B),
// then nki steps of pre = X W1[:, hj..] (gated: g = X Wg and u = X Wu; X
// K-major, the weight boxes MN-major); step k < nkd + nki.
template <bool GATED>
__device__ __forceinline__ void issue_recompute(int k, int nkd, unsigned char* sl, uint64_t* bar,
                                                const WgMaps& mp, int m0, int hj) {
  if (k < nkd) {
    mbar_expect_tx(bar, 3 * ATOM);
    tma_load_3d(sl, mp.dy, bar, k * 64, m0, 0);
    tma_load_3d(sl + ATOM, mp.dy, bar, k * 64, m0 + 64, 0);
    tma_load_3d(sl + 2 * ATOM, mp.w2, bar, k * 64, hj, 0);
  } else {
    k -= nkd;
    mbar_expect_tx(bar, (GATED ? 4 : 3) * ATOM);
    tma_load_3d(sl, mp.x, bar, k * 64, m0, 0);
    tma_load_3d(sl + ATOM, mp.x, bar, k * 64, m0 + 64, 0);
    tma_load_3d(sl + 2 * ATOM, mp.w1, bar, hj, k * 64, 0);
    if constexpr (GATED) tma_load_3d(sl + 3 * ATOM, mp.wu, bar, hj, k * 64, 0);
  }
}

template <bool GATED>
__device__ __forceinline__ void mma_recompute(int w, int k, int nkd, const unsigned char* sl,
                                              float* dt, float* g, float* u) {
  wgmma_fence();
  if (k < nkd) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64t<0, 0>(dt, kdesc(sl + w * ATOM + kk * 32), kdesc(sl + 2 * ATOM + kk * 32), 1);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = kdesc(sl + w * ATOM + kk * 32);
      wgmma_ss_n64t<0, 1>(g, a, mndesc(sl + 2 * ATOM + kk * 2048, ATOM), 1);
      if constexpr (GATED) wgmma_ss_n64t<0, 1>(u, a, mndesc(sl + 3 * ATOM + kk * 2048, ATOM), 1);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs<32>(dt);
  fence_regs<32>(g);
  if constexpr (GATED) fence_regs<32>(u);
}

// The hidden values of this warpgroup's 64 rows and 64 hidden columns,
// each rounded to bf16 at the plain version's rounding points
// (kernels/ref.py) into its atoms: gated, dg = dt u act'(g) into d0, du =
// dt act(g) into d1 and t = act(g) u; ungated, da = dt act'(pre) into d0
// and t = act(pre).  t goes to t_atom where it is not null.  Then the
// recompute accumulators are zeroed.
template <bool GATED>
__device__ __forceinline__ void put_hidden(int act, float* dt, float* g, float* u,
                                           unsigned char* d0_atom, unsigned char* d1_atom,
                                           unsigned char* t_atom) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    float d0[2], d1[2], t2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pre = g[i + e], d = dt[i + e];
      if constexpr (GATED) {
        const float uv = u[i + e], sg = act_apply(act, pre);
        d0[e] = d * uv * dact_apply(act, pre);
        d1[e] = d * sg;
        t2[e] = sg * uv;
      } else {
        d0[e] = d * dact_apply(act, pre);
        d1[e] = 0.f;
        t2[e] = act_apply(act, pre);
      }
    }
    const int r = acc_row(i), c = acc_col(i);
    atom_put(d0_atom, r, c, pack2(d0[0], d0[1]));
    if constexpr (GATED) atom_put(d1_atom, r, c, pack2(d1[0], d1[1]));
    if (t_atom) atom_put(t_atom, r, c, pack2(t2[0], t2[1]));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dt[i] = g[i] = u[i] = 0.f;
  fence_proxy_async_smem();  // the atoms are wgmma operands next
}

// Ungated dX's recompute of a sub-chunk pair: 128 hidden columns from hj
// of a 128-row tile (rows m0..), so that each step's dY or X boxes serve
// twice the columns of `issue_recompute`'s.  nkd steps of dt = dY W2[hj..,
// :]^T (two W2 boxes, rows hj and hj + 64, one K-major operand of 128
// rows), then pre = X W1[:, hj..] (two W1 boxes, MN-major, 64 columns
// apart); step k < nkd + nki.
__device__ __forceinline__ void issue_recompute_pair(int k, int nkd, unsigned char* sl,
                                                     uint64_t* bar, const WgMaps& mp, int m0,
                                                     int hj) {
  mbar_expect_tx(bar, 4 * ATOM);
  if (k < nkd) {
    tma_load_3d(sl, mp.dy, bar, k * 64, m0, 0);
    tma_load_3d(sl + ATOM, mp.dy, bar, k * 64, m0 + 64, 0);
    tma_load_3d(sl + 2 * ATOM, mp.w2, bar, k * 64, hj, 0);
    tma_load_3d(sl + 3 * ATOM, mp.w2, bar, k * 64, hj + 64, 0);
  } else {
    k -= nkd;
    tma_load_3d(sl, mp.x, bar, k * 64, m0, 0);
    tma_load_3d(sl + ATOM, mp.x, bar, k * 64, m0 + 64, 0);
    tma_load_3d(sl + 2 * ATOM, mp.w1, bar, hj, k * 64, 0);
    tma_load_3d(sl + 3 * ATOM, mp.w1, bar, hj + 64, k * 64, 0);
  }
}

// dX: block (blockIdx.x: hidden chunk of 64 NJ columns, blockIdx.y:
// 128-row tile); cluster = DX_CLUSTER consecutive chunks of one row tile.
// Recompute da (gated: dg, du) of the chunk into atoms -- gated one
// sub-chunk a step sequence (dt, then [g | u]), ungated a pair (dt and pre
// of 128 columns, one m64n128 product a k slice each) -- then per 128-wide
// dX column tile p the chunk's K steps of da W1^T (gated: dg Wg^T + du
// Wu^T; the weight boxes K-major as B: rows din, columns h), folded over
// the cluster into partial chunk / cluster of out (n_partials, M, Din).
// Ungated, the pair's dt | pre and then dX's accumulator share `acc`'s 128
// registers (a product chain starts with scale-d 0, so nothing zeroes it).
template <bool GATED>
__global__ void __launch_bounds__(RING_NT, 1)
mlp_bwd_dx_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap twu,
                 const __grid_constant__ CUtensorMap tw2, float* __restrict__ out, WgArgs a) {
  constexpr int NJ = DX_NJ<GATED>, RW = GATED ? 1 : 2;  // sub-chunks a recompute covers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* D0 = smem;                    // atom (j, w): rows 64 w.., columns 64 j..
  unsigned char* D1 = D0 + NJ * 2 * ATOM;      // gated only
  unsigned char* ring = D0 + (GATED ? 2 : 1) * NJ * 2 * ATOM;
  float* rb = reinterpret_cast<float*>(ring + DX_ST * SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(rb + RB_FLOATS);
  init_ring_barriers(DX_ST, full);
  const WgMaps mp{&tx, &tdy, &tw1, &twu, &tw2};
  const int cs = int(cooperative_groups::this_cluster().num_blocks());
  const int chunk = blockIdx.x;
  const int h0 = chunk * NJ * 64, m0 = blockIdx.y * 128;
  const int w = (threadIdx.x >> 7) - 1;  // consumer warpgroup
  const int nkd = (a.Dout + 63) / 64, nki = (a.Din + 63) / 64, seg = nkd + nki;
  const int TR = NJ / RW * seg;  // recompute steps
  const int npass = (a.Din + 127) / 128, T = TR + npass * NJ;
  float dt[32], g[32], u[32], acc[GATED ? 64 : 128];
#pragma unroll
  for (int i = 0; i < 32; ++i) dt[i] = g[i] = u[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GATED ? 64 : 128); ++i) acc[i] = 0.f;
  float* part = out + size_t(chunk / cs) * a.M * a.Din;
  int round = 0;  // reduce rounds so far

  auto issue = [&](int t, int s) {
    unsigned char* sl = ring + s * SLOT;
    if (t < TR) {
      const int hj = h0 + (t / seg) * 64 * RW;
      if constexpr (GATED)
        issue_recompute<true>(t % seg, nkd, sl, &full[s], mp, m0, hj);
      else
        issue_recompute_pair(t % seg, nkd, sl, &full[s], mp, m0, hj);
    } else {
      const int q = t - TR, p = q / NJ, hj = h0 + (q % NJ) * 64;
      mbar_expect_tx(&full[s], (GATED ? 4 : 2) * ATOM);
      tma_load_3d(sl, &tw1, &full[s], hj, p * 128, 0);
      tma_load_3d(sl + ATOM, &tw1, &full[s], hj, p * 128 + 64, 0);
      if constexpr (GATED) {
        tma_load_3d(sl + 2 * ATOM, &twu, &full[s], hj, p * 128, 0);
        tma_load_3d(sl + 3 * ATOM, &twu, &full[s], hj, p * 128 + 64, 0);
      }
    }
  };
  auto syncs = [&](int t) {  // the fold after the last step of a dX tile
    return t >= TR && (t - TR) % NJ == NJ - 1 ? 64 / RB_N : 0;
  };
  auto consume = [&](int t, int s, auto release) {
    const unsigned char* sl = ring + s * SLOT;
    if (t < TR) {
      const int jr = t / seg, k = t % seg;
      if constexpr (GATED) {
        mma_recompute<true>(w, k, nkd, sl, dt, g, u);
        release();
        if (k == seg - 1) {
          put_hidden<true>(a.act, dt, g, u, D0 + (jr * 2 + w) * ATOM, D1 + (jr * 2 + w) * ATOM,
                           nullptr);
          warpgroup_sync(w);  // its atoms are written before its products read them
        }
      } else {
        wgmma_fence();
        if (k < nkd) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128t<0, 0>(acc, kdesc(sl + w * ATOM + kk * 32),
                                 kdesc(sl + 2 * ATOM + kk * 32), k != 0 || kk != 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128t<0, 1>(acc + 64, kdesc(sl + w * ATOM + kk * 32),
                                 mndesc(sl + 2 * ATOM + kk * 2048, ATOM), k != nkd || kk != 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs<128>(acc);
        release();
        if (k == seg - 1) {
          // columns 64 c.. of the pair: dt in acc[32 c..], pre in acc[64 + 32 c..]
#pragma unroll
          for (int c = 0; c < 2; ++c)
            put_hidden<false>(a.act, acc + 32 * c, acc + 64 + 32 * c, acc + 64 + 32 * c,
                              D0 + ((2 * jr + c) * 2 + w) * ATOM, nullptr, nullptr);
          warpgroup_sync(w);
        }
      }
    } else {
      const int q = t - TR, p = q / NJ, j = q % NJ;
      const unsigned char* d0 = D0 + (j * 2 + w) * ATOM;
      const unsigned char* d1 = D1 + (j * 2 + w) * ATOM;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128t<0, 0>(acc, kdesc(d0 + kk * 32), kdesc(sl + kk * 32),
                             GATED || j != 0 || kk != 0);
        if constexpr (GATED)
          wgmma_ss_n128t<0, 0>(acc, kdesc(d1 + kk * 32), kdesc(sl + 2 * ATOM + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<64>(acc);
      release();
      if (j == NJ - 1) {
        cluster_store<64, DX_CLUSTER>(acc, rb, round, part, a.Din, m0 + 64 * w, p * 128, a.M, a.Din);
        if constexpr (GATED) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        }
      }
    }
  };
  run_ring(DX_ST, T, full, full + DX_ST, issue, syncs, consume);
}

// dW: block (blockIdx.x: DW_MS-row span, blockIdx.y: 64-wide hidden chunk);
// cluster = DW_CLUSTER consecutive spans of one chunk.  Recompute da and t
// (gated: dg, du, t) for the span's rows (128-row tiles) into atoms, then
// every 128-wide output tile p, A = the hidden atoms read MN-major (M = the
// 64 hidden columns), B = X or dY boxes MN-major (rows of the span as K):
//   gated, dWg^T, dWu^T [chunk, Din tile p] = dg^T X, du^T X: warpgroup 0
//     takes dWg, 1 dWu;
//   ungated, dW1^T [chunk, Din tile p] = da^T X, and both forms, dW2 [chunk,
//     Dout tile p] = t^T dY: warpgroup w takes columns 64 w.. of the tile;
// each tile folded over the cluster into partial blockIdx.x / cluster:
// p1 (gated: pg), pu (n, H, Din) -- transposed -- and p2 (n, H, Dout).
template <bool GATED>
__global__ void __launch_bounds__(RING_NT, 1)
mlp_bwd_dw_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap twu,
                 const __grid_constant__ CUtensorMap tw2, float* __restrict__ p1,
                 float* __restrict__ pu, float* __restrict__ p2, WgArgs a) {
  constexpr int NA = DW_MS / 64, ST = DW_ST<GATED>;  // atoms per hidden buffer, one per 64 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* D0 = smem;                  // da | dg
  unsigned char* D1 = D0 + NA * ATOM;        // du (gated only)
  unsigned char* TT = D0 + (GATED ? 2 : 1) * NA * ATOM;
  unsigned char* ring = TT + NA * ATOM;
  float* rb = reinterpret_cast<float*>(ring + ST * SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(rb + RB_FLOATS);
  init_ring_barriers(ST, full);
  const WgMaps mp{&tx, &tdy, &tw1, &twu, &tw2};
  const int cs = int(cooperative_groups::this_cluster().num_blocks());
  const int mb = blockIdx.x * DW_MS, h0 = blockIdx.y * 64;
  const int w = (threadIdx.x >> 7) - 1;  // consumer warpgroup
  const int nkd = (a.Dout + 63) / 64, nki = (a.Din + 63) / 64, seg = nkd + nki;
  constexpr int NMT = DW_MS / 128, NKS = DW_MS / 128;  // recompute tiles, K steps a pass
  const int npg = (a.Din + 127) / 128, npd = (a.Dout + 127) / 128;
  const int t_w = NMT * seg, t_d = t_w + npg * NKS, T = t_d + npd * NKS;
  float dt[32], g[32], u[32], acc[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) dt[i] = g[i] = u[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const size_t pn = size_t(blockIdx.x / cs);
  int round = 0;  // reduce rounds so far

  auto issue = [&](int t, int s) {
    unsigned char* sl = ring + s * SLOT;
    if (t < t_w) {
      issue_recompute<GATED>(t % seg, nkd, sl, &full[s], mp, mb + (t / seg) * 128, h0);
    } else {
      // box (row atom r, column atom c) at sl + (2 r + c) ATOM: rows of the
      // span as K, 128 columns of X (or dY) as N
      const bool dw = t >= t_d;
      const int q = dw ? t - t_d : t - t_w, p = q / NKS, r0 = mb + (q % NKS) * 128;
      const CUtensorMap* map = dw ? &tdy : &tx;
      mbar_expect_tx(&full[s], 4 * ATOM);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 2; ++c)
          tma_load_3d(sl + (2 * r + c) * ATOM, map, &full[s], p * 128 + c * 64, r0 + r * 64, 0);
    }
  };
  auto syncs = [&](int t) {  // the folds after the last step of a dW tile
    if (t < t_w || (t - (t < t_d ? t_w : t_d)) % NKS != NKS - 1) return 0;
    return GATED && t < t_d ? 64 / RB_N : 32 / RB_N;
  };
  auto consume = [&](int t, int s, auto release) {
    const unsigned char* sl = ring + s * SLOT;
    if (t < t_w) {
      const int mt = t / seg, k = t % seg;
      mma_recompute<GATED>(w, k, nkd, sl, dt, g, u);
      release();
      if (k == seg - 1) {
        const int at = (mt * 2 + w) * ATOM;
        put_hidden<GATED>(a.act, dt, g, u, D0 + at, D1 + at, TT + at);
      }
      return;
    }
    if (t == t_w) consumers_sync();  // both warpgroups' atoms are written
    if (GATED && t < t_d) {
      const int q = t - t_w, p = q / NKS, ks = q % NKS;
      const unsigned char* hid = w == 0 ? D0 : D1;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int r = kk / 4, ko = (kk % 4) * 2048;
        wgmma_ss_n128t<1, 1>(acc, mndesc(hid + (ks * 2 + r) * ATOM + ko, ATOM),
                             mndesc(sl + 2 * r * ATOM + ko, ATOM), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<64>(acc);
      release();
      if (ks == NKS - 1) {
        float* o = (w == 0 ? p1 : pu) + pn * a.H * a.Din;
        cluster_store<64, DW_CLUSTER>(acc, rb, round, o, a.Din, h0, p * 128, a.H, a.Din);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
    } else {
      const bool dw2 = t >= t_d;
      const int q = dw2 ? t - t_d : t - t_w, p = q / NKS, ks = q % NKS;
      const unsigned char* hid = dw2 ? TT : D0;
      wgmma_fence();  // the first 32 accumulators
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int r = kk / 4, ko = (kk % 4) * 2048;
        wgmma_ss_n64t<1, 1>(acc, mndesc(hid + (ks * 2 + r) * ATOM + ko, ATOM),
                            mndesc(sl + (2 * r + w) * ATOM + ko, ATOM), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<64>(acc);
      release();
      if (ks == NKS - 1) {
        const int ld = dw2 ? a.Dout : a.Din;
        cluster_store<32, DW_CLUSTER>(acc, rb, round, (dw2 ? p2 : p1) + pn * a.H * ld, ld, h0,
                                      p * 128 + 64 * w, a.H, ld);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
    }
  };
  run_ring(ST, T, full, full + ST, issue, syncs, consume);
}

// Allow the kernel its shared memory, then launch it in clusters.
template <typename Kern, typename... Args>
cudaError_t launch_wg(Kern kern, dim3 grid, int smem, int cluster, cudaStream_t st,
                      Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return e != cudaSuccess ? e : launch_cluster(kern, grid, smem, cluster, st, args...);
}

// The f32 partials of the bf16 backward at M rows and hidden width H (a
// multiple of 8): one dX partial per cluster of DX_CLUSTER hidden chunks
// of DX_NJ * 64 columns and one dW partial per cluster of DW_CLUSTER row
// spans of DW_MS rows.
template <bool GATED>
int wg_partials(int M, int H, int* n_dx, int* n_dw) {
  if (M < 1 || H < 8 || H % 8) return int(cudaErrorInvalidValue);
  const int nch = (H + DX_NJ<GATED> * 64 - 1) / (DX_NJ<GATED> * 64);
  const int nspan = (M + DW_MS - 1) / DW_MS;
  *n_dx = (nch + DX_CLUSTER - 1) / DX_CLUSTER;
  *n_dw = (nspan + DW_CLUSTER - 1) / DW_CLUSTER;
  return 0;
}

template <bool GATED>
int launch_wgmma(const void* x, const void* w1, const void* wu, const void* w2, const void* dy,
                 void* dx, void* p1, void* pu, void* p2, int M, int Din, int H, int Dout, int act,
                 int parts, cudaStream_t st) {
  if (M < 1 || Din % 8 || H % 8 || Dout % 8 || Din < 8 || H < 8 || Dout < 8)
    return int(cudaErrorInvalidValue);
  for (const void* p : {x, w1, GATED ? wu : w1, w2, dy})
    if (!p || (reinterpret_cast<uintptr_t>(p) & 15)) return int(cudaErrorInvalidValue);
  CUtensorMap tx, tdy, tw1, twu, tw2;
  cudaError_t e = map64(&tx, x, M, Din);
  if (e == cudaSuccess) e = map64(&tdy, dy, M, Dout);
  if (e == cudaSuccess) e = map64(&tw1, w1, Din, H);
  if (e == cudaSuccess) e = map64(&twu, GATED ? wu : w1, Din, H);  // ungated: never read
  if (e == cudaSuccess) e = map64(&tw2, w2, H, Dout);
  if (e != cudaSuccess) return int(e);
  const WgArgs a{M, Din, H, Dout, act};
  int n_dx = 0, n_dw = 0;
  wg_partials<GATED>(M, H, &n_dx, &n_dw);
  if (parts & 1)
    e = launch_wg(mlp_bwd_dx_wgmma<GATED>, dim3(n_dx * DX_CLUSTER, (M + 127) / 128),
                  DX_SMEM<GATED>, DX_CLUSTER, st, tx, tdy, tw1, twu, tw2, static_cast<float*>(dx),
                  a);
  if (e != cudaSuccess || !(parts & 2)) return int(e);
  e = launch_wg(mlp_bwd_dw_wgmma<GATED>, dim3(n_dw * DW_CLUSTER, (H + 63) / 64), DW_SMEM<GATED>,
                DW_CLUSTER, st, tx, tdy, tw1, twu, tw2, static_cast<float*>(p1),
                static_cast<float*>(pu), static_cast<float*>(p2), a);
  return int(e);
}

}  // namespace

// x (M, Din), w1 (Din, H), wu (Din, H) or null, w2 (H, Dout), dy (M, Dout),
// float32 (the bf16 forms are repro_mlp_bwd_wgmma's).  out holds dX as f32
// partials (ceil(H / block_h), M, Din).
extern "C" int repro_fused_mlp_bwd_dx(const void* x, const void* w1, const void* wu,
                                      const void* w2, const void* dy, void* out, int M, int Din,
                                      int H, int Dout, int dtype, int gated, int act, int block_h,
                                      void* stream) {
  if (dtype != F32 || block_h <= 0 || block_h % OT) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(out);
  auto a = make_args<float>(x, w1, wu, w2, dy, M, Din, H, Dout, act, gated);
  return gated ? launch_dx<float, true>(a, f, block_h, st) : launch_dx<float, false>(a, f, block_h, st);
}

// dW partials over row slices of block_m rows, float32: p1 (ceil(M /
// block_m), Din, H) holds dW1 (gated: dWg, with pu the same for dWu, else
// pu is null), p2 (ceil(M / block_m), H, Dout) holds dW2 (gated: dWd).
extern "C" int repro_fused_mlp_bwd_dw(const void* x, const void* w1, const void* wu,
                                      const void* w2, const void* dy, void* p1, void* pu,
                                      void* p2, int M, int Din, int H, int Dout, int dtype,
                                      int gated, int act, int block_m, void* stream) {
  if (dtype != F32 || block_m <= 0 || block_m % RM) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *f1 = static_cast<float*>(p1), *fu = static_cast<float*>(pu), *f2 = static_cast<float*>(p2);
  auto a = make_args<float>(x, w1, wu, w2, dy, M, Din, H, Dout, act, gated);
  return gated ? launch_dw<float, true>(a, f1, fu, f2, block_m, st)
               : launch_dw<float, false>(a, f1, fu, f2, block_m, st);
}

// The f32 partials the gated (repro_swiglu_bwd_partials) and ungated
// (repro_mlp_bwd_partials) bf16 backward write at M rows and hidden width H
// (a multiple of 8): dX ceil(ceil(H / (64 DX_NJ)) / 2), with DX_NJ 3 gated
// and 6 ungated, and dW ceil(ceil(M / 256) / 8).  The caller sizes
// repro_mlp_bwd_wgmma's buffers from it.
extern "C" int repro_swiglu_bwd_partials(int M, int H, int* n_dx, int* n_dw) {
  return wg_partials<true>(M, H, n_dx, n_dw);
}
extern "C" int repro_mlp_bwd_partials(int M, int H, int* n_dx, int* n_dw) {
  return wg_partials<false>(M, H, n_dx, n_dw);
}

// The bf16 backward on TMA + wgmma: x (M, Din), w1 (Din, H), wu (Din, H)
// where gated (else null), w2 (H, Dout), dy (M, Dout), every width a
// multiple of 8 and every pointer 16-byte aligned (TMA's rule).  Writes
// f32 partials, their counts n_dx and n_dw as repro_swiglu_bwd_partials /
// repro_mlp_bwd_partials give them: dx (n_dx, M, Din), p1 (n_dw, H, Din)
// holding dW1^T (gated: dWg^T, with pu the same for dWu^T, else pu is
// null) and p2 (n_dw, H, Dout) holding dW2.  parts: 1 launches the dX
// kernel, 2 the dW kernel, 3 both.
extern "C" int repro_mlp_bwd_wgmma(const void* x, const void* w1, const void* wu, const void* w2,
                                   const void* dy, void* dx, void* p1, void* pu, void* p2, int M,
                                   int Din, int H, int Dout, int gated, int act, int parts,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gated ? launch_wgmma<true>(x, w1, wu, w2, dy, dx, p1, pu, p2, M, Din, H, Dout, act, parts, st)
               : launch_wgmma<false>(x, w1, wu, w2, dy, dx, p1, pu, p2, M, Din, H, Dout, act, parts,
                                     st);
}
