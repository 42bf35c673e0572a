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
// Work: 11 GEMMs for the gated form (dX: 5, dW: 6, the TPU kernels' count)
// and 7 for the two-matrix one; at gemma3-1b's training shape (M 8192,
// 1152 -> 6912 -> 1152) that is 1.44 TFLOP, tensor-core bound on the card.
// The partials add bytes: 2 * 4 * (n_split * M * Din + n_ms * |dW|).  This
// version issues WMMA (mma.sync) from cp.async-staged tiles; wgmma, TMA and
// a cluster accumulator that would remove the partials are later work.
#include "common.cuh"

using namespace kt;

namespace {

constexpr int NW = 8, NT = NW * 32;
constexpr int BK = 32;   // k-step of every staged GEMM
constexpr int RM = 64;   // rows of a recompute tile
constexpr int OT = 128;  // width of a dX / dW output tile
template <typename T> constexpr int kStages = sizeof(T) == 2 ? 3 : 2;

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
    size_t staging = kStages<T> * slot * sizeof(T);
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
  constexpr int P = Pad<T>::v, LDA = BK + P, LDW = RN + P, STG = kStages<T>;
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
  constexpr int P = Pad<T>::v, LDB = BK + P, STG = kStages<T>;
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
  constexpr int P = Pad<T>::v, LDS = OT + P, STG = kStages<T>;
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

}  // namespace

// x (M, Din), w1 (Din, H), wu (Din, H) or null, w2 (H, Dout), dy (M, Dout),
// one dtype.  out holds dX as f32 partials (ceil(H / block_h), M, Din).
extern "C" int repro_fused_mlp_bwd_dx(const void* x, const void* w1, const void* wu,
                                      const void* w2, const void* dy, void* out, int M, int Din,
                                      int H, int Dout, int dtype, int gated, int act, int block_h,
                                      void* stream) {
  if (block_h <= 0 || block_h % OT) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(out);
  if (dtype == BF16) {
    auto a = make_args<__nv_bfloat16>(x, w1, wu, w2, dy, M, Din, H, Dout, act, gated);
    return gated ? launch_dx<__nv_bfloat16, true>(a, f, block_h, st)
                 : launch_dx<__nv_bfloat16, false>(a, f, block_h, st);
  }
  if (dtype == F32) {
    auto a = make_args<float>(x, w1, wu, w2, dy, M, Din, H, Dout, act, gated);
    return gated ? launch_dx<float, true>(a, f, block_h, st)
                 : launch_dx<float, false>(a, f, block_h, st);
  }
  return int(cudaErrorInvalidValue);
}

// dW partials over row slices of block_m rows: p1 (ceil(M / block_m), Din, H)
// holds dW1 (gated: dWg, with pu the same for dWu, else pu is null), p2
// (ceil(M / block_m), H, Dout) holds dW2 (gated: dWd), all f32.
extern "C" int repro_fused_mlp_bwd_dw(const void* x, const void* w1, const void* wu,
                                      const void* w2, const void* dy, void* p1, void* pu,
                                      void* p2, int M, int Din, int H, int Dout, int dtype,
                                      int gated, int act, int block_m, void* stream) {
  if (block_m <= 0 || block_m % RM) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *f1 = static_cast<float*>(p1), *fu = static_cast<float*>(pu), *f2 = static_cast<float*>(p2);
  if (dtype == BF16) {
    auto a = make_args<__nv_bfloat16>(x, w1, wu, w2, dy, M, Din, H, Dout, act, gated);
    return gated ? launch_dw<__nv_bfloat16, true>(a, f1, fu, f2, block_m, st)
                 : launch_dw<__nv_bfloat16, false>(a, f1, fu, f2, block_m, st);
  }
  if (dtype == F32) {
    auto a = make_args<float>(x, w1, wu, w2, dy, M, Din, H, Dout, act, gated);
    return gated ? launch_dw<float, true>(a, f1, fu, f2, block_m, st)
                 : launch_dw<float, false>(a, f1, fu, f2, block_m, st);
  }
  return int(cudaErrorInvalidValue);
}
