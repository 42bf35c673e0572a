// Fused MLP forward on Hopper: Y = act(X @ W1) @ W2, and the gated form
// Y = (act(X @ Wg) * (X @ Wu)) @ Wd.
//
// Replaces the TPU kernels src/repro/kernels/fused_mlp.py `fused_mlp_fwd`
// (_fwd_kernel) and `fused_mlp_swiglu_fwd` (_fwd_kernel_swiglu).
//
// What must hold: Kitsune's invariant -- the (M, H) hidden tensor never
// reaches HBM.  The TPU kernel keeps a (block_m, Dout) f32 accumulator in
// VMEM across its sequential H loop; at Dout = 4096 that is 1-2 MB, and an
// SM has 227 KB of shared memory, so that design does not carry over.
//
// Design (split H across blocks): block (i, s) owns BM rows of X (128 for
// bf16, 64 for f32) and the hidden range [BH s, BH s + BH).  It builds its
// hidden chunk once, 128 columns at a time, in shared memory (act/gate
// applied in registers, rounded to the input dtype as the TPU kernel does),
// then multiplies the chunk into every 128-column tile of W2.  Operand
// tiles stream in through a 3-stage cp.async pipeline (16-byte copies) so
// the next two k-steps load while the tensor cores work on the current one.
// With one split the block writes Y directly; with n_split > 1 it writes f32
// partials (n_split, M, Dout) that the queue_reduce kernel folds -- the
// paper's split-reduction idea.  Extra traffic against a kernel that never
// spills: 2 * n_split * M * Dout * 4 bytes of partials (written, then read
// by the fold); bsp instead moves the hidden tensor, 2 * M * H * dtype
// bytes, and more for the gated form.
// No GEMM1 work is recomputed.
//
// Bound on the H100: at Llama widths (M=8192, Din=4096, H=14336, Dout=4096)
// the work is 6 * M * Din * H FLOPs against ~0.5 GB of operands -- far above
// the ~295 FLOP/byte ridge, so tensor-core throughput bounds it.  This
// version issues WMMA (mma.sync) from cp.async-staged tiles; wgmma, TMA and
// a cluster-shared accumulator are later work.
#include "common.cuh"

using namespace kt;

namespace {

constexpr int BN = 128, BK = 32, NW = 8, NT = NW * 32;
constexpr int STAGES = 3;  // cp.async pipeline depth: two k-steps in flight
// Rows per block: 128 on the tensor-core path, where the 2 x 4 warp grid's
// 64 x 32 warp tiles halve the operand bytes per FLOP of 64-row blocks;
// 64 on the f32 SIMT path, whose staging tiles are twice as wide in bytes.
template <typename T> constexpr int kBM = sizeof(T) == 2 ? 128 : 64;
template <typename T> constexpr int kWR = sizeof(T) == 2 ? 2 : 8;

// Shared memory: the hidden chunk Hs, then STAGES staging slots of
// (X tile, W tile[, Wu tile]).  The f32 epilogue tile Cs aliases the
// staging slots: it is live only between k-loops, once every copy landed.
template <typename T>
struct MlpSmem {
  int ldh, ldx, ldw;
  size_t slot, off_x, off_w, off_u, total;  // slot: elements per staging slot
  __host__ __device__ MlpSmem(int bh, bool gated) {
    ldh = bh + Pad<T>::v;
    ldx = BK + Pad<T>::v;
    ldw = BN + Pad<T>::v;
    size_t xb = align128(size_t(kBM<T>) * ldx * sizeof(T));
    size_t wb = align128(size_t(BK) * ldw * sizeof(T));
    off_x = align128(size_t(kBM<T>) * ldh * sizeof(T));
    off_w = off_x + xb;
    off_u = off_w + wb;
    slot = (xb + wb + (gated ? wb : 0)) / sizeof(T);
    size_t staging = STAGES * slot * sizeof(T);
    size_t cs = align128(size_t(kBM<T>) * (BN + 4) * sizeof(float));
    total = off_x + (staging > cs ? staging : cs);
  }
};

template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
fused_mlp_kernel(const T* __restrict__ X, const T* __restrict__ W1, const T* __restrict__ WU,
                 const T* __restrict__ W2, void* __restrict__ out, int M, int Din, int H, int Dout,
                 int BH, int act, int direct) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpSmem<T> L(BH, GATED);
  T* Hs = reinterpret_cast<T*>(smem);
  T* Xs = reinterpret_cast<T*>(smem + L.off_x);  // slot s at + s * L.slot
  T* Ws = reinterpret_cast<T*>(smem + L.off_w);
  T* Us = reinterpret_cast<T*>(smem + L.off_u);
  float* Cs = reinterpret_cast<float*>(smem + L.off_x);
  constexpr int ldc = BN + 4;
  constexpr int BM = kBM<T>;
  using Acc = BlockAcc<T, BM, BN, NW, false, kWR<T>>;
  const int m0 = blockIdx.x * BM, h0 = blockIdx.y * BH;
  const int hn = min(BH, H - h0);
  const bool vx = vec_ok(X, Din);
  const bool vw = vec_ok(W1, H) && (!GATED || vec_ok(WU, H));
  const bool v2 = vec_ok(W2, Dout);

  // Stage 1: the hidden chunk, on chip only, 128 columns at a time.
  const int nk = (Din + BK - 1) / BK;
  for (int hc = 0; hc < hn; hc += BN) {
    auto stage = [&](int kt) {
      if (kt < nk) {
        const size_t o = (kt % STAGES) * L.slot;
        const int k0 = kt * BK;
        load_tile<T, BM, BK, NT>(Xs + o, L.ldx, X, Din, m0, k0, M, Din, vx);
        load_tile<T, BK, BN, NT>(Ws + o, L.ldw, W1, H, k0, h0 + hc, Din, h0 + hn, vw);
        if constexpr (GATED)
          load_tile<T, BK, BN, NT>(Us + o, L.ldw, WU, H, k0, h0 + hc, Din, h0 + hn, vw);
      }
      cp_async_commit();
    };
    Acc g, u;
    g.zero();
    if constexpr (GATED) u.zero();
    for (int s = 0; s < STAGES - 1; ++s) stage(s);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // step kt landed
      __syncthreads();              // ... for every thread; slot (kt-1) is free
      stage(kt + STAGES - 1);
      const size_t o = (kt % STAGES) * L.slot;
      g.template mma<BK>(Xs + o, L.ldx, Ws + o, L.ldw);
      if constexpr (GATED) u.template mma<BK>(Xs + o, L.ldx, Us + o, L.ldw);
    }
    cp_async_wait<0>();
    __syncthreads();  // staging idle: Cs may overwrite it
    if constexpr (GATED) g.gate(act, u); else g.act(act);
    g.store(Cs, ldc);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
      int r = idx / BN, c = idx % BN;
      Hs[r * L.ldh + hc + c] = (hc + c < hn) ? from_f<T>(Cs[r * ldc + c]) : from_f<T>(0.f);
    }
    __syncthreads();
  }

  // Stage 2: chunk @ W2[h0 : h0 + hn, :], one 128-column tile of Y at a
  // time, W2 tiles pipelined like stage 1's.
  const int nk2 = (hn + BK - 1) / BK;  // chunk columns past hn are zero
  for (int n0 = 0; n0 < Dout; n0 += BN) {
    auto stage = [&](int kt) {
      if (kt < nk2)
        load_tile<T, BK, BN, NT>(Ws + (kt % STAGES) * L.slot, L.ldw, W2, Dout, h0 + kt * BK, n0,
                                 h0 + hn, Dout, v2);
      cp_async_commit();
    };
    Acc y;
    y.zero();
    for (int s = 0; s < STAGES - 1; ++s) stage(s);
    for (int kt = 0; kt < nk2; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      stage(kt + STAGES - 1);
      y.template mma<BK>(Hs + kt * BK, L.ldh, Ws + (kt % STAGES) * L.slot, L.ldw);
    }
    cp_async_wait<0>();
    __syncthreads();
    y.store(Cs, ldc);
    __syncthreads();
    T* outd = reinterpret_cast<T*>(out);
    float* outp = reinterpret_cast<float*>(out) + size_t(blockIdx.y) * M * Dout;
    if (m0 + BM <= M && n0 + BN <= Dout && Dout % 4 == 0) {  // interior: 4 at a time
      for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NT) {
        int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        float4 v = *reinterpret_cast<const float4*>(Cs + r * ldc + c);
        size_t o = size_t(m0 + r) * Dout + n0 + c;
        if (direct) store4(outd + o, v); else store4(outp + o, v);
      }
    } else {
      for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
        int r = idx / BN, c = idx % BN;
        int gr = m0 + r, gc = n0 + c;
        if (gr < M && gc < Dout) {
          float v = Cs[r * ldc + c];
          size_t o = size_t(gr) * Dout + gc;
          if (direct) outd[o] = from_f<T>(v); else outp[o] = v;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool GATED>
int launch(const void* x, const void* w1, const void* wu, const void* w2, void* out, int M,
           int Din, int H, int Dout, int bh, int act, int direct, cudaStream_t st) {
  const MlpSmem<T> L(bh, GATED);
  auto kern = fused_mlp_kernel<T, GATED>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
  if (e != cudaSuccess) return int(e);
  dim3 grid((M + kBM<T> - 1) / kBM<T>, (H + bh - 1) / bh);
  kern<<<grid, NT, L.total, st>>>(static_cast<const T*>(x), static_cast<const T*>(w1),
                                  static_cast<const T*>(wu), static_cast<const T*>(w2), out, M,
                                  Din, H, Dout, bh, act, direct);
  return int(cudaGetLastError());
}

}  // namespace

// x (M, Din), w1 (Din, H), wu (Din, H) or null, w2 (H, Dout), all of one
// dtype.  direct=1: out is (M, Dout) in that dtype and H <= block_h.
// direct=0: out is f32 partials (ceil(H / block_h), M, Dout).
extern "C" int repro_fused_mlp_fwd(const void* x, const void* w1, const void* wu, const void* w2,
                                   void* out, int M, int Din, int H, int Dout, int dtype,
                                   int gated, int act, int block_h, int direct, void* stream) {
  if (block_h <= 0 || block_h % BN) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return gated ? launch<__nv_bfloat16, true>(x, w1, wu, w2, out, M, Din, H, Dout, block_h, act, direct, st)
                 : launch<__nv_bfloat16, false>(x, w1, wu, w2, out, M, Din, H, Dout, block_h, act, direct, st);
  if (dtype == F32)
    return gated ? launch<float, true>(x, w1, wu, w2, out, M, Din, H, Dout, block_h, act, direct, st)
                 : launch<float, false>(x, w1, wu, w2, out, M, Din, H, Dout, block_h, act, direct, st);
  return int(cudaErrorInvalidValue);
}

