// Shared device helpers for the repro_torch Hopper kernels (sm_90a).
//
// Every kernel takes float32 or bfloat16 operands and accumulates in
// float32.  bf16 products run on the tensor cores through WMMA 16x16x16
// tiles; float32 products run on the SIMT cores through FMA, because the
// tensor cores offer only TF32 for float32 operands and TF32 keeps about
// three decimal digits -- the float32 contract is 2e-4.
//
// Host entry points are plain C functions (bound with ctypes): every pointer
// and the stream arrive as void*, and each function returns
// cudaGetLastError() after its launch so a refused launch surfaces at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace kt {

enum DType { F32 = 0, BF16 = 1 };
enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

// Same formulas as the plain versions: gelu is the tanh approximation
// (jax.nn.gelu's default, F.gelu(approximate="tanh")).
__device__ __forceinline__ float act_apply(int act, float x) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_GELU: {
      float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(u));
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Row padding (elements) of shared-memory tiles: 16 bytes, so every row
// starts 16-byte aligned for cp.async; for bf16 it also keeps every WMMA
// pointer 32-byte aligned and the leading dimension a multiple of 8.
template <typename T> struct Pad { static constexpr int v = 16 / sizeof(T); };

// Byte offset rounded up to 128 for carving dynamic shared memory.
__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// A BM x BN float32 accumulator spread over the NW warps of a block.
//   mma<K>(A, lda, B, ldb):  acc += A[BM x K] @ B[K x BN]
// A is row-major in shared memory; B is row-major (B[k * ldb + n]) or, with
// B_T, stored transposed (B[n * ldb + k]).  K is a compile-time multiple of
// 16, so the fragment double-buffer indexes registers statically.
// load/store(C, ldc) move the tile from/to float32 shared memory
// (ldc % 4 == 0).  On the tensor-core path the warps form a WR x (NW / WR)
// grid, each owning (BM / 16 / WR) x (BN / 16 / (NW / WR)) fragments: a
// squarer warp tile reuses each fragment it loads across more products.
template <typename T, int BM, int BN, int NW, bool B_T, int WR> struct BlockAcc;

template <int BM, int BN, int NW, bool B_T, int WR>
struct BlockAcc<__nv_bfloat16, BM, BN, NW, B_T, WR> {
  static constexpr int WC = NW / WR;
  static constexpr int FR = BM / 16 / WR, FC = BN / 16 / WC;  // fragments per warp
  static_assert(WR * WC == NW && FR * WR * 16 == BM && FC * WC * 16 == BN,
                "warps must tile the block");
  using BLayout = typename std::conditional<B_T, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[FR][FC];
  int rb0, cb0;

  __device__ BlockAcc() {
    int w = threadIdx.x >> 5;
    rb0 = (w % WR) * FR;
    cb0 = (w / WR) * FC;
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int f = 0; f < FC; ++f) nvcuda::wmma::fill_fragment(c[i][f], 0.f);
  }
  // Fragments of step k + 16 load while step k's products issue (two
  // register sets), so shared-memory latency hides behind the tensor cores.
  template <int K>
  __device__ void mma(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2][FR];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2][FC];
    auto fetch = [&](int buf, int k) {
#pragma unroll
      for (int i = 0; i < FR; ++i)
        wmma::load_matrix_sync(a[buf][i], A + (rb0 + i) * 16 * lda + k, lda);
#pragma unroll
      for (int f = 0; f < FC; ++f)
        wmma::load_matrix_sync(
            b[buf][f], B_T ? B + (cb0 + f) * 16 * ldb + k : B + k * ldb + (cb0 + f) * 16, ldb);
    };
    fetch(0, 0);
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      const int cur = (k / 16) & 1;
      if (k + 16 < K) fetch(cur ^ 1, k + 16);
#pragma unroll
      for (int f = 0; f < FC; ++f)
#pragma unroll
        for (int i = 0; i < FR; ++i) wmma::mma_sync(c[i][f], a[cur][i], b[cur][f], c[i][f]);
    }
  }
  // Elementwise epilogues.  Accumulator fragments of one shape share one
  // element mapping, so pairing c[i][f].x[e] with up.c[i][f].x[e] is exact.
  __device__ void act(int a) {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int f = 0; f < FC; ++f)
        for (int e = 0; e < c[i][f].num_elements; ++e) c[i][f].x[e] = act_apply(a, c[i][f].x[e]);
  }
  __device__ void gate(int a, const BlockAcc& up) {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int f = 0; f < FC; ++f)
        for (int e = 0; e < c[i][f].num_elements; ++e)
          c[i][f].x[e] = act_apply(a, c[i][f].x[e]) * up.c[i][f].x[e];
  }
  __device__ void load(const float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int f = 0; f < FC; ++f)
        nvcuda::wmma::load_matrix_sync(c[i][f], C + (rb0 + i) * 16 * ldc + (cb0 + f) * 16, ldc,
                                       nvcuda::wmma::mem_row_major);
  }
  __device__ void store(float* C, int ldc) const {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int f = 0; f < FC; ++f)
        nvcuda::wmma::store_matrix_sync(C + (rb0 + i) * 16 * ldc + (cb0 + f) * 16, c[i][f], ldc,
                                        nvcuda::wmma::mem_row_major);
  }
};

// The SIMT path ignores WR: 16 threads across the columns, the rest down
// the rows.
template <int BM, int BN, int NW, bool B_T, int WR>
struct BlockAcc<float, BM, BN, NW, B_T, WR> {
  static constexpr int NT = NW * 32, TR = NT / 16;  // 16 threads across columns
  static constexpr int RI = BM / TR, CJ = BN / 16;
  static_assert(RI * TR == BM && CJ * 16 == BN, "threads must tile the block");
  float c[RI][CJ];
  int tr, tc;

  __device__ BlockAcc() {
    tr = threadIdx.x / 16;
    tc = threadIdx.x % 16;
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[i][j] = 0.f;
  }
  template <int K>
  __device__ void mma(const float* A, int lda, const float* B, int ldb) {
    for (int k = 0; k < K; ++k) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = A[(tr + i * TR) * lda + k];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = B_T ? B[(tc + j * 16) * ldb + k] : B[k * ldb + tc + j * 16];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ void act(int a) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[i][j] = act_apply(a, c[i][j]);
  }
  __device__ void gate(int a, const BlockAcc& up) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[i][j] = act_apply(a, c[i][j]) * up.c[i][j];
  }
  __device__ void load(const float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[i][j] = C[(tr + i * TR) * ldc + tc + j * 16];
  }
  __device__ void store(float* C, int ldc) const {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) C[(tr + i * TR) * ldc + tc + j * 16] = c[i][j];
  }
};

// Store four consecutive floats as T (16 bytes of f32, 8 of bf16); the
// address must be aligned to that size.
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether rows of a row-major matrix with leading dimension ld can be read
// in 16-byte pieces: the base pointer and every row start 16-byte aligned.
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, size_t ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % (16 / sizeof(T)) == 0;
}

// Copy a ROWS x COLS tile of a row-major global matrix (leading dimension
// ld) into shared memory (leading dimension lds), zero-filling whatever lies
// outside [0, nrows) x [0, ncols): the kernels mask their own ragged edges
// instead of asking the caller to pad.  With `vec` (see vec_ok; c0 a
// multiple of 16 bytes) the copy is asynchronous, one 16-byte cp.async per
// piece, and the caller fences it with cp_async_commit / cp_async_wait;
// otherwise it falls back to element loads, complete on return.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(T* dst, int lds, const T* src, size_t ld, int r0, int c0,
                                          int nrows, int ncols, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), CH = COLS / V;
    if constexpr ((ROWS * CH) % NT == 0) {
      // interior tile: no per-piece bounds arithmetic (it costs issue slots
      // the tensor-core work shares)
      if (r0 + ROWS <= nrows && c0 + COLS <= ncols) {
        const T* s0 = src + size_t(r0) * ld + c0;
#pragma unroll
        for (int it = 0; it < ROWS * CH / NT; ++it) {
          int idx = threadIdx.x + it * NT;
          int r = idx / CH, c = (idx % CH) * V;
          cp_async16(dst + r * lds + c, s0 + size_t(r) * ld + c, 16);
        }
        return;
      }
    }
#pragma unroll
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
      int r = idx / CH, c = (idx % CH) * V;
      int gr = r0 + r, gc = c0 + c;
      int n = gr < nrows ? max(0, min(V, ncols - gc)) : 0;
      cp_async16(dst + r * lds + c, n > 0 ? src + size_t(gr) * ld + gc : src,
                 n * int(sizeof(T)));
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += NT) {
    int r = idx / COLS, c = idx % COLS;
    int gr = r0 + r, gc = c0 + c;
    dst[r * lds + c] = (gr < nrows && gc < ncols) ? src[size_t(gr) * ld + gc] : from_f<T>(0.f);
  }
}

}  // namespace kt

// Every library built from one .cu file that includes this header exports
// the message for its own error codes.
extern "C" const char* repro_error_string(int e) { return cudaGetErrorString(cudaError_t(e)); }
