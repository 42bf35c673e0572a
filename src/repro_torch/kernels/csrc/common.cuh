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

// d/dx act_apply(act, x): the plain versions' DACTS (kernels/ref.py), the
// tanh-gelu derivative in its closed form.
__device__ __forceinline__ float dact_apply(int act, float x) {
  switch (act) {
    case ACT_RELU:
      return x > 0.f ? 1.f : 0.f;
    case ACT_GELU: {
      float t = tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x));
      float du = 0.7978845608028654f * (1.f + 3.f * 0.044715f * x * x);
      return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
    }
    case ACT_SILU: {
      float s = 1.f / (1.f + expf(-x));
      return s * (1.f + x * (1.f - s));
    }
    default:
      return 1.f;
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
// A is row-major in shared memory (A[m * lda + k]) or, with A_T, stored
// transposed (A[k * lda + m]); B is row-major (B[k * ldb + n]) or, with
// B_T, stored transposed (B[n * ldb + k]).  K is a compile-time multiple of
// 16, so the fragment double-buffer indexes registers statically.
// load/store(C, ldc) move the tile from/to float32 shared memory
// (ldc % 4 == 0).  On the tensor-core path the warps form a WR x (NW / WR)
// grid, each owning (BM / 16 / WR) x (BN / 16 / (NW / WR)) fragments: a
// squarer warp tile reuses each fragment it loads across more products.
// el(k), k < NE, is this thread's k-th accumulator element: accumulators of
// one (BM, BN, NW, WR) share one element mapping whatever their operand
// layouts, so el(k) of two of them is the same output element.
template <typename T, int BM, int BN, int NW, bool B_T, int WR, bool A_T = false> struct BlockAcc;

template <int BM, int BN, int NW, bool B_T, int WR, bool A_T>
struct BlockAcc<__nv_bfloat16, BM, BN, NW, B_T, WR, A_T> {
  static constexpr int WC = NW / WR;
  static constexpr int FR = BM / 16 / WR, FC = BN / 16 / WC;  // fragments per warp
  static_assert(WR * WC == NW && FR * WR * 16 == BM && FC * WC * 16 == BN,
                "warps must tile the block");
  using ALayout = typename std::conditional<A_T, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using BLayout = typename std::conditional<B_T, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  static constexpr int E = Frag::num_elements, NE = FR * FC * E;
  Frag c[FR][FC];
  int rb0, cb0;

  __device__ float& el(int k) { return c[k / (FC * E)][(k / E) % FC].x[k % E]; }

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
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a[2][FR];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2][FC];
    auto fetch = [&](int buf, int k) {
#pragma unroll
      for (int i = 0; i < FR; ++i)
        wmma::load_matrix_sync(
            a[buf][i], A_T ? A + k * lda + (rb0 + i) * 16 : A + (rb0 + i) * 16 * lda + k, lda);
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
template <int BM, int BN, int NW, bool B_T, int WR, bool A_T>
struct BlockAcc<float, BM, BN, NW, B_T, WR, A_T> {
  static constexpr int NT = NW * 32, TR = NT / 16;  // 16 threads across columns
  static constexpr int RI = BM / TR, CJ = BN / 16, NE = RI * CJ;
  static_assert(RI * TR == BM && CJ * 16 == BN, "threads must tile the block");
  float c[RI][CJ];
  int tr, tc;

  __device__ float& el(int k) { return c[k / CJ][k % CJ]; }

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
      for (int i = 0; i < RI; ++i) a[i] = A_T ? A[k * lda + tr + i * TR] : A[(tr + i * TR) * lda + k];
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


// ---------------------------------------------------------------------------
// Split-K single-token decode: one chunk of keys against one query group.
//
// Shared by flash_decode.cu (a dense (S, D) view per batch and kv head) and
// paged_attention.cu (rows resolved through a block table); the two differ
// only in the row-address functors they pass, so for the same chunk size the
// paged kernel is bitwise equal to gathering the view and running the dense
// one.  The math is the TPU kernels' `_decode_kernel_dyn`: f32 scores times
// `scale`, positions >= the slot's valid length scored NEG_INF, a one-shot
// max / exp / sum over the chunk (m, l), probabilities rounded to V's dtype
// before P @ V, partials (o, m, l) written in f32 for `decode_combine_kernel`.
//
// Key and value rows stream through a ring of DEC_STAGES shared-memory
// sub-tiles of DEC_R rows (16-byte cp.async pieces): first the chunk's K
// sub-tiles, whose scores go to shared memory, then its V sub-tiles.  Rows at
// or past the valid length are zero-filled instead of read: their scores are
// NEG_INF and their probabilities exactly 0, so skipping them changes no bit
// and the kernel reads only the rows the slot holds.  A chunk that lies
// wholly past a valid length >= 1 writes (o, m, l) = (0, NEG_INF, 0): the
// combine weights it by exp(NEG_INF - m_global) == 0 either way.
// ---------------------------------------------------------------------------

constexpr int DEC_NT = 128;      // threads per decode block
constexpr int DEC_R = 32;        // key/value rows per staged sub-tile
constexpr int DEC_STAGES = 4;    // sub-tiles in flight
constexpr int DEC_GMAX = 8;      // query heads per kv head
constexpr int DEC_BSMAX = 256;   // rows per split-K chunk
constexpr float DEC_NEG_INF = -1e30f;

// Dynamic shared memory of a decode block for head dims up to DP:
// q in f32 (GMAX x DP), scores / probabilities (GMAX x BSMAX), the chunk's
// block-table entries (paged kernel), and the sub-tile ring.
template <typename T, int DP>
struct DecodeSmem {
  static constexpr int LD = DP + Pad<T>::v;  // sub-tile row stride, elements
  static constexpr size_t q_off = 0;
  static constexpr size_t p_off = align128(q_off + size_t(DEC_GMAX) * DP * sizeof(float));
  static constexpr size_t tbl_off = align128(p_off + size_t(DEC_GMAX) * DEC_BSMAX * sizeof(float));
  static constexpr size_t tile_off = align128(tbl_off + DEC_BSMAX * sizeof(int));
  static constexpr size_t tile_elems = align128(size_t(DEC_R) * LD * sizeof(T)) / sizeof(T);
  static constexpr size_t total = tile_off + DEC_STAGES * tile_elems * sizeof(T);
};

// 16 bytes of shared memory as floats (4 f32 or 8 bf16 values).
__device__ __forceinline__ void unpack16(const float* p, float* f) {
  float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// One block of DEC_NT threads computes the partials of one chunk.
//   q: this kv head's G query rows (G x D, contiguous)
//   krow(r) / vrow(r): global address of the chunk's key / value row r, or
//     nullptr where the row does not exist (zero-filled)
//   block_s: rows in the chunk; lim: rows of the chunk before the slot's
//     valid length (may be <= 0 or > block_s); valid: the valid length
//   o (G x D), m (G), l (G): this chunk's partials
template <typename T, int DP, typename KRow, typename VRow>
__device__ void decode_chunk(unsigned char* smem, const T* __restrict__ q, int G, int D,
                             KRow krow, VRow vrow, int block_s, int lim, int valid, float scale,
                             float* __restrict__ o, float* __restrict__ m, float* __restrict__ l) {
  using L = DecodeSmem<T, DP>;
  constexpr int V = 16 / sizeof(T);
  constexpr int J = DEC_GMAX * DP / DEC_NT;  // P @ V outputs per thread
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ps = reinterpret_cast<float*>(smem + L::p_off);
  T* tiles = reinterpret_cast<T*>(smem + L::tile_off);

  // rows to read: those before the valid length; all of them when the slot
  // has no valid position (then every score is NEG_INF and every p is 1)
  const int rows = lim >= 1 ? min(lim, block_s) : (valid <= 0 ? block_s : 0);
  if (rows == 0) {
    for (int i = threadIdx.x; i < G * D; i += DEC_NT) o[i] = 0.f;
    for (int g = threadIdx.x; g < G; g += DEC_NT) {
      m[g] = DEC_NEG_INF;
      l[g] = 0.f;
    }
    return;
  }
  const int nsub = (rows + DEC_R - 1) / DEC_R;  // sub-tiles per operand
  const int ntiles = 2 * nsub;                   // K sub-tiles, then V
  const int pieces = D / V;                      // 16-byte pieces per row

  auto issue = [&](int t) {
    T* dst = tiles + (t % DEC_STAGES) * L::tile_elems;
    const bool is_v = t >= nsub;
    const int r0 = (is_v ? t - nsub : t) * DEC_R;
    for (int idx = threadIdx.x; idx < DEC_R * pieces; idx += DEC_NT) {
      const int rr = idx / pieces, c = (idx % pieces) * V, r = r0 + rr;
      const T* src = r < rows ? (is_v ? vrow(r) : krow(r)) : nullptr;
      cp_async16(dst + rr * L::LD + c, src ? src + c : q, src ? 16 : 0);
    }
  };

  for (int i = threadIdx.x; i < G * D; i += DEC_NT) qs[(i / D) * DP + i % D] = to_f(q[i]);
  for (int i = threadIdx.x; i < G * block_s; i += DEC_NT)
    if (i % block_s >= nsub * DEC_R) ps[(i / block_s) * DEC_BSMAX + i % block_s] = DEC_NEG_INF;
#pragma unroll
  for (int t = 0; t < DEC_STAGES - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
  }
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // sub-tile t (and q) visible; every thread done with t - 1
    if (t + DEC_STAGES - 1 < ntiles) issue(t + DEC_STAGES - 1);
    cp_async_commit();
    const T* tile = tiles + (t % DEC_STAGES) * L::tile_elems;
    if (t < nsub) {
      // scores of key rows [t * R, t * R + R): one (query row, key row) per thread
      for (int idx = threadIdx.x; idx < G * DEC_R; idx += DEC_NT) {
        const int g = idx / DEC_R, rr = idx % DEC_R, r = t * DEC_R + rr;
        if (r >= block_s) continue;
        float s = DEC_NEG_INF;
        if (r < lim) {
          const T* kr = tile + rr * L::LD;
          const float* qg = qs + g * DP;
          float dot = 0.f;
          for (int d = 0; d < D; d += V) {
            float kf[V];
            unpack16(kr + d, kf);
#pragma unroll
            for (int e = 0; e < V; ++e) dot = fmaf(qg[d + e], kf[e], dot);
          }
          s = dot * scale;
        }
        ps[g * DEC_BSMAX + r] = s;
      }
      continue;
    }
    if (t == nsub) {
      // one warp per query row: m = max, p = exp(s - m), l = sum p; p is
      // stored rounded to V's dtype for P @ V, l sums the unrounded p
      for (int g = warp; g < G; g += DEC_NT / 32) {
        float* pg = ps + g * DEC_BSMAX;
        float mx = -INFINITY;
        for (int r = lane; r < block_s; r += 32) mx = fmaxf(mx, pg[r]);
#pragma unroll
        for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
        for (int r = lane; r < block_s; r += 32) {
          const float p = expf(pg[r] - mx);
          sum += p;
          pg[r] = to_f(from_f<T>(p));
        }
#pragma unroll
        for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          m[g] = mx;
          l[g] = sum;
        }
      }
      __syncthreads();
    }
    // P @ V over value rows [r0, r0 + R) before `rows` (later rows have p == 0)
    const int r0 = (t - nsub) * DEC_R, r1 = min(r0 + DEC_R, rows);
    for (int r = r0; r < r1; ++r) {
      const T* vr = tile + (r - r0) * L::LD;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int idx = threadIdx.x + j * DEC_NT, g = idx / DP, d = idx % DP;
        if (g < G && d < D) acc[j] = fmaf(ps[g * DEC_BSMAX + r], to_f(vr[d]), acc[j]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int idx = threadIdx.x + j * DEC_NT, g = idx / DP, d = idx % DP;
    if (g < G && d < D) o[g * D + d] = acc[j];
  }
}

// Merge split-K partials, the queue_reduce-style final stage of decode
// (the TPU package's `combine_partials`): one block per (batch * kv head,
// query row); a max-rescaled sum over the chunks, a zero normaliser read as
// 1, the result in q's dtype.  o (BH, n_s, G, D), m / l (BH, n_s, G),
// out (BH, G, D).
template <typename T>
__global__ void __launch_bounds__(DEC_NT)
decode_combine_kernel(const float* __restrict__ o, const float* __restrict__ m,
                      const float* __restrict__ l, T* __restrict__ out, int n_s, int G, int D) {
  const int row = blockIdx.x, bh = row / G, g = row % G;
  const size_t base = size_t(bh) * n_s * G + g;  // (bh, chunk 0, g)
  float mg = -INFINITY;
  for (int c = 0; c < n_s; ++c) mg = fmaxf(mg, m[base + size_t(c) * G]);
  float lg = 0.f;
  for (int c = 0; c < n_s; ++c) lg += l[base + size_t(c) * G] * expf(m[base + size_t(c) * G] - mg);
  if (lg == 0.f) lg = 1.f;
  for (int d = threadIdx.x; d < D; d += DEC_NT) {
    float acc = 0.f;
    for (int c = 0; c < n_s; ++c)
      acc += o[(base + size_t(c) * G) * D + d] * expf(m[base + size_t(c) * G] - mg);
    out[size_t(row) * D + d] = from_f<T>(acc / lg);
  }
}

// Call f(std::integral_constant<int, DP>) for the smallest head-dim bucket
// DP in {32, 64, 128, 256} that holds D (the decode kernels' template).
template <typename F>
cudaError_t dispatch_head_dim(int D, F f) {
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

// Merge the partials of a decode launch (see decode_combine_kernel).
template <typename T>
cudaError_t launch_decode_combine(const float* o, const float* m, const float* l, void* out,
                                  int rows, int n_s, int G, int D, cudaStream_t st) {
  decode_combine_kernel<T><<<rows, DEC_NT, 0, st>>>(o, m, l, static_cast<T*>(out), n_s, G, D);
  return cudaGetLastError();
}

}  // namespace kt

// Every library built from one .cu file that includes this header exports
// the message for its own error codes.
extern "C" const char* repro_error_string(int e) { return cudaGetErrorString(cudaError_t(e)); }
