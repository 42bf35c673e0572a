// Shared device helpers for the repro_torch Hopper kernels (sm_90a).
//
// Every kernel takes float32 or bfloat16 operands and accumulates in
// float32; the decode kernels also read K/V stored as float8 e4m3 beside a
// float32 or bfloat16 q (DecodeDType).  bf16 products run on the tensor
// cores through WMMA 16x16x16 tiles; float32 products run on the SIMT
// cores through FMA, because the tensor cores offer only TF32 for float32
// operands and TF32 keeps about three decimal digits -- the float32
// contract is 2e-4.
//
// Host entry points are plain C functions (bound with ctypes): every pointer
// and the stream arrive as void*, and each function returns
// cudaGetLastError() after its launch so a refused launch surfaces at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace kt {

enum DType { F32 = 0, BF16 = 1 };
// The decode kernels' (q, K/V) operand pairs: q's DType, plus 2 where K/V
// are stored as float8 e4m3 (kernels/_build.py cuda_operands).
enum DecodeDType { DEC_F32 = 0, DEC_BF16 = 1, DEC_F32_E4M3 = 2, DEC_BF16_E4M3 = 3 };
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
// 8-byte form (cp.async.cg takes only 16 bytes; .ca also takes 4 and 8)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
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
// `scale`, positions >= the slot's valid length scored NEG_INF,
// probabilities rounded to q's dtype before P @ V, partials (o, m, l) of
// the chunk in f32 for `decode_combine_kernel`.  q is TQ (float or bf16);
// K/V are TKV, either TQ or float8 e4m3 (the float8 KV cache), converted
// to f32 in registers (e4m3 -> f16 is exact, a NaN byte stays NaN).  With
// TKV == TQ, rounding P to q's dtype is the TPU kernels' rounding to V's; an
// e4m3 V keeps P in q's dtype, not in 3 mantissa bits, as the reference's
// models decode an e4m3 cache (`_grouped_decode`: P in f32).  Scores are kept in log2
// units (scaled by scale * log2 e, exponentiated with fast_exp2), so the
// partials' m is too.
//
// Design: warps own rows.  The chunk's rows are split into DEC_NW
// contiguous runs, one per warp (and over several blocks, see `split`).
// Within a warp, LPR = DP / 8 lanes share a row, each holding 8 of its D
// values (16 bytes of bf16, 8 of e4m3), so a warp works on 32 / LPR rows at
// once.  Each lane streams its pieces of its rows' K and V together through
// its own ring of DEC_STAGES steps in shared memory (DEC_NB rows a step,
// 16-byte cp.async copies -- 8-byte ones for e4m3 --, DEC_STAGES - 1 steps
// in flight while it computes one);
// a lane reads back only what it copied, so there is no barrier of any kind
// per step.  A score is the lane's 8-wide dot reduced over its LPR lanes by
// shuffles.  Each lane group keeps an online (m, l) per query row and its
// G x 8 slice of o in registers (rescaled only when the max grows); P never
// touches shared memory.  At the end the lane groups merge by shuffles and
// the warps merge once through shared memory into the block's partials:
// m the max, l the sum of unrounded probabilities, o the sum of rounded
// probabilities times V, each rescaled to m as an online softmax does.
//
// Rows at or past the valid length are neither read nor weighted.  A chunk
// that lies wholly past a valid length >= 1 writes (o, m, l) =
// (0, NEG_INF, 0): the combine weights it by 2^(NEG_INF - m_global) == 0
// either way.  A slot with no valid position (valid <= 0) weights every row
// of the chunk by p = 1 (every score NEG_INF), as the plain version does.
//
// Bound and measurement (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): at
// phi3-medium-14b's serving shape (8 slots, 40 query / 10 kv heads of 128,
// ragged valid lengths) flash_decode takes 0.0185 ms at S = 512 (bound
// 0.0033 ms: the valid rows' K and V bytes at 3.35 TB/s) and 0.0498 ms at
// S = 4096 (bound 0.0179 ms).  Open: at 4 to 8 query rows per kv head the
// SIMT dots, shuffles and exponentials, replicated over a row's LPR lanes,
// cost as much as the loads; an mma.sync form (the query group as the
// 8-wide N of m16n8k16) would leave only the loads.
// ---------------------------------------------------------------------------

constexpr int DEC_NT = 256;             // threads per decode block
constexpr int DEC_NW = DEC_NT / 32;     // warps, one contiguous run of rows each
constexpr int DEC_NB = 2;               // rows per lane group per step
constexpr int DEC_STAGES = 4;           // steps in each lane's ring
constexpr int DEC_GMAX = 8;             // query heads per kv head
constexpr int DEC_BSMAX = 256;          // rows per split-K chunk
constexpr int DEC_MAX_SPLIT = 8;        // blocks one chunk may be spread over
constexpr float DEC_NEG_INF = -1e30f;

// Dynamic shared memory of a decode block (K/V element type T, query-group
// bucket GP, head-dim bucket DP): the lanes' rings (DEC_STAGES x DEC_NB rows
// x K and V x one 8-value piece each: half the bytes for e4m3), and over
// them once the rings are drained each warp's o (GP x DP f32), m, l and
// merge weight (GP) for the final merge; then the chunk's block-table
// entries (paged kernel).
template <typename T, int GP, int DP>
struct DecodeSmem {
  static constexpr size_t ring_bytes = size_t(DEC_STAGES) * DEC_NB * 2 * DEC_NT * 8 * sizeof(T);
  static constexpr size_t o_off = 0;
  static constexpr size_t m_off = o_off + size_t(DEC_NW) * GP * DP * sizeof(float);
  static constexpr size_t l_off = m_off + size_t(DEC_NW) * GP * sizeof(float);
  static constexpr size_t w_off = l_off + size_t(DEC_NW) * GP * sizeof(float);
  static constexpr size_t merge_end = w_off + size_t(DEC_NW) * GP * sizeof(float);
  static constexpr size_t tbl_off = align128(ring_bytes > merge_end ? ring_bytes : merge_end);
  static constexpr size_t total = tbl_off + DEC_BSMAX * sizeof(int);
};

// 8 consecutive values of a row as N words: 16-byte words for bf16 (one)
// and f32 (two), one 8-byte word for e4m3.  A lane's loads stay 8 values
// wide whatever the type, so an e4m3 row keeps bf16's lanes per row and
// registers (16 e4m3 values a lane would double a lane's q and o registers,
// past the register file at 8 query rows and D = 256).
template <typename T>
struct Piece8 {
  using Word = typename std::conditional<sizeof(T) == 1, uint2, uint4>::type;
  static constexpr int N = 8 * sizeof(T) / sizeof(Word);
  Word u[N];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = __ldg(reinterpret_cast<const Word*>(p) + i);
  }
  // word i of this thread's ring slot lies `stride` words after word i - 1
  __device__ __forceinline__ void load_shared(const Word* slot, int stride) {
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = slot[i * stride];
  }
  // copy word i of row piece p into ring word `slot + i * stride`
  // asynchronously (src_bytes 0: zero-fill, p is any valid address)
  __device__ __forceinline__ static void copy(Word* slot, int stride, const T* p,
                                              const void* dummy) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const void* src = p ? static_cast<const void*>(reinterpret_cast<const Word*>(p) + i) : dummy;
      if constexpr (sizeof(Word) == 16)
        cp_async16(slot + i * stride, src, p ? 16 : 0);
      else
        cp_async8(slot + i * stride, src, p ? 8 : 0);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = Word{};
  }
  __device__ __forceinline__ void to_float(float* f) const {
    if constexpr (sizeof(T) == 1) {
      // e4m3 pairs -> f16 pairs (cvt.rn.f16x2.e4m3x2: exact) -> f32
      const __nv_fp8x2_storage_t* h = reinterpret_cast<const __nv_fp8x2_storage_t*>(&u[0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 t = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(h[i], __NV_E4M3)));
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    } else if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    } else {
      const float* s = reinterpret_cast<const float*>(&u[0]);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = s[i];
    }
  }
};

// 2^x on the special-function unit (ex2.approx: about 2 ulp; results below
// the smallest normal flush to 0, so 2^(NEG_INF - m) is exactly 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Weight of a partial with max m in a merge whose max is mt, both in log2
// units (0 for a partial that saw no row, whose m is -inf).
__device__ __forceinline__ float merge_weight(float m, float mt) {
  return m == -INFINITY ? 0.f : fast_exp2(m - mt);
}

// One block of DEC_NT threads computes the partials of one chunk, or of its
// split-th share when a chunk is spread over n_split blocks.
//   q: this kv head's G query rows (G x D, contiguous, TQ), G <= GP
//   krow(r) / vrow(r): global address of the chunk's key / value row r
//     (TKV), or nullptr where the row does not exist (read as zeros)
//   block_s: rows in the chunk; lim: rows of the chunk before the slot's
//     valid length (may be <= 0 or > block_s); valid: the valid length
//   split of n_split: the chunk's rows are spread over the n_split * DEC_NW
//     warps of n_split blocks; this block takes split's share
//   o (G x D), m (G), l (G): this block's partials
template <typename TQ, typename TKV, int GP, int DP, typename KRow, typename VRow>
__device__ void decode_chunk(unsigned char* smem, const TQ* __restrict__ q, int G, int D,
                             KRow krow, VRow vrow, int block_s, int lim, int valid, float scale,
                             int split, int n_split, float* __restrict__ o, float* __restrict__ m,
                             float* __restrict__ l) {
  using L = DecodeSmem<TKV, GP, DP>;
  using Word = typename Piece8<TKV>::Word;
  constexpr int NWK = Piece8<TKV>::N;  // ring words per K/V piece
  constexpr int LPR = DP / 8, RPW = 32 / LPR;  // lanes per row, rows per warp step
  static_assert(LPR >= 1 && LPR <= 32, "head-dim bucket");

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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, d0 = (lane % LPR) * 8;
  const bool dok = d0 < D;
  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units

  float qf[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    Piece8<TQ> pq;
    if (g < G && dok)
      pq.load(q + g * D + d0);
    else
      pq.zero();
    pq.to_float(qf[g]);
  }
  float mo[GP], lo[GP], acc[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    mo[g] = -INFINITY;
    lo[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const int per = (rows + n_split * DEC_NW - 1) / (n_split * DEC_NW);
  const int w0 = min((split * DEC_NW + warp) * per, rows), w1 = min(w0 + per, rows);
  const int n_steps = (w1 - w0 + RPW * DEC_NB - 1) / (RPW * DEC_NB);
  // this thread's ring: word j of (step slot st, row i, K or V) at
  // ((st * DEC_NB + i) * 2 + kv) * NWK + j, in units of DEC_NT words, so a
  // warp's 32 lanes touch 32 consecutive words
  Word* ring = reinterpret_cast<Word*>(smem) + threadIdx.x;
  auto word = [&](int st, int i, int kv) {
    return ring + ((st * DEC_NB + i) * 2 + kv) * NWK * DEC_NT;
  };
  auto issue = [&](int step) {
    const int st = step % DEC_STAGES;
#pragma unroll
    for (int i = 0; i < DEC_NB; ++i) {
      const int r = w0 + (step * DEC_NB + i) * RPW + grp;
      const TKV* kp = r < w1 && dok ? krow(r) : nullptr;
      const TKV* vp = r < w1 && dok ? vrow(r) : nullptr;
      Piece8<TKV>::copy(word(st, i, 0), DEC_NT, kp ? kp + d0 : nullptr, q);
      Piece8<TKV>::copy(word(st, i, 1), DEC_NT, vp ? vp + d0 : nullptr, q);
    }
  };
#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < n_steps) issue(st);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<DEC_STAGES - 2>();  // this step's copies have landed
    if (step + DEC_STAGES - 1 < n_steps) issue(step + DEC_STAGES - 1);  // into the slot of step - 1
    cp_async_commit();
    const int st = step % DEC_STAGES, r0 = w0 + step * DEC_NB * RPW;
    float s[DEC_NB][GP];
#pragma unroll
    for (int i = 0; i < DEC_NB; ++i) {
      Piece8<TKV> kr;
      kr.load_shared(word(st, i, 0), DEC_NT);
      float kf[8];
      kr.to_float(kf);
      const int r = r0 + i * RPW + grp;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
        for (int off = LPR / 2; off; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[i][g] = r >= w1 ? -INFINITY : r < lim ? dot * scale2 : DEC_NEG_INF;
      }
    }
    float vf[DEC_NB][8];
#pragma unroll
    for (int i = 0; i < DEC_NB; ++i) {
      Piece8<TKV> vr;
      vr.load_shared(word(st, i, 1), DEC_NT);
      vr.to_float(vf[i]);
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = mo[g];
#pragma unroll
      for (int i = 0; i < DEC_NB; ++i) mx = fmaxf(mx, s[i][g]);
      if (mx == -INFINITY) continue;  // this lane group has seen no row yet
      if (mx > mo[g]) {  // a new max: rescale what was summed so far
        const float alpha = merge_weight(mo[g], mx);
        mo[g] = mx;
        lo[g] *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < DEC_NB; ++i) {
        const float p = fast_exp2(s[i][g] - mx);  // 0 for a row past the run
        lo[g] += p;
        const float pr = to_f(from_f<TQ>(p));  // rounded to q's dtype
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[i][e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the lane groups of the warp (same d slice, other rows) ...
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mo[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, lo[g], off);
      const float mt = fmaxf(mo[g], m2);
      const float a = merge_weight(mo[g], mt), b = merge_weight(m2, mt);
      lo[g] = lo[g] * a + l2 * b;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float o2 = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + o2 * b;
      }
      mo[g] = mt;
    }
  }
  // ... then the warps, once, through shared memory (over the drained rings)
  __syncthreads();
  float* so = reinterpret_cast<float*>(smem + L::o_off);
  float* sm = reinterpret_cast<float*>(smem + L::m_off);
  float* sl = reinterpret_cast<float*>(smem + L::l_off);
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) so[(warp * GP + g) * DP + d0 + e] = acc[g][e];
      if (lane == 0) {
        sm[warp * GP + g] = mo[g];
        sl[warp * GP + g] = lo[g];
      }
    }
  }
  __syncthreads();
  float* sw = reinterpret_cast<float*>(smem + L::w_off);  // [DEC_NW][GP] merge weights
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) mt = fmaxf(mt, sm[w * GP + g]);
    float sum = 0.f;  // stays 0 with m = NEG_INF for a split that read no row
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) {
      const float wt = merge_weight(sm[w * GP + g], mt);
      sw[w * GP + g] = wt;
      sum += sl[w * GP + g] * wt;
    }
    m[g] = mt == -INFINITY ? DEC_NEG_INF : mt;
    l[g] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += DEC_NT) {
    const int g = i / D, d = i % D;
    float out = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) out += so[(w * GP + g) * DP + d] * sw[w * GP + g];
    o[i] = out;
  }
}

// Merge split-K partials, the queue_reduce-style final stage of decode
// (the TPU package's `combine_partials`): one block per (batch * kv head,
// query row); a max-rescaled sum over the partials (m in log2 units), a
// zero normaliser read as 1, the result in q's dtype.  o (BH, n_part, G, D),
// m / l (BH, n_part, G), out (BH, G, D).  It is launched as a programmatic
// dependent of the chunk kernel: its blocks are scheduled while the chunk
// kernel drains and wait for its results at griddepcontrol.wait.
template <typename T>
__global__ void __launch_bounds__(DEC_NT)
decode_combine_kernel(const float* __restrict__ o, const float* __restrict__ m,
                      const float* __restrict__ l, T* __restrict__ out, int n_s, int G, int D) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row = blockIdx.x, bh = row / G, g = row % G;
  const size_t base = size_t(bh) * n_s * G + g;  // (bh, partial 0, g)
  float mg = -INFINITY;
  for (int c = 0; c < n_s; ++c) mg = fmaxf(mg, m[base + size_t(c) * G]);
  float lg = 0.f;
  for (int c = 0; c < n_s; ++c) lg += l[base + size_t(c) * G] * exp2f(m[base + size_t(c) * G] - mg);
  if (lg == 0.f) lg = 1.f;
  for (int d = threadIdx.x; d < D; d += DEC_NT) {
    float acc = 0.f;
    for (int c = 0; c < n_s; ++c)
      acc += o[(base + size_t(c) * G) * D + d] * exp2f(m[base + size_t(c) * G] - mg);
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

// Call f(std::integral_constant<int, GP>) for the smallest query-group
// bucket GP in {1, 2, 4, 8} that holds G (the decode kernels' registers).
template <typename F>
cudaError_t dispatch_group(int G, F f) {
  if (G <= 1) return f(std::integral_constant<int, 1>{});
  if (G <= 2) return f(std::integral_constant<int, 2>{});
  if (G <= 4) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

// Call f(gp, dp) once for every (GP, DP) bucket pair that dispatch_group and
// dispatch_head_dim select: every instantiation of a decode kernel.
template <typename F>
cudaError_t for_each_decode_bucket(F f) {
  for (int g : {1, 2, 4, 8})
    for (int d : {32, 64, 128, 256}) {
      cudaError_t e = dispatch_group(
          g, [&](auto gp) { return dispatch_head_dim(d, [&](auto dp) { return f(gp, dp); }); });
      if (e != cudaSuccess) return e;
    }
  return cudaSuccess;
}

// Call f(TQ*, TKV*) -- null pointers naming the types -- for a DecodeDType
// code: the decode kernels' q and K/V element types.
template <typename F>
cudaError_t dispatch_decode_dtypes(int code, F f) {
  switch (code) {
    case DEC_F32:
      return f(static_cast<float*>(nullptr), static_cast<float*>(nullptr));
    case DEC_BF16:
      return f(static_cast<__nv_bfloat16*>(nullptr), static_cast<__nv_bfloat16*>(nullptr));
    case DEC_F32_E4M3:
      return f(static_cast<float*>(nullptr), static_cast<__nv_fp8_e4m3*>(nullptr));
    case DEC_BF16_E4M3:
      return f(static_cast<__nv_bfloat16*>(nullptr), static_cast<__nv_fp8_e4m3*>(nullptr));
    default:
      return cudaErrorInvalidValue;
  }
}

// Merge the partials of a decode launch (see decode_combine_kernel).
template <typename T>
cudaError_t launch_decode_combine(const float* o, const float* m, const float* l, void* out,
                                  int rows, int n_s, int G, int D, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(DEC_NT);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, o, m, l, static_cast<T*>(out),
                                     n_s, G, D);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace kt

// Every library built from one .cu file that includes this header exports
// the message for its own error codes.
extern "C" const char* repro_error_string(int e) { return cudaGetErrorString(cudaError_t(e)); }
