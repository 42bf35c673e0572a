// Flash attention forward on Hopper: online-softmax attention with causal
// and sliding-window masks and grouped KV heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention` (_attn_kernel).  Same semantics: scores in f32, the
// causal mask start-aligned (query i sees keys <= i; lowering only uses it
// with sq == skv), masked scores set to NEG_INF = -1e30 (not -inf),
// probabilities rounded to the value dtype before P @ V, a row whose
// normaliser is 0 divided by 1, kv head h / (Hq / Hkv) for query head h.
// The (S, S) score matrix never exists in HBM.
//
// bf16, the path every caller takes (wgmma_attention_kernel): one block per
// (batch * query head, 128 query rows), 3 warpgroups.  Warpgroup 0 is the
// producer: one thread loads the Q tile once and then K and V tiles of 128
// keys into 2-stage rings of shared memory with TMA (128-byte swizzle, the
// layout wgmma reads; out-of-range rows and columns arrive as zeros, so a
// ragged Sq / Skv and a head dim below the 64 / 128 bucket need no
// padding), K and V each with their own full / empty mbarriers.
// Warpgroups 1 and 2 each own 64 query rows: S = Q K^T is one wgmma
// m64n128k16 chain out of shared memory into registers; the softmax runs in
// registers (scale folded with log2 e, ex2.approx, row max and sum over the
// 4 lanes of a quad, masks only on tiles that cross the diagonal, a window
// edge or Skv); P is rounded to bf16 in registers and fed as wgmma's
// register A operand against V (transposed-B form, V read as stored) into
// O, which stays in registers (64 f32 a thread at D = 128) and is written
// once.  No S, P or O tile goes through shared memory.  Each warpgroup
// issues S(t) and P(t-1) V(t-1) together and takes tile t's softmax while
// they run; the two warpgroups take turns to issue (named barriers), so
// one's softmax overlaps the other's products.  setmaxnreg moves registers
// from the producer to the consumers.  Causal blocks stop at their diagonal
// tile.  The grid runs one head's query tiles side by side (its K and V
// stay in L2 across them), heaviest causal tiles first.
//
// Bound on the H100: at (4, 32, 2048, 128) bf16 causal the work is
// 2 * B * H * S^2 * D FLOPs (half of the dense 4 * B * H * S^2 * D) against
// 4 * B * H * S * D * 2 bytes, ~1000 FLOP/byte -- tensor-core bound:
// 0.139 ms at 989 TFLOP/s.  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py, phase 3): 0.325 ms, against 0.261 ms for
// F.scaled_dot_product_attention (PERF.md, B3).  Open: the diagonal tile is
// computed whole by both warpgroups, and a persistent grid would overlap one
// tile's epilogue with the next one's loads.
//
// float32 (simt_attention_kernel, only the checks use it): the first port's
// design, kept as it was -- one block of 4 warps per 64 query rows, K/V
// tiles of 64 keys through cp.async, FMA products, S, P and O in shared
// memory.  Head dim D <= 128.
#include "common.cuh"
#include "sm90.cuh"

using namespace kt;

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: SIMT
// ---------------------------------------------------------------------------

constexpr int BQ = 64, BKV = 64, DMAX = 128, NW = 4, NT = NW * 32;

template <typename T>
struct AttnSmem {
  int ld, lds, ldp, ldo;
  size_t off_k, off_v, off_s, off_p, off_o, total;
  __host__ __device__ AttnSmem() {
    ld = DMAX + Pad<T>::v;
    lds = BKV + 4;
    ldp = BKV + Pad<T>::v;
    ldo = DMAX + 4;
    size_t qkv = align128(size_t(BQ) * ld * sizeof(T));
    off_k = qkv;
    off_v = off_k + qkv;
    off_s = off_v + qkv;
    off_p = off_s + align128(size_t(BQ) * lds * sizeof(float));
    off_o = off_p + align128(size_t(BQ) * ldp * sizeof(T));
    total = off_o + align128(size_t(BQ) * ldo * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
simt_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                       int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem<T> L;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + L.off_k);
  T* Vs = reinterpret_cast<T*>(smem + L.off_v);
  float* Ss = reinterpret_cast<float*>(smem + L.off_s);
  T* Ps = reinterpret_cast<T*>(smem + L.off_p);
  float* Os = reinterpret_cast<float*>(smem + L.off_o);

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + size_t(bh) * Sq * D;
  const T* kb = k + (size_t(b) * Hkv + kvh) * Skv * D;
  const T* vb = v + (size_t(b) * Hkv + kvh) * Skv * D;

  const bool vq = vec_ok(qb, D), vk = vec_ok(kb, D) && vec_ok(vb, D);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, qi = q0 + r;
  float m_i = NEG_INF, l_i = 0.f;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_start = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;

  // Copies run ahead of the math in two cp.async groups: K of the next tile
  // loads during this tile's softmax and P @ V, V of the next tile during
  // the next S = Q K^T.  wait_group<1> at each use leaves exactly the other
  // operand's copy in flight.
  load_tile<T, BQ, DMAX, NT>(Qs, L.ld, qb, D, q0, 0, Sq, D, vq);
  load_tile<T, BKV, DMAX, NT>(Ks, L.ld, kb, D, kv_start, 0, Skv, D, vk);
  cp_async_commit();
  load_tile<T, BKV, DMAX, NT>(Vs, L.ld, vb, D, kv_start, 0, Skv, D, vk);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < BQ * DMAX; idx += NT) Os[(idx / DMAX) * L.ldo + idx % DMAX] = 0.f;

  for (int k0 = kv_start; k0 < kv_end; k0 += BKV) {
    const bool more = k0 + BKV < kv_end;
    cp_async_wait<1>();  // Q and this tile's K
    __syncthreads();
    {
      BlockAcc<T, BQ, BKV, NW, true, 2> s;
      s.zero();
      s.template mma<DMAX>(Qs, L.ld, Ks, L.ld);  // columns past D are zero-filled
      s.store(Ss, L.lds);
    }
    __syncthreads();
    if (more) load_tile<T, BKV, DMAX, NT>(Ks, L.ld, kb, D, k0 + BKV, 0, Skv, D, vk);
    cp_async_commit();

    constexpr int HC = BKV / 2;
    float sv[HC];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      int c = half * HC + j, ki = k0 + c;
      bool ok = ki < Skv && (!causal || qi >= ki) && (window <= 0 || qi - ki < window);
      sv[j] = ok ? Ss[r * L.lds + c] * scale : NEG_INF;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      float p = expf(sv[j] - m_new);
      sum += p;
      Ps[r * L.ldp + half * HC + j] = from_f<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    for (int j = 0; j < DMAX / 2; ++j) Os[r * L.ldo + half * (DMAX / 2) + j] *= alpha;
    cp_async_wait<1>();  // this tile's V
    __syncthreads();
    {
      BlockAcc<T, BQ, DMAX, NW, false, 2> acc;
      acc.load(Os, L.ldo);
      acc.template mma<BKV>(Ps, L.ldp, Vs, L.ld);
      acc.store(Os, L.ldo);
    }
    __syncthreads();
    if (more) load_tile<T, BKV, DMAX, NT>(Vs, L.ld, vb, D, k0 + BKV, 0, Skv, D, vk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const float l = l_i == 0.f ? 1.f : l_i;
  if (qi < Sq) {
    T* ob = o + (size_t(bh) * Sq + qi) * D;
    for (int j = 0; j < DMAX / 2; ++j) {
      int c = half * (DMAX / 2) + j;
      if (c < D) ob[c] = from_f<T>(Os[r * L.ldo + c] / l);
    }
  }
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int Sq, int Skv, int D, float scale, int causal, int window,
                        cudaStream_t st) {
  const AttnSmem<T> L;
  auto kern = simt_attention_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, NT, L.total, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                  static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv,
                                  D, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, O in registers
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 128, WG_STAGES = 2, WG_NT = 384;
constexpr int CONSUMER_WARPS = 8;

// Shared memory of one block for head-dim bucket DP (64 or 128): the Q tile
// and WG_STAGES K and V tiles, each stored as DP / 64 atom columns of
// rows x 64 bf16 (see sm90.cuh), then the mbarriers.  +1024 for aligning the
// dynamic base to the swizzle atom.
template <int DP>
struct WgSmem {
  static constexpr int Q_BYTES = WG_BM * DP * 2, KV_BYTES = WG_BN * DP * 2;
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + WG_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + WG_STAGES * KV_BYTES;
  static constexpr int TOTAL = BAR_OFF + (4 * WG_STAGES + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(o, a, db);
  else
    wgmma_rs_n128(o, a, db);
}

// One consumer warpgroup's online-softmax state.  The thread holds rows
// row_lo and row_lo + 8 of every accumulator (the wgmma D layout: per
// 8-column chunk j, elements 4j, 4j+1 at row_lo, 4j+2, 4j+3 at row_lo + 8,
// columns 8j + 2 * (lane % 4) + {0, 1}).
template <int DP>
struct Consumer {
  float o[DP / 2];
  uint32_t p[WG_BN / 16][4];  // P of the last softmax as wgmma A fragments
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  int row_lo, col_in, r0;

  // S = Q K^T of this warpgroup's 64 rows against one K tile, issued
  __device__ __forceinline__ void issue_s(float* s, const __nv_bfloat16* qs,
                                          const __nv_bfloat16* ks) const {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n128t<0, 0>(s, sw128_desc(qs + (kk / 4) * WG_BM * 64 + (kk % 4) * 16, 16, 1024),
                    sw128_desc(ks + (kk / 4) * WG_BN * 64 + (kk % 4) * 16, 16, 1024), kk > 0);
  }
  // O += P V, issued
  __device__ __forceinline__ void issue_pv(const __nv_bfloat16* vs) {
#pragma unroll
    for (int kk = 0; kk < WG_BN / 16; ++kk)
      wgmma_pv<DP>(o, p[kk], sw128_desc(vs + kk * 16 * 64, WG_BN * 128, 1024));
  }
  // Scores of the tile at key k0 to probabilities, in place in s (log2
  // domain; masks only where the tile crosses Skv, the diagonal or the
  // window's edge); returns the rescale factors of O and l through al_*.
  __device__ __forceinline__ void softmax(float* s, int k0, int Skv, int causal, int window,
                                          float scale_log2, float& al_lo, float& al_hi) {
    const bool edge = k0 + WG_BN > Skv || (causal && k0 + WG_BN - 1 > r0) ||
                      (window > 0 && r0 + 63 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + col_in + (i & 1);
        const int row = row_lo + ((i & 2) ? 8 : 0);
        const bool ok = col < Skv && (!causal || row >= col) && (window <= 0 || row - col < window);
        s[i] = ok ? s[i] * scale_log2 : NEG_INF;
      }
    } else {
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) s[i] *= scale_log2;
    }
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int i = 0; i < WG_BN / 2; i += 4) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[i], s[i + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[i + 2], s[i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    al_lo = fast_exp2(m_lo - mn_lo);
    al_hi = fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < WG_BN / 2; i += 4) {
      s[i] = fast_exp2(s[i] - mn_lo);
      s[i + 1] = fast_exp2(s[i + 1] - mn_lo);
      s[i + 2] = fast_exp2(s[i + 2] - mn_hi);
      s[i + 3] = fast_exp2(s[i + 3] - mn_hi);
      sum_lo += s[i] + s[i + 1];
      sum_hi += s[i + 2] + s[i + 3];
    }
    l_lo = l_lo * al_lo + sum_lo;  // per-thread partial sums, reduced at the end
    l_hi = l_hi * al_hi + sum_hi;
  }
  __device__ __forceinline__ void rescale(float al_lo, float al_hi) {
#pragma unroll
    for (int i = 0; i < DP / 2; i += 4) {
      o[i] *= al_lo;
      o[i + 1] *= al_lo;
      o[i + 2] *= al_hi;
      o[i + 3] *= al_hi;
    }
  }
  // P rounded to bf16 as wgmma's A fragments: k-slice kk (keys 16kk ..
  // 16kk + 15) is S's chunks 2kk and 2kk + 1
  __device__ __forceinline__ void to_fragments(const float* s) {
#pragma unroll
    for (int kk = 0; kk < WG_BN / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
  // Keep P's registers live until the product reading them has completed.
  __device__ __forceinline__ void hold_fragments() {
#pragma unroll
    for (int kk = 0; kk < WG_BN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[kk][j])::"memory");
  }
};

// q (B * Hq, Sq, D), k/v (B * Hkv, Skv, D) through tensor maps with boxes
// (64, 128, 1); o (B, Hq, Sq, D).  scale_log2 = scale * log2(e).
//
// Per consumer warpgroup and K/V tile t the order is: issue S(t) = Q K(t)^T,
// issue O += P(t-1) V(t-1), wait for S(t), release K(t), softmax S(t) into
// P(t) while the P V product runs, wait for it, release V(t-1), rescale O.
// The tensor cores so work on one tile's P V while the same warpgroup does
// the next tile's exponentials.  K and V have their own full / empty
// barriers, so a K slot is refilled as soon as its scores are taken.
template <int DP>
__global__ void __launch_bounds__(WG_NT, 1)
wgmma_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int Hq, int Hkv, int Sq, int Skv, int D, float scale_log2, int causal,
                       int window) {
  using L = WgSmem<DP>;
  constexpr int ATOMS = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto Ks = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF + s * L::KV_BYTES);
  };
  auto Vs = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF + s * L::KV_BYTES);
  };
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_v = full_k + WG_STAGES;
  uint64_t* empty_k = full_v + WG_STAGES;
  uint64_t* empty_v = empty_k + WG_STAGES;
  uint64_t* qbar = empty_v + WG_STAGES;

  // blocks of one head run side by side, so its K and V stay in L2 while
  // they are read once per query tile; within a head the heaviest causal
  // tiles come first
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kv_bh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BM;
  const int kv_end = causal ? min(Skv, q0 + WG_BM) : Skv;
  const int kv_start = window > 0 ? max(0, q0 - window + 1) / WG_BN * WG_BN : 0;
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + WG_BN - 1) / WG_BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONSUMER_WARPS);
      mbar_init(&empty_v[s], CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int a = 0; a < ATOMS; ++a) tma_load_3d(Qs + a * WG_BM * 64, &tq, qbar, a * 64, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % WG_STAGES, k0 = kv_start + t * WG_BN;
        const uint32_t free_parity = ((t / WG_STAGES) & 1) ^ 1;
        mbar_wait(&empty_k[s], free_parity);
        mbar_expect_tx(&full_k[s], L::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_3d(Ks(s) + a * WG_BN * 64, &tk, &full_k[s], a * 64, k0, kv_bh);
        mbar_wait(&empty_v[s], free_parity);
        mbar_expect_tx(&full_v[s], L::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_3d(Vs(s) + a * WG_BN * 64, &tv, &full_v[s], a * 64, k0, kv_bh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // consumer warpgroup cw owns query rows r0 .. r0 + 63
  const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  Consumer<DP> c;
  c.r0 = q0 + cw * 64;
  c.row_lo = c.r0 + warp * 16 + lane / 4;
  c.col_in = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) c.o[i] = 0.f;
  const __nv_bfloat16* qs = Qs + cw * 64 * 64;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // The two consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2), so one's softmax runs while the other's products do.
  // Each issues n_tiles + 1 times; warpgroup 1 opens warpgroup 0's first
  // turn and does not pass its own last one, so every arrival is consumed.
  auto my_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
  };
  auto pass_turn = [&](bool last) {
    if (!(last && cw == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
  };
  if (cw == 1 && n_tiles > 0) pass_turn(false);

  mbar_wait(qbar, 0);
  float s[WG_BN / 2];
  float al_lo, al_hi;
  if (n_tiles > 0) {
    mbar_wait(&full_k[0], 0);
    my_turn();
    wgmma_fence();
    c.issue_s(s, qs, Ks(0));
    wgmma_commit();
    pass_turn(false);
    wgmma_wait0();
    fence_regs<WG_BN / 2>(s);
    release(&empty_k[0]);
    c.softmax(s, kv_start, Skv, causal, window, scale_log2, al_lo, al_hi);
    c.to_fragments(s);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % WG_STAGES, prev = (t - 1) % WG_STAGES;
    mbar_wait(&full_k[st], (t / WG_STAGES) & 1);
    mbar_wait(&full_v[prev], ((t - 1) / WG_STAGES) & 1);
    my_turn();
    wgmma_fence();
    c.issue_s(s, qs, Ks(st));
    wgmma_commit();
    c.issue_pv(Vs(prev));
    wgmma_commit();
    pass_turn(false);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S(t) done
    fence_regs<WG_BN / 2>(s);
    release(&empty_k[st]);
    c.softmax(s, kv_start + t * WG_BN, Skv, causal, window, scale_log2, al_lo, al_hi);
    wgmma_wait0();  // P(t-1) V(t-1) done
    fence_regs<DP / 2>(c.o);
    c.hold_fragments();
    release(&empty_v[prev]);
    c.rescale(al_lo, al_hi);
    c.to_fragments(s);
  }
  if (n_tiles > 0) {
    const int last = (n_tiles - 1) % WG_STAGES;
    mbar_wait(&full_v[last], ((n_tiles - 1) / WG_STAGES) & 1);
    my_turn();
    wgmma_fence();
    c.issue_pv(Vs(last));
    wgmma_commit();
    pass_turn(true);
    wgmma_wait0();
    fence_regs<DP / 2>(c.o);
    c.hold_fragments();
    release(&empty_v[last]);
  }

  float l_lo = c.l_lo, l_hi = c.l_hi;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo), inv_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
  __nv_bfloat16* ob = o + size_t(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 4) {
    const int col = (i / 4) * 8 + c.col_in;
    if (col < D) {
      if (c.row_lo < Sq)
        *reinterpret_cast<uint32_t*>(ob + size_t(c.row_lo) * D + col) =
            pack_bf16(c.o[i] * inv_lo, c.o[i + 1] * inv_lo);
      if (c.row_lo + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + size_t(c.row_lo + 8) * D + col) =
            pack_bf16(c.o[i + 2] * inv_hi, c.o[i + 3] * inv_hi);
    }
  }
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                         int Hkv, int Sq, int Skv, int D, float scale, int causal, int window,
                         cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const cuuint64_t dq[3] = {cuuint64_t(D), cuuint64_t(Sq), cuuint64_t(B) * Hq};
  const cuuint64_t dk[3] = {cuuint64_t(D), cuuint64_t(Skv), cuuint64_t(B) * Hkv};
  const cuuint64_t sq[2] = {cuuint64_t(D) * 2, cuuint64_t(Sq) * D * 2};
  const cuuint64_t sk[2] = {cuuint64_t(D) * 2, cuuint64_t(Skv) * D * 2};
  const cuuint32_t box_q[3] = {64, WG_BM, 1}, box_kv[3] = {64, WG_BN, 1};
  cudaError_t e = encode_sw128_bf16_3d(&tq, q, dq, sq, box_q);
  if (e == cudaSuccess) e = encode_sw128_bf16_3d(&tk, k, dk, sk, box_kv);
  if (e == cudaSuccess) e = encode_sw128_bf16_3d(&tv, v, dk, sk, box_kv);
  if (e != cudaSuccess) return e;
  auto kern = wgmma_attention_kernel<DP>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WgSmem<DP>::TOTAL);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + WG_BM - 1) / WG_BM, B * Hq);
  kern<<<grid, WG_NT, WgSmem<DP>::TOTAL, st>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq,
                                               Hkv, Sq, Skv, D, scale * 1.4426950408889634f,
                                               causal, window);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o like q; Hq % Hkv == 0, D <= 128;
// bf16 operands 16-byte aligned with D % 8 == 0 (TMA's stride rule).
// window <= 0 means no sliding window.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                                     int causal, int window, int dtype, void* stream) {
  if (D <= 0 || D > DMAX || Hkv <= 0 || Hq % Hkv) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    if (D % 8) return int(cudaErrorInvalidValue);
    if (D <= 64)
      return int(launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal, window, st));
    return int(launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal, window, st));
  }
  if (dtype == F32)
    return int(launch_simt<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal, window, st));
  return int(cudaErrorInvalidValue);
}
