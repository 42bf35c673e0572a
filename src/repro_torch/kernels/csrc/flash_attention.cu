// Flash attention forward on Hopper: online-softmax attention with causal
// and sliding-window masks and grouped KV heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention` (_attn_kernel).  Same semantics: scores in f32, the
// causal mask start-aligned (query i sees keys <= i; lowering only uses it
// with sq == skv), masked scores set to NEG_INF = -1e30 (not -inf),
// probabilities rounded to the value dtype before P @ V, and a row whose
// normaliser is 0 divided by 1.  The (S, S) score matrix never exists in
// HBM: each block holds one (64 x 64) score tile in shared memory.
//
// Design: one block of 4 warps per (batch * query head, 64 query rows).
// Q stays in shared memory; K/V tiles of 64 keys stream past it through
// cp.async copies that run one step ahead of the math.  S = Q K^T
// and the P V update run on the tensor cores (WMMA, bf16) or FMA (f32); the
// running output O (64 x D, f32) lives in shared memory so each row can be
// rescaled by its own exp(m_old - m_new).  Two threads own each query row
// for the softmax.  Causal blocks stop at their diagonal tile, so the
// masked half of the work is skipped.  Head dim D <= 128.
//
// Bound on the H100: at (4, 32, 2048, 128) bf16 causal the work is
// 2 * B * H * S^2 * D FLOPs (half of the dense 4 * B * H * S^2 * D) against
// 4 * B * H * S * D * 2 bytes, ~1000 FLOP/byte -- tensor-core bound.  This
// version issues WMMA (mma.sync); wgmma, TMA and keeping O in registers are
// later work.
#include "common.cuh"

using namespace kt;

namespace {

constexpr int BQ = 64, BKV = 64, DMAX = 128, NW = 4, NT = NW * 32;
constexpr float NEG_INF = -1e30f;

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
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
           int Skv, int D, float scale, int causal, int window, cudaStream_t st) {
  const AttnSmem<T> L;
  auto kern = flash_attention_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
  if (e != cudaSuccess) return int(e);
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, NT, L.total, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                  static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv,
                                  D, scale, causal, window);
  return int(cudaGetLastError());
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o like q; Hq % Hkv == 0, D <= 128.
// window <= 0 means no sliding window.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                                     int causal, int window, int dtype, void* stream) {
  if (D <= 0 || D > DMAX || Hkv <= 0 || Hq % Hkv) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal, window, st);
  if (dtype == F32)
    return launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal, window, st);
  return int(cudaErrorInvalidValue);
}
