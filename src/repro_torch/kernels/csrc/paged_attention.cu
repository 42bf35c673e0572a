// Block-table-native split-K decode attention on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// `paged_flash_decode` (_paged_decode_kernel).  K/V stay in the serving
// engine's flat page pools; each block resolves its chunk's pages through the
// slot's block table, loaded into shared memory at the start (the TPU
// kernel's scalar prefetch), so no dense view is ever gathered.  Pool row
// `page * bs + offset` of plane (g, a, h) covers both pool forms:
// (P, G, A, Hkv, D) with layer = (g, a), and (P, Hkv, D).  Page 0 is the
// engine's null page; table entries beyond a slot's allocation point at it
// and sit past the slot's valid length, so they are masked (and not read).
//
// The chunk math is decode_chunk in common.cuh, the same function
// flash_decode.cu runs on a dense view: with the same chunk size the output
// is bitwise equal to gathering the view and running flash_decode.
//
// Bound on the H100: memory, as flash_decode (the K/V bytes of each slot's
// valid rows over 3.35 TB/s); the extra cost here is the table indirection,
// one shared-memory load per row a lane reads.  This kernel has no design of
// its own: the chunk is decode_chunk's (warps own rows, per-lane cp.async
// rings, softmax and output in registers), split over blocks by the same
// decode_splits rule as flash_decode.  Measured on an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py): 0.0189 ms at phase 3's shape (8 slots x 32
// pages of 16, cold L2; bound 0.0024 ms), 7.9 us a call inside phi3-medium-
// 14b's decode tick (PERF.md, B8).  Open: the table entries load in a
// block-wide step before the chunk starts.
#include "common.cuh"

using namespace kt;

namespace {

template <typename TQ, typename TKV, int GP, int DP>
__global__ void __launch_bounds__(DEC_NT)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ tables, int n_table,
                    const int* __restrict__ valid, float* __restrict__ o, float* __restrict__ m,
                    float* __restrict__ l, int Hkv, int G, int D, int bs, int block_s,
                    int n_split, int plane_stride, int plane_base, long long pool_rows,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, c = blockIdx.y / n_split, n_part = gridDim.y;
  const int b = bh / Hkv, plane = plane_base + bh % Hkv;
  int* tbl = reinterpret_cast<int*>(smem + DecodeSmem<TKV, GP, DP>::tbl_off);
  const int ppc = block_s / bs;  // pages per chunk
  for (int p = threadIdx.x; p < ppc; p += DEC_NT) tbl[p] = tables[size_t(b) * n_table + c * ppc + p];
  __syncthreads();
  auto row = [=](const TKV* pool, int r) -> const TKV* {
    const long long pr = (long long)tbl[r / bs] * bs + r % bs;
    return pr >= 0 && pr < pool_rows ? pool + (size_t(pr) * plane_stride + plane) * D : nullptr;
  };
  auto krow = [=](int r) { return row(kp, r); };
  auto vrow = [=](int r) { return row(vp, r); };
  const int vl = valid[b], s_len = n_table * bs;
  const size_t part = size_t(bh) * n_part + blockIdx.y;
  decode_chunk<TQ, TKV, GP, DP>(smem, q + size_t(bh) * G * D, G, D, krow, vrow, block_s,
                                min(vl, s_len) - c * block_s, vl, scale, blockIdx.y % n_split,
                                n_split, o + part * G * D, m + part * G, l + part * G);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables, int n_table,
                   const int* valid, float* o, float* m, float* l, void* out, int B, int Hkv,
                   int G, int D, int bs, int block_s, int n_split, int plane_stride,
                   int plane_base, long long pool_rows, float scale, cudaStream_t st) {
  const int n_part = n_table * bs / block_s * n_split;
  cudaError_t e = dispatch_group(G, [&](auto gp) {
    return dispatch_head_dim(D, [&](auto dp) {
      constexpr int GP = decltype(gp)::value, DP = decltype(dp)::value;
      const int bytes = int(DecodeSmem<TKV, GP, DP>::total);
      paged_decode_kernel<TQ, TKV, GP, DP><<<dim3(B * Hkv, n_part), DEC_NT, bytes, st>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
          tables, n_table, valid, o, m, l, Hkv, G, D, bs, block_s, n_split, plane_stride,
          plane_base, pool_rows, scale);
      return cudaGetLastError();
    });
  });
  if (e != cudaSuccess) return e;
  return launch_decode_combine<TQ>(o, m, l, out, B * Hkv * G, n_part, G, D, st);
}

// As flash_decode.cu's: every instantiation's shared-memory limit, on the
// current device, set outside any launch.
template <typename TQ, typename TKV>
cudaError_t allow_smem() {
  return for_each_decode_bucket([](auto gp, auto dp) {
    constexpr int GP = decltype(gp)::value, DP = decltype(dp)::value;
    return cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV, GP, DP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(DecodeSmem<TKV, GP, DP>::total));
  });
}

}  // namespace

// Once per (device, operand pair), before the first launch there; dtype is
// a DecodeDType.
extern "C" int repro_paged_decode_allow(int dtype) {
  return int(dispatch_decode_dtypes(dtype, [](auto tq, auto tkv) {
    return allow_smem<std::remove_pointer_t<decltype(tq)>,
                      std::remove_pointer_t<decltype(tkv)>>();
  }));
}

// q (B, Hkv * G, 1, D), out like q.  kp/vp: pools of pool_rows rows, each
// row plane_stride planes of D values (G * A * Hkv for the 5-D form, Hkv for
// the 3-D form); this site's kv head h lives in plane plane_base + h.
// dtype (DecodeDType) names q's type and the pools' (q's, or e4m3).
// tables (B, n_table) int32 page ids, valid (B,) int32, both on the device.
// block_s is a multiple of bs that divides n_table * bs, at most 256;
// n_split and o_part / m_part / l_part are as in repro_flash_decode.
extern "C" int repro_paged_decode(const void* q, const void* kp, const void* vp,
                                  const void* tables, int n_table, const void* valid,
                                  void* o_part, void* m_part, void* l_part, void* out, int B,
                                  int Hkv, int G, int D, int bs, int block_s, int n_split,
                                  int plane_stride, int plane_base, long long pool_rows,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || G > DEC_GMAX || D <= 0 || D > 256 || D % 8 || bs <= 0 ||
      block_s <= 0 || block_s > DEC_BSMAX || block_s % bs || n_table <= 0 ||
      (n_table * bs) % block_s || n_split <= 0 || n_split > DEC_MAX_SPLIT)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* vl = static_cast<const int*>(valid);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  return int(dispatch_decode_dtypes(dtype, [&](auto tq, auto tkv) {
    return launch<std::remove_pointer_t<decltype(tq)>, std::remove_pointer_t<decltype(tkv)>>(
        q, kp, vp, tb, n_table, vl, o, m, l, out, B, Hkv, G, D, bs, block_s, n_split,
        plane_stride, plane_base, pool_rows, scale, st);
  }));
}
