// Split-K single-token decode attention on Hopper, over a dense KV view.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_decode` (_decode_kernel for a static valid length,
// _decode_kernel_dyn for a per-slot one) and its `combine_partials` merge.
// q (B, Hq, 1, D) against k/v (B, Hkv, S, D): the Hq / Hkv query heads of a
// kv head share its keys.  Grid (B * Hkv, n_chunks): each block holds its
// query group (<= 8 rows) and streams one chunk of <= 256 keys and values
// (decode_chunk in common.cuh), writing f32 partials (o, m, l); a second
// kernel merges them (decode_combine_kernel) into q's dtype.  A ragged last
// chunk is masked rather than refused, so any S works.
//
// Bound on the H100: memory.  Each key/value element is used by <= 8 query
// rows (2 * 8 FLOPs per 2 bytes in bf16, ~8 FLOP/byte against the card's
// ~295), so the least time is the K/V bytes of the valid rows over 3.35 TB/s.
// The design reads only rows before each slot's valid length, keeps a ring
// of 4 sub-tiles of 32 rows in flight per block through cp.async, and does
// its products on the SIMT cores (the tensor cores would idle on an 8-row
// query group).  TMA and more blocks per chunk are later work.
#include "common.cuh"

using namespace kt;

namespace {

template <typename T, int DP>
__global__ void __launch_bounds__(DEC_NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ valid, int valid_all, float* __restrict__ o,
                    float* __restrict__ m, float* __restrict__ l, int Hkv, int G, int S, int D,
                    int block_s, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, c = blockIdx.y, n_s = gridDim.y;
  const int vl = valid ? valid[bh / Hkv] : valid_all;
  const T* kb = k + size_t(bh) * S * D;
  const T* vb = v + size_t(bh) * S * D;
  const int c0 = c * block_s;
  auto krow = [=](int r) -> const T* { return c0 + r < S ? kb + size_t(c0 + r) * D : nullptr; };
  auto vrow = [=](int r) -> const T* { return c0 + r < S ? vb + size_t(c0 + r) * D : nullptr; };
  const size_t part = size_t(bh) * n_s + c;
  decode_chunk<T, DP>(smem, q + size_t(bh) * G * D, G, D, krow, vrow, block_s, min(vl, S) - c0,
                      vl, scale, o + part * G * D, m + part * G, l + part * G);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* valid, int valid_all,
           float* o, float* m, float* l, void* out, int B, int Hkv, int G, int S, int D,
           int block_s, float scale, cudaStream_t st) {
  const int n_s = (S + block_s - 1) / block_s;
  cudaError_t e = dispatch_head_dim(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    auto kern = flash_decode_kernel<T, DP>;
    const int bytes = int(DecodeSmem<T, DP>::total);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kern<<<dim3(B * Hkv, n_s), DEC_NT, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
        valid_all, o, m, l, Hkv, G, S, D, block_s, scale);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return int(e);
  return int(launch_decode_combine<T>(o, m, l, out, B * Hkv * G, n_s, G, D, st));
}

}  // namespace

// q (B, Hkv * G, 1, D), k/v (B, Hkv, S, D), out like q; valid (B,) int32 on
// the device, or null to use valid_all for every slot.  o_part
// (B * Hkv, n_s, G, D), m_part / l_part (B * Hkv, n_s, G) are f32 scratch,
// n_s = ceil(S / block_s).  G <= 8, 0 < block_s <= 256, D % 8 == 0, D <= 256.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, const void* valid,
                                  int valid_all, void* o_part, void* m_part, void* l_part,
                                  void* out, int B, int Hkv, int G, int S, int D, int block_s,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || G > DEC_GMAX || S <= 0 || D <= 0 || D > 256 || D % 8 ||
      block_s <= 0 || block_s > DEC_BSMAX)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(q, k, v, vl, valid_all, o, m, l, out, B, Hkv, G, S, D, block_s,
                                 scale, st);
  if (dtype == F32)
    return launch<float>(q, k, v, vl, valid_all, o, m, l, out, B, Hkv, G, S, D, block_s, scale,
                         st);
  return int(cudaErrorInvalidValue);
}
