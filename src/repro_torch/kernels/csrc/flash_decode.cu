// Split-K single-token decode attention on Hopper, over a dense KV view.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_decode` (_decode_kernel for a static valid length,
// _decode_kernel_dyn for a per-slot one) and its `combine_partials` merge.
// q (B, Hq, 1, D) against k/v (B, Hkv, S, D): the Hq / Hkv query heads of a
// kv head share its keys.  Grid (B * Hkv, n_chunks * n_split): each chunk
// of <= 256 keys is spread over n_split blocks (decode_splits in
// kernels/flash_attention.py: enough blocks for two per SM), each block
// holding its query group (<= 8 rows) and streaming its share of the chunk
// (decode_chunk in common.cuh), writing f32 partials (o, m, l); a second
// kernel, launched as a programmatic dependent so its blocks are scheduled
// while this one drains, merges them (decode_combine_kernel) into q's dtype.
// A ragged last chunk is masked rather than refused, so any S works.
// K/V may also be stored as float8 e4m3 beside a bf16 or f32 q (the
// reference's float8 KV cache, kv_cache_dtype="float8_e4m3fn"): the same
// chunk reads 8-byte pieces, converts them to f32 in registers and rounds P
// to q's dtype, so the bytes and the bound halve against bf16 K/V.
//
// Bound on the H100: memory.  Each key/value element is used by <= 8 query
// rows (2 * 8 FLOPs per 2 bytes in bf16, ~8 FLOP/byte against the card's
// ~295), so the least time is the K/V bytes of the valid rows over 3.35 TB/s
// (3.35 us at phi3-medium-14b's serving shape, S = 512).  The design
// (decode_chunk in common.cuh): 8 warps a block, each owning a contiguous run
// of the chunk's rows, each lane streaming its pieces of those rows' K and V
// through its own cp.async ring; online softmax and o in registers, one
// merge through shared memory at the end; only rows before each slot's valid
// length are read, and the products run on the SIMT cores.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 3, cold L2): 0.0185
// ms at S = 512 and 0.0498 ms at S = 4096 (PERF.md, B4).  Open: the SIMT
// arithmetic, not the loads, sets the time at 4 to 8 query rows per kv head
// (see decode_chunk); fusing the combine into the last block of a row
// (atomic counter) was slower than the dependent launch.
#include "common.cuh"

using namespace kt;

namespace {

template <typename TQ, typename TKV, int GP, int DP>
__global__ void __launch_bounds__(DEC_NT)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ valid, int valid_all,
                    float* __restrict__ o, float* __restrict__ m, float* __restrict__ l, int Hkv,
                    int G, int S, int D, int block_s, int n_split, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, c = blockIdx.y / n_split, n_part = gridDim.y;
  const int vl = valid ? valid[bh / Hkv] : valid_all;
  const TKV* kb = k + size_t(bh) * S * D;
  const TKV* vb = v + size_t(bh) * S * D;
  const int c0 = c * block_s;
  auto krow = [=](int r) -> const TKV* { return c0 + r < S ? kb + size_t(c0 + r) * D : nullptr; };
  auto vrow = [=](int r) -> const TKV* { return c0 + r < S ? vb + size_t(c0 + r) * D : nullptr; };
  const size_t part = size_t(bh) * n_part + blockIdx.y;
  decode_chunk<TQ, TKV, GP, DP>(smem, q + size_t(bh) * G * D, G, D, krow, vrow, block_s,
                                min(vl, S) - c0, vl, scale, blockIdx.y % n_split, n_split,
                                o + part * G * D, m + part * G, l + part * G);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid, int valid_all,
                   float* o, float* m, float* l, void* out, int B, int Hkv, int G, int S, int D,
                   int block_s, int n_split, float scale, cudaStream_t st) {
  const int n_part = (S + block_s - 1) / block_s * n_split;
  cudaError_t e = dispatch_group(G, [&](auto gp) {
    return dispatch_head_dim(D, [&](auto dp) {
      constexpr int GP = decltype(gp)::value, DP = decltype(dp)::value;
      const int bytes = int(DecodeSmem<TKV, GP, DP>::total);
      flash_decode_kernel<TQ, TKV, GP, DP><<<dim3(B * Hkv, n_part), DEC_NT, bytes, st>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
          valid, valid_all, o, m, l, Hkv, G, S, D, block_s, n_split, scale);
      return cudaGetLastError();
    });
  });
  if (e != cudaSuccess) return e;
  return launch_decode_combine<TQ>(o, m, l, out, B * Hkv * G, n_part, G, D, st);
}

// Raises every instantiation's dynamic shared-memory limit to what it takes,
// on the current device.  A launch never does: it may lie inside a captured
// CUDA graph, where it should be the launch alone.
template <typename TQ, typename TKV>
cudaError_t allow_smem() {
  return for_each_decode_bucket([](auto gp, auto dp) {
    constexpr int GP = decltype(gp)::value, DP = decltype(dp)::value;
    return cudaFuncSetAttribute(flash_decode_kernel<TQ, TKV, GP, DP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(DecodeSmem<TKV, GP, DP>::total));
  });
}

}  // namespace

// Once per (device, operand pair), before the first launch there: the
// kernels' shared-memory limit (allow_smem).  dtype is a DecodeDType.
extern "C" int repro_flash_decode_allow(int dtype) {
  return int(dispatch_decode_dtypes(dtype, [](auto tq, auto tkv) {
    return allow_smem<std::remove_pointer_t<decltype(tq)>,
                      std::remove_pointer_t<decltype(tkv)>>();
  }));
}

// q (B, Hkv * G, 1, D), k/v (B, Hkv, S, D), out like q; valid (B,) int32 on
// the device, or null to use valid_all for every slot.  dtype (DecodeDType)
// names q's type (float or bf16, out's too) and k/v's (the same, or e4m3).
// Each chunk of block_s rows is spread over n_split blocks
// (1..DEC_MAX_SPLIT), each writing its own partials: o_part (B * Hkv,
// n_s * n_split, G, D), m_part / l_part (B * Hkv, n_s * n_split, G) are f32
// scratch, n_s = ceil(S / block_s).  G <= 8, 0 < block_s <= 256,
// D % 8 == 0, D <= 256.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, const void* valid,
                                  int valid_all, void* o_part, void* m_part, void* l_part,
                                  void* out, int B, int Hkv, int G, int S, int D, int block_s,
                                  int n_split, float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || G > DEC_GMAX || S <= 0 || D <= 0 || D > 256 || D % 8 ||
      block_s <= 0 || block_s > DEC_BSMAX || n_split <= 0 || n_split > DEC_MAX_SPLIT)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  return int(dispatch_decode_dtypes(dtype, [&](auto tq, auto tkv) {
    return launch<std::remove_pointer_t<decltype(tq)>, std::remove_pointer_t<decltype(tkv)>>(
        q, k, v, vl, valid_all, o, m, l, out, B, Hkv, G, S, D, block_s, n_split, scale, st);
  }));
}
