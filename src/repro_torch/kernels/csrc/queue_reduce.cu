// Queue reduction on Hopper: (N, R, C) -> (R, C) by sum, max or min over
// axis 0 with an f32 accumulator.
//
// Replaces the TPU kernel src/repro/kernels/queue_reduce.py `queue_reduce`
// (_reduce_kernel): the fan-in stage that split_reduction creates, where
// each grid step pops one (R-tile, C) payload off the queue and folds it
// into a VMEM accumulator.  Here each thread owns output elements and pops
// the N payloads in order (the same sequential f32 order as the TPU
// kernel), so no cross-block reduction and no atomics are needed.
//
// Bound on the H100: N * R * C input elements read once and R * C written
// once, one add per input element -- memory bound at 3.35 TB/s.  Neighbouring
// threads read neighbouring elements of each payload, so every load is
// coalesced.  The same kernel folds the fused MLP's f32 partials into its
// output dtype (in dtype f32, out dtype bf16).
#include "common.cuh"

using namespace kt;

namespace {

constexpr int NT = 256;

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT)
queue_reduce_kernel(const TI* __restrict__ x, TO* __restrict__ out, int N, long long RC, int op) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < RC; e += stride) {
    float acc = op == 0 ? 0.f : (op == 1 ? -INFINITY : INFINITY);
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float v = to_f<TI>(x[n * RC + e]);
      if (op == 0)
        acc += v;
      else if (op == 1)
        acc = (v > acc || v != v) ? v : acc;  // NaN propagates, as in torch.amax
      else
        acc = (v < acc || v != v) ? v : acc;
    }
    out[e] = from_f<TO>(acc);
  }
}

template <typename TI, typename TO>
int launch(const void* x, void* out, int N, long long RC, int op, cudaStream_t st) {
  long long blocks = (RC + NT - 1) / NT;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  queue_reduce_kernel<TI, TO><<<unsigned(blocks), NT, 0, st>>>(static_cast<const TI*>(x),
                                                               static_cast<TO*>(out), N, RC, op);
  return int(cudaGetLastError());
}

}  // namespace

// x (N, R*C) contiguous of in_dtype; out (R*C,) of out_dtype; op 0=sum 1=max 2=min.
extern "C" int repro_queue_reduce(const void* x, void* out, int N, long long RC, int in_dtype,
                                  int out_dtype, int op, void* stream) {
  if (N <= 0 || op < 0 || op > 2) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32) return launch<float, float>(x, out, N, RC, op, st);
  if (in_dtype == F32 && out_dtype == BF16) return launch<float, __nv_bfloat16>(x, out, N, RC, op, st);
  if (in_dtype == BF16 && out_dtype == BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, out, N, RC, op, st);
  if (in_dtype == BF16 && out_dtype == F32) return launch<__nv_bfloat16, float>(x, out, N, RC, op, st);
  return int(cudaErrorInvalidValue);
}
