// Queue reduction on Hopper: (N, R, C) -> (R, C) by sum, max or min over
// axis 0 with an f32 accumulator.
//
// Replaces the TPU kernel src/repro/kernels/queue_reduce.py `queue_reduce`
// (_reduce_kernel): the fan-in stage that split_reduction creates, where
// each grid step pops one (R-tile, C) payload off the queue and folds it
// into a VMEM accumulator.  The order is the TPU kernel's and is kept
// exactly: element e is ((x[0,e] op x[1,e]) op x[2,e]) op ... in f32, never
// split over N nor reassociated, then cast once.  That order is what makes
// the fused MLP's small-M output independent of M and two training runs
// bitwise alike, so a design that splits N across threads is out.
//
// Bound on the H100: N * R * C input elements read once and R * C written
// once, one f32 operation per input element -- memory bound at 3.35 TB/s.
// With one thread per output element reading its N payloads one after
// another, a thread keeps only a few loads in flight, and at the fused
// MLP's decode fold (63 payloads of 40960 f32, still in L2) the chain of L2
// round trips, not the bytes, sets the time.  So each thread issues its
// payloads' loads DEPTH at a time into registers before it adds any of
// them.  Where the outputs fill the card, 4 deep in 256-thread blocks (more
// costs registers, so residency); where they are fewer than a quarter of
// its thread slots (the decode fold), 32 deep in 64-thread blocks spread
// over every SM.  The caller passes the SM count (cached on the host), so a
// launch makes no runtime query.
//
// A form that streams each block's column tile of every payload into
// shared memory with 1-D bulk copies through an mbarrier ring was probed on
// the H100 and dropped: it lost at every fold up to 134 MB (the decode fold
// by the most: at 1-4 KB a copy, the cost per copy sets its time) and tied
// within noise on the 537-680 MB folds (PERF.md, PR 17).  `op` is a
// template parameter, so no inner loop branches on it.  The same kernel
// folds the fused MLP's f32 partials into its output dtype (in dtype f32,
// out dtype bf16).
#include "common.cuh"

using namespace kt;

namespace {

// (threads a block, payloads a thread loads at once) where the outputs
// fill the card ("wide") and where they are fewer than a quarter of its
// thread slots ("deep": each thread keeps more loads in flight, and small
// blocks spread the few threads over every SM)
constexpr int WIDE_NT = 256, WIDE_DEPTH = 4;
constexpr int DEEP_NT = 64, DEEP_DEPTH = 32;

enum Op { SUM = 0, MAX = 1, MIN = 2 };

// The fold's start: x[0] op'd into it gives x[0] bit for bit (-0 + x = x,
// -0 included), so folding from it is folding from x[0].
template <int OP>
__device__ __forceinline__ float identity() {
  return OP == SUM ? -0.f : (OP == MAX ? -INFINITY : INFINITY);
}

template <int OP>
__device__ __forceinline__ float combine(float acc, float v) {
  if constexpr (OP == SUM)
    return acc + v;
  else if constexpr (OP == MAX)
    return (v > acc || v != v) ? v : acc;  // NaN propagates, as in torch.amax
  else
    return (v < acc || v != v) ? v : acc;
}

// A thread per output element.  Its payloads come DEPTH at a time, every
// load of a batch issued before its adds (a loop unrolled over a runtime
// trip count would leave a remainder of dependent round trips); the last
// batch's loads past N are predicated off.
template <typename TI, typename TO, int OP, int LNT, int DEPTH>
__global__ void __launch_bounds__(LNT)
queue_reduce_kernel(const TI* __restrict__ x, TO* __restrict__ out, int N, long long RC) {
  const long long stride = (long long)gridDim.x * LNT;
  for (long long e = (long long)blockIdx.x * LNT + threadIdx.x; e < RC; e += stride) {
    const TI* p = x + e;
    float acc = identity<OP>();
    int n = 0;
    for (; n + DEPTH <= N; n += DEPTH) {
      float v[DEPTH];
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) v[i] = to_f<TI>(p[(n + i) * RC]);
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) acc = combine<OP>(acc, v[i]);
    }
    if (n < N) {
      float v[DEPTH];
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) v[i] = n + i < N ? to_f<TI>(p[(n + i) * RC]) : 0.f;
#pragma unroll
      for (int i = 0; i < DEPTH; ++i)
        if (n + i < N) acc = combine<OP>(acc, v[i]);
    }
    out[e] = from_f<TO>(acc);
  }
}

template <typename TI, typename TO, int OP, int LNT, int DEPTH>
int launch_batched(const TI* x, TO* out, int N, long long RC, int sms, cudaStream_t st) {
  long long blocks = (RC + LNT - 1) / LNT;
  if (blocks > sms * 32LL) blocks = sms * 32LL;  // at most 32 blocks an SM, walking the rest
  queue_reduce_kernel<TI, TO, OP, LNT, DEPTH><<<unsigned(blocks), LNT, 0, st>>>(x, out, N, RC);
  return int(cudaGetLastError());
}

template <typename TI, typename TO, int OP>
int launch(const void* xv, void* outv, int N, long long RC, int sms, cudaStream_t st) {
  const TI* x = static_cast<const TI*>(xv);
  TO* out = static_cast<TO*>(outv);
  return RC * 4 <= sms * 2048LL
             ? launch_batched<TI, TO, OP, DEEP_NT, DEEP_DEPTH>(x, out, N, RC, sms, st)
             : launch_batched<TI, TO, OP, WIDE_NT, WIDE_DEPTH>(x, out, N, RC, sms, st);
}

template <typename TI, typename TO>
int dispatch_op(const void* x, void* out, int N, long long RC, int op, int sms, cudaStream_t st) {
  switch (op) {
    case SUM: return launch<TI, TO, SUM>(x, out, N, RC, sms, st);
    case MAX: return launch<TI, TO, MAX>(x, out, N, RC, sms, st);
    default: return launch<TI, TO, MIN>(x, out, N, RC, sms, st);
  }
}

}  // namespace

// x (N, R*C) contiguous of in_dtype; out (R*C,) of out_dtype; op 0=sum
// 1=max 2=min; sms the card's SM count.
extern "C" int repro_queue_reduce(const void* x, void* out, int N, long long RC, int in_dtype,
                                  int out_dtype, int op, int sms, void* stream) {
  if (N <= 0 || RC <= 0 || op < 0 || op > 2 || sms <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32) return dispatch_op<float, float>(x, out, N, RC, op, sms, st);
  if (in_dtype == F32 && out_dtype == BF16)
    return dispatch_op<float, __nv_bfloat16>(x, out, N, RC, op, sms, st);
  if (in_dtype == BF16 && out_dtype == BF16)
    return dispatch_op<__nv_bfloat16, __nv_bfloat16>(x, out, N, RC, op, sms, st);
  if (in_dtype == BF16 && out_dtype == F32)
    return dispatch_op<__nv_bfloat16, float>(x, out, N, RC, op, sms, st);
  return int(cudaErrorInvalidValue);
}
