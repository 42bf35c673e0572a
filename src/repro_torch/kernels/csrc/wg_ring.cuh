// The warp-specialised TMA ring and the cluster fold shared by the fused
// MLP kernels on TMA + wgmma (fused_mlp.cu's tiled bf16 forward, B1 / B2;
// fused_mlp_bwd.cu's bf16 backward, B6 and B7).
//
// A block is 384 threads: warpgroup 0 produces (its thread 0 keeps TMA
// loads of 64 x 64 bf16 boxes, 128-byte swizzled, in flight through a ring
// of full / empty mbarriers) and warpgroups 1 and 2 consume (64 rows each
// of a 128-row tile, wgmma out of the boxes, accumulators in registers).
// Values the next product reads (hidden tiles) are written as bf16 pairs
// into swizzled atoms of the same layout TMA leaves.  A cluster of blocks
// sums its f32 accumulators over distributed shared memory in rank order
// (`cluster_fold`), so every sum runs in a fixed order and two runs give
// the same bits.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace kt {

constexpr int RING_NT = 384;           // threads of a block: producer + 2 consumer warpgroups
constexpr int CONSUMER_NT = 256;       // the consumer warpgroups' threads
constexpr int ATOM = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box, 128-byte swizzled

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Descriptors of a K-major operand (rows 128 bytes apart, K steps of 32
// bytes) and of an MN-major one (K steps of 16 rows = 2048 bytes; `lbo`
// between 64-wide column atoms along M or N).
__device__ __forceinline__ uint64_t kdesc(const unsigned char* p) { return sw128_desc(p, 16, 1024); }
__device__ __forceinline__ uint64_t mndesc(const unsigned char* p, uint32_t lbo) {
  return sw128_desc(p, lbo, 1024);
}

// (row, column) within a warpgroup's 64-row accumulator of element i: rows
// lane / 4 (+8 for the upper pair) of the warp's 16, columns 8 (i / 4) +
// 2 (lane % 4) (+1)
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }

// Write a bf16 pair (columns c, c + 1, c even) at row r of a swizzled atom.
__device__ __forceinline__ void atom_put(unsigned char* atom, int r, int c, uint32_t v) {
  *reinterpret_cast<uint32_t*>(atom + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) = v;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The ring's barriers at `full`: full[ST] (one arrival and the step's
// bytes), then empty[ST] (one arrival per consumer warp).
__device__ __forceinline__ void init_ring_barriers(int ST, uint64_t* full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[ST + s], CONSUMER_NT / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The ring of ST slots, warp-specialised as csrc/flash_attention.cu's:
// warpgroup 0 produces -- its thread 0 refills slot t % ST with step t's
// TMA boxes (issue(t, slot) arms the slot's full barrier) once the slot's
// empty barrier says every consumer warp released step t - ST -- and
// warpgroups 1 and 2 consume: wait for step t, run consume(t, slot,
// release), which calls release() once its products have read the slot.
// The producer (`ring_produce`, which a kernel with its own consumer loop
// calls alone) takes part in the cluster barriers of the consumers' folds
// (syncs(t) of them after step t), ST - 1 steps behind its copies so that
// the next steps' boxes are in flight while the consumers fold.  No block
// leaves before its whole cluster (whose reduce buffers it may still read).
template <typename Issue, typename Syncs>
__device__ __forceinline__ void ring_produce(int ST, int T, uint64_t* empty, Issue issue,
                                             Syncs syncs) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
  for (int t = 0; t < T + ST - 1; ++t) {
    if (t < T && threadIdx.x == 0) {
      const int s = t % ST;
      if (t >= ST) mbar_wait(&empty[s], ((t / ST) + 1) & 1);
      issue(t, s);
    }
    const int td = t - (ST - 1);
    if (td >= 0)
      for (int k = syncs(td); k > 0; --k) cluster.sync();
  }
}

template <typename Issue, typename Syncs, typename Consume>
__device__ __forceinline__ void run_ring(int ST, int T, uint64_t* full, uint64_t* empty,
                                         Issue issue, Syncs syncs, Consume consume) {
  if (threadIdx.x < 128) {
    ring_produce(ST, T, empty, issue, syncs);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    for (int t = 0; t < T; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      consume(t, s, [&]() {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      });
    }
  }
  cooperative_groups::this_cluster().sync();
}

// Named barriers of the consumers: both warpgroups, or warpgroup w alone.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
}

// Fold this consumer thread's N accumulator floats over the CS blocks of
// the cluster in rank order and hand each sum pair to store(e, v0, v1)
// (accumulator elements e and e + 1, e even; `acc_row` / `acc_col` place
// them).  RBN floats a round through the reduce buffer buffer(round) of
// CONSUMER_NT * RBN floats (`round` counts the rounds; buffers must
// alternate between two regions): every member parks its own in the
// round's buffer (element i of consumer thread c at i * CONSUMER_NT + c),
// one cluster barrier, then member `rank` loads element range `rank` of
// the round from every member at once, sums it in rank order and stores
// it.  A buffer is written again two rounds later, after the next round's
// barrier, which every member reaches only once done reading it.  The
// producer warpgroup joins each of the N / RBN barriers.
template <int N, int CS, int RBN, typename Buffer, typename Store>
__device__ __forceinline__ void cluster_fold(const float* acc, Buffer buffer, int& round,
                                             Store store) {
  namespace cg = cooperative_groups;
  static_assert(N % RBN == 0 && RBN % (2 * CS) == 0, "every member folds whole pairs");
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int SHARE = RBN / CS;
  const int rank = int(cluster.block_rank()), ct = threadIdx.x - 128;  // consumer thread
#pragma unroll
  for (int base = 0; base < N; base += RBN, ++round) {
    float* buf = buffer(round);
#pragma unroll
    for (int i = 0; i < RBN; ++i) buf[i * CONSUMER_NT + ct] = acc[base + i];
    cluster.sync();
    float v[CS][SHARE];
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const float* r = cluster.map_shared_rank(buf, q) + rank * SHARE * CONSUMER_NT + ct;
#pragma unroll
      for (int i = 0; i < SHARE; ++i) v[q][i] = r[i * CONSUMER_NT];
    }
#pragma unroll
    for (int i = 0; i < SHARE; i += 2) {
      float v0 = v[0][i], v1 = v[0][i + 1];
#pragma unroll
      for (int q = 1; q < CS; ++q) {
        v0 += v[q][i];
        v1 += v[q][i + 1];
      }
      store(base + rank * SHARE + i, v0, v1);
    }
  }
}

// Store an f32 sum pair at out[row * ld + col] (and col + 1), masked to
// rows < nrows and columns < ncols.
__device__ __forceinline__ void put_f32_pair(float* out, size_t ld, int row, int col, int nrows,
                                             int ncols, float v0, float v1) {
  if (row < nrows && col < ncols) {
    float* o = out + size_t(row) * ld + col;
    if (col + 1 < ncols) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    else o[0] = v0;
  }
}

// A tensor map over a row-major (rows, cols) bf16 matrix in 64 x 64 boxes.
inline cudaError_t map64(CUtensorMap* m, const void* p, int rows, int cols) {
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), 1};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2, cuuint64_t(rows) * cols * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_sw128_bf16_3d(m, p, dims, strides, box);
}

// Launch `kern` with RING_NT threads a block and clusters of `cluster`
// blocks along x.  `smem` bytes of dynamic shared memory must already be
// allowed (cudaFuncAttributeMaxDynamicSharedMemorySize).
template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, dim3 grid, int smem, int cluster, cudaStream_t st,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(RING_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace kt
