// Fused MLP forward on Hopper: Y = act(X @ W1) @ W2, and the gated form
// Y = (act(X @ Wg) * (X @ Wu)) @ Wd.
//
// Replaces the TPU kernels src/repro/kernels/fused_mlp.py `fused_mlp_fwd`
// (_fwd_kernel) and `fused_mlp_swiglu_fwd` (_fwd_kernel_swiglu).
//
// What must hold: Kitsune's invariant -- the (M, H) hidden tensor never
// reaches HBM.  The TPU kernel keeps a (block_m, Dout) f32 accumulator in
// VMEM across its sequential H loop; at Dout = 4096 that is 1-2 MB, and an
// SM has 227 KB of shared memory, so that design does not carry over.
//
// Two forms, chosen by M alone (kernels/fused_mlp.py `fwd_form`: the
// small-M form for M <= SMALL_M = 64, its capacity; the tiled form above).
//
// Tiled form in bf16, mlp_fwd_wgmma (TMA + wgmma; helpers in sm90.cuh and
// wg_ring.cuh, shared with B7 in fused_mlp_bwd.cu).  What bounds it: at
// gemma3-1b's training shape (M 8192, 1152 -> 6912 -> 1152) 391 GFLOP
// against 49 MB of operands and output -- tensor-core bound on the card, as
// Llama's widths are; NeRF's (524288, 256 -> 256 -> 256) is bytes-bound.
// A block is a producer warpgroup whose thread 0 keeps TMA loads of 64 x 64
// boxes (128-byte swizzle) in flight through an mbarrier ring (as many
// 32 KB stages as shared memory holds beside the hidden atoms) and two
// consumer warpgroups of 64 rows each; a block owns a 128-row tile and a
// hidden chunk of nj 64-wide sub-chunks.  Stage 1 runs [g | u] = X [Wg |
// Wu] as one wgmma m64n128 per 16-deep k slice (ungated: g for two
// sub-chunks), X boxes read K-major and weight boxes MN-major (as stored:
// no transposed copy of any weight); t = act(g) * u goes from registers,
// rounded to bf16, into swizzled shared atoms.  Stage 2 multiplies the
// atoms (K-major A) by W2 boxes (MN-major B) into 256-column passes of Y
// (m64n256; the stage-1 and stage-2 accumulators share registers).  The TPU
// kernel keeps the whole (block_m, Dout) f32 accumulator across its H loop;
// a block cannot (128 x 1152 f32 is 590 KB), so the hidden chunks are spread
// over a cluster of FW_CS = 8 blocks and each pass is folded over the
// cluster in rank order through distributed shared memory before it is
// stored: one f32 partial per cluster for queue_reduce, or Y itself where
// one cluster spans H.  The fold's cluster barriers are its cost (four a
// pass; the first waits for the slowest member), so a block's chunk is as
// wide as shared memory allows, amortising each pass's fold over more
// products, and half of the fold's rounds go through the ring slot the
// pass's last step just freed.
// Geometry (tiled_geometry) is a function of H alone: H <= 448 takes one
// block (no cluster, Y written directly: NeRF's 256), otherwise as few
// partials as chunks of at most 7 sub-chunks allow -- gemma3-1b's 6912: 2
// partials (0.075 GB of f32 at M = 8192, where one partial per 512-wide
// chunk would be 14 and 0.53 GB); Llama3-8B's 14336: 4 (0.54 GB, against 28
// and 3.76 GB); whisper's 3072: 1.
// The grid is persistent: as many clusters as the card holds at once, each
// walking work items (group of chunks, row tile) group-major, so the next
// item's boxes load while a consumer folds and stores.  Every output
// element is one chain of wgmma steps in k order and a fold in rank order,
// fixed by the widths alone: a row's result depends neither on M nor on
// the other rows, and two runs give the same bits.
//
// Tiled form in float32, fused_mlp_kernel (SIMT, FMA): block (i,
// s) owns 64 rows of X and the hidden range [BH s, BH s + BH), builds its
// hidden chunk in shared memory through a 3-stage cp.async pipeline, and
// multiplies it into every 128-column tile of W2 with FMA (the reduced
// engines check against the CPU at 2e-4, which TF32 would miss); f32
// partials (n_split, M, Dout) for queue_reduce.
//
// Small-M form (decode, M <= 64).  What bounds it: the weights -- 550 MB at
// phi3-medium-14b's 5120 -> 17920 -> 5120, 0.164 ms at the H100's 3.35 TB/s
// -- while at 64 rows the products are 35 GFLOP (36 us at the bf16 peak), and
// a 128-row tile would spend most of its products on padding rows.  So the
// product is swapped, Y^T = W^T X^T: every 16 x 16 weight tile is mma.sync
// m16n8k16's A operand and the token rows its 8-wide N.  Blocks of up to 10
// 16-column hidden tiles, about one per SM, build their part of the hidden
// chunk; a cluster shares a hidden range, its members exchange their parts
// over distributed shared memory, and member r multiplies the cluster's
// chunk into its columns of W2: one f32 partial of Y per cluster.
// bf16, small_m_kernel_tma: the clusters' design at 64 rows was bound by
// three things that grow with the rows (PERF.md): every thread
// issued cp.async and then computed, with a block barrier each ring step,
// so loads and products ran nearly one after the other; warp 0 owned two of
// nine hidden tiles, so its sub-partition issued 1.5 x the products of the
// others; and clusters of 2 (a cluster's gathered chunk had its own copy
// beside the ring) left 63 (64, 5120) f32 partials, 82.6 MB written and read
// again by a separate queue_reduce launch.  Here a producer warp keeps TMA
// loads in flight through full / empty mbarrier rings (weights evict-first
// in L2) and eight consumer warps only compute, the (hidden tile, token
// tile) products are spread so that each sub-partition issues the same
// number, the cluster's chunk takes the stage-1 ring's place so clusters of
// 8 fit (14 partials, 18.4 MB, that stay in L2), and the launch folds them
// itself: the last cluster to write an output tile (an integer arrival
// ticket) sums the tile's partials in cluster order and writes Y.
// float32 (the reduced engines check against the CPU at 2e-4, which TF32
// would miss): small_m_kernel, the same structure with an FMA loop, clusters
// of up to 8 blocks of 9 tiles, cp.async, and its partials for queue_reduce.
// The launch geometry is a function of the widths and the card, never of M,
// and each output element is one chain of products in k order plus a fold in
// cluster order, so a row's result does not depend on M or on the other rows
// (solo == batched serving).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3;
// PERF.md): bf16 at (64, 5120 -> 17920 -> 5120) 0.236 ms with its fold,
// against the 0.165 ms byte bound, 0.220 ms for cuBLAS's unfused chain and
// 0.312 ms for the clusters-of-2 design with its queue_reduce fold; 0.210 ms
// at 8 rows; below the tiled form's ~0.85 ms at every M it takes (1..64).
#include <cooperative_groups.h>

#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"
#include "wg_ring.cuh"

using namespace kt;

namespace {

constexpr int BN = 128, BK = 32, NW = 8, NT = NW * 32;
constexpr int STAGES = 3;  // cp.async pipeline depth: two k-steps in flight
// The float32 tiled form (SIMT): 64 rows per block, each warp owning 8 of
// the rows of every 128-column tile.
constexpr int F32_BM = 64, F32_WR = 8;

// Shared memory: the hidden chunk Hs, then STAGES staging slots of
// (X tile, W tile[, Wu tile]).  The f32 epilogue tile Cs aliases the
// staging slots: it is live only between k-loops, once every copy landed.
template <typename T>
struct MlpSmem {
  int ldh, ldx, ldw;
  size_t slot, off_x, off_w, off_u, total;  // slot: elements per staging slot
  __host__ __device__ MlpSmem(int bh, bool gated) {
    ldh = bh + Pad<T>::v;
    ldx = BK + Pad<T>::v;
    ldw = BN + Pad<T>::v;
    size_t xb = align128(size_t(F32_BM) * ldx * sizeof(T));
    size_t wb = align128(size_t(BK) * ldw * sizeof(T));
    off_x = align128(size_t(F32_BM) * ldh * sizeof(T));
    off_w = off_x + xb;
    off_u = off_w + wb;
    slot = (xb + wb + (gated ? wb : 0)) / sizeof(T);
    size_t staging = STAGES * slot * sizeof(T);
    size_t cs = align128(size_t(F32_BM) * (BN + 4) * sizeof(float));
    total = off_x + (staging > cs ? staging : cs);
  }
};

template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
fused_mlp_kernel(const T* __restrict__ X, const T* __restrict__ W1, const T* __restrict__ WU,
                 const T* __restrict__ W2, void* __restrict__ out, int M, int Din, int H, int Dout,
                 int BH, int act, int direct) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpSmem<T> L(BH, GATED);
  T* Hs = reinterpret_cast<T*>(smem);
  T* Xs = reinterpret_cast<T*>(smem + L.off_x);  // slot s at + s * L.slot
  T* Ws = reinterpret_cast<T*>(smem + L.off_w);
  T* Us = reinterpret_cast<T*>(smem + L.off_u);
  float* Cs = reinterpret_cast<float*>(smem + L.off_x);
  constexpr int ldc = BN + 4;
  constexpr int BM = F32_BM;
  using Acc = BlockAcc<T, BM, BN, NW, false, F32_WR>;
  const int m0 = blockIdx.x * BM, h0 = blockIdx.y * BH;
  const int hn = min(BH, H - h0);
  const bool vx = vec_ok(X, Din);
  const bool vw = vec_ok(W1, H) && (!GATED || vec_ok(WU, H));
  const bool v2 = vec_ok(W2, Dout);

  // Stage 1: the hidden chunk, on chip only, 128 columns at a time.
  const int nk = (Din + BK - 1) / BK;
  for (int hc = 0; hc < hn; hc += BN) {
    auto stage = [&](int kt) {
      if (kt < nk) {
        const size_t o = (kt % STAGES) * L.slot;
        const int k0 = kt * BK;
        load_tile<T, BM, BK, NT>(Xs + o, L.ldx, X, Din, m0, k0, M, Din, vx);
        load_tile<T, BK, BN, NT>(Ws + o, L.ldw, W1, H, k0, h0 + hc, Din, h0 + hn, vw);
        if constexpr (GATED)
          load_tile<T, BK, BN, NT>(Us + o, L.ldw, WU, H, k0, h0 + hc, Din, h0 + hn, vw);
      }
      cp_async_commit();
    };
    Acc g, u;
    g.zero();
    if constexpr (GATED) u.zero();
    for (int s = 0; s < STAGES - 1; ++s) stage(s);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // step kt landed
      __syncthreads();              // ... for every thread; slot (kt-1) is free
      stage(kt + STAGES - 1);
      const size_t o = (kt % STAGES) * L.slot;
      g.template mma<BK>(Xs + o, L.ldx, Ws + o, L.ldw);
      if constexpr (GATED) u.template mma<BK>(Xs + o, L.ldx, Us + o, L.ldw);
    }
    cp_async_wait<0>();
    __syncthreads();  // staging idle: Cs may overwrite it
    if constexpr (GATED) g.gate(act, u); else g.act(act);
    g.store(Cs, ldc);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
      int r = idx / BN, c = idx % BN;
      Hs[r * L.ldh + hc + c] = (hc + c < hn) ? from_f<T>(Cs[r * ldc + c]) : from_f<T>(0.f);
    }
    __syncthreads();
  }

  // Stage 2: chunk @ W2[h0 : h0 + hn, :], one 128-column tile of Y at a
  // time, W2 tiles pipelined like stage 1's.
  const int nk2 = (hn + BK - 1) / BK;  // chunk columns past hn are zero
  for (int n0 = 0; n0 < Dout; n0 += BN) {
    auto stage = [&](int kt) {
      if (kt < nk2)
        load_tile<T, BK, BN, NT>(Ws + (kt % STAGES) * L.slot, L.ldw, W2, Dout, h0 + kt * BK, n0,
                                 h0 + hn, Dout, v2);
      cp_async_commit();
    };
    Acc y;
    y.zero();
    for (int s = 0; s < STAGES - 1; ++s) stage(s);
    for (int kt = 0; kt < nk2; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      stage(kt + STAGES - 1);
      y.template mma<BK>(Hs + kt * BK, L.ldh, Ws + (kt % STAGES) * L.slot, L.ldw);
    }
    cp_async_wait<0>();
    __syncthreads();
    y.store(Cs, ldc);
    __syncthreads();
    T* outd = reinterpret_cast<T*>(out);
    float* outp = reinterpret_cast<float*>(out) + size_t(blockIdx.y) * M * Dout;
    if (m0 + BM <= M && n0 + BN <= Dout && Dout % 4 == 0) {  // interior: 4 at a time
      for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NT) {
        int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        float4 v = *reinterpret_cast<const float4*>(Cs + r * ldc + c);
        size_t o = size_t(m0 + r) * Dout + n0 + c;
        if (direct) store4(outd + o, v); else store4(outp + o, v);
      }
    } else {
      for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
        int r = idx / BN, c = idx % BN;
        int gr = m0 + r, gc = n0 + c;
        if (gr < M && gc < Dout) {
          float v = Cs[r * ldc + c];
          size_t o = size_t(gr) * Dout + gc;
          if (direct) outd[o] = from_f<T>(v); else outp[o] = v;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool GATED>
int launch(const void* x, const void* w1, const void* wu, const void* w2, void* out, int M,
           int Din, int H, int Dout, int bh, int act, int direct, cudaStream_t st) {
  const MlpSmem<T> L(bh, GATED);
  auto kern = fused_mlp_kernel<T, GATED>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
  if (e != cudaSuccess) return int(e);
  dim3 grid((M + F32_BM - 1) / F32_BM, (H + bh - 1) / bh);
  kern<<<grid, NT, L.total, st>>>(static_cast<const T*>(x), static_cast<const T*>(w1),
                                  static_cast<const T*>(wu), static_cast<const T*>(w2), out, M,
                                  Din, H, Dout, bh, act, direct);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tiled bf16 form: TMA + wgmma, a hidden chunk per block, folded in a cluster
// ---------------------------------------------------------------------------

constexpr int FW_NJ = 7;        // at most 7 64-wide hidden sub-chunks per block (448 columns)
constexpr int FW_CS = 8;        // blocks per cluster when H needs more than one block
constexpr int FW_SLOT = 4 * ATOM;  // a stage: 2 X boxes + Wg (+ Wu), or 4 W2 boxes
constexpr int FW_PW = 256;         // columns of Y a stage-2 pass accumulates
// Accumulator floats per thread per fold round: a round's reduce buffer is
// one ring slot (CONSUMER_NT * FW_RBN floats), so a pass folds in four
// rounds, the even ones through the slot its last step just freed, the odd
// ones through a region of their own.
constexpr int FW_RBN = 32;
constexpr int FW_RB = CONSUMER_NT * FW_RBN * 4;  // the reduce buffer of odd rounds, bytes
static_assert(FW_RB == FW_SLOT, "a ring slot holds an even round");
constexpr int SMEM_MAX = 232448;                       // what a block may use

// Dynamic shared memory of a block: the hidden atoms (2 per sub-chunk, one
// per consumer warpgroup), the ring, the reduce buffers (clusters only), the
// ring's barriers, and slack to align the base to 1024.
constexpr int fw_smem(int nj, int cs, int st) {
  return nj * 2 * ATOM + st * FW_SLOT + (cs > 1 ? FW_RB : 0) + 16 * st + 1024;
}

// The geometry of the tiled form for hidden width H, a function of H alone:
// chunks of nj 64-wide sub-chunks, one per block; cs blocks per cluster
// over consecutive chunks; one f32 partial per cluster; st ring stages,
// as many as the shared memory left beside the atoms holds.  Where H fits
// one block (H <= 448) that block writes Y itself (cs = 1, one partial);
// otherwise clusters of FW_CS, as few partials as chunks of at most FW_NJ
// sub-chunks allow, and the sub-chunks spread evenly over the chunks.
struct TiledGeometry {
  int nj, cs, partials, st;
};

inline TiledGeometry tiled_geometry(int H) {
  const int units = (H + 63) / 64;
  TiledGeometry g{units, 1, 1, 0};
  if (units > FW_NJ) {
    g.cs = FW_CS;
    g.partials = (units + FW_NJ * FW_CS - 1) / (FW_NJ * FW_CS);
    g.nj = (units + g.partials * FW_CS - 1) / (g.partials * FW_CS);
  }
  g.st = (SMEM_MAX - fw_smem(g.nj, g.cs, 0)) / (FW_SLOT + 16);
  return g;
}

struct FwdArgs {
  int M, Din, H, Dout, act, nj, partials, st;
};

// Work item i of the launch (items = partials x row tiles, group-major so
// that the clusters in flight share a group's weights in L2): the cluster
// of group g = i / n_rt builds hidden chunks g cs .. g cs + cs - 1 (member
// r the chunk g cs + r, columns from 64 nj (g cs + r)) for the 128 rows
// from 128 (i % n_rt).  A persistent grid: cluster c takes items c, c +
// n_clusters, ...
//
// Per item, a block's steps through the ring:
//   stage 1, ceil(Din / 64) steps for each group of 128 product columns:
//     gated, [g | u] = X [Wg | Wu][:, sub-chunk j] side by side in one
//     m64n128 product; ungated, g = X W1[:, sub-chunks 2c, 2c + 1].  X
//     boxes are K-major A, weight boxes MN-major B (read as stored, no
//     transposed copy).  After a group's last k step each consumer
//     warpgroup writes t = act(g) * u (or act(g)), rounded to bf16, into
//     its swizzled atoms (j, w) -- K-major A of stage 2;
//   stage 2, ceil(Dout / 256) passes of nj steps: Y[rows, 256 columns] +=
//     atom (j, w) x W2[64 hidden rows, 256 columns] (four MN-major boxes),
//     then the pass's f32 tile is folded over the cluster in rank order
//     and stored: bf16 Y where the launch leaves one partial, else f32
//     partial g of out (partials, M, Dout).
// Every output element is one chain of wgmma steps in k order plus a fold in rank order, fixed by
// (Din, H, Dout) alone: a row's result does not depend on M, on the other
// rows, or on the grid.
template <bool GATED, int CS>
__global__ void __launch_bounds__(RING_NT, 1)
mlp_fwd_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap twg,
              const __grid_constant__ CUtensorMap twu, const __grid_constant__ CUtensorMap tw2,
              void* __restrict__ out, FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int nj = a.nj, ST = a.st;
  unsigned char* TA = smem;  // atom (j, w) at (2 j + w) ATOM: rows 64 w.., hidden 64 j..
  unsigned char* ring = TA + nj * 2 * ATOM;
  float* rb = reinterpret_cast<float*>(ring + ST * FW_SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(rb) +
                                               (CS > 1 ? FW_RB : 0));
  init_ring_barriers(ST, full);
  const int rank = CS == 1 ? 0 : int(cooperative_groups::this_cluster().block_rank());
  const int cl = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int w = (threadIdx.x >> 7) - 1;  // consumer warpgroup
  const int nki = (a.Din + 63) / 64, npass = (a.Dout + FW_PW - 1) / FW_PW;
  // stage 1 runs in column groups of 128 hidden-product columns: gated, one
  // sub-chunk's g and u side by side; ungated, two sub-chunks' g
  const int ngrp = GATED ? nj : (nj + 1) / 2;
  const int s1 = ngrp * nki, S = s1 + npass * nj;  // steps per item
  const int n_rt = (a.M + 127) / 128, items = a.partials * n_rt;
  const int T = (items - cl + ncl - 1) / ncl * S;
  const bool direct = a.partials == 1;
  // the item of step t: its rows from m0, its chunk's hidden columns from h0
  auto item = [&](int t, int& m0, int& h0, int& group) {
    const int i = cl + (t / S) * ncl;
    group = i / n_rt;
    m0 = (i % n_rt) * 128;
    h0 = (group * CS + rank) * nj * 64;
  };
  auto issue = [&](int t, int s) {
    unsigned char* sl = ring + s * FW_SLOT;
    int m0, h0, group;
    item(t, m0, h0, group);
    const int q = t % S;
    if (q < s1) {
      const int hj = h0 + (q / nki) * (GATED ? 64 : 128), k0 = (q % nki) * 64;
      mbar_expect_tx(&full[s], 4 * ATOM);
      tma_load_3d(sl, &tx, &full[s], k0, m0, 0);
      tma_load_3d(sl + ATOM, &tx, &full[s], k0, m0 + 64, 0);
      tma_load_3d(sl + 2 * ATOM, &twg, &full[s], hj, k0, 0);
      if constexpr (GATED) tma_load_3d(sl + 3 * ATOM, &twu, &full[s], hj, k0, 0);
      else tma_load_3d(sl + 3 * ATOM, &twg, &full[s], hj + 64, k0, 0);
    } else {
      const int r = q - s1, n0 = (r / nj) * FW_PW, hj = h0 + (r % nj) * 64;
      mbar_expect_tx(&full[s], 4 * ATOM);
      for (int c = 0; c < 4; ++c) tma_load_3d(sl + c * ATOM, &tw2, &full[s], n0 + 64 * c, hj, 0);
    }
  };
  uint64_t* empty = full + ST;
  if (threadIdx.x < 128) {
    ring_produce(ST, T, empty, issue, [&](int t) {  // the fold after a pass's last step
      const int q = t % S;
      return CS > 1 && q >= s1 && (q - s1) % nj == nj - 1 ? 128 / FW_RBN : 0;
    });
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    int t = 0, round = 0;  // ring steps and fold rounds so far
    auto acquire = [&]() {  // the next step's slot, once its boxes landed
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      return s;
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    // once step t's products have read its slot: hand the slot back
    auto settle = [&](int s) {
      wgmma_wait0();
      release(s);
      ++t;
    };
    // accumulators: a column group's 64 floats in stage 1 (gated: g in
    // 0..31, u in 32..63), a pass's 128 in stage 2 -- never live at once,
    // so they share registers
    float acc[128];
    while (t < T) {
      int m0, h0, group;
      item(t, m0, h0, group);
      for (int c = 0; c < ngrp; ++c) {
        for (int kk = 0; kk < nki; ++kk) {
          const int s = acquire();
          const unsigned char* sl = ring + s * FW_SLOT;
          wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)  // the group's first product overwrites
            wgmma_ss_n128t<0, 1>(acc, kdesc(sl + w * ATOM + k4 * 32),
                                 mndesc(sl + 2 * ATOM + k4 * 2048, ATOM), kk | k4);
          wgmma_commit();
          settle(s);
        }
        fence_regs<64>(acc);
        // t = act(g) * u into atom (c, w); ungated, act(g) into atoms (2c, w)
        // and (2c + 1, w), the second only where the chunk has it
        const int j = GATED ? c : 2 * c;
        unsigned char* atom = TA + (2 * j + w) * ATOM;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          float t0 = act_apply(a.act, acc[i]), t1 = act_apply(a.act, acc[i + 1]);
          if constexpr (GATED) {
            t0 *= acc[i + 32];
            t1 *= acc[i + 33];
          } else if (j + 1 < nj) {
            atom_put(atom + 2 * ATOM, acc_row(i), acc_col(i),
                     pack2(act_apply(a.act, acc[i + 32]), act_apply(a.act, acc[i + 33])));
          }
          atom_put(atom, acc_row(i), acc_col(i), pack2(t0, t1));
        }
        fence_proxy_async_smem();  // the atoms are wgmma operands next
        warpgroup_sync(w);         // ... read by the whole warpgroup
      }
      for (int p = 0; p < npass; ++p) {
        for (int j = 0; j < nj; ++j) {
          const int s = acquire();
          const unsigned char* sl = ring + s * FW_SLOT;
          const unsigned char* atom = TA + (2 * j + w) * ATOM;
          wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            wgmma_ss_n256t<0, 1>(acc, kdesc(atom + k4 * 32), mndesc(sl + k4 * 2048, ATOM),
                                 j | k4);
          wgmma_commit();
          settle(s);
        }
        fence_regs<128>(acc);
        const int row0 = m0 + 64 * w, col0 = p * FW_PW;
        auto store = [&](int e, float v0, float v1) {
          const int row = row0 + acc_row(e), col = col0 + acc_col(e);
          if (!direct) {
            put_f32_pair(static_cast<float*>(out) + size_t(group) * a.M * a.Dout, a.Dout, row, col,
                         a.M, a.Dout, v0, v1);
          } else if (row < a.M && col < a.Dout) {  // Dout is even: col + 1 < Dout too
            __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + size_t(row) * a.Dout + col;
            *reinterpret_cast<uint32_t*>(o) = pack2(v0, v1);
          }
        };
        if constexpr (CS == 1) {
#pragma unroll
          for (int e = 0; e < 128; e += 2) store(e, acc[e], acc[e + 1]);
        } else {
          // even rounds through the slot of the pass's last step, which
          // the producer refills only after the fold's barriers, once both
          // warpgroups' products have read it
          unsigned char* free_slot = ring + ((t - 1) % ST) * FW_SLOT;
          auto buffer = [&](int r) {
            return r & 1 ? rb : reinterpret_cast<float*>(free_slot);
          };
          consumers_sync();
          cluster_fold<128, CS, FW_RBN>(acc, buffer, round, store);
        }
      }
    }
  }
  cooperative_groups::this_cluster().sync();
}

// Clusters of the tiled form that can be resident on the current device at
// once: the persistent grid's size.  Also allows the kernel the most shared
// memory a block may use there, so that no launch has to.
template <bool GATED, int CS>
cudaError_t tiled_resident(const TiledGeometry& geo, int* clusters) {
  auto kern = mlp_fwd_wgmma<GATED, CS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS);
  cfg.blockDim = dim3(RING_NT);
  cfg.dynamicSmemBytes = fw_smem(geo.nj, geo.cs, geo.st);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

template <bool GATED>
int launch_tiled(const CUtensorMap& tx, const CUtensorMap& twg, const CUtensorMap& twu,
                 const CUtensorMap& tw2, void* out, const TiledGeometry& geo, const FwdArgs& a,
                 int clusters, cudaStream_t st) {
  const int n_rt = (a.M + 127) / 128, items = a.partials * n_rt;
  const int ncl = clusters < items ? clusters : items;
  const int smem = fw_smem(geo.nj, geo.cs, geo.st);
  if (geo.cs == 1)
    return int(launch_cluster(mlp_fwd_wgmma<GATED, 1>, dim3(ncl), smem, 1, st, tx, twg, twu, tw2,
                              out, a));
  return int(launch_cluster(mlp_fwd_wgmma<GATED, FW_CS>, dim3(ncl * FW_CS), smem, FW_CS, st, tx,
                            twg, twu, tw2, out, a));
}

// ---------------------------------------------------------------------------
// Small M (decode): the swapped product, one cluster per hidden range
// ---------------------------------------------------------------------------

constexpr int SM_MAXM = 64;           // rows the form takes (8 token tiles of 8)
constexpr int SM_MAX_CLUSTER = 8;     // the portable cluster size

// The launch geometry of the small-M form for one (dtype, gated, Din, H,
// Dout) on the current device -- never a function of M.  The caller keeps
// it and hands it back with every launch.  fold: 0, the f32 partials (if
// more than one) are left for queue_reduce; 1, the launch folds them into Y,
// each output tile by the block that brought its last partial; 2, the same
// shared over the grid, whose blocks are all resident at once (bf16).
struct SmallPlan {
  int ht, cs, nb, ds, hr_pad, fold;
};

// Occupancy of `kern` in clusters of cs blocks of nt threads and smem bytes.
template <typename Kern>
cudaError_t resident_clusters(Kern kern, int cs, int nt, size_t smem, int nb, int* nclusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(nclusters, kern, &cfg);
}

template <typename Kern, typename... Args>
cudaError_t launch_in_clusters(Kern kern, int nb, int cs, int nt, size_t smem, cudaStream_t st,
                               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// float32, small_m_kernel (SIMT, FMA): blocks of up to 9 16-column hidden
// tiles, about one per SM, stream W1 (and Wu) with X through a 3-stage
// cp.async ring of 32-row steps; a cluster of CS blocks owns a contiguous
// hidden range: each builds act(g) * u for its own columns, the members copy
// each other's chunks over distributed shared memory in rank order, and
// member r multiplies the cluster's whole chunk into its Dout / CS columns of
// W2.  One f32 partial of Y per cluster, (n_clusters, M, Dout), goes to
// queue_reduce.
constexpr int SM_NW = 8, SM_NT = SM_NW * 32;
constexpr int SM_HT = 9;              // at most 9 16-column hidden tiles per block
constexpr int SM_HS = SM_HT * 16;     // hidden columns a block's staging tile spans
constexpr int SM_OT = 128;            // output columns per stage-2 pass
constexpr int SM_KS = 32, SM_STAGES = 3;  // k rows per ring stage (both stages), ring depth

// Shared memory of an f32 small-M block for MP token rows and a cluster
// hidden range padded to hr_pad columns: the block's own hidden chunk (read
// by the whole cluster), then the stage-1 ring (W1 [+ Wu] tile of SM_KS x
// SM_HS and an X tile of MP x SM_KS per slot) aliased, once it drained, by
// the cluster's hidden chunk (MP x hr_pad) and the stage-2 ring (W2 tiles of
// SM_KS x SM_OT).
struct SmallSmem {
  int ldw, ldx, ldh, ldc, ldo;  // elements
  size_t own, wt, xt, slot1, ring1, hc, slot2, total;  // bytes
  __host__ __device__ SmallSmem(int mp, int hr_pad, bool gated) {
    constexpr int P = Pad<float>::v;
    ldw = SM_HS + P;
    ldx = SM_KS + P;
    ldh = SM_HS + P;
    ldc = hr_pad + P;
    ldo = SM_OT + P;
    own = align128(size_t(mp) * ldh * 4);
    wt = align128(size_t(SM_KS) * ldw * 4);
    xt = align128(size_t(mp) * ldx * 4);
    slot1 = (gated ? 2 : 1) * wt + xt;
    ring1 = SM_STAGES * slot1;
    hc = align128(size_t(mp) * ldc * 4);
    slot2 = align128(size_t(SM_KS) * ldo * 4);
    const size_t s2 = hc + SM_STAGES * slot2;
    total = own + (ring1 > s2 ? ring1 : s2);
  }
};

// A linear sequence of n ring steps over STG slots: prologue(n, stage)
// issues the first STG - 1, run(n, stage, use) waits for each in turn,
// refills the slot freed by the step before and calls use(t, slot).  Every
// thread issues copies, so each step starts with a block barrier; run ends
// with every copy landed and every thread past its last use.
template <int STG, typename Stage>
__device__ __forceinline__ void ring_prologue(int n, Stage stage) {
  for (int s = 0; s < STG - 1; ++s) {
    if (s < n) stage(s, s);
    cp_async_commit();
  }
}
template <int STG, typename Stage, typename Use>
__device__ __forceinline__ void ring_run(int n, Stage stage, Use use) {
  for (int t = 0; t < n; ++t) {
    cp_async_wait<STG - 2>();
    __syncthreads();
    const int nx = t + STG - 1;
    if (nx < n) stage(nx, nx % STG);
    cp_async_commit();
    use(t, t % STG);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Block b of cluster c (rank r) owns hidden columns [b hs, b hs + hs),
// hs = HT * 16; the cluster owns their union, hr = CS hs columns from
// hc0 = c hr.
//   Stage 1: the block's hidden chunk, streamed over Din through the ring;
//     act(g) * u into the block's own chunk.
//   Exchange: after a cluster barrier every member copies all members'
//     chunks (distributed shared memory, rank order) into the cluster's
//     hidden chunk, MP x hr.
//   Stage 2: member r owns output columns [r DS, r DS + DS) over the
//     cluster's hidden range, SM_OT columns a pass, every pass's tiles in
//     one continuous ring.  Its W2 tiles start loading before the exchange.
// out: direct, Y; else f32 partials (gridDim.x / CS, M, Dout), one per
// cluster.  Every output element is one FMA chain in k order, fixed by
// (Din, H, Dout, HT, CS) alone, so a row's result does not depend on M or
// on the other rows.
template <bool GATED, int MP>
__global__ void __launch_bounds__(SM_NT, 1)
small_m_kernel(const float* __restrict__ X, const float* __restrict__ W1,
               const float* __restrict__ WU, const float* __restrict__ W2, float* __restrict__ out,
               int M, int Din, int H, int Dout, int HT, int DS, int hr_pad, int act, int direct) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const SmallSmem L(MP, hr_pad, GATED);
  float* own = reinterpret_cast<float*>(smem);
  unsigned char* ring1 = smem + L.own;
  float* hcs = reinterpret_cast<float*>(smem + L.own);
  unsigned char* ring2 = smem + L.own + L.hc;
  constexpr int STG = SM_STAGES, KS = SM_KS;
  const int hs = HT * 16, h0 = blockIdx.x * hs, hend = min(H, h0 + hs);
  const int cl = blockIdx.x / CS, hr = CS * hs, hc0 = cl * hr, hc_end = min(H, hc0 + hr);
  const bool vx = vec_ok(X, Din), vw = vec_ok(W1, H) && (!GATED || vec_ok(WU, H));
  const bool v2 = vec_ok(W2, Dout);

  // ---- stage 1 ----
  auto W1s = [&](int s) { return reinterpret_cast<float*>(ring1 + s * L.slot1); };
  auto WUs = [&](int s) { return reinterpret_cast<float*>(ring1 + s * L.slot1 + L.wt); };
  auto Xs = [&](int s) {
    return reinterpret_cast<float*>(ring1 + s * L.slot1 + (GATED ? 2 : 1) * L.wt);
  };
  const int nk = (Din + KS - 1) / KS;
  auto stage1 = [&](int t, int s) {
    const int k0 = t * KS;
    load_tile<float, KS, SM_HS, SM_NT>(W1s(s), L.ldw, W1, H, k0, h0, Din, hend, vw);
    if constexpr (GATED)
      load_tile<float, KS, SM_HS, SM_NT>(WUs(s), L.ldw, WU, H, k0, h0, Din, hend, vw);
    load_tile<float, MP, KS, SM_NT>(Xs(s), L.ldx, X, Din, 0, k0, M, Din, vx);
  };
  ring_prologue<STG>(nk, stage1);
  // thread (tc, tm) owns hidden columns tc + 16 i and tokens tm + 16 j
  constexpr int MJ = MP >= 16 ? MP / 16 : 1;
  const int tc = threadIdx.x & 15, tm = threadIdx.x >> 4;
  {
    float g[SM_HT][MJ], u[SM_HT][MJ];
#pragma unroll
    for (int i = 0; i < SM_HT; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) g[i][j] = u[i][j] = 0.f;
    ring_run<STG>(nk, stage1, [&](int, int s) {
      if (tm >= MP) return;
      const float* w = W1s(s);
      const float* wu = WUs(s);
      const float* xs = Xs(s);
      for (int k = 0; k < KS; ++k) {
        float xv[MJ];
#pragma unroll
        for (int j = 0; j < MJ; ++j) xv[j] = xs[(tm + 16 * j) * L.ldx + k];
#pragma unroll
        for (int i = 0; i < SM_HT; ++i) {
          const float wv = w[k * L.ldw + tc + 16 * i];
#pragma unroll
          for (int j = 0; j < MJ; ++j) g[i][j] = fmaf(wv, xv[j], g[i][j]);
          if constexpr (GATED) {
            const float uv = wu[k * L.ldw + tc + 16 * i];
#pragma unroll
            for (int j = 0; j < MJ; ++j) u[i][j] = fmaf(uv, xv[j], u[i][j]);
          }
        }
      }
    });
    if (tm < MP) {
#pragma unroll
      for (int i = 0; i < SM_HT; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const float a = act_apply(act, g[i][j]);
          own[(tm + 16 * j) * L.ldh + tc + 16 * i] = GATED ? a * u[i][j] : a;
        }
    }
  }
  __syncthreads();  // own chunk written; ring 1 drained

  // ---- stage 2: first tiles in flight, then the exchange ----
  const int n_lo = rank * DS, n_hi = min(Dout, n_lo + DS);
  const int npass = n_hi > n_lo ? (n_hi - n_lo + SM_OT - 1) / SM_OT : 0;
  const int nk2 = (hc_end - hc0 + KS - 1) / KS;
  auto W2s = [&](int s) { return reinterpret_cast<float*>(ring2 + s * L.slot2); };
  auto stage2 = [&](int t, int s) {
    const int p = t / nk2, kt = t % nk2;
    load_tile<float, KS, SM_OT, SM_NT>(W2s(s), L.ldo, W2, Dout, hc0 + kt * KS,
                                       n_lo + p * SM_OT, hc_end, n_hi, v2);
  };
  ring_prologue<STG>(npass * nk2, stage2);
  cluster.sync();  // every member's own chunk is written
  {
    const int pr = hs / 4;  // 16-byte pieces per member row (hs % 16 == 0)
    for (int r = 0; r < CS; ++r) {
      const float* src = cluster.map_shared_rank(own, r);
      for (int idx = threadIdx.x; idx < MP * pr; idx += SM_NT) {
        const int m = idx / pr, c = (idx % pr) * 4;
        *reinterpret_cast<float4*>(hcs + m * L.ldc + r * hs + c) =
            *reinterpret_cast<const float4*>(src + m * L.ldh + c);
      }
    }
    for (int idx = threadIdx.x; idx < MP * (hr_pad - hr); idx += SM_NT)
      hcs[(idx / (hr_pad - hr)) * L.ldc + hr + idx % (hr_pad - hr)] = 0.f;
  }
  __syncthreads();

  float* outp = out + (direct ? 0 : size_t(cl) * M * Dout);
  constexpr int OI = SM_OT / 16;
  float y[OI][MJ];
#pragma unroll
  for (int i = 0; i < OI; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) y[i][j] = 0.f;
  ring_run<STG>(npass * nk2, stage2, [&](int t, int s) {
    if (tm >= MP) return;
    const int p = t / nk2, kt = t % nk2;
    const float* w = W2s(s);
    for (int k = 0; k < KS; ++k) {
      float hv[MJ];
#pragma unroll
      for (int j = 0; j < MJ; ++j) hv[j] = hcs[(tm + 16 * j) * L.ldc + kt * KS + k];
#pragma unroll
      for (int i = 0; i < OI; ++i) {
        const float wv = w[k * L.ldo + tc + 16 * i];
#pragma unroll
        for (int j = 0; j < MJ; ++j) y[i][j] = fmaf(wv, hv[j], y[i][j]);
      }
    }
    if (kt == nk2 - 1) {
#pragma unroll
      for (int i = 0; i < OI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const int m = tm + 16 * j, n = n_lo + p * SM_OT + tc + 16 * i;
          if (m < M && n < n_hi) outp[size_t(m) * Dout + n] = y[i][j];
          y[i][j] = 0.f;
        }
    }
  });
  cluster.sync();  // no member leaves while another may still read its chunk
}

// Blocks of HT <= SM_HT hidden tiles, about one per SM; the largest cluster
// (8, 4, 2 or 1 blocks) whose shared memory fits at SM_MAXM rows and whose
// clusters can all be resident at once (or fill the card's SMs, when the
// blocks outnumber them).  Also raises the form's shared-memory limit on
// the device to the most a block may opt into, so that no launch has to.
template <bool GATED>
cudaError_t small_plan_f32(int H, int Dout, int nsm, int optin, SmallPlan* plan) {
  for (auto k : {small_m_kernel<GATED, 8>, small_m_kernel<GATED, 16>, small_m_kernel<GATED, 32>,
                 small_m_kernel<GATED, 64>}) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
  }
  const int nt16 = (H + 15) / 16;
  const int ht = min(SM_HT, (nt16 + nsm - 1) / nsm);
  const int nb0 = (nt16 + ht - 1) / ht;
  for (int cs = SM_MAX_CLUSTER; cs >= 1; cs /= 2) {
    const int nb = (nb0 + cs - 1) / cs * cs;
    const int hr = cs * ht * 16, hr_pad = (hr + SM_KS - 1) / SM_KS * SM_KS;
    const SmallSmem L(SM_MAXM, hr_pad, GATED);
    if (L.total > size_t(optin)) continue;
    int nclusters = 0;
    cudaError_t e = resident_clusters(small_m_kernel<GATED, SM_MAXM>, cs, SM_NT, L.total, nb,
                                      &nclusters);
    if (e != cudaSuccess) return e;
    const int resident = nclusters * cs;
    if (cs > 1 && resident < nb && resident < nsm) continue;
    *plan = SmallPlan{ht, cs, nb, ((Dout + cs - 1) / cs + 15) / 16 * 16, hr_pad, 0};
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

template <bool GATED>
int launch_small_f32(const SmallPlan& p, const void* x, const void* w1, const void* wu,
                     const void* w2, void* out, int M, int Din, int H, int Dout, int act,
                     cudaStream_t st) {
  const bool cs_ok = p.cs == 1 || p.cs == 2 || p.cs == 4 || p.cs == SM_MAX_CLUSTER;
  if (!(cs_ok && p.ht >= 1 && p.ht <= SM_HT && p.nb >= p.cs && p.nb % p.cs == 0 &&
        size_t(p.nb) * p.ht * 16 >= size_t(H) && p.ds % 16 == 0 && p.ds * p.cs >= Dout &&
        p.hr_pad >= p.cs * p.ht * 16 && p.hr_pad % SM_KS == 0 && !p.fold))
    return int(cudaErrorInvalidValue);
  const int mp = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
  auto kern = mp == 8    ? small_m_kernel<GATED, 8>
              : mp == 16 ? small_m_kernel<GATED, 16>
              : mp == 32 ? small_m_kernel<GATED, 32>
                         : small_m_kernel<GATED, 64>;
  const SmallSmem L(mp, p.hr_pad, GATED);
  return int(launch_in_clusters(kern, p.nb, p.cs, SM_NT, L.total, st,
                                static_cast<const float*>(x), static_cast<const float*>(w1),
                                static_cast<const float*>(wu), static_cast<const float*>(w2),
                                static_cast<float*>(out), M, Din, H, Dout, p.ht, p.ds, p.hr_pad,
                                act, int(p.nb == p.cs)));
}

// bfloat16 on Hopper, small_m_kernel_tma: at phi3-medium-14b's widths the
// weights are 550 MB, 0.164 ms at 3.35 TB/s, and at 64 rows the products are
// 35 GFLOP (36 us at the bf16 peak), so the form is bound by the weight
// stream and has to keep the products and everything else under it.
//   * Loads off the consumers: warp 8 of a block produces -- its lane 0
//     keeps TMA loads in flight through two rings of full / empty mbarriers
//     (weights evict-first in L2, so that the partials below stay there) --
//     and warps 0-7 only compute: no block barrier per ring step.  A step
//     loads the block's weight columns in the widest boxes that cover them
//     and no others (`issue_w`).
//   * The product is swapped, Y^T = W^T X^T: each 16 x 16 weight tile is
//     mma.sync m16n8k16's A operand (ldmatrix.trans out of the swizzled TMA
//     boxes) and the token rows its 8-wide N, so no product runs on a
//     padding row of a 64-row tile; a block keeps the fine split of H into
//     16-column tiles (1120 at phi3's 17920), and the (hidden tile, token
//     tile) products are spread over the warps so that every SM
//     sub-partition issues the same number of them at 64 rows.
//   * Partials: a cluster of CS blocks (8 where the card holds them) shares
//     a hidden range.  Each member writes act(g) * u for its columns into
//     its copy of the cluster's chunk, which takes the drained stage-1
//     ring's place, the members copy each other's columns over distributed
//     shared memory, and member r multiplies the whole chunk into its DS
//     columns of W2 (128 a pass, its passes from its cluster's index on).
//     So the launch leaves one f32 partial of Y per cluster (14 of (64,
//     5120) at phi3's widths with 112 blocks: 18.4 MB, where clusters of 2
//     left 63 and 82.6 MB), and folds them itself in cluster order.  An
//     integer ticket per output tile counts the partials that arrived.
//     Where every block of the grid is resident at once (fold mode 2, the
//     plan's own grids), each block, done with its passes, helps: it claims
//     row slices of the tiles in turn on one counter, waits for a slice's
//     tile and folds it, so the last partials' fold is spread over the grid
//     instead of lying on the blocks that brought them (which are the
//     slowest: clusters that share a GPC stream more slowly).  A helper
//     waits SB_HELP_NS at most in all; then it gives its slice back (a bit
//     beside the tile's ticket) and leaves, so should the grid not be
//     resident after all (kernels of another stream holding SMs), no block
//     waits on one that cannot start.  The block that brought a tile's last
//     partial folds, once done with its passes, the tile's slices that no
//     helper claimed or that were given back (all of them in mode 1, for
//     grids that take waves).  A slice may so be folded twice, to the same
//     bits.  The tickets live in a workspace the caller hands the launch,
//     one per stream, zero between launches: the last block out resets
//     them, so a replayed graph needs no memset.
// Geometry (small_plan_tma) is a function of the widths and the card: as
// many blocks as there are SMs for the hidden tiles, the largest cluster
// whose clusters are all resident and use at least 7/8 of the blocks a grid
// without clusters would.  Every output element is one chain of products
// in k order over the cluster's hidden range and a fold in cluster order,
// fixed by the widths, so a row's result does not depend on M or on the
// other rows, and two runs give the same bits.
constexpr int SB_NW = 8;                 // consumer warps
constexpr int SB_NT = (SB_NW + 1) * 32;  // and one producer warp
constexpr int SB_HT = 10;                // 16-column hidden tiles a block at most
static_assert(SB_HT % 2 == 0, "an odd block's last box holds one tile more");
constexpr int SB_KS = 64, SB_KS2 = 64;   // k rows a ring step: stage 1, stage 2
constexpr int SB_OT = 128;               // output columns a stage-2 pass
constexpr int SB_ST1 = 3, SB_ST2 = 4;    // ring depths
constexpr int SB_TILE = SB_KS * 32;      // bytes of a 16-column weight tile of a step
constexpr int SB_BOX2 = SB_KS2 * 128;    // one 64-column W2 box of SB_KS2 rows of 128 bytes
constexpr int SB_TICKETS = 4096;         // output tiles (rank, pass) a launch may fold
// The in-launch fold's workspace, SB_TICKETS + 2 ints, zero between
// launches: a word per output tile (its partials arrived in bits 0-15, its
// slices given back in bits 16-23), the helpers' next slice, the blocks out.
constexpr int SB_SPT = 8;  // slices (row groups) of an output tile in the fold
// What a helper waits for tiles in all (fold mode 2): well above the waits
// of a resident grid, whose blocks end stage 1 within ~45 us of each other
// at phi3's widths and 64 rows
constexpr unsigned long long SB_HELP_NS = 250000;

// Shared memory of a bf16 small-M block for MP token rows and a cluster
// hidden range padded to hr_pad columns: region A holds the stage-1 ring
// (W1 [+ Wu] boxes of up to SB_HT tiles, an X box of MP x 64) and, once
// it drained, the cluster's hidden chunk (MP x hr_pad, rows padded by 16
// bytes so that ldmatrix's eight row reads hit eight bank groups); then the
// stage-2 ring (two W2 boxes a step), the barriers and two ints of the
// fold.  1024 bytes spare to align it.
struct SmallTmaSmem {
  int ldc;                     // elements of a hidden-chunk row
  size_t slot1, a, slot2, total;
  __host__ __device__ SmallTmaSmem(int mp, int hr_pad, bool gated) {
    ldc = hr_pad + 8;
    slot1 = size_t(gated ? 2 : 1) * SB_HT * SB_TILE + size_t(mp) * 128;
    const size_t ring1 = SB_ST1 * slot1, hc = size_t(mp) * ldc * 2;
    a = ((ring1 > hc ? ring1 : hc) + 1023) & ~size_t(1023);
    slot2 = 2 * SB_BOX2;
    total = 1024 + a + SB_ST2 * slot2 + 2 * (SB_ST1 + SB_ST2) * 8 + 16;
  }
};

// Four 8x8 b16 matrices, transposed on the way into registers: with the
// lanes' row addresses of a 16 x 16 tile stored k-major (lanes 0-15: k rows
// 0-7 at columns 0 and 8, lanes 16-31: k rows 8-15), mma.sync m16n8k16's A
// fragment of its transpose.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8 f32) += A (16 x 16 bf16) B (16 x 8 bf16)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A tensor map over a row-major (rows, cols) bf16 matrix in boxes of
// box_rows x box_cols with the given swizzle.
inline cudaError_t map_box(CUtensorMap* m, const void* p, int rows, int cols, int box_rows,
                           int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), 1};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2, cuuint64_t(rows) * cols * 2};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  return encode_bf16_3d(m, p, dims, strides, box, swizzle);
}

// A 2-D TMA box load (a 3-D map with one plane) with an L2 cache policy.
__device__ __forceinline__ void tma_load_hint(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(0),
      "l"(policy)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The lane's ldmatrix.trans row address for mma's A fragment of the 16 x 16
// tile at k rows kk.. of a k-major TMA box: the 16-column half `half` of a
// box of 64-byte rows (32 columns; 64-byte swizzle: the 16-byte piece p of
// row k at p ^ (k / 2) % 4).
__device__ __forceinline__ const void* a_sw64(const unsigned char* box, int kk, int half) {
  const int l = threadIdx.x & 31, k = kk + (l >> 4) * 8 + (l & 7);
  return box + k * 64 + (((half * 2 + ((l >> 3) & 1)) ^ ((k >> 1) & 3)) << 4);
}
// The same for columns c0.. (a multiple of 16) of a box of 128-byte rows (64
// columns; 128-byte swizzle: the 16-byte piece p of row k at p ^ k % 8).
__device__ __forceinline__ const void* a_sw128(const unsigned char* box, int kk, int c0) {
  const int l = threadIdx.x & 31, k = kk + (l >> 4) * 8 + (l & 7);
  return box + k * 128 + ((((c0 >> 3) + ((l >> 3) & 1)) ^ (k & 7)) << 4);
}
// mma's B fragments of N token tiles from tile0 on, k columns kk..kk + 15,
// of token rows whose 16-byte pieces addr(token, k) gives: ldmatrix (not
// transposed) of two tiles at a time.
template <int N, typename Addr>
__device__ __forceinline__ void frag_b(uint32_t (*b)[2], int tile0, int kk, Addr addr) {
  const int l = threadIdx.x & 31, q = l >> 3;
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    uint32_t r[4];
    if (j + 1 < N) {
      ldsm_x4(r, addr((tile0 + j + (q >> 1)) * 8 + (l & 7), kk + (q & 1) * 8));
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    } else {
      ldsm_x2(r, addr((tile0 + j) * 8 + (l & 7), kk + (q & 1) * 8));
    }
    b[j][0] = r[0];
    b[j][1] = r[1];
  }
}

// A block's HT hidden tiles of a weight (Din x H) as a stage-1 step loads
// them: HT / 4 boxes of 64 k rows by 64 columns (8 KB, 128-byte swizzle),
// then one of 32 columns (4 KB, 64-byte swizzle) where HT % 4 >= 2, then,
// where HT is odd, a 32-column box over the last tile and the one before
// it, which the block loads twice (from L2) rather than stream a 16-column
// box: TMA streams wide boxes faster (32-column boxes in place of 16-column
// ones took 6 % off the form at 8 rows on the H100, and this one 1.5 % off
// maverick's 9 tiles), and no box reaches another block's columns.  One
// tensor map per box width.
struct WMaps {
  CUtensorMap c64, c32;
};

__device__ __forceinline__ void issue_w(unsigned char* slot, const WMaps& m, uint64_t* bar, int h0,
                                        int k0, int HT, uint64_t pol) {
  const int h4 = HT >> 2;
  for (int b = 0; b < h4; ++b) tma_load_hint(slot + b * 8192, &m.c64, bar, h0 + 64 * b, k0, pol);
  unsigned char* rest = slot + h4 * 8192;
  if ((HT & 3) >= 2) {
    tma_load_hint(rest, &m.c32, bar, h0 + 64 * h4, k0, pol);
    rest += 4096;
  }
  if (HT & 1) tma_load_hint(rest, &m.c32, bar, h0 + 16 * (HT - 2), k0, pol);
}

// The lane's ldmatrix.trans address for hidden tile h of such a slot.
__device__ __forceinline__ const void* a_tile(const unsigned char* slot, int HT, int h, int kk) {
  const int h4 = HT >> 2, q = h - 4 * h4;
  if (q < 0) return a_sw128(slot + (h >> 2) * 8192, kk, (h & 3) * 16);
  if (q < 2 && (HT & 3) >= 2) return a_sw64(slot + h4 * 8192, kk, q);
  return a_sw64(slot + h4 * 8192 + ((HT & 3) >= 2 ? 4096 : 0), kk, 1);
}

inline cudaError_t map_weight(WMaps* m, const void* w, int Din, int H) {
  cudaError_t e = map_box(&m->c64, w, Din, H, SB_KS, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess) e = map_box(&m->c32, w, Din, H, SB_KS, 32, CU_TENSOR_MAP_SWIZZLE_64B);
  return e;
}

// The in-launch fold of rows m0 .. m1 - 1, columns n0 .. n0 + ncol - 1 of
// Y by a block's consumer warps: the P f32 partials summed from L2 in
// cluster order, eight loads in flight a thread.
__device__ __forceinline__ void fold_rows(const float* part, __nv_bfloat16* y, int P, int M,
                                          int Dout, int m0, int m1, int n0, int ncol) {
  constexpr int U = 8;
  const int q4 = ncol / 4;
  const size_t pstride = size_t(M) * Dout;
  for (int idx = threadIdx.x; idx < (m1 - m0) * q4; idx += SB_NW * 32) {
    const size_t off = size_t(m0 + idx / q4) * Dout + n0 + (idx % q4) * 4;
    const float* src = part + off;
    float4 acc = __ldcg(reinterpret_cast<const float4*>(src));
    for (int q0 = 1; q0 < P; q0 += U) {
      float4 v[U];
#pragma unroll
      for (int i = 0; i < U; ++i)
        if (q0 + i < P) v[i] = __ldcg(reinterpret_cast<const float4*>(src + (q0 + i) * pstride));
#pragma unroll
      for (int i = 0; i < U; ++i)
        if (q0 + i < P) {
          acc.x += v[i].x;
          acc.y += v[i].y;
          acc.z += v[i].z;
          acc.w += v[i].w;
        }
    }
    store4(y + off, acc);
  }
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Block b of cluster c (rank r) owns hidden columns [b hs, b hs + hs),
// hs = HT * 16; the cluster owns their union, hr = CS hs columns from
// hc0 = c hr.
//   Stage 1: g^T = W1[:, block's columns]^T X^T (and u^T) over Din, 64 k
//     rows a ring step; act(g) * u, rounded to bf16, into the block's
//     columns of its copy of the cluster's chunk (MP x hr).
//   Exchange: after a cluster barrier every member copies the other
//     members' columns of the chunk out of their shared memory.
//   Stage 2: member r owns output columns [r DS, r DS + DS): Y^T = W2[hr
//     rows, its columns]^T t^T, 128 columns a pass, its passes from pass c
//     on; the first W2 boxes load during the exchange.
// y: Y (M, Dout); part: f32 partials (gridDim.x / CS, M, Dout), one per
// cluster.  One cluster: Y written directly.  Else each pass's partial tile
// is written and, with y, counted on its ticket in `tickets` (the fold's
// workspace) and folded into Y (fold: the plan's mode, 1 or 2); with y null
// the partials are left to the caller.
template <bool GATED, int MP>
__global__ void __launch_bounds__(SB_NT, 1)
small_m_kernel_tma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ WMaps tw1,
                   const __grid_constant__ WMaps twu, const __grid_constant__ CUtensorMap tw2,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                   unsigned int* tickets, int M, int Din, int H, int Dout, int HT, int DS,
                   int hr_pad, int act, int fold) {
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const SmallTmaSmem L(MP, hr_pad, GATED);
  unsigned char* ring1 = smem;
  __nv_bfloat16* hcs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring2 = smem + L.a;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(ring2 + SB_ST2 * L.slot2);
  uint64_t* empty1 = full1 + SB_ST1;
  uint64_t* full2 = empty1 + SB_ST1;
  uint64_t* empty2 = full2 + SB_ST2;
  // two slots for thread 0 to hand the consumers a value (the fold's)
  volatile unsigned int* note = reinterpret_cast<unsigned int*>(empty2 + SB_ST2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hs = HT * 16, h0 = blockIdx.x * hs;
  const int cl = blockIdx.x / CS, P = gridDim.x / CS;
  const int hr = CS * hs, hc0 = cl * hr, hc_end = min(H, hc0 + hr);
  const int n_lo = rank * DS, n_hi = min(Dout, n_lo + DS);
  const int npass = n_hi > n_lo ? (n_hi - n_lo + SB_OT - 1) / SB_OT : 0;
  const int nk = (Din + SB_KS - 1) / SB_KS;
  const int nk2 = hc_end > hc0 ? (hc_end - hc0 + SB_KS2 - 1) / SB_KS2 : 0;
  const int T2 = npass * nk2;
  const int xoff = (GATED ? 2 : 1) * SB_HT * SB_TILE;  // the X box within a stage-1 slot
  // stage-2 step t: pass (t / nk2 + c) % npass, k step t % nk2
  auto pass_of = [&](int t) { return (t / nk2 + cl) % npass; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < SB_ST1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], SB_NW);
    }
    for (int s = 0; s < SB_ST2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], SB_NW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == SB_NW) {
    // ---- the producer ----
    uint64_t pol = 0;
    if (lane == 0) {
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
      const uint32_t bytes1 = (GATED ? 2 : 1) * (HT + (HT & 1)) * SB_TILE + MP * 128;
      for (int t = 0; t < nk; ++t) {
        const int s = t % SB_ST1;
        if (t >= SB_ST1) mbar_wait(&empty1[s], ((t / SB_ST1) + 1) & 1);
        unsigned char* slot = ring1 + s * L.slot1;
        mbar_expect_tx(&full1[s], bytes1);
        issue_w(slot, tw1, &full1[s], h0, t * SB_KS, HT, pol);
        if constexpr (GATED) issue_w(slot + SB_HT * SB_TILE, twu, &full1[s], h0, t * SB_KS, HT, pol);
        tma_load_3d(slot + xoff, &tx, &full1[s], t * SB_KS, 0, 0);
      }
    }
    auto issue2 = [&](int t) {
      const int s = t % SB_ST2;
      if (t >= SB_ST2) mbar_wait(&empty2[s], ((t / SB_ST2) + 1) & 1);
      const int n0 = n_lo + pass_of(t) * SB_OT, kt = t % nk2;
      const int nbox = n_hi - n0 > 64 ? 2 : 1;
      mbar_expect_tx(&full2[s], nbox * SB_BOX2);
      for (int b = 0; b < nbox; ++b)
        tma_load_hint(ring2 + s * L.slot2 + b * SB_BOX2, &tw2, &full2[s], n0 + 64 * b,
                      hc0 + kt * SB_KS2, pol);
    };
    const int pre = min(SB_ST2, T2);
    if (lane == 0)
      for (int t = 0; t < pre; ++t) issue2(t);
    __syncwarp();
    cluster.sync();  // the members' chunks are written
    cluster_arrive();
    if (lane == 0)
      for (int t = pre; t < T2; ++t) issue2(t);
    __syncwarp();
    cluster_wait();
    return;
  }

  // ---- stage 1 (consumers) ----
  // warp (hg, tg) = warp / TG, warp % TG: hidden tiles hg + HG i, token
  // tiles tg TPW ..; warps w and w + 4 share an SM sub-partition and hold
  // the same token tiles, so each sub-partition issues HT / 2 hidden tiles'
  // products at MP = 16.. 64
  constexpr int NT8 = MP / 8;
  constexpr int TG = NT8 >= 2 ? 2 : 1, TPW = NT8 / TG, HG = SB_NW / TG;
  constexpr int HTW = (SB_HT + HG - 1) / HG;
  const int tg = warp % TG, hg = warp / TG;
  {
    float g[HTW][TPW][4], u[HTW][TPW][4];
#pragma unroll
    for (int i = 0; i < HTW; ++i)
#pragma unroll
      for (int j = 0; j < TPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[i][j][e] = u[i][j][e] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % SB_ST1;
      mbar_wait(&full1[s], (t / SB_ST1) & 1);
      const unsigned char* slot = ring1 + s * L.slot1;
      const unsigned char* xs = slot + xoff;
      auto xaddr = [&](int tok, int k) {
        return xs + tok * 128 + ((((k >> 3)) ^ (tok & 7)) << 4);
      };
#pragma unroll
      for (int kk = 0; kk < SB_KS; kk += 16) {
        uint32_t b[TPW][2];
        frag_b<TPW>(b, tg * TPW, kk, xaddr);
#pragma unroll
        for (int i = 0; i < HTW; ++i) {
          const int h = hg + HG * i;
          if (h < HT) {
            uint32_t a[4];
            ldsm_x4_t(a, a_tile(slot, HT, h, kk));
#pragma unroll
            for (int j = 0; j < TPW; ++j) mma16816(g[i][j], a, b[j]);
            if constexpr (GATED) {
              ldsm_x4_t(a, a_tile(slot + SB_HT * SB_TILE, HT, h, kk));
#pragma unroll
              for (int j = 0; j < TPW; ++j) mma16816(u[i][j], a, b[j]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty1[s]);
    }
    consumers_sync();  // ring 1 drained: the chunk takes its place
    // element e of a 16 x 8 accumulator: hidden row lane / 4 (+8 for e >= 2),
    // token 2 (lane % 4) + (e & 1)
#pragma unroll
    for (int i = 0; i < HTW; ++i) {
      const int h = hg + HG * i;
      if (h < HT) {
#pragma unroll
        for (int j = 0; j < TPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hrow = rank * hs + h * 16 + (lane >> 2) + (e >> 1) * 8;
            const int tok = (tg * TPW + j) * 8 + 2 * (lane & 3) + (e & 1);
            const float a = act_apply(act, g[i][j][e]);
            hcs[tok * L.ldc + hrow] = from_f<__nv_bfloat16>(GATED ? a * u[i][j][e] : a);
          }
      }
    }
  }
  cluster.sync();  // every member's columns of the chunk are written

  // ---- exchange: the other members' columns, eight 16-byte loads in flight ----
  {
    constexpr int U = 8, CNT = SB_NW * 32;
    const int pr = hs / 8, per = MP * pr, total = CS * per;
    for (int base = threadIdx.x; base < total; base += U * CNT) {
      uint4 v[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int idx = base + q * CNT, r = idx / per;
        if (idx < total && r != rank) {
          const int m = (idx % per) / pr, c = r * hs + (idx % pr) * 8;
          v[q] = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(hcs, r) + m * L.ldc + c);
        }
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int idx = base + q * CNT, r = idx / per;
        if (idx < total && r != rank) {
          const int m = (idx % per) / pr, c = r * hs + (idx % pr) * 8;
          *reinterpret_cast<uint4*>(hcs + m * L.ldc + c) = v[q];
        }
      }
    }
    const int pad = hr_pad - hr;
    for (int idx = threadIdx.x; idx < MP * pad; idx += CNT)
      hcs[(idx / pad) * L.ldc + hr + idx % pad] = from_f<__nv_bfloat16>(0.f);
  }
  consumers_sync();
  cluster_arrive();  // done reading the other members' shared memory

  // ---- stage 2 ----
  // warp (cg2, tg2) = warp / TG2, warp % TG2: CW output columns of a pass
  // from cg2 CW, token tiles tg2 TPW2 ..
  constexpr int TG2 = NT8 >= 2 ? 2 : 1, TPW2 = NT8 / TG2;
  constexpr int CW = SB_OT * TG2 / SB_NW, CT = CW / 16;
  const int tg2 = warp % TG2, cw0 = (warp / TG2) * CW;
  const int tstride = (DS + SB_OT - 1) / SB_OT;  // tickets of a member
  float yacc[CT][TPW2][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int j = 0; j < TPW2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[c][j][e] = 0.f;
  auto haddr = [&](int tok, int k) { return hcs + tok * L.ldc + k; };
  unsigned long long last = 0;  // thread 0: the passes whose tile's last partial this block brought
  for (int t = 0; t < T2; ++t) {
    const int s = t % SB_ST2;
    const int p = pass_of(t), kt = t % nk2, n0 = n_lo + p * SB_OT;
    const bool mine = n0 + cw0 < n_hi;
    mbar_wait(&full2[s], (t / SB_ST2) & 1);
    if (mine) {
      const unsigned char* slot = ring2 + s * L.slot2;
#pragma unroll
      for (int kk = 0; kk < SB_KS2; kk += 16) {
        uint32_t b[TPW2][2];
        frag_b<TPW2>(b, tg2 * TPW2, kt * SB_KS2 + kk, haddr);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int col = cw0 + 16 * c;
          uint32_t a[4];
          ldsm_x4_t(a, a_sw128(slot + (col >> 6) * SB_BOX2, kk, col & 63));
#pragma unroll
          for (int j = 0; j < TPW2; ++j) mma16816(yacc[c][j], a, b[j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty2[s]);
    if (kt != nk2 - 1) continue;
    // the pass is done: its tile of Y or of this cluster's partial
    if (mine) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < TPW2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + cw0 + 16 * c + (lane >> 2) + (e >> 1) * 8;
            const int tok = (tg2 * TPW2 + j) * 8 + 2 * (lane & 3) + (e & 1);
            if (tok < M && n < n_hi) {
              if (P == 1) y[size_t(tok) * Dout + n] = from_f<__nv_bfloat16>(yacc[c][j][e]);
              else part[(size_t(cl) * M + tok) * Dout + n] = yacc[c][j][e];
            }
            yacc[c][j][e] = 0.f;
          }
    }
    if (P == 1 || y == nullptr) continue;
    // count the tile on its ticket (thread 0's fence releases the block's
    // stores, which the barrier ordered before it)
    consumers_sync();
    if (threadIdx.x == 0) {
      __threadfence();
      if ((atomicAdd(&tickets[rank * tstride + p], 1u) & 0xffffu) == unsigned(P - 1))
        last |= 1ull << p;
    }
  }
  if (P > 1 && y != nullptr) {
    // the in-launch fold: slice g is rows [g % SB_SPT M / SB_SPT, ...) of
    // tile g / SB_SPT, Y's columns from r DS + pp SB_OT for the tile (rank
    // r, pass pp); tiles past Dout get no partial, so no ticket
    unsigned int* next = tickets + SB_TICKETS;
    const int nslice = CS * tstride * SB_SPT;
    auto ncol_of = [&](int tile) {
      const int r = tile / tstride, n0 = r * DS + (tile % tstride) * SB_OT;
      return min(SB_OT, min(Dout, r * DS + DS) - n0);
    };
    auto fold_slice = [&](int g) {
      const int tile = g / SB_SPT, sl = g % SB_SPT, ncol = ncol_of(tile);
      const int n0 = (tile / tstride) * DS + (tile % tstride) * SB_OT;
      const int m0 = sl * M / SB_SPT, m1 = (sl + 1) * M / SB_SPT;
      if (ncol > 0 && m1 > m0) fold_rows(part, y, P, M, Dout, m0, m1, n0, ncol);
    };
    int nbc = 0;
    auto bcast = [&](unsigned int v) {  // thread 0's v, to every consumer thread
      volatile unsigned int* slot = note + (nbc++ & 1);
      if (threadIdx.x == 0) *slot = v;
      consumers_sync();
      return *slot;
    };
    if (fold == 2) {
      // every block resident: claim slices in turn and fold each once its
      // tile is complete, for SB_HELP_NS of waiting at most.  Thread 0
      // hands the consumers slice << 2 | (fold it) | (stop) << 1.
      const unsigned long long until = globaltimer_ns() + SB_HELP_NS;
      for (;;) {
        unsigned int v = 2u;
        if (threadIdx.x == 0) {
          const unsigned int g = atomicAdd(next, 1u);
          if (g < unsigned(nslice)) {
            unsigned int* tk = &tickets[g / SB_SPT];
            v = g << 2;
            if (ncol_of(int(g / SB_SPT)) > 0) {
              while ((ld_acquire(tk) & 0xffffu) < unsigned(P) && globaltimer_ns() < until)
                __nanosleep(256);
              if ((ld_acquire(tk) & 0xffffu) == unsigned(P)) v |= 1u;
              else  // give it back to the tile's last block, unless that one came meanwhile
                v |= (atomicOr(tk, 1u << (16 + g % SB_SPT)) & 0xffffu) == unsigned(P) ? 3u : 2u;
            }
          }
        }
        v = bcast(v);
        if (v & 1u) fold_slice(int(v >> 2));
        if (v & 2u) break;
      }
    }
    // the tiles whose last partial this block brought: their slices that no
    // helper claimed, or that one gave back.  Thread 0 hands the consumers
    // pass << 8 | slices, one tile at a time.
    for (int pp = -1;;) {
      unsigned int v = 0xffffffffu;  // none left
      if (threadIdx.x == 0)
        for (int q = pp + 1; q < npass; ++q) {
          if (!(last >> q & 1)) continue;
          const int tile = rank * tstride + q;
          unsigned int mask = ld_acquire(&tickets[tile]) >> 16;
          const unsigned int taken = *reinterpret_cast<volatile unsigned int*>(next);
          for (int sl = 0; sl < SB_SPT; ++sl)
            if (unsigned(tile * SB_SPT + sl) >= taken) mask |= 1u << sl;
          if (mask) {
            v = unsigned(q) << 8 | mask;
            break;
          }
        }
      v = bcast(v);
      if (v == 0xffffffffu) break;
      pp = int(v >> 8);
      for (int sl = 0; sl < SB_SPT; ++sl)
        if (v >> sl & 1u) fold_slice((rank * tstride + pp) * SB_SPT + sl);
    }
    // the last block out resets the workspace for the next launch
    consumers_sync();  // every thread's folds are issued
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(&tickets[SB_TICKETS + 1], 1u) == gridDim.x - 1) {
        for (int i = 0; i < CS * tstride; ++i) tickets[i] = 0u;
        *next = 0u;
        tickets[SB_TICKETS + 1] = 0u;
      }
    }
  }
  cluster_wait();  // no member leaves while another may still read its chunk
}

// The bf16 geometry: blocks of ht <= SB_HT hidden tiles; for each cluster
// size from 8 down, as many blocks as its clusters resident at once hold
// (measured at SM_MAXM rows and the widest block); the first whose blocks
// take at most SB_HT tiles each and number at least 7/8 of a grid without
// clusters (about one block per SM).  Widths no such grid covers take
// waves of the largest clusters.  Also raises the kernels' shared-memory
// limit on the device, so that no launch has to.
template <bool GATED>
cudaError_t small_plan_tma(int H, int Dout, int nsm, int optin, SmallPlan* plan) {
  for (auto k : {small_m_kernel_tma<GATED, 8>, small_m_kernel_tma<GATED, 16>,
                 small_m_kernel_tma<GATED, 32>, small_m_kernel_tma<GATED, 64>}) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
  }
  auto up = [](int a, int b) { return (a + b - 1) / b; };
  const int nt16 = up(H, 16);
  const int nb1 = up(nt16, min(SB_HT, up(nt16, nsm)));
  int widest = 0;
  for (int cs = SM_MAX_CLUSTER; cs >= 1; cs /= 2) {
    const SmallTmaSmem L(SM_MAXM, up(cs * SB_HT * 16, SB_KS) * SB_KS, GATED);
    if (L.total > size_t(optin)) continue;
    if (!widest) widest = cs;
    int ncl = 0;
    cudaError_t e = resident_clusters(small_m_kernel_tma<GATED, SM_MAXM>, cs, SB_NT, L.total,
                                      up(nt16, SB_HT * cs) * cs, &ncl);
    if (e != cudaSuccess) return e;
    const int ht = ncl > 0 ? up(nt16, ncl * cs) : SB_HT + 1;
    if (ht > SB_HT) continue;
    const int nb = up(up(nt16, ht), cs) * cs;
    if (cs > 1 && 8 * nb < 7 * nb1) continue;
    // every cluster resident at once: the grid may share the fold (mode 2)
    *plan = SmallPlan{ht, cs, nb, up(up(Dout, cs), 64) * 64, up(cs * ht * 16, SB_KS) * SB_KS,
                      nb / cs > 1 ? 2 : 0};
    return cudaSuccess;
  }
  if (!widest) return cudaErrorInvalidConfiguration;
  const int nb = up(up(nt16, SB_HT), widest) * widest;
  *plan = SmallPlan{SB_HT, widest, nb, up(up(Dout, widest), 64) * 64,
                    up(widest * SB_HT * 16, SB_KS) * SB_KS, nb / widest > 1 ? 1 : 0};
  return cudaSuccess;
}

template <bool GATED>
int launch_small_tma(const SmallPlan& p, const void* x, const void* w1, const void* wu,
                     const void* w2, void* y, void* part, void* tickets, int M, int Din, int H,
                     int Dout, int act, cudaStream_t st) {
  const bool cs_ok = p.cs == 1 || p.cs == 2 || p.cs == 4 || p.cs == SM_MAX_CLUSTER;
  const int P = p.cs > 0 ? p.nb / p.cs : 0;
  if (!(cs_ok && p.ht >= 1 && p.ht <= SB_HT && p.nb >= p.cs && p.nb % p.cs == 0 &&
        size_t(p.nb) * p.ht * 16 >= size_t(H) && p.ds % 64 == 0 && p.ds * p.cs >= Dout &&
        p.hr_pad >= p.cs * p.ht * 16 && p.hr_pad % SB_KS == 0 &&
        p.cs * ((p.ds + SB_OT - 1) / SB_OT) <= SB_TICKETS && (p.ds + SB_OT - 1) / SB_OT <= 64 &&
        p.fold >= 0 && p.fold <= 2 &&
        (p.fold != 0) == (P > 1)))
    return int(cudaErrorInvalidValue);
  if (Din % 8 || H % 8 || Dout % 8 || (P == 1 ? !y : !part) || (P > 1 && y && !tickets))
    return int(cudaErrorInvalidValue);
  for (const void* q : {x, w1, w2, GATED ? wu : w1, static_cast<const void*>(y),
                        static_cast<const void*>(part), static_cast<const void*>(tickets)})
    if (reinterpret_cast<uintptr_t>(q) & 15) return int(cudaErrorInvalidValue);
  const int mp = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
  CUtensorMap tx, tw2;
  WMaps tw1, twu;
  cudaError_t e = map_box(&tx, x, M, Din, mp, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess) e = map_weight(&tw1, w1, Din, H);
  if (e == cudaSuccess) e = map_weight(&twu, GATED ? wu : w1, Din, H);
  if (e == cudaSuccess) e = map_box(&tw2, w2, H, Dout, SB_KS2, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return int(e);
  auto kern = mp == 8    ? small_m_kernel_tma<GATED, 8>
              : mp == 16 ? small_m_kernel_tma<GATED, 16>
              : mp == 32 ? small_m_kernel_tma<GATED, 32>
                         : small_m_kernel_tma<GATED, 64>;
  const SmallTmaSmem L(mp, p.hr_pad, GATED);
  return int(launch_in_clusters(kern, p.nb, p.cs, SB_NT, L.total, st, tx, tw1, twu, tw2,
                                static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
                                static_cast<unsigned int*>(tickets), M, Din, H, Dout, p.ht, p.ds,
                                p.hr_pad, act, p.fold));
}

// The small-M form's plan for (dtype, gated, Din, H, Dout) on the current
// device.
template <bool GATED>
cudaError_t small_plan(int dtype, int H, int Dout, SmallPlan* plan) {
  int dev = 0, nsm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (dtype == BF16) return small_plan_tma<GATED>(H, Dout, nsm, optin, plan);
  if (dtype == F32) return small_plan_f32<GATED>(H, Dout, nsm, optin, plan);
  return cudaErrorInvalidValue;
}

}  // namespace

// float32: x (M, Din), w1 (Din, H), wu (Din, H) or null, w2 (H, Dout).
// direct=1: out is (M, Dout) f32 and H <= block_h.  direct=0: out is f32
// partials (ceil(H / block_h), M, Dout).  (bf16 takes repro_fused_mlp_tiled.)
extern "C" int repro_fused_mlp_fwd(const void* x, const void* w1, const void* wu, const void* w2,
                                   void* out, int M, int Din, int H, int Dout, int dtype,
                                   int gated, int act, int block_h, int direct, void* stream) {
  if (block_h <= 0 || block_h % BN || dtype != F32) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gated ? launch<float, true>(x, w1, wu, w2, out, M, Din, H, Dout, block_h, act, direct, st)
               : launch<float, false>(x, w1, wu, w2, out, M, Din, H, Dout, block_h, act, direct, st);
}

// The tiled bf16 form's geometry for hidden width H (a multiple of 8):
// geo = {nj, cs, partials, st} -- 64-wide sub-chunks per block, blocks per
// cluster, the f32 partials it leaves for queue_reduce (1: it writes Y
// itself), ring stages.  A function of H alone; the caller sizes its
// buffers from it.
extern "C" int repro_fused_mlp_tiled_geometry(int H, int* geo) {
  if (H < 8 || H % 8) return int(cudaErrorInvalidValue);
  const TiledGeometry g = tiled_geometry(H);
  const int fields[] = {g.nj, g.cs, g.partials, g.st};
  for (int i = 0; i < 4; ++i) geo[i] = fields[i];
  return 0;
}

// Clusters of the tiled bf16 form (gated or not, at hidden width H) that
// fit on the current device at once, the persistent grid's size; also
// allows the kernel its shared memory there.  Call it on a device before
// the form's first launch there.
extern "C" int repro_fused_mlp_tiled_resident(int H, int gated, int* clusters) {
  if (H < 8 || H % 8) return int(cudaErrorInvalidValue);
  const TiledGeometry g = tiled_geometry(H);
  const bool one = g.cs == 1;
  cudaError_t e = gated ? (one ? tiled_resident<true, 1>(g, clusters)
                               : tiled_resident<true, FW_CS>(g, clusters))
                        : (one ? tiled_resident<false, 1>(g, clusters)
                               : tiled_resident<false, FW_CS>(g, clusters));
  return int(e);
}

// The tiled bf16 form on TMA + wgmma: x (M, Din), w1 (Din, H), wu (Din, H)
// or null, w2 (H, Dout), every width a multiple of 8 and every pointer
// 16-byte aligned (TMA's rule).  out is Y (M, Dout) bf16 when the geometry
// leaves one partial, else f32 partials (partials, M, Dout).  clusters is
// repro_fused_mlp_tiled_resident's count for these widths on this device.
extern "C" int repro_fused_mlp_tiled(const void* x, const void* w1, const void* wu,
                                     const void* w2, void* out, int M, int Din, int H, int Dout,
                                     int gated, int act, int clusters, void* stream) {
  if (M < 1 || Din < 8 || H < 8 || Dout < 8 || Din % 8 || H % 8 || Dout % 8 || clusters < 1)
    return int(cudaErrorInvalidValue);
  for (const void* p : {x, w1, w2, gated ? wu : w1})
    if (reinterpret_cast<uintptr_t>(p) & 15) return int(cudaErrorInvalidValue);
  CUtensorMap tx, twg, twu, tw2;
  cudaError_t e = map64(&tx, x, M, Din);
  if (e == cudaSuccess) e = map64(&twg, w1, Din, H);
  if (e == cudaSuccess) e = map64(&twu, gated ? wu : w1, Din, H);
  if (e == cudaSuccess) e = map64(&tw2, w2, H, Dout);
  if (e != cudaSuccess) return int(e);
  const TiledGeometry g = tiled_geometry(H);
  const FwdArgs a{M, Din, H, Dout, act, g.nj, g.partials, g.st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gated ? launch_tiled<true>(tx, twg, twu, tw2, out, g, a, clusters, st)
               : launch_tiled<false>(tx, twg, twu, tw2, out, g, a, clusters, st);
}

// n: the ints of the small-M form's fold workspace (repro_fused_mlp_small's
// tickets).
extern "C" int repro_fused_mlp_small_tickets(int* n) {
  *n = SB_TICKETS + 2;
  return 0;
}

// Small-M form: its launch geometry for (Din, H, Dout) on the current
// device, plan = {ht, cs, nb, ds, hr_pad, fold}; it leaves nb / cs f32
// partials (1: it writes Y directly), which the launch folds into Y itself
// where fold is 1 (bf16).  Call it on a device before the form's first
// launch there: it also sets the form's shared-memory limit.
extern "C" int repro_fused_mlp_small_plan(int Din, int H, int Dout, int dtype, int gated,
                                          int* plan) {
  SmallPlan p;
  const cudaError_t e = gated ? small_plan<true>(dtype, H, Dout, &p)
                              : small_plan<false>(dtype, H, Dout, &p);
  if (e != cudaSuccess) return int(e);
  const int fields[] = {p.ht, p.cs, p.nb, p.ds, p.hr_pad, p.fold};
  for (int i = 0; i < 6; ++i) plan[i] = fields[i];
  return 0;
}

// x (M, Din) with 1 <= M <= 64, weights as repro_fused_mlp_fwd's, plan as
// repro_fused_mlp_small_plan gave it for these widths.  y: Y (M, Dout) in
// the operands' dtype, or null; part: f32 partials (nb / cs, M, Dout) where
// the plan leaves more than one, else null.  float32 writes one of the two
// (queue_reduce folds the partials); bf16 (every width a multiple of 8,
// every pointer 16-byte aligned, as TMA reads them) given both folds its
// partials into y itself, given part alone leaves them.  tickets: the
// fold's workspace (bf16 given both), repro_fused_mlp_small_tickets()
// ints, zero before the launch and left zero by it; launches that may run
// at once need workspaces of their own (the caller keeps one per stream).
extern "C" int repro_fused_mlp_small(const void* x, const void* w1, const void* wu,
                                     const void* w2, void* y, void* part, int M, int Din, int H,
                                     int Dout, int dtype, int gated, int act, const int* plan,
                                     void* tickets, void* stream) {
  if (M < 1 || M > SM_MAXM) return int(cudaErrorInvalidValue);
  const SmallPlan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return gated ? launch_small_tma<true>(p, x, w1, wu, w2, y, part, tickets, M, Din, H, Dout,
                                          act, st)
                 : launch_small_tma<false>(p, x, w1, wu, w2, y, part, tickets, M, Din, H, Dout,
                                           act, st);
  void* out = p.cs > 0 && p.nb == p.cs ? y : part;
  if (dtype != F32 || !out) return int(cudaErrorInvalidValue);
  return gated ? launch_small_f32<true>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st)
               : launch_small_f32<false>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st);
}
