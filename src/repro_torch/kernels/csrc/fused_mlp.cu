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
// Small-M form, small_m_kernel (decode): at M = 8 the weights are all the
// bytes -- 550 MB at phi3-medium-14b's 5120 -> 17920 -> 5120, 0.164 ms at the
// H100's 3.35 TB/s -- and a 128-row tile would spend 15/16 of its products on
// padding rows.  So the product is swapped, Y^T = W^T X^T: every 16 x 16
// weight tile is mma.sync m16n8k16's A operand (ldmatrix.trans from a k-major
// shared tile) and the token rows are its 8-wide N (MP = M rounded up to 8,
// 16, 32 or 64). Blocks of up to 9 16-column hidden tiles, about one per SM,
// stream W1 (and Wu) with X through a 4-stage cp.async ring of 64-row steps
// (~120 KB in flight per SM at M = 8), every weight byte read once.  A cluster
// of CS blocks owns a contiguous hidden range: each builds act(g) * u for its
// own columns (rounded to the input dtype), the members copy each other's
// chunks over distributed shared memory in rank order, and member r then
// multiplies the cluster's whole chunk into its Dout / CS columns of W2 (whose
// first tiles load during the exchange).  One f32 partial of Y per cluster,
// (n_clusters, M, Dout), goes to queue_reduce: at phi3's decode shape 4 *
// n_clusters * M * Dout bytes written and read once more (clusters of 2, 63
// partials: 10.3 MB), against the 5.7 MB of 35 tiled partials before and the
// 550 MB of weights.  The launch geometry (blocks, cluster size) is a function
// of the widths and the card, never of M, and each output element is one chain
// of products in k order, so a row's result does not depend on M or on the
// other rows (solo == batched serving). float32 takes the same structure with
// an FMA loop in place of mma (the reduced engines check against the CPU at
// 2e-4, which TF32 would miss).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3;
// PERF.md): 0.227 ms with its fold at (8, 5120 -> 17920 -> 5120)
// bf16, against the 0.164 ms byte bound and 0.217 ms for cuBLAS's unfused
// chain, and below the tiled form's ~0.86 ms at every M it takes (1..64).
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

constexpr int SM_NW = 8, SM_NT = SM_NW * 32;
constexpr int SM_HT = 9;              // at most 9 16-column hidden tiles per block
constexpr int SM_HS = SM_HT * 16;     // hidden columns a block's staging tile spans
constexpr int SM_OT = 128;            // output columns per stage-2 pass
constexpr int SM_MAXM = 64;           // rows the form takes (8 token tiles of 8)
constexpr int SM_MAX_CLUSTER = 8;     // the portable cluster size
// k rows per ring stage (both stages) and ring depth: bf16 takes deep
// stages (fewer barriers per byte), f32's twice-as-wide tiles fit 32 x 3
template <typename T> constexpr int kSmKS = sizeof(T) == 2 ? 64 : 32;
template <typename T> constexpr int kSmStages = sizeof(T) == 2 ? 4 : 3;

// Shared memory of a small-M block for MP token rows and a cluster hidden
// range padded to hr_pad columns: the block's own hidden chunk (read by the
// whole cluster), then the stage-1 ring (W1 [+ Wu] tile of KS x SM_HS and
// an X tile of MP x KS per slot, KS = kSmKS<T>) aliased, once it drained,
// by the cluster's hidden chunk (MP x hr_pad) and the stage-2 ring (W2
// tiles of KS x SM_OT).  Pitches keep 16-byte rows whose 16-byte index is
// odd, so ldmatrix's eight row reads hit eight distinct bank groups.
template <typename T>
struct SmallSmem {
  int ldw, ldx, ldh, ldc, ldo;  // elements
  size_t own, wt, xt, slot1, ring1, hc, slot2, total;  // bytes
  __host__ __device__ SmallSmem(int mp, int hr_pad, bool gated) {
    constexpr int P = Pad<T>::v;
    ldw = SM_HS + P;
    ldx = kSmKS<T> + P;
    ldh = SM_HS + P;
    ldc = hr_pad + P;
    ldo = SM_OT + P;
    own = align128(size_t(mp) * ldh * sizeof(T));
    wt = align128(size_t(kSmKS<T>) * ldw * sizeof(T));
    xt = align128(size_t(mp) * ldx * sizeof(T));
    slot1 = (gated ? 2 : 1) * wt + xt;
    ring1 = kSmStages<T> * slot1;
    hc = align128(size_t(mp) * ldc * sizeof(T));
    slot2 = align128(size_t(kSmKS<T>) * ldo * sizeof(T));
    const size_t s2 = hc + kSmStages<T> * slot2;
    total = own + (ring1 > s2 ? ring1 : s2);
  }
};

// Four 8x8 b16 matrices, transposed on the way into registers: with the
// lanes' row addresses set as in `frag_a`, mma.sync m16n8k16's A fragment
// of a 16 x 16 tile stored k-major (its rows are k).
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment of A[i][j] = S[j][c0 + i] (i < 16 output rows, j < 16 k rows)
// from a k-major tile S with pitch ld: lane l addresses k row
// (l / 16) * 8 + l % 8 at column c0 + ((l / 8) % 2) * 8.
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* S, int ld, int c0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, S + ((l >> 4) * 8 + (l & 7)) * ld + c0 + ((l >> 3) & 1) * 8);
}

// B fragment of B[j][n] = R[n][j] (16 k rows, 8 token columns) from a
// row-major activation R (token rows, k contiguous) with pitch ld.
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* R, int ld) {
  const int l = threadIdx.x & 31;
  const __nv_bfloat16* p = R + (l >> 2) * ld + 2 * (l & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// d (16 x 8 f32) += A (16 x 16 bf16) B (16 x 8 bf16)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
//   Stage 1: the block's hidden chunk transposed, g^T = W1[:, chunk]^T X^T
//     (and u^T), streamed over Din through the ring: each 16 x 16 weight
//     tile is mma.sync's A operand and the token rows are its 8-wide N, so
//     no product runs on a padding row of a 128-row tile.  act(g) * u is
//     rounded to T into the block's own chunk.
//   Exchange: after a cluster barrier every member copies all members'
//     chunks (distributed shared memory, rank order) into the cluster's
//     hidden chunk, MP x hr.
//   Stage 2: member r owns output columns [r DS, r DS + DS): Y^T = W2[hr
//     rows, its columns]^T t^T over the cluster's hidden range, SM_OT
//     columns a pass, every pass's tiles in one continuous ring.  Its W2
//     tiles start loading before the exchange.
// out: direct, Y in T; else f32 partials (gridDim.x / CS, M, Dout), one
// per cluster.  Every output element is one chain of products in k order
// (mma accumulates in place; the f32 form is an FMA loop), fixed by
// (Din, H, Dout, HT, CS) alone, so a row's result does not depend on M or
// on the other rows.
template <typename T, bool GATED, int MP>
__global__ void __launch_bounds__(SM_NT, 1)
small_m_kernel(const T* __restrict__ X, const T* __restrict__ W1, const T* __restrict__ WU,
               const T* __restrict__ W2, void* __restrict__ out, int M, int Din, int H, int Dout,
               int HT, int DS, int hr_pad, int act, int direct) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const SmallSmem<T> L(MP, hr_pad, GATED);
  T* own = reinterpret_cast<T*>(smem);
  unsigned char* ring1 = smem + L.own;
  T* hcs = reinterpret_cast<T*>(smem + L.own);
  unsigned char* ring2 = smem + L.own + L.hc;
  constexpr int STG = kSmStages<T>, KS = kSmKS<T>;
  constexpr int NT8 = MP / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hs = HT * 16, h0 = blockIdx.x * hs, hend = min(H, h0 + hs);
  const int cl = blockIdx.x / CS, hr = CS * hs, hc0 = cl * hr, hc_end = min(H, hc0 + hr);
  const bool vx = vec_ok(X, Din), vw = vec_ok(W1, H) && (!GATED || vec_ok(WU, H));
  const bool v2 = vec_ok(W2, Dout);

  // ---- stage 1 ----
  auto W1s = [&](int s) { return reinterpret_cast<T*>(ring1 + s * L.slot1); };
  auto WUs = [&](int s) { return reinterpret_cast<T*>(ring1 + s * L.slot1 + L.wt); };
  auto Xs = [&](int s) {
    return reinterpret_cast<T*>(ring1 + s * L.slot1 + (GATED ? 2 : 1) * L.wt);
  };
  const int nk = (Din + KS - 1) / KS;
  auto stage1 = [&](int t, int s) {
    const int k0 = t * KS;
    load_tile<T, KS, SM_HS, SM_NT>(W1s(s), L.ldw, W1, H, k0, h0, Din, hend, vw);
    if constexpr (GATED)
      load_tile<T, KS, SM_HS, SM_NT>(WUs(s), L.ldw, WU, H, k0, h0, Din, hend, vw);
    load_tile<T, MP, KS, SM_NT>(Xs(s), L.ldx, X, Din, 0, k0, M, Din, vx);
  };
  ring_prologue<STG>(nk, stage1);
  if constexpr (sizeof(T) == 2) {
    // warp w: hidden tiles w and w + 8 (< HT), every token tile
    float g[2][NT8][4], u[2][NT8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[i][n][e] = u[i][n][e] = 0.f;
    ring_run<STG>(nk, stage1, [&](int, int s) {
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        uint32_t b[NT8][2];
#pragma unroll
        for (int n = 0; n < NT8; ++n) frag_b(b[n], Xs(s) + n * 8 * L.ldx + kk, L.ldx);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ht = warp + 8 * i;
          if (ht < HT) {
            uint32_t a[4];
            frag_a(a, W1s(s) + kk * L.ldw, L.ldw, ht * 16);
#pragma unroll
            for (int n = 0; n < NT8; ++n) mma16816(g[i][n], a, b[n]);
            if constexpr (GATED) {
              frag_a(a, WUs(s) + kk * L.ldw, L.ldw, ht * 16);
#pragma unroll
              for (int n = 0; n < NT8; ++n) mma16816(u[i][n], a, b[n]);
            }
          }
        }
      }
    });
    // element e of a 16 x 8 accumulator: hidden row lane / 4 (+8 for e >= 2),
    // token 2 (lane % 4) + (e & 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ht = warp + 8 * i;
      if (ht < HT) {
#pragma unroll
        for (int n = 0; n < NT8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hrow = ht * 16 + (lane >> 2) + (e >> 1) * 8;
            const int tok = n * 8 + 2 * (lane & 3) + (e & 1);
            const float a = act_apply(act, g[i][n][e]);
            own[tok * L.ldh + hrow] = from_f<T>(GATED ? a * u[i][n][e] : a);
          }
      }
    }
  } else {
    // f32: FMA, thread (tc, tm) owns hidden columns tc + 16 i and tokens tm + 16 j
    constexpr int MJ = MP >= 16 ? MP / 16 : 1;
    const int tc = threadIdx.x & 15, tm = threadIdx.x >> 4;
    float g[SM_HT][MJ], u[SM_HT][MJ];
#pragma unroll
    for (int i = 0; i < SM_HT; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) g[i][j] = u[i][j] = 0.f;
    ring_run<STG>(nk, stage1, [&](int, int s) {
      if (tm >= MP) return;
      const T* w = W1s(s);
      const T* wu = WUs(s);
      const T* xs = Xs(s);
      for (int k = 0; k < KS; ++k) {
        float xv[MJ];
#pragma unroll
        for (int j = 0; j < MJ; ++j) xv[j] = to_f(xs[(tm + 16 * j) * L.ldx + k]);
#pragma unroll
        for (int i = 0; i < SM_HT; ++i) {
          const float wv = to_f(w[k * L.ldw + tc + 16 * i]);
#pragma unroll
          for (int j = 0; j < MJ; ++j) g[i][j] = fmaf(wv, xv[j], g[i][j]);
          if constexpr (GATED) {
            const float uv = to_f(wu[k * L.ldw + tc + 16 * i]);
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
          own[(tm + 16 * j) * L.ldh + tc + 16 * i] = from_f<T>(GATED ? a * u[i][j] : a);
        }
    }
  }
  __syncthreads();  // own chunk written; ring 1 drained

  // ---- stage 2: first tiles in flight, then the exchange ----
  const int n_lo = rank * DS, n_hi = min(Dout, n_lo + DS);
  const int npass = n_hi > n_lo ? (n_hi - n_lo + SM_OT - 1) / SM_OT : 0;
  const int nk2 = (hc_end - hc0 + KS - 1) / KS;
  auto W2s = [&](int s) { return reinterpret_cast<T*>(ring2 + s * L.slot2); };
  auto stage2 = [&](int t, int s) {
    const int p = t / nk2, kt = t % nk2;
    load_tile<T, KS, SM_OT, SM_NT>(W2s(s), L.ldo, W2, Dout, hc0 + kt * KS,
                                      n_lo + p * SM_OT, hc_end, n_hi, v2);
  };
  ring_prologue<STG>(npass * nk2, stage2);
  cluster.sync();  // every member's own chunk is written
  {
    constexpr int V = 16 / sizeof(T);  // elements per 16-byte piece
    const int pr = hs / V;             // pieces per member row (hs % 16 == 0)
    for (int r = 0; r < CS; ++r) {
      const T* src = cluster.map_shared_rank(own, r);
      for (int idx = threadIdx.x; idx < MP * pr; idx += SM_NT) {
        const int m = idx / pr, c = (idx % pr) * V;
        *reinterpret_cast<uint4*>(hcs + m * L.ldc + r * hs + c) =
            *reinterpret_cast<const uint4*>(src + m * L.ldh + c);
      }
    }
    for (int idx = threadIdx.x; idx < MP * (hr_pad - hr); idx += SM_NT)
      hcs[(idx / (hr_pad - hr)) * L.ldc + hr + idx % (hr_pad - hr)] = from_f<T>(0.f);
  }
  __syncthreads();

  T* outd = reinterpret_cast<T*>(out);
  float* outp = reinterpret_cast<float*>(out) + size_t(cl) * M * Dout;
  auto put = [&](int m, int n, float v) {
    if (m < M && n < n_hi) {
      if (direct) outd[size_t(m) * Dout + n] = from_f<T>(v);
      else outp[size_t(m) * Dout + n] = v;
    }
  };
  if constexpr (sizeof(T) == 2) {
    // warp w: output columns w * 16 .. + 15 of each pass, every token tile
    float y[NT8][4];
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[n][e] = 0.f;
    ring_run<STG>(npass * nk2, stage2, [&](int t, int s) {
      const int p = t / nk2, kt = t % nk2;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        uint32_t a[4];
        frag_a(a, W2s(s) + kk * L.ldo, L.ldo, warp * 16);
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          uint32_t b[2];
          frag_b(b, hcs + n * 8 * L.ldc + kt * KS + kk, L.ldc);
          mma16816(y[n], a, b);
        }
      }
      if (kt == nk2 - 1) {
        const int n0 = n_lo + p * SM_OT + warp * 16 + (lane >> 2);
#pragma unroll
        for (int n = 0; n < NT8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            put(n * 8 + 2 * (lane & 3) + (e & 1), n0 + (e >> 1) * 8, y[n][e]);
            y[n][e] = 0.f;
          }
      }
    });
  } else {
    constexpr int MJ = MP >= 16 ? MP / 16 : 1;
    constexpr int OI = SM_OT / 16;
    const int tc = threadIdx.x & 15, tm = threadIdx.x >> 4;
    float y[OI][MJ];
#pragma unroll
    for (int i = 0; i < OI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) y[i][j] = 0.f;
    ring_run<STG>(npass * nk2, stage2, [&](int t, int s) {
      if (tm >= MP) return;
      const int p = t / nk2, kt = t % nk2;
      const T* w = W2s(s);
      for (int k = 0; k < KS; ++k) {
        float hv[MJ];
#pragma unroll
        for (int j = 0; j < MJ; ++j) hv[j] = to_f(hcs[(tm + 16 * j) * L.ldc + kt * KS + k]);
#pragma unroll
        for (int i = 0; i < OI; ++i) {
          const float wv = to_f(w[k * L.ldo + tc + 16 * i]);
#pragma unroll
          for (int j = 0; j < MJ; ++j) y[i][j] = fmaf(wv, hv[j], y[i][j]);
        }
      }
      if (kt == nk2 - 1) {
#pragma unroll
        for (int i = 0; i < OI; ++i)
#pragma unroll
          for (int j = 0; j < MJ; ++j) {
            put(tm + 16 * j, n_lo + p * SM_OT + tc + 16 * i, y[i][j]);
            y[i][j] = 0.f;
          }
      }
    });
  }
  cluster.sync();  // no member leaves while another may still read its chunk
}

// The launch geometry of the small-M form for one (dtype, gated, Din, H,
// Dout) on the current device -- never a function of M.  The caller keeps
// it and hands it back with every launch.
struct SmallPlan {
  int ht, cs, nb, ds, hr_pad;
};

// Lets every row-count instantiation of the form use up to `bytes` of
// dynamic shared memory on the current device.
template <typename T, bool GATED>
cudaError_t small_allow(int bytes) {
  const void* kerns[] = {reinterpret_cast<const void*>(small_m_kernel<T, GATED, 8>),
                         reinterpret_cast<const void*>(small_m_kernel<T, GATED, 16>),
                         reinterpret_cast<const void*>(small_m_kernel<T, GATED, 32>),
                         reinterpret_cast<const void*>(small_m_kernel<T, GATED, 64>)};
  for (const void* k : kerns) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Blocks of HT <= SM_HT hidden tiles, about one per SM; the largest cluster
// (8, 4, 2 or 1 blocks) whose shared memory fits at SM_MAXM rows and whose
// clusters can all be resident at once (or fill the card's SMs, when the
// blocks outnumber them).  Also raises the form's shared-memory limit on
// the device to the most a block may opt into, so that no launch has to.
template <typename T, bool GATED>
cudaError_t small_plan(int Din, int H, int Dout, SmallPlan* plan) {
  int dev = 0, nsm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = small_allow<T, GATED>(optin);
  if (e != cudaSuccess) return e;
  const int nt16 = (H + 15) / 16;
  const int ht = min(SM_HT, (nt16 + nsm - 1) / nsm);
  const int nb0 = (nt16 + ht - 1) / ht;
  for (int cs = SM_MAX_CLUSTER; cs >= 1; cs /= 2) {
    const int nb = (nb0 + cs - 1) / cs * cs;
    const int hr = cs * ht * 16, hr_pad = (hr + kSmKS<T> - 1) / kSmKS<T> * kSmKS<T>;
    const SmallSmem<T> L(SM_MAXM, hr_pad, GATED);
    if (L.total > size_t(optin)) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb);
    cfg.blockDim = dim3(SM_NT);
    cfg.dynamicSmemBytes = L.total;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int nclusters = 0;
    auto kern = small_m_kernel<T, GATED, SM_MAXM>;
    e = cudaOccupancyMaxActiveClusters(&nclusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    const int resident = nclusters * cs;
    if (cs > 1 && resident < nb && resident < nsm) continue;
    *plan = SmallPlan{ht, cs, nb, ((Dout + cs - 1) / cs + 15) / 16 * 16, hr_pad};
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

// Whether p is a geometry small_plan could have given for (Din, H, Dout):
// whole clusters that cover H and Dout with a padded hidden range of whole
// k-steps.  A launch checks it, since the kernel trusts its plan.
template <typename T>
bool small_plan_covers(const SmallPlan& p, int H, int Dout) {
  const bool cs_ok = p.cs == 1 || p.cs == 2 || p.cs == 4 || p.cs == SM_MAX_CLUSTER;
  return cs_ok && p.ht >= 1 && p.ht <= SM_HT && p.nb >= p.cs && p.nb % p.cs == 0 &&
         size_t(p.nb) * p.ht * 16 >= size_t(H) && p.ds % 16 == 0 && p.ds * p.cs >= Dout &&
         p.hr_pad >= p.cs * p.ht * 16 && p.hr_pad % kSmKS<T> == 0;
}

template <typename T, bool GATED, int MP>
int launch_small_mp(const SmallPlan& p, const void* x, const void* w1, const void* wu,
                    const void* w2, void* out, int M, int Din, int H, int Dout, int act,
                    cudaStream_t st) {
  const SmallSmem<T> L(MP, p.hr_pad, GATED);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nb);
  cfg.blockDim = dim3(SM_NT);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int direct = p.nb == p.cs;
  auto kern = small_m_kernel<T, GATED, MP>;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                                     static_cast<const T*>(w1), static_cast<const T*>(wu),
                                     static_cast<const T*>(w2), out, M, Din, H, Dout, p.ht, p.ds,
                                     p.hr_pad, act, direct);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <typename T, bool GATED>
int launch_small(const SmallPlan& p, const void* x, const void* w1, const void* wu,
                 const void* w2, void* out, int M, int Din, int H, int Dout, int act,
                 cudaStream_t st) {
  if (!small_plan_covers<T>(p, H, Dout)) return int(cudaErrorInvalidValue);
  if (M <= 8) return launch_small_mp<T, GATED, 8>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st);
  if (M <= 16) return launch_small_mp<T, GATED, 16>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st);
  if (M <= 32) return launch_small_mp<T, GATED, 32>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st);
  return launch_small_mp<T, GATED, 64>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st);
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

// Small-M form: its launch geometry for (Din, H, Dout) on the current
// device, plan = {ht, cs, nb, ds, hr_pad}; it leaves nb / cs f32 partials
// (1: it writes Y directly).  Call it on a device before the form's first
// launch there: it also sets the form's shared-memory limit.
extern "C" int repro_fused_mlp_small_plan(int Din, int H, int Dout, int dtype, int gated,
                                          int* plan) {
  SmallPlan p;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == BF16)
    e = gated ? small_plan<__nv_bfloat16, true>(Din, H, Dout, &p)
              : small_plan<__nv_bfloat16, false>(Din, H, Dout, &p);
  else if (dtype == F32)
    e = gated ? small_plan<float, true>(Din, H, Dout, &p)
              : small_plan<float, false>(Din, H, Dout, &p);
  if (e != cudaSuccess) return int(e);
  const int fields[] = {p.ht, p.cs, p.nb, p.ds, p.hr_pad};
  for (int i = 0; i < 5; ++i) plan[i] = fields[i];
  return 0;
}

// x (M, Din) with 1 <= M <= 64, weights as repro_fused_mlp_fwd's, plan as
// repro_fused_mlp_small_plan gave it for these widths; out is Y (M, Dout)
// in the operands' dtype when the plan leaves one partial, else f32
// partials (nb / cs, M, Dout).
extern "C" int repro_fused_mlp_small(const void* x, const void* w1, const void* wu,
                                     const void* w2, void* out, int M, int Din, int H, int Dout,
                                     int dtype, int gated, int act, const int* plan,
                                     void* stream) {
  if (M < 1 || M > SM_MAXM) return int(cudaErrorInvalidValue);
  const SmallPlan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return gated ? launch_small<__nv_bfloat16, true>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st)
                 : launch_small<__nv_bfloat16, false>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st);
  if (dtype == F32)
    return gated ? launch_small<float, true>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st)
                 : launch_small<float, false>(p, x, w1, wu, w2, out, M, Din, H, Dout, act, st);
  return int(cudaErrorInvalidValue);
}
