// Flash-attention backward for Hopper (sm_90a) in float32: float32 in,
// float32 gradients out, float32 accuracy from 3xTF32 products on the
// tensor cores.
//
// Replaces: slamkit_tpu/ops/flash_attention.py::_bwd_kernel (launched by
// _bwd_call through _bwd, the backward rule of the _flash custom VJP) where
// it is given float32 inputs: the Pallas kernel runs in its inputs' dtype,
// and the JAX package trains in float32 whenever
// model.config_args.torch_dtype=float32. Same result as the bf16 kernel
// (flash_bwd.cu): with P = exp(scale * Q K^T - LSE) under the forward's
// masks (causal q_pos >= k_pos, equal segment ids with pads, id < 0, seeing
// other pads, keys at or past T masked; a dead row's LSE of +1e30 gives
// P = 0 exactly),
//   dV = P^T dO,   dS = P o (dO V^T - delta) * scale,   dK = dS^T Q,   dQ = dS K,
// with delta = rowsum(dO o O) of the external O. q heads are kv-major (head h
// reads kv head h / G); dK and dV sum over the G heads of a kv group.
//
// What bounds it on the H100: the visible pairs' 10 D FLOPs (S, dP, dV, dK,
// dQ) in float32: 67 TFLOP/s on the CUDA cores, 165 TFLOP/s of float32 work
// as 3xTF32 on the tensor cores (495 TFLOP/s of TF32, three products each).
// At the Slam shape ([8, 14/2, 1024, 64], 8 packed segments) that is ~0.05
// ms against ~0.013 ms of bytes (q, k, v, O, dO, LSE read; dq, dk, dv
// written): operations bound it. What held the CUDA-core version back
// (tools/cta_clocks.py on an H100, before the redesign) was its fill as
// much as its rate: one CTA per (key tile, kv head, batch row) walked all G
// heads of the group, 96 CTAs on 132 SMs at DPO's [16, 14/2, 152, 64], each
// ~310k cycles of tiles in sequence, and every tile waited on its loads.
// What the design does:
//   * three launches, no atomics, so dQ, dK and dV are bitwise deterministic
//     (a float32 resume repeats a step exactly):
//       - prep: delta = rowsum(dO o O) in float32, D / 4 lanes a row with
//         one float4 each and a fixed shuffle tree;
//       - dkdv: the G q heads of a kv group are split over the C CTAs of a
//         thread-block cluster (C the largest divisor of G up to 8; rank r
//         walks heads r G / C .. (r + 1) G / C - 1 in order, each head's
//         listed q tiles in order), one CTA of 4 warps per (64-key tile,
//         rank, kv head, batch row): 672 CTAs at DPO's shape, 1792 at the
//         Slam batch. A warp owns 16 keys and keeps their dK and dV in
//         registers; at the end each CTA sends its rows through distributed
//         shared memory to the cluster CTA that owns them, and every owner
//         sums its rows' C parts in rank order, so the sum is the same on
//         every run;
//       - dq: one CTA of 4 warps per (64-row q tile, q head, batch row), over
//         the listed k tiles, a warp's 16 rows of dQ in registers;
//   * products on the tensor cores in 3xTF32 (hopper.cuh: mma.sync m16n8k8,
//     each float32 operand split into TF32 hi and lo parts as its fragment
//     is read, lo_a hi_b + hi_a lo_b + hi_a hi_b accumulated in float32),
//     ~2^-22 of each product lost where one TF32 product loses ~2^-11;
//     tests/test_torch_tf32_split.py emulates both on the CPU. P and dS are
//     split as float32 and go from the S^T / dP^T (S / dP) accumulators
//     straight into the A fragments of the gradient products, the k order of
//     a step permuted to the accumulator's (f32_tiles.cuh);
//   * the tensor cores add each product to their float32 accumulator
//     without rounding to nearest, a bias that grows with the number of adds,
//     and dK, dV (dQ) sum over every visited tile and head: each tile's
//     gradient product starts from zero and is added to them in float32;
//   * loads through 2-stage cp.async rings of [rows][D + 4] tiles (the pad
//     spreads every fragment read over the 32 banks): Q, dO, LSE, delta and
//     the q ids in the dK/dV pass, K, V and the k ids in the dQ pass, the
//     next tile loading while this one multiplies;
//   * each CTA lists the tiles it must visit before loading any, all four
//     warps at once from one coalesced read of the ids (issued before the
//     tile copies, so it does not queue behind them): under causality only
//     tiles on the seen side of the diagonal, with segment ids only tiles
//     whose ids meet (hopper.cuh's ranges, pads kept apart), each marked
//     interior when it needs no mask;
//   * P on the SFU (ex2.approx in the base-2 domain, ~2^-22 relative).
// At d = 128 the dK/dV pass takes q tiles of 32 rows, so that dK, dV, S^T
// and dP^T fit one thread's registers. Shared memory: 106 KB (dkdv) and 105
// KB (dq) at d = 64, 136 KB and 203 KB at d = 128.
// Left for later work: a warp of the dQ and dK/dV passes owns 16 rows, so
// each fragment it splits serves one product (the forward's 32-row warps
// halve that), and the cluster sum waits for the slowest CTA of the cluster
// (~10k cycles a CTA at the Slam and DPO shapes on an H100).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <stdint.h>

#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;
using namespace f32_tiles;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  const int* q_seg;
  const int* k_seg;
  float* dq;
  float* dk;
  float* dv;
  int H, Hkv, T, causal, walk;
  float scale;
};

// ------------------------------------------------------------------ prep --

// delta[row] = sum_d dO[row, d] O[row, d] over the B*H*T rows
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_f32_prep_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                          float* __restrict__ delta, int rows) {
  constexpr int kLanes = D / 4, kRowsPerBlock = 256 / kLanes;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  float acc = 0.f;
  if (row < rows) {
    const float4 a = *reinterpret_cast<const float4*>(out + (size_t)row * D + 4 * l);
    const float4 b = *reinterpret_cast<const float4*>(dout + (size_t)row * D + 4 * l);
    acc = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && l == 0) delta[row] = acc;
}

// The two products of a pass that share their A rows: c1 += A1 B1 and
// c2 += A2 B2 over D (A: 16 rows of a [.][D + 4] tile; B: N tiles of 8 of
// a tile whose rows are the products' n), all in 3xTF32
template <int D, int N>
__device__ __forceinline__ void two_products_nrows(float (&c1)[N][4], float (&c2)[N][4],
                                                   const float* a1, const float* a2, int ar,
                                                   const float* b1, const float* b2, int g,
                                                   int t4) {
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      float x[4];
      uint32_t a_hi[4], a_lo[4], b_hi[N][2], b_lo[N][2];
      frag_a<D>(x, which ? a2 : a1, ar, 8 * kk, g, t4);
      split_tf32(x, a_hi, a_lo);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float y[2];
        frag_b_nrows<D>(y, which ? b2 : b1, 8 * kk, 8 * n, g, t4);
        split_tf32(y, b_hi[n], b_lo[n]);
      }
      mma_3xtf32(which ? c2 : c1, a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// acc[D / 8] += P (16 x 8 J, from accumulators) B (8 J rows of a [.][D + 4]
// tile), 3xTF32. The tensor cores add a product to their accumulator without
// rounding to nearest, a bias that grows with the adds, so this tile's
// product starts from zero, 32 columns at a time, and is added to acc in
// float32: acc sums over every visited tile (and head)
template <int D, int J>
__device__ __forceinline__ void product_from_acc(float (&acc)[D / 8][4], const float (&p)[J][4],
                                                 const float* bt, int g, int t4) {
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    float part[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float x[4];
      uint32_t a_hi[4], a_lo[4], b_hi[4][2], b_lo[4][2];
      frag_a_from_acc(x, p[j]);
      split_tf32(x, a_hi, a_lo);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float y[2];
        frag_b_krows<D>(y, bt, 8 * j, 32 * c + 8 * n, g, t4);
        split_tf32(y, b_hi[n], b_lo[n]);
      }
      mma_3xtf32(part, a_hi, a_lo, b_hi, b_lo);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * c + n][e] += part[n][e];
    }
  }
}

// ------------------------------------------------------------------ dkdv --

// Shared memory in floats: K, V [64][D + 4] and the keys' ids [64];
// kStages x (Q, dO [BQ][D + 4], LSE, delta, q ids [BQ]); the list's length;
// flags and list (n_q each). After the loop the cluster's gather,
// [C][ceil(128 / C)][D + 4], reuses the front.
template <int D, int BQ>
struct KvSmem {
  static constexpr int kTileKV = kTile * Ld<D>::value, kTileQ = BQ * Ld<D>::value;
  static constexpr int kK = 0, kV = kTileKV, kKseg = 2 * kTileKV;
  static constexpr int kStage = kKseg + kTile;
  static constexpr int kStageF = 2 * kTileQ + 3 * BQ;
  static constexpr int kCount = kStage + kStages * kStageF, kFlags = kCount + 4;
  static constexpr int kGatherF = (2 * kTile + kMaxCluster) * Ld<D>::value;
  static_assert(kGatherF <= kCount, "the gather must fit the tiles");
  static size_t bytes(int T) { return 4 * ((size_t)kFlags + 2 * ((T + BQ - 1) / BQ)); }
};

// One CTA per (64-key tile, rank, kv head, batch row); the grid's x is Hkv * C
// in clusters of C, the CTA of rank r walking heads hk G + r walk + [0, walk).
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dkdv_kernel(const BwdArgs a) {
  using L = KvSmem<D, BQ>;
  constexpr int NC = D / 8, NQ = BQ / 8;
  extern __shared__ float smem[];
  float* Ks = smem + L::kK;
  float* Vs = smem + L::kV;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kKseg);
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  auto Qs = [&](int st) { return smem + L::kStage + st * L::kStageF; };
  auto dOs = [&](int st) { return Qs(st) + L::kTileQ; };
  auto lses = [&](int st) { return Qs(st) + 2 * L::kTileQ; };
  auto deltas = [&](int st) { return lses(st) + BQ; };
  auto qsegs = [&](int st) { return reinterpret_cast<int*>(lses(st) + 2 * BQ); };

  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int T = a.T, n_q = (T + BQ - 1) / BQ, G = a.H / a.Hkv;
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);
  int* list = flags + n_q;
  const int k0 = blockIdx.z * kTile;             // z = 0 first: under causality it sees the most
  const int hk = blockIdx.x / C, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = a.q_seg != nullptr;
  const size_t kv_base = ((size_t)b * a.Hkv + hk) * T * D;
  const int* qs_row = has_seg ? a.q_seg + (size_t)b * T : nullptr;
  CTA_STAMP(0, kMarkEntry);

  const int h0 = hk * G + rank * a.walk;
  auto load_tile = [&](int st, int h, int qt) {
    const size_t row_base = ((size_t)b * a.H + h) * T;
    cp_rows<BQ, D, kThreads>(Qs(st), a.q + row_base * D, qt * BQ, T, tid);
    cp_rows<BQ, D, kThreads>(dOs(st), a.dout + row_base * D, qt * BQ, T, tid);
    cp_vals<BQ>(lses(st), a.lse + row_base, qt * BQ, T, tid);
    cp_vals<BQ>(deltas(st), a.delta + row_base, qt * BQ, T, tid);
    if (has_seg) cp_vals<BQ>(qsegs(st), qs_row, qt * BQ, T, tid);
  };

  // ---- the q tiles these keys can see, in order; listed before any tile
  // is loaded, so that the ids' reads do not queue behind the tile copies
  const int qt_start = a.causal ? k0 / BQ : 0;
  bool k_one = true;
  int uk = 0;
  int4 kr = empty_range();
  if (has_seg) kr = rows_range<kTile>(a.k_seg + (size_t)b * T, k0, T, lane, k_one, uk);
  auto corner_free = [&](int qt) {               // rows before T, keys before T, (causal) seen
    return qt * BQ + BQ <= T && k0 + kTile <= T && (!a.causal || k0 + kTile - 1 <= qt * BQ);
  };
  const int n_list = list_tiles<BQ, kWarps>(flags, list, count_s, qs_row, kr, k_one,
                                            uk, qt_start, n_q, T, tid, corner_free);
  CTA_STAMP(0, kMarkListed);
  const int iters = a.walk * n_list;
  CTA_TILES(0, iters);
  auto load_stage = [&](int it) {
    load_tile(it % kStages, h0 + it / n_list, list[it % n_list] & (kInterior - 1));
  };

  // K, V, the keys' ids and the first q tile: group 0
  cp_rows<kTile, D, kThreads>(Ks, a.k + kv_base, k0, T, tid);
  cp_rows<kTile, D, kThreads>(Vs, a.v + kv_base, k0, T, tid);
  if (has_seg) cp_vals<kTile>(kseg_s, a.k_seg + (size_t)b * T, k0, T, tid);
  if (iters > 0) load_stage(0);
  cp_async_commit();

  const int kr0 = warp * 16;                     // this warp's keys in the tile
  const int key0 = k0 + kr0 + g, key1 = key0 + 8;
  const float scale_log2 = a.scale * kLog2e;
  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();                // this tile (and K, V) have landed
    __syncthreads();                             // ... for every thread; the last stage is free
    if (it + kStages - 1 < iters) load_stage(it + kStages - 1);
    cp_async_commit();
    if (it == 0) CTA_STAMP(0, kMarkFirstTile);
    const int st = it % kStages, entry = list[it % n_list];
    const int q0 = (entry & (kInterior - 1)) * BQ;
    const float* Qt = Qs(st);
    const float* dOt = dOs(st);

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    two_products_nrows<D, NQ>(s, dp, Ks, Vs, kr0, Qt, dOt, g, t4);

    // P^T (0 off the mask and on dead rows) and dS^T = P^T (dP^T - delta) scale
    const bool interior = entry & kInterior;
    const int kseg0 = has_seg ? kseg_s[kr0 + g] : 0, kseg1 = has_seg ? kseg_s[kr0 + g + 8] : 0;
    const float* lse_t = lses(st);
    const float* delta_t = deltas(st);
    const int* qseg_t = qsegs(st);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int qi = 8 * n + 2 * t4;             // this thread's two queries of tile n
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + qi);
      const float2 dl2 = *reinterpret_cast<const float2*>(delta_t + qi);
      const int2 qs2 = has_seg ? *reinterpret_cast<const int2*>(qseg_t + qi) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, qpos = q0 + qi + c, key = e < 2 ? key0 : key1;
        float x = fmaf(s[n][e], scale_log2, -(c ? lse2.y : lse2.x) * kLog2e);
        if (!interior) {
          bool ok = key < T && qpos < T && (!a.causal || key <= qpos);
          if (has_seg) ok = ok && (c ? qs2.y : qs2.x) == (e < 2 ? kseg0 : kseg1);
          x = ok ? x : -INFINITY;
        }
        const float p = fast_exp2(x);            // no branch: 2^-inf = 0
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - (c ? dl2.y : dl2.x)) * a.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: the k index is the query
    product_from_acc<D, NQ>(dv, s, dOt, g, t4);
    product_from_acc<D, NQ>(dk, dp, Qt, g, t4);
  }
  cp_async_wait<0>();
  CTA_STAMP(0, kMarkLoopEnd);

  // epilogue: this tile's keys (a tile no q tile sees writes zeros)
  if (C == 1) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = 8 * n + 2 * t4;
      if (key0 < T) {
        *reinterpret_cast<float2*>(a.dk + kv_base + (size_t)key0 * D + col) = make_float2(dk[n][0], dk[n][1]);
        *reinterpret_cast<float2*>(a.dv + kv_base + (size_t)key0 * D + col) = make_float2(dv[n][0], dv[n][1]);
      }
      if (key1 < T) {
        *reinterpret_cast<float2*>(a.dk + kv_base + (size_t)key1 * D + col) = make_float2(dk[n][2], dk[n][3]);
        *reinterpret_cast<float2*>(a.dv + kv_base + (size_t)key1 * D + col) = make_float2(dv[n][2], dv[n][3]);
      }
    }
    CTA_STAMP(0, kMarkEnd);
    return;
  }
  // The tile's 128 rows (dK's, then dV's) go straight from the registers to
  // the CTA that owns them (rows [o per, (o + 1) per) to rank o), into its
  // slot for this rank; after one more cluster barrier every owner sums its
  // rows' C slots in rank order and writes them. Every key row < T is
  // written, zeros included.
  constexpr int kRS = Ld<D>::value;
  const int per = (2 * kTile + C - 1) / C;
  float* gather = smem;                          // [C][per][kRS], over the tiles
  cluster.sync();                                // every CTA of the cluster is done with its tiles
  auto put = [&](int row, int col, float x, float y) {
    const int owner = row / per;
    float* dst = cluster.map_shared_rank(gather, owner) + (rank * per + row - owner * per) * kRS + col;
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  };
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int col = 8 * n + 2 * t4;
    put(kr0 + g, col, dk[n][0], dk[n][1]);
    put(kr0 + g + 8, col, dk[n][2], dk[n][3]);
    put(kTile + kr0 + g, col, dv[n][0], dv[n][1]);
    put(kTile + kr0 + g + 8, col, dv[n][2], dv[n][3]);
  }
  cluster.sync();
  const int row0 = rank * per, rows = min(2 * kTile, row0 + per) - row0;
  for (int idx = tid; idx < rows * (D / 4); idx += kThreads) {
    const int lr = idx / (D / 4), col = (idx - lr * (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float4 p = *reinterpret_cast<const float4*>(gather + (r * per + lr) * kRS + col);
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
    }
    const int row = row0 + lr, key = k0 + row % kTile;
    if (key < T) {
      float* dst = (row < kTile ? a.dk : a.dv) + kv_base + (size_t)key * D + col;
      *reinterpret_cast<float4*>(dst) = acc;
    }
  }
  CTA_STAMP(0, kMarkEnd);
}

// -------------------------------------------------------------------- dq --

// Shared memory in floats: Q, dO [64][D + 4]; kStages x (K, V [64][D + 4],
// the keys' ids [64]); the list's length; flags and list.
template <int D>
struct QSmem {
  static constexpr int kTileF = kTile * Ld<D>::value;
  static constexpr int kQ = 0, kDO = kTileF, kStage = 2 * kTileF;
  static constexpr int kStageF = 2 * kTileF + kTile;
  static constexpr int kCount = kStage + kStages * kStageF, kFlags = kCount + 4;
  static size_t bytes(int T) { return 4 * ((size_t)kFlags + 2 * ((T + kTile - 1) / kTile)); }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dq_kernel(const BwdArgs a) {
  using L = QSmem<D>;
  constexpr int NC = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem + L::kQ;
  float* dOs = smem + L::kDO;
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  auto Ks = [&](int st) { return smem + L::kStage + st * L::kStageF; };
  auto Vs = [&](int st) { return Ks(st) + L::kTileF; };
  auto ksegs = [&](int st) { return reinterpret_cast<int*>(Ks(st) + 2 * L::kTileF); };

  const int T = a.T, n_t = (T + kTile - 1) / kTile;
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);
  int* list = flags + n_t;
  const int q_tile = n_t - 1 - (int)blockIdx.z;  // the last first: it sees the most keys
  const int q0 = q_tile * kTile;
  const int h = blockIdx.x, hk = h / (a.H / a.Hkv), b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = a.q_seg != nullptr;
  const size_t row_base = ((size_t)b * a.H + h) * T;
  const float* kp = a.k + ((size_t)b * a.Hkv + hk) * T * D;
  const float* vp = a.v + ((size_t)b * a.Hkv + hk) * T * D;
  const int* ks_row = has_seg ? a.k_seg + (size_t)b * T : nullptr;
  CTA_STAMP(1, kMarkEntry);

  auto load_tile = [&](int st, int kt) {
    cp_rows<kTile, D, kThreads>(Ks(st), kp, kt * kTile, T, tid);
    cp_rows<kTile, D, kThreads>(Vs(st), vp, kt * kTile, T, tid);
    if (has_seg) cp_vals<kTile>(ksegs(st), ks_row, kt * kTile, T, tid);
  };
  auto load_stage = [&](int it) { load_tile(it % kStages, list[it] & (kInterior - 1)); };

  // ---- the k tiles these rows can see, listed before any tile is
  // loaded, so that the ids' reads do not queue behind the copies
  const int k_end = a.causal ? q_tile + 1 : n_t;
  bool q_one = true;
  int uq = 0;
  int4 qr = empty_range();
  if (has_seg) qr = rows_range<kTile>(a.q_seg + (size_t)b * T, q0, T, lane, q_one, uq);
  auto corner_free = [&](int kt) {               // rows and keys before T, (causal) seen
    return q0 + kTile <= T && kt * kTile + kTile <= T &&
           (!a.causal || kt * kTile + kTile - 1 <= q0);
  };
  const int n_list = list_tiles<kTile, kWarps>(flags, list, count_s, ks_row, qr, q_one,
                                               uq, 0, k_end, T, tid, corner_free);
  CTA_STAMP(1, kMarkListed);
  CTA_TILES(1, n_list);

  // Q, dO and the first k tile: group 0
  cp_rows<kTile, D, kThreads>(Qs, a.q + row_base * D, q0, T, tid);
  cp_rows<kTile, D, kThreads>(dOs, a.dout + row_base * D, q0, T, tid);
  if (n_list > 0) load_stage(0);
  cp_async_commit();

  const int wr = warp * 16;                      // this warp's rows in the tile
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float scale_log2 = a.scale * kLog2e;
  float lse[2], delta[2];
  int qseg[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    lse[half] = row < T ? a.lse[row_base + row] * kLog2e : INFINITY;   // rows past T: P = 0
    delta[half] = row < T ? a.delta[row_base + row] : 0.f;
    qseg[half] = has_seg && row < T ? a.q_seg[(size_t)b * T + row] : 0;
  }
  float dq[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  }

  for (int it = 0; it < n_list; ++it) {
    cp_async_wait<kStages - 2>();                // this tile (and Q, dO) have landed
    __syncthreads();                             // ... for every thread; the last stage is free
    if (it + kStages - 1 < n_list) load_stage(it + kStages - 1);
    cp_async_commit();
    if (it == 0) CTA_STAMP(1, kMarkFirstTile);
    const int st = it % kStages, entry = list[it];
    const int k0 = (entry & (kInterior - 1)) * kTile;
    const float* Kt = Ks(st);

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    two_products_nrows<D, 8>(s, dp, Qs, dOs, wr, Kt, Vs(st), g, t4);

    // dS = P (dP - delta) scale, P exactly 0 off the mask
    const bool interior = entry & kInterior;
    const int* kseg_t = ksegs(st);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int kc = 8 * n + 2 * t4;
      const int2 ks2 = has_seg ? *reinterpret_cast<const int2*>(kseg_t + kc) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, half = e >> 1, key = k0 + kc + c, row = half ? row1 : row0;
        float x = fmaf(s[n][e], scale_log2, -lse[half]);
        if (!interior) {
          bool ok = key < T && row < T && (!a.causal || key <= row);
          if (has_seg) ok = ok && (c ? ks2.y : ks2.x) == qseg[half];
          x = ok ? x : -INFINITY;
        }
        const float p = fast_exp2(x);
        dp[n][e] = p * (dp[n][e] - delta[half]) * a.scale;
      }
    }

    // dQ += dS K: the k index is the key
    product_from_acc<D, 8>(dq, dp, Kt, g, t4);
  }
  cp_async_wait<0>();                            // no copy outlives the CTA
  CTA_STAMP(1, kMarkLoopEnd);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= T) continue;
    float* drow = a.dq + (row_base + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      *reinterpret_cast<float2*>(drow + 8 * n + 2 * t4) =
          make_float2(dq[n][2 * half], dq[n][2 * half + 1]);
    }
  }
  CTA_STAMP(1, kMarkEnd);
}

// ----------------------------------------------------------------- launch --

template <int D, int BQ>
cudaError_t launch(const BwdArgs& a, int B, const float* out, float* delta, cudaStream_t s) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_f32_dkdv_kernel<D, BQ>, kv_configured, dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_f32_dq_kernel<D>, q_configured, dev);
  if (err != cudaSuccess) return err;

  const int rows = B * a.H * a.T, per_block = 256 / (D / 4);
  flash_bwd_f32_prep_kernel<D><<<(rows + per_block - 1) / per_block, 256, 0, s>>>(
      out, a.dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dkdv: clusters of C CTAs along x
  const int n_t = (a.T + kTile - 1) / kTile, C = a.H / a.Hkv / a.walk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * C, B, n_t);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = KvSmem<D, BQ>::bytes(a.T);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_f32_dkdv_kernel<D, BQ>, a);
  if (err != cudaSuccess) return err;

  flash_bwd_f32_dq_kernel<D><<<dim3(a.H, B, n_t), kThreads, QSmem<D>::bytes(a.T), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the caller provides: delta [B, H, T].
extern "C" long long slamkit_flash_bwd_f32_scratch_floats(int B, int H, int T) {
  return (long long)B * H * T;
}

// Plain C entry, bound with ctypes. q, out, dout [B,H,T,D], k/v [B,Hkv,T,D]
// float32, contiguous and 16-byte aligned; lse [B,H,T] f32 (natural log,
// +1e30 on dead rows); q_seg / k_seg [B,T] int32 or both null; dq
// [B,H,T,D], dk/dv [B,Hkv,T,D] f32; scratch:
// slamkit_flash_bwd_f32_scratch_floats(B, H, T) floats. Launches the prep,
// dkdv and dq kernels on `stream`; returns the first launch error.
extern "C" int slamkit_flash_bwd_f32(const float* q, const float* k, const float* v,
                                     const float* out, const float* dout, const float* lse,
                                     const int* q_seg, const int* k_seg, float* dq, float* dk,
                                     float* dv, float* scratch, int B, int H, int Hkv, int T,
                                     int D, float sm_scale, int causal, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (k_seg == nullptr)) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = scratch;
  a.q_seg = q_seg;
  a.k_seg = k_seg;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.causal = causal;
  a.walk = (H / Hkv) / cluster_size(H / Hkv);
  a.scale = sm_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64, 64>(a, B, out, scratch, s);
  // half-height q tiles keep dK, dV, S^T and dP^T within one thread's registers
  if (D == 128) return (int)launch<128, 32>(a, B, out, scratch, s);
  return (int)cudaErrorInvalidValue;
}
