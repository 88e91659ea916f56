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
// KB (dq) at d = 64, 136 KB and 203 KB at d = 128. At d = 256 a 64-row CTA's
// gradient rows would be 256 registers a thread and its tiles would not fit
// 227 KB, so both passes take 32-row CTAs (32 keys, 32 q rows) and tiles of
// 32 rows: warps 0-1 own 16 rows each for columns 0-127 of the gradients,
// warps 2-3 the same rows for columns 128-255, each computing its rows' S
// and dP over the whole head dim (those products twice, the registers of
// d = 128); 196 KB of shared memory a CTA.
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

// The lanes of the delta pre-pass that share a row: one float4 each up to
// d = 128, a warp (two float4 each) at d = 256, so a row never spans warps
template <int D>
struct PrepLanes {
  static constexpr int value = D / 4 < 32 ? D / 4 : 32;
};

// delta[row] = sum_d dO[row, d] O[row, d] over the B*H*T rows
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_f32_prep_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                          float* __restrict__ delta, int rows) {
  constexpr int kLanes = PrepLanes<D>::value, kRowsPerBlock = 256 / kLanes;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int i = 0; i < D / 4 / kLanes; ++i) {
      const int c = 4 * (l + i * kLanes);
      const float4 a = *reinterpret_cast<const float4*>(out + (size_t)row * D + c);
      const float4 b = *reinterpret_cast<const float4*>(dout + (size_t)row * D + c);
      const float part = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
      acc = i == 0 ? part : acc + part;
    }
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

// acc[DC / 8] += P (16 x 8 J, from accumulators) B (8 J rows of a [.][D + 4]
// tile, DC columns from c0), 3xTF32. The tensor cores add a product to their
// accumulator without rounding to nearest, a bias that grows with the adds,
// so this tile's product starts from zero, 32 columns at a time, and is added
// to acc in float32: acc sums over every visited tile (and head)
template <int D, int DC, int J>
__device__ __forceinline__ void product_from_acc(float (&acc)[DC / 8][4], const float (&p)[J][4],
                                                 const float* bt, int c0, int g, int t4) {
#pragma unroll
  for (int c = 0; c < DC / 32; ++c) {
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
        frag_b_krows<D>(y, bt, 8 * j, c0 + 32 * c + 8 * n, g, t4);
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

// Shared memory in floats: K, V [KT][D + 4] and the keys' ids [KT];
// kStages x (Q, dO [BQ][D + 4], LSE, delta, q ids [BQ]); the list's length;
// flags and list (n_q each). After the loop the cluster's gather,
// [C][ceil(2 KT / C)][D + 4], reuses the front.
template <int D, int BQ, int KT>
struct KvSmem {
  static constexpr int kTileKV = KT * Ld<D>::value, kTileQ = BQ * Ld<D>::value;
  static constexpr int kK = 0, kV = kTileKV, kKseg = 2 * kTileKV;
  static constexpr int kStage = kKseg + KT;
  static constexpr int kStageF = 2 * kTileQ + 3 * BQ;
  static constexpr int kCount = kStage + kStages * kStageF, kFlags = kCount + 4;
  static constexpr int kGatherF = (2 * KT + kMaxCluster) * Ld<D>::value;
  static_assert(kGatherF <= kCount, "the gather must fit the tiles");
  static size_t bytes(int T) { return 4 * ((size_t)kFlags + 2 * ((T + BQ - 1) / BQ)); }
};

// One CTA per (KT-key tile, rank, kv head, batch row); the grid's x is Hkv * C
// in clusters of C, the CTA of rank r walking heads hk G + r walk + [0, walk).
// A warp owns 16 keys and DC columns of their dK and dV.
template <int D, int BQ, int KT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dkdv_kernel(const BwdArgs a) {
  using L = KvSmem<D, BQ, KT>;
  constexpr int kGroups = KT / 16, DC = D / (kWarps / kGroups);   // key groups; columns a warp
  static_assert(kWarps % kGroups == 0, "the warps split the keys evenly");
  constexpr int NC = DC / 8, NQ = BQ / 8;
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
  const int k0 = blockIdx.z * KT;                // z = 0 first: under causality it sees the most
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
  if (has_seg) kr = rows_range<KT>(a.k_seg + (size_t)b * T, k0, T, lane, k_one, uk);
  auto corner_free = [&](int qt) {               // rows before T, keys before T, (causal) seen
    return qt * BQ + BQ <= T && k0 + KT <= T && (!a.causal || k0 + KT - 1 <= qt * BQ);
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
  cp_rows<KT, D, kThreads>(Ks, a.k + kv_base, k0, T, tid);
  cp_rows<KT, D, kThreads>(Vs, a.v + kv_base, k0, T, tid);
  if (has_seg) cp_vals<KT>(kseg_s, a.k_seg + (size_t)b * T, k0, T, tid);
  if (iters > 0) load_stage(0);
  cp_async_commit();

  const int kr0 = (warp % kGroups) * 16;         // this warp's keys in the tile
  const int c0 = (warp / kGroups) * DC;          // ... and its columns of dK and dV
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
    product_from_acc<D, DC, NQ>(dv, s, dOt, c0, g, t4);
    product_from_acc<D, DC, NQ>(dk, dp, Qt, c0, g, t4);
  }
  cp_async_wait<0>();
  CTA_STAMP(0, kMarkLoopEnd);

  // epilogue: this tile's keys (a tile no q tile sees writes zeros)
  if (C == 1) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t4;
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
  // The tile's 2 KT rows (dK's, then dV's) go straight from the registers to
  // the CTA that owns them (rows [o per, (o + 1) per) to rank o), into its
  // slot for this rank; after one more cluster barrier every owner sums its
  // rows' C slots in rank order and writes them. Every key row < T is
  // written, zeros included.
  constexpr int kRS = Ld<D>::value;
  const int per = (2 * KT + C - 1) / C;
  float* gather = smem;                          // [C][per][kRS], over the tiles
  cluster.sync();                                // every CTA of the cluster is done with its tiles
  auto put = [&](int row, int col, float x, float y) {
    const int owner = row / per;
    float* dst = cluster.map_shared_rank(gather, owner) + (rank * per + row - owner * per) * kRS + col;
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  };
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int col = c0 + 8 * n + 2 * t4;
    put(kr0 + g, col, dk[n][0], dk[n][1]);
    put(kr0 + g + 8, col, dk[n][2], dk[n][3]);
    put(KT + kr0 + g, col, dv[n][0], dv[n][1]);
    put(KT + kr0 + g + 8, col, dv[n][2], dv[n][3]);
  }
  cluster.sync();
  const int row0 = rank * per, rows = min(2 * KT, row0 + per) - row0;
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
    const int row = row0 + lr, key = k0 + row % KT;
    if (key < T) {
      float* dst = (row < KT ? a.dk : a.dv) + kv_base + (size_t)key * D + col;
      *reinterpret_cast<float4*>(dst) = acc;
    }
  }
  CTA_STAMP(0, kMarkEnd);
}

// -------------------------------------------------------------------- dq --

// Shared memory in floats: Q, dO [QT][D + 4]; kStages x (K, V [BN][D + 4],
// the keys' ids [BN]); the list's length; flags and list.
template <int D, int QT, int BN>
struct QSmem {
  static constexpr int kTileQ = QT * Ld<D>::value, kTileK = BN * Ld<D>::value;
  static constexpr int kQ = 0, kDO = kTileQ, kStage = 2 * kTileQ;
  static constexpr int kStageF = 2 * kTileK + BN;
  static constexpr int kCount = kStage + kStages * kStageF, kFlags = kCount + 4;
  static size_t bytes(int T) { return 4 * ((size_t)kFlags + 2 * ((T + BN - 1) / BN)); }
};

// One CTA per (QT-row q tile, q head, batch row), BN keys a tile; a warp owns
// 16 rows and DC columns of their dQ.
template <int D, int QT, int BN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dq_kernel(const BwdArgs a) {
  using L = QSmem<D, QT, BN>;
  constexpr int kGroups = QT / 16, DC = D / (kWarps / kGroups);   // row groups; columns a warp
  static_assert(kWarps % kGroups == 0, "the warps split the rows evenly");
  constexpr int NC = DC / 8, NB = BN / 8;
  extern __shared__ float smem[];
  float* Qs = smem + L::kQ;
  float* dOs = smem + L::kDO;
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  auto Ks = [&](int st) { return smem + L::kStage + st * L::kStageF; };
  auto Vs = [&](int st) { return Ks(st) + L::kTileK; };
  auto ksegs = [&](int st) { return reinterpret_cast<int*>(Ks(st) + 2 * L::kTileK); };

  const int T = a.T, n_k = (T + BN - 1) / BN;
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);
  int* list = flags + n_k;
  // the last q tile first: it sees the most keys
  const int q_tile = (T + QT - 1) / QT - 1 - (int)blockIdx.z;
  const int q0 = q_tile * QT;
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
    cp_rows<BN, D, kThreads>(Ks(st), kp, kt * BN, T, tid);
    cp_rows<BN, D, kThreads>(Vs(st), vp, kt * BN, T, tid);
    if (has_seg) cp_vals<BN>(ksegs(st), ks_row, kt * BN, T, tid);
  };
  auto load_stage = [&](int it) { load_tile(it % kStages, list[it] & (kInterior - 1)); };

  // ---- the k tiles these rows can see, listed before any tile is
  // loaded, so that the ids' reads do not queue behind the copies
  const int k_end = a.causal ? min(n_k, (q0 + QT - 1) / BN + 1) : n_k;
  bool q_one = true;
  int uq = 0;
  int4 qr = empty_range();
  if (has_seg) qr = rows_range<QT>(a.q_seg + (size_t)b * T, q0, T, lane, q_one, uq);
  auto corner_free = [&](int kt) {               // rows and keys before T, (causal) seen
    return q0 + QT <= T && kt * BN + BN <= T && (!a.causal || kt * BN + BN - 1 <= q0);
  };
  const int n_list = list_tiles<BN, kWarps>(flags, list, count_s, ks_row, qr, q_one,
                                               uq, 0, k_end, T, tid, corner_free);
  CTA_STAMP(1, kMarkListed);
  CTA_TILES(1, n_list);

  // Q, dO and the first k tile: group 0
  cp_rows<QT, D, kThreads>(Qs, a.q + row_base * D, q0, T, tid);
  cp_rows<QT, D, kThreads>(dOs, a.dout + row_base * D, q0, T, tid);
  if (n_list > 0) load_stage(0);
  cp_async_commit();

  const int wr = (warp % kGroups) * 16;          // this warp's rows in the tile
  const int c0 = (warp / kGroups) * DC;          // ... and its columns of dQ
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
    const int k0 = (entry & (kInterior - 1)) * BN;
    const float* Kt = Ks(st);

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BN keys
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    two_products_nrows<D, NB>(s, dp, Qs, dOs, wr, Kt, Vs(st), g, t4);

    // dS = P (dP - delta) scale, P exactly 0 off the mask
    const bool interior = entry & kInterior;
    const int* kseg_t = ksegs(st);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
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
    product_from_acc<D, DC, NB>(dq, dp, Kt, c0, g, t4);
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
      *reinterpret_cast<float2*>(drow + c0 + 8 * n + 2 * t4) =
          make_float2(dq[n][2 * half], dq[n][2 * half + 1]);
    }
  }
  CTA_STAMP(1, kMarkEnd);
}

// ----------------------------------------------------------------- launch --

// BQ q rows a dK/dV tile, KT keys a dK/dV CTA; QT q rows a dQ CTA, BN keys a
// dQ tile
template <int D, int BQ, int KT, int QT, int BN>
cudaError_t launch(const BwdArgs& a, int B, const float* out, float* delta, cudaStream_t s) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_f32_dkdv_kernel<D, BQ, KT>, kv_configured, dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_f32_dq_kernel<D, QT, BN>, q_configured, dev);
  if (err != cudaSuccess) return err;

  const int rows = B * a.H * a.T, per_block = 256 / PrepLanes<D>::value;
  flash_bwd_f32_prep_kernel<D><<<(rows + per_block - 1) / per_block, 256, 0, s>>>(
      out, a.dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dkdv: clusters of C CTAs along x
  const int C = a.H / a.Hkv / a.walk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * C, B, (a.T + KT - 1) / KT);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = KvSmem<D, BQ, KT>::bytes(a.T);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_f32_dkdv_kernel<D, BQ, KT>, a);
  if (err != cudaSuccess) return err;

  flash_bwd_f32_dq_kernel<D, QT, BN>
      <<<dim3(a.H, B, (a.T + QT - 1) / QT), kThreads, QSmem<D, QT, BN>::bytes(a.T), s>>>(a);
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
  if (D == 64) return (int)launch<64, 64, 64, 64, 64>(a, B, out, scratch, s);
  // half-height q tiles keep dK, dV, S^T and dP^T within one thread's
  // registers; at d = 256 every tile and CTA is 32 rows, each warp holding
  // half of the gradient's columns
  if (D == 128) return (int)launch<128, 32, 64, 64, 64>(a, B, out, scratch, s);
  if (D == 256) return (int)launch<256, 32, 32, 32, 32>(a, B, out, scratch, s);
  return (int)cudaErrorInvalidValue;
}
