// Flash-attention backward for Hopper (sm_90a), bf16 in / f32 accumulate.
//
// Replaces: slamkit_tpu/ops/flash_attention.py::_bwd_kernel (launched by
// _bwd_call through _bwd, the backward rule of the _flash custom VJP). Same
// result: with P = exp(scale * Q K^T - LSE) under the forward's masks (causal
// q_pos >= k_pos, equal segment ids, keys < T; a dead row's LSE is +1e30 so
// its P is exactly 0),
//   dV = P^T dO,   dS = P o (dO V^T - delta) * scale,   dK = dS^T Q,   dQ = dS K,
// with delta = rowsum(dO o O) of the external O (JAX computes it outside its
// kernel, flash_attention.py:345; here a pre-pass kernel does). q heads are
// kv-major (head h reads kv head h / G); dK and dV sum over the G heads of a
// kv group.
//
// What bounds it on the H100: at the Slam shape ([8, 14/2, 1024, 64], 8
// packed segments) the bytes (q, k, v, O, dO, LSE read, dq, dk, dv written,
// ~68 MB) take ~20 us at 3.35 TB/s and the products of the visible pairs
// ~8 us at 989 TFLOP/s: bytes bound it. slam_dh128's [8, 7/1, 1024, 128]
// moves the same bytes under the same bound, and SIMS at Qwen2.5-7B's heads
// ([2, 28/4, 2048, 128] on fsdp [4]) twice as many. What holds it back is
// latency: a key tile of a packed batch sees only a few q tiles, so a CTA's
// fixed work (finding its tiles, its first loads, the sum over the cluster)
// weighs as much as its products, and the per-element mask and exp of P run
// at the instruction rate of the warps that also issue the products. At d =
// 128 a warpgroup's dK and dV alone are 128 f32 registers a thread, and
// S^T and dP^T over 32 queries read 48 KB of shared memory a step, near
// what the SM reads in the step's time.
// What the design does about it:
//   * three launches, no atomics, so dQ, dK and dV are bitwise deterministic:
//       - prep: delta = rowsum(dO o O) from the bf16 tensors (one 16-byte load
//         per lane, a fixed shuffle tree), and the segment-id ranges of
//         every 32-row block of q_seg and k_seg, so the other two kernels
//         can list the tiles they must visit before loading any.
//       - dkdv: at d = 64 and 256 one CTA per (key tile, q head, batch
//         row): G times the CTAs of one per kv head. The G CTAs of a kv
//         group form a thread-block cluster; each keeps its head's dK and dV
//         in f32 registers, and at the end sends each row to the cluster CTA
//         that owns it (distributed shared memory, one slot per sender),
//         once every CTA of the cluster has started (a barrier arrived at on
//         entry; where the gather reuses the tiles, d = 256, a full cluster
//         barrier); after one more cluster barrier every owner sums its
//         rows' slots in rank order and writes them. G <= 8 (every preset
//         in models/presets.py: G = 1, 3, 4, 6, 7 or 8) takes one CTA per
//         head; a larger G takes the largest cluster size C <= 8 dividing G,
//         each CTA walking G / C heads in order (none of the presets). At d
//         = 128 a cluster of C CTAs shares a kv group's steps (below), summed
//         the same way, in rank order.
//       - dq: one CTA (one warpgroup) per (64-row q tile, q head, batch
//         row): loops over the listed k tiles and keeps dQ in f32 registers.
//   * d = 64: a dkdv CTA is one warpgroup of 64 keys; both passes stream
//     their tiles through a 3-stage cp.async ring (the dkdv pass Q, dO, LSE,
//     delta and q segment ids; the dq pass K, V and k segment ids), the next
//     two tiles loading while this one multiplies. Every product is wgmma
//     m64n64k16, the warpgroup's 64 keys (dkdv) or 64 q rows (dq) being the
//     M rows: S^T = K Q^T and dP^T = V dO^T (S = Q K^T and dP = dO V^T)
//     with both operands in 128-byte-swizzled shared memory, dV += P^T dO
//     and dK += dS^T Q (dQ += dS K) with P^T, dS^T (dS) packed from the
//     accumulators straight into A-operand registers and the B tile read
//     MN-major.
//   * d = 128 (and d in (64, 128], zero-padded by the wrapper): a dkdv CTA
//     of 64 keys and two warpgroups, 256 threads, each thread free to hold
//     255 registers. A kv group's steps (head, 32-query tile) alternate
//     between the warpgroups, each keeping the keys' dK and dV (64 + 64 f32
//     registers a thread) and a step's S^T and dP^T (16 + 16), so one
//     warpgroup's mask and exp run while the other's products do. Warp 0
//     feeds both from one (Q, dO) ring of five stages: the tiles by TMA
//     through 3-D tensor maps (zeros past T, swizzled as wgmma reads them),
//     LSE, delta and the q segment ids by cp.async, both counted on the
//     stage's mbarrier, a stage refilled once the warpgroup that took it has
//     arrived at its `empty` one. S^T and dP^T run on wgmma m64n32k16 over
//     the two 64-column halves of d; dV += P^T dO and dK += dS^T Q on
//     m64n128k16 with dO and Q read MN-major across both halves. Each
//     kv group's steps are shared by a cluster of C CTAs (rank r takes steps
//     r, r + C, ...), C chosen on the host (`launch128`) so that the grid
//     fills the card and no CTA's share is long: at slam_dh128's shape C = 2,
//     at SIMS 7B's on fsdp [4] C = 2, and C = 1 (no cross-CTA sum) where
//     the key tiles alone suffice. Tried on the card (NVIDIA H100 80GB
//     HBM3, 700 W) and slower: 128 keys and three warpgroups, a producer
//     warpgroup giving its registers to two consumers by setmaxnreg (ptxas
//     kept the consumers near 168 registers, spilled and serialized every
//     wgmma); a producer warp beside two consumers (a 288-thread CTA is
//     allocated registers as 384 threads, the same 168); 64 queries a step
//     (S^T and dP^T 32 + 32: spills); the G heads of a group always spread
//     over a cluster of G, whose cross-CTA sum through distributed shared
//     memory was a CTA's largest phase (`CTA_STAMP` marks,
//     tools/cta_clocks.py). The dq
//     CTA is the d = 64 one with d = 128 tiles (S and dP by m64n64k16 over
//     both halves, dQ += dS K by m64n128k16, dS from registers) and a
//     2-stage ring, so two CTAs share an SM.
//   * d = 256: a dkdv CTA takes 32 keys (64 would be 256 registers a thread
//     of dK and dV): warps 0-1 own 16 keys each for columns 0-127 of dK and
//     dV, warps 2-3 the same keys for columns 128-255, each computing its
//     keys' S^T and dP^T over the whole head dim. Its products run on
//     mma.sync m16n8k16 from padded shared memory, B fragments by ldmatrix;
//     its dq CTA reads Q and dO fragments from padded shared memory.
//   * the mask and exp: each thread reads its query columns' LSE, delta and
//     segment ids as pairs, and takes 2^x on the SFU for every element (-inf
//     off the mask), so the warp never branches.
//   * causal balance: the k tiles that see the most q tiles (the first) and
//     the q tiles that see the most keys (the last) are launched first.
//   * causal: tile pairs above the diagonal are never visited; with segment
//     ids, tiles whose id ranges are disjoint are left off the lists before
//     their operands are loaded; a block's pads (id < 0) keep a range of
//     their own, so a tile ending in a -1 tail is not taken to span every
//     id. A k tile that sees no query still writes its zeros. Any T: the
//     ragged edge is masked in the kernel.
// Left for later work: a persistent grid; at d = 128, S^T and dP^T with K
// and V as register operands (no registers left for them here), and the
// next step's products overlapped with this step's mask.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cmath>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                 // q rows per dq CTA, keys per dkdv CTA (KT) below d = 256
constexpr int kBlock = 32;                // rows per entry of the segment-range table
constexpr int kStages = 3;                // depth of the cp.async rings
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- helpers --

// A fragment (16 rows x 16 cols at [row0, col0]) of a row-major smem tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int stride, int row0, int col0, int g, int t4) {
  const __nv_bfloat16* p = tile + (row0 + g) * stride + col0 + 2 * t4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragment (k = 16 columns at col0, n = 8 rows at row0) of a row-major smem
// tile X, i.e. B = X^T: rows of X are the n index (K in Q K^T)
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int stride,
                                            int row0, int col0, int g, int t4) {
  const __nv_bfloat16* p = tile + (row0 + g) * stride + col0 + 2 * t4;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment (k = 16 rows at row0, n = 8 columns at col0) of a row-major smem
// tile X, i.e. B = X: rows of X are the k index (V in P V)
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int stride,
                                            int row0, int col0, int g, int t4) {
  const __nv_bfloat16* p = tile + (row0 + 2 * t4) * stride + col0 + g;
  b0 = pack_bf16_raw(p[0], p[stride]);
  b1 = pack_bf16_raw(p[8 * stride], p[9 * stride]);
}

// rows [row0, row0 + ROWS) x D of a [T, D] slab into a padded smem tile (row
// stride D + 8 halves), zeros past T
template <int ROWS, int D>
__device__ __forceinline__ void cp_tile_padded(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int T, int tid) {
  constexpr int kStride = D + 8, kChunks = D / 8;
  static_assert((ROWS * kChunks) % kThreads == 0, "tile load must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + row < T;
    cp_async16(&dst[row * kStride + col], ok ? src + (size_t)(row0 + row) * D + col : src, ok);
  }
}

// either layout: swizzled for wgmma (D / 64 tiles of [ROWS][64], one per 64
// columns, ROWS * 128 bytes apart), padded for mma.sync
template <int ROWS, int D, bool kSwizzled>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                        int T, int tid) {
  if constexpr (kSwizzled) {
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) {
      cp_tile_sw128<ROWS, kThreads>(dst + hh * ROWS * 64, src + hh * 64, D, row0, T, tid);
    }
  } else {
    cp_tile_padded<ROWS, D>(dst, src, row0, T, tid);
  }
}

// The tiles t in [t_begin, t_end) (of `per` 32-row blocks each) whose ranges
// meet `want`, in increasing order, into `list`; returns how many. `counts`
// is THREADS / 32 ints of scratch. Every thread of the CTA calls it.
template <int THREADS>
__device__ int build_list(int* list, int* counts, const int4* table, int n_blk, int t_begin,
                          int t_end, int per, int4 want, int tid) {
  constexpr int kListWarps = THREADS / 32;
  const int warp = tid >> 5, lane = tid & 31;
  int n = 0;
  for (int base = t_begin; base < t_end; base += THREADS) {
    const int t = base + tid;
    bool need = false;
    if (t < t_end) {
      need = meet(block_range(table, t * per, t * per + per, n_blk), want);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, need);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int before = n, total = 0;
#pragma unroll
    for (int w = 0; w < kListWarps; ++w) {
      before += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (need) list[before + __popc(ballot & ((1u << lane) - 1u))] = t;
    n += total;
    __syncthreads();                        // counts is reused
  }
  return n;
}

// ------------------------------------------------------------------ prep --

// delta[row] = sum_d dO[row, d] O[row, d] over the B*H*T rows (D / 8 lanes a
// row, 16 bytes each); then, in the blocks after those, the segment-id ranges
// of every 32-row block of q_seg (table 0) and k_seg (table 1), a warp each.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                      int rows, const int* __restrict__ q_seg,
                      const int* __restrict__ k_seg, int4* __restrict__ ranges, int B,
                      int T, int n_blk) {
  constexpr int kLanes = D / 8, kRowsPerBlock = 256 / kLanes;
  const int n_delta = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if ((int)blockIdx.x < n_delta) {
    const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
    const int l = threadIdx.x % kLanes;
    float acc = 0.f;
    if (row < rows) {
      const uint4 a = *reinterpret_cast<const uint4*>(out + (size_t)row * D + l * 8);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + (size_t)row * D + l * 8);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(pa[j]), fb = __bfloat1622float2(pb[j]);
        acc = fmaf(fa.x, fb.x, acc);
        acc = fmaf(fa.y, fb.y, acc);
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row < rows && l == 0) delta[row] = acc;
    return;
  }
  const int w = (blockIdx.x - n_delta) * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (w >= 2 * B * n_blk) return;
  const int which = w / (B * n_blk), rest = w - which * B * n_blk;
  const int b = rest / n_blk, blk = rest - b * n_blk;
  const int* seg = which ? k_seg : q_seg;
  const int t = blk * kBlock + lane;
  int4 r = empty_range();
  if (t < T) {
    const int id = seg[(size_t)b * T + t];
    if (id >= 0) {
      r.x = r.y = id;
    } else {
      r.z = r.w = id;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r = join(r, make_int4(__shfl_xor_sync(0xffffffffu, r.x, off),
                          __shfl_xor_sync(0xffffffffu, r.y, off),
                          __shfl_xor_sync(0xffffffffu, r.z, off),
                          __shfl_xor_sync(0xffffffffu, r.w, off)));
  }
  if (lane == 0) ranges[w] = r;
}

// ------------------------------------------------------------------ dkdv --

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  const int* q_seg;
  const int* k_seg;
  const int4* ranges;      // [2][B][n_blk] (q_seg's, then k_seg's), or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, H, Hkv, T, n_blk, walk, causal;
  float sm_scale;
};

// Shared memory of a dkdv CTA, in bytes from a 1024-aligned base: the K and V
// tiles (KT keys), kStages (Q tile, dO tile) stages, per stage BQ LSE, delta
// and q segment ids, the tile's k segment ids, kWarps counts, the epilogue's
// f32 gather of the cluster's dK / dV rows ([C][ceil(2 KT / C)][D + 8], at
// most (2 KT + 8) rows) and the q-tile list. At d = 256 the gather reuses the
// tiles instead.
template <int D, int BQ, bool kWgmma, int KT>
struct KvSmem {
  static constexpr int kStride = kWgmma ? D : D + 8;       // halves a row
  static constexpr int kTileKV = KT * kStride * 2, kTileQ = BQ * kStride * 2;
  static constexpr int kK = 0, kV = kTileKV, kQ = 2 * kTileKV;
  static constexpr int kDO = kQ + kStages * kTileQ;
  static constexpr int kLse = kDO + kStages * kTileQ;
  static constexpr int kDelta = kLse + kStages * BQ * 4;
  static constexpr int kQseg = kDelta + kStages * BQ * 4;
  static constexpr int kKseg = kQseg + kStages * BQ * 4;
  static constexpr int kCounts = kKseg + KT * 4;
  static constexpr int kGatherBytes = (2 * KT + kMaxCluster) * (D + 8) * 4;
  static constexpr int kGather = D == 64 ? kCounts + kWarps * 4 : 0;
  static constexpr int kList = kGather == 0 ? kCounts + kWarps * 4 : kGather + kGatherBytes;
  static_assert(kGather != 0 || kGatherBytes <= kLse, "the gather must fit the tiles");
  static_assert(!kWgmma || (kTileKV % 1024 == 0 && kTileQ % 1024 == 0), "swizzled tiles");
  static size_t bytes(int T) { return 1024 + kList + 4 * (size_t)((T + BQ - 1) / BQ); }
};

// One CTA per (KT-key tile, head walk, batch row); the grid's x is Hkv * C in
// clusters of C, the CTA of rank r walking heads hk * G + r * walk + [0, walk).
// A warp owns 16 keys and DC columns of their dK and dV.
template <int D, int BQ, bool kWgmma, int KT>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_kernel(const BwdArgs a) {
  static_assert(!kWgmma || (D == 64 && BQ == 64 && KT == 64),
                "wgmma takes d = 64, 64 queries and 64 keys a tile");
  static_assert(kWgmma || D == 256, "mma.sync serves d = 256 alone");
  using L = KvSmem<D, BQ, kWgmma, KT>;
  constexpr int kStride = L::kStride;
  constexpr int kGroups = KT / 16, DC = D / (kWarps / kGroups);   // key groups; columns a warp
  static_assert(kWarps % kGroups == 0, "the warps split the keys evenly");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(sm + L::kK);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(sm + L::kV);
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* delta_s = reinterpret_cast<float*>(sm + L::kDelta);
  int* qseg_s = reinterpret_cast<int*>(sm + L::kQseg);
  int* kseg_s = reinterpret_cast<int*>(sm + L::kKseg);
  int* counts = reinterpret_cast<int*>(sm + L::kCounts);
  int* list = reinterpret_cast<int*>(sm + L::kList);
  auto Qs = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(sm + L::kQ + st * L::kTileQ); };
  auto dOs = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(sm + L::kDO + st * L::kTileQ); };

  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T = a.T, G = a.H / a.Hkv;
  const int hk = blockIdx.x / C, b = blockIdx.y;
  const int k0 = blockIdx.z * KT;           // z = 0 first: under causality it sees the most
  const bool has_seg = a.ranges != nullptr;
  const float scale_log2 = a.sm_scale * kLog2e;
  const size_t kv_base = ((size_t)b * a.Hkv + hk) * T * D;
  if constexpr (L::kGather != 0) cluster_arrive_relaxed();   // this CTA has started

  // K, V and the keys' segment ids: the first cp.async group
  cp_tile<KT, D, kWgmma>(Ks, a.k + kv_base, k0, T, tid);
  cp_tile<KT, D, kWgmma>(Vs, a.v + kv_base, k0, T, tid);
  if (has_seg && tid < KT) {
    const bool ok = k0 + tid < T;
    cp_async4(&kseg_s[tid], a.k_seg + (size_t)b * T + (ok ? k0 + tid : 0), ok);
  }
  cp_async_commit();

  // the q tiles these keys can see, in order
  const int n_q = (T + BQ - 1) / BQ, qt_start = a.causal ? k0 / BQ : 0;
  int n_list = n_q - qt_start;
  if (has_seg) {
    const int4 kr = block_range(a.ranges + ((size_t)a.B + b) * a.n_blk, k0 / kBlock,
                                (k0 + KT) / kBlock, a.n_blk);
    n_list = build_list<kThreads>(list, counts, a.ranges + (size_t)b * a.n_blk, a.n_blk,
                                  qt_start, n_q, BQ / kBlock, kr, tid);
  }
  const int iters = a.walk * n_list, h0 = hk * G + rank * a.walk;
  auto q_tile = [&](int it) { const int i = it % n_list; return has_seg ? list[i] : qt_start + i; };
  auto load_stage = [&](int it) {
    const int h = h0 + it / n_list, q0 = q_tile(it) * BQ, st = it % kStages;
    const size_t row_base = ((size_t)b * a.H + h) * T;
    cp_tile<BQ, D, kWgmma>(Qs(st), a.q + row_base * D, q0, T, tid);
    cp_tile<BQ, D, kWgmma>(dOs(st), a.dout + row_base * D, q0, T, tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < T;
      const size_t r = row_base + (ok ? q0 + tid : 0);
      cp_async4(&lse_s[st * BQ + tid], a.lse + r, ok);
      cp_async4(&delta_s[st * BQ + tid], a.delta + r, ok);
      if (has_seg) cp_async4(&qseg_s[st * BQ + tid], a.q_seg + (size_t)b * T + (ok ? q0 + tid : 0), ok);
    }
  };

  const int kr = (warp % kGroups) * 16;     // this warp's keys within the tile
  const int c0 = (warp / kGroups) * DC;     // ... and its columns of dK and dV
  const int key0 = k0 + kr + g, key1 = key0 + 8;
  float dk[DC / 8][4], dv[DC / 8][4], s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < iters) load_stage(st);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();           // this tile (and K, V) have landed
    if constexpr (kWgmma) fence_async_smem();
    __syncthreads();                        // ... for every thread; the last stage is free
    if (it + kStages - 1 < iters) load_stage(it + kStages - 1);
    cp_async_commit();
    const int st = it % kStages, q0 = q_tile(it) * BQ;
    const __nv_bfloat16* Qt = Qs(st);
    const __nv_bfloat16* dOt = dOs(st);

    // S^T = K Q^T and dP^T = V dO^T for the tile's 64 keys x BQ queries
    if constexpr (kWgmma) {
      float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
      float(&dpf)[32] = reinterpret_cast<float(&)[32]>(dp);
      const uint64_t dk_ = sw128_desc(Ks), dv_ = sw128_desc(Vs);
      const uint64_t dq_ = sw128_desc(Qt), do_ = sw128_desc(dOt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sf, dk_ + 2 * kk, dq_ + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dpf, dv_ + 2 * kk, do_ + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sf);
      fence_regs(dpf);
    } else {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, Ks, kStride, kr, kk * 16, g, t4);
        load_a(va, Vs, kStride, kr, kk * 16, g, t4);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, Qt, kStride, j * 8, kk * 16, g, t4);
          mma_16816(s[j], ka, b0, b1);
          load_b_rows(b0, b1, dOt, kStride, j * 8, kk * 16, g, t4);
          mma_16816(dp[j], va, b0, b1);
        }
      }
    }

    // P^T (masked, exactly 0 off the mask and on dead rows) and
    // dS^T = P^T (dP^T - delta) * scale, both per (key, query) element
    const int kseg0 = has_seg ? kseg_s[kr + g] : 0, kseg1 = has_seg ? kseg_s[kr + g + 8] : 0;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    const int* qseg_t = qseg_s + st * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      // this thread's two query columns of block j: LSE, delta, segment ids
      const int qi = j * 8 + 2 * t4;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + qi);
      const float2 dl = *reinterpret_cast<const float2*>(delta_t + qi);
      const int2 qs = has_seg ? *reinterpret_cast<const int2*>(qseg_t + qi) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, qpos = q0 + qi + c;
        const int key = e < 2 ? key0 : key1;
        bool ok = key < T && qpos < T && (!a.causal || key <= qpos);
        if (has_seg) ok = ok && (c ? qs.y : qs.x) == (e < 2 ? kseg0 : kseg1);
        const float x = fmaf(s[j][e], scale_log2, -(c ? lse2.y : lse2.x) * kLog2e);
        const float p = fast_exp2(ok ? x : -INFINITY);   // no branch: 2^-inf = 0
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (c ? dl.y : dl.x)) * a.sm_scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: the k index is the query
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    if constexpr (kWgmma) {
      float(&dvf)[32] = reinterpret_cast<float(&)[32]>(dv);
      float(&dkf)[32] = reinterpret_cast<float(&)[32]>(dk);
      const uint64_t do_ = sw128_desc(dOt), dq_ = sw128_desc(Qt);
      wgmma_fence();
#pragma unroll   // k16 steps of the queries: 16 rows of 128 bytes each
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dvf, pa[kk], do_ + kk * kDescRows16);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dkf, da[kk], dq_ + kk * kDescRows16);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dvf);
      fence_regs(dkf);
    } else {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          uint32_t b0, b1;
          load_b_cols(b0, b1, dOt, kStride, kk * 16, c0 + n * 8, g, t4);
          mma_16816(dv[n], pa[kk], b0, b1);
          load_b_cols(b0, b1, Qt, kStride, kk * 16, c0 + n * 8, g, t4);
          mma_16816(dk[n], da[kk], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the tiles are free for the sums

  // The tile's 2 KT f32 rows (dK's, then dV's) go straight from the
  // registers to the CTA that owns them (rows [o per, (o + 1) per) to rank
  // o), into its slot for this rank; after one cluster barrier every owner
  // sums its rows' C slots in rank order and writes them. Every key row < T
  // is written, zeros included.
  constexpr int kRS = D + 8;
  const int per = (2 * KT + C - 1) / C;
  float* gather = reinterpret_cast<float*>(sm + L::kGather);   // [C][per][kRS]
  if constexpr (L::kGather == 0) {
    cluster.sync();                         // the gather reuses the tiles
  } else {
    cluster_wait();                         // every CTA of the cluster has started
  }
  auto put = [&](int row, int c, float x, float y) {
    const int owner = row / per;
    float* dst = cluster.map_shared_rank(gather, owner) + (rank * per + row - owner * per) * kRS + c;
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  };
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int c = c0 + n * 8 + 2 * t4;
    put(kr + g, c, dk[n][0], dk[n][1]);
    put(kr + g + 8, c, dk[n][2], dk[n][3]);
    put(KT + kr + g, c, dv[n][0], dv[n][1]);
    put(KT + kr + g + 8, c, dv[n][2], dv[n][3]);
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
        acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
      }
    }
    const int row = row0 + lr, key = k0 + row % KT;
    if (key < T) {
      __nv_bfloat16* dst = (row < KT ? a.dk : a.dv) + kv_base + (size_t)key * D + col;
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
  }
}

// ------------------------------------------------------------ dkdv, d = 128 --

constexpr int kThreads128 = 2 * 128;     // two warpgroups
constexpr int kKT128 = 64;               // keys a d = 128 dkdv CTA
constexpr int kBQ128 = 32;               // queries a step
constexpr int kRing128 = 5;              // (Q, dO) stages of its ring
constexpr int kKVTile = 64 * 64 * 2;     // bytes of a swizzled [64][64] bf16 tile (K, V)
constexpr int kQHalf = kBQ128 * 64 * 2;  // ... of a [32][64] one (Q, dO)

// Shared memory of a d = 128 dkdv CTA, in bytes from a 1024-aligned base: K
// and V (two swizzled [64][64] column halves each), kRing128 (Q, dO) stages
// ([stage][column half] [32][64] tiles), per stage 32 LSE, delta and q
// segment ids, the tile's 64 k segment ids, the ring's mbarriers (full and
// empty a stage, then K / V's), counts and the q-tile list. The epilogue
// reuses the tiles: warpgroup 1's f32 dK / dV rows ([128][D + 8]) for
// warpgroup 0 to add, then, in a cluster, over the same bytes, the gather of
// the cluster's rows ([C][ceil(2 KT / C)][D + 8]).
struct Kv128Smem {
  static constexpr int kK = 0, kV = 2 * kKVTile, kQ = 4 * kKVTile;
  static constexpr int kDO = kQ + kRing128 * 2 * kQHalf;
  static constexpr int kLse = kDO + kRing128 * 2 * kQHalf;
  static constexpr int kDelta = kLse + kRing128 * kBQ128 * 4;
  static constexpr int kQseg = kDelta + kRing128 * kBQ128 * 4;
  static constexpr int kKseg = kQseg + kRing128 * kBQ128 * 4;
  static constexpr int kBar = kKseg + kKT128 * 4;
  static constexpr int kCounts = kBar + (2 * kRing128 + 1) * 8;
  static constexpr int kList = kCounts + kThreads128 / 32 * 4;
  static constexpr int kGatherBytes = (2 * kKT128 + kMaxCluster) * (128 + 8) * 4;
  static_assert(kGatherBytes <= kLse, "the gathers must fit the tiles");
  static size_t bytes(int T) { return 1024 + kList + 4 * (size_t)((T + kBQ128 - 1) / kBQ128); }
};

// One CTA per (64-key tile, batch row, rank in its cluster): the grid's x
// is Hkv * C in clusters of C, C (1 to 8) chosen on the host so that the
// grid fills the card; the C CTAs of a kv group share its steps (every
// head's 32-query tiles). A CTA's steps alternate between its two
// warpgroups, each keeping the 64 keys' dK and dV in f32
// registers (64 + 64 a thread): S^T = K Q^T and dP^T = V dO^T by wgmma
// m64n32k16 from the swizzled tiles, then dV += P^T dO and dK += dS^T Q by
// m64n128k16 with P^T and dS^T packed from the accumulators into A
// registers and dO / Q read MN-major. Warp 0 keeps the (Q, dO) ring full by
// TMA (the tiles, zeros past T) and cp.async (LSE, delta, q segment ids),
// both counted on the stage's `full` mbarrier, refilling a stage once the
// warpgroup that took it has arrived at its `empty` one. At the end
// warpgroup 0 adds warpgroup 1's rows to its own, and a cluster sums its
// CTAs' rows in rank order as the d = 64 kernel does.
__global__ void __launch_bounds__(kThreads128, 1)
flash_bwd_dkdv128_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const BwdArgs a) {
  using L = Kv128Smem;
  constexpr int D = 128, BQ = kBQ128, KT = kKT128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  auto kv_tile = [&](int off, int hh) {
    return reinterpret_cast<__nv_bfloat16*>(sm + off + hh * kKVTile);
  };
  auto q_tile_at = [&](int off, int i) {
    return reinterpret_cast<__nv_bfloat16*>(sm + off + i * kQHalf);
  };
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* delta_s = reinterpret_cast<float*>(sm + L::kDelta);
  int* qseg_s = reinterpret_cast<int*>(sm + L::kQseg);
  int* kseg_s = reinterpret_cast<int*>(sm + L::kKseg);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kRing128;
  uint64_t* kv_full = empty + kRing128;
  int* counts = reinterpret_cast<int*>(sm + L::kCounts);
  int* list = reinterpret_cast<int*>(sm + L::kList);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T = a.T, G = a.H / a.Hkv;
  const int hk = blockIdx.x / C, b = blockIdx.y;
  const int k0 = blockIdx.z * KT;           // z = 0 first: under causality it sees the most
  const bool has_seg = a.ranges != nullptr;
  CTA_STAMP(0, kMarkEntry);
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kRing128; ++st) {
      mbar_init(&full[st], 1 + 32);         // the TMA bytes' arrival + 32 lanes' copies
      mbar_init(&empty[st], 128);           // the threads of the warpgroup that took it
    }
    mbar_init(kv_full, 1 + 32);
    mbar_init_fence();
    // K and V first: they do not wait for the tile list
    const int kv_slab = b * a.Hkv + hk;
    mbar_expect_tx(kv_full, 2 * KT * D * 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tma_load_3d(kv_tile(L::kK, hh), &kmap, hh * 64, k0, kv_slab, kv_full);
      tma_load_3d(kv_tile(L::kV, hh), &vmap, hh * 64, k0, kv_slab, kv_full);
    }
  }
  __syncwarp();
  if (tid < 32) {                           // the keys' segment ids, on the same barrier
    if (has_seg) {
      for (int i = lane; i < KT; i += 32) {
        const bool ok = k0 + i < T;
        cp_async4(&kseg_s[i], a.k_seg + (size_t)b * T + (ok ? k0 + i : 0), ok);
      }
    }
    cp_async_mbar_arrive(kv_full);
  }

  // the q tiles (of BQ rows) these keys can see, in order
  const int n_q = (T + BQ - 1) / BQ, qt_start = a.causal ? k0 / BQ : 0;
  int n_list = n_q - qt_start;
  if (has_seg) {
    const int4 kr = block_range(a.ranges + ((size_t)a.B + b) * a.n_blk, k0 / kBlock,
                                (k0 + KT) / kBlock, a.n_blk);
    n_list = build_list<kThreads128>(list, counts, a.ranges + (size_t)b * a.n_blk, a.n_blk,
                                    qt_start, n_q, BQ / kBlock, kr, tid);
  }
  __syncthreads();                          // the barriers are set up, the list written
  // The kv group's steps are (head, q tile) pairs, s = head * n_list + tile;
  // the CTA of rank r takes s = r, r + C, r + 2 C, ..., so every CTA of a
  // cluster gets an even share whatever G is. Its j-th:
  const int steps = G * n_list;
  const int iters = steps > rank ? (steps - rank + C - 1) / C : 0;
  auto q_tile = [&](int j) {
    const int i = (rank + j * C) % n_list;
    return has_seg ? list[i] : qt_start + i;
  };
  auto q_slab = [&](int j) { return b * a.H + hk * G + (rank + j * C) / n_list; };
  CTA_STAMP(0, kMarkListed);
  CTA_TILES(0, iters);

  // Warp 0 loads step it into stage it % kRing128: the (Q, dO) tiles (TMA,
  // zeros past T) and their LSE, delta and q segment ids (cp.async, a query
  // a lane), all counted on the stage's `full` mbarrier
  auto produce = [&](int it) {
    const int st = it % kRing128;
    if (it >= kRing128) mbar_wait(&empty[st], (it / kRing128 - 1) & 1);
    const int slab = q_slab(it), q0 = q_tile(it) * BQ;
    if (lane == 0) {
      mbar_expect_tx(&full[st], 2 * BQ * D * 2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tma_load_3d(q_tile_at(L::kQ, 2 * st + hh), &qmap, hh * 64, q0, slab, &full[st]);
        tma_load_3d(q_tile_at(L::kDO, 2 * st + hh), &domap, hh * 64, q0, slab, &full[st]);
      }
    }
    const bool ok = q0 + lane < T;
    const size_t r = (size_t)slab * T + (ok ? q0 + lane : 0);
    cp_async4(&lse_s[st * BQ + lane], a.lse + r, ok);
    cp_async4(&delta_s[st * BQ + lane], a.delta + r, ok);
    if (has_seg) {
      cp_async4(&qseg_s[st * BQ + lane], a.q_seg + (size_t)b * T + (ok ? q0 + lane : 0), ok);
    }
    cp_async_mbar_arrive(&full[st]);
  };
  if (tid < 32) {
    for (int it = 0; it < kRing128 - 2 && it < iters; ++it) produce(it);
  }

  // warpgroup wg takes the steps it = wg, wg + 2, ...
  const int kr = warp * 16;                 // this warp's 16 keys within the tile
  const int key0 = k0 + kr + g, key1 = key0 + 8;
  const float scale_log2 = a.sm_scale * kLog2e;
  // Registers: dK and dV are 128 a thread, S^T and dP^T 32 at 32 queries a
  // step, P^T and dS^T packed 16, within the 255 a thread of a 256-thread
  // CTA. S^T and dP^T start from their first product (wgmma_ss_first), so
  // they hold nothing live between steps. Every register a product reads is
  // set before its wgmma_fence: a move ptxas finds between the fence and
  // the products makes it serialize every wgmma of the kernel.
  float dk[64], dv[64], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  fence_regs(dk);
  fence_regs(dv);
  mbar_wait(kv_full, 0);
  const int kseg0 = has_seg ? kseg_s[kr + g] : 0, kseg1 = has_seg ? kseg_s[kr + g + 8] : 0;

  for (int it = wg; it < iters; it += 2) {
    // warp 0 refills the stages of the two steps before this one (its own
    // warpgroup's last, and the other's), kRing128 - 2 steps ahead
    if (tid < 32) {
      for (int next = it + kRing128 - 2; next < it + kRing128 && next < iters; ++next) {
        produce(next);
      }
    }
    const int st = it % kRing128, q0 = q_tile(it) * BQ;
    mbar_wait(&full[st], (it / kRing128) & 1);
    if (it == 0) CTA_STAMP(0, kMarkFirstTile);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries over d = 128, the
    // two column halves in order
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint64_t k_ = sw128_desc(kv_tile(L::kK, hh));
      const uint64_t q_ = sw128_desc(q_tile_at(L::kQ, 2 * st + hh));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (hh + kk == 0) {
          wgmma_ss_first(s, k_, q_);
        } else {
          wgmma_ss(s, k_ + 2 * kk, q_ + 2 * kk);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint64_t v_ = sw128_desc(kv_tile(L::kV, hh));
      const uint64_t do_ = sw128_desc(q_tile_at(L::kDO, 2 * st + hh));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (hh + kk == 0) {
          wgmma_ss_first(dp, v_, do_);
        } else {
          wgmma_ss(dp, v_ + 2 * kk, do_ + 2 * kk);
        }
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T (exactly 0 off the mask and on dead rows) and dS^T = P^T (dP^T -
    // delta) * scale; element 4 j + e is key kr + g (+ 8 for e >= 2), query
    // 8 j + 2 t4 + (e & 1)
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    const int* qseg_t = qseg_s + st * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int qi = j * 8 + 2 * t4;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + qi);
      const float2 dl = *reinterpret_cast<const float2*>(delta_t + qi);
      const int2 qs = has_seg ? *reinterpret_cast<const int2*>(qseg_t + qi) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, qpos = q0 + qi + c;
        const int key = e < 2 ? key0 : key1;
        bool ok = key < T && qpos < T && (!a.causal || key <= qpos);
        if (has_seg) ok = ok && (c ? qs.y : qs.x) == (e < 2 ? kseg0 : kseg1);
        const float x = fmaf(s[4 * j + e], scale_log2, -(c ? lse2.y : lse2.x) * kLog2e);
        const float p = fast_exp2(ok ? x : -INFINITY);   // no branch: 2^-inf = 0
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - (c ? dl.y : dl.x)) * a.sm_scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: the k index is the query, 16 a step
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }
    const uint64_t do_ = sw128_desc_mn(q_tile_at(L::kDO, 2 * st), kQHalf);
    const uint64_t q_ = sw128_desc_mn(q_tile_at(L::kQ, 2 * st), kQHalf);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_mn(dv, pa[kk], do_ + kk * kDescRows16);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_mn(dk, da[kk], q_ + kk * kDescRows16);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[st]);                // this thread is done with the stage
  }
  CTA_STAMP(0, kMarkLoopEnd);

  // The epilogue reuses the tiles: every step's reads are done once both
  // warpgroups pass this barrier. Warpgroup 1 leaves its f32 rows (dK's 64,
  // then dV's) in shared memory; warpgroup 0 adds them to its own.
  constexpr int kRS = D + 8;
  static_assert(2 * KT * kRS * 4 <= L::kLse, "warpgroup 1's rows must fit the tiles");
  float* rows1 = reinterpret_cast<float*>(sm);      // [2 KT][kRS]
  fence_async_smem();                       // the tiles' wgmma reads before these writes
  __syncthreads();
  auto each = [&](auto&& f) {               // f(row, column, dk or dv, element index)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t4;
      f(kr + g, c, dk, 4 * n);
      f(kr + g + 8, c, dk, 4 * n + 2);
      f(KT + kr + g, c, dv, 4 * n);
      f(KT + kr + g + 8, c, dv, 4 * n + 2);
    }
  };
  if (wg == 1) {
    each([&](int row, int c, float (&x)[64], int i) {
      *reinterpret_cast<float2*>(rows1 + row * kRS + c) = make_float2(x[i], x[i + 1]);
    });
  }
  __syncthreads();
  if (wg == 0) {
    each([&](int row, int c, float (&x)[64], int i) {
      const float2 y = *reinterpret_cast<const float2*>(rows1 + row * kRS + c);
      x[i] += y.x;
      x[i + 1] += y.y;
    });
  }
  const size_t kv_base = ((size_t)b * a.Hkv + hk) * T * D;
  if (C == 1) {                             // warpgroup 0 writes the sums
    if (wg == 0) {
      each([&](int row, int c, float (&x)[64], int i) {
        const int key = k0 + row % KT;
        if (key < T) {
          __nv_bfloat16* dst = (row < KT ? a.dk : a.dv) + kv_base + (size_t)key * D + c;
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x[i], x[i + 1]);
        }
      });
    }
    CTA_STAMP(0, kMarkEnd);
    return;
  }
  // In a cluster, warpgroup 0's sums go to the CTAs that own their rows (rows
  // [o per, (o + 1) per) to rank o), into the owner's slot for this rank;
  // after a cluster barrier every owner adds its rows' C slots in rank order
  // and writes them. Every key row < T is written, zeros included.
  const int per = (2 * KT + C - 1) / C;
  float* gather = rows1;                    // [C][per][kRS], once every CTA has read rows1
  cluster.sync();
  if (wg == 0) {
    each([&](int row, int c, float (&x)[64], int i) {
      const int owner = row / per;
      float* dst = cluster.map_shared_rank(gather, owner) + (rank * per + row - owner * per) * kRS;
      *reinterpret_cast<float2*>(dst + c) = make_float2(x[i], x[i + 1]);
    });
  }
  cluster.sync();
  const int row0 = rank * per, rows = min(2 * KT, row0 + per) - row0;
  for (int idx = tid; idx < rows * (D / 4); idx += kThreads128) {
    const int lr = idx / (D / 4), col = (idx - lr * (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float4 p = *reinterpret_cast<const float4*>(gather + (r * per + lr) * kRS + col);
        acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
      }
    }
    const int row = row0 + lr, key = k0 + row % KT;
    if (key < T) {
      __nv_bfloat16* dst = (row < KT ? a.dk : a.dv) + kv_base + (size_t)key * D + col;
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
  }
  CTA_STAMP(0, kMarkEnd);
}

// --------------------------------------------------------------------- dq --

// Shared memory of a dq CTA, in bytes from a 1024-aligned base: with wgmma
// (or at d = 256) the Q and dO tiles (the A operands, 128-byte swizzled as D
// / 64 tiles of 64 columns, or padded to D + 8 halves a row), then kS (K
// tile, V tile) stages laid out the same way, per stage BN k segment ids,
// kWarps counts and the k-tile list. At d = 128 the ring has two stages, so
// that two CTAs share an SM.
template <int D, int BN, bool kWgmma>
struct QSmem {
  static constexpr int kS = kWgmma && D == 128 ? 2 : kStages;
  static constexpr int kRow = kWgmma ? D : D + 8;          // halves a row (of all halves)
  static constexpr int kTileKV = BN * kRow * 2;
  static constexpr int kQ = 0, kDO = kTile * kRow * 2;
  static constexpr int kK = 2 * kDO;
  static constexpr int kKseg = kK + kS * 2 * kTileKV;
  static constexpr int kCounts = kKseg + kS * BN * 4;
  static constexpr int kList = kCounts + kWarps * 4;
  static_assert(!kWgmma || (kTileKV % 1024 == 0 && kDO % 1024 == 0), "swizzled tiles");
  static size_t bytes(int T) { return 1024 + kList + 4 * (size_t)((T + BN - 1) / BN); }
};

// One CTA per (64-row q tile, q head, batch row); BN keys a step.
template <int D, int BN, bool kWgmma>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdArgs a) {
  static_assert(!kWgmma || ((D == 64 || D == 128) && BN == 64),
                "wgmma takes d = 64 or 128, 64 keys a tile");
  static_assert(kWgmma || D == 256, "mma.sync serves d = 256 alone");
  using L = QSmem<D, BN, kWgmma>;
  constexpr int kStride = L::kRow, S = L::kS, NH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm + L::kQ);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(sm + L::kDO);
  auto Ks = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(sm + L::kK + st * 2 * L::kTileKV); };
  auto Vs = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(sm + L::kK + st * 2 * L::kTileKV + L::kTileKV);
  };
  int* kseg_s = reinterpret_cast<int*>(sm + L::kKseg);
  int* counts = reinterpret_cast<int*>(sm + L::kCounts);
  int* list = reinterpret_cast<int*>(sm + L::kList);

  const int T = a.T;
  const int n_qt = (T + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * kTile;   // the last first: it sees the most keys
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = a.ranges != nullptr;
  const float scale_log2 = a.sm_scale * kLog2e;

  const size_t q_base = ((size_t)b * a.H + h) * T * D;
  const size_t kv_base = ((size_t)b * a.Hkv + hk) * T * D;
  const size_t row_base = ((size_t)b * a.H + h) * T;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // the k tiles these rows can see, in order
  const int n_k = (T + BN - 1) / BN;
  const int k_end = a.causal ? min(n_k, (q0 + kTile - 1) / BN + 1) : n_k;
  int n_list = k_end;
  if (has_seg) {
    const int4 qr = block_range(a.ranges + (size_t)b * a.n_blk, q0 / kBlock,
                                (q0 + kTile) / kBlock, a.n_blk);
    n_list = build_list<kThreads>(list, counts, a.ranges + ((size_t)a.B + b) * a.n_blk,
                                  a.n_blk, 0, k_end, BN / kBlock, qr, tid);
  }
  auto k_tile = [&](int it) { return has_seg ? list[it] : it; };
  auto load_stage = [&](int it) {
    const int k0 = k_tile(it) * BN, st = it % S;
    cp_tile<BN, D, kWgmma>(Ks(st), a.k + kv_base, k0, T, tid);
    cp_tile<BN, D, kWgmma>(Vs(st), a.v + kv_base, k0, T, tid);
    if (has_seg && tid < BN) {
      const bool ok = k0 + tid < T;
      cp_async4(&kseg_s[st * BN + tid], a.k_seg + (size_t)b * T + (ok ? k0 + tid : 0), ok);
    }
  };
  cp_tile<kTile, D, kWgmma>(Qs, a.q + q_base, q0, T, tid);   // Q and dO: a group before the
  cp_tile<kTile, D, kWgmma>(dOs, a.dout + q_base, q0, T, tid);   // stages'
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_list) load_stage(st);
    cp_async_commit();
  }

  const float lse0 = r0 < T ? a.lse[row_base + r0] * kLog2e : 0.f;
  const float lse1 = r1 < T ? a.lse[row_base + r1] * kLog2e : 0.f;
  const float delta0 = r0 < T ? a.delta[row_base + r0] : 0.f;
  const float delta1 = r1 < T ? a.delta[row_base + r1] : 0.f;
  const int qseg0 = has_seg && r0 < T ? a.q_seg[(size_t)b * T + r0] : 0;
  const int qseg1 = has_seg && r1 < T ? a.q_seg[(size_t)b * T + r1] : 0;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
  if constexpr (kWgmma) {                   // set before any wgmma_fence, as in dkdv128
    fence_regs(reinterpret_cast<float(&)[D / 2]>(acc));
    fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
    fence_regs(reinterpret_cast<float(&)[BN / 2]>(dp));
  }

  for (int it = 0; it < n_list; ++it) {
    cp_async_wait<S - 2>();                 // this tile (and Q, dO) have landed
    if constexpr (kWgmma) fence_async_smem();
    __syncthreads();                        // ... for every thread; the last stage is free
    if (it + S - 1 < n_list) load_stage(it + S - 1);
    cp_async_commit();
    const int st = it % S, k0 = k_tile(it) * BN;
    const __nv_bfloat16* Kt = Ks(st);
    const __nv_bfloat16* Vt = Vs(st);
    const int* kseg_t = kseg_s + st * BN;

    // S = Q K^T and dP = dO V^T for the 64 rows x BN keys: wgmma from the
    // swizzled tiles (the column halves in order), or mma.sync per warp's 16
    // rows, where one ldmatrix gives the B fragments of keys 8 j.. of two
    // 16-deep k steps
    if constexpr (kWgmma) {
      float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
      float(&dpf)[32] = reinterpret_cast<float(&)[32]>(dp);
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        const uint64_t q_ = sw128_desc(Qs + hh * kTile * 64), k_ = sw128_desc(Kt + hh * BN * 64);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(sf, q_ + 2 * kk, k_ + 2 * kk, hh + kk);
      }
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        const uint64_t do_ = sw128_desc(dOs + hh * kTile * 64), v_ = sw128_desc(Vt + hh * BN * 64);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(dpf, do_ + 2 * kk, v_ + 2 * kk, hh + kk);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sf);
      fence_regs(dpf);
    } else {
      // the A fragments of two k steps read from the padded Q and dO tiles
      // at a time (the order of each sum unchanged)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll 2
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t qf[2][4], df[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          load_a(qf[u], Qs, kStride, warp * 16, (kk + u) * 16, g, t4);
          load_a(df[u], dOs, kStride, warp * 16, (kk + u) * 16, g, t4);
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int off = (j * 8 + (lane & 7)) * kStride + kk * 16 + (lane >> 3) * 8;
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, Kt + off);
          ldsm_x4(vb, Vt + off);
          mma_16816(s[j], qf[0], kb[0], kb[1]);
          mma_16816(s[j], qf[1], kb[2], kb[3]);
          mma_16816(dp[j], df[0], vb[0], vb[1]);
          mma_16816(dp[j], df[1], vb[2], vb[3]);
        }
      }
    }

    // dS = P (dP - delta) * scale, P masked exactly to 0
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int kj0 = j * 8 + 2 * t4;
      const int2 ks = has_seg ? *reinterpret_cast<const int2*>(kseg_t + kj0) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kj0 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        bool ok = key < T && row < T && (!a.causal || key <= row);
        if (has_seg) ok = ok && ((e & 1) ? ks.y : ks.x) == (e < 2 ? qseg0 : qseg1);
        const float x = s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1);
        const float p = fast_exp2(ok ? x : -INFINITY);
        s[j][e] = p * (dp[j][e] - (e < 2 ? delta0 : delta1)) * a.sm_scale;
      }
    }

    // dQ += dS K: the k index is the key. wgmma takes dS from registers
    // and K as an MN-major B (m64n64k16 at d = 64, m64n128k16 over both
    // column halves at d = 128); mma.sync reads K with a transposing
    // ldmatrix, two 8-wide column blocks at a time
    uint32_t sa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      sa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    if constexpr (kWgmma) {
      float(&accf)[D / 2] = reinterpret_cast<float(&)[D / 2]>(acc);
      fence_regs(sa);
      wgmma_fence();
      if constexpr (D == 64) {
        const uint64_t k_ = sw128_desc(Kt);
#pragma unroll   // k16 steps of the keys: 16 rows of 128 bytes each
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(accf, sa[kk], k_ + kk * kDescRows16);
      } else {
        const uint64_t k_ = sw128_desc_mn(Kt, BN * 128);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_mn(accf, sa[kk], k_ + kk * kDescRows16);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(accf);
    } else {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t kb[4];
          ldsm_x4_t(kb, Kt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kStride +
                            (n + (lane >> 4)) * 8);
          mma_16816(acc[n], sa[kk], kb[0], kb[1]);
          mma_16816(acc[n + 1], sa[kk], kb[2], kb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* o_r0 = a.dq + q_base + (size_t)r0 * D;
  __nv_bfloat16* o_r1 = a.dq + q_base + (size_t)r1 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < T) *reinterpret_cast<__nv_bfloat162*>(o_r0 + c) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r1 < T) *reinterpret_cast<__nv_bfloat162*>(o_r1 + c) = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// ----------------------------------------------------------------- launch --

// prep: delta, and the segment-range tables
template <int D>
cudaError_t launch_prep(const BwdArgs& a, const __nv_bfloat16* out, float* delta, cudaStream_t s) {
  const int rows = a.B * a.H * a.T, per_block = 256 / (D / 8);
  const int n_delta = (rows + per_block - 1) / per_block;
  const int n_ranges = a.ranges != nullptr ? (2 * a.B * a.n_blk + 7) / 8 : 0;
  flash_bwd_prep_kernel<D><<<n_delta + n_ranges, 256, 0, s>>>(
      out, a.dout, delta, rows, a.q_seg, a.k_seg, const_cast<int4*>(a.ranges), a.B, a.T,
      a.n_blk);
  return cudaGetLastError();
}

// dkdv: clusters of C CTAs along x, KT keys a CTA
template <typename Kernel, typename... Args>
cudaError_t launch_dkdv(Kernel kernel, const BwdArgs& a, int C, int KT, int threads,
                        size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * C, a.B, (a.T + KT - 1) / KT);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args..., a);
}

template <int D, int BN, bool kWgmma>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t s) {
  const dim3 grid(a.H, a.B, (a.T + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D, BN, kWgmma><<<grid, kThreads, QSmem<D, BN, kWgmma>::bytes(a.T), s>>>(a);
  return cudaGetLastError();
}

// d = 64 and 256: one warpgroup a dkdv CTA of KT keys
template <int D, int BQ, bool kWgmma, int BN, int KT>
cudaError_t launch(const BwdArgs& a, const __nv_bfloat16* out, float* delta, cudaStream_t s) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkdv_kernel<D, BQ, kWgmma, KT>, kv_configured, dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<D, BN, kWgmma>, q_configured, dev);
  if (err != cudaSuccess) return err;
  err = launch_prep<D>(a, out, delta, s);
  if (err != cudaSuccess) return err;
  err = launch_dkdv(flash_bwd_dkdv_kernel<D, BQ, kWgmma, KT>, a, a.H / a.Hkv / a.walk, KT,
                    kThreads, KvSmem<D, BQ, kWgmma, KT>::bytes(a.T), s);
  if (err != cudaSuccess) return err;
  return launch_dq<D, BN, kWgmma>(a, s);
}

// d = 128: the warp-specialised dkdv CTA of 128 keys, its ring fed by TMA
// through 3-D tensor maps ([B H or B Hkv][T][128], boxes of 32 (Q, dO) or 64
// (K, V) rows x 64 columns, zeros past T), encoded on the host for every
// call (no device work)
cudaError_t launch128(const BwdArgs& a, const __nv_bfloat16* out, float* delta, cudaStream_t s) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // CTAs a kv group (1 to 8, a cluster): enough for the grid to give every
  // SM a CTA, and enough that no CTA takes more than kRowsPerCta of the
  // group's G x T (head, query) rows (its longest CTA bounds the launch).
  // One CTA takes all of a group's steps where that holds, so no cross-CTA
  // sum is paid. On the card (NVIDIA H100 80GB HBM3, 700 W) it picks, at
  // each d = 128 shape of chip_smoke.py's phase 3b, the fastest of the C
  // that one, two or four waves of CTAs would give.
  constexpr long long kRowsPerCta = 8192;
  const long long tiles = (long long)a.Hkv * a.B * ((a.T + kKT128 - 1) / kKT128);
  const long long rows = (long long)(a.H / a.Hkv) * a.T;
  const long long fill = (sms + tiles - 1) / tiles, split = (rows + kRowsPerCta - 1) / kRowsPerCta;
  const int C = (int)std::min<long long>(kMaxCluster, std::max({1LL, fill, split}));
  err = allow_smem(flash_bwd_dkdv128_kernel, kv_configured, dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<128, 64, true>, q_configured, dev);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, domap, kmap, vmap;
  const int bh = a.B * a.H, bhkv = a.B * a.Hkv;
  if ((err = tmap_bf16_sw128_3d(&qmap, a.q, bh, a.T, 128, kBQ128)) != cudaSuccess) return err;
  if ((err = tmap_bf16_sw128_3d(&domap, a.dout, bh, a.T, 128, kBQ128)) != cudaSuccess) return err;
  if ((err = tmap_bf16_sw128_3d(&kmap, a.k, bhkv, a.T, 128, 64)) != cudaSuccess) return err;
  if ((err = tmap_bf16_sw128_3d(&vmap, a.v, bhkv, a.T, 128, 64)) != cudaSuccess) return err;
  err = launch_prep<128>(a, out, delta, s);
  if (err != cudaSuccess) return err;
  err = launch_dkdv(flash_bwd_dkdv128_kernel, a, C, kKT128, kThreads128, Kv128Smem::bytes(a.T),
                    s, qmap, domap, kmap, vmap);
  if (err != cudaSuccess) return err;
  return launch_dq<128, 64, true>(a, s);
}

}  // namespace

// Floats of scratch the caller provides: delta [B, H, T] (rounded up to a
// multiple of 4), then the segment-range tables, 2 x B x ceil(T / 32) int4s.
extern "C" long long slamkit_flash_bwd_scratch_floats(int B, int H, int T) {
  const long long rows = (long long)B * H * T;
  return (rows + 3) / 4 * 4 + 8LL * B * ((T + kBlock - 1) / kBlock);
}

// Plain C entry, bound with ctypes. q, out, dout [B,H,T,D], k/v [B,Hkv,T,D]
// bf16 and contiguous; lse [B,H,T] f32 (natural log, +1e30 on dead rows);
// q_seg / k_seg [B,T] int32 or both null; dq [B,H,T,D], dk/dv [B,Hkv,T,D]
// bf16; scratch: slamkit_flash_bwd_scratch_floats(B, H, T) floats. Launches
// the prep, dkdv and dq kernels on `stream`; returns the first launch error.
extern "C" int slamkit_flash_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const float* lse,
                                      const int* q_seg, const int* k_seg, void* dq, void* dk,
                                      void* dv, float* scratch, int B, int H, int Hkv, int T,
                                      int D, float sm_scale, int causal, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (k_seg == nullptr)) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = reinterpret_cast<const __nv_bfloat16*>(q);
  a.k = reinterpret_cast<const __nv_bfloat16*>(k);
  a.v = reinterpret_cast<const __nv_bfloat16*>(v);
  a.dout = reinterpret_cast<const __nv_bfloat16*>(dout);
  a.lse = lse;
  a.delta = scratch;
  a.q_seg = q_seg;
  a.k_seg = k_seg;
  a.n_blk = (T + kBlock - 1) / kBlock;
  a.ranges = q_seg == nullptr ? nullptr
             : reinterpret_cast<const int4*>(scratch + ((long long)B * H * T + 3) / 4 * 4);
  a.dq = reinterpret_cast<__nv_bfloat16*>(dq);
  a.dk = reinterpret_cast<__nv_bfloat16*>(dk);
  a.dv = reinterpret_cast<__nv_bfloat16*>(dv);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.walk = (H / Hkv) / cluster_size(H / Hkv);
  a.causal = causal;
  a.sm_scale = sm_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* o = reinterpret_cast<const __nv_bfloat16*>(out);
  if (D == 64) return (int)launch<64, 64, true, 64, 64>(a, o, scratch, s);
  if (D == 128) return (int)launch128(a, o, scratch, s);
  // d = 256: half as many keys a dkdv CTA, each warp holding half of the
  // columns, mma.sync
  if (D == 256) return (int)launch<256, 32, false, 32, 32>(a, o, scratch, s);
  return (int)cudaErrorInvalidValue;
}
