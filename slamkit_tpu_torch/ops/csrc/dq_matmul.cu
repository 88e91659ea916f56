// int8 weight-only matrix product for Hopper (sm_90a):
//   y [M, N] = bf16( (x [M, K] . q [K, N]) * s [N] )
// x bf16, q int8 (per-output-column symmetric), s bf16, f32 accumulation.
//
// Replaces: slamkit_tpu/ops/quant.py::_dq_kernel (launched by dq_matmul :51).
// As there, the int8 weight is dequantized on chip: the bf16 weight never
// exists in device memory, each int8 byte is read from it once, and the scale
// multiplies the f32 sum once, in the epilogue (`acc * s`, quant.py:48).
// Every int8 value is exact in bf16 and in f32, so the products are exact.
//
// What bounds it on the H100, and what the design does about it:
//   * decode (M <= 16 rows, the decode batch): a GEMV bound by the int8
//     weight's bytes (~2 M flops per weight byte against the card's ~295 per
//     byte). At the Slam widths a projection's weight is 0.1-4.4 MB, so the
//     whole card has to keep most of it in flight at once, and every serial
//     phase of a CTA (staging, reductions, synchronisation) shows in the
//     time. The design:
//       - Lane (g, t4) of a warp reads 16 consecutive int8 columns (8 when
//         the panels must be narrow) of four q rows, 2 t4, 2 t4 + 1,
//         2 t4 + 8, 2 t4 + 9 of a 16-deep k step, with 16-byte loads: a
//         warp reads 16 rows x 128 contiguous bytes a step. Those four bytes
//         of one column are exactly the column's k pairs of an mma.sync
//         m16n8k16 B fragment, so column j of the lane's 16 feeds the j-th
//         of 16 tensor-core products (n = g labels column 16 n + j), with x
//         (M <= 16 rows, zero-padded) as the A fragment read from L2. The
//         tensor cores do the multiply-adds; a lane keeps 64 f32 sums.
//       - int8 -> bf16 is exact and takes no conversion instruction: a byte
//         permute puts b ^ 0x80 under the exponent of 2^23, one subtraction
//         leaves b as f32, and its upper half is b in bf16.
//       - A CTA of 8 warps owns a panel of 128 (or 64) columns and a slice of
//         K; its warps take interleaved k steps, each loading the next step
//         while it multiplies the current one. K is split further across the
//         CTAs of a thread-block cluster (at most 8, the portable size).
//       - The 8 warps' sums are added in a fixed order in shared memory and
//         written straight into the shared memory of the cluster's CTA that
//         finishes them (distributed shared memory, one slot a sender, once
//         a barrier arrived at on entry shows every CTA of the cluster has
//         started); after one cluster barrier every CTA adds its share's
//         slots in rank order, scales them once and writes y. One launch, no
//         workspace, no atomics: bitwise deterministic.
//   * prefill (M = B * L0 rows, 17 and more): bound by operations (at M =
//     1024 and the Slam widths ~2 M / (1 + 2 M / N) flops a byte moved, far
//     above the card's ~295). The design computes y^T = q^T x^T:
//       - the weight is the A operand of wgmma, dequantized in registers: a
//         thread owns two neighbouring columns of y (its wgmma rows g and
//         g + 8), so one 16-bit shared-memory read of a q row gives both,
//         four reads a 16-deep k step, and the GEMV's byte permute turns
//         them into the A fragment with no conversion instruction;
//       - x, K-major as it lies in memory, is the shared-memory B operand,
//         its rows the product's N (128 or 64, one instruction);
//       - one CTA per 64 columns x 128 rows of y (x 64 rows at M <= 64). Its
//         KW warpgroups take every KW-th 64-deep k step, and their sums are
//         added in warpgroup order at the end: one pass over K in a fixed
//         order, no split across CTAs, y bitwise deterministic. KW = 2 and
//         two CTAs an SM where the grid outnumbers the SMs; else KW = 4 and
//         one CTA an SM, so that every SM still runs four warpgroups;
//       - a ring of 2 KW stages, two for each warpgroup, which loads its own
//         steps' tiles: the x tiles by TMA (one thread, an mbarrier a stage,
//         zeros past M and K), the raw int8 q tiles by cp.async. A warpgroup
//         waits only on its own barrier, so the warpgroups drift apart and
//         one builds its fragments while another's products run; each loads
//         its next step while it multiplies this one;
//       - the scale multiplies each f32 sum once, and y's tile is staged in
//         shared memory so its stores are 16 bytes wide and coalesced.
//     The other way, dequantizing into a swizzled bf16 tile in shared memory
//     for wgmma with both operands there, was measured first on the card:
//     it moved ~112 KB through shared memory a 128 x 128 x 64 step against
//     ~64 KB with the weight in registers, and ran the up/gate product at
//     ~46 us against ~35.
//   * ragged M and N are masked in the kernel; K must be a multiple of 8 (the
//     16-byte x loads), which the wrapper checks.
// Tried on the card and left out (PERF.md §6): a cp.async ring for x as
// well (slower than TMA), 128-column tiles and one warpgroup on K (slower
// at the down projection), deeper rings (no gain while a CTA barrier held
// the warpgroups in step), pairs of CTAs in a cluster sharing x's tiles by
// TMA multicast (slower: a cluster barrier or an empty-stage mbarrier a
// step couples the pair), and the next step's fragments built while this
// step's products run (ptxas then serializes every wgmma of the kernel).
// Clock stamps in the k loop on the card showed a step's products taking a
// small part of the step while a CTA barrier a step made the warpgroups build
// their fragments, and then multiply, all at the same time: a barrier for
// each warpgroup cured it. Left for later work: TMA for q and a persistent
// grid to spread the tiles over the SMs evenly.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int kMaxRows = 16;            // the GEMV path's M
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kMaxSplit = 8;            // the portable cluster size

// Byte j of u = w ^ 0x80808080 (the int8 b as b + 128) -> the f32 bits of b:
// the byte becomes the low mantissa byte of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ uint32_t f32_bits_of_int8(uint32_t u, int j) {
  return __float_as_uint(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 | j)) -
                         8388736.f);
}

// CPL int8 columns [col0, col0 + CPL) of q row r as CPL / 4 words, zeros
// past K or N
template <int CPL, bool kVec>
__device__ __forceinline__ void load_q(uint32_t (&w)[CPL / 4], const int8_t* __restrict__ q,
                                       int r, int K, int N, int col0) {
#pragma unroll
  for (int i = 0; i < CPL / 4; ++i) w[i] = 0u;
  if (r >= K || col0 >= N) return;
  const int8_t* p = q + (size_t)r * N + col0;
  if constexpr (kVec && CPL == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (kVec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (col0 + j < N) w[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
    }
  }
}

// The operands of one 16-deep k step at k0: the lane's four q rows and its
// A fragment of x (rows g and g + 8, k pairs 2 t4 and 2 t4 + 8; zero rows
// past M, zero k past K).
template <int CPL>
struct Step {
  uint32_t w[4][CPL / 4];
  uint32_t xa[4];
};

template <int CPL, bool kVec>
__device__ __forceinline__ void load_step(Step<CPL>& st, const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ q, int k0, int M, int K,
                                          int N, int col0, int g, int t4) {
  const int ka = k0 + 2 * t4, kb = ka + 8;
  load_q<CPL, kVec>(st.w[0], q, ka, K, N, col0);
  load_q<CPL, kVec>(st.w[1], q, ka + 1, K, N, col0);
  load_q<CPL, kVec>(st.w[2], q, kb, K, N, col0);
  load_q<CPL, kVec>(st.w[3], q, kb + 1, K, N, col0);
  auto xw = [&](int m, int k) {
    return m < M && k < K ? __ldg(reinterpret_cast<const uint32_t*>(x + (size_t)m * K + k)) : 0u;
  };
  st.xa[0] = xw(g, ka);
  st.xa[1] = xw(g + 8, ka);
  st.xa[2] = xw(g, kb);
  st.xa[3] = xw(g + 8, kb);
}

// acc[j] += x (16 x 16) . q (16 x 8 columns: 16 n + j for n = 0..7)
template <int CPL>
__device__ __forceinline__ void mma_step(float (&acc)[CPL][4], const Step<CPL>& st) {
  uint32_t u[4][CPL / 4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i) u[r][i] = st.w[r][i] ^ 0x80808080u;
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int i = j >> 2, b = j & 3;
    // bf16 pairs (rows 2 t4, 2 t4 + 1) and (2 t4 + 8, 2 t4 + 9) of column j:
    // the upper halves of the exact f32 values
    const uint32_t b0 = __byte_perm(f32_bits_of_int8(u[0][i], b), f32_bits_of_int8(u[1][i], b),
                                    0x7632);
    const uint32_t b1 = __byte_perm(f32_bits_of_int8(u[2][i], b), f32_bits_of_int8(u[3][i], b),
                                    0x7632);
    mma_16816(acc[j], st.xa, b0, b1);
  }
}

// One CTA: the PW = 8 CPL columns from PW blockIdx.x, the 16-deep k steps
// [spc blockIdx.y, +spc), its warps taking every 8th; the gridDim.y CTAs of a
// panel form one cluster. Shared memory: the panel's scales [PW] as f32, the
// warps' f32 sums [kGemvWarps][MT][8 CPL + 8] (column CPL n + j of the panel
// at j * 8 + n), then the cluster's sums of the CTA's share [split][per].
template <int MT, int CPL, bool kVec>
__global__ void __launch_bounds__(kGemvThreads, 2)
dq_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
               const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ y,
               int M, int K, int N, int spc) {
  constexpr int PW = 8 * CPL, RS = PW + 8;
  extern __shared__ __align__(16) float scale[];
  float* red = scale + PW;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * PW + g * CPL;
  // the panel's scales load beside the weights; shared memory gets them
  // after the k loop, so no warp waits for them before its first q load
  const bool scales = tid < PW && blockIdx.x * PW + tid < N;
  const __nv_bfloat16 my_scale = scales ? s[blockIdx.x * PW + tid] : __float2bfloat16_rn(0.f);
  const int steps = (K + 15) / 16;
  const int s_end = min(steps, ((int)blockIdx.y + 1) * spc);
  cluster_arrive_relaxed();                // this CTA has started

  float acc[CPL][4];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  Step<CPL> sa, sb;
  int st = blockIdx.y * spc + warp;
  if (st < s_end) load_step<CPL, kVec>(sa, x, q, st * 16, M, K, N, col0, g, t4);
  for (; st < s_end; st += 2 * kGemvWarps) {
    if (st + kGemvWarps < s_end) {
      load_step<CPL, kVec>(sb, x, q, (st + kGemvWarps) * 16, M, K, N, col0, g, t4);
    }
    mma_step<CPL>(acc, sa);
    if (st + kGemvWarps >= s_end) break;
    if (st + 2 * kGemvWarps < s_end) {
      load_step<CPL, kVec>(sa, x, q, (st + 2 * kGemvWarps) * 16, M, K, N, col0, g, t4);
    }
    mma_step<CPL>(acc, sb);
  }

  if (tid < PW) scale[tid] = __bfloat162float(my_scale);
  // this warp's sums: row g (and g + 8), panel columns CPL (2 t4 + e) + j
  float* mine = red + warp * MT * RS;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    *reinterpret_cast<float2*>(&mine[g * RS + j * 8 + 2 * t4]) = make_float2(acc[j][0], acc[j][1]);
    if constexpr (MT == 16) {
      *reinterpret_cast<float2*>(&mine[(g + 8) * RS + j * 8 + 2 * t4]) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  // the warps' sums in order, each straight into the slot for this rank of
  // the CTA that finishes it (CTA o owns the sums [o per, (o + 1) per) of
  // the panel's M x RS), through distributed shared memory
  const int per = (M * RS + split - 1) / split;
  float* gather = red + kGemvWarps * MT * RS;            // [split][per]
  cluster_wait();                          // every CTA of the cluster has started
  for (int idx = tid; idx < M * RS; idx += kGemvThreads) {
    float v = red[idx];
#pragma unroll
    for (int w = 1; w < kGemvWarps; ++w) v += red[w * MT * RS + idx];
    const int owner = idx / per;
    cluster.map_shared_rank(gather, owner)[rank * per + idx - owner * per] = v;
  }
  cluster.sync();                          // every CTA's sums are where they are finished

  // this CTA's share: the split of K summed in rank order, scaled once, to y
  const int end = min(M * RS, (rank + 1) * per);
  for (int idx = rank * per + tid; idx < end; idx += kGemvThreads) {
    const int m = idx / RS, p = idx - m * RS;
    const int col = blockIdx.x * PW + (p % 8) * CPL + p / 8;
    if (p >= PW || col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < split) v += gather[r * per + idx - rank * per];
    }
    y[(size_t)m * N + col] = __float2bfloat16_rn(v * scale[col - blockIdx.x * PW]);
  }
}

// ------------------------------------------------------------- prefill --

// Shared memory of a prefill CTA (a tile of 64 columns by BM rows of y, KW
// warpgroups on K), in bytes from a 1024-aligned base: kStages = 2 KW x tiles
// [BM][64] (bf16, 128-byte swizzled, K-major), kStages raw int8 weight tiles
// [64][64] (rows padded by 16 bytes, so that a warp's 16-bit fragment reads
// fall in distinct banks), the tile's 64 scales as f32 and an mbarrier a
// stage for its x tile's TMA load. The epilogue stages the sums of
// warpgroups 1 .. KW - 1 and then y's tile [BM][64 + 8] (bf16) over the x
// tiles.
template <int BM, int KW>
struct GemmSmem {
  static constexpr int kBN = 64, kBK = 64, kQStride = kBN + 16;
  static constexpr int kStages = 2 * KW;   // two for each warpgroup
  static constexpr int kX = BM * kBK * 2, kQ = kBK * kQStride;
  static constexpr int kQOff = kStages * kX;
  static constexpr int kScale = kQOff + kStages * kQ;
  static constexpr int kBar = kScale + kBN * 4;
  static constexpr int kBytes = 1024 + kBar + kStages * 8;
  static_assert(BM * (kBN + 8) * 2 <= kQOff, "the epilogue's tile must fit the x tiles");
  static_assert((KW - 1) * BM / 2 * 128 * 4 <= kQOff, "the warpgroups' sums must fit the x tiles");
};

// One CTA of KW warpgroups per 64 x BM tile of y^T = q^T x^T: the tile's 64
// columns are the 64 rows of each warpgroup's wgmma, and the BM rows of x are
// the product's N. Thread (warp, g) of a warpgroup owns the two columns
// nl = 2 (8 warp + g) and nl + 1, which are its wgmma rows g and g + 8, so
// that one 16-bit read of a q row gives both. Warpgroup w takes the 64-deep
// k steps w, w + KW, ... through its own two stages of the ring: the x tile
// (TMA, 128-byte swizzled, zeros past M and K, completion counted on the
// stage's mbarrier) and the raw int8 q tile (cp.async) of its next step load
// while it multiplies this one. The warpgroups' sums are added in the order
// of w at the end: one pass over K in a fixed order. For each
// 16-deep k step a thread reads its columns' bytes of four q rows and
// dequantizes them in registers (the GEMV's exact byte permute) into an A
// fragment; wgmma takes A from the registers and x from shared memory
// (K-major B). vec: N is a multiple of 16, so a q chunk is 16 aligned bytes,
// whole or absent; else it is read byte by byte.
template <int BM, int KW>
__global__ void __launch_bounds__(128 * KW)
dq_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ q,
               const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ y,
               int M, int K, int N, int vec) {
  using L = GemmSmem<BM, KW>;
  constexpr int kThr = 128 * KW, kBN = L::kBN, kBK = L::kBK, QS = L::kQStride;
  constexpr int S = L::kStages;
  constexpr int kQChunks = kBK * kBN / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  auto Xs = [&](int st) { return sm + st * L::kX; };
  auto Qs = [&](int st) { return sm + L::kQOff + st * L::kQ; };
  float* scale = reinterpret_cast<float*>(sm + L::kScale);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBar);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int nl = 2 * (8 * warp + g);              // this thread's columns nl, nl + 1
  const int steps = (K + kBK - 1) / kBK;
  for (int i = tid; i < kBN; i += kThr) {
    scale[i] = n0 + i < N ? __bfloat162float(s[n0 + i]) : 0.f;
  }
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) mbar_init(&bar[st], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // step it's tiles, loaded by the warpgroup that multiplies them
  auto load_stage = [&](int it) {
    const int k0 = it * kBK, st = it % S, wtid = tid & 127;
    if (wtid == 0) {                               // x: one TMA box, zeros past M and K
      mbar_expect_tx(&bar[st], L::kX);
      tma_load_2d(Xs(st), &xmap, k0, m0, &bar[st]);
    }
#pragma unroll
    for (int c = wtid; c < kQChunks; c += 128) {   // q: zeros past K and past N
      const int r = c / (kBN / 16), c16 = c % (kBN / 16);
      const int kr = k0 + r, col = n0 + c16 * 16;
      unsigned char* dst = Qs(st) + r * QS + c16 * 16;
      if (vec) {
        const bool ok = kr < K && col < N;
        cp_async16(dst, ok ? q + (size_t)kr * N + col : q, ok);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (kr < K) {
          const int8_t* src = q + (size_t)kr * N + col;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (col + j < N) w[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };
  // The A fragments of step it's four 16-deep k steps: rows g and g + 8 are
  // columns nl and nl + 1, the k pairs (2 t4, 2 t4 + 1) and (2 t4 + 8,
  // 2 t4 + 9); int8 -> bf16 exactly, with no conversion instruction
  auto fragments = [&](uint32_t (&a)[4][4], int it) {
    const unsigned char* qt = Qs(it % S) + nl;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned char* p = qt + (kk * 16 + 2 * t4) * QS;
      auto pair = [&](int row) { return (uint32_t)*reinterpret_cast<const uint16_t*>(p + row * QS); };
      // bytes: (k, nl), (k, nl + 1), (k + 1, nl), (k + 1, nl + 1), each b + 128
      const uint32_t lo = (pair(0) | (pair(1) << 16)) ^ 0x80808080u;
      const uint32_t hi = (pair(8) | (pair(9) << 16)) ^ 0x80808080u;
      a[kk][0] = __byte_perm(f32_bits_of_int8(lo, 0), f32_bits_of_int8(lo, 2), 0x7632);
      a[kk][1] = __byte_perm(f32_bits_of_int8(lo, 1), f32_bits_of_int8(lo, 3), 0x7632);
      a[kk][2] = __byte_perm(f32_bits_of_int8(hi, 0), f32_bits_of_int8(hi, 2), 0x7632);
      a[kk][3] = __byte_perm(f32_bits_of_int8(hi, 1), f32_bits_of_int8(hi, 3), 0x7632);
    }
  };

  float acc[BM / 2];                              // y^T rows nl, nl + 1 x the BM rows of x
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  // Each warpgroup runs its own steps through its own stages (it % S for its
  // steps it), with no barrier but its own: the warpgroups drift apart, so
  // one builds its fragments while another's products run.
  if (wg < steps) load_stage(wg);
  cp_async_commit();
  for (int it = wg; it < steps; it += KW) {
    cp_async_wait<0>();                          // this thread's q copies of step it
    mbar_wait(&bar[it % S], (it / S) & 1);       // its x tile
    warpgroup_sync(wg);                          // ... and the warpgroup's; its other stage is free
    if (it + KW < steps) load_stage(it + KW);
    cp_async_commit();
    uint32_t a[4][4];
    fragments(a, it);
    const uint64_t b_ = sw128_desc(Xs(it % S));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_bk(acc, a[kk], b_ + 2 * kk);
    wgmma_commit();
    // the products finish before the next step's fragments are written: a
    // register written while a wgmma that reads the set is in flight makes
    // ptxas serialize every wgmma of the kernel
    wgmma_wait0();
    fence_regs(a);
  }
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();                               // the x tiles are free
  {                                              // warpgroup 0 adds the others' sums in order
    float* red = reinterpret_cast<float*>(sm);
    const int slot = tid % 128;
    if (wg > 0) {
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) red[((wg - 1) * (BM / 2) + i) * 128 + slot] = acc[i];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int w = 1; w < KW; ++w) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] += red[((w - 1) * (BM / 2) + i) * 128 + slot];
      }
    }
    __syncthreads();
  }

  // y = bf16(acc * s), staged in shared memory so the stores are coalesced;
  // acc[4 j + e] is y^T row nl (e < 2) or nl + 1, x row 8 j + 2 t4 + (e & 1)
  constexpr int kYS = kBN + 8;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(sm);
  const float s0 = scale[nl], s1 = scale[nl + 1];
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int m = 8 * j + 2 * t4;
      *reinterpret_cast<uint32_t*>(ys + m * kYS + nl) = pack_bf16(acc[4 * j] * s0, acc[4 * j + 2] * s1);
      *reinterpret_cast<uint32_t*>(ys + (m + 1) * kYS + nl) =
          pack_bf16(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * (kBN / 8); idx += kThr) {
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const __nv_bfloat16* src = ys + r * kYS + c;
    __nv_bfloat16* dst = y + (size_t)m * N + n;
    if (N % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

int sm_count(int dev) {
  static int cached[64] = {0};
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
    cached[dev] = n;
  }
  return cached[dev];
}

// The decode path: one launch of a (panels, split) grid in clusters of
// (1, split). Panels are 128 columns (16-byte q loads) when that still gives
// >= one CTA per SM once K is split 8 ways, else 64 (8-byte loads); the
// split then aims at the CTAs the SMs hold at once (two each, or one where
// shared memory allows only one), every warp >= one k step.
template <int MT, int CPL, bool kVec>
cudaError_t launch_gemv_t(const __nv_bfloat16* x, const int8_t* q, const __nv_bfloat16* s,
                          __nv_bfloat16* y, int M, int K, int N, int panels, int sms,
                          int dev, cudaStream_t st) {
  constexpr size_t kRowBytes = (8 * CPL + 8) * sizeof(float);
  constexpr size_t kScaleBytes = 8 * CPL * sizeof(float);
  constexpr size_t kMost = kScaleBytes + (kGemvWarps + kMaxSplit) * MT * kRowBytes;
  const int per_sm = kMost <= 113 * 1024 ? 2 : 1;
  const int steps = (K + 15) / 16;
  int split = min(kMaxSplit, max(1, per_sm * sms / panels));
  split = max(1, min(split, steps / kGemvWarps));
  const int spc = (steps + split - 1) / split;
  split = (steps + spc - 1) / spc;
  const size_t smem = kScaleBytes + (kGemvWarps * MT + (size_t)split * M) * kRowBytes;
  // once per device, on the first (eager) call: not inside a graph capture
  static unsigned long long configured = 0;
  if (!((configured >> dev) & 1ull)) {
    const cudaError_t err = cudaFuncSetAttribute(
        dq_gemv_kernel<MT, CPL, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMost);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(panels, split, 1);
  cfg.blockDim = dim3(kGemvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dq_gemv_kernel<MT, CPL, kVec>, x, q, s, y, M, K, N, spc);
}

template <int MT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int8_t* q, const __nv_bfloat16* s,
                        __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(dev);
  const int wide = (N + 127) / 128, narrow = (N + 63) / 64;
  if (wide * kMaxSplit >= sms) {
    if (N % 16 == 0) return launch_gemv_t<MT, 16, true>(x, q, s, y, M, K, N, wide, sms, dev, st);
    return launch_gemv_t<MT, 16, false>(x, q, s, y, M, K, N, wide, sms, dev, st);
  }
  if (N % 8 == 0) return launch_gemv_t<MT, 8, true>(x, q, s, y, M, K, N, narrow, sms, dev, st);
  return launch_gemv_t<MT, 8, false>(x, q, s, y, M, K, N, narrow, sms, dev, st);
}

// x's tensor map with BM-row boxes, encoded once per (x, M, K, BM) and kept
// in a small table: a captured graph replays the map it was given, and the
// calls a capture records find theirs here from the warm-up before it.
cudaError_t x_map(CUtensorMap* map, const __nv_bfloat16* x, int M, int K, int BM) {
  struct Entry {
    const void* x;
    int M, K, BM;
    CUtensorMap map;
  };
  static Entry table[16];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.x == x && e.M == M && e.K == K && e.BM == BM) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = tmap_bf16_sw128(map, x, M, K, BM);
  if (err != cudaSuccess) return err;
  table[next] = Entry{x, M, K, BM, *map};
  next = (next + 1) % 16;
  used = used < 16 ? used + 1 : 16;
  return cudaSuccess;
}

// The prefill path: one CTA per 64 columns x 128 rows of y (x 64 rows at M <=
// 64), chosen on the card (NVIDIA H100 80GB HBM3, 700 W) at the Slam shapes,
// M = 600 and 1024, among 64 and 128 columns by 64 and 128 rows, one
// warpgroup or two on K, and rings of 4-12 stages: this one was among the
// fastest at every shape. Two warpgroups on K and two CTAs an SM where the
// grid has more CTAs than the card has SMs; else, where an SM would hold at
// most one CTA, four warpgroups on K, so that each SM still runs four (on
// the card, faster at the down projection, within a few percent at q/o and
// k/v).
template <int BM, int KW>
cudaError_t launch_gemm_t(const __nv_bfloat16* x, const int8_t* q, const __nv_bfloat16* s,
                          __nv_bfloat16* y, int M, int K, int N, int dev, cudaStream_t st) {
  static unsigned long long configured = 0;
  cudaError_t err = allow_smem(dq_gemm_kernel<BM, KW>, configured, dev);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = x_map(&map, x, M, K, BM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 63) / 64, (M + BM - 1) / BM);
  dq_gemm_kernel<BM, KW><<<grid, 128 * KW, GemmSmem<BM, KW>::kBytes, st>>>(
      map, q, s, y, M, K, N, N % 16 == 0 ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t launch_gemm(const __nv_bfloat16* x, const int8_t* q, const __nv_bfloat16* s,
                        __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int bm = M > 64 ? 128 : 64;
  const bool few = (N + 63) / 64 * ((M + bm - 1) / bm) <= sm_count(dev);
  if (bm == 128) {
    return few ? launch_gemm_t<128, 4>(x, q, s, y, M, K, N, dev, st)
               : launch_gemm_t<128, 2>(x, q, s, y, M, K, N, dev, st);
  }
  return few ? launch_gemm_t<64, 4>(x, q, s, y, M, K, N, dev, st)
             : launch_gemm_t<64, 2>(x, q, s, y, M, K, N, dev, st);
}

}  // namespace

// Plain C entry, bound with ctypes. x [M, K] bf16, q [K, N] int8, s [N] bf16,
// y [M, N] bf16, all contiguous; K a multiple of 8. M <= 16 takes the GEMV
// path, larger M the tensor-core path; either is one launch on `stream`.
// Returns the launch's error (cudaGetLastError()).
extern "C" int slamkit_dq_matmul_bf16(const void* x, const void* q, const void* s, void* y,
                                      int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* xp = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* qp = reinterpret_cast<const int8_t*>(q);
  const auto* sp = reinterpret_cast<const __nv_bfloat16*>(s);
  auto* yp = reinterpret_cast<__nv_bfloat16*>(y);
  if (M > kMaxRows) return (int)launch_gemm(xp, qp, sp, yp, M, K, N, st);
  const cudaError_t err = M <= 8 ? launch_gemv<8>(xp, qp, sp, yp, M, K, N, st)
                                  : launch_gemv<16>(xp, qp, sp, yp, M, K, N, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
