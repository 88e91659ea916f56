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
//   * prefill (M = B * L0 rows): enough rows to want the tensor cores. One
//     CTA per 64 x 64 output tile streams 32-deep k tiles: x as bf16, q
//     dequantized to bf16 into shared memory, mma.sync m16n8k16 (gemm_tile.cuh).
//   * ragged M and N are masked in the kernel; K must be a multiple of 8 (the
//     16-byte x loads), which the wrapper checks.
// Left for later work: wgmma with a TMA pipeline for the prefill.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 16;            // the GEMV path's M
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kMaxSplit = 8;            // the portable cluster size

// The cluster barrier split in two: every thread arrives at the kernel's
// entry and waits just before its first write to another CTA's shared
// memory, which is allowed only once every CTA of the cluster has started.
// The k loop runs between the two, so the wait costs almost nothing.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float int8_at(uint32_t w, int j) {
  return (float)(int8_t)((w >> (8 * j)) & 0xffu);
}

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
    gemm_tile::mma_16816(acc[j], st.xa, b0, b1);
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

// One CTA per 64 x 64 tile of y.
template <bool kVecN>
__global__ void __launch_bounds__(gemm_tile::kThreads)
dq_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
               const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ y,
               int M, int K, int N) {
  using namespace gemm_tile;
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK * kBStride];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[2][4][4];
  zero(acc);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();                     // the previous tile's readers are done
    // x tile: 64 rows x 32 halves, 16 bytes a thread twice
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, col = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M && k0 + col < K) {
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 + col);
      }
      *reinterpret_cast<uint4*>(&As[row * kAStride + col]) = v;
    }
    // q tile: 32 rows x 64 bytes, 16 bytes a thread, dequantized to bf16
    {
      const int row = tid >> 2, col = (tid & 3) * 16;
      const int kr = k0 + row;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (kr < K) {
        const int8_t* src = q + (size_t)kr * N + n0 + col;
        if (kVecN) {
          if (n0 + col < N) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (n0 + col + j < N) w[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
          }
        }
      }
      uint32_t deq[8];                   // 16 bf16, two per word
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        deq[j] = pack_bf16_raw(__float2bfloat16_rn(int8_at(w[j >> 1], (2 * j) & 3)),
                               __float2bfloat16_rn(int8_at(w[j >> 1], (2 * j + 1) & 3)));
      }
      *reinterpret_cast<uint4*>(&Bs[row * kBStride + col]) =
          make_uint4(deq[0], deq[1], deq[2], deq[3]);
      *reinterpret_cast<uint4*>(&Bs[row * kBStride + col + 8]) =
          make_uint4(deq[4], deq[5], deq[6], deq[7]);
    }
    __syncthreads();
    mma_k32(As, Bs, acc, warp, lane);
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + acc_row(warp, lane, mi, e);
        const int col = n0 + acc_col(warp, lane, ni, e);
        if (row < M && col < N) {
          y[(size_t)row * N + col] =
              __float2bfloat16_rn(acc[mi][ni][e] * __bfloat162float(s[col]));
        }
      }
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
  if (M > kMaxRows) {
    const dim3 grid((N + gemm_tile::kBN - 1) / gemm_tile::kBN,
                    (M + gemm_tile::kBM - 1) / gemm_tile::kBM);
    if (N % 16 == 0) {
      dq_gemm_kernel<true><<<grid, gemm_tile::kThreads, 0, st>>>(xp, qp, sp, yp, M, K, N);
    } else {
      dq_gemm_kernel<false><<<grid, gemm_tile::kThreads, 0, st>>>(xp, qp, sp, yp, M, K, N);
    }
    return (int)cudaGetLastError();
  }
  const cudaError_t err = M <= 8 ? launch_gemv<8>(xp, qp, sp, yp, M, K, N, st)
                                  : launch_gemv<16>(xp, qp, sp, yp, M, K, N, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
