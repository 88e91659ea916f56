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
//   * decode (M <= 16 rows, the decode batch): a weight-bandwidth-bound GEMV,
//     ~2 flops per weight byte against the card's ~295 per byte. One CTA of 8
//     warps owns 128 columns and a slice of K; lane l reads 4 consecutive
//     columns as one 4-byte load (a warp reads 128 contiguous bytes of a q
//     row), warps take interleaved rows. The x rows of the slice sit in
//     shared memory as f32. K is split so that ~2 CTAs per SM stream weights
//     even at N = 128 (the k/v projections), and the split is summed by a
//     second, deterministic pass (fixed order, no atomics).
//   * prefill (M = B * L0 rows): enough rows to want the tensor cores. One
//     CTA per 64 x 64 output tile streams 32-deep k tiles: x as bf16, q
//     dequantized to bf16 into shared memory, mma.sync m16n8k16 (gemm_tile.cuh).
//   * ragged M and N are masked in the kernel; K must be a multiple of 8 (the
//     16-byte x loads), which the wrapper checks.
// Left for later work: wgmma with a TMA pipeline for the prefill, 16-byte
// q loads and a fused split-K reduction for the decode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 128;          // 32 lanes x 4 columns
constexpr int kMaxChunk = 512;          // K rows staged per CTA
constexpr int kMaxRows = 16;            // the GEMV path's M

__device__ __forceinline__ float int8_at(uint32_t w, int j) {
  return (float)(int8_t)((w >> (8 * j)) & 0xffu);
}

// One CTA: columns [128 blockIdx.x, +128), K rows [kchunk blockIdx.y, +kchunk).
template <int MT, bool kVecN>
__global__ void __launch_bounds__(kGemvThreads)
dq_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
               const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ y,
               float* __restrict__ work, int M, int K, int N, int kchunk, int split) {
  __shared__ float xs[MT * kMaxChunk];
  __shared__ float red[MT * kGemvCols];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k_begin = blockIdx.y * kchunk;
  const int klen = min(K, k_begin + kchunk) - k_begin;
  for (int i = tid; i < M * klen; i += kGemvThreads) {
    const int m = i / klen, kk = i - m * klen;
    xs[m * kMaxChunk + kk] = __bfloat162float(x[(size_t)m * K + k_begin + kk]);
  }
  __syncthreads();

  const int n = blockIdx.x * kGemvCols + lane * 4;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

#pragma unroll 4
  for (int kk = warp; kk < klen; kk += kGemvWarps) {
    const int8_t* row = q + (size_t)(k_begin + kk) * N;
    uint32_t w = 0u;
    if (kVecN) {
      if (n < N) w = *reinterpret_cast<const uint32_t*>(row + n);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n + j < N) w |= (uint32_t)(uint8_t)row[n + j] << (8 * j);
      }
    }
    const float w0 = int8_at(w, 0), w1 = int8_at(w, 1), w2 = int8_at(w, 2),
                w3 = int8_at(w, 3);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const float xv = xs[m * kMaxChunk + kk];
        acc[m][0] += xv * w0;
        acc[m][1] += xv * w1;
        acc[m][2] += xv * w2;
        acc[m][3] += xv * w3;
      }
    }
  }

  // sum the 8 warps' partials in a fixed order
  for (int w = 0; w < kGemvWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* r = &red[m * kGemvCols + lane * 4 + j];
            *r = (w == 0 ? 0.f : *r) + acc[m][j];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < M * kGemvCols; i += kGemvThreads) {
    const int m = i / kGemvCols, c = i - m * kGemvCols;
    const int col = blockIdx.x * kGemvCols + c;
    if (col >= N) continue;
    const float v = red[i];
    if (split == 1) {
      y[(size_t)m * N + col] = __float2bfloat16_rn(v * __bfloat162float(s[col]));
    } else {
      work[((size_t)blockIdx.y * M + m) * N + col] = v;
    }
  }
}

// Second pass of a split K: y = bf16(sum over the splits, in order, * s).
__global__ void dq_splitk_reduce(const float* __restrict__ work,
                                 const __nv_bfloat16* __restrict__ s,
                                 __nv_bfloat16* __restrict__ y, int M, int N, int split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float acc = 0.f;
  for (int p = 0; p < split; ++p) acc += work[(size_t)p * total + i];
  y[i] = __float2bfloat16_rn(acc * __bfloat162float(s[i % N]));
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

template <int MT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int8_t* q, const __nv_bfloat16* s,
                        __nv_bfloat16* y, float* work, int M, int K, int N, int kchunk,
                        int split, cudaStream_t st) {
  const dim3 grid((N + kGemvCols - 1) / kGemvCols, split);
  if (N % 4 == 0) {
    dq_gemv_kernel<MT, true><<<grid, kGemvThreads, 0, st>>>(x, q, s, y, work, M, K, N,
                                                           kchunk, split);
  } else {
    dq_gemv_kernel<MT, false><<<grid, kGemvThreads, 0, st>>>(x, q, s, y, work, M, K, N,
                                                            kchunk, split);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. x [M, K] bf16, q [K, N] int8, s [N] bf16,
// y [M, N] bf16, all contiguous; K a multiple of 8. M <= 16 takes the GEMV
// path with K split into chunks of `kchunk` rows (a multiple of 8, at most
// 512): `work` holds ceil(K / kchunk) * M * N floats when that is more than
// one chunk, and may be null otherwise. Larger M takes the tensor-core path
// (kchunk and work unused). Launches on `stream`; returns cudaGetLastError().
extern "C" int slamkit_dq_matmul_bf16(const void* x, const void* q, const void* s, void* y,
                                      float* work, int M, int K, int N, int kchunk,
                                      void* stream) {
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
  if (kchunk <= 0 || kchunk > kMaxChunk || kchunk % 8 != 0) return (int)cudaErrorInvalidValue;
  const int split = (K + kchunk - 1) / kchunk;
  if (split > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (M <= 4) {
    err = launch_gemv<4>(xp, qp, sp, yp, work, M, K, N, kchunk, split, st);
  } else if (M <= 8) {
    err = launch_gemv<8>(xp, qp, sp, yp, work, M, K, N, kchunk, split, st);
  } else {
    err = launch_gemv<16>(xp, qp, sp, yp, work, M, K, N, kchunk, split, st);
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t total = (size_t)M * N;
  dq_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(work, sp, yp, M, N, split);
  return (int)cudaGetLastError();
}
