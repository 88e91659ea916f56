// Contraction-cost probe for Hopper (sm_90a): out [M, N] f32 = sum over `reps`
// repetitions of a [M, K] . b [K, N], bf16 in, f32 accumulation.
//
// Replaces: scripts/bench_flash.py::matmul_probe (its Pallas body `kern` :98),
// which asked the TPU whether a d = 64 contraction costs half of d = 128. The
// same question here, of mma.sync m16n8k16: S = Q K^T contracts over the head
// dim (K = 64 vs 128), O = P V produces it (N = 64 vs 128).
//
// What bounds it: the tensor cores' issue rate and the shared-memory traffic
// that feeds them. The Pallas probe held both operands whole in VMEM; a CTA
// cannot (at K = 1024 a 64-row slab of a and a 64-column slab of b are 128 KB
// each), so each CTA streams 32-deep k tiles of its 64 x 64 output tile through
// shared memory (gemm_tile.cuh) and keeps the sum in registers across the
// repetitions; after the first repetition the tiles come from L2. At N = 64
// the grid has M / 64 CTAs, fewer than the card's 132 SMs: the N probes
// measure that as well as the product.
// Shapes: M and N multiples of 64, K a multiple of 32 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

__global__ void __launch_bounds__(gemm_tile::kThreads)
matmul_probe_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                    float* __restrict__ out, int K, int N, int reps) {
  using namespace gemm_tile;
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK * kBStride];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[2][4][4];
  zero(acc);

  for (int r = 0; r < reps; ++r) {
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {      // a tile: 64 x 32 halves
        const int c = tid + i * kThreads;
        const int row = c >> 2, col = (c & 3) * 8;
        *reinterpret_cast<uint4*>(&As[row * kAStride + col]) =
            *reinterpret_cast<const uint4*>(a + (size_t)(m0 + row) * K + k0 + col);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {      // b tile: 32 x 64 halves
        const int c = tid + i * kThreads;
        const int row = c >> 3, col = (c & 7) * 8;
        *reinterpret_cast<uint4*>(&Bs[row * kBStride + col]) =
            *reinterpret_cast<const uint4*>(b + (size_t)(k0 + row) * N + n0 + col);
      }
      __syncthreads();
      mma_k32(As, Bs, acc, warp, lane);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[(size_t)(m0 + acc_row(warp, lane, mi, e)) * N + n0 + acc_col(warp, lane, ni, e)] =
            acc[mi][ni][e];
      }
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes. a [M, K] and b [K, N] bf16, out [M, N]
// f32, all contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int slamkit_matmul_probe_bf16(const void* a, const void* b, float* out,
                                         int M, int K, int N, int reps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || reps <= 0 || M % gemm_tile::kBM != 0 ||
      N % gemm_tile::kBN != 0 || K % gemm_tile::kBK != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(N / gemm_tile::kBN, M / gemm_tile::kBM);
  matmul_probe_kernel<<<grid, gemm_tile::kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(a), reinterpret_cast<const __nv_bfloat16*>(b), out,
      K, N, reps);
  return (int)cudaGetLastError();
}
