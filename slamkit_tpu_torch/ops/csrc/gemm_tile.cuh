// A 64 x 64 output tile of a bf16 matrix product on the tensor cores, used
// by matmul_probe.cu.
//
// Four warps (128 threads) own one tile; warp w computes rows 32 (w / 2) ..
// +31 and columns 32 (w % 2) .. +31 with mma.sync m16n8k16 (bf16 in, f32
// accumulate), 2 x 4 instructions per 16-deep step. A k tile of 32 is staged
// by the caller in shared memory:
//   As [64][kAStride]  bf16, row major (m, k): fragments read as 32-bit pairs;
//   Bs [32][kBStride]  bf16, row major (k, n): fragments read as two halves of
//                      neighbouring rows, as the flash kernels read V.
// Both strides are padded by 8 halves so the fragment reads of a warp fall in
// distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace gemm_tile {

using hopper::mma_16816;
using hopper::pack_bf16_raw;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 8;   // halves
constexpr int kBStride = kBN + 8;   // halves

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += As[warp rows, 0:32] * Bs[0:32, warp cols]
__device__ __forceinline__ void mma_k32(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                        float (&acc)[2][4][4], int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* ar = As + (wm + mi * 16 + g) * kAStride + kk * 16 + 2 * t4;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(ar);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kAStride);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kAStride + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* bp = Bs + (kk * 16 + 2 * t4) * kBStride + wn + ni * 8 + g;
      const uint32_t b0 = pack_bf16_raw(bp[0], bp[kBStride]);
      const uint32_t b1 = pack_bf16_raw(bp[8 * kBStride], bp[9 * kBStride]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// Where accumulator element e of (mi, ni) lands in the 64 x 64 tile.
__device__ __forceinline__ int acc_row(int warp, int lane, int mi, int e) {
  return (warp >> 1) * 32 + mi * 16 + (lane >> 2) + (e < 2 ? 0 : 8);
}
__device__ __forceinline__ int acc_col(int warp, int lane, int ni, int e) {
  return (warp & 1) * 32 + ni * 8 + 2 * (lane & 3) + (e & 1);
}

}  // namespace gemm_tile
