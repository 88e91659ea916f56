// Tile loads shared by the float32 flash kernels (flash_fwd_f32.cu and
// flash_bwd_f32.cu): a [64][D] row-major slab of a [T][D] float32 matrix
// into shared memory, transposed to [D][64] (so that a thread reads four
// rows of one column as one float4) or as it is. Rows past T read as 0.
#pragma once

#include <cuda_runtime.h>

namespace f32_tiles {

constexpr int kTile = 64;   // rows of a slab

// rows [row0, row0 + 64) of `src` into `dst` as [D][64]
template <int D, int THREADS = 256>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int row0, int T,
                                                int tid) {
  constexpr int kVecs = kTile * D / 4;
#pragma unroll 4
  for (int i = tid; i < kVecs; i += THREADS) {
    const int r = i % kTile, c = i / kTile;          // neighbouring threads: neighbouring rows
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T) x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + 4 * c);
    dst[(4 * c + 0) * kTile + r] = x.x;
    dst[(4 * c + 1) * kTile + r] = x.y;
    dst[(4 * c + 2) * kTile + r] = x.z;
    dst[(4 * c + 3) * kTile + r] = x.w;
  }
}

// rows [row0, row0 + 64) of `src` into `dst` as they are, [64][D]
template <int D, int THREADS = 256>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int T, int tid) {
  constexpr int kVecs = kTile * D / 4;
#pragma unroll 4
  for (int i = tid; i < kVecs; i += THREADS) {
    const int r = i / (D / 4), c = i % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T) x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + 4 * c);
    *reinterpret_cast<float4*>(dst + r * D + 4 * c) = x;
  }
}

}  // namespace f32_tiles
