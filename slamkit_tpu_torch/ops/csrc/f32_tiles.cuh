// Pieces shared by the float32 flash kernels (flash_fwd_f32.cu and
// flash_bwd_f32.cu): padded float32 tiles loaded by cp.async, the fragment
// reads of their mma.sync m16n8k8 products (hopper.cuh's 3xTF32), and the
// list of the tiles a CTA must visit.
//
// Tiles are row-major [rows][D + 4] floats. The pad of 4 makes every
// fragment read below hit 32 distinct banks: a row stride of 4 (mod 32)
// words spreads lanes (g, t) to 4 g + t, and rows 2 t + {0, 1} to 8 t + g,
// where an unpadded row of 64 or 128 floats puts 8 lanes on each bank.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace f32_tiles {

using namespace hopper;

constexpr int kTile = 64;              // rows of a tile up to d = 128 (but the
                                       // q tiles of the d = 128 dK/dV pass);
                                       // at d = 256 only the forward's q tile
constexpr int kInterior = 1 << 30;     // a list entry's mark: the pair needs no mask

template <int D>
struct Ld {
  static constexpr int value = D + 4;  // floats a tile row
};

// rows [row0, row0 + ROWS) of a [T][D] float32 matrix into a [ROWS][D + 4]
// tile by cp.async, 16 bytes a copy, zeros past T
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int row0, int T, int tid) {
  constexpr int kChunks = D / 4, kCopies = ROWS * kChunks;
  static_assert(kCopies % THREADS == 0, "the tile load must split evenly");
#pragma unroll
  for (int i = 0; i < kCopies / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c / kChunks, ch = c - r * kChunks;
    const bool ok = row0 + r < T;
    cp_async16(dst + r * Ld<D>::value + 4 * ch, ok ? src + (size_t)(row0 + r) * D + 4 * ch : src,
               ok);
  }
}

// N 4-byte values of a [T] row at row0 into dst by cp.async (threads < N),
// zeros past T
template <int N>
__device__ __forceinline__ void cp_vals(void* dst, const void* src, int row0, int T, int tid) {
  if (tid < N) {
    const bool ok = row0 + tid < T;
    cp_async4(static_cast<uint32_t*>(dst) + tid,
              static_cast<const uint32_t*>(src) + (ok ? row0 + tid : 0), ok);
  }
}

// The A fragment (16 rows x 8 k) at (row0, k0) of a tile whose rows are the
// product's rows
template <int D>
__device__ __forceinline__ void frag_a(float (&x)[4], const float* t, int row0, int k0, int g,
                                       int t4) {
  constexpr int L = Ld<D>::value;
  const float* p = t + (row0 + g) * L + k0 + t4;
  x[0] = p[0];
  x[1] = p[8 * L];
  x[2] = p[4];
  x[3] = p[8 * L + 4];
}

// The B fragment (8 k x 8 n) at (k0, n0) of a tile whose rows are the
// product's n (B^T row-major: K for S = Q K^T)
template <int D>
__device__ __forceinline__ void frag_b_nrows(float (&x)[2], const float* t, int k0, int n0, int g,
                                             int t4) {
  const float* p = t + (n0 + g) * Ld<D>::value + k0 + t4;
  x[0] = p[0];
  x[1] = p[4];
}

// The B fragment at (k0, n0) of a tile whose rows are the product's k (V for
// O = P V), with the k index permuted to match `frag_a_from_acc`: k = t reads
// row k0 + 2 t, k = t + 4 row k0 + 2 t + 1
template <int D>
__device__ __forceinline__ void frag_b_krows(float (&x)[2], const float* t, int k0, int n0, int g,
                                             int t4) {
  const float* p = t + (k0 + 2 * t4) * Ld<D>::value + n0 + g;
  x[0] = p[0];
  x[1] = p[Ld<D>::value];
}

// An accumulator tile (16 x 8: P or dS) as the A fragment of the next
// product, whose k runs over its 8 columns: a thread holds columns 2 t and
// 2 t + 1, so k = t is column 2 t and k = t + 4 column 2 t + 1 (the B side
// reads its rows in the same order, `frag_b_krows`); no shuffle
__device__ __forceinline__ void frag_a_from_acc(float (&x)[4], const float (&c)[4]) {
  x[0] = c[0];
  x[1] = c[2];
  x[2] = c[1];
  x[3] = c[3];
}

// The tiles t in [t0, t1) of ROWS ids each (ids: one batch row's [T] ids,
// null without segment ids) that hold an id in `mine` (the CTA's own rows'
// ranges), in increasing order, into `list`; an entry is marked kInterior
// when `corner_free(t)` (no position mask: before T, and under causality
// wholly on the seen side) and one id `one` (or, without ids, none) covers
// both the CTA's rows and the whole tile.
// Warp w takes the tiles w, w + WARPS, ..., four tiles' loads in flight
// before the votes; `flags` is scratch of t1 ints. Every thread calls it;
// returns the list's length.
template <int ROWS, int WARPS, typename CornerFree>
__device__ int list_tiles(int* flags, int* list, int* count, const int* ids, int4 mine,
                          bool mine_one, int one, int t0, int t1, int T, int tid,
                          CornerFree corner_free) {
  static_assert(ROWS == 32 || ROWS == 64, "tiles of 32 or 64 rows");
  constexpr int kPer = ROWS / 32;
  const int warp = tid >> 5, lane = tid & 31;
  if (ids != nullptr) {
    for (int base = t0 + warp; base < t1; base += 4 * WARPS) {
      int v[4][kPer];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = (base + WARPS * u) * ROWS + 32 * e + lane;
          v[u][e] = r < T ? ids[r] : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = base + WARPS * u;
        if (t >= t1) break;                    // uniform across the warp
        bool hit = false, all_one = true;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const bool in = t * ROWS + 32 * e + lane < T;
          hit = hit || (in && in_range(v[u][e], mine));
          all_one = all_one && in && v[u][e] == one;
        }
        const bool need = __any_sync(0xffffffffu, hit);
        const bool whole = __all_sync(0xffffffffu, all_one);
        if (lane == 0) flags[t] = need ? (t | (mine_one && whole && corner_free(t) ? kInterior : 0))
                                       : -1;
      }
    }
  } else {
    for (int t = t0 + tid; t < t1; t += 32 * WARPS) flags[t] = t | (corner_free(t) ? kInterior : 0);
  }
  __syncthreads();
  if (warp == 0) {                             // the listed tiles, in order
    int n = 0;
    for (int base = t0; base < t1; base += 32) {
      const int t = base + lane;
      const int f = t < t1 ? flags[t] : -1;
      const unsigned ballot = __ballot_sync(0xffffffffu, f >= 0);
      if (f >= 0) list[n + __popc(ballot & ((1u << lane) - 1u))] = f;
      n += __popc(ballot);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// The id ranges of rows [r0, r0 + ROWS) (those < T) of one batch row, joined
// by each warp on its own (no shared memory, no barrier, so the reads go out
// beside the tile list's); whether one id covers them all, and which.
template <int ROWS>
__device__ __forceinline__ int4 rows_range(const int* ids, int r0, int T, int lane, bool& is_one,
                                           int& one) {
  int4 q = empty_range();
#pragma unroll
  for (int e = 0; e < (ROWS + 31) / 32; ++e) {
    const int r = r0 + 32 * e + lane;
    if (32 * e + lane < ROWS && r < T) q = join(q, range_of(ids[r]));
  }
  q = warp_join(q);
  is_one = (q.x == q.y && q.z > q.w) || (q.x > q.y && q.z == q.w);
  one = q.x <= q.y ? q.x : q.z;
  return q;
}

}  // namespace f32_tiles
