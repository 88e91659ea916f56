// Flash-attention backward for Hopper (sm_90a) in float32: float32 in, float32
// arithmetic on the CUDA cores, float32 gradients out.
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
// Every product is an FMA in float32 (no TF32, no bf16 rounding of P or dS):
// the kernel is held to the float32 plain version within float32 summation
// noise. The LSE comes from flash_fwd_f32.cu, and the tiles a pass visits
// are the forward's: a (q tile, k tile) pair is skipped only where the mask
// zeroes all of it.
//
// What bounds it on the H100: float32 off the tensor cores, 67 TFLOP/s. At
// the Slam shape ([8, 14/2, 1024, 64], 8 packed segments) the visible
// pairs' 10 D FLOPs (S, dP, dV, dK, dQ) take ~0.07 ms and the bytes (q, k,
// v, O, dO, LSE read; dq, dk, dv written; ~44 MB) ~0.013 ms: operations
// bound it. A CUDA-core kernel can at best approach that rate.
// What the design does (a simple kernel first, on flash_fwd_f32.cu's plan):
//   * three launches, no atomics, so dQ, dK and dV are bitwise
//     deterministic (a float32 resume repeats a step exactly):
//       - prep: delta = rowsum(dO o O) in float32, D / 4 lanes a row with
//         one float4 each and a fixed shuffle tree;
//       - dkdv: one CTA of 256 threads per (64-key tile, kv head, batch
//         row), which walks the G q heads of its group in order, and for
//         each the listed q tiles in order, as the Pallas kernel folds the G
//         heads into one panel. dK and dV stay in registers (thread (ty, tx)
//         owns keys 4 ty .. 4 ty + 3 and columns 4 tx + 64 c .. + 3) and are
//         written once;
//       - dq: one CTA per (64-row q tile, q head, batch row), over the listed
//         k tiles, dQ in registers;
//   * each CTA lists the tiles it must visit before loading any: under
//     causality k tile <= q tile; with segment ids only tiles whose id
//     ranges meet (hopper.cuh's ranges, pads kept apart);
//   * products register-blocked as the forward's: the operands of S and dP
//     in shared memory as [D][64] (transposed on the store, so that a thread
//     reads four rows or keys as one float4), 16 FMAs per two float4 reads;
//     P and dS go to shared memory, the same Q / dO (dkdv) or K (dq) tile is
//     then reloaded as [64][D] into the buffer the transposed one used, and
//     the gradient products read it row by row;
//   * dynamic shared memory (about 100 KB at d = 64, 165 KB at d = 128).
// Left for later work: cp.async double buffering, wider register blocks, a
// split of D for the accumulators, 3xTF32 tensor-core products held to the
// same bound.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <stdint.h>

#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using f32_tiles::kTile;
using f32_tiles::load_rows;
using f32_tiles::load_transposed;

constexpr int kThreads = 256;      // 16 x 16 threads, a 4 x 4 block each
constexpr float kLseSentinel = 1e30f;

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
  int H, Hkv, T, causal;
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

// ------------------------------------------------------------ tile lists --

// the id range of rows [r0, r0 + 64) (those < T) of one batch row, in every lane
__device__ __forceinline__ int4 tile_range(const int* ids, int r0, int T, int lane) {
  int4 r = empty_range();
  for (int c = lane; c < kTile; c += 32) {
    if (r0 + c < T) r = join(r, range_of(ids[r0 + c]));
  }
  return warp_join(r);
}

// One warp: the tiles t in [t0, t1) whose ids (`ids`, null without segment
// ids) meet `mine`, in increasing order, into `list`; returns how many.
__device__ int list_tiles(int* list, const int* ids, int4 mine, int t0, int t1, int T,
                          int lane) {
  int n = 0;
  for (int t = t0; t < t1; ++t) {
    if (ids == nullptr || meet(mine, tile_range(ids, t * kTile, T, lane))) {
      if (lane == 0) list[n] = t;
      ++n;
    }
  }
  return n;
}

__device__ __forceinline__ void as4(float (&dst)[4], const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

// ------------------------------------------------------------------ dkdv --

// Shared memory in floats: K^T, V^T [D][64]; the q tile's Q and dO buffers
// ([D][64], then [64][D]); P and dS [64 rows][64 keys]; per q row its LSE,
// delta and id; the keys' ids; the list's length and the list.
template <int D>
struct KvSmem {
  static constexpr int kK = 0, kV = D * kTile, kQ = 2 * D * kTile, kDO = 3 * D * kTile;
  static constexpr int kP = 4 * D * kTile, kDS = kP + kTile * kTile;
  static constexpr int kLse = kDS + kTile * kTile, kDelta = kLse + kTile;
  static constexpr int kQseg = kDelta + kTile, kKseg = kQseg + kTile;
  static constexpr int kCount = kKseg + kTile, kList = kCount + 4;
  static size_t bytes(int T) { return 4 * ((size_t)kList + (T + kTile - 1) / kTile); }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dkdv_kernel(const BwdArgs a) {
  using L = KvSmem<D>;
  constexpr int NC = D / 64;                     // 4-column groups of dK / dV a thread holds
  extern __shared__ float smem[];
  float* Kt = smem + L::kK;
  float* Vt = smem + L::kV;
  float* Qb = smem + L::kQ;
  float* dOb = smem + L::kDO;
  float* Ps = smem + L::kP;
  float* dSs = smem + L::kDS;
  float* lse_s = smem + L::kLse;
  float* delta_s = smem + L::kDelta;
  int* qseg_s = reinterpret_cast<int*>(smem + L::kQseg);
  int* kseg_s = reinterpret_cast<int*>(smem + L::kKseg);
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  int* list = reinterpret_cast<int*>(smem + L::kList);

  const int T = a.T, n_t = (T + kTile - 1) / kTile;
  const int k_tile = blockIdx.z, k0 = k_tile * kTile;   // z = 0 first: it sees the most q tiles
  const int hk = blockIdx.x, b = blockIdx.y, G = a.H / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;        // keys 4 ty + i; q rows / columns 4 tx + j
  const bool has_seg = a.q_seg != nullptr;
  const float* kp = a.k + ((size_t)b * a.Hkv + hk) * T * D;
  const float* vp = a.v + ((size_t)b * a.Hkv + hk) * T * D;

  load_transposed<D>(Kt, kp, k0, T, tid);
  load_transposed<D>(Vt, vp, k0, T, tid);
  if (has_seg && tid < kTile) {
    kseg_s[tid] = k0 + tid < T ? a.k_seg[(size_t)b * T + k0 + tid] : 0;
  }
  // ---- the q tiles these keys can see, in order
  if (warp == 0) {
    const int4 kr = has_seg ? tile_range(a.k_seg + (size_t)b * T, k0, T, lane) : empty_range();
    const int n = list_tiles(list, has_seg ? a.q_seg + (size_t)b * T : nullptr, kr,
                             a.causal ? k_tile : 0, n_t, T, lane);
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int n_list = *count_s;

  int kseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kseg[i] = has_seg ? kseg_s[4 * ty + i] : 0;

  float dk[4][4 * NC], dv[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const size_t row_base = ((size_t)b * a.H + h) * T;
    const float* qp = a.q + row_base * D;
    const float* dop = a.dout + row_base * D;
    for (int it = 0; it < n_list; ++it) {
      const int q0 = list[it] * kTile;
      __syncthreads();                           // the last tile's Q, dO, P and dS are read
      load_transposed<D>(Qb, qp, q0, T, tid);
      load_transposed<D>(dOb, dop, q0, T, tid);
      if (tid < kTile) {
        const bool in = q0 + tid < T;            // rows past T: P = 0
        lse_s[tid] = in ? a.lse[row_base + q0 + tid] : kLseSentinel;
        delta_s[tid] = in ? a.delta[row_base + q0 + tid] : 0.f;
        if (has_seg) qseg_s[tid] = in ? a.q_seg[(size_t)b * T + q0 + tid] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys 4 ty + i, q rows 4 tx + j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      }
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[4], qa[4], va[4], oa[4];
        as4(ka, Kt + d * kTile + 4 * ty);
        as4(qa, Qb + d * kTile + 4 * tx);
        as4(va, Vt + d * kTile + 4 * ty);
        as4(oa, dOb + d * kTile + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[j], ka[i], s[i][j]);
            dp[i][j] = fmaf(oa[j], va[i], dp[i][j]);
          }
        }
      }

      // P and dS, masked exactly to 0; stored as [row][key]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rc = 4 * tx + j, row = q0 + rc;
        const float lse = lse_s[rc], delta = delta_s[rc];
        const int qseg = has_seg ? qseg_s[rc] : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 4 * ty + i;
          bool ok = key < T && row < T && (!a.causal || key <= row);
          if (has_seg) ok = ok && kseg[i] == qseg;
          const float p = ok ? expf(s[i][j] * a.scale - lse) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - delta) * a.scale;
        }
        *reinterpret_cast<float4*>(Ps + rc * kTile + 4 * ty) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(dSs + rc * kTile + 4 * ty) =
            make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
      }
      __syncthreads();                           // Q^T and dO^T are read; P and dS written
      load_rows<D>(Qb, qp, q0, T, tid);
      load_rows<D>(dOb, dop, q0, T, tid);
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: keys 4 ty + i, columns 64 c + 4 tx + e
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pa[4], sa[4];
        as4(pa, Ps + r * kTile + 4 * ty);
        as4(sa, dSs + r * kTile + 4 * ty);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float oa[4], qa[4];
          as4(oa, dOb + r * D + 64 * c + 4 * tx);
          as4(qa, Qb + r * D + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv[i][4 * c + e] = fmaf(pa[i], oa[e], dv[i][4 * c + e]);
              dk[i][4 * c + e] = fmaf(sa[i], qa[e], dk[i][4 * c + e]);
            }
          }
        }
      }
    }
  }

  // epilogue: this tile's keys (a tile no q tile sees writes zeros)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= T) continue;
    const size_t at = (((size_t)b * a.Hkv + hk) * T + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      *reinterpret_cast<float4*>(a.dk + at + 64 * c + 4 * tx) =
          make_float4(dk[i][4 * c], dk[i][4 * c + 1], dk[i][4 * c + 2], dk[i][4 * c + 3]);
      *reinterpret_cast<float4*>(a.dv + at + 64 * c + 4 * tx) =
          make_float4(dv[i][4 * c], dv[i][4 * c + 1], dv[i][4 * c + 2], dv[i][4 * c + 3]);
    }
  }
}

// -------------------------------------------------------------------- dq --

// Shared memory in floats: Q^T, dO^T [D][64]; the k tile's K buffer ([D][64],
// then [64][D]) and V^T [D][64]; dS^T [64 keys][64 rows]; the q rows' ids,
// the keys' ids, the list's length and the list.
template <int D>
struct QSmem {
  static constexpr int kQ = 0, kDO = D * kTile, kK = 2 * D * kTile, kV = 3 * D * kTile;
  static constexpr int kDS = 4 * D * kTile, kQseg = kDS + kTile * kTile;
  static constexpr int kKseg = kQseg + kTile, kCount = kKseg + kTile, kList = kCount + 4;
  static size_t bytes(int T) { return 4 * ((size_t)kList + (T + kTile - 1) / kTile); }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dq_kernel(const BwdArgs a) {
  using L = QSmem<D>;
  constexpr int NC = D / 64;                     // 4-column groups of dQ a thread holds
  extern __shared__ float smem[];
  float* Qt = smem + L::kQ;
  float* dOt = smem + L::kDO;
  float* Kb = smem + L::kK;
  float* Vt = smem + L::kV;
  float* dSt = smem + L::kDS;
  int* qseg_s = reinterpret_cast<int*>(smem + L::kQseg);
  int* kseg_s = reinterpret_cast<int*>(smem + L::kKseg);
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  int* list = reinterpret_cast<int*>(smem + L::kList);

  const int T = a.T, n_t = (T + kTile - 1) / kTile;
  const int q_tile = n_t - 1 - (int)blockIdx.z;  // the last first: it sees the most keys
  const int q0 = q_tile * kTile;
  const int h = blockIdx.x, hk = h / (a.H / a.Hkv), b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;        // q rows 4 ty + i; keys / columns 4 tx + j
  const bool has_seg = a.q_seg != nullptr;
  const size_t row_base = ((size_t)b * a.H + h) * T;
  const float* kp = a.k + ((size_t)b * a.Hkv + hk) * T * D;
  const float* vp = a.v + ((size_t)b * a.Hkv + hk) * T * D;

  load_transposed<D>(Qt, a.q + row_base * D, q0, T, tid);
  load_transposed<D>(dOt, a.dout + row_base * D, q0, T, tid);
  if (has_seg && tid < kTile) {
    qseg_s[tid] = q0 + tid < T ? a.q_seg[(size_t)b * T + q0 + tid] : 0;
  }
  // ---- the k tiles these rows can see, in order
  if (warp == 0) {
    const int4 qr = has_seg ? tile_range(a.q_seg + (size_t)b * T, q0, T, lane) : empty_range();
    const int k_end = a.causal ? q_tile + 1 : n_t;
    const int n = list_tiles(list, has_seg ? a.k_seg + (size_t)b * T : nullptr, qr, 0, k_end,
                             T, lane);
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int n_list = *count_s;

  float lse[4], delta[4];
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse[i] = row < T ? a.lse[row_base + row] : kLseSentinel;
    delta[i] = row < T ? a.delta[row_base + row] : 0.f;
    qseg[i] = has_seg ? qseg_s[4 * ty + i] : 0;
  }

  float dq[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dq[i][c] = 0.f;
  }

  for (int it = 0; it < n_list; ++it) {
    const int k0 = list[it] * kTile;
    __syncthreads();                             // the last tile's K and dS^T are read
    load_transposed<D>(Kb, kp, k0, T, tid);
    load_transposed<D>(Vt, vp, k0, T, tid);
    if (has_seg && tid < kTile) {
      kseg_s[tid] = k0 + tid < T ? a.k_seg[(size_t)b * T + k0 + tid] : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: q rows 4 ty + i, keys 4 tx + j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4], oa[4], va[4];
      as4(qa, Qt + d * kTile + 4 * ty);
      as4(ka, Kb + d * kTile + 4 * tx);
      as4(oa, dOt + d * kTile + 4 * ty);
      as4(va, Vt + d * kTile + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
      }
    }

    // dS, masked exactly to 0; stored as [key][row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = 4 * tx + j, key = k0 + kc;
      const int kseg = has_seg ? kseg_s[kc] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        bool ok = key < T && row < T && (!a.causal || key <= row);
        if (has_seg) ok = ok && kseg == qseg[i];
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        dp[i][j] = p * (dp[i][j] - delta[i]) * a.scale;
      }
      *reinterpret_cast<float4*>(dSt + kc * kTile + 4 * ty) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();                             // K^T is read; dS^T is written
    load_rows<D>(Kb, kp, k0, T, tid);
    __syncthreads();

    // dQ += dS K: q rows 4 ty + i, columns 64 c + 4 tx + e
#pragma unroll 4
    for (int kc = 0; kc < kTile; ++kc) {
      float sa[4];
      as4(sa, dSt + kc * kTile + 4 * ty);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float ka[4];
        as4(ka, Kb + kc * D + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[i][4 * c + e] = fmaf(sa[i], ka[e], dq[i][4 * c + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= T) continue;
    float* drow = a.dq + (row_base + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      *reinterpret_cast<float4*>(drow + 64 * c + 4 * tx) =
          make_float4(dq[i][4 * c], dq[i][4 * c + 1], dq[i][4 * c + 2], dq[i][4 * c + 3]);
    }
  }
}

template <int D>
cudaError_t launch(const BwdArgs& a, int B, const float* out, float* delta, cudaStream_t s) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_f32_dkdv_kernel<D>, kv_configured, dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_f32_dq_kernel<D>, q_configured, dev);
  if (err != cudaSuccess) return err;

  const int rows = B * a.H * a.T, per_block = 256 / (D / 4);
  flash_bwd_f32_prep_kernel<D><<<(rows + per_block - 1) / per_block, 256, 0, s>>>(
      out, a.dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_t = (a.T + kTile - 1) / kTile;
  flash_bwd_f32_dkdv_kernel<D><<<dim3(a.Hkv, B, n_t), kThreads, KvSmem<D>::bytes(a.T), s>>>(a);
  err = cudaGetLastError();
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
  a.scale = sm_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(a, B, out, scratch, s);
  if (D == 128) return (int)launch<128>(a, B, out, scratch, s);
  return (int)cudaErrorInvalidValue;
}
