// Flash-attention backward for Hopper (sm_90a), bf16 in / f32 accumulate.
//
// Replaces: slamkit_tpu/ops/flash_attention.py::_bwd_kernel (launched by
// _bwd_call through _bwd, the backward rule of the _flash custom VJP). Same
// result: with P = exp(scale * Q K^T - LSE) under the forward's masks (causal
// q_pos >= k_pos, equal segment ids, keys < T; a dead row's LSE is +1e30 so
// its P is exactly 0),
//   dV = P^T dO,   dS = P o (dO V^T - delta) * scale,   dK = dS^T Q,   dQ = dS K,
// where delta = rowsum(dO o O) comes from the caller (JAX computes it outside
// its kernel too, flash_attention.py:345). q heads are kv-major (head h reads
// kv head h / G); dK and dV sum over the G heads of a kv group.
//
// What bounds it on the H100: the backward does 2.5x the forward's matmul
// work (S, dP, dV, dK per tile pair, plus S, dP, dQ again in the dQ pass),
// all through mma.sync from shared memory; at the Slam shape
// ([8, 14/2, 1024, 64]) the tensors are ~60 MB, so it is bound by the tensor
// cores' issue rate and shared-memory traffic, not by HBM bytes.
// What the design does about it:
//   * two kernels, FlashAttention-2's split, and no atomics, so dQ, dK and
//     dV are deterministic run to run:
//       - dkdv: one CTA (4 warps) per (64-key tile, kv head, batch row).
//         Each warp owns 16 keys and computes the transposed scores
//         S^T = K Q^T for them, so P^T and dS^T land in registers already as
//         the A operand of dV += P^T dO and dK += dS^T Q (the register
//         re-packing the forward uses for P V). It loops over the G query
//         heads of the group and over the q tiles from the diagonal on,
//         keeping dK and dV in f32 registers: GQA sums without atomics.
//       - dq: one CTA per (64-row q tile, q head, batch row); each warp owns
//         16 q rows, holds its Q and dO fragments in registers, loops over
//         the k tiles up to the diagonal and keeps dQ in f32 registers.
//     The scores and probabilities are recomputed in both (7 matmuls per
//     tile pair against Pallas's 5, which wrote per-k-block dQ partials
//     only because a TPU grid has no atomics).
//   * tiles are staged in padded shared memory (row stride d + 8 halves:
//     conflict-free fragment reads); the transposed operands (dO and Q as
//     B with k = query) are read as two halves of neighbouring rows.
//   * causal: tile pairs above the diagonal are never visited; with segment
//     ids, tile pairs whose id ranges are disjoint are skipped before their
//     operands are loaded. A k tile that sees no query (a -1 tail) still
//     writes its zeros.
//   * any T: the ragged edge is masked in the kernel, no host-side padding.
// Left for later work: wgmma, TMA and a multi-stage pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                 // keys per dkdv CTA, q rows per dq CTA
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// min / max segment id over the valid entries [base, base + N) of `seg`
// (entries at or past `limit` are ignored); every lane gets the result.
template <int N>
__device__ __forceinline__ void seg_range(const int* seg, int base, int limit,
                                          int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int idx = lane + 32 * i;
    if (base + idx < limit) {
      const int s = seg[idx];
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// rows [row0, row0 + ROWS) x D of a [T, D] slab into a padded smem tile,
// zeros past T
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int T, int tid) {
  constexpr int kStride = D + 8, kChunks = D / 8;
  static_assert((ROWS * kChunks) % kThreads == 0, "tile load must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kChunks, col = (c % kChunks) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < T) x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * D + col);
    *reinterpret_cast<uint4*>(&dst[row * kStride + col]) = x;
  }
}

// --------------------------------------------------------------------------
// dK, dV: one CTA per (64-key tile, kv head, batch row); BQ query rows a step
// --------------------------------------------------------------------------
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ q_seg,
                      const int* __restrict__ k_seg,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv,
                      int H, int Hkv, int T, float sm_scale, int causal) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * kStride;
  __nv_bfloat16* Qs = Vs + kTile * kStride;
  __nv_bfloat16* dOs = Qs + BQ * kStride;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * kStride);   // log2 domain
  float* delta_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);
  int* kseg_s = qseg_s + BQ;

  const int k_tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int k0 = k_tile * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = q_seg != nullptr;
  const float scale_log2 = sm_scale * kLog2e;

  const size_t kv_base = ((size_t)b * Hkv + hk) * T * D;
  load_tile<kTile, D>(Ks, k + kv_base, k0, T, tid);
  load_tile<kTile, D>(Vs, v + kv_base, k0, T, tid);
  if (has_seg && tid < kTile) {
    kseg_s[tid] = k0 + tid < T ? k_seg[(size_t)b * T + k0 + tid] : 0;
  }
  __syncthreads();
  int k_lo = 0, k_hi = 0;
  if (has_seg) seg_range<kTile>(kseg_s, k0, T, lane, k_lo, k_hi);

  const int kr = warp * 16;                 // this warp's keys within the tile
  const int key0 = k0 + kr + g, key1 = key0 + 8;
  const int kseg0 = has_seg ? kseg_s[kr + g] : 0;
  const int kseg1 = has_seg ? kseg_s[kr + g + 8] : 0;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  const int n_q = (T + BQ - 1) / BQ;
  const int qt_start = causal ? k0 / BQ : 0;
  for (int hq = 0; hq < G; ++hq) {
    const int h = hk * G + hq;
    const size_t q_base = ((size_t)b * H + h) * T * D;
    const size_t row_base = ((size_t)b * H + h) * T;
    for (int qt = qt_start; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                      // the previous step's readers are done
      if (has_seg) {
        if (tid < BQ) qseg_s[tid] = q0 + tid < T ? q_seg[(size_t)b * T + q0 + tid] : 0;
        __syncthreads();
        int q_lo, q_hi;
        seg_range<BQ>(qseg_s, q0, T, lane, q_lo, q_hi);
        if (q_hi < k_lo || k_hi < q_lo) continue;   // uniform across the CTA
      }
      load_tile<BQ, D>(Qs, q + q_base, q0, T, tid);
      load_tile<BQ, D>(dOs, dout + q_base, q0, T, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < T;
        lse_s[tid] = in ? lse[row_base + q0 + tid] * kLog2e : 0.f;
        delta_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
      float s[BQ / 8][4], dp[BQ / 8][4];
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
          load_b_rows(b0, b1, Qs, kStride, j * 8, kk * 16, g, t4);
          mma_16816(s[j], ka, b0, b1);
          load_b_rows(b0, b1, dOs, kStride, j * 8, kk * 16, g, t4);
          mma_16816(dp[j], va, b0, b1);
        }
      }

      // P^T (masked, exactly 0 off the mask and on dead rows) and
      // dS^T = P^T (dP^T - delta) * scale, both per (key, query) element
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t4 + (e & 1);
          const int qpos = q0 + qi;
          const int key = e < 2 ? key0 : key1;
          bool ok = key < T && qpos < T && (!causal || key <= qpos);
          if (has_seg) ok = ok && qseg_s[qi] == (e < 2 ? kseg0 : kseg1);
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_s[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[qi]) * sm_scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: the k index is the query
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          load_b_cols(b0, b1, dOs, kStride, kk * 16, n * 8, g, t4);
          mma_16816(dv_acc[n], pa, b0, b1);
          load_b_cols(b0, b1, Qs, kStride, kk * 16, n * 8, g, t4);
          mma_16816(dk_acc[n], da, b0, b1);
        }
      }
    }
  }

  // every key row < T is written, zeros included
  __nv_bfloat16* dk_r0 = dk + kv_base + (size_t)key0 * D;
  __nv_bfloat16* dk_r1 = dk + kv_base + (size_t)key1 * D;
  __nv_bfloat16* dv_r0 = dv + kv_base + (size_t)key0 * D;
  __nv_bfloat16* dv_r1 = dv + kv_base + (size_t)key1 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (key0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dk_r0 + c) = __floats2bfloat162_rn(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_r0 + c) = __floats2bfloat162_rn(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key1 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dk_r1 + c) = __floats2bfloat162_rn(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv_r1 + c) = __floats2bfloat162_rn(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// --------------------------------------------------------------------------
// dQ: one CTA per (64-row q tile, q head, batch row); BN keys a step
// --------------------------------------------------------------------------
template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ k_seg,
                    __nv_bfloat16* __restrict__ dq,
                    int H, int Hkv, int T, float sm_scale, int causal) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * kStride];
  __shared__ int kseg_s[BN];

  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = q_tile * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = q_seg != nullptr;
  const float scale_log2 = sm_scale * kLog2e;

  const size_t q_base = ((size_t)b * H + h) * T * D;
  const size_t kv_base = ((size_t)b * Hkv + hk) * T * D;
  const size_t row_base = ((size_t)b * H + h) * T;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // Q and dO fragments (A operands, row major), kept for the whole k loop
  uint32_t qa[D / 16][4], da[D / 16][4];
  {
    const __nv_bfloat16* q_r0 = q + q_base + (size_t)r0 * D;
    const __nv_bfloat16* q_r1 = q + q_base + (size_t)r1 * D;
    const __nv_bfloat16* d_r0 = dout + q_base + (size_t)r0 * D;
    const __nv_bfloat16* d_r1 = dout + q_base + (size_t)r1 * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qa[kk][0] = r0 < T ? ld32(q_r0 + c) : 0u;
      qa[kk][1] = r1 < T ? ld32(q_r1 + c) : 0u;
      qa[kk][2] = r0 < T ? ld32(q_r0 + c + 8) : 0u;
      qa[kk][3] = r1 < T ? ld32(q_r1 + c + 8) : 0u;
      da[kk][0] = r0 < T ? ld32(d_r0 + c) : 0u;
      da[kk][1] = r1 < T ? ld32(d_r1 + c) : 0u;
      da[kk][2] = r0 < T ? ld32(d_r0 + c + 8) : 0u;
      da[kk][3] = r1 < T ? ld32(d_r1 + c + 8) : 0u;
    }
  }
  const float lse0 = r0 < T ? lse[row_base + r0] * kLog2e : 0.f;
  const float lse1 = r1 < T ? lse[row_base + r1] * kLog2e : 0.f;
  const float delta0 = r0 < T ? delta[row_base + r0] : 0.f;
  const float delta1 = r1 < T ? delta[row_base + r1] : 0.f;

  int qseg0 = 0, qseg1 = 0, q_lo = 0, q_hi = 0;
  if (has_seg) {
    const int* qs = q_seg + (size_t)b * T;
    qseg0 = r0 < T ? qs[r0] : 0;
    qseg1 = r1 < T ? qs[r1] : 0;
    seg_range<kTile>(qs + q0, q0, T, lane, q_lo, q_hi);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_k = (T + BN - 1) / BN;
  const int k_end = causal ? min(n_k, (q0 + kTile - 1) / BN + 1) : n_k;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();                        // the previous tile's readers are done
    if (has_seg) {
      if (tid < BN) kseg_s[tid] = k0 + tid < T ? k_seg[(size_t)b * T + k0 + tid] : 0;
      __syncthreads();
      int k_lo, k_hi;
      seg_range<BN>(kseg_s, k0, T, lane, k_lo, k_hi);
      if (q_hi < k_lo || k_hi < q_lo) continue;     // uniform across the CTA
    }
    load_tile<BN, D>(Ks, k + kv_base, k0, T, tid);
    load_tile<BN, D>(Vs, v + kv_base, k0, T, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, Ks, kStride, j * 8, kk * 16, g, t4);
        mma_16816(s[j], qa[kk], b0, b1);
        load_b_rows(b0, b1, Vs, kStride, j * 8, kk * 16, g, t4);
        mma_16816(dp[j], da[kk], b0, b1);
      }
    }

    // dS = P (dP - delta) * scale, P masked exactly to 0
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j * 8 + 2 * t4 + (e & 1);
        const int key = k0 + kj;
        const int row = e < 2 ? r0 : r1;
        bool ok = key < T && row < T && (!causal || key <= row);
        if (has_seg) ok = ok && kseg_s[kj] == (e < 2 ? qseg0 : qseg1);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? delta0 : delta1)) * sm_scale;
      }
    }

    // dQ += dS K: the k index is the key
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, Ks, kStride, kk * 16, n * 8, g, t4);
        mma_16816(acc[n], sa, b0, b1);
      }
    }
  }

  __nv_bfloat16* o_r0 = dq + q_base + (size_t)r0 * D;
  __nv_bfloat16* o_r1 = dq + q_base + (size_t)r1 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < T) *reinterpret_cast<__nv_bfloat162*>(o_r0 + c) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r1 < T) *reinterpret_cast<__nv_bfloat162*>(o_r1 + c) = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <int D, int BQ, int BN>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* dout, const float* lse, const float* delta,
           const int* q_seg, const int* k_seg,
           __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
           int B, int H, int Hkv, int T, float sm_scale, int causal, cudaStream_t s) {
  constexpr int kStride = D + 8;
  constexpr size_t kSmem = (size_t)(2 * kTile + 2 * BQ) * kStride * sizeof(__nv_bfloat16)
                           + (size_t)(3 * BQ + kTile) * 4;
  // once per device, on the first (eager) call: not inside a graph capture
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << dev;
  }
  const dim3 grid_kv((T + kTile - 1) / kTile, Hkv, B);
  flash_bwd_dkdv_kernel<D, BQ><<<grid_kv, kThreads, kSmem, s>>>(
      q, k, v, dout, lse, delta, q_seg, k_seg, dk, dv, H, Hkv, T, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((T + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<D, BN><<<grid_q, kThreads, 0, s>>>(
      q, k, v, dout, lse, delta, q_seg, k_seg, dq, H, Hkv, T, sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. q, dout [B,H,T,D], k/v [B,Hkv,T,D] bf16 and
// contiguous; lse, delta [B,H,T] f32 (lse natural log, +1e30 on dead rows);
// q_seg / k_seg [B,T] int32 or both null; dq [B,H,T,D], dk/dv [B,Hkv,T,D] bf16.
// Launches the dkdv and dq kernels on `stream`; returns cudaGetLastError().
extern "C" int slamkit_flash_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse,
                                      const float* delta, const int* q_seg,
                                      const int* k_seg, void* dq, void* dk, void* dv,
                                      int B, int H, int Hkv, int T, int D,
                                      float sm_scale, int causal, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (k_seg == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = reinterpret_cast<const __nv_bfloat16*>(q);
  const auto* kp = reinterpret_cast<const __nv_bfloat16*>(k);
  const auto* vp = reinterpret_cast<const __nv_bfloat16*>(v);
  const auto* dop = reinterpret_cast<const __nv_bfloat16*>(dout);
  auto* dqp = reinterpret_cast<__nv_bfloat16*>(dq);
  auto* dkp = reinterpret_cast<__nv_bfloat16*>(dk);
  auto* dvp = reinterpret_cast<__nv_bfloat16*>(dv);
  if (D == 64) {
    return launch<64, 64, 64>(qp, kp, vp, dop, lse, delta, q_seg, k_seg, dqp, dkp, dvp,
                              B, H, Hkv, T, sm_scale, causal, s);
  }
  if (D == 128) {   // half-height tiles keep dK/dV and S/dP within the registers
    return launch<128, 32, 32>(qp, kp, vp, dop, lse, delta, q_seg, k_seg, dqp, dkp, dvp,
                               B, H, Hkv, T, sm_scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
