// Flash-attention forward for Hopper (sm_90a), bf16 in / f32 accumulate.
//
// Replaces: slamkit_tpu/ops/flash_attention.py::_fwd_kernel (launched by _fwd,
// public entry flash_attention). Same result: O = softmax(scale * Q K^T + mask) V
// and the row log-sum-exp, where the mask is causal (q_pos >= k_pos) AND equal
// segment ids; a row with no unmasked key outputs exactly 0 with LSE = +1e30.
// q heads are kv-major: q head h reads kv head h / (H / Hkv); kv is never
// repeated.
//
// What bounds it on the H100: at the serving shapes (T <= 1024, d = 64) the
// work is ~2*T*d flops per score and the K/V tiles are re-read by every q tile,
// so it is bound by the tensor-core issue rate and by shared-memory traffic,
// not by HBM bytes (q/k/v/out of one [8, 14/2, 1024, 64] call are ~40 MB).
// What the design does about it:
//   * one CTA (4 warps) per (q tile of 64 rows, q head, batch row); each warp
//     owns 16 q rows, keeps its Q fragments, the online-softmax state (m, l)
//     and the output accumulator in registers for the whole k loop, and runs
//     both products with mma.sync m16n8k16 (bf16 -> f32). The probabilities
//     never leave registers: the S accumulator layout is re-packed in place as
//     the A operand of P V (the FlashAttention-2 register trick).
//   * K/V tiles of 64 keys are staged in padded shared memory (row stride
//     d + 8 halves: conflict-free fragment reads);
//   * causal: k tiles above the diagonal are never visited; with segment ids,
//     k tiles whose id range is disjoint from the q tile's are skipped before
//     their K/V are loaded (packed rows attend only inside their segment);
//   * any T: the ragged edge is masked in the kernel (keys >= T are masked,
//     rows >= T are not stored), no host-side padding copy.
// Left for later work: wgmma, TMA and a multi-stage K/V pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;    // q rows per CTA
constexpr int kBlockN = 64;    // keys per k tile
constexpr int kWarps = 4;      // 16 q rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;       // masked score
constexpr float kMClamp = -1e25f;       // running-max floor: exp2(kNegInf - m) == 0
constexpr float kLseSentinel = 1e30f;   // dead rows
constexpr float kLn2 = 0.6931471805599453f;

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

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// min / max segment id over the valid entries [base, base + 64) of `seg`
// (entries at or past `limit` are ignored); every lane gets the result.
__device__ __forceinline__ void seg_range(const int* seg, int base, int limit,
                                          int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int idx = lane + 32 * i;
    if (base + idx < limit) {
      int s = seg[idx];
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ k_seg,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse,
                 int H, int Hkv, int T, float scale_log2, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;           // padded smem row, in halves
  constexpr int kChunks = D / 8;           // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * kStride];
  __shared__ int kseg_s[kBlockN];

  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = q_tile * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = q_seg != nullptr;

  const size_t q_base = ((size_t)b * H + h) * T * D;
  const size_t kv_base = ((size_t)b * Hkv + hk) * T * D;
  const int r0 = q0 + warp * 16 + g;       // this thread's two rows
  const int r1 = r0 + 8;

  // Q fragments (A operand, row major), kept for the whole k loop
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* q_r0 = q + q_base + (size_t)r0 * D;
  const __nv_bfloat16* q_r1 = q + q_base + (size_t)r1 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qa[kk][0] = r0 < T ? *reinterpret_cast<const uint32_t*>(q_r0 + c) : 0u;
    qa[kk][1] = r1 < T ? *reinterpret_cast<const uint32_t*>(q_r1 + c) : 0u;
    qa[kk][2] = r0 < T ? *reinterpret_cast<const uint32_t*>(q_r0 + c + 8) : 0u;
    qa[kk][3] = r1 < T ? *reinterpret_cast<const uint32_t*>(q_r1 + c + 8) : 0u;
  }

  int qseg0 = 0, qseg1 = 0, q_lo = 0, q_hi = 0;
  if (has_seg) {
    const int* qs = q_seg + (size_t)b * T;
    qseg0 = r0 < T ? qs[r0] : 0;
    qseg1 = r1 < T ? qs[r1] : 0;
    seg_range(qs + q0, q0, T, lane, q_lo, q_hi);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m0 = kMClamp, m1 = kMClamp;        // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;                // per-thread partial row sums

  const int n_k = (T + kBlockN - 1) / kBlockN;
  const int k_end = causal ? min(n_k, q_tile + 1) : n_k;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();                       // previous tile's readers are done
    if (has_seg) {
      if (tid < kBlockN) {
        kseg_s[tid] = k0 + tid < T ? k_seg[(size_t)b * T + k0 + tid] : 0;
      }
      __syncthreads();
      int k_lo, k_hi;
      seg_range(kseg_s, k0, T, lane, k_lo, k_hi);
      if (q_hi < k_lo || k_hi < q_lo) continue;   // uniform across the CTA
    }
#pragma unroll
    for (int i = 0; i < kBlockN * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / kChunks, col = (c % kChunks) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < T) {
        const size_t off = kv_base + (size_t)(k0 + row) * D + col;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[row * kStride + col]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[row * kStride + col]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(j * 8 + g) * kStride + 2 * t4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[j], qa[kk], b0, b1);
      }
    }

    // mask, scale into the log2 domain, and take the row maxima
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        bool ok = key < T && (!causal || key <= row);
        if (has_seg) ok = ok && kseg_s[key - k0] == (e < 2 ? qseg0 : qseg1);
        const float x = ok ? s[j][e] * scale_log2 : kNegInf;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: P (bf16) re-packed from the S accumulators as the A operand;
    // V is the B operand (k = key, n = head-dim column), read as halves
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = &Vs[(kk * 16 + 2 * t4) * kStride + g];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = v0 + n * 8;
        const uint32_t b0 = pack_bf16_raw(vp[0], vp[kStride]);
        const uint32_t b1 = pack_bf16_raw(vp[8 * kStride], vp[9 * kStride]);
        mma_16816(acc[n], pa, b0, b1);
      }
    }
  }

  // epilogue: full row sums, normalise, zero dead rows, store O and LSE
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool alive0 = l0 > 0.f, alive1 = l1 > 0.f;
  const float inv0 = alive0 ? 1.f / l0 : 0.f;
  const float inv1 = alive1 ? 1.f / l1 : 0.f;
  __nv_bfloat16* o_r0 = out + q_base + (size_t)r0 * D;
  __nv_bfloat16* o_r1 = out + q_base + (size_t)r1 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(o_r0 + c) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (r1 < T) {
      *reinterpret_cast<__nv_bfloat162*>(o_r1 + c) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
  if (t4 == 0) {
    float* lse_bh = lse + ((size_t)b * H + h) * T;
    if (r0 < T) lse_bh[r0] = alive0 ? m0 * kLn2 + logf(l0) : kLseSentinel;
    if (r1 < T) lse_bh[r1] = alive1 ? m1 * kLn2 + logf(l1) : kLseSentinel;
  }
}

}  // namespace

// Plain C entry, bound with ctypes. q [B,H,T,D], k/v [B,Hkv,T,D] bf16 and
// contiguous; q_seg / k_seg [B,T] int32 or both null; out [B,H,T,D] bf16;
// lse [B,H,T] f32. Launches on `stream` and returns cudaGetLastError().
extern "C" int slamkit_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                      const int* q_seg, const int* k_seg,
                                      void* out, float* lse,
                                      int B, int H, int Hkv, int T, int D,
                                      float sm_scale, int causal, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (k_seg == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kBlockM - 1) / kBlockM, H, B);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = reinterpret_cast<const __nv_bfloat16*>(q);
  const auto* kp = reinterpret_cast<const __nv_bfloat16*>(k);
  const auto* vp = reinterpret_cast<const __nv_bfloat16*>(v);
  auto* op = reinterpret_cast<__nv_bfloat16*>(out);
  if (D == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(qp, kp, vp, q_seg, k_seg, op, lse,
                                                   H, Hkv, T, scale_log2, causal);
  } else if (D == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(qp, kp, vp, q_seg, k_seg, op, lse,
                                                    H, Hkv, T, scale_log2, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
