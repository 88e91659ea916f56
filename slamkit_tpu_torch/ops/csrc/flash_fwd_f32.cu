// Flash-attention forward for Hopper (sm_90a) in float32: float32 in, float32
// arithmetic on the CUDA cores, float32 out.
//
// Replaces: slamkit_tpu/ops/flash_attention.py::_fwd_kernel (launched by _fwd,
// public entry flash_attention) where it is given float32 inputs: the Pallas
// kernel runs in its inputs' dtype, and the JAX package scores text with a
// float32 UnitLM (metric/metric_utils.py::get_llm, the GenPPL text LM and
// the LLM judge). Same result as the bf16 kernel (flash_fwd.cu): O =
// softmax(scale * Q K^T + mask) V and the row log-sum-exp, the mask causal
// (q_pos >= k_pos) AND equal segment ids (pads, id < 0, see other pads), keys
// at or past T masked; a row with no unmasked key outputs exactly 0 with LSE
// = +1e30. q heads are kv-major: q head h reads kv head h / (H / Hkv).
//
// Every product is an FMA in float32 (no TF32, no bf16 rounding of P): the
// kernel is held to the float32 plain version within float32 summation noise.
//
// What bounds it on the H100: float32 off the tensor cores, 67 TFLOP/s. At
// the text LM's shape ([8, 32/8, 512, 64], right-padded rows) the visible
// pairs' 4 D FLOPs take ~0.1 ms and the bytes (~84 MB) ~0.025 ms: operations
// bound it, and a CUDA-core kernel can at best approach that rate.
// What the design does (a simple kernel first; PR 9):
//   * one CTA of 256 threads per (64-row q tile, q head, batch row), the
//     last q tiles (the heaviest under causality) launched first;
//   * before the loop the CTA lists the k tiles its rows can see: up to the
//     diagonal, and, with segment ids, only tiles whose ids meet the q
//     tile's (hopper.cuh's segment ranges, pads kept apart);
//   * Q^T and each K^T tile in shared memory as [D][64] (transposed on the
//     store, so a thread reads four rows or four keys as one float4), V as
//     [64][D]; P as [64 keys][64 rows];
//   * S = Q K^T register-blocked: thread (ty, tx) owns rows 4 ty .. 4 ty + 3
//     and keys 4 tx .. 4 tx + 3, 16 FMAs per two float4 reads; the online
//     softmax in the natural-log domain with expf, the running max floored at
//     -1e25 so a row that has seen nothing stays 0; row max and sum across
//     the 16 lanes of a row group by shuffles;
//   * O += P V with the same row block and columns 4 tx + 64 c;
//   * no atomics and no split of the keys: bitwise deterministic.
// Left for later work: double-buffered K/V loads (cp.async), wider register
// blocks, and 3xTF32 tensor-core products held to the same bound.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;        // q rows per CTA, keys per k tile
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 block each
constexpr float kMClamp = -1e25f;
constexpr float kLseSentinel = 1e30f;

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const int* q_seg;
  const int* k_seg;
  float* out;
  float* lse;
  int H, Hkv, T, causal;
  float scale;
};

// Shared memory in floats: Q^T [D][64], K^T [D][64], V [64][D], P^T [64][64],
// then the q rows' ids, the keys' ids, the list's length and the list.
template <int D>
struct F32Smem {
  static constexpr int kQ = 0, kK = D * kTile, kV = 2 * D * kTile, kP = 3 * D * kTile;
  static constexpr int kQseg = kP + kTile * kTile, kKseg = kQseg + kTile;
  static constexpr int kCount = kKseg + kTile, kList = kCount + 4;
  static size_t bytes(int T) { return 4 * ((size_t)kList + (T + kTile - 1) / kTile); }
};

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a [64][D] row-major slab (rows past T read as 0) into smem as [D][64]
template <int D>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int row0, int T,
                                                int tid) {
  constexpr int kVecs = kTile * D / 4;
#pragma unroll 4
  for (int i = tid; i < kVecs; i += kThreads) {
    const int r = i % kTile, c = i / kTile;          // neighbouring threads: neighbouring rows
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T) x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + 4 * c);
    dst[(4 * c + 0) * kTile + r] = x.x;
    dst[(4 * c + 1) * kTile + r] = x.y;
    dst[(4 * c + 2) * kTile + r] = x.z;
    dst[(4 * c + 3) * kTile + r] = x.w;
  }
}

// a [64][D] row-major slab into smem as it is
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int T, int tid) {
  constexpr int kVecs = kTile * D / 4;
#pragma unroll 4
  for (int i = tid; i < kVecs; i += kThreads) {
    const int r = i / (D / 4), c = i % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T) x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + 4 * c);
    *reinterpret_cast<float4*>(dst + r * D + 4 * c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const F32Args a) {
  using L = F32Smem<D>;
  constexpr int NC = D / 64;                     // 4-column groups of O a thread holds
  extern __shared__ float smem[];
  float* Qt = smem + L::kQ;
  float* Kt = smem + L::kK;
  float* Vs = smem + L::kV;
  float* Pt = smem + L::kP;
  int* qseg_s = reinterpret_cast<int*>(smem + L::kQseg);
  int* kseg_s = reinterpret_cast<int*>(smem + L::kKseg);
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  int* list = reinterpret_cast<int*>(smem + L::kList);

  const int T = a.T, n_k = (T + kTile - 1) / kTile;
  const int q_tile = n_k - 1 - (int)blockIdx.z;  // the last first: it sees the most keys
  const int q0 = q_tile * kTile;
  const int h = blockIdx.x, hk = h / (a.H / a.Hkv), b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;        // rows 4 ty + i, keys / columns 4 tx + j
  const bool has_seg = a.q_seg != nullptr;
  const float* qp = a.q + ((size_t)b * a.H + h) * T * D;
  const float* kp = a.k + ((size_t)b * a.Hkv + hk) * T * D;
  const float* vp = a.v + ((size_t)b * a.Hkv + hk) * T * D;

  load_transposed<D>(Qt, qp, q0, T, tid);
  if (has_seg && tid < kTile) {
    qseg_s[tid] = q0 + tid < T ? a.q_seg[(size_t)b * T + q0 + tid] : 0;
  }

  // ---- the k tiles these rows can see, in order
  const int k_end = a.causal ? min(n_k, q_tile + 1) : n_k;
  if (warp == 0) {
    int4 qr = empty_range();
    if (has_seg) {
      const int* qs = a.q_seg + (size_t)b * T;
      for (int r = lane; r < kTile; r += 32) {
        if (q0 + r < T) qr = join(qr, range_of(qs[q0 + r]));
      }
      qr = warp_join(qr);
    }
    int n = 0;
    for (int kt = 0; kt < k_end; ++kt) {
      bool need = true;
      if (has_seg) {
        const int* ks = a.k_seg + (size_t)b * T + kt * kTile;
        int4 kr = empty_range();
        for (int c = lane; c < kTile; c += 32) {
          if (kt * kTile + c < T) kr = join(kr, range_of(ks[c]));
        }
        need = meet(qr, warp_join(kr));
      }
      if (need) {
        if (lane == 0) list[n] = kt;
        ++n;
      }
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int n_list = *count_s;

  int rseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rseg[i] = has_seg ? qseg_s[4 * ty + i] : 0;

  float o[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.f;
  }
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMClamp;
    l[i] = 0.f;
  }

  for (int it = 0; it < n_list; ++it) {
    const int k0 = list[it] * kTile;
    __syncthreads();                             // the last tile's K, V and P are read
    load_transposed<D>(Kt, kp, k0, T, tid);
    load_rows<D>(Vs, vp, k0, T, tid);
    if (has_seg && tid < kTile) {
      kseg_s[tid] = k0 + tid < T ? a.k_seg[(size_t)b * T + k0 + tid] : 0;
    }
    __syncthreads();

    // S = Q K^T, a 4 x 4 block a thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * kTile + 4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + d * kTile + 4 * tx);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }

    // scale, mask (-inf), online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = 4 * tx + j, key = k0 + kc;
        bool ok = key < T && (!a.causal || key <= row);
        if (has_seg) ok = ok && kseg_s[kc] == rseg[i];
        s[i][j] = ok ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], group16_max(mx));
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
      l[i] = l[i] * corr + group16_sum(ps);
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) o[i][c] *= corr;
    }
    // P^T [key][row]: a thread's four rows of one key as one float4
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * kTile + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // O += P V: rows 4 ty + i, columns 4 tx + 64 c + e
#pragma unroll 4
    for (int kc = 0; kc < kTile; ++kc) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + kc * kTile + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + kc * D + 64 * c + 4 * tx);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][4 * c + e] = fmaf(pa[i], va[e], o[i][4 * c + e]);
        }
      }
    }
  }

  // epilogue: normalise, zero dead rows, store O and LSE
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= T) continue;
    const bool alive = l[i] > 0.f;
    const float inv = alive ? 1.f / l[i] : 0.f;
    float* orow = a.out + (((size_t)b * a.H + h) * T + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      *reinterpret_cast<float4*>(orow + 64 * c + 4 * tx) =
          make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv, o[i][4 * c + 2] * inv,
                      o[i][4 * c + 3] * inv);
    }
    if (tx == 0) a.lse[((size_t)b * a.H + h) * T + row] = alive ? m[i] + logf(l[i]) : kLseSentinel;
  }
}

template <int D>
cudaError_t launch(const F32Args& a, int B, cudaStream_t s) {
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_fwd_f32_kernel<D>, configured, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, (a.T + kTile - 1) / kTile);
  flash_fwd_f32_kernel<D><<<grid, kThreads, F32Smem<D>::bytes(a.T), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. q [B,H,T,D], k/v [B,Hkv,T,D] float32,
// contiguous and 16-byte aligned; q_seg / k_seg [B,T] int32 or both null; out
// [B,H,T,D] f32; lse [B,H,T] f32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int slamkit_flash_fwd_f32(const float* q, const float* k, const float* v,
                                     const int* q_seg, const int* k_seg, float* out, float* lse,
                                     int B, int H, int Hkv, int T, int D, float sm_scale,
                                     int causal, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (k_seg == nullptr)) return (int)cudaErrorInvalidValue;
  F32Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_seg = q_seg;
  a.k_seg = k_seg;
  a.out = out;
  a.lse = lse;
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.causal = causal;
  a.scale = sm_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(a, B, s);
  if (D == 128) return (int)launch<128>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
