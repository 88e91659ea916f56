// Contraction-cost probe for Hopper (sm_90a): out [M, N] f32 = sum over `reps`
// repetitions of a [M, K] . b [K, N], bf16 in, f32 accumulation.
//
// Replaces: scripts/bench_flash.py::matmul_probe (its Pallas body `kern` :98),
// which asked the TPU whether a d = 64 contraction costs half of d = 128. The
// same question here, of wgmma, the instruction every flash product of the
// port runs on: S = Q K^T contracts over the head dim (K = 64 vs 128), O = P V
// produces it (N = 64 vs 128).
//
// What bounds it: the tensor cores. At [1024, 128] x [128, 1024] x 64 the
// products are 17.2 GFLOP (17.4 us at 989 TFLOP/s) against 4.5 MB of
// operands and result. The Pallas probe held both operands whole in VMEM.
// What the design does about it:
//   * one warpgroup a CTA and a 64 x BN output tile, BN = 128 where N allows
//     (m64n128k16, the flash kernels' dV / dK / dQ product at d = 128), else
//     64 (m64n64k16): a 1024 x 1024 result is 128 CTAs, one an SM;
//   * a operands from registers (A fragments read once from the swizzled
//     tile), b from 128-byte-swizzled shared memory read MN-major, so the
//     tensor cores read one operand's bytes from shared memory a step;
//   * K <= 128: both operands are loaded once and every repetition's products
//     are issued back to back, one commit and one wait for the whole call (the
//     K / 16 steps a repetition are a template argument, so nothing but the
//     loop counter runs between two products);
//   * larger K: 64-deep k chunks (a [64][64] and b [64][BN]) stream through a
//     4-stage cp.async ring, from L2 after the first repetition, the next
//     three loading while one multiplies. At K = 1024 and N = 64 or 128 the
//     grid has M / 64 = 16 CTAs: the N probes measure one SM's products, as
//     a flash CTA's head dim lives inside its own products.
// Shapes: M and N multiples of 64, K a multiple of 32 (the wrapper checks);
// a chunk past K is zero-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128, kBM = 64, kChunk = 64;
constexpr int kRing = 4;                  // stages of the streamed k chunks

template <int BN>
struct ProbeSmem {
  static constexpr int kA = kBM * kChunk * 2;              // [64][64], swizzled
  static constexpr int kB = kChunk * BN * 2;               // BN / 64 tiles of [64 k][64 n]
  static constexpr int kStage = kA + kB;
  static constexpr int kBytes = 1024 + kRing * kStage;
};

// RS: the K / 16 steps of a resident call (K <= 128), or 0 for a streamed one
template <int BN, int RS>
__global__ void __launch_bounds__(kThreads)
matmul_probe_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                    float* __restrict__ out, int K, int N, int reps) {
  using L = ProbeSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int chunks = (K + kChunk - 1) / kChunk, steps = K / 16;

  // chunk c (k in [64 c, 64 c + 64), zeros past K) into stage st
  auto load_chunk = [&](int c, int st) {
    unsigned char* As = sm + st * L::kStage;
    unsigned char* Bs = As + L::kA;
    for (int i = tid; i < kBM * 8; i += kThreads) {
      const int row = i >> 3, ch = i & 7, col = c * kChunk + ch * 8;
      const bool ok = col < K;
      cp_async16(As + row * 128 + ((ch ^ (row & 7)) << 4),
                 ok ? a + (size_t)(m0 + row) * K + col : a, ok);
    }
    for (int i = tid; i < kChunk * BN / 8; i += kThreads) {
      const int hh = i / (kChunk * 8), j = i % (kChunk * 8);
      const int row = j >> 3, ch = j & 7, kr = c * kChunk + row;
      const bool ok = kr < K;
      cp_async16(Bs + hh * kChunk * 128 + row * 128 + ((ch ^ (row & 7)) << 4),
                 ok ? b + (size_t)kr * N + n0 + hh * 64 + ch * 8 : b, ok);
    }
  };
  // the A fragment of k16 step kk of the chunk in stage st: rows 16 warp + g
  // (+ 8), k pairs 16 kk + 2 t4 (+ 8), read through the swizzle
  auto fragment = [&](uint32_t (&f)[4], int st, int kk) {
    const unsigned char* As = sm + st * L::kStage + (16 * warp + g) * 128 + 4 * t4;
    f[0] = *reinterpret_cast<const uint32_t*>(As + (((2 * kk) ^ g) << 4));
    f[1] = *reinterpret_cast<const uint32_t*>(As + 8 * 128 + (((2 * kk) ^ g) << 4));
    f[2] = *reinterpret_cast<const uint32_t*>(As + (((2 * kk + 1) ^ g) << 4));
    f[3] = *reinterpret_cast<const uint32_t*>(As + 8 * 128 + (((2 * kk + 1) ^ g) << 4));
  };
  // acc += A (registers) x the b rows of k16 step kk of stage st
  auto product = [&](float (&acc)[BN / 2], const uint32_t (&f)[4], int st, int kk) {
    const unsigned char* Bs = sm + st * L::kStage + L::kA;
    if constexpr (BN == 128) {
      wgmma_rs_mn(acc, f, sw128_desc_mn(Bs, kChunk * 128) + kk * kDescRows16);
    } else {
      wgmma_rs(acc, f, sw128_desc(Bs) + kk * kDescRows16);
    }
  };

  // every register a product reads is set before its first wgmma_fence: a
  // move ptxas finds between the fence and the products makes it serialize
  // every wgmma of the kernel
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  if constexpr (RS > 0) {
    for (int c = 0; c < chunks; ++c) load_chunk(c, c);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    uint32_t f[RS][4];
#pragma unroll
    for (int s = 0; s < RS; ++s) fragment(f[s], s / 4, s % 4);
    fence_regs(f);
    wgmma_fence();
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int s = 0; s < RS; ++s) product(acc, f[s], s / 4, s % 4);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  } else {
    const int total = reps * chunks;
#pragma unroll
    for (int st = 0; st < kRing - 1; ++st) {
      if (st < total) load_chunk(st % chunks, st);
      cp_async_commit();
    }
    for (int i = 0; i < total; ++i) {
      cp_async_wait<kRing - 2>();           // this chunk has landed
      fence_async_smem();
      __syncthreads();                      // ... for every thread; the last stage is free
      if (i + kRing - 1 < total) load_chunk((i + kRing - 1) % chunks, (i + kRing - 1) % kRing);
      cp_async_commit();
      const int st = i % kRing, left = steps - (i % chunks) * 4;
      uint32_t f[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < left) fragment(f[kk], st, kk);
      }
      fence_regs(f);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < left) product(acc, f[kk], st, kk);
      }
      wgmma_commit();
      wgmma_wait0();                        // the fragments are rewritten next chunk
      fence_regs(acc);
    }
    cp_async_wait<0>();
  }

  // element 4 j + e: row 16 warp + g (+ 8 for e >= 2), column 8 j + 2 t4 + (e & 1)
  float* o0 = out + (size_t)(m0 + 16 * warp + g) * N + n0 + 2 * t4;
  float* o1 = o0 + (size_t)8 * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int BN, int RS>
cudaError_t launch_t(const __nv_bfloat16* a, const __nv_bfloat16* b, float* out, int M, int K,
                     int N, int reps, cudaStream_t s) {
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(matmul_probe_kernel<BN, RS>, configured, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, M / kBM);
  matmul_probe_kernel<BN, RS><<<grid, kThreads, ProbeSmem<BN>::kBytes, s>>>(a, b, out, K, N,
                                                                             reps);
  return cudaGetLastError();
}

// K a multiple of 32: resident at 2, 4, 6 or 8 k16 steps, else streamed
template <int BN>
cudaError_t launch(const __nv_bfloat16* a, const __nv_bfloat16* b, float* out, int M, int K,
                   int N, int reps, cudaStream_t s) {
  switch (K / 16) {
    case 2: return launch_t<BN, 2>(a, b, out, M, K, N, reps, s);
    case 4: return launch_t<BN, 4>(a, b, out, M, K, N, reps, s);
    case 6: return launch_t<BN, 6>(a, b, out, M, K, N, reps, s);
    case 8: return launch_t<BN, 8>(a, b, out, M, K, N, reps, s);
    default: return launch_t<BN, 0>(a, b, out, M, K, N, reps, s);
  }
}

}  // namespace

// Plain C entry, bound with ctypes. a [M, K] and b [K, N] bf16, out [M, N]
// f32, all contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int slamkit_matmul_probe_bf16(const void* a, const void* b, float* out,
                                         int M, int K, int N, int reps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || reps <= 0 || M % kBM != 0 || N % 64 != 0 || K % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* ap = reinterpret_cast<const __nv_bfloat16*>(a);
  const auto* bp = reinterpret_cast<const __nv_bfloat16*>(b);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N % 128 == 0) return (int)launch<128>(ap, bp, out, M, K, N, reps, s);
  return (int)launch<64>(ap, bp, out, M, K, N, reps, s);
}
