// Flash-attention forward for Hopper (sm_90a) in float32: float32 in, float32
// out, float32 accuracy from 3xTF32 products on the tensor cores.
//
// Replaces: slamkit_tpu/ops/flash_attention.py::_fwd_kernel (launched by _fwd,
// public entry flash_attention) where it is given float32 inputs: the Pallas
// kernel runs in its inputs' dtype, and the JAX package scores text with a
// float32 UnitLM (metric/metric_utils.py::get_llm, the GenPPL text LM and
// the LLM judge) and trains in float32 when model.config_args.torch_dtype
// says so. Same result as the bf16 kernel (flash_fwd.cu): O =
// softmax(scale * Q K^T + mask) V and the row log-sum-exp, the mask causal
// (q_pos >= k_pos) AND equal segment ids (pads, id < 0, see other pads), keys
// at or past T masked; a row with no unmasked key outputs exactly 0 with LSE
// = +1e30. q heads are kv-major: q head h reads kv head h / (H / Hkv).
//
// What bounds it on the H100: the visible pairs' 4 D FLOPs in float32. The
// CUDA cores give 67 TFLOP/s; TF32 on the tensor cores gives 495, and
// 3xTF32 takes three TF32 products for each float32 one, so 165 TFLOP/s of
// float32 work. At the text LM's scoring batch ([8, 32/8, 3584, 64], rows of
// 1700-3584 tokens) that is ~1.7 ms against ~0.1 ms of bytes: operations
// bound it.
// What held the CUDA-core version back (tools/cta_clocks.py on an H100,
// before the redesign): a 64 x 64 tile took ~27k cycles of FMAs, and
// building the tile list one tile at a time in one warp took 14-22k cycles
// a CTA at the packed training shapes, 74-143k at GenPPL's and the judge's
// long rows.
// What the design does:
//   * products on the tensor cores in 3xTF32 (hopper.cuh: mma.sync
//     m16n8k8, each float32 operand split into a TF32 hi and lo part as its
//     fragment is read, lo_a hi_b + hi_a lo_b + hi_a hi_b accumulated in
//     float32): ~2^-22 of each product is lost, where one TF32 product would
//     lose ~2^-11, so the kernel stays within the float32 version's bounds
//     (tests/test_torch_tf32_split.py emulates both on the CPU). P is split
//     as float32, never rounded to bf16;
//   * one CTA of 4 warps per (64-row q tile, q head, batch row), the last q
//     tiles (the heaviest under causality) launched first. A warp owns 16 q
//     rows, so the online softmax's row max and sum stay in its registers
//     (four threads a row, two quad shuffles), and P goes from the S
//     accumulators straight into the A fragments of P V: the key order of a
//     k step is permuted to the accumulator's, and V's rows are read in the
//     same order (f32_tiles.cuh);
//   * the tile list first, built by all four warps at once from one
//     coalesced read of the ids, before any tile is loaded: the k tiles the q
//     tile can see, each marked interior when it needs no mask (below the
//     diagonal, before T, one segment over both tiles). A block's pads (id <
//     0) keep a range of their own;
//   * the tensor cores add each product to their float32 accumulator
//     without rounding to nearest, a bias that grows with the number of adds
//     (on an H100, over GenPPL's 3584 keys, 1.3e-4 of |O| on a real model's
//     activations, where the float32 version's error was 9e-6): a tile's
//     P V starts from zero (24 adds) and is added to O in float32;
//   * loads: Q once, K, V and the keys' ids through a 2-stage cp.async ring
//     of [64][D + 4] tiles (the pad spreads every fragment read over the 32
//     banks), the next tile loading while this one multiplies;
//   * softmax in the base-2 domain on the SFU (ex2.approx, ~2^-22
//     relative), the running max floored at -1e25 so a row that has seen
//     nothing stays 0;
//   * no atomics and no split of the keys: bitwise deterministic.
// Shared memory: 87 KB at d = 64 (two CTAs an SM), 169 KB at d = 128. At
// d = 256 two stages of 64-key tiles would not fit (260 KB), so its k tiles
// are 32 keys (195 KB), and its P V runs 32 columns at a time, so that O's
// 128 registers a thread leave room for the fragments.
// Left for later work: mma.sync holds the tensor cores to about a third of
// their TF32 rate here; wgmma on TF32 with the tiles in swizzled shared
// memory is the next step. A warp of 32 q rows (two m16 tiles sharing each
// split K or V fragment, 128-row q tiles) ran GenPPL's rows ~15% faster and
// the packed training rows ~10% slower on the H100, and spilled once each
// tile's P V took a fresh accumulator.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <stdint.h>

#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace f32_tiles;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kMClamp = -1e25f;
constexpr float kLseSentinel = 1e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

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

// Shared memory in floats: Q [64][D + 4]; kStages x (K, V [KT][D + 4], the
// keys' ids [KT]); the list's length; the flags and the list (n_k each).
template <int D>
struct Smem {
  static constexpr int KT = D > 128 ? 32 : kTile;   // keys a tile
  static constexpr int kTileF = kTile * Ld<D>::value, kTileK = KT * Ld<D>::value;
  static constexpr int kQ = 0, kStage = kQ + kTileF;
  static constexpr int kStageF = 2 * kTileK + KT;
  static constexpr int kCount = kStage + kStages * kStageF, kFlags = kCount + 4;
  static size_t bytes(int T) { return 4 * ((size_t)kFlags + 2 * ((T + KT - 1) / KT)); }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const F32Args a) {
  using L = Smem<D>;
  constexpr int KT = L::KT, NK = KT / 8;         // keys a tile; its 8-key tiles
  constexpr int NO = D / 8;                      // 8-column tiles of O a warp holds
  constexpr int NP = D > 128 ? 4 : 8;            // ... of one P V part
  extern __shared__ float smem[];
  float* Qs = smem + L::kQ;
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  auto Ks = [&](int st) { return smem + L::kStage + st * L::kStageF; };
  auto Vs = [&](int st) { return Ks(st) + L::kTileK; };
  auto ksegs = [&](int st) { return reinterpret_cast<int*>(Ks(st) + 2 * L::kTileK); };

  const int T = a.T, n_k = (T + KT - 1) / KT;
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);
  int* list = flags + n_k;
  // the last q tile first: it sees the most keys
  const int q_tile = (T + kTile - 1) / kTile - 1 - (int)blockIdx.z;
  const int q0 = q_tile * kTile;
  const int h = blockIdx.x, hk = h / (a.H / a.Hkv), b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = a.q_seg != nullptr;
  const float* qp = a.q + ((size_t)b * a.H + h) * T * D;
  const float* kp = a.k + ((size_t)b * a.Hkv + hk) * T * D;
  const float* vp = a.v + ((size_t)b * a.Hkv + hk) * T * D;
  const int* ks_row = has_seg ? a.k_seg + (size_t)b * T : nullptr;
  CTA_STAMP(0, kMarkEntry);

  // ---- the k tiles these rows can see, marked interior or not; listed
  // before any tile is loaded, so that the ids' reads do not queue behind
  // the first wave's tile copies
  const int k_end = a.causal ? min(n_k, (q0 + kTile - 1) / KT + 1) : n_k;
  bool q_one = true;
  int uq = 0;
  int4 qr = empty_range();
  if (has_seg) qr = rows_range<kTile>(a.q_seg + (size_t)b * T, q0, T, lane, q_one, uq);
  auto corner_free = [&](int kt) {               // before T, and (causal) below the diagonal
    return kt * KT + KT <= T && (!a.causal || kt * KT + KT - 1 <= q0);
  };
  const int n_list = list_tiles<KT, kWarps>(flags, list, count_s, ks_row, qr, q_one, uq, 0,
                                               k_end, T, tid, corner_free);
  CTA_STAMP(0, kMarkListed);
  CTA_TILES(0, n_list);

  auto load_stage = [&](int it) {
    const int k0 = (list[it] & (kInterior - 1)) * KT, st = it % kStages;
    cp_rows<KT, D, kThreads>(Ks(st), kp, k0, T, tid);
    cp_rows<KT, D, kThreads>(Vs(st), vp, k0, T, tid);
    if (has_seg) cp_vals<KT>(ksegs(st), ks_row, k0, T, tid);
  };
  cp_rows<kTile, D, kThreads>(Qs, qp, q0, T, tid);
  if (n_list > 0) load_stage(0);
  cp_async_commit();                             // group 0: Q and stage 0

  const int wr = warp * 16;                      // this warp's rows in the tile
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const int qseg0 = has_seg && row0 < T ? a.q_seg[(size_t)b * T + row0] : 0;
  const int qseg1 = has_seg && row1 < T ? a.q_seg[(size_t)b * T + row1] : 0;
  const float scale_log2 = a.scale * kLog2e;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m[2] = {kMClamp, kMClamp}, l[2] = {0.f, 0.f};   // rows g, g + 8 (l: this thread's part)

  for (int it = 0; it < n_list; ++it) {
    cp_async_wait<kStages - 2>();                // this tile (and Q) have landed
    __syncthreads();                             // ... for every thread; the last stage is free
    if (it + kStages - 1 < n_list) load_stage(it + kStages - 1);
    cp_async_commit();
    if (it == 0) CTA_STAMP(0, kMarkFirstTile);
    const int st = it % kStages, entry = list[it];
    const int k0 = (entry & (kInterior - 1)) * KT;
    const float* Kt = Ks(st);
    const float* Vt = Vs(st);

    // S = Q K^T: this warp's 16 rows x KT keys, NK tiles of 8 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      float x[4];
      uint32_t a_hi[4], a_lo[4], b_hi[NK][2], b_lo[NK][2];
      frag_a<D>(x, Qs, wr, 8 * kk, g, t4);
      split_tf32(x, a_hi, a_lo);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        float y[2];
        frag_b_nrows<D>(y, Kt, 8 * kk, 8 * n, g, t4);
        split_tf32(y, b_hi[n], b_lo[n]);
      }
      mma_3xtf32(s, a_hi, a_lo, b_hi, b_lo);
    }

    // scale (base 2), mask (-inf), online softmax; P back into s
    const bool interior = entry & kInterior;
    const int* kseg_t = ksegs(st);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0, qseg = half ? qseg1 : qseg0;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * half + e] * scale_log2;
          if (!interior) {
            const int kc = 8 * n + 2 * t4 + e, key = k0 + kc;
            bool ok = key < T && (!a.causal || key <= row);
            if (has_seg) ok = ok && kseg_t[kc] == qseg;
            x = ok ? x : -INFINITY;
          }
          s[n][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[half], mx);
      const float corr = fast_exp2(m[half] - mn);
      m[half] = mn;
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(s[n][2 * half + e] - mn);
          s[n][2 * half + e] = p;
          ps += p;
        }
      }
      l[half] = l[half] * corr + ps;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * half] *= corr;
        o[n][2 * half + 1] *= corr;
      }
    }

    // O += P V: k steps of 8 keys, P from the accumulators, V's rows permuted
    // alike. The tensor cores add a product to their accumulator without
    // rounding to nearest (a bias that grows with the adds: over thousands
    // of keys, 1.3e-4 of |O| on a real model's activations), so
    // each tile's P V starts from zero, 8 NP columns at a time, and is
    // added to O in float32
#pragma unroll
    for (int c = 0; c < NO / NP; ++c) {
      float part[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float x[4];
        uint32_t a_hi[4], a_lo[4], b_hi[NP][2], b_lo[NP][2];
        frag_a_from_acc(x, s[j]);
        split_tf32(x, a_hi, a_lo);
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          float y[2];
          frag_b_krows<D>(y, Vt, 8 * j, 8 * NP * c + 8 * n, g, t4);
          split_tf32(y, b_hi[n], b_lo[n]);
        }
        mma_3xtf32(part, a_hi, a_lo, b_hi, b_lo);
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[NP * c + n][e] += part[n][e];
      }
    }
  }
  cp_async_wait<0>();                            // no copy outlives the CTA
  CTA_STAMP(0, kMarkLoopEnd);

  // epilogue: the row sums over the quad, normalise, zero dead rows, store
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = half ? row1 : row0;
    if (row >= T) continue;
    const bool alive = sum > 0.f;
    const float inv = alive ? 1.f / sum : 0.f;
    float* orow = a.out + (((size_t)b * a.H + h) * T + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
    if (t4 == 0) {
      a.lse[((size_t)b * a.H + h) * T + row] =
          alive ? (m[half] + log2f(sum)) * kLn2 : kLseSentinel;
    }
  }
  CTA_STAMP(0, kMarkEnd);
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
  flash_fwd_f32_kernel<D><<<grid, kThreads, Smem<D>::bytes(a.T), s>>>(a);
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
  if (D == 256) return (int)launch<256>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
