// Flash-attention forward for Hopper (sm_90a), bf16 in / f32 accumulate.
//
// Replaces: slamkit_tpu/ops/flash_attention.py::_fwd_kernel (launched by _fwd,
// public entry flash_attention). Same result: O = softmax(scale * Q K^T + mask) V
// and the row log-sum-exp, where the mask is causal (q_pos >= k_pos) AND equal
// segment ids; a row with no unmasked key outputs exactly 0 with LSE = +1e30.
// q heads are kv-major: q head h reads kv head h / (H / Hkv); kv is never
// repeated.
//
// What bounds it on the H100: at the Slam shape ([8, 14/2, 1024, 64], 8
// packed segments) the bytes (q, k, v read, out and LSE written, ~34 MB) take
// ~10 us at 3.35 TB/s and the products of the visible pairs ~4 us at 989
// TFLOP/s: bytes bound it. What holds it back is latency: a 64-row q tile of
// the packed batch sees only ~2-3 k tiles, so each CTA's fixed work (its Q
// load, finding its tiles, the first K/V loads, the epilogue) weighs as much
// as its products, and whatever runs per element (mask, exp) runs at the
// instruction rate of one warpgroup.
// What the design does about it:
//   * one CTA of one warpgroup per (64-row q tile, q head, batch row), the
//     last q tiles (under causality the heaviest) launched first and the G
//     q heads of a kv group next to each other, so their K/V tiles are read
//     while still in L2. Two heads of a group a CTA, sharing one ring and one
//     tile list, ran the Slam shape within the run-to-run spread of this
//     design on the card (NVIDIA H100 80GB HBM3, 700 W) and slower at short
//     rows, so a CTA is one head;
//   * the tile list first: before any K/V load the CTA reads the q tile's
//     and every candidate k tile's segment ids (one coalesced read, warp
//     votes, no shared-memory round trip a tile) and lists the k tiles that
//     can be seen, each marked interior when it needs no mask: below the
//     diagonal, before T, and with the q tile inside one segment that covers
//     the whole k tile. A block's pads (id < 0) keep a range of their own, so
//     a tile ending in a -1 tail is not taken to span every id. The C entry
//     keeps its signature and takes no scratch, so the list is built in the
//     CTA rather than by a pre-pass: its cost is the same one read of ids a
//     pre-pass's table would have needed, and there is one launch a call;
//   * loads: Q once into shared memory, K and V (and the keys' segment ids)
//     through a cp.async ring (3 stages at d = 64, 2 at d = 128 and 256), the
//     next tiles loading while this one multiplies; every tile is stored
//     128-byte swizzled, d = 128 (256) as two (four) 64-column halves;
//   * products on wgmma m64n64k16: S = Q K^T with both operands in shared
//     memory, then O += P V with P packed from the S accumulators straight
//     into A-operand registers and V read MN-major. At d = 128 the registers
//     allow it too (S 32, O 64, P 16 a thread; ptxas: 154 registers, no
//     spills), and on the card d128_ctx1024 ran in 0.037-0.040 ms: d = 128
//     stays on wgmma, O as two 64-column halves. d = 256 is the same code
//     with four halves: O is 128 registers a thread, Q and two stages of K
//     and V 160 KB of shared memory (one CTA an SM). No published decoder the
//     port reads needs it; it exists so that any head dim up to 256 runs, as
//     the JAX wrapper pads any d to a multiple of 128;
//   * the mask only on the tiles that need it, as -inf; every element's
//     exp is the SFU's 2^x with no branch (2^-inf = 0), the online softmax's
//     running max floored at -1e25 so a row that has seen nothing stays 0;
//   * no atomics and no split of the keys across CTAs: bitwise deterministic.
// Left for later work: the G heads of a group in a cluster with TMA
// multicast, and overlapping one tile's softmax with the next tile's S
// product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;               // q rows per CTA, keys per k tile
constexpr int kWarps = 4;               // a warpgroup, 16 q rows a warp
constexpr int kThreads = kWarps * 32;   // threads of a warpgroup
constexpr int kInterior = 1 << 30;      // a list entry's mark: the tile takes no mask
constexpr float kMClamp = -1e25f;       // running-max floor: 2^(-inf - m) == 0
constexpr float kLseSentinel = 1e30f;   // dead rows
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* q_seg;
  const int* k_seg;
  __nv_bfloat16* out;
  float* lse;
  int H, Hkv, T, causal;
  float scale_log2;
};

// Shared memory, in bytes from a 1024-aligned base: the Q tile, kStages (K
// tile, V tile) stages (each [64][D] as D / 64 swizzled [64][64] halves, as
// the Q tile), per stage 64 key segment ids, the q tile's two
// range halves and the list's length, then the k tiles' flags and the list,
// n_k ints each.
template <int D>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kQ = 0, kK = kTileBytes;
  static constexpr int kKseg = kK + kStages * 2 * kTileBytes;
  static constexpr int kQrange = kKseg + kStages * kTile * 4;
  static constexpr int kCount = kQrange + 2 * 16;
  static constexpr int kFlags = kCount + 16;
  static size_t bytes(int T) { return 1024 + kFlags + 8 * (size_t)((T + kTile - 1) / kTile); }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FwdArgs a) {
  using L = FwdSmem<D>;
  constexpr int NH = D / 64, S = L::kStages, kHalf = kTile * 64;   // halves of a [64][64] tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm + L::kQ);
  auto Ks = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(sm + L::kK + st * 2 * L::kTileBytes); };
  auto Vs = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(sm + L::kK + st * 2 * L::kTileBytes + L::kTileBytes);
  };
  int* kseg_s = reinterpret_cast<int*>(sm + L::kKseg);
  int4* qrange_s = reinterpret_cast<int4*>(sm + L::kQrange);
  int* count_s = reinterpret_cast<int*>(sm + L::kCount);

  const int T = a.T;
  const int n_k = (T + kTile - 1) / kTile;
  int* flags = reinterpret_cast<int*>(sm + L::kFlags);
  int* list = flags + n_k;
  const int q_tile = n_k - 1 - (int)blockIdx.z;   // the last first: it sees the most keys
  const int q0 = q_tile * kTile;
  const int h = blockIdx.x, hk = h / (a.H / a.Hkv), b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_seg = a.q_seg != nullptr;
  const size_t q_base = ((size_t)b * a.H + h) * T * D;
  const size_t kv_base = ((size_t)b * a.Hkv + hk) * T * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's two rows

  // Q: the first cp.async group
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    cp_tile_sw128<kTile, kThreads>(Qs + hh * kHalf, a.q + q_base + hh * 64, D, q0, T, tid);
  }
  cp_async_commit();

  // ---- the k tiles these rows can see, in order, marked interior or not
  const int k_end = a.causal ? min(n_k, q_tile + 1) : n_k;
  auto corner_free = [&](int k0) {           // before T, and (causal) below the diagonal
    return k0 + kTile <= T && (!a.causal || k0 + kTile - 1 <= q0);
  };
  int qseg0 = 0, qseg1 = 0;
  if (has_seg) {
    const int* qs = a.q_seg + (size_t)b * T;
    const int* ks = a.k_seg + (size_t)b * T;
    qseg0 = r0 < T ? qs[r0] : 0;
    qseg1 = r1 < T ? qs[r1] : 0;
    if (warp < 2) {                          // the q tile's ids; rows past T do not count
      const int row = q0 + warp * 32 + lane;
      const int4 r = warp_join(row < T ? range_of(qs[row]) : empty_range());
      if (lane == 0) qrange_s[warp] = r;
    }
    __syncthreads();
    const int4 qr = join(qrange_s[0], qrange_s[1]);
    // one id covers the q tile: uq
    const bool q_one = (qr.x == qr.y && qr.z > qr.w) || (qr.x > qr.y && qr.z == qr.w);
    const int uq = qr.x <= qr.y ? qr.x : qr.z;
    // warp w takes the k tiles w, w + 4, ...: two ids a lane, four tiles'
    // loads in flight before the votes
    for (int base = warp; base < k_end; base += 4 * kWarps) {
      int ids[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = (base + kWarps * u) * kTile + lane;
        ids[u][0] = key < T ? ks[key] : 0;
        ids[u][1] = key + 32 < T ? ks[key + 32] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kt = base + kWarps * u;
        if (kt >= k_end) break;                // uniform across the warp
        const int key = kt * kTile + lane;
        const bool v0 = key < T, v1 = key + 32 < T;
        const bool need = __any_sync(0xffffffffu, (v0 && in_range(ids[u][0], qr)) ||
                                                      (v1 && in_range(ids[u][1], qr)));
        const bool one = __all_sync(0xffffffffu, v0 && v1 && ids[u][0] == uq && ids[u][1] == uq);
        if (lane == 0) {
          flags[kt] = need ? (kt | (q_one && one && corner_free(kt * kTile) ? kInterior : 0)) : -1;
        }
      }
    }
  } else {
    for (int kt = tid; kt < k_end; kt += kThreads) {
      flags[kt] = kt | (corner_free(kt * kTile) ? kInterior : 0);
    }
  }
  __syncthreads();
  if (warp == 0) {                           // the listed tiles, in order
    int n = 0;
    for (int base = 0; base < k_end; base += 32) {
      const int t = base + lane;
      const int f = t < k_end ? flags[t] : -1;
      const unsigned ballot = __ballot_sync(0xffffffffu, f >= 0);
      if (f >= 0) list[n + __popc(ballot & ((1u << lane) - 1u))] = f;
      n += __popc(ballot);
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int n_list = *count_s;

  auto load_stage = [&](int it) {
    const int k0 = (list[it] & (kInterior - 1)) * kTile, st = it % S;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      cp_tile_sw128<kTile, kThreads>(Ks(st) + hh * kHalf, a.k + kv_base + hh * 64, D, k0, T, tid);
      cp_tile_sw128<kTile, kThreads>(Vs(st) + hh * kHalf, a.v + kv_base + hh * 64, D, k0, T, tid);
    }
    if (has_seg && tid < kTile) {
      const bool ok = k0 + tid < T;
      cp_async4(&kseg_s[st * kTile + tid], a.k_seg + (size_t)b * T + (ok ? k0 + tid : 0), ok);
    }
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_list) load_stage(st);
    cp_async_commit();
  }

  float o[NH][32], s[32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kMClamp, m1 = kMClamp;          // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;                  // per-thread partial row sums

  for (int it = 0; it < n_list; ++it) {
    cp_async_wait<S - 2>();                  // this tile (and Q) have landed
    fence_async_smem();
    __syncthreads();                         // ... for every thread; the last stage is free
    if (it + S - 1 < n_list) load_stage(it + S - 1);
    cp_async_commit();
    const int st = it % S, entry = list[it];
    const int k0 = (entry & (kInterior - 1)) * kTile;

    // S = Q K^T: 64 rows x 64 keys; accumulator element 4 j + e is row
    // 16 warp + g (+ 8 for e >= 2), key 8 j + 2 t4 + (e & 1)
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const uint64_t q_ = sw128_desc(Qs + hh * kHalf), k_ = sw128_desc(Ks(st) + hh * kHalf);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, q_ + 2 * kk, k_ + 2 * kk, hh + kk);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scale into the log2 domain; mask (-inf) only where the tile needs it
    if (entry & kInterior) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= a.scale_log2;
    } else {
      const int* kseg_t = kseg_s + st * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = j * 8 + 2 * t4;
        const int2 ksg = has_seg ? *reinterpret_cast<const int2*>(kseg_t + kj) : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kj + (e & 1);
          const int row = e < 2 ? r0 : r1;
          bool ok = key < T && (!a.causal || key <= row);
          if (has_seg) ok = ok && ((e & 1) ? ksg.y : ksg.x) == (e < 2 ? qseg0 : qseg1);
          s[4 * j + e] = ok ? s[4 * j + e] * a.scale_log2 : -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = fast_exp2(m0 - mn0), corr1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = fast_exp2(s[4 * j] - mn0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mn1);
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[hh][4 * j] *= corr0;
        o[hh][4 * j + 1] *= corr0;
        o[hh][4 * j + 2] *= corr1;
        o[hh][4 * j + 3] *= corr1;
      }
    }

    // O += P V: P (bf16) packed from the S accumulators as A fragments, the
    // k index being the key; V MN-major, 16 keys (rows of 128 bytes) a step
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const uint64_t v_ = sw128_desc(Vs(st) + hh * kHalf);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[hh], pa[kk], v_ + kk * kDescRows16);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(o[hh]);
  }
  cp_async_wait<0>();

  // epilogue: full row sums, normalise, zero dead rows, store O and LSE
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool alive0 = l0 > 0.f, alive1 = l1 > 0.f;
  const float inv0 = alive0 ? 1.f / l0 : 0.f;
  const float inv1 = alive1 ? 1.f / l1 : 0.f;
  __nv_bfloat16* o_r0 = a.out + q_base + (size_t)r0 * D;
  __nv_bfloat16* o_r1 = a.out + q_base + (size_t)r1 * D;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = hh * 64 + j * 8 + 2 * t4;
      if (r0 < T) {
        *reinterpret_cast<__nv_bfloat162*>(o_r0 + c) =
            __floats2bfloat162_rn(o[hh][4 * j] * inv0, o[hh][4 * j + 1] * inv0);
      }
      if (r1 < T) {
        *reinterpret_cast<__nv_bfloat162*>(o_r1 + c) =
            __floats2bfloat162_rn(o[hh][4 * j + 2] * inv1, o[hh][4 * j + 3] * inv1);
      }
    }
  }
  if (t4 == 0) {
    float* lse_bh = a.lse + ((size_t)b * a.H + h) * T;
    if (r0 < T) lse_bh[r0] = alive0 ? m0 * kLn2 + logf(l0) : kLseSentinel;
    if (r1 < T) lse_bh[r1] = alive1 ? m1 * kLn2 + logf(l1) : kLseSentinel;
  }
}

template <int D>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t s) {
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_fwd_kernel<D>, configured, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, (a.T + kTile - 1) / kTile);
  flash_fwd_kernel<D><<<grid, kThreads, FwdSmem<D>::bytes(a.T), s>>>(a);
  return cudaGetLastError();
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
  FwdArgs a;
  a.q = reinterpret_cast<const __nv_bfloat16*>(q);
  a.k = reinterpret_cast<const __nv_bfloat16*>(k);
  a.v = reinterpret_cast<const __nv_bfloat16*>(v);
  a.q_seg = q_seg;
  a.k_seg = k_seg;
  a.out = reinterpret_cast<__nv_bfloat16*>(out);
  a.lse = lse;
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.causal = causal;
  a.scale_log2 = sm_scale * kLog2e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(a, B, s);
  if (D == 128) return (int)launch<128>(a, B, s);
  if (D == 256) return (int)launch<256>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
