// Building blocks shared by the Hopper (sm_90a) kernels of this package:
// flash_fwd.cu, flash_bwd.cu, dq_matmul.cu, matmul_probe.cu and the float32
// flash kernels.
//
//   * bf16 packing and the branch-free SFU exp2;
//   * cp.async (global -> shared, zero-filling what is out of range) and its
//     groups; 128-byte-swizzled tile loads in the layout wgmma reads;
//   * mma.sync m16n8k16; mma.sync m16n8k8 on TF32 and the
//     3xTF32 split that keeps float32 accuracy on the tensor cores;
//   * wgmma (bf16 in, f32 accumulate): m64n64k16 and m64n32k16 with both
//     operands from shared memory (m64n32k16 also as the first product of a
//     sum, writing its accumulators without reading them), m64n64k16 with A
//     from registers and B MN-major or K-major; m64n128k16
//     with A from registers and B K-major or MN-major (two swizzled halves);
//   * mbarriers (arrivals of threads, of their cp.async copies and of TMA
//     bytes) and 2-D and 3-D TMA tile loads, with the tensor maps they read;
//   * the named barrier of one warpgroup; the split cluster barrier and the
//     flash backward kernels' cluster size;
//   * segment-id ranges that keep a block's pads (id < 0) apart;
//   * the once-per-device opt-in to more than 48 KB of dynamic shared memory;
//   * per-CTA clock64 stamps of a kernel's phases, compiled in only under
//     -DSLAMKIT_CTA_CLOCKS (tools/cta_clocks.py builds such a library of its
//     own name; the main path's libraries hold no stamp).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; libcuda's functions are looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------- numbers --

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx, relative error ~2^-22, subnormal results
// flushed to 0: far below the bf16 rounding of P), called on every element
// (-inf where the mask is off) so that the warp never branches.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// ------------------------------------------------------------ cp.async --

// 16 (or 4) bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// what the generic proxy wrote to shared memory (or cp.async put there)
// becomes visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) x 64 columns at `col` of a slab with `stride`
// halves a row (rows < `rows` valid, zeros past) into a 128-byte-swizzled smem
// tile [ROWS][64] (the layout wgmma reads with SWIZZLE_128B: row r's 16-byte
// chunk c lands at chunk c ^ (r % 8); the tile starts 1024-byte aligned).
// THREADS threads share the copy.
template <int ROWS, int THREADS>
__device__ __forceinline__ void cp_tile_sw128(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int stride, int row0, int rows, int tid) {
  static_assert((ROWS * 8) % THREADS == 0, "tile load must split evenly");
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 3, ch = c & 7;
    const bool ok = row0 + row < rows;
    cp_async16(base + row * 128 + ((ch ^ (row & 7)) << 4),
               ok ? src + (size_t)(row0 + row) * stride + ch * 8 : src, ok);
  }
}

// ------------------------------------------------------ mbarrier, TMA ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` still to come from TMA
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// one arrival of the calling thread
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// one arrival, made when every cp.async the calling thread issued before it
// has landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar))
               : "memory");
}
// waits for the phase of parity `parity` to complete; a barrier that never
// completes (a fault) traps after ~2^28 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (i == (1u << 28)) __trap();
  }
}
// the box of a 2-D tensor map at (c0, innermost; c1) into shared memory,
// zeros where it passes the tensor's edges; the bytes count on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}

// the box of a 3-D tensor map at (c0, innermost; c1; c2), as tma_load_2d
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

// the 128 threads of warpgroup wg (named barrier 1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// ---------------------------------------------------------- cluster -----

// The cluster barrier split in two: every thread arrives at the kernel's
// entry and waits just before its first write to another CTA's shared
// memory, which is allowed only once every CTA of the cluster has started.
// The main loop runs between the two, so the wait costs almost nothing.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ mma.sync --

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16x8, f32) += A (16x8, tf32, row) * B (8x8, tf32, col). Fragments, with
// g = lane / 4 and t = lane % 4: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (k = t + 4, n = g); c0, c1 (g,
// 2 t + {0, 1}), c2, c3 (g + 8, 2 t + {0, 1}).
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: a float32 x as hi = tf32(x) and lo = tf32(x - hi), each rounded to
// nearest with ties away from zero (cvt.rna); a product a b is then
// lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in that order into float32
// accumulators (CUTLASS's OpMultiplyAddFastF32). Each product of two TF32
// values is exact in float32; only lo_a lo_b and the roundings of the lo
// parts are lost, ~2^-22 of |a b|, where one TF32 product loses ~2^-11.
// The rounding is cvt.rna.tf32.f32's for a finite x, taken in integer
// operations: add half of the 13 dropped bits' unit to the magnitude bits
// (a carry into the exponent is the round up), then clear them. cvt.rna
// itself compiles on sm_90a to a sequence guarded for inf and NaN, four
// instructions where this takes two. The tensor cores read a TF32 operand's
// top 19 bits and ignore the rest, so lo is passed with its bits uncleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}
// c[n] += A B[n] for n < N in 3xTF32, A and every B[n] already split; the
// three passes each run over all N independent accumulators, so that the
// products of one pass are in flight together
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(c[n], a_lo, b_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(c[n], a_hi, b_lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(c[n], a_hi, b_hi[n]);
}

// --------------------------------------------------------------- wgmma --

// Shared-memory matrix descriptor of a 128-byte-swizzled bf16 tile whose rows
// are 128 bytes (64 values): address >> 4, the leading byte offset (unused
// here: one swizzle atom spans the operand's contiguous dimension), the
// stride byte offset 1024 (the next group of 8 rows), SWIZZLE_128B. A K-major
// operand steps 16 deep by adding 2 (32 bytes); an MN-major one by adding
// 2048 >> 4 (16 rows of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}
constexpr uint64_t kDescRows16 = 2048 >> 4;
// The same for an MN-major operand 128 values wide, stored as two such
// tiles of [rows][64] (the first 64 columns, then the next), `half_bytes`
// apart: the leading byte offset is the step from one 64-wide half to the
// other, the stride byte offset (1024) the step of 8 rows down the k index.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* tile, uint32_t half_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFull) >> 4) | ((uint64_t)((half_bytes >> 4) & 0x3FFF) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define HOPPER_WGMMA_D32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_WGMMA_OUT32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
  "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 32, smem,
// K-major), and the first product of a sum: it writes d without reading it
// (scale-d off), so nothing the compiler must keep lives in d before it
#define HOPPER_WGMMA_D16                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_WGMMA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_WGMMA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),
        "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
// A's registers are an mma.sync m16n8k16 A fragment of the warp's 16 rows.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_rs_bk(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define HOPPER_WGMMA_D64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "     \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_WGMMA_OUT64(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_rs_bk(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOPPER_WGMMA_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major:
// two [16][64] halves, the descriptor from sw128_desc_mn)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_WGMMA_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// keeps the compiler from moving accesses to registers across the
// asynchronous wgmma region
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// ------------------------------------------------------- segment ranges --

// A block's segment ids as two ranges, (x, y) over the ids >= 0 and (z, w)
// over the pads' (< 0), each empty as (INT_MAX, INT_MIN): a tile that ends in
// a -1 tail then does not seem to span every id between -1 and its last.
__device__ __forceinline__ int4 empty_range() {
  return make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
}
__device__ __forceinline__ int4 join(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), max(a.y, b.y), min(a.z, b.z), max(a.w, b.w));
}
__device__ __forceinline__ bool meet(int4 a, int4 b) {
  return (a.x <= b.y && b.x <= a.y) || (a.z <= b.w && b.z <= a.w);
}
// the range of one id
__device__ __forceinline__ int4 range_of(int id) {
  return id >= 0 ? make_int4(id, id, INT_MAX, INT_MIN) : make_int4(INT_MAX, INT_MIN, id, id);
}
// whether an id falls in a range
__device__ __forceinline__ bool in_range(int id, int4 r) {
  return id >= 0 ? (r.x <= id && id <= r.y) : (r.z <= id && id <= r.w);
}
// the join over a warp's lanes, in every lane
__device__ __forceinline__ int4 warp_join(int4 r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r = join(r, make_int4(__shfl_xor_sync(0xffffffffu, r.x, off),
                          __shfl_xor_sync(0xffffffffu, r.y, off),
                          __shfl_xor_sync(0xffffffffu, r.z, off),
                          __shfl_xor_sync(0xffffffffu, r.w, off)));
  }
  return r;
}

// the ranges of the 32-row blocks [blk0, blk1) of one row's table, joined
__device__ __forceinline__ int4 block_range(const int4* table, int blk0, int blk1, int n_blk) {
  int4 r = empty_range();
  for (int i = blk0; i < blk1 && i < n_blk; ++i) r = join(r, table[i]);
  return r;
}

// ---------------------------------------------------------- CTA clocks --

// Under SLAMKIT_CTA_CLOCKS, thread 0 of every CTA writes clock64() at each of
// a kernel's marks (kMarkEntry .. kMarkEnd) into the buffer of its slot (one
// slot per kernel of a call), [CTAs in launch order][kClockWords], and the
// tiles it visited into the last word; a null slot writes nothing. The host
// sets a slot with slamkit_cta_clocks(slot, buffer). Without the macro the
// stamps compile to nothing.
enum { kMarkEntry = 0, kMarkListed = 1, kMarkFirstTile = 2, kMarkLoopEnd = 3, kMarkEnd = 4,
       kClockWords = 6 };
#ifdef SLAMKIT_CTA_CLOCKS
__device__ unsigned long long* g_cta_clocks[2];
__device__ __forceinline__ unsigned long long* cta_clock_row(int slot) {
  unsigned long long* buf = g_cta_clocks[slot];
  if (buf == nullptr || threadIdx.x != 0) return nullptr;
  const size_t cta = blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
  return buf + cta * kClockWords;
}
__device__ __forceinline__ void cta_stamp(int slot, int mark) {
  if (unsigned long long* row = cta_clock_row(slot)) row[mark] = clock64();
}
__device__ __forceinline__ void cta_tiles(int slot, int tiles) {
  if (unsigned long long* row = cta_clock_row(slot)) row[kClockWords - 1] = (unsigned)tiles;
}
#define CTA_STAMP(slot, mark) hopper::cta_stamp(slot, mark)
#define CTA_TILES(slot, tiles) hopper::cta_tiles(slot, tiles)
#else
#define CTA_STAMP(slot, mark) ((void)0)
#define CTA_TILES(slot, tiles) ((void)0)
#endif

// ---------------------------------------------------------------- host --

// The portable cluster size, and the largest size up to it that divides G:
// the flash backward kernels spread a kv group's G heads over that many CTAs
// (G itself for every preset: G = 1, 3, 4, 6, 7 or 8)
constexpr int kMaxCluster = 8;
inline int cluster_size(int G) {
  for (int c = G < kMaxCluster ? G : kMaxCluster; c > 1; --c) {
    if (G % c == 0) return c;
  }
  return 1;
}

// once per device, on the first (eager) call, not inside a graph capture:
// allow a kernel the card's whole opt-in shared memory
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, unsigned long long& configured, int dev) {
  if ((configured >> dev) & 1ull) return cudaSuccess;
  int most = 0;
  cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  configured |= 1ull << dev;
  return cudaSuccess;
}

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime,
// so that the library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A row-major bf16 matrix [rows][cols] (cols a multiple of 8, the base
// 16-byte aligned) read in boxes of box_rows rows x 64 columns (128 bytes),
// 128-byte swizzled as wgmma reads a K-major operand; zeros past the edges.
// A host computation: nothing is enqueued, so it may run during a capture.
inline cudaError_t tmap_bf16_sw128(CUtensorMap* map, const void* base, int rows, int cols,
                                   int box_rows) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 tensor [depth][rows][cols] (cols a multiple of 8, the base 16-byte
// aligned) read in boxes of one slab x box_rows rows x 64 columns, 128-byte
// swizzled as tmap_bf16_sw128; zeros past the rows (and columns) of a slab,
// so a box that passes the end of one slab never reads the next.
inline cudaError_t tmap_bf16_sw128_3d(CUtensorMap* map, const void* base, int depth, int rows,
                                      int cols, int box_rows) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper

#ifdef SLAMKIT_CTA_CLOCKS
// points slot `slot` (0 or 1) of the stamps at `buffer` (device memory, or
// null to stop stamping)
extern "C" int slamkit_cta_clocks(int slot, void* buffer) {
  if (slot < 0 || slot > 1) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(hopper::g_cta_clocks, &buffer, sizeof(buffer),
                                 slot * sizeof(buffer));
}
#endif
