// Tensor-core building blocks shared by the bf16 flash-attention kernels:
// inline PTX for `mma.sync` (m16n8k16, bf16 in, fp32 accumulators),
// `ldmatrix` (8x8 b16 tiles, plain and transposed) and `cp.async` (global to
// shared, with zero fill). No CUTLASS or CuTe, so a build takes seconds.
//
// Fragments of one warp (lane = threadIdx.x % 32, g = lane / 4, t = lane % 4):
//   A, 16x16 row-major:  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B, 16x8 (k x n):     b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C, 16x8 fp32:        c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// Two neighbouring C tiles of one 16-row band, packed to bf16 pairs, are the
// A fragment of a product over their 16 columns (pack_a), so a score tile
// goes from the accumulators into the next product without shared memory.
//
// Shared tiles are row-major bf16 with rows padded by 8 elements (16 bytes):
// the 8 rows that one ldmatrix matrix reads then start in 8 different groups
// of 4 banks, free of conflicts.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fa_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is
// not read then, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a·b over one m16n8k16 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, one instruction (exp2f adds range
// handling for results below 2^-126, which p = 2^(s − m) rounds away anyway)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to nearest bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment over columns 16·kk..16·kk+15 of a row band held as C tiles
// c[2kk] and c[2kk+1], rounded to bf16 (`x.astype(bf16)` before a product).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Where this lane points ldmatrix for the A fragment of rows r0..r0+15,
// columns k0..k0+15 of a row-major tile.
__device__ __forceinline__ const bf16* a_ptr(const bf16* tile, int stride, int r0,
                                             int k0, int lane) {
  return tile + (r0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8;
}

// ... for the B fragments (r0, r1: n tile 0; r2, r3: n tile 1) of columns
// n0..n0+15 and depth k0..k0+15, from a tile stored [n][k] (non-transposed
// ldmatrix): K for q·kᵀ.
__device__ __forceinline__ const bf16* b_ptr_nk(const bf16* tile, int stride, int n0,
                                                int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
         ((lane >> 3) & 1) * 8;
}

// ... from a tile stored [k][n] (transposed ldmatrix): V for p·v.
__device__ __forceinline__ const bf16* b_ptr_kn(const bf16* tile, int stride, int k0,
                                                int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + n0 +
         (lane >> 4) * 8;
}

// Start copying `rows` rows of D bf16 each (row `row0` on, stride `row_stride`
// elements) into a padded shared tile; rows at or past `seq` are zeros.
template <int D, int kRowsTile, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t row_stride, int row0, int seq) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  constexpr int kTotal = kRowsTile * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool in = row < seq;
    cp_async16(dst + r * kStride + c, src + (in ? row : 0) * row_stride + c, in);
  }
}

// Start copying `n` fp32 row statistics (lse or δ) from row `row0` on; zeros
// past `seq`. 4-byte copies: a head's rows start anywhere when S % 4 != 0.
template <int n, int kThreads>
__device__ __forceinline__ void load_stats(float* dst, const float* src, int row0,
                                           int seq) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in = row0 + i < seq;
    cp_async4(dst + i, src + (in ? row0 + i : 0), in);
  }
}

}  // namespace fa_mma
