// Hopper (sm_90a) building blocks shared by the bf16 flash-attention kernels:
// inline PTX for TMA tile loads (`cp.async.bulk.tensor`), `mbarrier`s,
// `wgmma.mma_async` (bf16 in, fp32 accumulators) and `setmaxnreg`, and the
// host-side tensor maps. No CUTLASS or CuTe, so a build takes seconds.
//
// Accumulators of one `wgmma` m64nN (warp w of the warpgroup, lane, g = lane
// / 4, t = lane % 4): element i is row 16w + g + 8·((i / 2) % 2), column
// 8·(i / 4) + 2t + i % 2. The A fragment of a register-sourced m64k16
// product holds (rows g, g + 8; columns 2t, 2t + 1, 8 + 2t, 9 + 2t) of the
// same band, so two neighbouring n8 blocks of a score accumulator, packed to
// bf16 pairs, are the A operand of a product over their 16 columns
// (pack_a): a score tile goes from the accumulators into the next product
// without shared memory.
//
// Shared tiles are what TMA writes: a [rows][D] bf16 tile in column boxes of
// min(D, 64) values, each box [rows][box] with rows of 64 or 128 bytes,
// swizzled by TMA with the 64- or 128-byte pattern (a 128-byte swizzle caps a
// box's inner dimension at 128 bytes, so D = 128 is two boxes; D = 32 rows are
// 64 bytes and take the 64-byte pattern). Every box starts on a 1024-byte
// boundary, so the pattern's 8-row atoms (512 or 1024 bytes) are aligned and
// a `wgmma` descriptor with the same swizzle mode reads what TMA wrote:
//   K-major (the product's depth runs along a row: q, k for q·kᵀ):
//     stride byte offset = 8 rows; the k16 step kk starts 32·kk bytes into
//     the row (the next box past the row's end); leading byte offset unused.
//   MN-major (depth runs down the rows: v for p·v, the transpose bit set):
//     stride byte offset = 8 rows (the next 8 depth rows); the k16 step kk
//     starts 16·kk rows down; leading byte offset = one box (unused: an
//     n64 product spans one box, D = 128 takes two).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa_sm90 {

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The A fragment over columns 16·kk..16·kk+15 of a row band held as
// accumulator n8 blocks `lo` = acc[8kk..8kk+3] and `hi` = acc[8kk+4..8kk+7],
// rounded to bf16 (`x.astype(bf16)` before a product).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* lo, const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---- mbarriers: a phase completes when its arrivals are in and, after an
// expect_tx, the bytes TMA was told to deliver have landed.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// adds `bytes` to the current phase's expected transfer without arriving
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier is
// in phase 0, so waiting on parity 1 passes at once). A wait that spins for
// ~20 s traps: a lost arrival then ends the launch with an error instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// ---- TMA: one thread asks for a box of a 4-D tensor map (D, H, S, B) to be
// copied into shared memory; coordinates past the tensor's end read zeros.

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- register budget of warp-specialised blocks

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ---- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every committed group of products is done
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties registers to this point of the program: after wgmma_wait0 it keeps the
// compiler from reading an accumulator, or reusing a register-sourced A
// operand, before the asynchronous product is done.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// A [rows][D] bf16 tile as TMA lays it out (see the top of this file).
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64 and 128");
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;             // 64 or 128
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kAtom = 8 * kRowBytes;           // 8 rows: 1024 or 512 bytes
  static constexpr int kBoxRows = 64;                        // rows per TMA box
  static constexpr uint32_t bytes(int rows) { return static_cast<uint32_t>(rows) * D * 2; }

  // K-major operand: rows r0..r0+63 (or ..+N−1) of a `rows`-row tile, depth k16 step kk
  __device__ static uint64_t desc_k(uint32_t base, int rows, int r0, int kk) {
    const int byte = kk * 32;
    return make_desc(base + (byte / kRowBytes) * rows * kRowBytes + r0 * kRowBytes +
                         byte % kRowBytes,
                     16, kAtom, kSwizzle);
  }

  // MN-major operand: depth rows 16·kk..16·kk+15, columns of box nb
  __device__ static uint64_t desc_mn(uint32_t base, int rows, int kk, int nb) {
    return make_desc(base + nb * rows * kRowBytes + kk * 16 * kRowBytes, rows * kRowBytes,
                     kAtom, kSwizzle);
  }

  // Issue the TMA loads of rows row0..row0+rows−1 (64-row boxes, every
  // column box) of one (head, batch) into the tile at `base`, completing on
  // `bar`. One thread.
  __device__ static void load(uint32_t base, int rows, const CUtensorMap* map, uint32_t bar,
                              int head, int batch, int row0) {
#pragma unroll
    for (int cb = 0; cb < kBoxes; ++cb)
      for (int rb = 0; rb < rows / kBoxRows; ++rb)
        tma_load_4d(base + (cb * rows + rb * kBoxRows) * kRowBytes, map, bar, cb * kBoxCols,
                    head, row0 + rb * kBoxRows, batch);
  }
};

// D = 72 (DiT-XL/2): a `wgmma` steps through the depth 16 values at a time,
// so the kernel pads the head dim to 80. A [rows][72] tile is two column
// boxes: columns 0..63 as Tile<64> lays them (128-byte rows, 128-byte
// swizzle), then, after them, columns 64..79 in 32-byte rows with the 32-byte
// swizzle (its 8-row atom is 256 bytes). Both boxes are loaded through tensor
// maps of the true width 72, so TMA fills columns 72..79 with zeros: they add
// nothing to q·kᵀ, and the output columns they give are never stored.
struct Tile72 {
  static constexpr int kPadded = 80;
  static constexpr int kBoxRows = 64;
  static constexpr uint32_t bytes(int rows) { return static_cast<uint32_t>(rows) * kPadded * 2; }

  // the 16-column box of a `rows`-row tile
  __device__ static uint32_t tail(uint32_t base, int rows) { return base + rows * 128; }

  // K-major operand: steps kk 0..3 read the 128-byte box, step 4 the 32-byte one
  __device__ static uint64_t desc_k(uint32_t base, int rows, int r0, int kk) {
    if (kk < 4) return make_desc(base + r0 * 128 + kk * 32, 16, 1024, 1);
    return make_desc(tail(base, rows) + r0 * 32, 16, 256, 3);
  }

  // MN-major operand: depth rows 16·kk..16·kk+15 of box nb (0: columns 0..63, 1: 64..79)
  __device__ static uint64_t desc_mn(uint32_t base, int rows, int kk, int nb) {
    if (nb == 0) return make_desc(base + kk * 16 * 128, rows * 128, 1024, 1);
    return make_desc(tail(base, rows) + kk * 16 * 32, rows * 32, 256, 3);
  }

  // Rows row0..row0+rows−1 of one (head, batch): `map` gives columns 0..63,
  // `tail_map` (16-column boxes) columns 64..79. One thread.
  __device__ static void load(uint32_t base, int rows, const CUtensorMap* map,
                              const CUtensorMap* tail_map, uint32_t bar, int head, int batch,
                              int row0) {
    for (int rb = 0; rb < rows / kBoxRows; ++rb) {
      tma_load_4d(base + rb * kBoxRows * 128, map, bar, 0, head, row0 + rb * kBoxRows, batch);
      tma_load_4d(tail(base, rows) + rb * kBoxRows * 32, tail_map, bar, 64, head,
                  row0 + rb * kBoxRows, batch);
    }
  }
};

// D[64 x 32] (+)= A·B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A·B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A·B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 16] += A·B, A from registers (the accumulator layout packed to bf16), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// D[64 x 32] += A·B, A from registers (the accumulator layout packed to bf16), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// D[64 x 64] += A·B, A from registers (the accumulator layout packed to bf16), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// One S-like product step: m64 x N, A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "score tiles of 32, 64 or 128 columns");
  if constexpr (N == 32) {
    wgmma_ss_n32(d, desc_a, desc_b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, accumulate);
  } else {
    wgmma_ss_n128(d, desc_a, desc_b, accumulate);
  }
}

// One m64 x D product step with a register A operand: D ≤ 64 is one wgmma;
// D = 128 two, one per column box of B.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint32_t base, int rows, int kk) {
  if constexpr (D == 32) {
    wgmma_rs_n32(d, a, Tile<D>::desc_mn(base, rows, kk, 0));
  } else {
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
      wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&d[32 * nb]), a,
                   Tile<D>::desc_mn(base, rows, kk, nb));
  }
}

// The D = 72 step: n64 over Tile72's first box into d[0..31], n16 over the
// second into d[32..39] (output columns 64..79; 72..79 are padding).
__device__ __forceinline__ void wgmma_rs72(float (&d)[40], const uint32_t (&a)[4], uint32_t base,
                                           int rows, int kk) {
  wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&d[0]), a, Tile72::desc_mn(base, rows, kk, 0));
  wgmma_rs_n16(*reinterpret_cast<float(*)[8]>(&d[32]), a, Tile72::desc_mn(base, rows, kk, 1));
}

// ---- host: tensor maps over [B, S, H, D] bf16 views

// returned by the C entry points when cuTensorMapEncodeTiled fails: this
// offset plus its CUresult (cudaError_t values stay below it)
constexpr int kEncodeError = 100000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime. It is looked
// up once through the runtime's cudaGetDriverEntryPoint rather than by
// linking -lcuda: the library then needs no libcuda stub at build time and
// takes the libcuda the process (PyTorch) already loaded.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// libcuda's calls want a current context, which a thread that has made no
// runtime call yet lacks: PyTorch runs a backward on a thread of its own,
// whose first CUDA work may be this library's. cudaFree(nullptr) makes the
// device's primary context current and does nothing else. Once a thread:
// the context stays current, and cudaFree may not be called while the
// thread captures a CUDA graph (a captured step's first steps run eagerly).
inline int bind_context() {
  thread_local int bound = -1;
  if (bound != 0) bound = static_cast<int>(cudaFree(nullptr));
  return bound;
}

// Encode a map over the view [batch, seq, heads, dim] (element strides `st`,
// last dim contiguous) as the 4-D tensor (dim, heads, seq, batch) with byte
// strides, boxes of (box_cols, 1, 64, 1) and the swizzle the kernels'
// descriptors read: box_cols 64 (the default above D = 32) takes 128 B, 32
// (the default at D = 32) 64 B, 16 (Tile72's second box) 32 B. The base must
// be 16-byte aligned and every stride a multiple of 16 bytes (the wrapper's
// `_mappable`); the stride of a dimension of size 1 is never used and is
// given as a contiguous layout would have it. Returns 0 or kEncodeError + the
// CUresult.
inline int encode_bshd(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
                       int dim, Strides st, int box_cols = 0) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  // a dimension of size 1 gets the stride of a contiguous layout
  auto bytes = [](int size, int64_t stride, cuuint64_t contiguous) -> cuuint64_t {
    return size == 1 ? contiguous : static_cast<cuuint64_t>(stride) * sizeof(bf16);
  };
  const cuuint64_t row = static_cast<cuuint64_t>(dim) * sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(heads, st.h, row), bytes(seq, st.s, row * heads),
                                 bytes(batch, st.b, row * heads * seq)};
  if (box_cols == 0) box_cols = dim < 64 ? dim : 64;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

// The register budget of a block of kConsumers warpgroups of consumers and
// one of producers, kMinBlocks blocks an SM: the launch gives every thread
// kRegs; the producers drop to 24 and the consumers take what they free.
template <int kConsumers, int kMinBlocks>
struct Budget {
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kRegs = 65536 / (kThreads * kMinBlocks) / 8 * 8;  // 168 or 128
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (kRegs + (kRegs - kProducerRegs) / kConsumers) / 8 * 8;            // 240 or 232
  static_assert(kConsumerRegs <= 256, "setmaxnreg takes at most 256");
};

}  // namespace fa_sm90
