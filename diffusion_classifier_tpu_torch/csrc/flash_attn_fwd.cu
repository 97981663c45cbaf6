// Non-causal flash-attention forward for Hopper (sm_90a): bf16 on the tensor
// cores, fp32 on scalar FMAs.
//
// Replaces the TPU Pallas kernels `_flash_fused_heads` (:123, its
// pallas_call at :130) and `_flash_bh` (:154, pallas_call :164) of
// diffusion_classifier_tpu/ops/flash_attention.py: one function in two VMEM
// layouts, whose shared body is `_softmax_pv` (:78). It computes
//
//   s = c·(q·kᵀ), c = log2(e)/√D, fp32 sums of bf16 (or fp32) products
//   p = exp2(s − rowmax(s));  l = rowsum(p)     (fp32, p unrounded in l)
//   o = (p rounded to v's dtype)·v, fp32 sums;  out = o / l in q's dtype
//
// The TPU kernel held the whole K/V of a head in VMEM. A block here has at
// most 227 KB of shared memory, so it streams 64-row K/V tiles and keeps an
// online softmax (running max m and sum l in fp32, the output rescaled by
// exp2(m_old − m_new) when the max moves).
//
// Bound: at (B, S, H, D) = (16, 1024, 6, 64) bf16 the call does 4·B·H·S²·D =
// 25.8 GFLOP over 50 MB (q, k, v in, o out), ~515 flops per byte, above the
// H100's ~295 flop/byte bf16 ridge: compute-bound, 0.0261 ms at the 989
// TFLOP/s bf16 dense peak (chip_smoke.py's bound, H100 80GB HBM3 at 700 W).
// Only the tensor cores come near it, so the bf16 path is built on them:
//
// bf16, flash_fwd_mma_kernel: the FA2 design. One block per (q tile, head,
// batch); each warp owns 16 q rows and holds them as `ldmatrix`'d A
// fragments in registers for the whole K/V sweep. K/V tiles of 64 rows
// stream through a two-deep `cp.async` ring (the next tile's copy runs under
// this tile's products), shared by all warps of the block: 8 warps (128 q
// rows) at D ≤ 64, which halves the K/V traffic from L2 per q row against 4
// warps; 4 at D = 128 (register budget). S = Q·Kᵀ and O += P·V are
// `mma.sync.m16n8k16` (bf16 operands, fp32 accumulators); K enters through
// `ldmatrix`, V through `ldmatrix.trans`. The online softmax runs on the
// accumulator fragments: each thread holds parts of two rows, the row max
// reduces over the quad with `__shfl_xor_sync` (the sum once, at the end),
// c and the max enter in one FFMA and exp2 is one `ex2.approx` (by the
// published rates an SM does 16 exp2 a clock against ~4096 bf16 tensor-core
// flops, so at D = 64 a score's exp2 costs about what its 256 flops do). p goes from the S accumulators, packed to
// bf16, straight into the A fragment of P·V: scores and probabilities never
// touch shared memory. The tiling was chosen by timing the alternatives on
// the card (PERF.md, PR 3's tilings table).
//
// Where the bf16 arithmetic differs from `_softmax_pv`: tensor-core operands
// are bf16, so c multiplies the fp32 accumulator after the product instead of
// q before it (the variant of benchmarks/flash_bf16qk_probe.py), the tensor
// cores sum the products in their own order, and `ex2.approx` is within
// ~2^-22 relative of exp2. All are fp32 rounding;
// the outputs stay within bf16 atol/rtol 2e-2 of the plain version
// (tests/test_torch_ops.py holds the reordered plain version to that bound
// on the CPU, chip_smoke.py and tests/test_torch_gpu.py the kernel on the
// card).
//
// fp32, flash_fwd_kernel: fp32 has no exact tensor-core product (TF32 keeps
// ~3 digits, outside the 2e-5 tolerance), so fp32 keeps the scalar kernel:
// 256 threads, thread (ty, tx) = (tid / 16, tid % 16) owns score rows
// 4·ty..4·ty+3 and columns tx + 16·j of each 64×64 tile, tiles staged in
// shared memory as fp32, q pre-scaled by c exactly as `_softmax_pv`.
//
// Layout: q, k, v are [B, S, H, D] views with a contiguous last dim; batch,
// sequence and head strides are arguments, so the q/k/v thirds of a fused
// qkv projection go in without a copy (the bf16 path needs 16-byte aligned
// bases and strides, which the thirds of the DiT's qkv meet; the wrapper
// copies a tensor that does not). The ragged last q and K/V tiles are masked
// (copies past `seq` zero-fill, scores past it are −inf), so S needs no
// alignment.
//
// Row statistics for the backward: when `lse` is not null, the kernel also
// writes the fp32 logsumexp of each score row in the log2 domain,
// lse[b, h, s] = m + log2(l), so the backward (flash_attn_bwd.cu) recomputes
// p = exp2(s − lse) without the row max and sum. With a null pointer nothing
// more is written, and classification pays nothing for it.
//
// Built by nvcc into a shared library with a plain C entry point
// (flash_attn_fwd) and bound with ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using fa_mma::bf16;

constexpr int kBlockM = 64;   // q rows per block (fp32)
constexpr int kBlockN = 64;   // k/v rows per tile (fp32)
constexpr int kThreads = 256;
constexpr int kRows = 4;      // score rows per thread
constexpr int kCols = 4;      // score columns per thread (strided by 16)

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// p rounded to v's dtype before the P·V product, as `p.astype(v.dtype)`.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Strides {
  int64_t b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
  // Qs [64][D+1], Ks [64][D+1], Vs [64][D], Ps [64][65], all fp32
  return sizeof(float) *
         (kBlockM * (D + 1) + kBlockN * (D + 1) + kBlockN * D +
          kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale_log2e) {
  constexpr int kQStride = D + 1;  // +1 pads shared rows off one bank
  constexpr int kKStride = D + 1;
  constexpr int kPStride = kBlockN + 1;
  constexpr int kOut = D / 16;     // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockM * kQStride;
  float* Vs = Ks + kBlockN * kKStride;
  float* Ps = Vs + kBlockN * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  const T* qb = q + batch * qs.b + head * qs.h;
  const T* kb = k + batch * ks.b + head * ks.h;
  const T* vb = v + batch * vs.b + head * vs.h;
  T* ob = o + batch * os.b + head * os.h;

  // q tile, upcast and pre-scaled: `q.astype(f32) * (scale * LOG2_E)`
  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    Qs[r * kQStride + c] =
        row < seq ? to_float(qb[row * qs.s + c]) * scale_log2e : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = 0; n0 < seq; n0 += kBlockN) {
    __syncthreads();  // previous tile's readers are done (and Qs is written)
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int row = n0 + r;
      const bool in = row < seq;
      Ks[r * kKStride + c] = in ? to_float(kb[row * ks.s + c]) : 0.f;
      Vs[r * D + c] = in ? to_float(vb[row * vs.s + c]) : 0.f;
    }
    __syncthreads();

    // scores: s[i][j] = Qs[4ty+i] · Ks[tx+16j]
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(ty * kRows + i) * kQStride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = Ks[(tx + 16 * j) * kKStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax over this tile; masked columns score -inf
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (n0 + tx + 16 * j >= seq) s[i][j] = -INFINITY;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      // every tile holds at least one unmasked column, so m_new is finite
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = exp2f(m[i] - m_new);  // 0 on the first tile
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        row_sum += p;
        Ps[(ty * kRows + i) * kPStride + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[i][j] += Ps[4ty+i] · Vs[:, tx+16j]
#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float p[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty * kRows + i) * kPStride + n];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = Vs[n * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  // o / l, once, stored in q's dtype
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      ob[row * os.s + tx + 16 * j] = from_float<T>(acc[i][j] / l[i]);
    // m and l were reduced over the half-warp: every lane holds the row's
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(batch) * gridDim.y + head) * seq + row] =
          m[i] + log2f(l[i]);
  }
}

// The bf16 tiling: kWarps warps of 16 q rows share each K/V tile of kBlockN
// rows. Eight warps (128 rows) at D ≤ 64 halve the K/V traffic from L2 per q
// row against four; at D = 128 the accumulators take ~230 registers, and
// four warps keep two blocks on an SM.
template <int D>
struct MmaTiling {
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kRows = kWarps * 16;  // q rows per block
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBlockN = 64;
  static_assert(kBlockN % 16 == 0, "P·V steps over K/V rows in k16 slices");
  // Qs [kRows][D+8], then K and V tiles [2][kBlockN][D+8] each, bf16
  static constexpr size_t kSmem = sizeof(bf16) * (kRows + 4 * kBlockN) * (D + 8);
};

template <int D>
__global__ void __launch_bounds__(MmaTiling<D>::kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int seq, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale_log2e) {
  using namespace fa_mma;
  using Tiling = MmaTiling<D>;
  constexpr int kThreadsM = Tiling::kThreads;
  constexpr int kBlockN = Tiling::kBlockN;
  constexpr int kStride = D + 8;
  constexpr int kTile = kBlockN * kStride;
  constexpr int kKSteps = D / 16;       // k16 steps of S = Q·Kᵀ
  constexpr int kNTiles = kBlockN / 8;  // n8 tiles of a score row band
  constexpr int kDTiles = D / 8;        // n8 tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + Tiling::kRows * kStride;  // [2][kBlockN][kStride]
  bf16* Vs = Ks + 2 * kTile;                // [2][kBlockN][kStride]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int q0 = blockIdx.x * Tiling::kRows;
  const int head = blockIdx.y, batch = blockIdx.z;
  const bf16* qb = q + batch * qs.b + head * qs.h;
  const bf16* kb = k + batch * ks.b + head * ks.h;
  const bf16* vb = v + batch * vs.b + head * vs.h;

  load_rows<D, Tiling::kRows, kThreadsM>(Qs, qb, qs.s, q0, seq);
  load_rows<D, kBlockN, kThreadsM>(Ks, kb, ks.s, 0, seq);
  load_rows<D, kBlockN, kThreadsM>(Vs, vb, vs.s, 0, seq);
  cp_async_commit();

  uint32_t qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows g and g + 8 of this warp's band: running max of the unscaled
  // scores, and this thread's part of the running sum (its quad's four parts
  // add up at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_tiles = (seq + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {  // the next tile's copy runs under this tile's work
      load_rows<D, kBlockN, kThreadsM>(Ks + (buf ^ 1) * kTile, kb, ks.s,
                                       (j + 1) * kBlockN, seq);
      load_rows<D, kBlockN, kThreadsM>(Vs + (buf ^ 1) * kTile, vb, vs.s,
                                       (j + 1) * kBlockN, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], a_ptr(Qs, kStride, warp * 16, kk * 16, lane));
    }
    const bf16* Kt = Ks + buf * kTile;
    const bf16* Vt = Vs + buf * kTile;

    // S = Q·Kᵀ for this warp's 16 rows and the tile's 64 columns
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_ptr_nk(Kt, kStride, np * 16, kk * 16, lane));
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // columns past `seq` score −inf (only the last tile has any)
    const int n0 = j * kBlockN;
    if (n0 + kBlockN > seq) {
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + n * 8 + 2 * t + (e & 1) >= seq) s[n][e] = -INFINITY;
    }

    // online softmax; element e of a tile is in row e / 2 (g or g + 8). The
    // max is taken on the unscaled scores (c > 0), and c enters with the
    // subtraction in one FFMA: p = exp2(c·s − c·m).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    // every tile holds at least one unmasked column, so mx is finite and
    // alpha is 0 on the first tile
    float alpha[2], neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx((m[r] - mx[r]) * scale_log2e);
      neg[r] = -mx[r] * scale_log2e;
      m[r] = mx[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2e, neg[e >> 1]));
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];

    // O += bf16(P)·V: the score accumulators are P·V's A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_ptr_kn(Vt, kStride, kk * 16, dp * 16, lane));
        mma(acc[2 * dp], pa, b[0], b[1]);
        mma(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled on the next iteration
  }

  // o / l, once, stored in q's dtype; lse = c·m + log2(l)
  bf16* ob = o + batch * os.b + head * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= seq) continue;
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
      *reinterpret_cast<uint32_t*>(ob + row * os.s + d * 8 + 2 * t) =
          pack_bf16(acc[d][2 * r] / l[r], acc[d][2 * r + 1] / l[r]);
    if (lse != nullptr && t == 0)
      lse[(static_cast<int64_t>(batch) * gridDim.y + head) * seq + row] =
          m[r] * scale_log2e + log2f(l[r]);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int batch, int seq, int heads, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale_log2e,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, qs, ks,
      vs, os, scale_log2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int batch, int seq, int heads, Strides qs,
                        Strides ks, Strides vs, Strides os, float scale_log2e,
                        cudaStream_t stream) {
  using Tiling = MmaTiling<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tiling::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + Tiling::kRows - 1) / Tiling::kRows, heads, batch);
  flash_fwd_mma_kernel<D><<<grid, Tiling::kThreads, Tiling::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, seq, qs, ks, vs,
      os, scale_log2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int batch, int seq, int heads,
                   Strides qs, Strides ks, Strides vs, Strides os, float c,
                   cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; for bfloat16
// the base pointers must be 16-byte aligned and the strides multiples of 8.
// `lse` is null or a contiguous fp32 [batch, heads, seq]. Returns the
// cudaError_t of the launch (0 = launched); the kernel's own faults show at
// the next synchronisation.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int dtype, int batch, int seq,
                              int heads, int dim, int64_t q_sb, int64_t q_ss,
                              int64_t q_sh, int64_t k_sb, int64_t k_ss,
                              int64_t k_sh, int64_t v_sb, int64_t v_ss,
                              int64_t v_sh, int64_t o_sb, int64_t o_ss,
                              int64_t o_sh, float scale_log2e, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dim) {
    case 32: err = launch<32>(dtype, q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, scale_log2e, st); break;
    case 64: err = launch<64>(dtype, q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, scale_log2e, st); break;
    case 128: err = launch<128>(dtype, q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, scale_log2e, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
