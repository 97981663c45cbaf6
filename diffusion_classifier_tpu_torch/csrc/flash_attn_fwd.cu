// Non-causal flash-attention forward for Hopper (sm_90a): bf16 on the tensor
// cores through `wgmma` fed by TMA, fp32 on scalar FMAs.
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
// most 227 KB of shared memory, so it streams K/V tiles and keeps an online
// softmax (running max m and sum l in fp32, the output rescaled by
// exp2(m_old − m_new) when the max moves).
//
// Bound: at (B, S, H, D) = (16, 1024, 6, 64) bf16 the call does 4·B·H·S²·D =
// 25.8 GFLOP over 50 MB (q, k, v in, o out), ~515 flops per byte, above the
// H100's ~295 flop/byte bf16 ridge: compute-bound, 0.0261 ms at the 989
// TFLOP/s bf16 dense peak (chip_smoke.py's bound, H100 80GB HBM3 at 700 W).
// Only `wgmma` reaches the tensor cores' full rate, so the bf16 path is
// built on it (helpers in flash_sm90.cuh):
//
// bf16, flash_fwd_wgmma_kernel<D, kBlockN>: warp-specialised. One block per
// (64 q rows, head, batch) holds one consumer warpgroup and one producer
// warpgroup, two blocks an SM. The producer's first thread loads the Q tile
// once by TMA and streams the K and V tiles of kBlockN rows through a ring of
// 2 shared-memory stages; each stage has a "full" barrier for K and one for V
// (TMA completes them with its byte count) and an "empty" barrier on which
// every consumer thread arrives when its products have read the stage, so
// the producer never overwrites a stage in use. `setmaxnreg` drops the
// producers to 24 registers and gives the consumers the 232 they free. The
// consumer warpgroup computes S = Q·Kᵀ as `wgmma` m64 x kBlockN with A = Q and
// B = K both in shared memory, runs the online softmax on the fp32
// accumulators (each thread holds parts of two rows; the row max reduces over
// the quad with two `__shfl_xor_sync`, the sum once, at the end), packs p to
// bf16 straight from the S accumulators into the register A operand of
// O += P·V (the accumulator and A-fragment layouts coincide, flash_sm90.cuh),
// and reads B = V from shared memory as MN-major, the transpose bit set. c
// and the max enter in one FFMA and exp2 is one `ex2.approx`. The other block
// on the SM runs its products while this one runs its softmax.
//   Tilings: kBlockN = 128 at D ≤ 64 and seq > 64 (half the barrier round
//   trips of 64-row tiles); 64 at seq ≤ 64 (the UNets' 16 and 64 tokens,
//   where a 128-row tile would be mostly padding; `kShortSeq` is that one
//   threshold) and at D = 128 and 72 (a 128-column score tile, the output and P
//   would spill the consumers' registers).
//   D = 72 (DiT-XL/2, 16 heads × 72): 72 is no multiple of the 16 values a
//   `wgmma` depth step takes, so the tiles are padded to 80 columns inside
//   the kernel (Tile72 in flash_sm90.cuh): columns 0..63 in the 128-byte
//   swizzled box of D = 64, columns 64..79 in a box of 32-byte rows loaded
//   through a second tensor map of the true width 72, which TMA fills with
//   zeros past column 71. q·kᵀ runs 5 depth steps, P·V an n64 and an n16
//   product, and only the 72 true output columns are stored: 11% more
//   products than the model's work, where a pad to 128 would cost 78%. K/V
//   tiles of 64 rows, as at D = 128: with 128 the consumers spilled 112
//   bytes and ran 10% slower (PERF.md). bf16 only (the scalar fp32 kernel
//   steps D in 16s), forward only (the backward has no D = 72 entry).
//   Measured on the card and not kept (PERF.md): two consumer
//   warpgroups a block sharing the K/V tiles, with or without FA3's
//   ping-pong between them or the next tile's S product issued before this
//   tile's softmax, and a 3-stage ring; each was slower or no faster at the
//   DiT's shape than two one-warpgroup blocks an SM.
//
// What the design does about each hazard:
// - Strided q/k/v: one 4-D tensor map per operand over (D, H, S, B) with the
//   view's byte strides (encode_bshd), so the thirds of the DiT's fused qkv
//   projection load without a copy; TMA needs a 16-byte aligned base and
//   16-byte multiple strides, the wrapper's `_mappable` rule.
// - Swizzle against D: a box is at most 64 bf16 wide (the 128-byte
//   swizzle's limit), so a D = 128 tile is two boxes and a D = 32 tile takes
//   the 64-byte swizzle; the `wgmma` descriptors use the same mode and
//   offsets (Tile<D> in flash_sm90.cuh), every box 1024-byte aligned.
// - Ragged S: TMA zero-fills rows past `seq`, and a zero K row scores 0, so
//   columns ≥ seq are set to −inf before the softmax; q rows past `seq` are
//   computed on zeros and never stored.
// - Async ordering: `wgmma.fence` before each batch of products (the
//   accumulators and P were written by ordinary instructions), then
//   commit_group / wait_group 0, then the registers are tied past the wait
//   (fence_regs); each ring slot's barriers are waited on with their phase
//   parity; barrier waits trap after ~20 s instead of hanging.
// - Tensor maps are encoded on the host at each call (3 a call) and passed
//   as `const __grid_constant__ CUtensorMap` parameters; an encode that
//   fails returns kEncodeError + its CUresult and the wrapper raises.
// - compute-sanitizer refuses the card's sandbox ("Device not supported"),
//   so races are looked for by repetition: chip_smoke.py requires bit-equal
//   outputs over repeated calls.
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
// shared memory as fp32, q pre-scaled by c exactly as `_softmax_pv`; its
// loads take the views' strides, and the ragged last tiles are masked.
//
// Row statistics for the backward: when `lse` is not null, the kernel also
// writes the fp32 logsumexp of each score row in the log2 domain,
// lse[b, h, s] = m + log2(l), so the backward (flash_attn_bwd.cu) recomputes
// p = exp2(s − lse) without the row max and sum. With a null pointer nothing
// more is written, and classification pays nothing for it.
//
// Built by nvcc into a shared library with a plain C entry point
// (flash_attn_fwd) and bound with ctypes; no PyTorch headers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using fa_sm90::bf16;
using fa_sm90::Strides;

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

// ---- bf16: the warp-specialised wgmma kernel (see the notes at the top)

// sequences up to this many rows take 64-row K/V tiles
constexpr int kShortSeq = 64;

// The shared-memory tile of a head dim: Tile<D>, or at D = 72 the padded Tile72.
template <int D>
struct FwdTile {
  using type = fa_sm90::Tile<D>;
};
template <>
struct FwdTile<72> {
  using type = fa_sm90::Tile72;
};

template <int D, int kBlockN_>
struct FwdTiling {
  using Tile = typename FwdTile<D>::type;
  // the depth the products run over: D, or 80 at D = 72 (its columns 72..79 zeros)
  static constexpr int kDepth = D == 72 ? 80 : D;
  using Budget = fa_sm90::Budget<1, 2>;   // one consumer warpgroup, two blocks an SM
  static constexpr int kBlockN = kBlockN_;
  static constexpr int kBlockM = 64;      // q rows per block
  static constexpr int kStages = 2;       // K/V ring depth
  static constexpr uint32_t kQBytes = Tile::bytes(kBlockM);
  static constexpr uint32_t kKVBytes = Tile::bytes(kBlockN);
  // Q, then the K and V stages; 1024 bytes of slack to align the tiles
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
  // barriers: Q full, K full and V full for each stage, empty for each stage
  static constexpr int kBars = 1 + 3 * kStages;
};

// The online softmax of one score tile in place, for rows g and g + 8 of a
// warp's band (element i of the accumulator is in row (i / 2) % 2): columns
// past `seq` score −inf (only the last tile has any); the row max m moves
// (taken on the unscaled scores, c > 0) and alpha = exp2(c·(m_old − m_new))
// rescales the running sum l here and the output at the caller; c enters
// with the subtraction in one FFMA, p = exp2(c·s − c·m).
template <int kBlockN>
__device__ __forceinline__ void online_softmax(float (&sc)[kBlockN / 2], int n0, int seq,
                                               float scale_log2e, int t, float (&m)[2],
                                               float (&l)[2], float (&alpha)[2]) {
  using fa_sm90::exp2_approx;
  constexpr int kNTiles = kBlockN / 8;  // n8 blocks of a score row band
  if (n0 + kBlockN > seq) {
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + n * 8 + 2 * t + (e & 1) >= seq) sc[4 * n + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  // every tile holds at least one unmasked column, so mx is finite and
  // alpha is 0 on the first tile
  float neg[2];
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
  for (int i = 0; i < kBlockN / 2; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], scale_log2e, neg[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// One operand's rows row0..row0+rows−1 into the tile at `base` (one thread);
// `tail` is Tile72's second tensor map, unread at the other head dims.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t base, int rows, const CUtensorMap* map,
                                          const CUtensorMap* tail, uint32_t bar, int head,
                                          int batch, int row0) {
  if constexpr (D == 72) {
    fa_sm90::Tile72::load(base, rows, map, tail, bar, head, batch, row0);
  } else {
    fa_sm90::Tile<D>::load(base, rows, map, bar, head, batch, row0);
  }
}

template <int D, int kBlockN>
__global__ void __launch_bounds__(256, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tq_tail,
                       const __grid_constant__ CUtensorMap tk_tail,
                       const __grid_constant__ CUtensorMap tv_tail, bf16* __restrict__ o,
                       float* __restrict__ lse, int seq, Strides os, float scale_log2e) {
  using namespace fa_sm90;
  using Tiling = FwdTiling<D, kBlockN>;
  using Tl = typename Tiling::Tile;
  using Budget = typename Tiling::Budget;
  constexpr int kStages = Tiling::kStages;
  constexpr int kBlockM = Tiling::kBlockM;
  constexpr int kDepth = Tiling::kDepth;
  constexpr int kDTiles = D / 8;  // n8 blocks of the output that are stored

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[Tiling::kBars];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Tiling::kQBytes;              // [kStages] K tiles
  const uint32_t sv = sk + kStages * Tiling::kKVBytes;   // [kStages] V tiles
  const uint32_t q_full = smem_u32(bars);
  const uint32_t k_full = q_full + 8;                    // + 8·stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = (seq + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer warpgroup: its first thread keeps the ring full
    setmaxnreg_dec<Budget::kProducerRegs>();
    if (threadIdx.x == 128) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      if constexpr (D == 72) {
        prefetch_tensormap(&tq_tail);
        prefetch_tensormap(&tk_tail);
        prefetch_tensormap(&tv_tail);
      }
      mbar_arrive_expect_tx(q_full, Tiling::kQBytes);
      load_tile<D>(sq, kBlockM, &tq, &tq_tail, q_full, head, batch, q0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        // the stage's previous tile has been read (passes at once on round 0)
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, Tiling::kKVBytes);
        load_tile<D>(sk + s * Tiling::kKVBytes, kBlockN, &tk, &tk_tail, k_full + 8 * s, head,
                     batch, j * kBlockN);
        mbar_arrive_expect_tx(v_full + 8 * s, Tiling::kKVBytes);
        load_tile<D>(sv + s * Tiling::kKVBytes, kBlockN, &tv, &tv_tail, v_full + 8 * s, head,
                     batch, j * kBlockN);
      }
    }
  } else {
    // the consumer warpgroup
    setmaxnreg_inc<Budget::kConsumerRegs>();
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane & 3;
    float acc[kDepth / 2], sc[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kDepth / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;
    // rows g and g + 8 of this warp's band: running max of the unscaled
    // scores, and this thread's part of the running sum (its quad's four
    // parts add up at the end)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t kt = sk + s * Tiling::kKVBytes, vt = sv + s * Tiling::kKVBytes;

      // S = Q·Kᵀ for the block's 64 rows and the tile's kBlockN columns
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        wgmma_ss<kBlockN>(sc, Tl::desc_k(sq, kBlockM, 0, kk), Tl::desc_k(kt, kBlockN, 0, kk),
                          kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      online_softmax<kBlockN>(sc, j * kBlockN, seq, scale_log2e, t, m, l, alpha);
#pragma unroll
      for (int i = 0; i < kDepth / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += bf16(P)·V: the score accumulators are the A operand
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
      mbar_wait(v_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        if constexpr (D == 72) {
          wgmma_rs72(acc, pa[kk], vt, kBlockN, kk);
        } else {
          wgmma_rs<D>(acc, pa[kk], vt, kBlockN, kk);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + 8 * s);  // this stage may be refilled
    }

    // o / l, once, stored in q's dtype; lse = c·m + log2(l)
    bf16* ob = o + batch * os.b + head * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
      if (row >= seq) continue;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
        *reinterpret_cast<uint32_t*>(ob + row * os.s + d * 8 + 2 * t) =
            pack_bf16(acc[4 * d + 2 * r] / l[r], acc[4 * d + 2 * r + 1] / l[r]);
      if (lse != nullptr && t == 0)
        lse[(static_cast<int64_t>(batch) * gridDim.y + head) * seq + row] =
            m[r] * scale_log2e + log2f(l[r]);
    }
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


template <int D, int kBlockN>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[6], void* o, float* lse, int batch, int seq,
                         int heads, Strides os, float scale_log2e, cudaStream_t stream) {
  using Tiling = FwdTiling<D, kBlockN>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, kBlockN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Tiling::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + Tiling::kBlockM - 1) / Tiling::kBlockM, heads, batch);
  flash_fwd_wgmma_kernel<D, kBlockN><<<grid, Tiling::Budget::kThreads, Tiling::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<bf16*>(o), lse, seq, os,
      scale_log2e);
  return cudaGetLastError();
}

// one tensor map per operand (two at D = 72: Tile72's 64- and 16-column
// boxes; the other head dims pass the first three again), then the tiling
// for this sequence length
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                int seq, int heads, Strides qs, Strides ks, Strides vs, Strides os,
                float scale_log2e, cudaStream_t stream) {
  CUtensorMap maps[6];
  const void* ptrs[3] = {q, k, v};
  const Strides strides[3] = {qs, ks, vs};
  int err = fa_sm90::bind_context();
  for (int i = 0; i < 3 && err == 0; ++i) {
    err = fa_sm90::encode_bshd(&maps[i], ptrs[i], batch, seq, heads, D, strides[i]);
    if (err == 0 && D == 72)
      err = fa_sm90::encode_bshd(&maps[3 + i], ptrs[i], batch, seq, heads, D, strides[i], 16);
    else
      maps[3 + i] = maps[i];
  }
  if (err != 0) return err;
  // 128-row K/V tiles halve the barrier round trips; at D = 128 (and at
  // D = 72, whose 40 output accumulators spill 112 bytes there) their
  // scores, the output and P would spill the consumers' registers
  if constexpr (D == 128 || D == 72) {
    return launch_wgmma<D, 64>(maps, o, lse, batch, seq, heads, os, scale_log2e, stream);
  } else {
    if (seq <= kShortSeq)
      return launch_wgmma<D, 64>(maps, o, lse, batch, seq, heads, os, scale_log2e, stream);
    return launch_wgmma<D, 128>(maps, o, lse, batch, seq, heads, os, scale_log2e, stream);
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int seq, int heads, Strides qs, Strides ks, Strides vs, Strides os,
           float c, cudaStream_t st) {
  if constexpr (D == 72) {  // bf16 only: the scalar fp32 kernel steps D in 16s
    if (dtype == 1)
      return launch_bf16<D>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
    return cudaErrorInvalidValue;
  } else {
    if (dtype == 0)
      return launch_f32<D>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
    if (dtype == 1)
      return launch_bf16<D>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; for bfloat16
// the base pointers must be 16-byte aligned and the strides multiples of 8.
// `lse` is null or a contiguous fp32 [batch, heads, seq]. Returns 0 when the
// kernel launched, the launch's cudaError_t, or (bfloat16)
// fa_sm90::kEncodeError + the CUresult of a tensor-map encode that failed;
// the kernel's own faults show at the next synchronisation.
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
  switch (dim) {
    case 32: return launch<32>(dtype, q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, scale_log2e, st);
    case 64: return launch<64>(dtype, q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, scale_log2e, st);
    case 72: return launch<72>(dtype, q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, scale_log2e, st);
    case 128: return launch<128>(dtype, q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, scale_log2e, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
