// Non-causal flash-attention backward for Hopper (sm_90a): bf16 on the tensor
// cores through `wgmma` fed by TMA, fp32 on scalar FMAs.
//
// Replaces the TPU Pallas backward `_flash_bwd` of
// diffusion_classifier_tpu/ops/flash_attention.py: its lane-group path
// (:304, pallas_call :321, kernel `_bwd_kernel_lanes` :244) and its
// head-major path (pallas_call :336, kernel `_bwd_kernel_bh` :264), one
// function `_bwd_one_head` (:216) in two VMEM layouts. It computes
//
//   s  = c·(q·kᵀ), c = log2(e)/√D, fp32 sums   p = exp2(s − lse)
//   dv = (p rounded to dO's dtype)ᵀ·dO,  dp = dO·vᵀ,  fp32 sums
//   δ  = rowsum(dO ∘ O) in fp32                (= rowsum(p ∘ dp))
//   ds = p ∘ (dp − δ), rounded to q's dtype
//   dq = scale·ds·k,  dk = scale·dsᵀ·q,       outputs in the input dtype
//
// with lse = m + log2 l, the forward's row statistic (flash_attn_fwd.cu).
// The TPU kernel held one head's whole [S, S] p/dp/ds in VMEM and gated
// S ≤ 1024. A Hopper block has at most 227 KB of shared memory, so this is
// the FA2 design in three launches, with no S limit and no atomics (the
// gradients are the same bits from run to run):
//
//   1. δ = rowsum(dO ∘ O) in fp32, one warp per score row (delta_kernel,
//      both dtypes: it is memory-bound and small);
//   2. dk/dv: one block per (K/V tile, head, batch) streaming q/dO;
//   3. dq: one block per (q tile, head, batch) streaming K/V; it
//      recomputes s and dp (14 rather than 10 S²·D flops per head), which
//      buys run-to-run identical dq without atomics (FA3's dq sums with
//      atomics, whose order changes from run to run).
//
// Bound: at (B, S, H, D) = (16, 1024, 6, 64) bf16 the call needs
// 10·B·H·S²·D = 64.4 GFLOP (s, dp, dv, dk, dq) over 101 MB (q, k, v, O, dO
// and the fp32 lse in; dq, dk, dv out), ~640 flops per byte, above the
// H100's ~295 flop/byte bf16 ridge: compute-bound, 0.0651 ms at the 989
// TFLOP/s bf16 dense peak (chip_smoke.py's bound, H100 80GB HBM3 at 700 W).
// Only `wgmma` reaches the tensor cores' full rate, so the bf16 passes are
// built on it (helpers in flash_sm90.cuh), warp-specialised like the
// forward: each block has kConsumers consumer warpgroups of 64 own rows and
// one producer warpgroup whose first warp issues the TMA loads; the streamed
// tiles are 64 rows in a ring of 2 stages with "full" and "empty"
// `mbarrier`s; `setmaxnreg` gives the producers 24 registers and the
// consumers what that frees. Tilings: 2 consumer warpgroups (one block an
// SM, 240 registers a consumer thread), or 1 when seq ≤ kShortSeq = 64 (the
// UNets' 16 and 64 tokens: two blocks an SM, 232 registers), where 128 own
// rows would be mostly padding and two blocks an SM hide each other's
// latency. A streamed tile is taken in product steps of kSub rows: 64, or 32
// at one consumer warpgroup and at D = 128, where 64-column score tiles
// beside the dK and dV sums would spill the consumers' registers.
//
// dkdv_wgmma_kernel: K/V rows are the M dimension. The block's K and V
// tiles load once; Q and dO tiles stream, with their lse and δ (the
// producer warp's 32 lanes copy those rows into the stage and arrive on its
// full barrier, which also counts TMA's bytes). Each consumer warpgroup
// computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (`wgmma` m64 x kSub, A = K or V and
// B = Q or dO, all K-major in shared memory), then Pᵀ = exp2(c·Sᵀ − lse[col]) and
// dSᵀ = Pᵀ∘(dPᵀ − δ[col]) in place on the accumulators, packs both to bf16
// register A operands and runs dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q with
// B = dO or Q read MN-major (the transpose bit set). P and dS never touch
// shared memory; `scale` multiplies dK once at the store. Pᵀ and dSᵀ are
// packed before the products, so the fp32 tiles are dead while they run.
//
// dq_wgmma_kernel: q rows are M; the block's Q and dO tiles load once, K and
// V tiles stream. S = Q·Kᵀ and dP = dO·Vᵀ (A = Q or dO, B = K or V, K-major),
// dS = P∘(dP − δ[row]) with the rows' lse and δ in registers, then
// dQ += bf16(dS)·K with B = K read MN-major from the same shared tile.
//
// In both, c and −lse enter in one FFMA and exp2 is one `ex2.approx`.
// Hazards, as in the forward (flash_attn_fwd.cu): strided q, k, v and dO
// are read through one 4-D tensor map each (4 encodes a call; δ reads O and
// dO with plain loads); the D = 128
// tiles are two 64-column boxes, D = 32 takes the 64-byte swizzle; the
// ragged last tiles: TMA zero-fills rows past `seq`, p (and so ds) is forced
// to 0 in columns past `seq` (a zero q row would otherwise score s = 0
// against lse 0, p = 1), and rows past `seq` are never stored; `wgmma.fence`
// before each batch of products and fence_regs after each wait. FA3's
// ping-pong between the two consumer warpgroups was measured slower on the
// card and not kept (PERF.md).
//
// Where the bf16 arithmetic differs from `_bwd_one_head`: c multiplies the
// fp32 accumulator after q·k instead of q before it (tensor-core operands are
// bf16; benchmarks/flash_bf16qk_probe.py is the TPU's probe of this variant),
// the tensor cores sum in their own order, and `ex2.approx` is within ~2^-22
// relative of exp2. All are fp32 rounding; the gradients stay within bf16
// atol/rtol 2e-2 of the plain version (tests/test_torch_ops.py holds the
// reordered plain version to that bound on the CPU; chip_smoke.py and
// tests/test_torch_gpu.py the kernels on the card).
//
// fp32 keeps the scalar kernels dkdv_kernel and dq_kernel (fp32 has no exact
// tensor-core product): thread (ty, tx) = (tid / 16, tid % 16) of 256 owns
// rows 4·ty..4·ty+3 and columns tx + 16·j of each 64×64 tile, tiles staged in
// shared memory as fp32 (100 KB at D=64, 166 KB at D=128 for dk/dv), q
// pre-scaled by c exactly as the forward's scalar kernel, so p here is that
// kernel's p.
//
// Layout: q, k, v, O, dO and the gradients are [B, S, H, D] views with a
// contiguous last dim and any batch/sequence/head strides, so the q/k/v
// thirds of a fused qkv projection (and their gradients) need no copy; the
// bf16 path needs 16-byte aligned bases and strides, which the wrapper
// ensures.
//
// Built by nvcc into a shared library with a plain C entry point
// (flash_attn_bwd) and bound with ctypes; no PyTorch headers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using fa_sm90::bf16;
using fa_sm90::Strides;

constexpr int kBlock = 64;    // rows of a q tile and of a K/V tile (fp32)
constexpr int kThreads = 256;
constexpr int kRows = 4;      // tile rows per thread
constexpr int kCols = 4;      // tile columns per thread (strided by 16)
constexpr int kPStride = kBlock + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// a value rounded to T and back, as `x.astype(T)` before an MXU product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// The tensors of one call, each with its strides.
template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S], written by delta_kernel
  T *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int batch, seq, heads;
  float scale, scale_log2e;
};

// Stage `rows` rows of a [S, D] head slice into shared memory as fp32, rows
// past `seq` as zeros. `mul` scales each value.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int seq, float mul) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < seq ? to_float(src[row * row_stride + c]) * mul : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args<T> a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp;
  if (row >= static_cast<int64_t>(a.batch) * a.heads * a.seq) return;  // warp-uniform
  const int s = static_cast<int>(row % a.seq);
  const int h = static_cast<int>((row / a.seq) % a.heads);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.seq) * a.heads));
  const T* o = a.o + b * a.os.b + h * a.os.h + s * a.os.s;
  const T* g = a.dout + b * a.dos.b + h * a.dos.h + s * a.dos.s;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_float(g[d]), to_float(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * kBlock * (D + 1) + 2 * kBlock * kPStride + 2 * kBlock);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args<T> a) {
  constexpr int kS = D + 1;  // +1 pads shared rows off one bank
  constexpr int kOut = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * kS;
  float* Qs = Vs + kBlock * kS;
  float* dOs = Qs + kBlock * kS;
  float* Ps = dOs + kBlock * kS;
  float* dSs = Ps + kBlock * kPStride;
  float* Ls = dSs + kBlock * kPStride;
  float* Dl = Ls + kBlock;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * kBlock;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int seq = a.seq;
  const T* qb = a.q + batch * a.qs.b + head * a.qs.h;
  const T* gb = a.dout + batch * a.dos.b + head * a.dos.h;
  const int64_t stat0 = (static_cast<int64_t>(batch) * a.heads + head) * seq;

  load_tile<T, D>(Ks, a.k + batch * a.ks.b + head * a.ks.h, a.ks.s, n0, seq, 1.f);
  load_tile<T, D>(Vs, a.v + batch * a.vs.b + head * a.vs.h, a.vs.s, n0, seq, 1.f);

  float acc_dk[kRows][kOut], acc_dv[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int m0 = 0; m0 < seq; m0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Qs, qb, a.qs.s, m0, seq, 1.f);
    load_tile<T, D>(dOs, gb, a.dos.s, m0, seq, 1.f);
    if (tid < kBlock) {
      const bool in = m0 + tid < seq;
      Ls[tid] = in ? a.lse[stat0 + m0 + tid] : 0.f;
      Dl[tid] = in ? a.delta[stat0 + m0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are K/V rows 4ty+i, columns q rows tx+16j
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[kRows], vv[kRows], qq[kCols], gg[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kk[i] = Ks[(ty * kRows + i) * kS + d];
        vv[i] = Vs[(ty * kRows + i) * kS + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        // the forward's pre-scaled q, `q.astype(f32) * (scale * LOG2_E)`
        qq[j] = Qs[(tx + 16 * j) * kS + d] * a.scale_log2e;
        gg[j] = dOs[(tx + 16 * j) * kS + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qq[j], kk[i], s[i][j]);
          dp[i][j] = fmaf(gg[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float p = m0 + c < seq ? exp2f(s[i][j] - Ls[c]) : 0.f;
        Ps[(ty * kRows + i) * kPStride + c] = round_to<T>(p);
        dSs[(ty * kRows + i) * kPStride + c] = round_to<T>(p * (dp[i][j] - Dl[c]));
      }
    __syncthreads();

    // dv += pᵀ·dO and dk += dsᵀ·q over this tile's 64 q rows
#pragma unroll 4
    for (int n = 0; n < kBlock; ++n) {
      float pp[kRows], dd[kRows], go[kOut], qv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pp[i] = Ps[(ty * kRows + i) * kPStride + n];
        dd[i] = dSs[(ty * kRows + i) * kPStride + n];
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        go[j] = dOs[n * kS + tx + 16 * j];
        qv[j] = Qs[n * kS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          acc_dv[i][j] = fmaf(pp[i], go[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dd[i], qv[j], acc_dk[i][j]);
        }
    }
  }

  T* dkb = a.dk + batch * a.dks.b + head * a.dks.h;
  T* dvb = a.dv + batch * a.dvs.b + head * a.dvs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = n0 + ty * kRows + i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      dkb[row * a.dks.s + tx + 16 * j] = from_float<T>(acc_dk[i][j] * a.scale);
      dvb[row * a.dvs.s + tx + 16 * j] = from_float<T>(acc_dv[i][j]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * kPStride + 2 * kBlock);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args<T> a) {
  constexpr int kS = D + 1;
  constexpr int kOut = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * kS;
  float* Ks = dOs + kBlock * kS;
  float* Vs = Ks + kBlock * kS;
  float* dSs = Vs + kBlock * kS;
  float* Ls = dSs + kBlock * kPStride;
  float* Dl = Ls + kBlock;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kBlock;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int seq = a.seq;
  const T* kb = a.k + batch * a.ks.b + head * a.ks.h;
  const T* vb = a.v + batch * a.vs.b + head * a.vs.h;
  const int64_t stat0 = (static_cast<int64_t>(batch) * a.heads + head) * seq;

  load_tile<T, D>(Qs, a.q + batch * a.qs.b + head * a.qs.h, a.qs.s, m0, seq,
                  a.scale_log2e);
  load_tile<T, D>(dOs, a.dout + batch * a.dos.b + head * a.dos.h, a.dos.s, m0,
                  seq, 1.f);
  if (tid < kBlock) {
    const bool in = m0 + tid < seq;
    Ls[tid] = in ? a.lse[stat0 + m0 + tid] : 0.f;
    Dl[tid] = in ? a.delta[stat0 + m0 + tid] : 0.f;
  }

  float acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < seq; n0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done (and Qs is written)
    load_tile<T, D>(Ks, kb, a.ks.s, n0, seq, 1.f);
    load_tile<T, D>(Vs, vb, a.vs.s, n0, seq, 1.f);
    __syncthreads();

    // rows are q rows 4ty+i, columns K/V rows tx+16j
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qq[kRows], gg[kRows], kk[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qq[i] = Qs[(ty * kRows + i) * kS + d];
        gg[i] = dOs[(ty * kRows + i) * kS + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kk[j] = Ks[(tx + 16 * j) * kS + d];
        vv[j] = Vs[(tx + 16 * j) * kS + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float p = n0 + c < seq ? exp2f(s[i][j] - Ls[r]) : 0.f;
        dSs[r * kPStride + c] = round_to<T>(p * (dp[i][j] - Dl[r]));
      }
    }
    __syncthreads();

    // dq += ds·k over this tile's 64 K rows
#pragma unroll 4
    for (int n = 0; n < kBlock; ++n) {
      float dd[kRows], kv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dd[i] = dSs[(ty * kRows + i) * kPStride + n];
#pragma unroll
      for (int j = 0; j < kOut; ++j) kv[j] = Ks[n * kS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(dd[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = a.dq + batch * a.dqs.b + head * a.dqs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + ty * kRows + i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      dqb[row * a.dqs.s + tx + 16 * j] = from_float<T>(acc[i][j] * a.scale);
  }
}

// ---- bf16: the warp-specialised wgmma passes (see the notes at the top)

// sequences up to this many rows take one consumer warpgroup a block
constexpr int kShortSeq = 64;

template <int D, int kConsumers>
struct BwdTiling {
  using Tile = fa_sm90::Tile<D>;
  using Budget = fa_sm90::Budget<kConsumers, kConsumers == 1 ? 2 : 1>;
  static constexpr int kRows = 64 * kConsumers;  // the block's own rows (K/V or q)
  static constexpr int kStream = 64;             // rows of a streamed tile
  // streamed rows a product step takes: 32 where 64-column score tiles
  // would spill the consumers' registers (one consumer warpgroup: 232; D =
  // 128: the dK and dV or dQ sums take 64 a thread each)
  static constexpr int kSub = kConsumers == 1 || D == 128 ? 32 : 64;
  static constexpr int kStages = 2;              // ring depth
  static constexpr uint32_t kOwnBytes = Tile::bytes(kRows);
  static constexpr uint32_t kStreamBytes = Tile::bytes(kStream);
  // two own tiles, two streamed tiles a stage, and (dk/dv) each stage's lse
  // and δ; 1024 bytes of slack to align the tiles
  static constexpr size_t kSmem =
      1024 + 2 * kOwnBytes + 2 * kStages * kStreamBytes + 2 * kStages * kStream * sizeof(float);
};

template <int D, int kConsumers>
__global__ void __launch_bounds__(128 * (kConsumers + 1), kConsumers == 1 ? 2 : 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  Args<bf16> a) {
  using namespace fa_sm90;
  using Tiling = BwdTiling<D, kConsumers>;
  using Tl = typename Tiling::Tile;
  using Budget = typename Tiling::Budget;
  constexpr int kStages = Tiling::kStages;
  constexpr int kRowsB = Tiling::kRows;
  constexpr int kM = Tiling::kStream;   // q rows a streamed tile
  constexpr int kSub = Tiling::kSub;
  constexpr int kDTiles = D / 8;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t pad = ((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw);
  const uint32_t sk = smem_u32(smem_raw) + pad;
  const uint32_t sv = sk + Tiling::kOwnBytes;
  const uint32_t sq = sv + Tiling::kOwnBytes;                  // [kStages]
  const uint32_t sdo = sq + kStages * Tiling::kStreamBytes;    // [kStages]
  // [kStages][lse, δ][kM]
  float* stats = reinterpret_cast<float*>(smem_raw + pad + 2 * Tiling::kOwnBytes +
                                          2 * kStages * Tiling::kStreamBytes);
  const uint32_t kv_full = smem_u32(bars);
  const uint32_t full = kv_full + 8;       // + 8·stage
  const uint32_t empty = full + 8 * kStages;

  const int n0 = blockIdx.x * kRowsB;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int seq = a.seq;
  const int m_tiles = (seq + kM - 1) / kM;
  const int wg = threadIdx.x / 128;
  const int64_t stat0 = (static_cast<int64_t>(batch) * a.heads + head) * seq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    setmaxnreg_dec<Budget::kProducerRegs>();
    if (threadIdx.x % 128 < 32) {  // the producer warpgroup's first warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        prefetch_tensormap(&tq);
        prefetch_tensormap(&tdo);
        mbar_arrive_expect_tx(kv_full, 2 * Tiling::kOwnBytes);
        Tl::load(sk, kRowsB, &tk, kv_full, head, batch, n0);
        Tl::load(sv, kRowsB, &tv, kv_full, head, batch, n0);
      }
      for (int j = 0; j < m_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * Tiling::kStreamBytes);
          Tl::load(sq + s * Tiling::kStreamBytes, kM, &tq, full + 8 * s, head, batch, j * kM);
          Tl::load(sdo + s * Tiling::kStreamBytes, kM, &tdo, full + 8 * s, head, batch, j * kM);
        }
        // the tile's lse and δ rows, zeros past `seq`; each lane's arrival
        // releases its own stores
        float* st = stats + s * 2 * kM;
        for (int i = lane; i < kM; i += 32) {
          const int row = j * kM + i;
          st[i] = row < seq ? a.lse[stat0 + row] : 0.f;
          st[kM + i] = row < seq ? a.delta[stat0 + row] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    setmaxnreg_inc<Budget::kConsumerRegs>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, t = lane & 3;
    float dk[D / 2], dv[D / 2], st[kSub / 2], dpt[kSub / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kSub / 2; ++i) st[i] = dpt[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int j = 0; j < m_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t qt = sq + s * Tiling::kStreamBytes, dot = sdo + s * Tiling::kStreamBytes;
      const float* lt = stats + s * 2 * kM;
      const float* dt = lt + kM;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
#pragma unroll
      for (int h = 0; h < kM / kSub; ++h) {
        if (j * kM + kSub * h >= seq) break;  // past the sequence: p = 0, nothing to add
        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warpgroup's 64 K/V rows by the
        // tile's q rows kSub·h..kSub·h + kSub − 1
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kSub>(st, Tl::desc_k(sk, kRowsB, 64 * wg, kk),
                         Tl::desc_k(qt, kM, kSub * h, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kSub>(dpt, Tl::desc_k(sv, kRowsB, 64 * wg, kk),
                         Tl::desc_k(dot, kM, kSub * h, kk), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(st);
        fence_regs(dpt);

        // Pᵀ and dSᵀ in place; element i is q row (column) kSub·h + 8·(i / 4) + 2t + i % 2
        const int m0 = j * kM;
#pragma unroll
        for (int i = 0; i < kSub / 2; ++i) {
          const int c = kSub * h + 8 * (i >> 2) + 2 * t + (i & 1);
          const float p = m0 + c < seq ? exp2_approx(fmaf(st[i], a.scale_log2e, -lt[c])) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - dt[c]);
        }
        uint32_t pa[kSub / 16][4], da[kSub / 16][4];
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          pack_a(pa[kk], &st[8 * kk], &st[8 * kk + 4]);
          pack_a(da[kk], &dpt[8 * kk], &dpt[8 * kk + 4]);
        }

        // dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q over those q rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          wgmma_rs<D>(dv, pa[kk], dot, kM, kSub / 16 * h + kk);
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          wgmma_rs<D>(dk, da[kk], qt, kM, kSub / 16 * h + kk);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
      }
      mbar_arrive(empty + 8 * s);
    }

    bf16* dkb = a.dk + batch * a.dks.b + head * a.dks.h;
    bf16* dvb = a.dv + batch * a.dvs.b + head * a.dvs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = n0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
      if (row >= seq) continue;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        const int col = d * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkb + row * a.dks.s + col) =
            pack_bf16(dk[4 * d + 2 * r] * a.scale, dk[4 * d + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + row * a.dvs.s + col) =
            pack_bf16(dv[4 * d + 2 * r], dv[4 * d + 2 * r + 1]);
      }
    }
  }
}

template <int D, int kConsumers>
__global__ void __launch_bounds__(128 * (kConsumers + 1), kConsumers == 1 ? 2 : 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                Args<bf16> a) {
  using namespace fa_sm90;
  using Tiling = BwdTiling<D, kConsumers>;
  using Tl = typename Tiling::Tile;
  using Budget = typename Tiling::Budget;
  constexpr int kStages = Tiling::kStages;
  constexpr int kRowsB = Tiling::kRows;
  constexpr int kN = Tiling::kStream;   // K/V rows a streamed tile
  constexpr int kSub = Tiling::kSub;
  constexpr int kDTiles = D / 8;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + Tiling::kOwnBytes;
  const uint32_t sk = sdo + Tiling::kOwnBytes;                 // [kStages]
  const uint32_t sv = sk + kStages * Tiling::kStreamBytes;     // [kStages]
  const uint32_t qd_full = smem_u32(bars);
  const uint32_t k_full = qd_full + 8;  // + 8·stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int m0 = blockIdx.x * kRowsB;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int seq = a.seq;
  const int n_tiles = (seq + kN - 1) / kN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    setmaxnreg_dec<Budget::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      mbar_arrive_expect_tx(qd_full, 2 * Tiling::kOwnBytes);
      Tl::load(sq, kRowsB, &tq, qd_full, head, batch, m0);
      Tl::load(sdo, kRowsB, &tdo, qd_full, head, batch, m0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, Tiling::kStreamBytes);
        Tl::load(sk + s * Tiling::kStreamBytes, kN, &tk, k_full + 8 * s, head, batch, j * kN);
        mbar_arrive_expect_tx(v_full + 8 * s, Tiling::kStreamBytes);
        Tl::load(sv + s * Tiling::kStreamBytes, kN, &tv, v_full + 8 * s, head, batch, j * kN);
      }
    }
  } else {
    setmaxnreg_inc<Budget::kConsumerRegs>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, t = lane & 3;
    // rows g and g + 8 of this warp's band, and their statistics
    const int64_t stat0 = (static_cast<int64_t>(batch) * a.heads + head) * seq;
    float lse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
      lse[r] = row < seq ? a.lse[stat0 + row] : 0.f;
      delta[r] = row < seq ? a.delta[stat0 + row] : 0.f;
    }
    float dq[D / 2], sc[kSub / 2], dp[kSub / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kSub / 2; ++i) sc[i] = dp[i] = 0.f;

    mbar_wait(qd_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t kt = sk + s * Tiling::kStreamBytes, vt = sv + s * Tiling::kStreamBytes;
      mbar_wait(k_full + 8 * s, parity);
      mbar_wait(v_full + 8 * s, parity);
#pragma unroll
      for (int h = 0; h < kN / kSub; ++h) {
        if (j * kN + kSub * h >= seq) break;  // past the sequence: p = 0, nothing to add
        // S = Q·Kᵀ and dP = dO·Vᵀ for this warpgroup's 64 q rows and the
        // tile's K/V rows kSub·h..kSub·h + kSub − 1
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kSub>(sc, Tl::desc_k(sq, kRowsB, 64 * wg, kk),
                         Tl::desc_k(kt, kN, kSub * h, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kSub>(dp, Tl::desc_k(sdo, kRowsB, 64 * wg, kk),
                         Tl::desc_k(vt, kN, kSub * h, kk), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);

        // dS in place of S; element i is K/V row n0 + 8·(i / 4) + 2t + i % 2,
        // q row g + 8·((i / 2) % 2)
        const int n0 = j * kN + kSub * h;
#pragma unroll
        for (int i = 0; i < kSub / 2; ++i) {
          const int r = (i >> 1) & 1;
          const bool in = n0 + 8 * (i >> 2) + 2 * t + (i & 1) < seq;
          const float p = in ? exp2_approx(fmaf(sc[i], a.scale_log2e, -lse[r])) : 0.f;
          sc[i] = p * (dp[i] - delta[r]);
        }
        uint32_t da[kSub / 16][4];
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) pack_a(da[kk], &sc[8 * kk], &sc[8 * kk + 4]);

        // dQ += bf16(dS)·K over those K rows, K read MN-major
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          wgmma_rs<D>(dq, da[kk], kt, kN, kSub / 16 * h + kk);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dq);
        fence_regs(da);
      }
      mbar_arrive(empty + 8 * s);
    }

    bf16* dqb = a.dq + batch * a.dqs.b + head * a.dqs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
      if (row >= seq) continue;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
        *reinterpret_cast<uint32_t*>(dqb + row * a.dqs.s + d * 8 + 2 * t) =
            pack_bf16(dq[4 * d + 2 * r] * a.scale, dq[4 * d + 2 * r + 1] * a.scale);
    }
  }
}

// δ, one warp per score row
template <typename T, int D>
cudaError_t launch_delta(const Args<T>& a, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(a.batch) * a.heads * a.seq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  delta_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename A>
cudaError_t launch_one(void (*kernel)(A), const A& a, dim3 grid, int threads,
                       size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args<float>& a, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, D>(a, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kBlock - 1) / kBlock, a.heads, a.batch);
  err = launch_one(dkdv_kernel<float, D>, a, grid, kThreads, dkdv_smem_bytes<D>(), stream);
  if (err != cudaSuccess) return err;
  return launch_one(dq_kernel<float, D>, a, grid, kThreads, dq_smem_bytes<D>(), stream);
}

template <int D, int kConsumers>
cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         const CUtensorMap& tdo, const Args<bf16>& a, cudaStream_t stream) {
  using Tiling = BwdTiling<D, kConsumers>;
  const dim3 grid((a.seq + Tiling::kRows - 1) / Tiling::kRows, a.heads, a.batch);
  using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, Args<bf16>);
  const Kernel kernels[2] = {dkdv_wgmma_kernel<D, kConsumers>, dq_wgmma_kernel<D, kConsumers>};
  for (const Kernel kernel : kernels) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Tiling::kSmem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, Tiling::Budget::kThreads, Tiling::kSmem, stream>>>(tq, tk, tv, tdo, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// δ, then one tensor map per streamed operand and the two passes at this
// sequence length's tiling
template <int D>
int launch_bf16(const Args<bf16>& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = fa_sm90::bind_context();
  if (err == 0) err = fa_sm90::encode_bshd(&tq, a.q, a.batch, a.seq, a.heads, D, a.qs);
  if (err == 0) err = fa_sm90::encode_bshd(&tk, a.k, a.batch, a.seq, a.heads, D, a.ks);
  if (err == 0) err = fa_sm90::encode_bshd(&tv, a.v, a.batch, a.seq, a.heads, D, a.vs);
  if (err == 0) err = fa_sm90::encode_bshd(&tdo, a.dout, a.batch, a.seq, a.heads, D, a.dos);
  if (err != 0) return err;
  err = launch_delta<bf16, D>(a, stream);
  if (err != cudaSuccess) return err;
  if (a.seq <= kShortSeq) return launch_wgmma<D, 1>(tq, tk, tv, tdo, a, stream);
  return launch_wgmma<D, 2>(tq, tk, tv, tdo, a, stream);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int seq,
        int heads, int dim, const int64_t* st, float scale, float scale_log2e,
        cudaStream_t stream) {
  auto strides = [st](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(o),
            static_cast<const T*>(dout), lse, delta,
            static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
            strides(0), strides(1), strides(2), strides(3), strides(4),
            strides(5), strides(6), strides(7),
            batch, seq, heads, scale, scale_log2e};
  if constexpr (sizeof(T) == sizeof(float)) {
    switch (dim) {
      case 32: return launch_f32<32>(a, stream);
      case 64: return launch_f32<64>(a, stream);
      case 128: return launch_f32<128>(a, stream);
    }
  } else {
    switch (dim) {
      case 32: return launch_bf16<32>(a, stream);
      case 64: return launch_bf16<64>(a, stream);
      case 128: return launch_bf16<128>(a, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 24 element strides, the
// (batch, seq, head) strides of q, k, v, o, dout, dq, dk, dv in that order;
// for bfloat16 the base pointers must be 16-byte aligned and the strides
// multiples of 8. `lse` is the forward's contiguous fp32 [batch, heads, seq];
// `delta` is scratch of the same shape. Returns 0 when all three kernels
// launched, the first failing launch's cudaError_t, or (bfloat16)
// fa_sm90::kEncodeError + the CUresult of a tensor-map encode that failed;
// the kernels' own faults show at the next synchronisation.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int dtype, int batch,
                              int seq, int heads, int dim,
                              const int64_t* strides, float scale,
                              float scale_log2e, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads, dim,
                      strides, scale, scale_log2e, st);
  if (dtype == 1)
    return run<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads, dim,
                     strides, scale, scale_log2e, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
