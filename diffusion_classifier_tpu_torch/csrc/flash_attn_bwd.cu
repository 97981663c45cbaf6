// Non-causal flash-attention backward for Hopper (sm_90a): bf16 on the tensor
// cores, fp32 on scalar FMAs.
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
//      buys run-to-run identical dq without atomics.
//
// Bound: at (B, S, H, D) = (16, 1024, 6, 64) bf16 the call needs
// 10·B·H·S²·D = 64.4 GFLOP (s, dp, dv, dk, dq) over 101 MB (q, k, v, O, dO
// and the fp32 lse in; dq, dk, dv out), ~640 flops per byte, above the
// H100's ~295 flop/byte bf16 ridge: compute-bound, 0.0651 ms at the 989
// TFLOP/s bf16 dense peak (chip_smoke.py's bound, H100 80GB HBM3 at 700 W).
// Only the tensor cores come near it, so the bf16 passes are built on them,
// every product an `mma.sync.m16n8k16` (bf16 operands, fp32 accumulators),
// 4 warps a block. Each warp owns two 16-row bands at D ≤ 64 (one at
// D = 128, register budget): with one band, one `ldmatrix` fed two `mma`s and
// shared-memory reads set the pace; two bands double the products per read.
// The streamed tiles are 32 rows and ride a two-deep `cp.async` ring (the
// next tile's copy runs under this tile's products). The tiling was chosen
// by timing the alternatives on the card (PERF.md, PR 3's tilings table).
//
// dkdv_mma_kernel: K/V rows are the M dimension. The q/dO tiles stream with
// their lse and δ, and the tiles are computed transposed: Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ (K, V as A fragments by `ldmatrix` at each k step — held for the
// whole sweep beside two bands' dk/dv sums they would pass 255 registers;
// Q, dO as B), then Pᵀ = exp2(c·Sᵀ − lse[col]) and dSᵀ = Pᵀ∘(dPᵀ − δ[col]) on
// the accumulators, whose m16n8 layout packed to bf16 is the A fragment of
// the next product: dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q take A from
// registers and dO, Q through `ldmatrix.trans`. P and dS never touch shared
// memory; `scale` multiplies dK once at the store.
//
// dq_mma_kernel: q rows are M; Q and dO are A fragments in registers for the
// whole sweep, and K/V tiles stream. S = Q·Kᵀ, dP = dO·Vᵀ, dS = P∘(dP − δ[row])
// in registers, dQ += bf16(dS)·K with K through `ldmatrix.trans`.
//
// In both, c and −lse enter in one FFMA and exp2 is one `ex2.approx`. The
// ragged last tiles: rows past `seq` are zero-filled by `cp.async`, p (and so
// ds) is forced to 0 in columns past `seq` (a zero q row would otherwise
// score s = 0 against lse 0, p = 1), and rows past `seq` are never stored.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using fa_mma::bf16;

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

struct Strides {
  int64_t b, s, h;
};

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

// The bf16 tiling of both passes: 4 warps of kBands 16-row bands each (K/V
// rows for dk/dv, q rows for dq) share each streamed tile of kStream rows
// (q/dO for dk/dv, K/V for dq); see the notes at the top.
template <int D>
struct MmaTiling {
  static constexpr int kWarps = 4;
  static constexpr int kBands = D <= 64 ? 2 : 1;
  static constexpr int kRows = kWarps * kBands * 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStream = 32;
  static_assert(kStream % 16 == 0, "the streamed rows are a k16 step of dV, dK and dQ");
  // the block's rows and two buffers of both streamed tiles, bf16 [..][D+8]
  static constexpr size_t kTiles = sizeof(bf16) * (2 * kRows + 4 * kStream) * (D + 8);
};

template <int D>
__global__ void __launch_bounds__(MmaTiling<D>::kThreads) dkdv_mma_kernel(Args<bf16> a) {
  using namespace fa_mma;
  using Tiling = MmaTiling<D>;
  constexpr int kThreadsM = Tiling::kThreads;
  constexpr int kBands = Tiling::kBands;
  constexpr int kStride = D + 8;
  constexpr int kM = Tiling::kStream;  // q rows per streamed tile
  constexpr int kQTile = kM * kStride;
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kM / 8;       // n8 tiles of a transposed score band
  constexpr int kDTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + Tiling::kRows * kStride;
  bf16* Qs = Vs + Tiling::kRows * kStride;  // [2][kM][kStride]
  bf16* dOs = Qs + 2 * kQTile;              // [2][kM][kStride]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kQTile);  // [2][kM]
  float* Dl = Ls + 2 * kM;                                  // [2][kM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int n0 = blockIdx.x * Tiling::kRows;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int seq = a.seq;
  const bf16* qb = a.q + batch * a.qs.b + head * a.qs.h;
  const bf16* gb = a.dout + batch * a.dos.b + head * a.dos.h;
  const int64_t stat0 = (static_cast<int64_t>(batch) * a.heads + head) * seq;
  const float* lse = a.lse + stat0;
  const float* delta = a.delta + stat0;

  load_rows<D, Tiling::kRows, kThreadsM>(Ks, a.k + batch * a.ks.b + head * a.ks.h, a.ks.s, n0, seq);
  load_rows<D, Tiling::kRows, kThreadsM>(Vs, a.v + batch * a.vs.b + head * a.vs.h, a.vs.s, n0, seq);
  load_rows<D, kM, kThreadsM>(Qs, qb, a.qs.s, 0, seq);
  load_rows<D, kM, kThreadsM>(dOs, gb, a.dos.s, 0, seq);
  load_stats<kM, kThreadsM>(Ls, lse, 0, seq);
  load_stats<kM, kThreadsM>(Dl, delta, 0, seq);
  cp_async_commit();

  float dk[kBands][kDTiles][4], dv[kBands][kDTiles][4];
#pragma unroll
  for (int i = 0; i < kBands; ++i)
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][d][e] = dv[i][d][e] = 0.f;

  const int m_tiles = (seq + kM - 1) / kM;
  for (int j = 0; j < m_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < m_tiles) {  // the next tile's copy runs under this tile's work
      const int m1 = (j + 1) * kM;
      load_rows<D, kM, kThreadsM>(Qs + (buf ^ 1) * kQTile, qb, a.qs.s, m1, seq);
      load_rows<D, kM, kThreadsM>(dOs + (buf ^ 1) * kQTile, gb, a.dos.s, m1, seq);
      load_stats<kM, kThreadsM>(Ls + (buf ^ 1) * kM, lse, m1, seq);
      load_stats<kM, kThreadsM>(Dl + (buf ^ 1) * kM, delta, m1, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * kQTile;
    const bf16* dOt = dOs + buf * kQTile;
    const float* Lt = Ls + buf * kM;
    const float* Dt = Dl + buf * kM;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warp's K/V rows by the tile's q rows.
    // K and V, the A operands, are read from shared memory at each k step:
    // held in registers for the whole sweep, with two bands' dk/dv sums,
    // they would pass 255 registers.
    float st[kBands][kNTiles][4], dpt[kBands][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kBands; ++i)
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][n][e] = dpt[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t ka[kBands][4], va[kBands][4];
#pragma unroll
      for (int i = 0; i < kBands; ++i) {
        ldmatrix_x4(ka[i], a_ptr(Ks, kStride, (warp * kBands + i) * 16, kk * 16, lane));
        ldmatrix_x4(va[i], a_ptr(Vs, kStride, (warp * kBands + i) * 16, kk * 16, lane));
      }
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_ptr_nk(Qt, kStride, np * 16, kk * 16, lane));
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          mma(st[i][2 * np], ka[i], b[0], b[1]);
          mma(st[i][2 * np + 1], ka[i], b[2], b[3]);
        }
        ldmatrix_x4(b, b_ptr_nk(dOt, kStride, np * 16, kk * 16, lane));
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          mma(dpt[i][2 * np], va[i], b[0], b[1]);
          mma(dpt[i][2 * np + 1], va[i], b[2], b[3]);
        }
      }
    }

    // Pᵀ and dSᵀ in place; element e of tile n is q row n·8 + 2t + e % 2
    const int m0 = j * kM;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const bool in = m0 + c < seq;
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          const float p = in ? exp2_approx(fmaf(st[i][n][e], a.scale_log2e, -Lt[c])) : 0.f;
          st[i][n][e] = p;
          dpt[i][n][e] = p * (dpt[i][n][e] - Dt[c]);
        }
      }

    // dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q over the tile's q rows
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk) {
      uint32_t pa[kBands][4], da[kBands][4];
#pragma unroll
      for (int i = 0; i < kBands; ++i) {
        pack_a(pa[i], st[i][2 * kk], st[i][2 * kk + 1]);
        pack_a(da[i], dpt[i][2 * kk], dpt[i][2 * kk + 1]);
      }
#pragma unroll
      for (int dn = 0; dn < kDTiles / 2; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_ptr_kn(dOt, kStride, kk * 16, dn * 16, lane));
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          mma(dv[i][2 * dn], pa[i], b[0], b[1]);
          mma(dv[i][2 * dn + 1], pa[i], b[2], b[3]);
        }
        ldmatrix_x4_trans(b, b_ptr_kn(Qt, kStride, kk * 16, dn * 16, lane));
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          mma(dk[i][2 * dn], da[i], b[0], b[1]);
          mma(dk[i][2 * dn + 1], da[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled on the next iteration
  }

  bf16* dkb = a.dk + batch * a.dks.b + head * a.dks.h;
  bf16* dvb = a.dv + batch * a.dvs.b + head * a.dvs.h;
#pragma unroll
  for (int i = 0; i < kBands; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = n0 + (warp * kBands + i) * 16 + (lane >> 2) + 8 * r;
      if (row >= seq) continue;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        const int col = d * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkb + row * a.dks.s + col) =
            pack_bf16(dk[i][d][2 * r] * a.scale, dk[i][d][2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + row * a.dvs.s + col) =
            pack_bf16(dv[i][d][2 * r], dv[i][d][2 * r + 1]);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(MmaTiling<D>::kThreads) dq_mma_kernel(Args<bf16> a) {
  using namespace fa_mma;
  using Tiling = MmaTiling<D>;
  constexpr int kThreadsM = Tiling::kThreads;
  constexpr int kBands = Tiling::kBands;
  constexpr int kStride = D + 8;
  constexpr int kN = Tiling::kStream;  // K/V rows per streamed tile
  constexpr int kKVTile = kN * kStride;
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = kN / 8;
  constexpr int kDTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + Tiling::kRows * kStride;
  bf16* Ks = dOs + Tiling::kRows * kStride;  // [2][kN][kStride]
  bf16* Vs = Ks + 2 * kKVTile;               // [2][kN][kStride]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int m0 = blockIdx.x * Tiling::kRows;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int seq = a.seq;
  const bf16* kb = a.k + batch * a.ks.b + head * a.ks.h;
  const bf16* vb = a.v + batch * a.vs.b + head * a.vs.h;
  const int64_t stat0 = (static_cast<int64_t>(batch) * a.heads + head) * seq;

  load_rows<D, Tiling::kRows, kThreadsM>(Qs, a.q + batch * a.qs.b + head * a.qs.h, a.qs.s, m0, seq);
  load_rows<D, Tiling::kRows, kThreadsM>(dOs, a.dout + batch * a.dos.b + head * a.dos.h, a.dos.s, m0, seq);
  load_rows<D, kN, kThreadsM>(Ks, kb, a.ks.s, 0, seq);
  load_rows<D, kN, kThreadsM>(Vs, vb, a.vs.s, 0, seq);
  cp_async_commit();

  // rows g and g + 8 of each of this warp's bands, and their statistics
  float lse[kBands][2], delta[kBands][2];
#pragma unroll
  for (int i = 0; i < kBands; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + (warp * kBands + i) * 16 + (lane >> 2) + 8 * r;
      lse[i][r] = row < seq ? a.lse[stat0 + row] : 0.f;
      delta[i][r] = row < seq ? a.delta[stat0 + row] : 0.f;
    }

  uint32_t qf[kBands][kKSteps][4], gf[kBands][kKSteps][4];
  float dq[kBands][kDTiles][4];
#pragma unroll
  for (int i = 0; i < kBands; ++i)
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][d][e] = 0.f;

  const int n_tiles = (seq + kN - 1) / kN;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<D, kN, kThreadsM>(Ks + (buf ^ 1) * kKVTile, kb, a.ks.s, (j + 1) * kN, seq);
      load_rows<D, kN, kThreadsM>(Vs + (buf ^ 1) * kKVTile, vb, a.vs.s, (j + 1) * kN, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < kBands; ++i)
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          ldmatrix_x4(qf[i][kk], a_ptr(Qs, kStride, (warp * kBands + i) * 16, kk * 16, lane));
          ldmatrix_x4(gf[i][kk], a_ptr(dOs, kStride, (warp * kBands + i) * 16, kk * 16, lane));
        }
    }
    const bf16* Kt = Ks + buf * kKVTile;
    const bf16* Vt = Vs + buf * kKVTile;

    // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's q rows
    float s[kBands][kNTiles][4], dp[kBands][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kBands; ++i)
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = dp[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_ptr_nk(Kt, kStride, np * 16, kk * 16, lane));
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          mma(s[i][2 * np], qf[i][kk], b[0], b[1]);
          mma(s[i][2 * np + 1], qf[i][kk], b[2], b[3]);
        }
        ldmatrix_x4(b, b_ptr_nk(Vt, kStride, np * 16, kk * 16, lane));
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          mma(dp[i][2 * np], gf[i][kk], b[0], b[1]);
          mma(dp[i][2 * np + 1], gf[i][kk], b[2], b[3]);
        }
      }

    // dS in place of S; element e of tile n is K/V row n0 + n·8 + 2t + e % 2
    const int n0 = j * kN;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = n0 + n * 8 + 2 * t + (e & 1) < seq;
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          const int r = e >> 1;
          const float p = in ? exp2_approx(fmaf(s[i][n][e], a.scale_log2e, -lse[i][r])) : 0.f;
          s[i][n][e] = p * (dp[i][n][e] - delta[i][r]);
        }
      }

    // dQ += bf16(dS)·K over the tile's K rows
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t da[kBands][4];
#pragma unroll
      for (int i = 0; i < kBands; ++i) pack_a(da[i], s[i][2 * kk], s[i][2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDTiles / 2; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_ptr_kn(Kt, kStride, kk * 16, dn * 16, lane));
#pragma unroll
        for (int i = 0; i < kBands; ++i) {
          mma(dq[i][2 * dn], da[i], b[0], b[1]);
          mma(dq[i][2 * dn + 1], da[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled on the next iteration
  }

  bf16* dqb = a.dq + batch * a.dqs.b + head * a.dqs.h;
#pragma unroll
  for (int i = 0; i < kBands; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + (warp * kBands + i) * 16 + (lane >> 2) + 8 * r;
      if (row >= seq) continue;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
        *reinterpret_cast<uint32_t*>(dqb + row * a.dqs.s + d * 8 + 2 * t) =
            pack_bf16(dq[i][d][2 * r] * a.scale, dq[i][d][2 * r + 1] * a.scale);
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

template <int D>
cudaError_t launch_bf16(const Args<bf16>& a, cudaStream_t stream) {
  cudaError_t err = launch_delta<bf16, D>(a, stream);
  if (err != cudaSuccess) return err;
  using Tiling = MmaTiling<D>;
  const dim3 grid((a.seq + Tiling::kRows - 1) / Tiling::kRows, a.heads, a.batch);
  // dk/dv also stage the streamed tiles' lse and δ, [2][kStream] fp32 each
  err = launch_one(dkdv_mma_kernel<D>, a, grid, Tiling::kThreads,
                   Tiling::kTiles + sizeof(float) * 4 * Tiling::kStream, stream);
  if (err != cudaSuccess) return err;
  return launch_one(dq_mma_kernel<D>, a, grid, Tiling::kThreads, Tiling::kTiles, stream);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int batch, int seq, int heads, int dim,
                const int64_t* st, float scale, float scale_log2e,
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
// `delta` is scratch of the same shape. Returns the first failing launch's
// cudaError_t (0 = all three launched); the kernels' own faults show at the
// next synchronisation.
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
  cudaError_t err;
  if (dtype == 0)
    err = run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads,
                     dim, strides, scale, scale_log2e, st);
  else if (dtype == 1)
    err = run<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads,
                    dim, strides, scale, scale_log2e, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
