// Non-causal flash-attention backward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU Pallas backward `_flash_bwd` of
// diffusion_classifier_tpu/ops/flash_attention.py: its lane-group kernel
// `_bwd_kernel_lanes` and its head-major kernel `_bwd_kernel_bh`, one
// function `_bwd_one_head` in two VMEM layouts. It computes the same thing:
//
//   s  = (q·c)·kᵀ in fp32, c = log2(e)/√D     (q and k upcast first)
//   p  = exp2(s − lse)                        (lse = m + log2 l from the forward)
//   dv = (p rounded to dO's dtype)ᵀ·dO,       fp32 sums
//   dp = dO·vᵀ in fp32
//   δ  = rowsum(dO ∘ O) in fp32               (= rowsum(p ∘ dp))
//   ds = p ∘ (dp − δ), rounded to q's dtype
//   dq = scale·ds·k,  dk = scale·dsᵀ·q,       outputs in the input dtype
//
// The TPU kernel held one head's whole [S, S] p/dp/ds in VMEM and gated
// S ≤ 1024, falling back to XLA above. A Hopper block has at most 227 KB of
// shared memory, so this is the FA2 design, in three launches with no S
// limit and no atomics (the result is the same from run to run):
//
//   1. delta: one warp per score row, δ = rowsum(dO ∘ O) in fp32 — the
//      forward's output stands in for the [S, S] product p ∘ dp;
//   2. dkdv: one block per (64-row K/V tile, head, batch); K and V stay in
//      shared memory while the block streams 64-row q/dO tiles and keeps the
//      tile's dk and dv sums in registers;
//   3. dq: one block per (64-row q tile, head, batch), streaming K/V tiles.
//      p and ds are recomputed here rather than summed across blocks.
//
// Thread (ty, tx) = (tid / 16, tid % 16) of 256 owns rows 4·ty..4·ty+3 and
// columns tx + 16·j of each 64×64 tile, as in the forward. All products are
// scalar fp32 FMAs on tiles staged in shared memory as fp32 (a product of
// two bf16 values is exact in fp32, so this is the TPU kernel's
// arithmetic); the score sums run in the forward's order, so p here is the
// forward's p.
//
// Bound: at (B, S, H, D) = (16, 1024, 6, 64) bf16 the call does
// 10·B·H·S²·D = 64.4 GFLOP (s, dv, dp, dq, dk: five S²·D products per head)
// over ~101 MB (q, k, v, O, dO and the fp32 lse in; dq, dk, dv out) — about
// 640 flops per byte, above the H100's ~295 flop/byte bf16 ridge, so it is
// compute-bound: 65 µs at the 989 TFLOP/s bf16 dense peak. This scalar-FMA
// version runs far below that; the later speed work is `wgmma` fed by TMA.
//
// Layout: q, k, v, O, dO and the gradients are [B, S, H, D] views with a
// contiguous last dim and any batch/sequence/head strides, so the q/k/v
// thirds of a fused qkv projection (and their gradients) need no copy. The
// ragged last tiles are masked: padded q rows get p = 0, padded K/V rows are
// never stored.
//
// Shared memory (fp32): dkdv holds K, V, q, dO tiles [64][D+1], p and ds
// [64][65] and 128 row statistics — 100 KB at D=64, 166 KB at D=128; dq
// holds q, dO, K, V tiles, ds and the statistics — 83 KB / 149 KB. Opted in
// above 48 KB with cudaFuncSetAttribute.
//
// Built by nvcc into a shared library with a plain C entry point
// (flash_attn_bwd) and bound with ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // rows of a q tile and of a K/V tile
constexpr int kThreads = 256;
constexpr int kRows = 4;      // tile rows per thread
constexpr int kCols = 4;      // tile columns per thread (strided by 16)
constexpr int kPStride = kBlock + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int D>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(a.batch) * a.heads * a.seq;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((a.seq + kBlock - 1) / kBlock, a.heads, a.batch);
  constexpr size_t kv_smem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, D><<<grid, kThreads, kv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t q_smem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<grid, kThreads, q_smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int dim, const Args<T>& a, cudaStream_t st) {
  switch (dim) {
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
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
  return dispatch_dim<T>(dim, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 24 element strides, the
// (batch, seq, head) strides of q, k, v, o, dout, dq, dk, dv in that order.
// `lse` is the forward's contiguous fp32 [batch, heads, seq]; `delta` is
// scratch of the same shape. Returns the first failing launch's cudaError_t
// (0 = all three launched); the kernels' own faults show at the next
// synchronisation.
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
    err = run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                             seq, heads, dim, strides, scale, scale_log2e, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
