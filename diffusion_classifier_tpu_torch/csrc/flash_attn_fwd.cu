// Non-causal flash-attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU Pallas kernels `_flash_fused_heads` / `_flash_bh` of
// diffusion_classifier_tpu/ops/flash_attention.py (one function, two VMEM
// layouts; their shared body is `_softmax_pv`). It computes the same thing:
//
//   s = (q·c)·kᵀ with c = log2(e)/√D, in fp32   (q and k upcast first)
//   p = exp2(s − rowmax(s));  l = rowsum(p)     (fp32, p unrounded in l)
//   o = (p rounded to v's dtype)·v, fp32 sums;  out = o / l in q's dtype
//
// The TPU kernel held the whole K/V of a head in VMEM. A block here has at
// most 227 KB of shared memory, too little for K/V at S=4096, so the block
// streams K/V tiles and keeps an online softmax (running max m and sum l in
// fp32, the output rescaled by exp2(m_old − m_new) when the max moves).
//
// Grid: one block per (64-row q tile, head, batch); 256 threads. Thread
// (ty, tx) = (tid / 16, tid % 16) owns score rows 4·ty..4·ty+3 and columns
// tx + 16·j of each 64×64 score tile, and the output columns tx + 16·j of the
// same rows. Row max and row sum reduce over the 16 lanes of a half-warp.
// All products are plain fp32 FMAs on tiles staged in shared memory as fp32
// (a bf16 product is exact in fp32, so this is the TPU kernel's arithmetic).
//
// Bound: at S=1024, D=64 the call does about 4·S²·D flops over 4·S·D·2
// bytes per head — S/2 ≈ 512 flops per byte, above the H100's ~295 flop/byte
// bf16 ridge. So it is compute-bound, and this scalar-FMA version runs far
// below the tensor cores' rate: the later speed work is `wgmma` fed by TMA.
//
// Layout: q, k, v are [B, S, H, D] views with a contiguous last dim; batch,
// sequence and head strides are arguments, so the q/k/v thirds of a fused
// qkv projection go in without a copy. The ragged last q and k/v tiles are
// masked, so S needs no alignment.
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

namespace {

constexpr int kBlockM = 64;   // q rows per block
constexpr int kBlockN = 64;   // k/v rows per tile
constexpr int kThreads = 256;
constexpr int kRows = 4;      // score rows per thread
constexpr int kCols = 4;      // score columns per thread (strided by 16)

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int seq, int heads, Strides qs,
                   Strides ks,
                   Strides vs, Strides os, float scale_log2e,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq, qs, ks, vs, os,
      scale_log2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int dim, const void* q, const void* k, const void* v,
                         void* o, float* lse, int batch, int seq, int heads,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         float c, cudaStream_t st) {
  switch (dim) {
    case 32: return launch<T, 32>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, os, c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lse` is null
// or a contiguous fp32 [batch, heads, seq]. Returns the cudaError_t of the
// launch (0 = launched); the kernel's own faults show at the next
// synchronisation.
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
  if (dtype == 0)
    err = dispatch_dim<float>(dim, q, k, v, o, lse, batch, seq, heads, qs, ks,
                              vs, os, scale_log2e, st);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16>(dim, q, k, v, o, lse, batch, seq, heads,
                                      qs, ks, vs, os, scale_log2e, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
