// One-pass LayerNorm forward with a fused epilogue, for the port's forwards
// that record no autograd graph (classify, sampling, evaluation).
//
// Replaces no TPU kernel: the JAX package leaves flax's LayerNorm, its cast
// and the DiT's AdaLN modulation to XLA, which fuses them into the
// neighbouring passes. Run eagerly on the H100 the same arithmetic is ~15
// launches a norm, each a pass over device memory; this kernel is one. It
// computes, for each row of D values,
//
//   mean = sum(x)·(1/D), msq = sum(x·x)·(1/D)       (fp32, x upcast)
//   var = max(msq − mean·mean, 0)                     (flax's variance)
//   y = (x − mean)·rsqrt(var + eps)                   (fp32)
//
// then one epilogue, every step rounded to T, the output's type, as the
// plain chain rounds it (ops/layer_norm.py::layer_norm_reference):
//
//   0 none:   out = T(y)
//   1 affine: out = T(y·w + b), w and b fp32 [D] (the LayerNorm module)
//   2 adaln:  r = T(y); out = T(T(r·T(1 + scale)) + shift), scale and
//             shift T rows [B, D], one row a sample of S rows (the DiT)
//
// The steps from the statistics to the output are `__fsub_rn`/`__fmul_rn`/
// `__fadd_rn`, or bf16-pair instructions with `.rn`, so nvcc contracts none
// into an FMA that the plain chain does not round like. Only the statistics
// differ from it: their fp32 sums run in another order (with FMAs).
//
// Bound: bytes. At the DiT's [128, 1024, 384] bf16 a norm reads 2 bytes and
// writes 2 an element, 201 MB, 0.060 ms at 3.35 TB/s, far below the ~295
// flop/byte ridge. The design streams:
// - A group of kLanes lanes (4 to 32) takes a row; a block of 128 threads
//   takes 128/kLanes rows. Each lane loads kChunks chunks of 16 bytes (8 bf16
//   or 4 fp32), neighbouring lanes on neighbouring chunks, and keeps them in
//   registers as loaded, so x is read once. kLanes is the smallest group
//   that leaves a lane at most 4 chunks (8 when kLanes is 32): 16 lanes × 3
//   chunks at D = 384, 8 × 4 at 256, 16 × 4 at 512, 32 × 4 at 1024.
// - The two fp32 sums reduce across the group by `__shfl_xor_sync`, with no
//   shared memory and no block barrier.
// - The epilogue's operands (w, b, or the sample's scale and shift row) are
//   loaded per chunk with the same 16-byte width; a sample's rows share one
//   scale row, which stays in L1. A bf16 output is rounded and modulated in
//   pairs (one `cvt`, `add` or `mul` a pair a step: the instructions an
//   element fell from ~19 to ~8), and written once, 16 bytes a lane.
// - Rows longer than 256 chunks (and rows whose width or strides are no
//   multiple of the chunk, at one element a chunk) take
//   layer_norm_long_rows: a warp a row, the statistics in a first pass and
//   the output in a second that reads the row again, from L1 or L2.
// Measured on the card and not kept (PERF.md): 256-thread blocks; at most 6
// or 8 chunks a lane; register caps by launch bounds (they spill); a
// persistent grid, with and without the next row's loads issued before this
// row's sums; tiles of rows staged in shared memory by `cp.async.bulk`
// through 2-4 mbarrier stages; streaming cache hints. None was faster at the
// DiT's shape; ATen's own `copy_` of the same 100 MB moves 201 MB at about
// 2.8 TB/s there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
enum Epilogue { kNone = 0, kAffine = 1, kAdaLN = 2 };

struct Params {
  const void* x;
  void* out;
  const void* p0;  // w (affine) or scale (adaln)
  const void* p1;  // b (affine) or shift (adaln)
  int64_t rows, seq, dim;
  int64_t x_sb, x_ss;  // x's element strides over (sample, token)
  int64_t p_sb;        // the scale and shift rows' element stride
  float eps, inv_dim;
  int epilogue;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and read back: an intermediate the plain chain stores in T
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// bf16 pairs in a 32-bit word, the lower address in the low half. The `.rn`
// of each instruction keeps ptxas from contracting a product and an add into
// one fused, once-rounded step.
__device__ __forceinline__ uint32_t bf16x2_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// kN consecutive values of one operand, loaded and stored whole (16 bytes,
// or two 16-byte halves for fp32 weights beside a bf16 chunk)
template <typename T, int kN>
struct alignas(kN * sizeof(T) >= 16 ? 16 : kN * sizeof(T)) Pack {
  T v[kN];
};

template <typename T, int kN>
__device__ __forceinline__ Pack<T, kN> load(const void* base, int64_t offset) {
  return *reinterpret_cast<const Pack<T, kN>*>(static_cast<const T*>(base) + offset);
}

// the normalised chunk y through the epilogue into T, stored at out[col]
template <typename TOut, int kVec>
__device__ __forceinline__ void finish(const Params& p, int64_t b, int64_t col, const float (&y)[kVec],
                                       TOut* out) {
  Pack<TOut, kVec> o;
  float z[kVec];  // y, or y·w + b in fp32
#pragma unroll
  for (int i = 0; i < kVec; ++i) z[i] = y[i];
  if (p.epilogue == kAffine) {
    const Pack<float, kVec> w = load<float, kVec>(p.p0, col);
    const Pack<float, kVec> bias = load<float, kVec>(p.p1, col);
#pragma unroll
    for (int i = 0; i < kVec; ++i) z[i] = __fadd_rn(__fmul_rn(y[i], w.v[i]), bias.v[i]);
  }
  if constexpr (std::is_same<TOut, __nv_bfloat16>::value && kVec % 2 == 0) {
    // bf16 pairs, one instruction each step. An add or a product of bf16
    // values rounded once to bf16 equals the fp32 result rounded to bf16
    // (24 bits ≥ 2·8 + 2: the double rounding is innocuous), so the AdaLN
    // steps give the plain chain's bits.
    uint32_t* o2 = reinterpret_cast<uint32_t*>(o.v);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) o2[i] = bf16x2_pack(z[2 * i], z[2 * i + 1]);
    if (p.epilogue == kAdaLN) {
      const Pack<TOut, kVec> scale = load<TOut, kVec>(p.p0, b * p.p_sb + col);
      const Pack<TOut, kVec> shift = load<TOut, kVec>(p.p1, b * p.p_sb + col);
      const uint32_t* sc = reinterpret_cast<const uint32_t*>(scale.v);
      const uint32_t* sh = reinterpret_cast<const uint32_t*>(shift.v);
      constexpr uint32_t kOnes = 0x3f803f80u;  // (1, 1) in bf16
#pragma unroll
      for (int i = 0; i < kVec / 2; ++i) o2[i] = bf16x2_add(bf16x2_mul(o2[i], bf16x2_add(kOnes, sc[i])), sh[i]);
    }
  } else if (p.epilogue == kAdaLN) {
    const Pack<TOut, kVec> scale = load<TOut, kVec>(p.p0, b * p.p_sb + col);
    const Pack<TOut, kVec> shift = load<TOut, kVec>(p.p1, b * p.p_sb + col);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float r = round_to<TOut>(y[i]);
      const float s1 = round_to<TOut>(__fadd_rn(1.0f, to_float(scale.v[i])));
      const float t = round_to<TOut>(__fmul_rn(r, s1));
      o.v[i] = from_float<TOut>(__fadd_rn(t, to_float(shift.v[i])));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) o.v[i] = from_float<TOut>(z[i]);
  }
  *reinterpret_cast<Pack<TOut, kVec>*>(out + col) = o;
}

// mean and 1/std of a row from the group's partial sums (kLanes lanes, a
// power of two, aligned within the warp: the xor partners stay in the group)
template <int kLanes>
__device__ __forceinline__ void row_stats(const Params& p, float sum, float sq, float& mean, float& rstd) {
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset /= 2) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, offset));
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, offset));
  }
  mean = __fmul_rn(sum, p.inv_dim);
  const float d = __fsub_rn(__fmul_rn(sq, p.inv_dim), __fmul_rn(mean, mean));
  const float var = d < 0.0f ? 0.0f : d;  // a NaN passes, as torch.clamp passes it
  rstd = rsqrtf(__fadd_rn(var, p.eps));
}

template <typename TIn, typename TOut, int kVec, int kLanes, int kChunks>
__global__ void __launch_bounds__(kThreads) layer_norm_rows(const Params p) {
  const int lane = threadIdx.x % kLanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool live = row < p.rows;  // dead lanes still join the shuffles
  const int64_t b = live ? static_cast<uint32_t>(row) / static_cast<uint32_t>(p.seq) : 0;
  const int64_t s = live ? row - b * p.seq : 0;
  const TIn* x = static_cast<const TIn*>(p.x) + b * p.x_sb + s * p.x_ss;

  Pack<TIn, kVec> in[kChunks];
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t col = static_cast<int64_t>(c * kLanes + lane) * kVec;
    if (live && col < p.dim) {
      in[c] = load<TIn, kVec>(x, col);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float v = to_float(in[c].v[i]);
        sum += v;
        sq = fmaf(v, v, sq);
      }
    }
  }
  float mean, rstd;
  row_stats<kLanes>(p, sum, sq, mean, rstd);
  TOut* out = static_cast<TOut*>(p.out) + row * p.dim;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t col = static_cast<int64_t>(c * kLanes + lane) * kVec;
    if (live && col < p.dim) {
      float y[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) y[i] = __fmul_rn(__fsub_rn(to_float(in[c].v[i]), mean), rstd);
      finish<TOut, kVec>(p, b, col, y, out);
    }
  }
}

template <typename TIn, typename TOut, int kVec>
__global__ void __launch_bounds__(kThreads) layer_norm_long_rows(const Params p) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const bool live = row < p.rows;
  const int64_t b = live ? row / p.seq : 0;
  const int64_t s = live ? row - b * p.seq : 0;
  const TIn* x = static_cast<const TIn*>(p.x) + b * p.x_sb + s * p.x_ss;
  const int64_t end = live ? p.dim : 0;

  float sum = 0.0f, sq = 0.0f;
  for (int64_t col = static_cast<int64_t>(lane) * kVec; col < end; col += 32 * kVec) {
    const Pack<TIn, kVec> in = load<TIn, kVec>(x, col);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float v = to_float(in.v[i]);
      sum += v;
      sq = fmaf(v, v, sq);
    }
  }
  float mean, rstd;
  row_stats<32>(p, sum, sq, mean, rstd);
  TOut* out = static_cast<TOut*>(p.out) + row * p.dim;
  for (int64_t col = static_cast<int64_t>(lane) * kVec; col < end; col += 32 * kVec) {
    const Pack<TIn, kVec> in = load<TIn, kVec>(x, col);
    float y[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) y[i] = __fmul_rn(__fsub_rn(to_float(in.v[i]), mean), rstd);
    finish<TOut, kVec>(p, b, col, y, out);
  }
}

template <typename TIn, typename TOut, int kVec, int kLanes, int kChunks>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  constexpr int kRows = kThreads / kLanes;
  const int64_t blocks = (p.rows + kRows - 1) / kRows;
  layer_norm_rows<TIn, TOut, kVec, kLanes, kChunks><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TIn, typename TOut, int kVec>
cudaError_t launch_long(const Params& p, cudaStream_t stream) {
  const int64_t blocks = (p.rows + kThreads / 32 - 1) / (kThreads / 32);
  layer_norm_long_rows<TIn, TOut, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// the tiling for a row of n chunks: the smallest group of lanes that leaves
// a lane at most 4 chunks, 32 lanes up to 8; longer rows, and rows that are
// not `vectorized`, take the two-pass kernel
template <typename TIn, typename TOut>
cudaError_t launch(const Params& p, bool vectorized, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TIn);
  if (!vectorized) return launch_long<TIn, TOut, 1>(p, stream);
  const int64_t n = p.dim / kVec;
  if (n <= 4) return launch_rows<TIn, TOut, kVec, 4, 1>(p, stream);
  if (n <= 8) return launch_rows<TIn, TOut, kVec, 4, 2>(p, stream);
  if (n <= 12) return launch_rows<TIn, TOut, kVec, 4, 3>(p, stream);
  if (n <= 16) return launch_rows<TIn, TOut, kVec, 4, 4>(p, stream);
  if (n <= 24) return launch_rows<TIn, TOut, kVec, 8, 3>(p, stream);
  if (n <= 32) return launch_rows<TIn, TOut, kVec, 8, 4>(p, stream);
  if (n <= 48) return launch_rows<TIn, TOut, kVec, 16, 3>(p, stream);
  if (n <= 64) return launch_rows<TIn, TOut, kVec, 16, 4>(p, stream);
  if (n <= 96) return launch_rows<TIn, TOut, kVec, 32, 3>(p, stream);
  if (n <= 128) return launch_rows<TIn, TOut, kVec, 32, 4>(p, stream);
  if (n <= 160) return launch_rows<TIn, TOut, kVec, 32, 5>(p, stream);
  if (n <= 192) return launch_rows<TIn, TOut, kVec, 32, 6>(p, stream);
  if (n <= 224) return launch_rows<TIn, TOut, kVec, 32, 7>(p, stream);
  if (n <= 256) return launch_rows<TIn, TOut, kVec, 32, 8>(p, stream);
  return launch_long<TIn, TOut, kVec>(p, stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (ops/kernel.py's DTYPE_CODES).
// x is [rows / seq, seq, dim] at element strides (x_sb, x_ss, 1); out is
// contiguous [rows, dim]. `vectorized`: dim and x's strides are multiples of
// 16 / sizeof(x) elements and every operand's base is 16-byte aligned (the
// wrapper checks). Returns the launch's cudaError_t.
extern "C" int layer_norm(const void* x, void* out, const void* p0, const void* p1, int64_t rows,
                          int64_t seq, int64_t dim, int64_t x_sb, int64_t x_ss, int64_t p_sb,
                          int in_dtype, int out_dtype, int epilogue, int vectorized, float eps,
                          void* stream) {
  if (rows <= 0 || seq <= 0 || dim <= 0 || epilogue < kNone || epilogue > kAdaLN || rows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, out, p0, p1, rows, seq, dim, x_sb, x_ss, p_sb, eps,
                 1.0f / static_cast<float>(dim), epilogue};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vectorized != 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == 1 && out_dtype == 1) err = launch<__nv_bfloat16, __nv_bfloat16>(p, vec, st);
  else if (in_dtype == 1 && out_dtype == 0) err = launch<__nv_bfloat16, float>(p, vec, st);
  else if (in_dtype == 0 && out_dtype == 1) err = launch<float, __nv_bfloat16>(p, vec, st);
  else if (in_dtype == 0 && out_dtype == 0) err = launch<float, float>(p, vec, st);
  return static_cast<int>(err);
}
