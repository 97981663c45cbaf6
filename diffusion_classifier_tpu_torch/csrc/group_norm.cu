// One-pass GroupNorm forward with an optional SiLU epilogue, for the port's
// forwards that record no autograd graph (classify, sampling, evaluation).
//
// Replaces no TPU kernel: the JAX package's `group_norm_mxu`
// (diffusion_classifier_tpu/models/layers.py) is plain jnp, and XLA fuses it
// with the SiLU after it. Run eagerly on the H100 the same arithmetic is ~20
// launches a norm and a separate SiLU pass, ~20 bytes of device memory
// traffic an element; this kernel reads x once and writes the output once.
// For x [N, HW, C] (NHWC rows) in G groups of cg = C / G channels it
// computes, per (sample, group), over its n = HW·cg elements
//
//   s = sum(x), q = sum(T(x·x))                     (fp32 sums; the squares
//                                                     rounded to T, x's type,
//                                                     as group_norm_mxu forms
//                                                     them in bf16)
//   mean = s·(1/n), var = max(q·(1/n) − mean·mean, 0), inv = rsqrt(var + eps)
//
// then per channel c, w = T(inv·scale[c]) and
// b = T(bias[c] − (mean·inv)·scale[c]) (fp32 steps), and per element
//
//   y = T(T(x·w) + b)                                (the plain chain's two ops)
//   out = silu ? T(y / (1 + exp(−y))) : y            (fp32, rounded once, as
//                                                     F.silu on T computes it)
//
// every step `__fmul_rn`/`__fsub_rn`/`__fadd_rn`, or bf16-pair instructions
// with `.rn`, so that nvcc contracts none into an FMA that the plain chain
// (ops/group_norm.py::group_norm_reference) does not round like. The fp32
// sums run in another order than the chain's, and the SiLU divides by
// `__fdividef` (2 ulps) where ATen rounds the quotient exactly: at the
// CIFAR cell's largest norm the IEEE division took 0.297 ms against 0.226,
// and both matched the plain chain's bf16 outputs as often (99.9997%).
//
// Bound: bytes. At the CIFAR UNet's [1024, 32·32, 128] bf16 a norm reads 2
// bytes and writes 2 an element, 537 MB, 0.160 ms at 3.35 TB/s. The design:
// - A block of 256 threads owns whole groups of one sample: a tile of HW rows
//   × W channels, W a multiple of cg and of the 16-byte chunk (8 bf16, 4
//   fp32). The group statistics are block-local: no second launch, no
//   atomics, and a fixed order of every sum, so a run repeats its bits.
// - A thread keeps one column chunk of the tile and takes every rs-th row
//   (rs = 256 / (W / chunk)); it loads its kChunks chunks 16 bytes at a time
//   and holds them in registers as loaded, so x is read once. The caller
//   (ops/group_norm.py::tiling) picks W and kChunks from the shape alone: the
//   narrowest W whose rows fill 32-byte sectors and whose tile fits kChunks
//   ≤ 16 chunks a thread, widened while the tile leaves a thread fewer than 4
//   chunks. At [32·32, 128] with cg = 4 that is 16 channels: 32 KB a block, 8
//   chunks a thread, ~100 registers, two blocks an SM. Measured there (PERF.md):
//   rows of 64 bytes at 16 chunks (166 registers, one block an SM) took 1.4×
//   as long, rows of 16 bytes 2.4×, and a cap of 80 registers (three blocks)
//   spilled and was no faster.
// - A thread sums its elements into kAcc pairs of fp32 partials, one per run
//   of kVec / kAcc channels that lies in one group: kAcc = 1 where cg is a
//   multiple of the chunk (8 bf16, 4 fp32), 2 where it is a multiple of half
//   a chunk (bf16 cg = 4 or 12), else kVec, a partial a channel (cg = 7, 10,
//   14 or 21: diffusers' UNet2DModel and SD widths in 32 groups, whose tile
//   width lcm(cg, kVec) holds whole groups and whole chunks all the same).
//   The partials of one column fold across the warp by
//   `__shfl_xor_sync` (where W / chunk divides 32), then across warps
//   through shared memory; a thread a group sums its column runs and writes
//   mean and 1/std to shared memory.
// - The epilogue's w and b are formed once per thread for its chunk's
//   channels; a bf16 chunk is normalised in pairs (one `mul` and one `add` a
//   pair), and written once, 16 bytes a thread.
// - A tile that cannot be held at kChunks = 16 (more than 2,048 rows of 32
//   bytes: the CheXpert and IPMSA UNets at 128 × 128, SD-class latents)
//   takes group_norm_stream: the same statistics in a first pass, the
//   output in a second that reads the tile again. At [16, 128·128, 256] it
//   took 0.25-0.26 ms against a 0.080 ms bound (PERF.md): the re-read comes
//   mostly from device memory, since the 256 blocks read 134 MB in their
//   first pass; loading 8 rows a thread ahead, or reading the second pass
//   backwards, moved it by less than the spread between machines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* x;
  void* out;
  const float* scale;
  const float* bias;
  int64_t hw, channels;  // rows a sample; C, the length of a row
  int64_t x_sn, x_sr;    // x's element strides over (sample, row); channels contiguous
  int group_size;        // cg
  int width;             // W, a tile's channels
  int tiles;             // C / W
  float eps, inv_count;  // inv_count = 1 / (HW·cg)
  int silu;
};

using bf16 = __nv_bfloat16;

// kN consecutive values, loaded and stored whole (16 bytes)
template <typename T, int kN>
struct alignas(16) Pack {
  T v[kN];
};

// bf16 pairs in a 32-bit word, the lower address in the low half. The `.rn`
// of each instruction keeps ptxas from contracting the product and the add
// into one fused, once-rounded step.
__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_half(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
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

// ATen's SiLU, x / (1 + exp(−x)) in fp32, the quotient to 2 ulps (0 where
// 1 + exp(−x) lies in (2¹²⁶, 2¹²⁸), x in (−88.7, −87.3), where ATen's is ~1e-36)
__device__ __forceinline__ float silu(float v) { return __fdividef(v, __fadd_rn(1.0f, expf(-v))); }

// a chunk's values into the thread's partial sums, kVec / kAcc channels a partial
template <int kAcc>
__device__ __forceinline__ void accumulate(const Pack<bf16, 8>& in, float (&s)[kAcc], float (&q)[kAcc]) {
  constexpr int kSub = 8 / kAcc;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(in.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a product of two bf16 values is exact in fp32, so the pair product
    // rounded once to bf16 is the plain chain's bf16 square
    const uint32_t sq = bf16x2_mul(w[i], w[i]);
    s[2 * i / kSub] += lo_half(w[i]);
    s[(2 * i + 1) / kSub] += hi_half(w[i]);
    q[2 * i / kSub] += lo_half(sq);
    q[(2 * i + 1) / kSub] += hi_half(sq);
  }
}

template <int kAcc>
__device__ __forceinline__ void accumulate(const Pack<float, 4>& in, float (&s)[kAcc], float (&q)[kAcc]) {
  constexpr int kSub = 4 / kAcc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i / kSub] += in.v[i];
    q[i / kSub] += __fmul_rn(in.v[i], in.v[i]);
  }
}

// Folds the threads' partials into each group's mean and 1/std, in shared
// memory (mean[g], inv[g] for the tile's groups g). cw: chunks a tile row;
// rs: rows a pass; a thread holds column chunk cc of rows r0 + k·rs (an idle
// thread has r0 ≥ rs and holds zeros).
template <int kVec, int kAcc>
__device__ __forceinline__ void tile_stats(const Params& p, int cw, int rs, int cc, int r0, float (&s)[kAcc],
                                           float (&q)[kAcc], float* part_s, float* part_q, float* mean,
                                           float* inv) {
  const int sw = cw * kAcc;  // partials a tile row
  int parts;
  if (cw < 32 && 32 % cw == 0) {  // a column's threads in every warp: fold the warp first
    for (int offset = cw; offset < 32; offset *= 2) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], offset);
        q[j] += __shfl_xor_sync(0xffffffffu, q[j], offset);
      }
    }
    if (static_cast<int>(threadIdx.x % 32) < cw) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        part_s[(threadIdx.x / 32) * sw + cc * kAcc + j] = s[j];
        part_q[(threadIdx.x / 32) * sw + cc * kAcc + j] = q[j];
      }
    }
    parts = kThreads / 32;
  } else {
    if (r0 < rs) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        part_s[r0 * sw + cc * kAcc + j] = s[j];
        part_q[r0 * sw + cc * kAcc + j] = q[j];
      }
    }
    parts = rs;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < sw; i += kThreads) {  // a column run's total, into row 0
    float a = 0.0f, c = 0.0f;
    for (int k = 0; k < parts; ++k) {
      a += part_s[k * sw + i];
      c += part_q[k * sw + i];
    }
    part_s[i] = a;
    part_q[i] = c;
  }
  __syncthreads();
  const int runs = p.group_size / (kVec / kAcc);  // column runs a group
  for (int g = threadIdx.x; g < p.width / p.group_size; g += kThreads) {
    float a = 0.0f, c = 0.0f;
    for (int k = 0; k < runs; ++k) {
      a += part_s[g * runs + k];
      c += part_q[g * runs + k];
    }
    const float m = __fmul_rn(a, p.inv_count);
    const float d = __fsub_rn(__fmul_rn(c, p.inv_count), __fmul_rn(m, m));
    const float var = d < 0.0f ? 0.0f : d;  // a NaN passes, as torch.clamp passes it
    mean[g] = m;
    inv[g] = rsqrtf(__fadd_rn(var, p.eps));
  }
  __syncthreads();
}

// w and b of the chunk's channels (global column col, tile column tcol) in fp32
template <int kVec>
__device__ __forceinline__ void coefficients(const Params& p, int64_t col, int tcol, const float* mean,
                                             const float* inv, float (&w)[kVec], float (&b)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int g = (tcol + i) / p.group_size;
    const float sc = p.scale[col + i];
    w[i] = __fmul_rn(inv[g], sc);
    b[i] = __fsub_rn(p.bias[col + i], __fmul_rn(__fmul_rn(mean[g], inv[g]), sc));
  }
}

// y = T(T(x·w) + b), then the SiLU, for one chunk; w and b as the kernel holds them
struct Bf16Coefficients {
  uint32_t w[4], b[4];  // bf16 pairs
  __device__ __forceinline__ Bf16Coefficients(const float (&wf)[8], const float (&bf)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = bf16x2_pack(wf[2 * i], wf[2 * i + 1]);
      b[i] = bf16x2_pack(bf[2 * i], bf[2 * i + 1]);
    }
  }
  __device__ __forceinline__ Pack<bf16, 8> operator()(const Pack<bf16, 8>& in, bool act) const {
    Pack<bf16, 8> o;
    const uint32_t* x = reinterpret_cast<const uint32_t*>(in.v);
    uint32_t* y = reinterpret_cast<uint32_t*>(o.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a product or a sum of bf16 values rounded once to bf16 equals the
      // fp32 result rounded to bf16 (24 bits ≥ 2·8 + 2), as the chain rounds
      y[i] = bf16x2_add(bf16x2_mul(x[i], w[i]), b[i]);
      if (act) y[i] = bf16x2_pack(silu(lo_half(y[i])), silu(hi_half(y[i])));
    }
    return o;
  }
};

struct F32Coefficients {
  float w[4], b[4];
  __device__ __forceinline__ F32Coefficients(const float (&wf)[4], const float (&bf)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = wf[i];
      b[i] = bf[i];
    }
  }
  __device__ __forceinline__ Pack<float, 4> operator()(const Pack<float, 4>& in, bool act) const {
    Pack<float, 4> o;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float y = __fadd_rn(__fmul_rn(in.v[i], w[i]), b[i]);
      o.v[i] = act ? silu(y) : y;
    }
    return o;
  }
};

template <typename T>
using Coefficients = typename std::conditional<std::is_same<T, bf16>::value, Bf16Coefficients, F32Coefficients>::type;

template <typename T, int kVec>
__device__ __forceinline__ Pack<T, kVec> load(const T* x) {
  return *reinterpret_cast<const Pack<T, kVec>*>(x);
}

// the shared memory and the thread's place in its block's tile
template <typename T, int kAcc>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);
  int cw, rs, cc, r0;
  int64_t n, col;
  __device__ __forceinline__ explicit Tile(const Params& p) {
    cw = p.width / kVec;
    rs = kThreads / cw;
    cc = threadIdx.x % cw;
    r0 = threadIdx.x / cw;
    n = blockIdx.x / p.tiles;
    col = static_cast<int64_t>(blockIdx.x % p.tiles) * p.width + cc * kVec;
  }
  __device__ __forceinline__ const T* x(const Params& p) const {
    return static_cast<const T*>(p.x) + n * p.x_sn + col;
  }
  __device__ __forceinline__ T* out(const Params& p) const {
    return static_cast<T*>(p.out) + n * p.hw * p.channels + col;
  }
  // the statistics of the partials s, q; then this thread's chunk coefficients
  __device__ __forceinline__ Coefficients<T> finish_stats(const Params& p, float (&s)[kAcc], float (&q)[kAcc]) const {
    __shared__ float part_s[kThreads * kAcc], part_q[kThreads * kAcc];
    __shared__ float mean[kThreads], inv[kThreads];
    tile_stats<kVec, kAcc>(p, cw, rs, cc, r0, s, q, part_s, part_q, mean, inv);
    float w[kVec], b[kVec];
    coefficients<kVec>(p, col, cc * kVec, mean, inv, w, b);
    return Coefficients<T>(w, b);
  }
};

// the tile held in registers: kChunks chunks a thread, rows r0 + k·rs
template <typename T, int kChunks, int kAcc>
__global__ void __launch_bounds__(kThreads) group_norm_tile(const Params p) {
  constexpr int kVec = 16 / sizeof(T);
  const Tile<T, kAcc> t(p);
  const bool live = t.r0 < t.rs;
  const T* x = t.x(p);
  Pack<T, kVec> in[kChunks];
  float s[kAcc] = {}, q[kAcc] = {};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t r = t.r0 + c * t.rs;
    if (live && r < p.hw) in[c] = load<T, kVec>(x + r * p.x_sr);
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (live && t.r0 + c * t.rs < p.hw) accumulate<kAcc>(in[c], s, q);
  }
  const Coefficients<T> f = t.finish_stats(p, s, q);
  T* out = t.out(p);
  const bool act = p.silu != 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t r = t.r0 + c * t.rs;
    if (live && r < p.hw) *reinterpret_cast<Pack<T, kVec>*>(out + r * p.channels) = f(in[c], act);
  }
}

// a tile too tall to hold: the statistics in one pass, the output in a second
template <typename T, int kAcc>
__global__ void __launch_bounds__(kThreads) group_norm_stream(const Params p) {
  constexpr int kVec = 16 / sizeof(T);
  const Tile<T, kAcc> t(p);
  const int64_t end = t.r0 < t.rs ? p.hw : 0;
  const T* x = t.x(p);
  float s[kAcc] = {}, q[kAcc] = {};
  for (int64_t r = t.r0; r < end; r += t.rs) accumulate<kAcc>(load<T, kVec>(x + r * p.x_sr), s, q);
  const Coefficients<T> f = t.finish_stats(p, s, q);
  T* out = t.out(p);
  const bool act = p.silu != 0;
  for (int64_t r = t.r0; r < end; r += t.rs)
    *reinterpret_cast<Pack<T, kVec>*>(out + r * p.channels) = f(load<T, kVec>(x + r * p.x_sr), act);
}

template <typename T, int kAcc>
cudaError_t launch_tiles(const Params& p, unsigned blocks, int chunks, cudaStream_t stream) {
  switch (chunks) {
    case 0: group_norm_stream<T, kAcc><<<blocks, kThreads, 0, stream>>>(p); break;
    case 2: group_norm_tile<T, 2, kAcc><<<blocks, kThreads, 0, stream>>>(p); break;
    case 4: group_norm_tile<T, 4, kAcc><<<blocks, kThreads, 0, stream>>>(p); break;
    case 8: group_norm_tile<T, 8, kAcc><<<blocks, kThreads, 0, stream>>>(p); break;
    case 16: group_norm_tile<T, 16, kAcc><<<blocks, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// kAcc from cg: a partial covers a chunk, half a chunk or one channel, that lies in one group
template <typename T>
cudaError_t launch(const Params& p, unsigned blocks, int chunks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (p.group_size % kVec == 0) return launch_tiles<T, 1>(p, blocks, chunks, stream);
  if (p.group_size % (kVec / 2) == 0) return launch_tiles<T, 2>(p, blocks, chunks, stream);
  return launch_tiles<T, kVec>(p, blocks, chunks, stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (ops/kernel.py's DTYPE_CODES).
// x is [samples, hw, channels] at element strides (x_sn, x_sr, 1); out is
// contiguous, of x's type; scale and bias fp32 [channels]. A block takes `width`
// channels of one sample (a multiple of group_size and of 16 / sizeof
// element, dividing channels, at most 256 chunks and 256 groups); `chunks`
// (2, 4, 8 or 16) chunks a thread hold its rows, or 0: the two-pass kernel.
// The wrapper checks that x's base and strides are 16-byte aligned. Returns
// the launch's cudaError_t.
extern "C" int group_norm(const void* x, void* out, const void* scale, const void* bias, int64_t samples,
                          int64_t hw, int64_t channels, int64_t x_sn, int64_t x_sr, int64_t group_size,
                          int64_t width, int64_t chunks, int dtype, int silu, float eps, void* stream) {
  const int64_t vec = dtype == 1 ? 8 : 4;
  if (samples <= 0 || hw <= 0 || group_size <= 0 || width <= 0 || width % group_size || width % vec ||
      channels % width || width / vec > kThreads || width / group_size > kThreads || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rs = kThreads / (width / vec);
  const int64_t blocks = samples * (channels / width);
  if (blocks > 0x7fffffff || (chunks != 0 && chunks * rs < hw) || x_sn % vec || x_sr % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, out, static_cast<const float*>(scale), static_cast<const float*>(bias), hw, channels,
                 x_sn, x_sr, static_cast<int>(group_size), static_cast<int>(width),
                 static_cast<int>(channels / width), eps, 1.0f / static_cast<float>(hw * group_size), silu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
  const int k = static_cast<int>(chunks);
  return static_cast<int>(dtype == 1 ? launch<bf16>(p, b, k, st) : launch<float>(p, b, k, st));
}
