// Rowwise-scaled fp8 (e4m3fn) quantize / dequantize for the quantized
// allreduce, written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels in
// torchft_tpu/ops/quantization.py: quantize_fp8_rowwise_kernel<false>
// replaces fused_quantize_fp8 (_quantize_kernel), dequantize_fp8_rowwise_kernel
// replaces fused_dequantize_fp8 (_dequantize_kernel).
// quantize_fp8_rowwise_kernel<true> is the same kernel with the reference's
// HOST codec rule (quantize_fp8_rowwise, which compress_bucket runs on every
// bucket of the streamed allreduce): a bucket that lies on the card is
// coded there to the codes and scales numpy gives, bit for bit.
//
// What bounds them on this card: bytes. Quantize reads 4 B and writes
// 1 B + 4/512 B per element; dequantize the reverse. There is no reuse, so
// the design only has to stream device memory once at full width:
//   * quantize: one warp per 512-element row, 16 values per lane held in
//     registers as four 16-byte loads, so the row is read from memory once
//     for both the amax and the codes. The amax is a warp-shuffle
//     reduction (no shared memory, no block barrier). The ragged tail is
//     zero-filled in registers: the caller never materializes a padded f32
//     copy in device memory.
//   * dequantize: one thread per 4 codes (one 4-byte load, one 16-byte
//     store), grid-strided.
//
// Numerics follow the reference kernel bit for bit on finite input:
//   scale = amax > 0 ? amax * (1/448) : 1  (the reciprocal multiply XLA
//   emits for the reference's amax / 448), codes = x / scale with an IEEE
//   divide (no fast-math, no flush-to-zero), rounded to nearest even.
//   The host rule (kHostRule): scale = amax / 448 and codes =
//   x * (1 / scale), each an IEEE f32 divide or multiply as numpy takes it,
//   NaN signs included (host_rule_code). One repair: a row whose scale has
//   no finite reciprocal (every value under 448 * 2^-128, which error
//   feedback reaches as a residual decays) is coded as a zero row (scale 1,
//   codes +-0), where the reference's x * inf codes it all NaN.
//   A quotient of magnitude above 464 (which would round past 448) and any
//   NaN become the NaN code 0x7f | sign, as ml_dtypes / XLA convert; the
//   hardware cvt alone would saturate to 448. amax propagates NaN as
//   jnp.max does, so a row holding a NaN gets scale 1.
//
// Plain C interface, bound with ctypes: each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 512;
constexpr int kWarpsPerBlock = 8;
constexpr int kVecPerLane = kRow / (32 * 4);  // float4 loads per lane

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.max semantics: NaN wins
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ uint32_t f32_to_e4m3fn(float v) {
  const uint32_t sign = (__float_as_uint(v) >> 24) & 0x80u;
  const float a = fabsf(v);
  if (!(a <= 464.0f)) return sign | 0x7fu;  // NaN, or rounds past 448
  // at most 2^-10 rounds (ties to even) to a signed zero; decided here so
  // an f32 subnormal quotient never depends on how the cvt treats it
  if (a <= 0x1p-10f) return sign;
  return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float e4m3fn_to_f32(uint32_t c) {
  const uint32_t sign = (c & 0x80u) << 24;
  const uint32_t e = (c >> 3) & 0xfu;
  const uint32_t m = c & 0x7u;
  if (e == 0xfu && m == 0x7u) return __uint_as_float(sign | 0x7fc00000u);
  if (e == 0) {
    const float v = static_cast<float>(m) * 0.001953125f;  // m * 2^-9
    return sign ? -v : v;
  }
  return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
}

// The host rule's code of v: numpy computes v * (1 / scale) on the host,
// where (x86) a NaN v keeps its sign and an invalid product (inf * 0,
// 0 * inf) is the default NaN, whose sign bit x86 sets. CUDA's multiply
// returns a positive NaN for both, so they are decided here.
__device__ __forceinline__ uint32_t host_rule_code(float v, float inv) {
  if (v != v) return ((__float_as_uint(v) >> 24) & 0x80u) | 0x7fu;
  const float p = __fmul_rn(v, inv);
  return p != p ? 0xffu : f32_to_e4m3fn(p);
}

template <bool kHostRule>
__global__ void quantize_fp8_rowwise_kernel(const float* __restrict__ x,
                                            int64_t n, int64_t rows,
                                            bool aligned,
                                            uint8_t* __restrict__ q,
                                            float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int64_t base = r * kRow;

  float v[kVecPerLane][4];
  const bool full = aligned && base + kRow <= n;
#pragma unroll
  for (int j = 0; j < kVecPerLane; ++j) {
    const int64_t e = base + (static_cast<int64_t>(j) * 32 + lane) * 4;
    if (full) {
      const float4 f = *reinterpret_cast<const float4*>(x + e);
      v[j][0] = f.x; v[j][1] = f.y; v[j][2] = f.z; v[j][3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = (e + k < n) ? x[e + k] : 0.0f;
    }
  }

  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecPerLane; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) amax = nan_max(amax, fabsf(v[j][k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  float scale =
      amax > 0.0f ? (kHostRule ? __fdiv_rn(amax, 448.0f) : amax * (1.0f / 448.0f))
                  : 1.0f;
  float inv = kHostRule ? __fdiv_rn(1.0f, scale) : 0.0f;
  if (kHostRule && isinf(inv)) {  // no finite reciprocal: a zero row
    scale = 1.0f;
    inv = 1.0f;
  }
  if (lane == 0) scales[r] = scale;

#pragma unroll
  for (int j = 0; j < kVecPerLane; ++j) {
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      packed |= (kHostRule ? host_rule_code(v[j][k], inv)
                           : f32_to_e4m3fn(__fdiv_rn(v[j][k], scale)))
                << (8 * k);
    const int64_t e = base + (static_cast<int64_t>(j) * 32 + lane) * 4;
    *reinterpret_cast<uint32_t*>(q + e) = packed;
  }
}

__global__ void dequantize_fp8_rowwise_kernel(const uint8_t* __restrict__ q,
                                              const float* __restrict__ scales,
                                              int64_t n, bool aligned,
                                              float* __restrict__ out) {
  const int64_t groups = (n + 3) / 4;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = g * 4;
    const float s = scales[e / kRow];  // 4 | kRow: the group is in one row
    if (aligned && e + 4 <= n) {
      const uint32_t packed = *reinterpret_cast<const uint32_t*>(q + e);
      float4 f;
      f.x = __fmul_rn(e4m3fn_to_f32(packed & 0xffu), s);
      f.y = __fmul_rn(e4m3fn_to_f32((packed >> 8) & 0xffu), s);
      f.z = __fmul_rn(e4m3fn_to_f32((packed >> 16) & 0xffu), s);
      f.w = __fmul_rn(e4m3fn_to_f32(packed >> 24), s);
      *reinterpret_cast<float4*>(out + e) = f;
    } else {
      for (int k = 0; k < 4 && e + k < n; ++k)
        out[e + k] = __fmul_rn(e4m3fn_to_f32(q[e + k]), s);
    }
  }
}

template <bool kHostRule>
int launch_quantize(const float* x, int64_t n, int64_t rows, int aligned,
                    uint8_t* q, float* scales, cudaStream_t stream) {
  if (rows > 0) {
    const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    quantize_fp8_rowwise_kernel<kHostRule>
        <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
            x, n, rows, aligned != 0, q, scales);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tft_fp8_row() { return kRow; }

// x: n f32 values; q: rows*512 codes; scales: rows f32. rows*512 >= n; the
// rows past the data quantize zeros (scale 1, codes 0).
int tft_quantize_fp8_rowwise(const float* x, int64_t n, int64_t rows,
                             int aligned, uint8_t* q, float* scales,
                             cudaStream_t stream) {
  return launch_quantize<false>(x, n, rows, aligned, q, scales, stream);
}

// The same with the host codec's rule.
int tft_quantize_fp8_rowwise_host(const float* x, int64_t n, int64_t rows,
                                  int aligned, uint8_t* q, float* scales,
                                  cudaStream_t stream) {
  return launch_quantize<true>(x, n, rows, aligned, q, scales, stream);
}

// q: codes of ceil(n/512) rows or more; out: the first n values.
int tft_dequantize_fp8_rowwise(const uint8_t* q, const float* scales,
                               int64_t n, int aligned, float* out,
                               cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t groups = (n + 3) / 4;
    int64_t blocks = (groups + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride past 64 per SM
    dequantize_fp8_rowwise_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                    stream>>>(q, scales, n, aligned != 0, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
