// Causal GQA attention forward on the CUDA cores (sm_90a) for f32 tensors.
//
// Replaces the same Pallas kernels' forward as attention.cu (K1
// splash_attention_tpu, K2 flash_attention_tpu in
// torchft_tpu/ops/attention.py) where attention.cu has no kernel: the
// reference's dispatch has no dtype clause and runs its kernels on an f32
// model. (bf16 and f16 are attention.cu's tensor-core kernels, and the f32
// dq and dK/dV attention_tf32x3.cu's; the kernel below keeps the element
// type T as a template argument, and only T = float is built.) Same contract
// as attention.cu:
//   * q/o [B, S, Hq, D], k/v [B, S, Hkv, D] in T, read through their
//     batch/sequence/head strides (the head-dim stride is 1); lse [B, Hq, S]
//     f32; GQA K/V heads read in place;
//   * K1 (p_f32): q arrives pre-scaled, sm_scale = 1, P stays f32 for P.V;
//     K2: the scores are scaled by sm_scale in f32 and P is rounded to T for
//     P.V;
//   * masked scores take the reference's -0.7 * FLT_MAX.
// Every product is summed in f32, so the rounding points are those of the
// plain version in ops/attention.py; for f32 the roundings to T are no-ops.
//
// What bounds it: f32 multiply-adds on the CUDA cores (a TF32 product keeps
// ~11 significant bits; attention_tf32x3.cu's split operands are the way
// onto the tensor cores). The design is a plain tiled SIMT one:
//   * 256 threads as a 16 x 16 grid; tiles staged in shared memory as f32
//     (rows padded by one float so column walks hit distinct banks); each
//     thread owns rows ty + 16i and columns tx + 16j of every product, so a
//     row's 16 owners sit in one half-warp and reduce by shuffles;
//   * one block per (64-row query tile, q head, batch), an online softmax
//     over 64-key tiles (32 at D 256); P goes through shared memory to the
//     P.V product;
//   * exp and log are expf / logf (no fast-math), as the f32 bar needs.
//
// Plain C interface, bound with ctypes: the entry point launches on the
// caller's stream and returns cudaError_t, or kErrHeadDim / kErrDtype.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kSide = 16;                // threads per side of the grid
constexpr int kThreads = kSide * kSide;  // 256
constexpr int kErrHeadDim = -1;          // a head dim it was not built for
constexpr int kErrDtype = -4;            // a dtype code it does not know

struct Strides {
  int64_t b, s, h;  // elements; the head-dim stride is 1
};

__device__ __forceinline__ int64_t offset(const Strides& st, int b, int s,
                                          int h) {
  return b * st.b + s * st.s + h * st.h;
}

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// x rounded to T and back: a product operand as the plain versions round it
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Tile sizes: 64 query rows; 64 keys at D 64/128, 32 at D 256 (what fits).
template <int D>
struct Tiles {
  static constexpr int kQ = 64;
  static constexpr int kK = D <= 128 ? 64 : 32;
  static constexpr int kLD = D + 1;  // padded row of a Q/K/V/dO tile
};

// `rows` rows of head h of a [B, S, H, D] tensor from row s0, as f32 into
// shared rows of D + 1 floats; neighbouring threads read neighbouring
// elements of a row.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const Strides& st, int b, int s0,
                                          int h, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = to_f32(src[offset(st, b, s0 + r, h) + d]);
  }
}

// c[i][j] += sum_d A[ty + 16i][d] B[tx + 16j][d] over d < D: both operands'
// rows hold the contraction dimension (rows of D + 1 floats).
template <int D, int M, int N>
__device__ __forceinline__ void dot_rows(float (&c)[M][N], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[M], bb[N];
#pragma unroll
    for (int i = 0; i < M; ++i) a[i] = A[(ty + kSide * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < N; ++j) bb[j] = B[(tx + kSide * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) c[i][j] = fmaf(a[i], bb[j], c[i][j]);
  }
}

// acc[i][n] += sum_c P[ty + 16i][c] X[c][tx + 16n] over c < K: P in shared
// rows of `ldp` floats, X in rows of D + 1.
template <int D, int K, int M>
__device__ __forceinline__ void dot_cols(float (&acc)[M][D / kSide],
                                         const float* P, int ldp,
                                         const float* X, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < K; ++c) {
    float a[M], x[D / kSide];
#pragma unroll
    for (int i = 0; i < M; ++i) a[i] = P[(ty + kSide * i) * ldp + c];
#pragma unroll
    for (int n = 0; n < D / kSide; ++n) x[n] = X[c * (D + 1) + tx + kSide * n];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int n = 0; n < D / kSide; ++n) acc[i][n] = fmaf(a[i], x[n], acc[i][n]);
  }
}

// Longest rows first across the grid: the last query tiles of every (head,
// batch) before the next-to-last ones. Sets qt, h, b.
__device__ __forceinline__ void query_block(int S, int rows, int Hq, int& qt,
                                            int& h, int& b) {
  const int n_qt = S / rows, heads = gridDim.x / n_qt;
  qt = n_qt - 1 - blockIdx.x / heads;
  h = blockIdx.x % heads % Hq;
  b = blockIdx.x % heads / Hq;
}

template <int D>
constexpr int fwd_smem() {
  using Ti = Tiles<D>;
  return 4 * (Ti::kQ * Ti::kLD + 2 * Ti::kK * Ti::kLD + Ti::kQ * (Ti::kK + 1));
}

// ---------------------------------------------------------------------------
// Forward: one block per (64-row query tile, q head, batch)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) simt_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
    Strides sv, Strides so, int S, int Hq, int group, float sm_scale,
    int p_f32) {
  using Ti = Tiles<D>;
  constexpr int BQ = Ti::kQ, BK = Ti::kK, PLD = BK + 1;
  constexpr int M = BQ / kSide, N = BK / kSide, DN = D / kSide;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * Ti::kLD;
  float* Vs = Ks + BK * Ti::kLD;
  float* Ps = Vs + BK * Ti::kLD;

  int qt, h, b;
  query_block(S, BQ, Hq, qt, h, b);
  const int kvh = h / group, q0 = qt * BQ;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;

  load_rows<D>(Qs, q, sq, b, q0, h, BQ);
  float acc[M][DN], m[M], l[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[i][n] = 0.f;
  }

  const int n_kt = (q0 + BQ - 1) / BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's K, V and P are read
    load_rows<D>(Ks, k, sk, b, k0, kvh, BK);
    load_rows<D>(Vs, v, sv, b, k0, kvh, BK);
    __syncthreads();

    float s[M][N];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) s[i][j] = 0.f;
    dot_rows<D>(s, Qs, Ks, ty, tx);

    // online softmax; a row's 16 owners are one half-warp
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int row = q0 + ty + kSide * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float x = s[i][j] * sm_scale;
        if (k0 + tx + kSide * j > row) x = kMaskValue;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < kSide; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < DN; ++n) acc[i][n] *= alpha;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float p = expf(s[i][j] - mx);
        l[i] += p;
        Ps[(ty + kSide * i) * PLD + tx + kSide * j] = p_f32 ? p : round_to<T>(p);
      }
    }
    __syncthreads();
    dot_cols<D, BK>(acc, Ps, PLD, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int row = q0 + ty + kSide * i;
#pragma unroll
    for (int w = 1; w < kSide; w <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const float inv = 1.0f / l[i];
    T* out = o + offset(so, b, row, h);
#pragma unroll
    for (int n = 0; n < DN; ++n) out[tx + kSide * n] = from_f32<T>(acc[i][n] * inv);
    if (tx == 0) lse[(static_cast<int64_t>(b) * Hq + h) * S + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------
Strides strides_at(const int64_t* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, int blocks, cudaStream_t stream,
           Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const int64_t* st, int B, int S, int Hq, int Hkv, float sm_scale,
        int p_f32, cudaStream_t stream) {
  return launch(simt_fwd_kernel<T, D>, fwd_smem<D>(), S / Tiles<D>::kQ * Hq * B,
                stream, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse,
                strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                strides_at(st, 3), S, Hq, Hq / Hkv, sm_scale, p_f32);
}

// fn<float, D>(args...) for dtype code 0 and D 64/128/256: bf16 and f16
// run attention.cu's tensor-core kernel, so any other code is refused here
#define TFT_DISPATCH_F32(fn, dtype, D, ...)                          \
  switch ((dtype) * 1000 + (D)) {                                    \
    case 64: return fn<float, 64>(__VA_ARGS__);                      \
    case 128: return fn<float, 128>(__VA_ARGS__);                    \
    case 256: return fn<float, 256>(__VA_ARGS__);                    \
  }                                                                  \
  return (dtype) == 0 ? kErrHeadDim : kErrDtype;

}  // namespace

extern "C" {

// Rows of the kernel's query tile: S must be a multiple of it.
int tft_simt_attention_tile() { return Tiles<64>::kQ; }

// dtype: 0 f32 (1, f16, is attention.cu's). strides: 3 per tensor (batch,
// sequence, head) for q, k, v, o
int tft_simt_attention_fwd(int dtype, const void* q, const void* k,
                           const void* v, void* o, float* lse,
                           const int64_t* strides, int B, int S, int Hq,
                           int Hkv, int D, float sm_scale, int p_f32,
                           cudaStream_t stream) {
  TFT_DISPATCH_F32(fwd, dtype, D, q, k, v, o, lse, strides, B, S, Hq, Hkv,
                   sm_scale, p_f32, stream)
}

}  // extern "C"
