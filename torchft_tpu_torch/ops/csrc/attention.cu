// Causal GQA attention, forward and backward, written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas attention kernels in
// torchft_tpu/ops/attention.py:
//   * K1, splash_attention_tpu (splash_attention_kernel.py: forward
//     flash_attention_kernel, backward _flash_attention_dq_kernel and
//     _flash_attention_dkv_kernel): q arrives pre-scaled by the caller,
//     sm_scale = 1, and P stays f32 for P.V (p_split below);
//   * K2, flash_attention_tpu (pallas/ops/tpu/flash_attention.py): the
//     scores are scaled by sm_scale in f32, P is rounded to bf16 for P.V,
//     and dS is scaled by sm_scale before its matmuls. K/V are read per
//     query-head group, never repeated.
//
// Layout: q/o/do [B, S, Hq, D], k/v [B, S, Hkv, D] in bf16, read through
// their batch/sequence/head strides (the head-dim stride is 1); lse and
// delta [B, Hq, S] f32.
//
// What bounds them on this card: tensor-core operations. At the bench_1b
// shape (S 2048, D 128) each block does ~S*D multiply-adds per byte it
// loads, far above the ~295 FLOP/B ridge, so the design keeps every matmul
// on the tensor cores and never writes the S x S scores to device memory:
//   * mma.sync m16n8k16 bf16 -> f32; each of a block's 4 warps owns 16 rows
//     of the block's 64-row tile. Operand fragments are read from shared
//     memory with 32-bit loads (rows padded by 8 elements, so the 8 row
//     groups of a warp hit 8 different bank quads) or, for a B operand held
//     k-major, as two 16-bit loads packed together. The scores' accumulator
//     fragment is reused in registers as the A operand of the next product.
//   * Causality is a loop bound: a block visits only the key tiles at or
//     below its diagonal (forward, dq) or the query tiles at or after it
//     (dkv); elements above the diagonal inside those tiles get the
//     reference's mask value -0.7 * FLT_MAX before the exp.
//   * Online softmax in f32 (running max and sum per row); the forward
//     writes O in bf16 and lse = max + log(sum) in f32. The backward
//     recomputes P = exp(s - lse) from it.
//   * dkv: one block per (batch, kv head, 64-key tile) loops over the
//     Hq/Hkv query heads of its group and over the query tiles, summing dK
//     and dV in f32 registers and rounding them once: no atomics, so the
//     result is the same from run to run.
//   * p_split (K1's forward): P = hi + lo, both bf16, and P.V is two
//     products, so P.V carries ~16 bits of P as the reference's f32 P does.
// Simple first: no cp.async/TMA pipeline and no wgmma yet; loads and math
// of one tile do not overlap except across the blocks resident on an SM.
//
// Plain C interface, bound with ctypes: each entry point launches on the
// caller's stream and returns cudaGetLastError() (or -1 for a head dim it
// was not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;  // rows a block owns: 16 per warp
constexpr int kPad = 8;             // bf16 elements of padding per smem row

struct Strides {
  int64_t b, s, h;  // elements; the head-dim stride is 1
};

__device__ __forceinline__ int64_t offset(const Strides& st, int b, int s,
                                          int h) {
  return b * st.b + s * st.s + h * st.h;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A * B + D, A 16x16 (row-major fragment), B 16x8 (column fragment)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loads from a row-major smem matrix M with leading dimension LD.
// g = lane / 4 (row group), t = lane % 4 (thread in group).

// A[m][k] = M[r0 + m][c0 + k]
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* M, int r0,
                                       int c0, int g, int t) {
  const bf16* p = M + (r0 + g) * LD + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B[k][n] = M[n0 + n][k0 + k]   (M holds B transposed, e.g. K for Q K^T)
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* M, int n0, int k0, int g,
                                          int t) {
  const bf16* p = M + (n0 + g) * LD + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B[k][n] = M[k0 + k][n0 + n]   (M holds B, e.g. V for P V)
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* M, int k0, int n0, int g,
                                          int t) {
  const bf16* p = M + (k0 + 2 * t) * LD + n0 + g;
  b0 = pack_raw(p[0], p[LD]);
  b1 = pack_raw(p[8 * LD], p[9 * LD]);
}

// The A fragment of columns [16c, 16c + 16) of a 16 x N accumulator held as
// N/8 mma result tiles, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows x D tile from global (row stride `stride` elements) into smem rows
// of D + kPad; 16-byte vectors (the wrapper checks alignment)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int rows) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (query tile, q head, batch)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, Strides sq, Strides sk,
                         Strides sv, Strides so, int S, int Hq, int group,
                         float sm_scale, bool p_split) {
  constexpr int LD = D + kPad;
  constexpr int BK = kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile * LD;
  bf16* Vs = Ks + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<D>(Qs, q + offset(sq, b, q0, h), sq.s, kTile);

  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = (q0 + kTile - 1) / BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous K/V tiles are consumed
    load_tile<D>(Ks, k + offset(sk, b, k0, kvh), sk.s, BK);
    load_tile<D>(Vs, v + offset(sv, b, k0, kvh), sv.s, BK);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<LD>(a, Qs, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t b0, b1;
        load_b_nk<LD>(b0, b1, Ks, j * 8, kk, g, t);
        mma(s[j], a, b0, b1);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * sm_scale;
        if (col > row[e >> 1]) x = kMaskValue;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, s[2 * c], s[2 * c + 1]);
      uint32_t a_lo[4];
      if (p_split) {
        float r0[4], r1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          r0[e] = s[2 * c][e] - round_bf16(s[2 * c][e]);
          r1[e] = s[2 * c + 1][e] - round_bf16(s[2 * c + 1][e]);
        }
        acc_to_a(a_lo, r0, r1);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_kn<LD>(b0, b1, Vs, c * 16, n * 8, g, t);
        mma(acc[n], a, b0, b1);
        if (p_split) mma(acc[n], a_lo, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.0f / l[i];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(o + offset(so, b, row[i], h) + col) =
          pack_bf16(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lse[(static_cast<int64_t>(b) * Hq + h) * S + row[i]] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (query tile, q head, batch)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdq, int S, int Hq, int group, float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int BK = kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;
  bf16* Vs = Ks + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int64_t stat = (static_cast<int64_t>(b) * Hq + h) * S;
  const float row_lse[2] = {lse[stat + row[0]], lse[stat + row[1]]};
  const float row_delta[2] = {delta[stat + row[0]], delta[stat + row[1]]};

  load_tile<D>(Qs, q + offset(sq, b, q0, h), sq.s, kTile);
  load_tile<D>(dOs, dout + offset(sdo, b, q0, h), sdo.s, kTile);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = (q0 + kTile - 1) / BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(Ks, k + offset(sk, b, k0, kvh), sk.s, BK);
    load_tile<D>(Vs, v + offset(sv, b, k0, kvh), sv.s, BK);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, Qs, warp * 16, kk, g, t);
      load_a<LD>(ado, dOs, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t b0, b1;
        load_b_nk<LD>(b0, b1, Ks, j * 8, kk, g, t);
        mma(s[j], aq, b0, b1);
        load_b_nk<LD>(b0, b1, Vs, j * 8, kk, g, t);
        mma(dp[j], ado, b0, b1);
      }
    }
    // dS = (dP - delta) * P * sm_scale, with P = exp(s - lse)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * sm_scale;
        if (col > row[i]) x = kMaskValue;
        const float p = expf(x - row_lse[i]);
        dp[j][e] = (dp[j][e] - row_delta[i]) * p * sm_scale;
      }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_kn<LD>(b0, b1, Ks, c * 16, n * 8, g, t);
        mma(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(dq + offset(sdq, b, row[i], h) + col) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (key tile, kv head, batch), looping over the query
// heads of the group and the query tiles at or after the diagonal
// ---------------------------------------------------------------------------
constexpr int kDkvQ = 32;  // query rows per inner tile

template <int D>
__global__ void __launch_bounds__(kThreads) attention_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv, int S, int Hq,
    int group, float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int BQ = kDkvQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* dOs = Qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LD);
  float* delta_s = lse_s + BQ;

  const int kt = gridDim.x - 1 - blockIdx.x;  // keys near 0 see most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile<D>(Ks, k + offset(sk, b, k0, kvh), sk.s, kTile);
  load_tile<D>(Vs, v + offset(sv, b, k0, kvh), sv.s, kTile);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = S / BQ;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const int64_t stat = (static_cast<int64_t>(b) * Hq + h) * S;
    for (int qt = k0 / BQ; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous Q/dO tiles are consumed
      load_tile<D>(Qs, q + offset(sq, b, q0, h), sq.s, BQ);
      load_tile<D>(dOs, dout + offset(sdo, b, q0, h), sdo.s, BQ);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = lse[stat + q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta[stat + q0 + threadIdx.x];
      }
      __syncthreads();

      // s^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4], av[4];
        load_a<LD>(ak, Ks, warp * 16, kk, g, t);
        load_a<LD>(av, Vs, warp * 16, kk, g, t);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t b0, b1;
          load_b_nk<LD>(b0, b1, Qs, j * 8, kk, g, t);
          mma(s[j], ak, b0, b1);
          load_b_nk<LD>(b0, b1, dOs, j * 8, kk, g, t);
          mma(dp[j], av, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cq = j * 8 + 2 * t + (e & 1);
          float x = s[j][e] * sm_scale;
          if (key[e >> 1] > q0 + cq) x = kMaskValue;
          const float p = expf(x - lse_s[cq]);
          s[j][e] = p;
          dp[j][e] = (dp[j][e] - delta_s[cq]) * p * sm_scale;
        }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, s[2 * c], s[2 * c + 1]);
        acc_to_a(ads, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          load_b_kn<LD>(b0, b1, dOs, c * 16, n * 8, g, t);
          mma(dv_acc[n], ap, b0, b1);
          load_b_kn<LD>(b0, b1, Qs, c * 16, n * 8, g, t);
          mma(dk_acc[n], ads, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint32_t*>(dk + offset(sdk, b, key[i], kvh) + col) =
          pack_bf16(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + offset(sdv, b, key[i], kvh) + col) =
          pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D>
constexpr int fwd_smem() {
  return 3 * kTile * (D + kPad) * 2;
}
template <int D>
constexpr int dq_smem() {
  return 4 * kTile * (D + kPad) * 2;
}
template <int D>
constexpr int dkv_smem() {
  return (2 * kTile + 2 * kDkvQ) * (D + kPad) * 2 + 2 * kDkvQ * 4;
}

Strides strides_at(const int64_t* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Raise the kernel's dynamic shared-memory limit (once per kernel) and
// launch it; a refused attribute is returned like a refused launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const int64_t* st, int B, int S, int Hq, int Hkv, float sm_scale,
        int p_split, cudaStream_t stream) {
  return launch(attention_fwd_kernel<D>, fwd_smem<D>(),
                dim3(S / kTile, Hq, B), stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<bf16*>(o), lse, strides_at(st, 0),
                strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), S, Hq,
                Hq / Hkv, sm_scale, p_split != 0);
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dqp, const int64_t* st,
       int B, int S, int Hq, int Hkv, float sm_scale, cudaStream_t stream) {
  return launch(attention_dq_kernel<D>, dq_smem<D>(), dim3(S / kTile, Hq, B),
                stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const bf16*>(dout), lse, delta,
                static_cast<bf16*>(dqp), strides_at(st, 0), strides_at(st, 1),
                strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), S, Hq,
                Hq / Hkv, sm_scale);
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dkp, void* dvp,
        const int64_t* st, int B, int S, int Hq, int Hkv, float sm_scale,
        cudaStream_t stream) {
  return launch(attention_dkv_kernel<D>, dkv_smem<D>(),
                dim3(S / kTile, Hkv, B), stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const bf16*>(dout), lse, delta,
                static_cast<bf16*>(dkp), static_cast<bf16*>(dvp),
                strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), S, Hq,
                Hq / Hkv, sm_scale);
}

}  // namespace

extern "C" {

// Rows per block tile: S must be a multiple of it.
int tft_attention_tile() { return kTile; }

// strides: 3 per tensor (batch, sequence, head) for q, k, v, o
int tft_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      float* lse, const int64_t* strides, int B, int S, int Hq,
                      int Hkv, int D, float sm_scale, int p_split,
                      cudaStream_t stream) {
  switch (D) {
    case 64:
      return fwd<64>(q, k, v, o, lse, strides, B, S, Hq, Hkv, sm_scale,
                     p_split, stream);
    case 128:
      return fwd<128>(q, k, v, o, lse, strides, B, S, Hq, Hkv, sm_scale,
                      p_split, stream);
    case 256:
      return fwd<256>(q, k, v, o, lse, strides, B, S, Hq, Hkv, sm_scale,
                      p_split, stream);
  }
  return -1;
}

// strides for q, k, v, do, dq
int tft_attention_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dqp, const int64_t* strides, int B, int S, int Hq,
                     int Hkv, int D, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return dq<64>(q, k, v, dout, lse, delta, dqp, strides, B, S, Hq, Hkv,
                    sm_scale, stream);
    case 128:
      return dq<128>(q, k, v, dout, lse, delta, dqp, strides, B, S, Hq, Hkv,
                     sm_scale, stream);
    case 256:
      return dq<256>(q, k, v, dout, lse, delta, dqp, strides, B, S, Hq, Hkv,
                     sm_scale, stream);
  }
  return -1;
}

// strides for q, k, v, do, dk, dv
int tft_attention_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dkp, void* dvp, const int64_t* strides, int B,
                      int S, int Hq, int Hkv, int D, float sm_scale,
                      cudaStream_t stream) {
  switch (D) {
    case 64:
      return dkv<64>(q, k, v, dout, lse, delta, dkp, dvp, strides, B, S, Hq,
                     Hkv, sm_scale, stream);
    case 128:
      return dkv<128>(q, k, v, dout, lse, delta, dkp, dvp, strides, B, S, Hq,
                      Hkv, sm_scale, stream);
    case 256:
      return dkv<256>(q, k, v, dout, lse, delta, dkp, dvp, strides, B, S, Hq,
                      Hkv, sm_scale, stream);
  }
  return -1;
}

}  // extern "C"
