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
// loads, far above the ~295 FLOP/B ridge, so every matmul runs on the
// tensor cores and the S x S scores never reach device memory.
//
// Forward and dK/dV (the Hopper pieces of hopper.cuh):
//   * A 384-thread block: warpgroup 0 is the producer (one thread issues
//     every TMA load; setmaxnreg gives its registers to the others), and
//     warpgroups 1 and 2 are consumers that run wgmma.
//   * Tiles arrive by TMA, 128-byte swizzled, through a ring of full/empty
//     mbarriers (forward 3 stages, 2 at D 256; dK/dV 4, 3 at D 256: what
//     fits in 227 KB), so later tiles' loads overlap this tile's products.
//   * Forward: a block owns 128 query rows, 64 per consumer warpgroup,
//     loads its Q tile once and streams K/V tiles (128 keys at D 64/128,
//     64 at D 256). S = Q K^T is an SS wgmma, O += P V an RS wgmma: P stays
//     in the registers it was computed in, rounded to bf16 fragments, and V
//     is read MN-major from its swizzled tile. Online softmax in f32 on the
//     accumulator's layout (row max and sum by quad shuffles); lse = max +
//     log(sum). p_split (K1): P = hi + lo, both bf16, two RS products into
//     one f32 accumulator, so P.V carries ~16 bits of P as the reference's
//     f32 P does.
//   * dK/dV: a block owns one KV head's 64-key tile, loads its K/V once and
//     streams Q/dO tiles with their lse and delta rows (64 queries at D
//     64/128, 32 at D 256) for every query head of the group. Both
//     consumer warpgroups own all 64 keys, so each thread holds a single
//     64 x D accumulator (two would not fit in the registers at D 128 and
//     above). Both compute S^T = K Q^T (SS) and P^T; one sums dV += P^T dO
//     (RS), the other also computes dP^T = V dO^T (SS) and dS^T = P^T
//     (dP^T - delta) sm_scale and sums dK += dS^T Q (RS). S^T is computed
//     twice (5 products where 4 would do) so that neither warpgroup waits
//     for the other: a hand-over of P^T through shared memory measured
//     slower. Sums stay in f32 registers and are rounded once: no atomics,
//     so the result is the same from run to run.
//   * exp runs on the MUFU unit alone (ex2.approx, the log2(e) factor
//     folded into the argument).
//   * Causality is a loop bound: a forward block visits only the key tiles
//     at or below its diagonal, a dK/dV block only the query tiles at or
//     after it; a forward warpgroup whose 64 rows lie wholly above a key
//     tile skips its products, and elements above the diagonal get the
//     reference's mask value -0.7 * FLT_MAX before the exp. Every forward
//     block starts at key tile 0, which holds key 0 for every row, so no
//     row's running max stays at the mask value. Blocks are numbered so
//     the longest (the last query tiles, the first key tiles) start first.
//
// dq keeps its first design: 4 warps of mma.sync m16n8k16, each owning 16
// rows of a 64-row tile, fragments from padded shared memory, tiles loaded
// synchronously.
//
// Plain C interface, bound with ctypes: each entry point builds its tile
// maps, launches on the caller's stream and returns cudaError_t, or one of
// hopper::kErr* for a head dim it was not built for or a refused tile map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))

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

// 2^x on the MUFU unit alone: ~2^-22 relative error and subnormal results
// flushed to 0, far below the bf16 rounding P goes through; -inf gives 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The RS A fragment of columns [16c, 16c + 16) of an f32 accumulator
// (layout in hopper.cuh), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_frag(uint32_t (&a)[4],
                                            const float (&d)[N], int c) {
  a[0] = pack_bf16(d[8 * c + 0], d[8 * c + 1]);
  a[1] = pack_bf16(d[8 * c + 2], d[8 * c + 3]);
  a[2] = pack_bf16(d[8 * c + 4], d[8 * c + 5]);
  a[3] = pack_bf16(d[8 * c + 6], d[8 * c + 7]);
}

// The same columns' residual after rounding to bf16, itself rounded: the lo
// half of p_split.
template <int N>
__device__ __forceinline__ void acc_to_frag_lo(uint32_t (&a)[4],
                                               const float (&d)[N], int c) {
  float r[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) r[e] = d[8 * c + e] - round_bf16(d[8 * c + e]);
  a[0] = pack_bf16(r[0], r[1]);
  a[1] = pack_bf16(r[2], r[3]);
  a[2] = pack_bf16(r[4], r[5]);
  a[3] = pack_bf16(r[6], r[7]);
}

// ---------------------------------------------------------------------------
// The Hopper kernels' shared shape
// ---------------------------------------------------------------------------
constexpr int kRows = 128;            // query rows of a forward block
constexpr int kWgRows = 64;           // rows of one consumer warpgroup
constexpr int kHopperThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;     // arrivals that free a ring stage
constexpr int kSubRow = 128;          // bytes per sub-tile row (64 bf16)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Byte offset of K step `kk` (16 columns) in a swizzled tile of `rows` rows:
// sub-tile kk / 4, 32 bytes a step inside it.
__device__ __forceinline__ uint32_t k_step(int kk, int rows) {
  return (kk / 4) * rows * kSubRow + (kk % 4) * 32;
}

// ---------------------------------------------------------------------------
// Forward: one block per (128-row query tile, q head, batch)
// ---------------------------------------------------------------------------
template <int D>
struct FwdShape {
  static constexpr int kKeys = D <= 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kKeys * D * 2;     // one of K or V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kStages = D <= 128 ? 3 : 2;  // ring depth that fits
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
};

template <int D, bool kSplit>
__global__ void __launch_bounds__(kHopperThreads, 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         Strides so, int S, int Hq, int group, float sm_scale) {
  using Shape = FwdShape<D>;
  constexpr int BK = Shape::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Shape::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + Shape::kStages;

  // longest rows first across the whole grid: the last query tiles of
  // every (head, batch) before the next-to-last ones
  const int n_qt = S / kRows, heads = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / heads;
  const int h = blockIdx.x % heads % Hq, b = blockIdx.x % heads / Hq;
  const int kvh = h / group;
  const int q0 = qt * kRows;
  const int n_kt = (q0 + kRows - 1) / BK + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < Shape::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, Shape::kQBytes);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(Qs + c * kRows * kSubRow, &tq, q_full, c * 64, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % Shape::kStages;
        mbar_wait(&empty[s], ((kt / Shape::kStages) & 1) ^ 1);
        unsigned char* Ks = smem + Shape::kQBytes + s * Shape::kStageBytes;
        unsigned char* Vs = Ks + Shape::kKVBytes;
        mbar_arrive_expect_tx(&full[s], Shape::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(Ks + c * BK * kSubRow, &tk, &full[s], c * 64, kvh,
                      kt * BK, b);
          tma_load_4d(Vs + c * BK * kSubRow, &tv, &full[s], c * 64, kvh,
                      kt * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows q0 + 64w .. q0 + 64w + 63
  reg_alloc<kConsumerRegs>();
  const int w = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int first = q0 + kWgRows * w;
  const int row[2] = {first + warp * 16 + g, first + warp * 16 + g + 8};
  const uint32_t q_base = smem_u32(Qs) + kWgRows * w * kSubRow;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % Shape::kStages;
    const int k0 = kt * BK;
    mbar_wait(&full[s], (kt / Shape::kStages) & 1);
    if (k0 <= first + kWgRows - 1) {  // else every key is above our rows
      const uint32_t k_base =
          smem_u32(smem + Shape::kQBytes + s * Shape::kStageBytes);
      const uint32_t v_base = k_base + Shape::kKVBytes;

      // S = Q K^T
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, desc_k_major(q_base + k_step(kk, kRows)),
                     desc_k_major(k_base + k_step(kk, BK)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);

      // online softmax on the accumulator's rows
      const bool diagonal = k0 + BK - 1 > first;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x = sc[i] * sm_scale;
        if (diagonal && k0 + (i >> 2) * 8 + 2 * t + (i & 1) > row[r])
          x = kMaskValue;
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      const float m2[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2_approx(fmaf(sc[i], kLog2e, -m2[r]));
        sc[i] = p;
        l[r] += p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V, P from registers (hi, and lo with p_split)
      uint32_t p_hi[BK / 16][4], p_lo[kSplit ? BK / 16 : 1][4];
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        acc_to_frag(p_hi[c], sc, c);
        if constexpr (kSplit) acc_to_frag_lo(p_lo[c], sc, c);
      }
      wgmma_fence();
      fence_operand(acc);
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        const uint64_t dv = desc_mn_major(v_base + c * 16 * kSubRow, BK * kSubRow);
        wgmma_rs<D>(acc, p_hi[c], dv);
        if constexpr (kSplit) wgmma_rs<D>(acc, p_lo[c], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(o + offset(so, b, row[r], h) + col) =
          pack_bf16(acc[4 * n + 2 * r] * inv[r], acc[4 * n + 2 * r + 1] * inv[r]);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[(static_cast<int64_t>(b) * Hq + h) * S + row[r]] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (64-key tile, kv head, batch), looping over the
// query heads of the group and the query tiles at or after the diagonal.
// Both consumer warpgroups own the block's 64 keys and compute S^T = K Q^T
// and P^T = exp(S^T - lse); the dV warpgroup sums dV += P^T dO, the dK
// warpgroup also computes dP^T = V dO^T and dS^T = P^T (dP^T - delta)
// sm_scale and sums dK += dS^T Q. Each thread so holds one f32 accumulator
// of 64 x D, and the two warpgroups never wait for each other.
// ---------------------------------------------------------------------------
constexpr int kDkvKeys = 64;

template <int D>
struct DkvShape {
  static constexpr int kQueries = D <= 128 ? 64 : 32;  // per Q/dO tile
  static constexpr int kKBytes = kDkvKeys * D * 2;      // one of K or V
  static constexpr int kQBytes = kQueries * D * 2;      // one of Q or dO
  static constexpr int kStatBytes = kQueries * 4;       // one of lse, delta
  static constexpr int kLoadBytes = 2 * kQBytes + 2 * kStatBytes;
  static constexpr int kStageBytes = (kLoadBytes + 1023) / 1024 * 1024;
  static constexpr int kStages = D <= 128 ? 4 : 3;      // ring depth that fits
  static constexpr int kBarOffset = 2 * kKBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    attention_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Strides sdk, Strides sdv, int S,
                         int Hq, int group, float sm_scale) {
  using Shape = DkvShape<D>;
  constexpr int BQ = Shape::kQueries;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + Shape::kKBytes;
  unsigned char* stages = smem + 2 * Shape::kKBytes;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Shape::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + Shape::kStages;

  // keys near 0 see most queries: their tiles first across the whole grid
  const int hkv = Hq / group, heads = gridDim.x / (S / kDkvKeys);
  const int kt = blockIdx.x / heads;
  const int kvh = blockIdx.x % heads % hkv, b = blockIdx.x % heads / hkv;
  const int k0 = kt * kDkvKeys;
  const int per_head = (S - k0) / BQ, n_tiles = group * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < Shape::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: K and V once, then Q, dO, lse, delta per (head, tile)
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * Shape::kKBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(Ks + c * kDkvKeys * kSubRow, &tk, kv_full, c * 64, kvh, k0, b);
        tma_load_4d(Vs + c * kDkvKeys * kSubRow, &tv, kv_full, c * 64, kvh, k0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int h = kvh * group + it / per_head;
        const int q0 = k0 + it % per_head * BQ;
        const int64_t stat = (static_cast<int64_t>(b) * Hq + h) * S + q0;
        const int s = it % Shape::kStages;
        mbar_wait(&empty[s], ((it / Shape::kStages) & 1) ^ 1);
        unsigned char* stage = stages + s * Shape::kStageBytes;
        mbar_arrive_expect_tx(&full[s], Shape::kLoadBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(stage + c * BQ * kSubRow, &tq, &full[s], c * 64, h, q0, b);
          tma_load_4d(stage + Shape::kQBytes + c * BQ * kSubRow, &tdo, &full[s],
                      c * 64, h, q0, b);
        }
        bulk_load(stage + 2 * Shape::kQBytes, lse + stat, Shape::kStatBytes,
                  &full[s]);
        bulk_load(stage + 2 * Shape::kQBytes + Shape::kStatBytes, delta + stat,
                  Shape::kStatBytes, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup 1 sums dV, warpgroup 2 dK, over the same 64 keys
  reg_alloc<kConsumerRegs>();
  const bool dv_group = wg == 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int key = k0 + warp * 16 + (lane >> 2);  // and key + 8

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = k0 + it % per_head * BQ;
    const int s = it % Shape::kStages;
    mbar_wait(&full[s], (it / Shape::kStages) & 1);
    unsigned char* stage = stages + s * Shape::kStageBytes;
    const uint32_t q_base = smem_u32(stage);
    const uint32_t do_base = q_base + Shape::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(stage + 2 * Shape::kQBytes);
    const float* delta_s = lse_s + BQ;

    // S^T = K Q^T, and dP^T = V dO^T in the dK group
    uint32_t k_tile = smem_u32(Ks), v_tile = smem_u32(Vs);
    asm volatile("" : "+r"(k_tile), "+r"(v_tile));  // descriptors per tile
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(st, desc_k_major(k_tile + k_step(kk, kDkvKeys)),
                   desc_k_major(q_base + k_step(kk, BQ)), kk > 0);
    if (!dv_group) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dpt, desc_k_major(v_tile + k_step(kk, kDkvKeys)),
                     desc_k_major(do_base + k_step(kk, BQ)), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(st);
    fence_operand(dpt);

    // P^T = exp(S^T sm_scale - lse), the mask value above the diagonal;
    // dS^T = P^T (dP^T - delta) sm_scale in the dK group
    const bool diagonal = k0 + kDkvKeys - 1 > q0;
    auto prob = [&](int i, int q, float l) {  // element i, query q0 + q
      float x = st[i] * sm_scale;
      if (diagonal && key + 8 * ((i >> 1) & 1) > q0 + q) x = kMaskValue;
      return exp2_approx(fmaf(x, kLog2e, -l * kLog2e));
    };
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int cq = j * 8 + 2 * t;  // this thread's query columns cq, cq + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + cq);
      if (dv_group) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] = prob(4 * j + e, cq + (e & 1), e & 1 ? l2.y : l2.x);
      } else {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          st[i] = (dpt[i] - (e & 1 ? d2.y : d2.x)) *
                  prob(i, cq + (e & 1), e & 1 ? l2.y : l2.x) * sm_scale;
        }
      }
    }

    // dV += P^T dO or dK += dS^T Q, the A operand rounded to bf16
    uint32_t frag[BQ / 16][4];
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) acc_to_frag(frag[c], st, c);
    const uint32_t bt_tile = dv_group ? do_base : q_base;
    wgmma_fence();
    fence_operand(acc);
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c)
      wgmma_rs<D>(acc, frag[c],
                  desc_mn_major(bt_tile + c * 16 * kSubRow, BQ * kSubRow));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  bf16* out = dv_group ? dv : dk;
  const Strides so = dv_group ? sdv : sdk;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(out + offset(so, b, key + 8 * r, kvh) + col) =
          pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// The dq kernel's mma.sync pieces
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;  // rows a block owns: 16 per warp
constexpr int kPad = 8;             // bf16 elements of padding per smem row

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
// dq: one block per (64-row query tile, q head, batch), mma.sync
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

template <int D>
constexpr int dq_smem() {
  return 4 * kTile * (D + kPad) * 2;
}

Strides strides_at(const int64_t* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Raise the kernel's dynamic shared-memory limit and launch it; a refused
// attribute is returned like a refused launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int smem, dim3 grid,
           cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The tile map of tensor `i` of the strides array, `rows` rows a box.
int map_at(CUtensorMap* map, const void* p, const int64_t* st, int i, int B,
           int S, int H, int D, int rows) {
  const Strides s = strides_at(st, i);
  return tile_map(map, p, B, S, H, D, s.b, s.s, s.h, rows);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const int64_t* st, int B, int S, int Hq, int Hkv, float sm_scale,
        int p_split, cudaStream_t stream) {
  using Shape = FwdShape<D>;
  CUtensorMap tq, tk, tv;
  int err = map_at(&tq, q, st, 0, B, S, Hq, D, kRows);
  if (err == 0) err = map_at(&tk, k, st, 1, B, S, Hkv, D, Shape::kKeys);
  if (err == 0) err = map_at(&tv, v, st, 2, B, S, Hkv, D, Shape::kKeys);
  if (err != 0) return err;
  const dim3 grid(S / kRows * Hq * B);
  auto kernel = p_split ? attention_fwd_kernel<D, true>
                        : attention_fwd_kernel<D, false>;
  return launch(kernel, kHopperThreads, Shape::kSmem, grid, stream, tq, tk, tv,
                static_cast<bf16*>(o), lse, strides_at(st, 3), S, Hq,
                Hq / Hkv, sm_scale);
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dqp, const int64_t* st,
       int B, int S, int Hq, int Hkv, float sm_scale, cudaStream_t stream) {
  return launch(attention_dq_kernel<D>, kThreads, dq_smem<D>(),
                dim3(S / kTile, Hq, B), stream, static_cast<const bf16*>(q),
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
  using Shape = DkvShape<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = map_at(&tq, q, st, 0, B, S, Hq, D, Shape::kQueries);
  if (err == 0) err = map_at(&tk, k, st, 1, B, S, Hkv, D, kDkvKeys);
  if (err == 0) err = map_at(&tv, v, st, 2, B, S, Hkv, D, kDkvKeys);
  if (err == 0) err = map_at(&tdo, dout, st, 3, B, S, Hq, D, Shape::kQueries);
  if (err != 0) return err;
  return launch(attention_dkv_kernel<D>, kHopperThreads, Shape::kSmem,
                dim3(S / kDkvKeys * Hkv * B), stream, tq, tk, tv, tdo, lse, delta,
                static_cast<bf16*>(dkp), static_cast<bf16*>(dvp),
                strides_at(st, 4), strides_at(st, 5), S, Hq, Hq / Hkv,
                sm_scale);
}

}  // namespace

extern "C" {

// Rows per block tile of the forward kernel: S must be a multiple of it
// (the dK/dV and dq kernels' 64-row tiles divide it).
int tft_attention_tile() { return kRows; }

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
  return kErrHeadDim;
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
  return kErrHeadDim;
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
  return kErrHeadDim;
}

}  // extern "C"
