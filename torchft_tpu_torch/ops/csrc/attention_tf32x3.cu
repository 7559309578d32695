// Causal GQA attention, forward and backward (dq and dK/dV), for f32
// tensors on Hopper's tensor cores (sm_90a), by split operands: 3xTF32 on
// wgmma, fed by TMA.
//
// Replaces, for f32, the JAX package's Pallas attention kernels in
// torchft_tpu/ops/attention.py: K1 splash_attention_tpu (the forward of
// splash_attention_kernel.py, dq _flash_attention_dq_kernel, dK/dV
// _flash_attention_dkv_kernel; q pre-scaled, sm_scale = 1) and K2
// flash_attention_tpu (sm_scale applied to the f32 scores and to dS; P
// rounded to the input dtype for P.V, a no-op in f32). The reference's
// dispatch has no dtype clause, so an f32 model runs them. The contract is
// attention.cu's: q/o/do/dq [B, S, Hq, D] and k/v/dk/dv [B, S, Hkv, D] read
// through their batch/sequence/head strides (head-dim stride 1), GQA K/V
// heads read in place, lse and delta [B, Hq, S] f32; the forward's online
// softmax by expf, lse = m + logf(l); P = exp(s sm_scale - lse) by expf,
// dS = (dP - delta) P sm_scale, masked scores -0.7 * FLT_MAX; dK/dV summed
// over the group's query heads in f32 registers and stored once, no
// atomics.
//
// What bounds them: tensor-core operations. A TF32 product keeps ~11
// significant bits, far from f32, so every f32 operand x is split into x =
// hi + lo, both TF32, and each product is hi*hi + hi*lo + lo*hi (the
// dropped lo*lo is ~2^-22 of it): three TF32 products per f32 one, at 495
// TFLOP/s dense, an effective 165 TFLOP/s (2.5x the 67 of the CUDA cores).
// f32 tiles are twice bf16's bytes, so shared memory, not registers, sets
// the tiles. What the design does:
//   * The split. The tensor core reads an f32 operand, from registers or
//     shared memory, as its top 19 bits (the low 13 mantissa bits ignored:
//     truncation), as measured on an H100 by tft_tf32x3_probe below. So a
//     raw f32 tile serves as its own hi, and only lo = rna(x - trunc(x)) is
//     written beside it. Operands computed in registers are split by
//     rounding: hi = rna(x), lo = rna(x - hi).
//   * A 384-thread block: warpgroup 0 is the producer (one thread issues
//     the TMA loads) and writes every streamed tile's lo tile once its load
//     lands (fence.proxy.async, then a "ready" mbarrier); warpgroups 1 and 2
//     consume. setmaxnreg 56 / 224 (exact for 168 registers a thread).
//   * S = Q K^T (forward, dq), dP = dO V^T (dq), S^T = K Q^T and dP^T =
//     V dO^T (dK/dV) are RS wgmmas (m64nNk8.tf32): A (Q, dO or K, V of the
//     block's own rows, raw in shared memory) is read by ld.shared and split
//     in registers per k8 step, B is the streamed tile (raw = hi) and its lo
//     tile, both K-major as .tf32 requires.
//   * O += P V, dQ += dS K, dV += P^T dO and dK += dS^T Q would read their B
//     tile along N, which .tf32 wgmma cannot (it takes no transpose). They
//     run transposed, O^T += V^T P^T (and dQ^T, dV^T, dK^T): A = the
//     streamed tile read across its rows by ld.shared (raw and lo: no split
//     needed), B = P (or dS, P^T, dS^T) split and written by the warpgroup
//     into two 8 KB K-major tiles of its own. (An mma.sync m16n8k8 version,
//     B fragments read by each warp, took twice the time of these
//     products.)
//   * wgmma's f32 sums keep only ~22-23 bits aligned to the largest addend,
//     truncated. So the hi*hi products of S and dP go into a fresh
//     accumulator per 16 columns of the contraction and the small products
//     (hi*lo, lo*hi, ~2^-10 of the total) into another, both added to the
//     running sum on the CUDA cores; dQ^T's products over a key tile,
//     O^T's over 16 keys and dK^T's, dV^T's over 16 queries go into a
//     fresh accumulator, smallest first. (A CPU model of exactly this
//     arithmetic, tests/test_torch_attention.py, holds o, dq, dk and dv
//     within the 4x bar against f64 at 22 bits; one accumulator per
//     product, or for the whole of a row of O, would not.) Each group of
//     products is waited for before the next is issued: double-buffered
//     groups spilled registers and ran slower.
//   * The forward: a block owns 128 query rows of one head, 64 per
//     consumer, and streams K/V tiles (32 keys, 8 at D 256) through a
//     2-stage ring that both consumers read, so each tile is loaded and
//     split once for 128 rows. (64-row blocks whose consumers took
//     alternate tiles, each from its own stage, and merged their sums at
//     the end took 1.27-1.29x as long at bench_1b on an H100.) Each
//     consumer keeps an online softmax (running max m, sum l) and O^T for
//     its rows. In O^T's layout a query row is a column of the
//     accumulator, held by other threads than its row of S, so the rescale
//     exp(m_old - m_new) of each row reaches them through a 64-float row in
//     shared memory.
//   * dq: a block owns 64 query rows of one head. Q and dO arrive once;
//     K/V tiles (32 keys, 8 at D 256: what the registers and shared memory
//     hold) alternate between the two consumers, each with its own stage
//     (K, V and their lo tiles: two stages are what fits) and its own
//     partial dQ, which meet through shared memory at the end.
//   * dK/dV: a block owns one KV head's 64 keys; both consumers own all 64
//     (the D x 64 f32 sum of one of dK^T, dV^T per thread) and stream
//     Q/dO tiles (32 queries, 8 at D 256) with their lse and delta rows
//     through a 2-stage ring. The dV consumer computes S^T and P^T, writes
//     P^T's hi/lo tiles for its own product and hands them to the dK
//     consumer (named barriers: written, and read), which computes dP^T
//     and dS^T from P^T = hi + lo (within 2^-22 of P^T): S^T is computed
//     once, where the first version computed it in both consumers and ran
//     1.25x longer.
//   * Causality is a loop bound (a dq block visits the key tiles up to its
//     last row, a dK/dV block the query tiles from its first key), and
//     longest blocks start first.
//
// Plain C interface, bound with ctypes: each entry point builds its tile
// maps, launches on the caller's stream and returns cudaError_t, or one of
// hopper::kErr* for a head dim or dtype code it was not built for or a
// refused tile map.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kSubRow = 128;      // bytes of a swizzle row (32 floats)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

struct Strides {
  int64_t b, s, h;  // elements; the head-dim stride is 1
};

__device__ __forceinline__ int64_t offset(const Strides& st, int b, int s,
                                          int h) {
  return b * st.b + s * st.s + h * st.h;
}

// x rounded to TF32, ties away from zero (cvt.rna.tf32.f32's rounding), as
// an f32 whose low 13 mantissa bits are 0
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// The part of an f32 operand the tensor core reads: its top 19 bits
__device__ __forceinline__ float tc_view(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// A register operand's split: hi = rna(x), lo = rna(x - hi) (x - hi exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = rna_tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(rna_tf32(x - h));
}

// The lo of a raw shared-memory operand, whose hi the tensor core reads
// itself: rna(x - trunc(x)) (x - trunc(x) exact)
__device__ __forceinline__ float lo_of(float x) { return rna_tf32(x - tc_view(x)); }

// Shared memory is read and written by ld/st.shared on 32-bit addresses:
// the 1024-byte alignment of the dynamic shared memory loses its state
// space to the compiler, whose generic loads take 64-bit addresses. In a
// 128-byte-swizzled f32 tile of R rows, element (r, c) lies in sub-tile
// c / 32, row r, 16-byte chunk (c / 4 % 8) ^ (r % 8), word c % 4. The chunk
// bits (4-6 of the byte offset) are an XOR, so a thread computes the offset
// of its first element once and reaches the others by XOR-ing a constant
// into bits 4-6 and adding constant sub-tile and 8-row offsets.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) { return __uint_as_float(lds(addr)); }

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// Byte offset of k8 step kk in a swizzled f32 tile of `rows` rows: sub-tile
// kk / 4, 32 bytes a step inside it
__device__ __forceinline__ uint32_t k_step(int kk, int rows) {
  return (kk / 4) * rows * kSubRow + (kk % 4) * 32;
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The lo tiles of the raw tiles in the `bytes` at shared address `raw`,
// written right after them by `threads` threads (this one is `i`), then
// made visible to wgmma.
__device__ __forceinline__ void write_lo(uint32_t raw, int bytes, int i, int threads) {
  for (int j = 16 * i; j < bytes; j += 16 * threads) {
    float x[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                 : "r"(raw + j)
                 : "memory");
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(raw + bytes + j),
                 "f"(lo_of(x[0])), "f"(lo_of(x[1])), "f"(lo_of(x[2])), "f"(lo_of(x[3]))
                 : "memory");
  }
  fence_proxy_async();
}

// out[64 x N] = A B^T in 3xTF32 for this warpgroup: A is rows [a_row, a_row
// + 64) of a swizzled f32 tile of `a_rows` rows in shared memory, read by
// ld.shared and split in registers per k8 step; B is an N-row K-major tile
// at b_raw (read raw: its hi) with its lo tile at b_lo. Per 16 columns of
// the contraction the small products (lo*hi, hi*lo) go into one fresh
// accumulator and the hi*hi ones into another; both are added to the
// running sum on the CUDA cores, hi*hi first. Each group is waited for
// before the next is issued: double-buffering the groups needed registers
// that spilled. The accumulators are defined by an empty asm before the
// first group, though each group's first product overwrites them (scale-d
// 0): left undefined (uninitialized), the card returned wrong sums.
template <int N, int D>
__device__ __forceinline__ void product_3x(float (&out)[N / 2], uint32_t a_tile,
                                           int a_rows, int a_row, uint32_t b_raw, uint32_t b_lo,
                                           int g, int t) {
  float small[N / 2], part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "=f"(small[i]), "=f"(part[i]));
  // element (a_row + g, t): row a_row + g has g in its chunk bits
  const uint32_t a_thread = (a_row + g) * kSubRow + (g << 4) + (t << 2);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    uint32_t hi[2][4], lo[2][4];  // [k8 step of the chunk][fragment]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // columns 8 kk + t (chunk 2 (kk % 4)) and + 4 (the next chunk) of
      // sub-tile kk / 4, rows a_row + g and + 8 (1024 bytes on)
      const int kk = 2 * c + s;
      const uint32_t sub = a_tile + (kk / 4) * a_rows * kSubRow;
      const uint32_t c0 = sub + (a_thread ^ ((2 * (kk % 4)) << 4));
      const uint32_t c1 = sub + (a_thread ^ ((2 * (kk % 4) + 1) << 4));
      split(lds_f32(c0), hi[s][0], lo[s][0]);
      split(lds_f32(c0 + 8 * kSubRow), hi[s][1], lo[s][1]);
      split(lds_f32(c1), hi[s][2], lo[s][2]);
      split(lds_f32(c1 + 8 * kSubRow), hi[s][3], lo[s][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint32_t step = k_step(2 * c + s, N);
      wgmma_rs_tf32<N>(small, lo[s], desc_k_major(b_raw + step), s);
      wgmma_rs_tf32<N>(small, hi[s], desc_k_major(b_lo + step), 1);
    }
    wgmma_rs_tf32<N>(part, hi[0], desc_k_major(b_raw + k_step(2 * c, N)), 0);
    wgmma_rs_tf32<N>(part, hi[1], desc_k_major(b_raw + k_step(2 * c + 1, N)), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(small);
    fence_operand(part);
    fence_regs(hi[0]);
    fence_regs(hi[1]);
    fence_regs(lo[0]);
    fence_regs(lo[1]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) out[i] = (c == 0 ? part[i] : out[i] + part[i]) + small[i];
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of this thread's elements (16 warp + g (+ 8), 8j + 2t (+ 1))
// of the accumulator of a K-column product in a Y tile (64 rows of 128
// bytes, K-major, swizzled; row % 8 is g): y_offset + h * 1024 for the
// rows + 8 (h = 1), XOR (2j << 4) for the columns of step j.
__device__ __forceinline__ uint32_t y_offset(int warp, int g, int t) {
  return (16 * warp + g) * kSubRow + (((t >> 1) ^ g) << 4) + 8 * (t & 1);
}

// The split of Y (the accumulator `y` of a K-column product, this
// warpgroup's 64 rows) into its hi and lo Y tiles, made visible to wgmma.
template <int K>
__device__ __forceinline__ void write_y(const float (&y)[K / 2], uint32_t y_hi, uint32_t y_lo,
                                        int warp, int g, int t) {
  const uint32_t y_thread = y_offset(warp, g, t);
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t hi0, lo0, hi1, lo1;
      split(y[4 * j + 2 * h], hi0, lo0);
      split(y[4 * j + 2 * h + 1], hi1, lo1);
      const uint32_t off = h * 8 * kSubRow + (y_thread ^ ((2 * j) << 4));
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(y_hi + off), "r"(hi0), "r"(hi1)
                   : "memory");
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(y_lo + off), "r"(lo0), "r"(lo1)
                   : "memory");
    }
  }
  fence_proxy_async();
}

// Element e of step j of Y back from the hi and lo tiles write_y wrote (by
// a thread of the same slot in another warpgroup; y_thread its
// y_offset): hi + lo, within 2^-22 of the element
__device__ __forceinline__ float read_y(uint32_t y_hi, uint32_t y_lo, uint32_t y_thread, int j,
                                       int e) {
  const uint32_t off = (e >> 1) * 8 * kSubRow + (y_thread ^ ((2 * j) << 4)) + 4 * (e & 1);
  return lds_f32(y_hi + off) + lds_f32(y_lo + off);
}

// run += (Y X)^T in 3xTF32 for this warpgroup, over a tile's K rows: Y is
// a K-column product's accumulator (the warpgroup's 64 rows) that write_y
// has put into y_hi / y_lo, X a [K rows x D] swizzled tile read raw (its
// hi) with its lo tile at x_lo. .tf32 wgmma reads B K-major only, and X
// runs along D, so the product is taken transposed, X^T Y^T: A = X^T by
// ld.shared into registers, B = the Y tiles. run holds the D/64 blocks of
// 64 rows of D x 64 columns (the accumulator layout, run[32 mb + i]
// element i of block mb). Each block's products over G of the tile's K
// go into a fresh accumulator (smallest first) added to run: G < K holds
// fewer fragments in registers at once (dK/dV needs that not to spill).
template <int K, int D, int G = K>
__device__ __forceinline__ void product_t3x(float (&run)[D / 2], uint32_t y_hi, uint32_t y_lo,
                                            uint32_t x_raw, uint32_t x_lo, int warp, int g,
                                            int t) {
  // X^T's fragment element (d, k) = X (k, d) for d = 64 mb + 16 warp + g
  // (+ 8: chunk + 2) and k = 8 kk + t (+ 4: row + 4, chunk ^ 4)
  const uint32_t x_thread = (warp >> 1) * K * kSubRow + t * kSubRow +
                            (((4 * (warp & 1) + (g >> 2)) ^ t) << 4) + ((g & 3) << 2);
  float part[32];  // defined (see product_3x), though the first product overwrites it
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "=f"(part[i]));
  constexpr int kSteps = G / 8;  // k8 steps of a group
#pragma unroll
  for (int mb = 0; mb < D / 64; ++mb) {
#pragma unroll
    for (int k0 = 0; k0 < K / 8; k0 += kSteps) {
      uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a[e]: d + 8 (e & 1), k + 4 (e / 2)
          const uint32_t off = 2 * mb * K * kSubRow + (k0 + s) * 8 * kSubRow +
                               (e >> 1) * 4 * kSubRow + (x_thread ^ ((e & 1) << 5) ^ ((e >> 1) << 6));
          hi[s][e] = lds(x_raw + off);
          lo[s][e] = lds(x_lo + off);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        wgmma_rs_tf32<64>(part, hi[s], desc_k_major(y_lo + k_step(k0 + s, 64)), s > 0);
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        wgmma_rs_tf32<64>(part, lo[s], desc_k_major(y_hi + k_step(k0 + s, 64)), 1);
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        wgmma_rs_tf32<64>(part, hi[s], desc_k_major(y_hi + k_step(k0 + s, 64)), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(part);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        fence_regs(hi[s]);
        fence_regs(lo[s]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) run[32 * mb + i] += part[i];
    }
  }
}

// Named barriers (0 is __syncthreads'): both consumer warpgroups (dq's
// partial sums), each consumer warpgroup alone (2 + its index), and dK/dV's
// hand-over of P^T (written, and read)
constexpr int kConsumersBarrier = 1;
constexpr int kWgBarrier = 2;
constexpr int kPReady = 4, kPRead = 5;

// Bytes of one of a consumer's Y tiles (hi or lo): 64 rows of 128 bytes
constexpr int kYBytes = 64 * kSubRow;

// out[b, row0 + n, h, d] = element (d, n) of run (product_t3x's layout),
// plus the same element of `add` (a second sum kept in the thread's own
// slots, add[i * 128 + tid]) unless it is null
template <int D>
__device__ __forceinline__ void store_transposed(float* out, const Strides& so, int b, int row0,
                                                 int h, const float (&run)[D / 2],
                                                 const float* add, int tid, int g, int t) {
  // rows row0 + 8j + 2t (+ 1), columns 64 mb + 16 warp + g (+ 8)
  float* base = out + offset(so, b, row0 + 2 * t, h) + 16 * (tid >> 5) + g;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const int mb = i / 32, j = i % 32 / 4, e = i % 4;
    base[(8 * j + (e & 1)) * so.s + 64 * mb + 8 * (e >> 1)] =
        add ? run[i] + add[i * 128 + tid] : run[i];
  }
}

// run (product_t3x's layout: column n = 8j + 2t (+ 1) of a thread's
// run[32 mb + 4j (+ 1, + 2, + 3)]) times the factor of each column, read
// from a 64-float row at shared address `row`
template <int D>
__device__ __forceinline__ void scale_columns(float (&run)[D / 2], uint32_t row, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f[2];
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(f[0]), "=f"(f[1])
                 : "r"(row + 4 * (8 * j + 2 * t))
                 : "memory");
#pragma unroll
    for (int mb = 0; mb < D / 64; ++mb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) run[32 * mb + 4 * j + e] *= f[e & 1];
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (128-row query tile, q head, batch)
// ---------------------------------------------------------------------------
constexpr int kFwdRows = 128;

template <int D>
struct FwdShape {
  static constexpr int kKeys = D <= 128 ? 32 : 8;  // per K/V tile
  static constexpr int kQBytes = kFwdRows * D * 4;
  static constexpr int kKVBytes = kKeys * D * 4;    // one of K, V
  static constexpr int kStageBytes = 4 * kKVBytes;  // K, V, then their lo tiles
  // Q, two stages, each consumer's Y tiles (P hi and lo), then four rows of
  // 64 floats, each consumer's rescale row and final factor row: 128 KB at
  // D 64, 224 KB at D 128 and 256 (+ barriers, 1024 alignment)
  static constexpr int kYOffset = kQBytes + 2 * kStageBytes;
  static constexpr int kRowOffset = kYOffset + 4 * kYBytes;
  static constexpr int kRowBytes = 64 * 4;
  static constexpr int kBarOffset = kRowOffset + 4 * kRowBytes;
  static constexpr int kSmem = kBarOffset + 7 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    tf32x3_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                      float* __restrict__ lse, Strides so, int S, int Hq, int group,
                      float sm_scale) {
  using Shape = FwdShape<D>;
  constexpr int BK = Shape::kKeys;
  constexpr int kGroup = BK < 16 ? BK : 16;  // keys of one product_t3x group
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* stages = smem + Shape::kQBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Shape::kBarOffset);
  uint64_t* full = q_full + 1;  // per stage: K/V landed, lo tiles ready, freed
  uint64_t* ready = full + 2;
  uint64_t* empty = ready + 2;

  // longest rows first across the whole grid
  const int n_qt = S / kFwdRows, heads = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / heads;
  const int h = blockIdx.x % heads % Hq, b = blockIdx.x % heads / Hq;
  const int kvh = h / group;
  const int q0 = qt * kFwdRows;
  const int n_kt = (q0 + kFwdRows - 1) / BK + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 4);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: Q once, then key tile kt into stage kt % 2 once both
    // consumers have freed it; the whole warpgroup writes its lo tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, Shape::kQBytes);
      for (int c = 0; c < D / 32; ++c)
        tma_load_4d(smem + c * kFwdRows * kSubRow, &tq, q_full, c * 32, h, q0, b);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % 2;
      const uint32_t phase = (kt / 2) & 1;
      unsigned char* stage = stages + s * Shape::kStageBytes;
      if (threadIdx.x == 0) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * Shape::kKVBytes);
        for (int c = 0; c < D / 32; ++c) {
          tma_load_4d(stage + c * BK * kSubRow, &tk, &full[s], c * 32, kvh, kt * BK, b);
          tma_load_4d(stage + Shape::kKVBytes + c * BK * kSubRow, &tv, &full[s], c * 32, kvh,
                      kt * BK, b);
        }
      }
      mbar_wait(&full[s], phase);
      write_lo(smem_u32(stage), 2 * Shape::kKVBytes, threadIdx.x, 128);
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&ready[s]);
    }
    return;
  }

  // consumers: consumer c owns rows q0 + 64c .. q0 + 64c + 63 and reads
  // every stage
  reg_alloc<kConsumerRegs>();
  const uint32_t smem_base = smem_u32(smem);
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * c;               // the consumer's first row, from q0
  const int row = r0 + warp * 16 + g;  // and row + 8
  // the consumer's last key tile with a key at or before its last row
  const int last_kt = (q0 + r0 + 63) / BK;

  float run[D / 2];  // O^T, product_t3x's layout; column n is row r0 + n
#pragma unroll
  for (int i = 0; i < D / 2; ++i) run[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};  // rows row, row + 8

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % 2;
    mbar_wait(&ready[s], (kt / 2) & 1);
    if (kt <= last_kt) {
      const int k0 = kt * BK;
      // addresses computed anew per tile, as dq's
      uint32_t base = smem_base;
      asm volatile("" : "+r"(base));
      const uint32_t k_raw = base + Shape::kQBytes + s * Shape::kStageBytes;
      const uint32_t v_raw = k_raw + Shape::kKVBytes;
      const uint32_t k_lo = k_raw + 2 * Shape::kKVBytes, v_lo = k_raw + 3 * Shape::kKVBytes;

      // S = Q K^T, scaled, the mask value above the diagonal
      float sc[BK / 2];
      product_3x<BK, D>(sc, base, kFwdRows, r0 + warp * 16, k_raw, k_lo, g, t);
      const bool diagonal = k0 + BK - 1 > q0 + r0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        float x = sc[j] * sm_scale;
        if (diagonal && k0 + (j >> 2) * 8 + 2 * t + (j & 1) > q0 + row + 8 * r) x = kMaskValue;
        sc[j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      // the online softmax: a row's scores lie in the quad of its 4 threads.
      // Key 0 lies in tile 0, so every row has a real score from the start.
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        sc[j] = expf(sc[j] - m[r]);
        l[r] += sc[j];
      }

      // P into the Y tiles and alpha into the consumer's rescale row, once
      // every warp's products of its last tile have read both; then O^T =
      // alpha O^T + V^T P^T, the products over each 16 keys in a fresh
      // accumulator (over the whole tile, 32 keys, the CPU model's o came
      // within 16% of the 4x bar)
      const uint32_t y = base + Shape::kYOffset + 2 * c * kYBytes;
      const uint32_t alpha_row = base + Shape::kRowOffset + c * Shape::kRowBytes;
      bar_sync(kWgBarrier + c, 128);
      write_y<BK>(sc, y, y + kYBytes, warp, g, t);
      if (t == 0) {
        sts_f32(alpha_row + 4 * (warp * 16 + g), alpha[0]);
        sts_f32(alpha_row + 4 * (warp * 16 + g + 8), alpha[1]);
      }
      bar_sync(kWgBarrier + c, 128);
      scale_columns<D>(run, alpha_row, t);
      product_t3x<BK, D, kGroup>(run, y, y + kYBytes, v_raw, v_lo, warp, g, t);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // O = O^T / l and lse = m + log l; 1 / l of each row reaches the threads
  // that hold its column of O^T through the consumer's factor row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const uint32_t factor_row = smem_base + Shape::kRowOffset + (2 + c) * Shape::kRowBytes;
  if (t == 0) {
    float* lse_rows = lse + (static_cast<int64_t>(b) * Hq + h) * S + q0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sts_f32(factor_row + 4 * (warp * 16 + g + 8 * r), 1.0f / l[r]);
      lse_rows[row + 8 * r] = m[r] + logf(l[r]);
    }
  }
  bar_sync(kWgBarrier + c, 128);
  scale_columns<D>(run, factor_row, t);
  store_transposed<D>(o, so, b, q0 + r0, h, run, nullptr, tid, g, t);
}

// ---------------------------------------------------------------------------
// dq: one block per (64-row query tile, q head, batch)
// ---------------------------------------------------------------------------
constexpr int kDqRows = 64;

template <int D>
struct DqShape {
  static constexpr int kKeys = D <= 128 ? 32 : 8;  // per K/V tile
  static constexpr int kQBytes = kDqRows * D * 4;                  // one of Q, dO
  static constexpr int kKVBytes = kKeys * D * 4;                   // one of K, V
  static constexpr int kStageBytes = 4 * kKVBytes;  // K, V, then their lo tiles
  // Q, dO, two stages, each consumer's Y tiles (dS hi and lo), then the
  // block's lse and delta rows: 128 KB at D 64, 224 KB at D 128 and 256
  // (+ barriers, 1024 alignment)
  static constexpr int kYOffset = 2 * kQBytes + 2 * kStageBytes;
  static constexpr int kStatOffset = kYOffset + 4 * kYBytes;
  static constexpr int kStatBytes = kDqRows * 4;  // one of lse, delta
  static constexpr int kBarOffset = kStatOffset + 2 * kStatBytes;
  static constexpr int kSmem = kBarOffset + 7 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    tf32x3_dq_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, Strides sdq, int S, int Hq, int group,
                     float sm_scale) {
  using Shape = DqShape<D>;
  constexpr int BK = Shape::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + Shape::kQBytes;
  unsigned char* stages = smem + 2 * Shape::kQBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Shape::kBarOffset);
  uint64_t* full = q_full + 1;  // per stage: K/V landed, lo tiles ready, freed
  uint64_t* ready = full + 2;
  uint64_t* empty = ready + 2;

  // longest rows first across the whole grid
  const int n_qt = S / kDqRows, heads = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / heads;
  const int h = blockIdx.x % heads % Hq, b = blockIdx.x % heads / Hq;
  const int kvh = h / group;
  const int q0 = qt * kDqRows;
  const int n_kt = (q0 + kDqRows - 1) / BK + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 2);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: Q and dO once; warps 0-1 feed stage 0 (the even key tiles,
    // consumer 0), warps 2-3 stage 1 (the odd ones, consumer 1)
    reg_dealloc<kProducerRegs>();
    const int s = threadIdx.x / 64, i_thread = threadIdx.x % 64;
    unsigned char* stage = stages + s * Shape::kStageBytes;
    if (threadIdx.x == 0) {
      const int64_t stat = (static_cast<int64_t>(b) * Hq + h) * S + q0;
      unsigned char* stats = smem + Shape::kStatOffset;
      mbar_arrive_expect_tx(q_full, 2 * Shape::kQBytes + 2 * Shape::kStatBytes);
      for (int c = 0; c < D / 32; ++c) {
        tma_load_4d(Qs + c * kDqRows * kSubRow, &tq, q_full, c * 32, h, q0, b);
        tma_load_4d(dOs + c * kDqRows * kSubRow, &tdo, q_full, c * 32, h, q0, b);
      }
      bulk_load(stats, lse + stat, Shape::kStatBytes, q_full);
      bulk_load(stats + Shape::kStatBytes, delta + stat, Shape::kStatBytes, q_full);
    }
    for (int kt = s, i = 0; kt < n_kt; kt += 2, ++i) {
      if (i_thread == 0) {
        mbar_wait(&empty[s], (i & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * Shape::kKVBytes);
        for (int c = 0; c < D / 32; ++c) {
          tma_load_4d(stage + c * BK * kSubRow, &tk, &full[s], c * 32, kvh, kt * BK, b);
          tma_load_4d(stage + Shape::kKVBytes + c * BK * kSubRow, &tv, &full[s], c * 32, kvh,
                      kt * BK, b);
        }
      }
      mbar_wait(&full[s], i & 1);
      write_lo(smem_u32(stage), 2 * Shape::kKVBytes, i_thread, 64);
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&ready[s]);
    }
    return;
  }

  // consumers: both own rows q0 .. q0 + 63; consumer c takes key tiles c,
  // c + 2, ... from stage c
  reg_alloc<kConsumerRegs>();
  const uint32_t smem_base = smem_u32(smem);
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = warp * 16 + g;  // and row + 8, from q0

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = c, i = 0; kt < n_kt; kt += 2, ++i) {
    mbar_wait(&ready[c], i & 1);
    const int k0 = kt * BK;
    // every address below is computed anew per tile: hoisted out of the
    // loop, the ~100 of them would hold registers across it
    uint32_t base = smem_base;
    asm volatile("" : "+r"(base));
    const uint32_t k_raw = base + 2 * Shape::kQBytes + c * Shape::kStageBytes;
    const uint32_t v_raw = k_raw + Shape::kKVBytes;
    const uint32_t k_lo = k_raw + 2 * Shape::kKVBytes, v_lo = k_raw + 3 * Shape::kKVBytes;

    // S = Q K^T and dP = dO V^T
    float sc[BK / 2], dp[BK / 2];
    product_3x<BK, D>(sc, base, kDqRows, warp * 16, k_raw, k_lo, g, t);
    product_3x<BK, D>(dp, base + Shape::kQBytes, kDqRows, warp * 16, v_raw, v_lo, g, t);

    // dS = P (dP - delta) sm_scale, P = exp(S sm_scale - lse), the mask
    // value above the diagonal (its exp is 0)
    const uint32_t lse_s = base + Shape::kStatOffset + 4 * row;
    const uint32_t delta_s = lse_s + Shape::kStatBytes;
    const float row_lse[2] = {lds_f32(lse_s), lds_f32(lse_s + 32)};
    const float row_delta[2] = {lds_f32(delta_s), lds_f32(delta_s + 32)};
    const bool diagonal = k0 + BK - 1 > q0;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = (j >> 1) & 1;
      float x = sc[j] * sm_scale;
      if (diagonal && k0 + (j >> 2) * 8 + 2 * t + (j & 1) > q0 + row + 8 * r) x = kMaskValue;
      sc[j] = (dp[j] - row_delta[r]) * expf(x - row_lse[r]) * sm_scale;
    }

    // dQ^T += K^T dS^T, once every warp's products of the last tile have
    // read the Y tiles and all of dS is in them
    const uint32_t y = base + Shape::kYOffset + 2 * c * kYBytes;
    bar_sync(kWgBarrier + c, 128);
    write_y<BK>(sc, y, y + kYBytes, warp, g, t);
    bar_sync(kWgBarrier + c, 128);
    product_t3x<BK, D>(acc, y, y + kYBytes, k_raw, k_lo, warp, g, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[c]);
  }

  // consumer 1's partial dQ reaches consumer 0 through shared memory (the
  // Q/dO tiles, read by neither any more), in the thread's own slots
  float* scratch = reinterpret_cast<float*>(smem);
  bar_sync(kConsumersBarrier, 256);
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) scratch[i * 128 + tid] = acc[i];
  }
  bar_sync(kConsumersBarrier, 256);
  if (c == 0) store_transposed<D>(dq, sdq, b, q0, h, acc, scratch, tid, g, t);
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (64-key tile, kv head, batch), looping over the
// query heads of the group and the query tiles at or after the diagonal
// ---------------------------------------------------------------------------
constexpr int kDkvKeys = 64;

template <int D>
struct DkvShape {
  static constexpr int kQueries = D <= 128 ? 32 : 8;  // per Q/dO tile
  static constexpr int kKBytes = kDkvKeys * D * 4;                    // one of K, V
  static constexpr int kQBytes = kQueries * D * 4;  // one of Q, dO and their lo tiles
  static constexpr int kStatBytes = kQueries * 4;   // one of lse, delta
  static constexpr int kLoadBytes = 2 * kQBytes + 2 * kStatBytes;  // by TMA
  static constexpr int kStageBytes = 4 * kQBytes;  // Q, dO, Q lo, dO lo
  // K, V, two stages, each consumer's Y tiles (P^T or dS^T, hi and lo),
  // then each stage's lse and delta rows: 128 KB at D 64, 224 KB at D 128
  // and 256 (+ barriers, 1024 alignment)
  static constexpr int kYOffset = 2 * kKBytes + 2 * kStageBytes;
  static constexpr int kStatOffset = kYOffset + 4 * kYBytes;
  static constexpr int kBarOffset = kStatOffset + 4 * kStatBytes;
  static constexpr int kSmem = kBarOffset + 7 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    tf32x3_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, Strides sdk,
                      Strides sdv, int S, int Hq, int group, float sm_scale) {
  using Shape = DkvShape<D>;
  constexpr int BQ = Shape::kQueries;
  constexpr int kDkvGroup = BQ < 16 ? BQ : 16;  // queries of one product_t3x group
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + Shape::kKBytes;
  unsigned char* stages = smem + 2 * Shape::kKBytes;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Shape::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* ready = full + 2;
  uint64_t* empty = ready + 2;

  // keys near 0 see most queries: their tiles first across the whole grid
  const int hkv = Hq / group, heads = gridDim.x / (S / kDkvKeys);
  const int kt = blockIdx.x / heads;
  const int kvh = blockIdx.x % heads % hkv, b = blockIdx.x % heads / hkv;
  const int k0 = kt * kDkvKeys;
  const int per_head = (S - k0) / BQ, n_tiles = group * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 4);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: K and V once, then Q, dO, lse, delta per (head, tile); the
    // whole warpgroup writes each stage's lo tiles
    reg_dealloc<kProducerRegs>();
    auto load = [&](int it) {
      const int h = kvh * group + it / per_head;
      const int q0 = k0 + it % per_head * BQ;
      const int64_t stat = (static_cast<int64_t>(b) * Hq + h) * S + q0;
      const int s = it % 2;
      unsigned char* stage = stages + s * Shape::kStageBytes;
      unsigned char* stats = smem + Shape::kStatOffset + 2 * s * Shape::kStatBytes;
      mbar_wait(&empty[s], ((it / 2) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], Shape::kLoadBytes);
      for (int c = 0; c < D / 32; ++c) {
        tma_load_4d(stage + c * BQ * kSubRow, &tq, &full[s], c * 32, h, q0, b);
        tma_load_4d(stage + Shape::kQBytes + c * BQ * kSubRow, &tdo, &full[s], c * 32, h, q0,
                    b);
      }
      bulk_load(stats, lse + stat, Shape::kStatBytes, &full[s]);
      bulk_load(stats + Shape::kStatBytes, delta + stat, Shape::kStatBytes, &full[s]);
    };
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * Shape::kKBytes);
      for (int c = 0; c < D / 32; ++c) {
        tma_load_4d(Ks + c * kDkvKeys * kSubRow, &tk, kv_full, c * 32, kvh, k0, b);
        tma_load_4d(Vs + c * kDkvKeys * kSubRow, &tv, kv_full, c * 32, kvh, k0, b);
      }
      load(0);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % 2;
      mbar_wait(&full[s], (it / 2) & 1);
      write_lo(smem_u32(stages + s * Shape::kStageBytes), 2 * Shape::kQBytes, threadIdx.x, 128);
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&ready[s]);
      if (threadIdx.x == 0 && it + 1 < n_tiles) load(it + 1);
    }
    return;
  }

  // consumers: warpgroup 1 sums dV, warpgroup 2 dK, over the same 64 keys
  reg_alloc<kConsumerRegs>();
  const uint32_t smem_base = smem_u32(smem);
  const bool dv_group = wg == 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key = k0 + warp * 16 + g;  // and key + 8

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = k0 + it % per_head * BQ;
    const int s = it % 2;
    mbar_wait(&ready[s], (it / 2) & 1);
    // addresses computed anew per tile, as dq's
    uint32_t base = smem_base;
    asm volatile("" : "+r"(base));
    const uint32_t q_raw = base + 2 * Shape::kKBytes + s * Shape::kStageBytes;
    const uint32_t do_raw = q_raw + Shape::kQBytes;
    const uint32_t q_lo = q_raw + 2 * Shape::kQBytes, do_lo = q_raw + 3 * Shape::kQBytes;
    const uint32_t lse_s = base + Shape::kStatOffset + 2 * s * Shape::kStatBytes;
    const uint32_t delta_s = lse_s + Shape::kStatBytes;

    const uint32_t y_dv = base + Shape::kYOffset, y_dk = y_dv + 2 * kYBytes;
    float y[BQ / 2];
    if (dv_group) {
      // S^T = K Q^T and P^T = exp(S^T sm_scale - lse), the mask value above
      // the diagonal
      product_3x<BQ, D>(y, base, kDkvKeys, warp * 16, q_raw, q_lo, g, t);
      const bool diagonal = k0 + kDkvKeys - 1 > q0;
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int q = (j >> 2) * 8 + 2 * t + (j & 1);  // this element's query, from q0
        float x = y[j] * sm_scale;
        if (diagonal && key + 8 * ((j >> 1) & 1) > q0 + q) x = kMaskValue;
        y[j] = expf(x - lds_f32(lse_s + 4 * q));
      }
      // P^T into the Y tiles once the dK group has read the last tile's
      // (which also means every warp here is done with them), then to the
      // dK group; dV^T += dO^T P
      if (it > 0) bar_sync(kPRead, 256);
      write_y<BQ>(y, y_dv, y_dv + kYBytes, warp, g, t);
      bar_sync(kWgBarrier, 128);
      bar_arrive(kPReady, 256);
      product_t3x<BQ, D, kDkvGroup>(acc, y_dv, y_dv + kYBytes, do_raw, do_lo, warp, g, t);
    } else {
      // dP^T = V dO^T, P^T from the dV group's Y tiles, dS^T = P^T (dP^T -
      // delta) sm_scale; dK^T += Q^T dS
      product_3x<BQ, D>(y, base + Shape::kKBytes, kDkvKeys, warp * 16, do_raw, do_lo, g, t);
      const uint32_t y_thread = y_offset(warp, g, t);
      bar_sync(kPReady, 256);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int q = (j >> 2) * 8 + 2 * t + (j & 1);
        y[j] = (y[j] - lds_f32(delta_s + 4 * q)) *
               read_y(y_dv, y_dv + kYBytes, y_thread, j >> 2, j & 3) * sm_scale;
      }
      if (it + 1 < n_tiles) bar_arrive(kPRead, 256);
      bar_sync(kWgBarrier + 1, 128);
      write_y<BQ>(y, y_dk, y_dk + kYBytes, warp, g, t);
      bar_sync(kWgBarrier + 1, 128);
      product_t3x<BQ, D, kDkvGroup>(acc, y_dk, y_dk + kYBytes, q_raw, q_lo, warp, g, t);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_transposed<D>(dv_group ? dv : dk, dv_group ? sdv : sdk, b, k0, kvh, acc, nullptr, tid,
                      g, t);
}

// ---------------------------------------------------------------------------
// The probe of how the tensor core reads an f32 operand, through the RS
// wgmma the kernels use (one warpgroup, m64n8k8.tf32): A's column 0 holds
// x[0..63] (raw f32 in registers) against B = e_0, and A = e_0 against B's
// column 0 = x[64..71] (raw f32 in shared memory), so out[i] = x[i] as the
// tensor core took it.
// ---------------------------------------------------------------------------
__global__ void tf32x3_probe_kernel(const float* __restrict__ x, float* __restrict__ out) {
  // two [8 rows x 32] swizzled K-major B tiles: e_0, and x[64..71] in
  // column 0 (element (n, 0) in chunk n of row n)
  __shared__ __align__(1024) float tiles[2][8 * 32];
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  for (int i = tid; i < 2 * 8 * 32; i += 128) tiles[i / 256][i % 256] = 0.f;
  __syncthreads();
  if (tid < 8) {
    tiles[0][tid * 32 + tid * 4] = 1.f;
    tiles[1][tid * 32 + tid * 4] = x[64 + tid];
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t one = t == 0 ? __float_as_uint(1.f) : 0u;
  const uint32_t a_x[4] = {t == 0 ? __float_as_uint(x[16 * warp + g]) : 0u,
                           t == 0 ? __float_as_uint(x[16 * warp + g + 8]) : 0u, 0u, 0u};
  const uint32_t a_one[4] = {one, one, 0u, 0u};
  float d_a[4], d_b[4];
  wgmma_fence();
  wgmma_rs_tf32<8>(d_a, a_x, desc_k_major(smem_u32(tiles[0])), 0);
  wgmma_rs_tf32<8>(d_b, a_one, desc_k_major(smem_u32(tiles[1])), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(d_a);
  fence_operand(d_b);
  if (t == 0) {
    out[16 * warp + g] = d_a[0];
    out[16 * warp + g + 8] = d_a[2];
  }
  if (warp == 0 && g == 0) {
    out[64 + 2 * t] = d_b[0];
    out[64 + 2 * t + 1] = d_b[1];
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------
Strides strides_at(const int64_t* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Raise the kernel's dynamic shared-memory limit and launch it; a refused
// attribute is returned like a refused launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, dim3 grid, cudaStream_t stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The f32 tile map of tensor `i` of the strides array, `rows` rows a box.
int map_at(CUtensorMap* map, const void* p, const int64_t* st, int i, int B, int S, int H,
           int D, int rows) {
  const Strides s = strides_at(st, i);
  return tile_map<float>(map, p, B, S, H, D, s.b, s.s, s.h, rows);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, const int64_t* st,
        int B, int S, int Hq, int Hkv, float sm_scale, cudaStream_t stream) {
  using Shape = FwdShape<D>;
  CUtensorMap tq, tk, tv;
  int err = map_at(&tq, q, st, 0, B, S, Hq, D, kFwdRows);
  if (err == 0) err = map_at(&tk, k, st, 1, B, S, Hkv, D, Shape::kKeys);
  if (err == 0) err = map_at(&tv, v, st, 2, B, S, Hkv, D, Shape::kKeys);
  if (err != 0) return err;
  return launch(tf32x3_fwd_kernel<D>, Shape::kSmem, dim3(S / kFwdRows * Hq * B),
                stream, tq, tk, tv, static_cast<float*>(o), lse, strides_at(st, 3), S, Hq,
                Hq / Hkv, sm_scale);
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, void* dqp, const int64_t* st, int B, int S, int Hq, int Hkv,
       float sm_scale, cudaStream_t stream) {
  using Shape = DqShape<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = map_at(&tq, q, st, 0, B, S, Hq, D, kDqRows);
  if (err == 0) err = map_at(&tk, k, st, 1, B, S, Hkv, D, Shape::kKeys);
  if (err == 0) err = map_at(&tv, v, st, 2, B, S, Hkv, D, Shape::kKeys);
  if (err == 0) err = map_at(&tdo, dout, st, 3, B, S, Hq, D, kDqRows);
  if (err != 0) return err;
  return launch(tf32x3_dq_kernel<D>, Shape::kSmem, dim3(S / kDqRows * Hq * B), stream, tq,
                tk, tv, tdo, lse, delta, static_cast<float*>(dqp), strides_at(st, 4), S, Hq,
                Hq / Hkv, sm_scale);
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dkp, void* dvp, const int64_t* st, int B, int S, int Hq,
        int Hkv, float sm_scale, cudaStream_t stream) {
  using Shape = DkvShape<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = map_at(&tq, q, st, 0, B, S, Hq, D, Shape::kQueries);
  if (err == 0) err = map_at(&tk, k, st, 1, B, S, Hkv, D, kDkvKeys);
  if (err == 0) err = map_at(&tv, v, st, 2, B, S, Hkv, D, kDkvKeys);
  if (err == 0) err = map_at(&tdo, dout, st, 3, B, S, Hq, D, Shape::kQueries);
  if (err != 0) return err;
  return launch(tf32x3_dkv_kernel<D>, Shape::kSmem, dim3(S / kDkvKeys * Hkv * B), stream,
                tq, tk, tv, tdo, lse, delta, static_cast<float*>(dkp),
                static_cast<float*>(dvp), strides_at(st, 4), strides_at(st, 5), S, Hq,
                Hq / Hkv, sm_scale);
}

// fn<D>(args...) for dtype code 0 (f32) and D 64/128/256
#define TFT_DISPATCH_TF32X3(fn, dtype, D, ...)          \
  if ((dtype) != 0) return kErrDtype;                   \
  switch (D) {                                          \
    case 64: return fn<64>(__VA_ARGS__);                \
    case 128: return fn<128>(__VA_ARGS__);              \
    case 256: return fn<256>(__VA_ARGS__);              \
  }                                                     \
  return kErrHeadDim;

}  // namespace

extern "C" {

// Rows of the largest of the kernels' tiles (the forward's 128 query rows;
// dq's 64 query rows, dK/dV's 64 keys): S must be a multiple of it.
int tft_tf32x3_attention_tile() { return kFwdRows; }

// dtype: 0 f32. strides: 3 per tensor (batch, sequence, head) for q, k, v,
// o. p_f32 (K1 keeps P in f32, K2 rounds it to the input dtype) changes
// nothing in f32.
int tft_tf32x3_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                             float* lse, const int64_t* strides, int B, int S, int Hq, int Hkv,
                             int D, float sm_scale, int p_f32, cudaStream_t stream) {
  (void)p_f32;
  TFT_DISPATCH_TF32X3(fwd, dtype, D, q, k, v, o, lse, strides, B, S, Hq, Hkv, sm_scale, stream)
}

// dtype: 0 f32. strides for q, k, v, do, dq
int tft_tf32x3_attention_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            void* dqp, const int64_t* strides, int B, int S, int Hq,
                            int Hkv, int D, float sm_scale, cudaStream_t stream) {
  TFT_DISPATCH_TF32X3(dq, dtype, D, q, k, v, dout, lse, delta, dqp, strides, B, S, Hq, Hkv,
                      sm_scale, stream)
}

// dtype: 0 f32. strides for q, k, v, do, dk, dv
int tft_tf32x3_attention_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             void* dkp, void* dvp, const int64_t* strides, int B, int S,
                             int Hq, int Hkv, int D, float sm_scale, cudaStream_t stream) {
  TFT_DISPATCH_TF32X3(dkv, dtype, D, q, k, v, dout, lse, delta, dkp, dvp, strides, B, S, Hq,
                      Hkv, sm_scale, stream)
}

// out[i] = x[i] (72 f32 values on the card) as the tensor core reads an f32
// operand of a .tf32 wgmma: x[0..63] from registers (A), x[64..71] from
// shared memory (B).
int tft_tf32x3_probe(const float* x, float* out, cudaStream_t stream) {
  tf32x3_probe_kernel<<<1, 128, 0, stream>>>(x, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
