// Hopper (sm_90a) building blocks of the port's hand-written kernels.
//
//   * TMA: tile maps over [B, S, H, D] bf16, f16 or f32 tensors read
//     through their own strides (cuTensorMapEncodeTiled, reached through
//     the runtime's libcuda entry point, so the library links no -lcuda),
//     4-D tile loads and 1-D bulk copies that complete on an mbarrier.
//   * The 128-byte swizzle. A tile of R rows x D elements lands in shared
//     memory as D / (128 / sizeof(T)) sub-tiles of R rows x 128 bytes (64
//     2-byte or 32 4-byte elements a row; one TMA box each, 1024-byte
//     aligned); within a sub-tile, 16-byte chunk c of row r sits at r * 128
//     + ((c ^ (r % 8)) * 16). The wgmma descriptors below read exactly that
//     layout, K-major (rows of the operand along the sub-tile's rows) or
//     MN-major (the operand's N along the row's elements). A K step is 32
//     bytes either way: 16 bf16/f16 elements (k16) or 8 tf32 ones (k8).
//   * mbarriers: init, arrive, arrive with an expected byte count, and a
//     parity wait with a watchdog that traps after ~10 s, so a protocol
//     fault ends the launch with an error instead of hanging the card.
//   * wgmma: fence / commit / wait, the operand fence, SS (A and B in
//     shared memory) and RS (A in registers) products for the shapes the
//     kernels use, from bf16 or f16 operands (the same fragment layouts,
//     descriptors and swizzle: both are 2 bytes), and RS k8 products from
//     tf32 operands (f32 data whose low 13 mantissa bits the tensor core
//     ignores; B K-major only, as .tf32 takes no transpose).
//   * setmaxnreg for a producer/consumer split of a 384-thread block: the
//     producer warpgroup gives registers back (24 a thread), the two
//     consumer warpgroups take them (240), which is exact for a kernel
//     compiled at 168 registers (__launch_bounds__(384, 1)).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Host: tile maps
// ---------------------------------------------------------------------------
// Status codes the entry points return besides cudaError_t values.
constexpr int kErrHeadDim = -1;     // a head dim the kernels were not built for
constexpr int kErrEntryPoint = -2;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = -3;   // cuTensorMapEncodeTiled refused the map
constexpr int kErrDtype = -4;       // a dtype code it was not built for

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                : nullptr;
  }();
  return fn;
}

// The TMA element type of T.
template <typename T>
constexpr CUtensorMapDataType tma_type();
template <>
constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// A map over a [B, S, H, D] tensor of T (bf16, f16 or f32) with element
// strides (sb, ss, sh) and a unit stride along D, whose box is `rows`
// sequence positions by 128 / sizeof(T) head-dim columns (one 128-byte
// swizzle row) of one head and batch. Dimensions in memory order (D, H, S,
// B); a load's coordinates are (d0, h, s0, b).
template <typename T>
inline int tile_map(CUtensorMap* map, const void* base, int B, int S, int H,
                    int D, int64_t sb, int64_t ss, int64_t sh, int rows) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "a box row is the 128-byte swizzle");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrEntryPoint;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * sizeof(T),
                                 static_cast<cuuint64_t>(ss) * sizeof(T),
                                 static_cast<cuuint64_t>(sb) * sizeof(T)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / sizeof(T)), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, tma_type<T>(), 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to the 1024 bytes the swizzle repeats on
// (the launch asks for 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of transfers to complete on it.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Orders this thread's earlier writes to shared memory (the generic proxy)
// before later reads of it by the async proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Cycles a wait may spin before it traps (~10 s at the H100's clocks).
constexpr long long kWatchdogCycles = 20000000000LL;

// Waits until the phase of parity `parity` has completed. A fresh barrier
// counts its (nonexistent) previous phase, parity 1, as completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > kWatchdogCycles) {
      __trap();
    }
  }
}

// TMA: the box of `map` at coordinates (c0, c1, c2, c3) into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// memory into `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: setmaxnreg
// ---------------------------------------------------------------------------
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors for the 128-byte swizzle (layout type 1
// in bits 62-63). Start address in bits 0-13, leading byte offset in bits
// 16-29, stride byte offset in bits 32-45, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows of 128 bytes (64 elements of K), 8-row groups 1024
// bytes apart; the 16 K values of one product start at `addr` (a sub-tile
// row base plus 32 bytes per K step). The leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}

// MN-major operand (B with N along the sub-tile's 64 columns): K runs down
// the rows, 8-row groups 1024 bytes apart (stride offset); N continues in
// the next sub-tile, `subtile_bytes` on (leading offset).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t subtile_bytes) {
  return make_desc(addr, subtile_bytes, 1024);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] in f32 from T (__nv_bfloat16 or
// __half; the instruction's .bf16 or .f16 operand type): SS reads A and B
// (both K-major) from shared memory and adds D only if `accumulate`; RS
// reads A from registers (the mma.sync m16n8k16 A fragment per warp) and B
// MN-major from shared memory, and adds D unless `accumulate` is 0 (then D's
// registers need no values before the product). Accumulator layout: warp w
// of the warpgroup owns rows 16w..16w+15; d[4j + e] is row 16w + lane/4 +
// 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2.
// Each shape below is defined for both types by one macro.
template <int N, typename T>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                         int accumulate);
template <int N, typename T>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                         int accumulate = 1);

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory
#define TFT_WGMMA_SS_32(T, TY)                                                                                 \
  template <>                                                                                                  \
  __device__ __forceinline__ void wgmma_ss<32, T>(float (&d)[16], uint64_t a,                                  \
                                                  uint64_t b, int accumulate) {                                \
    asm volatile(                                                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                           \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                                           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "                                \
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                                                     \
        :                                                                                                      \
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),      \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
        : "l"(a), "l"(b), "r"(accumulate));                                                                    \
  }
TFT_WGMMA_SS_32(__nv_bfloat16, "bf16")
TFT_WGMMA_SS_32(__half, "f16")

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
#define TFT_WGMMA_SS_64(T, TY)                                                                                    \
  template <>                                                                                                     \
  __device__ __forceinline__ void wgmma_ss<64, T>(float (&d)[32], uint64_t a,                                     \
                                                  uint64_t b, int accumulate) {                                   \
    asm volatile(                                                                                                 \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                              \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                                  \
        "%30, %31 "                                                                                               \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                                        \
        :                                                                                                         \
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
        : "l"(a), "l"(b), "r"(accumulate));                                                                       \
  }
TFT_WGMMA_SS_64(__nv_bfloat16, "bf16")
TFT_WGMMA_SS_64(__half, "f16")

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
#define TFT_WGMMA_SS_128(T, TY)                                                                                   \
  template <>                                                                                                     \
  __device__ __forceinline__ void wgmma_ss<128, T>(float (&d)[64], uint64_t a,                                    \
                                                  uint64_t b, int accumulate) {                                   \
    asm volatile(                                                                                                 \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                              \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                             \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                                  \
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "                                  \
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "                                  \
        "%58, %59, %60, %61, %62, %63 "                                                                           \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                                                        \
        :                                                                                                         \
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
        : "l"(a), "l"(b), "r"(accumulate));                                                                       \
  }
TFT_WGMMA_SS_128(__nv_bfloat16, "bf16")
TFT_WGMMA_SS_128(__half, "f16")

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
#define TFT_WGMMA_RS_64(T, TY)                                                                                    \
  template <>                                                                                                     \
  __device__ __forceinline__ void wgmma_rs<64, T>(float (&d)[32],                                                 \
                                                  const uint32_t (&a)[4],                                         \
                                               uint64_t b, int accumulate) {                                      \
    asm volatile(                                                                                                 \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                              \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                                  \
        "%30, %31 "                                                                                               \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                          \
        :                                                                                                         \
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));                                   \
  }
TFT_WGMMA_RS_64(__nv_bfloat16, "bf16")
TFT_WGMMA_RS_64(__half, "f16")

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in shared memory
#define TFT_WGMMA_RS_128(T, TY)                                                                                   \
  template <>                                                                                                     \
  __device__ __forceinline__ void wgmma_rs<128, T>(float (&d)[64],                                                \
                                                  const uint32_t (&a)[4],                                         \
                                               uint64_t b, int accumulate) {                                      \
    asm volatile(                                                                                                 \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                              \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                             \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                                  \
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "                                  \
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "                                  \
        "%58, %59, %60, %61, %62, %63 "                                                                           \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                          \
        :                                                                                                         \
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));                                   \
  }
TFT_WGMMA_RS_128(__nv_bfloat16, "bf16")
TFT_WGMMA_RS_128(__half, "f16")

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers, B MN-major in shared memory
#define TFT_WGMMA_RS_256(T, TY)                                                                                           \
  template <>                                                                                                             \
  __device__ __forceinline__ void wgmma_rs<256, T>(float (&d)[128],                                                       \
                                                  const uint32_t (&a)[4],                                                 \
                                               uint64_t b, int accumulate) {                                              \
    asm volatile(                                                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                                                     \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                                     \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                          \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                                          \
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "                                          \
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "                                          \
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "                                          \
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "                                          \
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "                                          \
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "                                              \
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "                                              \
        "%122, %123, %124, %125, %126, %127 "                                                                             \
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                                             \
        :                                                                                                                 \
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),         \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),         \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),         \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),         \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),         \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),     \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));                                           \
  }
TFT_WGMMA_RS_256(__nv_bfloat16, "bf16")
TFT_WGMMA_RS_256(__half, "f16")

// D[64 x N] (+)= A[64 x 8] B[8 x N] in f32 from tf32 operands: A in
// registers, B K-major in shared memory (.tf32 reads B K-major only), and D
// is added unless `accumulate` is 0. A fragment per warp (rows 16w..16w+15
// of the warpgroup), as mma.sync m16n8k8's: a[0] row lane/4, column
// lane%4; a[1] row + 8; a[2] column + 4; a[3] both. D's layout is the
// 16-bit products' above.
template <int N>
__device__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                              int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace hopper
