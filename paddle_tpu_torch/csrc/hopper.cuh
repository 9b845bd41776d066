// Hopper (sm_90a) building blocks for the hand-written tensor-core kernels:
// wgmma (warpgroup matrix multiply) descriptors and instructions, the
// wgmma fence / commit / wait, mbarrier wrappers, thread-block cluster
// barriers and distributed shared-memory reads, TMA tile loads, and the
// host-side tensor-map encoder.
//
// The encoder looks cuTensorMapEncodeTiled up at run time through
// cudaGetDriverEntryPoint, so a library that includes this header links
// against the CUDA runtime only (no -lcuda).  Tensor maps are encoded on
// the host for every call and passed to the kernel by value as a
// `const __grid_constant__ CUtensorMap` parameter, which CUDA-graph
// capture records with the launch.
//
// Shared-memory tiles.  A tile of R rows of a 16-bit (bf16 / fp16) matrix
// with D columns is stored as D / C column blocks ("atoms"), each R rows
// of C columns (C = 64: 128-byte rows, 128-byte swizzle; C = 32: 64-byte
// rows, 64-byte swizzle), exactly as TMA writes a box of C columns x R
// rows with that swizzle.  The wgmma descriptors below read such tiles in
// both orientations:
//   * K-major (the tile's columns are the contraction): desc_kmajor;
//   * MN-major (the tile's rows are the contraction, its columns the
//     output's N), taken by wgmma's transpose bit: desc_mnmajor.
// Tiles start on a 1024-byte boundary, which both swizzles need.
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one plain arrival (a consumer handing a ring stage back)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// spins until the barrier's phase of this parity has completed; traps
// after about 2^34 clocks (seconds), so a copy that never lands fails the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -------------------------------------------------- thread-block cluster
// (a kernel launched without a cluster is a cluster of one CTA)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every CTA of the cluster: the shared-memory writes
// before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 4 floats at the same shared-memory offset as `local` (16-byte
// aligned), in the CTA of the cluster with this rank
__device__ __forceinline__ float4 ld_cluster_f32x4(const float* local,
                                                   uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote) : "memory");
  return v;
}

// ------------------------------------------------------------------ TMA
// a box of the 3-D map at (c0, c1, c2) (innermost first) into dst,
// completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// ------------------------------------------------------------- cp.async
// `bytes` (4, 8 or 16) from global src into shared dst; only the first
// src_bytes are read, the rest of the chunk is zero-filled (0: all zero)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         uint32_t src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -------------------------------------------------------- tile geometry
// A 16-bit tile of D columns (D in {32, 64, 128}) as TMA and wgmma see it.
template <int D>
struct TileCols {
  static constexpr int kAtomCols = D >= 64 ? 64 : 32;  // columns per atom
  static constexpr int kAtoms = D / kAtomCols;         // 1, or 2 at D = 128
  static constexpr int kRowBytes = kAtomCols * 2;      // 128 or 64
  static constexpr int kGroupBytes = 8 * kRowBytes;    // 8 rows
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2; // descriptor: B128, B64
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows of an R-row tile are M (or N), columns 16 kk ..
// 16 kk + 15 are the k16 step kk
template <int D, int R>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  using G = TileCols<D>;
  const int col = 16 * kk;
  const char* p = (const char*)tile + (col / G::kAtomCols) * R * G::kRowBytes +
                  (col % G::kAtomCols) * 2;
  return make_desc(p, 16, G::kGroupBytes, G::kLayout);
}

// MN-major operand (wgmma transpose bit set): rows 16 kk .. 16 kk + 15 of
// an R-row tile are the k16 step kk, the D columns are N
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  using G = TileCols<D>;
  const char* p = (const char*)tile + 16 * kk * G::kRowBytes;
  return make_desc(p, R * G::kRowBytes, G::kGroupBytes, G::kLayout);
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma's operand reads); a barrier then publishes them to the
// other warps' wgmmas.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait (or reusing them before it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats rounded to nearest even into T x 2 (the lower column in the
// low half): a 32-bit A-operand register, or a 4-byte store.  fp16 keeps
// subnormals (cvt.rn without .ftz).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The m64nNk16 products with f32 accumulators.  d holds this thread's
// N / 2 accumulators: d[4 n + 2 h + e] is row 16 warp + lane / 4 + 8 h,
// column 8 n + 2 (lane % 4) + e.  `accumulate` 0 overwrites d.  TB = 1
// reads B MN-major; TA = 1 reads A MN-major (an A in shared memory only).
#define HOPPER_ACC8(o)                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define HOPPER_ACC16 HOPPER_ACC8(0), HOPPER_ACC8(8)
#define HOPPER_ACC32 HOPPER_ACC16, HOPPER_ACC8(16), HOPPER_ACC8(24)
#define HOPPER_ACC64 \
  HOPPER_ACC32, HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56)
#define HOPPER_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_REGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// A and B from shared memory (descriptors); TA = 1 reads A MN-major
#define HOPPER_WGMMA_SS(N, TY, REGS, ACC, IA, IB, IS, ITA, IT)             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " REGS ", %" IA ", %" IB ", p, 1, 1, %" ITA ", %" IT      \
               ";\n}\n"                                                    \
               : ACC                                                       \
               : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB))
// A from registers (four T x 2 registers, the accumulator's layout for
// the 16 columns of one k16 step), B from shared memory
#define HOPPER_WGMMA_RS(N, TY, REGS, ACC, IA, IB, IS, IT)                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " REGS ", " IA ", %" IB ", p, 1, 1, %" IT ";\n}\n"        \
               : ACC                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                 "r"(accumulate), "n"(TB))

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (kIsBf16<T>)
    HOPPER_WGMMA_SS(32, "bf16", HOPPER_REGS16, HOPPER_ACC16, "16", "17", "18",
                    "19", "20");
  else
    HOPPER_WGMMA_SS(32, "f16", HOPPER_REGS16, HOPPER_ACC16, "16", "17", "18",
                    "19", "20");
}
template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (kIsBf16<T>)
    HOPPER_WGMMA_SS(64, "bf16", HOPPER_REGS32, HOPPER_ACC32, "32", "33", "34",
                    "35", "36");
  else
    HOPPER_WGMMA_SS(64, "f16", HOPPER_REGS32, HOPPER_ACC32, "32", "33", "34",
                    "35", "36");
}
template <typename T, int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (kIsBf16<T>)
    HOPPER_WGMMA_SS(128, "bf16", HOPPER_REGS64, HOPPER_ACC64, "64", "65", "66",
                    "67", "68");
  else
    HOPPER_WGMMA_SS(128, "f16", HOPPER_REGS64, HOPPER_ACC64, "64", "65", "66",
                    "67", "68");
}
template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (kIsBf16<T>)
    HOPPER_WGMMA_RS(32, "bf16", HOPPER_REGS16, HOPPER_ACC16,
                    "{%16, %17, %18, %19}", "20", "21", "22");
  else
    HOPPER_WGMMA_RS(32, "f16", HOPPER_REGS16, HOPPER_ACC16,
                    "{%16, %17, %18, %19}", "20", "21", "22");
}
template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (kIsBf16<T>)
    HOPPER_WGMMA_RS(64, "bf16", HOPPER_REGS32, HOPPER_ACC32,
                    "{%32, %33, %34, %35}", "36", "37", "38");
  else
    HOPPER_WGMMA_RS(64, "f16", HOPPER_REGS32, HOPPER_ACC32,
                    "{%32, %33, %34, %35}", "36", "37", "38");
}
template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (kIsBf16<T>)
    HOPPER_WGMMA_RS(128, "bf16", HOPPER_REGS64, HOPPER_ACC64,
                    "{%64, %65, %66, %67}", "68", "69", "70");
  else
    HOPPER_WGMMA_RS(128, "f16", HOPPER_REGS64, HOPPER_ACC64,
                    "{%64, %65, %66, %67}", "68", "69", "70");
}

#undef HOPPER_WGMMA_RS
#undef HOPPER_WGMMA_SS
#undef HOPPER_REGS64
#undef HOPPER_REGS32
#undef HOPPER_REGS16
#undef HOPPER_ACC64
#undef HOPPER_ACC32
#undef HOPPER_ACC16
#undef HOPPER_ACC8

// ------------------------------------------------------- host: encoding
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, or null
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a row-major (n, rows, cols) tensor of 16-bit elements
// (cols * 2 a multiple of 16 bytes), boxes of box_cols x box_rows x 1;
// reads past any edge of a box are zeros.
inline cudaError_t encode_3d(CUtensorMap* map, const void* base,
                             CUtensorMapDataType type, uint64_t cols,
                             uint64_t rows, uint64_t n, uint32_t box_cols,
                             uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cols, rows, n};
  const cuuint64_t strides[2] = {cols * 2, cols * rows * 2};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides,
                        box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 1-D map over n float32s, boxes of `box` elements (box * 4 a multiple
// of 16 bytes); reads past the end are zeros.
inline cudaError_t encode_1d_f32(CUtensorMap* map, const float* base,
                                 uint64_t n, uint32_t box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {n};
  const cuuint64_t strides[1] = {n * 4};   // not read for rank 1
  const cuuint32_t boxes[1] = {box};
  const cuuint32_t step[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<float*>(base), dims, strides, boxes, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
