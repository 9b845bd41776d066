// The fc epilogue of a fused matmul -> bias -> activation chain on 16-bit
// operands (bf16 or fp16), for Hopper (sm_90a), on the tensor cores.
//
// Replaces the bf16 and fp16 variants of _matmul_bias_act_kernel
// (paddle_tpu/ops/pallas_kernels.py:1186, launched by matmul_bias_act
// :1207):  out = act(x @ w + bias),  x (M, K) and w (K, N) of one 16-bit
// type T, row-major, bias (N,) f32 or T, f32 accumulation.
//
// Rounding follows the static AMP program, not the Pallas kernel.  In a
// rewritten program the chain is mul (T x T -> T) -> elementwise_add
// (T + f32 bias -> f32, as jnp promotes) -> act, and the JAX package's own
// fallback (_matmul_bias_act_jnp, fused_ops.py:577) computes exactly that;
// its Pallas kernel instead adds the bias to the unrounded f32 accumulator
// and stores T (result_type(x, w)).  Fusion must not change numerics
// (fused_ops.py:422-423), so here:
//   v = T(acc)                    the mul's T output
//   v = v + bias                  in f32 (bias upcast)
//   v = T(v) if bias is T         the T add's rounding
//   out = act(v)                  stored f32 for an f32 bias, T else.
// The product and the pre-activation sum never reach device memory.  In
// fp16 an accumulator beyond 65504 rounds to Inf, as the unfused mul's
// fp16 output does.
//
// What bounds it: 2*M*N*K operations at 989 TFLOP/s (the bf16 and fp16
// tensor-core peak) against (M*K + K*N)*2 + N*4 + M*N*4 bytes at 3.35
// TB/s.  At BERT-base's FFN-in shape (22528 x 768 x 3072) that is 0.107 ms
// of operations against 0.095 ms of bytes; at LeNet's and word2vec's
// widths both are far under a microsecond and the launch and one or two
// load latencies are the time.
//
// The design: wgmma (m64nNk16, both operands from shared memory, f32
// accumulators in registers) over a ring of shared-memory stages, each 64
// deep in K: x's (BM x 64) tile K-major and w's (64 x BN) tile MN-major
// (wgmma's transpose bit), both in TMA's 128-byte swizzle (csrc/hopper.cuh
// descriptors).  Two feeds fill the same ring:
//   * TMA (mm_tma_kernel), where both tensors can be tensor maps: K and N
//     multiples of 8 (16-byte row strides) and 16-byte-aligned bases.  One
//     producer warp keeps the ring's loads in flight (a full and an empty
//     mbarrier per stage); one or two consumer warpgroups run the wgmmas,
//     keep one stage's products in flight, and hand each stage back as
//     soon as its products are done.  Tiles of 128 x 128 (two
//     warpgroups, 3 stages: two CTAs an SM, so that one's epilogue runs
//     under the other's products) where the grid fills the card, 64 x 64
//     (one, 4 stages) where it does not, so that LeNet's 256-row layers
//     still get 8 CTAs;
//   * cp.async (mm_cpasync_kernel) for every other shape and alignment:
//     the 128 threads copy 16, 8 or 4 bytes a copy, as the row width and
//     the base allow, or element by element, zero-filling past the edges,
//     into the same swizzled tiles; 64 x 64 tiles, 4 stages.
// Which shape takes which variant is decided by the caller
// (paddle_tpu_torch/ops/matmul_epilogue.py:tc_variant).
// The epilogue runs on the accumulator fragments: each thread rounds,
// adds the bias and applies the act to its two neighbouring columns and
// stores them together (8 bytes f32, 4 bytes T), masked at ragged edges.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/matmul_epilogue.py);
// each returns the launch's cudaError_t:
//   paddle_matmul_bias_act_{bf16,fp16}(x, w, bias, out, m, n, k, act,
//                                      bias_low, variant, stream)
// act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (exact erf); bias_low 0:
// bias and out are f32, 1: both are of x's type; variant: see kVariant*.
#include <limits.h>

#include "hopper.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3,
           ACT_GELU = 4 };

// the variants, numbered as matmul_epilogue.py's TC_VARIANTS
enum Variant {
  kVariantCpAsync64 = 0,   // cp.async feed, 64 x 64, 4 stages: any shape
  kVariantTma64 = 1,       // TMA, 64 x 64, 4 stages: grids below the card
  kVariantTma128 = 2,      // TMA, 128 x 128, 3 stages, 2 CTAs an SM
};

constexpr int kBK = 64;          // K of a stage: one 128-byte swizzle atom
constexpr int kRowBytes = 128;   // a 64-wide row of 16-bit values

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_RELU) return v < 0.f ? 0.f : v;
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  if (ACT == ACT_TANH) return tanhf(v);
  if (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
  return v;
}

// conversions of the two operand types
template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ float load(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half store(float v) {
    return __float2half_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Ops<T>::load(Ops<T>::store(v));
}

// one ring stage: x's BM x 64 tile (K-major), then w's 64 x BN tile
// (BN / 64 atoms of 64 rows x 128 bytes, MN-major)
template <int NWG, int BN, int STAGES>
struct Ring {
  static constexpr int kBM = 64 * NWG;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr size_t kSmem =
      (size_t)STAGES * kStageBytes + 2 * STAGES * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (hopper::smem_addr(p) & 1023u)) & 1023u);
}

// acc += A B over one stage: a is the warpgroup's 64 rows of x's tile, b
// w's tile; the products are committed as one group, not waited for
template <typename T, int BN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2],
                                          const uint8_t* a,
                                          const uint8_t* b) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    hopper::wgmma_ss<T, 1>(acc, hopper::desc_kmajor<kBK, 64>(a, kk),
                           hopper::desc_mnmajor<BN, kBK>(b, kk), 1);
  hopper::wgmma_commit();
}

template <typename T, typename TB>
__device__ __forceinline__ float bias_at(const TB* bias, long long col) {
  if constexpr (sizeof(TB) == 2)
    return Ops<T>::load(bias[col]);
  else
    return bias[col];
}

template <typename T, int ACT, bool LOW>
__device__ __forceinline__ float finish(float acc, float b) {
  float v = __fadd_rn(round_to<T>(acc), b);
  if (LOW) v = round_to<T>(v);
  return act_fn<ACT>(v);
}

// The warpgroup's 64 x BN tile at (row0, col0) from its fragments:
// d[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane
// % 4) + e.  Two neighbouring columns are stored together where the row
// width is even (the output is allocated 16-byte aligned).
template <typename T, typename TB, int ACT, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           const TB* __restrict__ bias,
                                           TB* __restrict__ out, long long m,
                                           long long n, long long row0,
                                           long long col0) {
  constexpr bool kLow = sizeof(TB) == 2;
  const int lane = threadIdx.x & 31;
  const long long r0 = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const long long col = col0 + 8 * j + 2 * (lane & 3);
    if (col >= n) break;
    const bool two = col + 1 < n;
    const float b0 = bias_at<T>(bias, col);
    const float b1 = two ? bias_at<T>(bias, col + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r0 + 8 * h;
      if (row >= m) continue;
      const float v0 = finish<T, ACT, kLow>(acc[4 * j + 2 * h], b0);
      const float v1 = finish<T, ACT, kLow>(acc[4 * j + 2 * h + 1], b1);
      TB* p = out + row * n + col;
      if constexpr (kLow) {
        if (pairs) {
          *reinterpret_cast<uint32_t*>(p) = hopper::pack2<T>(v0, v1);
        } else {
          p[0] = Ops<T>::store(v0);
          if (two) p[1] = Ops<T>::store(v1);
        }
      } else {
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (two) p[1] = v1;
        }
      }
    }
  }
}

template <typename T, typename TB, int BN>
__device__ __forceinline__ void epilogue(int act, const float (&acc)[BN / 2],
                                         const TB* bias, TB* out, long long m,
                                         long long n, long long row0,
                                         long long col0) {
  switch (act) {
    case ACT_RELU:
      store_tile<T, TB, ACT_RELU, BN>(acc, bias, out, m, n, row0, col0);
      break;
    case ACT_SIGMOID:
      store_tile<T, TB, ACT_SIGMOID, BN>(acc, bias, out, m, n, row0, col0);
      break;
    case ACT_TANH:
      store_tile<T, TB, ACT_TANH, BN>(acc, bias, out, m, n, row0, col0);
      break;
    case ACT_GELU:
      store_tile<T, TB, ACT_GELU, BN>(acc, bias, out, m, n, row0, col0);
      break;
    default:
      store_tile<T, TB, ACT_NONE, BN>(acc, bias, out, m, n, row0, col0);
  }
}

// ---------------------------------------------------------- the TMA feed
// grid: one CTA per output tile, N tiles fastest (neighbouring CTAs share
// x's rows in L2); block: NWG consumer warpgroups, then the producer warp
template <typename T, typename TB, int NWG, int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(128 * NWG + 32, MINB)
mm_tma_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              const TB* __restrict__ bias, TB* __restrict__ out, long long m,
              long long n, int k, int act, int n_tiles) {
  using namespace hopper;
  using R = Ring<NWG, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * R::kStageBytes);
  uint64_t* empty = full + STAGES;
  const int m_tile = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int nk = (k + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {   // the producer
    if ((threadIdx.x & 31) == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, use = kt / STAGES;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        uint8_t* a = ring + s * R::kStageBytes;
        mbar_expect_tx(&full[s], R::kStageBytes);
        tma_load_3d(a, &tx, &full[s], kt * kBK, m_tile * R::kBM, 0);
#pragma unroll
        for (int at = 0; at < BN / 64; ++at)
          tma_load_3d(a + R::kABytes + at * kBK * kRowBytes, &tw, &full[s],
                      n0 + 64 * at, kt * kBK, 0);
      }
    }
    return;
  }

  const int g = warp >> 2;   // the consumer warpgroup: rows 64 g ..
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* a = ring + s * R::kStageBytes;
    mma_stage<T, BN>(acc, a + g * 64 * kRowBytes, a + R::kABytes);
    wgmma_wait<1>();   // the previous stage's products are done
    fence_regs(acc);
    if (kt > 0 && (threadIdx.x & 31) == 0)
      mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  epilogue<T, TB, BN>(act, acc, bias, out, m, n,
                      (long long)m_tile * R::kBM + 64 * g, n0);
}

// ------------------------------------------------------ the cp.async feed
// The 16-byte chunk of 8 elements at (r, c) of a row-major (rows, cols)
// matrix into shared dst: copies of v elements (cols % v == 0, the base
// aligned to 2 v bytes; v = 1 by ordinary loads), zeros outside.
template <typename T>
__device__ __forceinline__ void fill_chunk(uint8_t* dst, const T* src,
                                           long long rows, long long cols,
                                           long long r, long long c, int v) {
  using hopper::cp_async;
  if (r >= rows || c >= cols) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const T* row = src + r * cols;
  switch (v) {
    case 8:
      cp_async<16>(dst, row + c, 16);
      return;
    case 4:
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool in = c + 4 * i < cols;
        cp_async<8>(dst + 8 * i, in ? row + c + 4 * i : row, in ? 8 : 0);
      }
      return;
    case 2:
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = c + 2 * i < cols;
        cp_async<4>(dst + 4 * i, in ? row + c + 2 * i : row, in ? 4 : 0);
      }
      return;
    default: {
      const uint16_t* bits = reinterpret_cast<const uint16_t*>(row);
      uint32_t pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = c + 2 * i < cols ? __ldg(bits + c + 2 * i) : 0u;
        const uint32_t hi =
            c + 2 * i + 1 < cols ? __ldg(bits + c + 2 * i + 1) : 0u;
        pk[i] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
  }
}

constexpr int kCpStages = 4;
using CpRing = Ring<1, 64, kCpStages>;

// K slice kt of the tile at (m0, n0) into stage `st`: 512 chunks of x's
// 64 x 64 and 512 of w's 64 x 64, four of each a thread, in swizzled order
template <typename T>
__device__ __forceinline__ void cp_stage(uint8_t* st, const T* x, const T* w,
                                         long long m, long long n, long long k,
                                         long long m0, long long n0, int kt,
                                         int vx, int vw) {
  const long long k0 = (long long)kt * kBK;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = threadIdx.x + 128 * q;
    const int r = idx >> 3, ch = idx & 7;
    const int off = r * kRowBytes + ((ch ^ (r & 7)) << 4);
    fill_chunk(st + off, x, m, k, m0 + r, k0 + 8 * ch, vx);
    fill_chunk(st + CpRing::kABytes + off, w, k, n, k0 + r, n0 + 8 * ch, vw);
  }
}

template <typename T, typename TB>
__global__ void __launch_bounds__(128)
mm_cpasync_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const TB* __restrict__ bias, TB* __restrict__ out,
                  long long m, long long n, long long k, int vx, int vw,
                  int act, int n_tiles) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  const long long m0 = (long long)(blockIdx.x / n_tiles) * 64;
  const long long n0 = (long long)(blockIdx.x % n_tiles) * 64;
  const int nk = (int)((k + kBK - 1) / kBK);

#pragma unroll
  for (int s = 0; s < kCpStages - 1; ++s) {
    if (s < nk)
      cp_stage(ring + s * CpRing::kStageBytes, x, w, m, n, k, m0, n0, s, vx,
               vw);
    cp_async_commit();
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kCpStages - 2>();   // this thread's copies of stage kt
    fence_async_smem();               // visible to wgmma's reads
    __syncthreads();                  // everyone's, and stage kt - 1 free
    const uint8_t* st = ring + (kt % kCpStages) * CpRing::kStageBytes;
    mma_stage<T, 64>(acc, st, st + CpRing::kABytes);
    const int next = kt + kCpStages - 1;
    if (next < nk)
      cp_stage(ring + (next % kCpStages) * CpRing::kStageBytes, x, w, m, n, k,
               m0, n0, next, vx, vw);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  epilogue<T, TB, 64>(act, acc, bias, out, m, n, m0, n0);
}

// ------------------------------------------------------------------ host
bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// the widest copy (elements) a row-major matrix of `cols` columns allows
int copy_width(const void* base, long long cols) {
  for (int v = 8; v > 1; v /= 2)
    if (cols % v == 0 && aligned(base, 2 * v)) return v;
  return 1;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return hopper::kIsBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, typename TB, int NWG, int BN, int STAGES, int MINB>
cudaError_t launch_tma(const void* x, const void* w, const void* bias,
                       void* out, long long m, long long n, long long k,
                       int act, cudaStream_t stream) {
  using R = Ring<NWG, BN, STAGES>;
  CUtensorMap tx, tw;
  cudaError_t err = hopper::encode_3d(&tx, x, tma_type<T>(), k, m, 1, kBK,
                                      R::kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::encode_3d(&tw, w, tma_type<T>(), n, k, 1, 64, kBK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(mm_tma_kernel<T, TB, NWG, BN, STAGES, MINB>,
                        R::kSmem)) != cudaSuccess)
    return err;
  const long long n_tiles = (n + BN - 1) / BN;
  const long long tiles = (m + R::kBM - 1) / R::kBM * n_tiles;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  mm_tma_kernel<T, TB, NWG, BN, STAGES, MINB>
      <<<(unsigned)tiles, 128 * NWG + 32, R::kSmem, stream>>>(
      tx, tw, static_cast<const TB*>(bias), static_cast<TB*>(out), m, n,
      (int)k, act, (int)n_tiles);
  return cudaGetLastError();
}

template <typename T, typename TB>
cudaError_t launch_cpasync(const void* x, const void* w, const void* bias,
                           void* out, long long m, long long n, long long k,
                           int act, cudaStream_t stream) {
  cudaError_t err = allow_smem(mm_cpasync_kernel<T, TB>, CpRing::kSmem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n + 63) / 64;
  const long long tiles = (m + 63) / 64 * n_tiles;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  mm_cpasync_kernel<T, TB><<<(unsigned)tiles, 128, CpRing::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const TB*>(bias), static_cast<TB*>(out), m, n, k,
      copy_width(x, k), copy_width(w, n), act, (int)n_tiles);
  return cudaGetLastError();
}

template <typename T, typename TB>
cudaError_t dispatch(int variant, const void* x, const void* w,
                     const void* bias, void* out, long long m, long long n,
                     long long k, int act, cudaStream_t stream) {
  switch (variant) {
    case kVariantCpAsync64:
      return launch_cpasync<T, TB>(x, w, bias, out, m, n, k, act, stream);
    case kVariantTma64:
      return launch_tma<T, TB, 1, 64, 4, 1>(x, w, bias, out, m, n, k, act,
                                            stream);
    case kVariantTma128:
      return launch_tma<T, TB, 2, 128, 3, 2>(x, w, bias, out, m, n, k, act,
                                             stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int entry(const void* x, const void* w, const void* bias, void* out,
          long long m, long long n, long long k, int act, int bias_low,
          int variant, void* stream_ptr) {
  if (m <= 0 || n <= 0 || k <= 0 || m > INT_MAX || n > INT_MAX ||
      k > INT_MAX || act < ACT_NONE || act > ACT_GELU)
    return (int)cudaErrorInvalidValue;
  // a tensor map needs 16-byte row strides and a 16-byte-aligned base
  const bool tma = k % 8 == 0 && n % 8 == 0 && aligned(x, 16) &&
                   aligned(w, 16);
  if (variant != kVariantCpAsync64 && !tma) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bias_low)
    return (int)dispatch<T, T>(variant, x, w, bias, out, m, n, k, act,
                               stream);
  return (int)dispatch<T, float>(variant, x, w, bias, out, m, n, k, act,
                                 stream);
}

}  // namespace

extern "C" int paddle_matmul_bias_act_bf16(const void* x, const void* w,
                                           const void* bias, void* out,
                                           long long m, long long n,
                                           long long k, int act,
                                           int bias_low, int variant,
                                           void* stream_ptr) {
  return entry<__nv_bfloat16>(x, w, bias, out, m, n, k, act, bias_low,
                              variant, stream_ptr);
}

extern "C" int paddle_matmul_bias_act_fp16(const void* x, const void* w,
                                           const void* bias, void* out,
                                           long long m, long long n,
                                           long long k, int act,
                                           int bias_low, int variant,
                                           void* stream_ptr) {
  return entry<__half>(x, w, bias, out, m, n, k, act, bias_low, variant,
                       stream_ptr);
}
