// The fc epilogue of a fused matmul -> bias -> activation chain, float32,
// for Hopper (sm_90a).
//
// Replaces _matmul_bias_act_kernel (paddle_tpu/ops/pallas_kernels.py:1186,
// launched by matmul_bias_act :1207):
//   out = act(x @ w + bias),  x (M, K), w (K, N), bias (N,), row-major.
// As in the TPU kernel, the bias and the activation are applied to the f32
// accumulator in registers before the one store of each output element:
// neither the product x @ w nor the pre-activation sum ever reaches device
// memory.  Every output is one chain of full f32 FMAs (fmaf) over k in
// increasing order, then __fadd_rn(acc, bias), then the act: no TF32, no
// split-K, so the result does not depend on the tile and is bit-identical
// from run to run.
//
// What bounds it: 2*M*N*K f32 operations against (M*K + K*N + N + M*N)*4
// bytes.  At BERT-base's FFN-in shape (22528 x 768 x 3072) that is 106.3
// GFLOP, 1.587 ms at the H100's 67 TFLOP/s f32 rate outside the tensor
// cores, against 0.11 ms of bytes at 3.35 TB/s: operations.  At LeNet's fc
// layers (M 256; K 400 / 120; N 120 / 84) both bounds are under half a
// microsecond: there the K loop's chain of load latencies is the time.
//
// What the first kernel (one 64 x 64 tile a CTA, one shared-memory buffer,
// scalar shared-memory reads: 4.884 ms at FFN-in, 21.8 TFLOP/s, and 0.0944
// ms a LeNet step) lost, and what this design does about it:
//   * shared memory capped its loop near half the FMA rate (8 LDS.32 for 16
//     FMAs a thread and k).  Here each thread holds a (QM*4) x (QN*4) block
//     of accumulators, 2 x 2 quadrants of 4 x 4 at the 128 x 128 tile; the
//     lanes of a warp sit 4 (rows) x 8 (columns) over its sub-tile, so every
//     operand read is a 16-byte LDS.128 that is at most one 128-byte
//     wavefront (the lanes of a row share an address and broadcast): 4
//     wavefronts for 64 FFMAs a warp and k at 128 x 128.  The loop over the
//     stage's k is unrolled, so the compiler issues the next k's fragments
//     under the current k's FMAs.
//   * every K step waited out a global-load latency.  Here a ring of STAGES
//     shared-memory stages is fed by cp.async (hopper.cuh), STAGES - 1 of
//     them in flight, one __syncthreads a stage.  x is stored k-major
//     (As[k][row], rows padded by 4 words: the copies' 4-byte writes of 8
//     neighbouring k fall in distinct banks, and the 16-byte reads stay
//     aligned), written by 4-byte cp.async copies that transpose it on the
//     way, so x needs no alignment.  (A row-major x tile read along k
//     behind a swizzle was not built: its fragments take 32 registers more
//     a thread, over the 128-register cap of two CTAs an SM.)  w is stored as
//     it lies (Bs[k][col]), by 16-byte copies where N is a multiple of 4
//     and w starts 16-byte aligned, else by 4-byte copies (N = 263, a
//     misaligned view); the host picks (matmul_epilogue.f32_variant).
//     Each thread copies at one k offset and column, so its source
//     pointers advance by a constant a stage, and a stage wholly inside M,
//     N and K is copied without predicates (at 4 stages of BK 16: 2.296
//     ms at FFN-in against 2.434 with them); copies past the ragged edges
//     are zero-filled.
//   * at LeNet's M 256 the 64 x 64 tile gave 8 CTAs that each waited out
//     25 load latencies in a row.  Grids that 128 x 128 tiles would not
//     fill take 32 x 64 tiles (128 threads, BK 32, 4 stages): 16 CTAs at
//     lenet-fc1, each with 96 of its 400 k in flight from its start.
//   * CTAs walk the output tiles column tile first (a 1-D grid), so the
//     CTAs in flight share their x row tiles and w stays in the L2: at
//     FFN-in, x (69 MB) is read from device memory about once.
// Variants (tile, w copy width), numbered as f32_variant names them; the
// tiles chosen with tools/sweep_matmul_tc.py --dtype float32 (PERF.md
// section 6, which also lists the tiles that lost):
//   0 / 1: 128 x 128, 256 threads, BK 16, 3 stages, two CTAs an SM; 16- /
//          4-byte w copies (grids that fill the SMs);
//   2 / 3: 32 x 64, 128 threads, BK 32, 4 stages (smaller grids).
// Measured (chip_smoke.py phase 13; H100 80GB HBM3, 700 W, CUDA-graph
// replay, cold L2): FFN-in 2.246 ms, 47.3 TFLOP/s, 71% of the bound
// (addmm + gelu 2.357); lenet-fc1 0.0121, lenet-fc2 0.0050, word2vec
// 0.0049, ragged 0.0271 (64 x 64 tiles, also built and timed, won only
// there, by 0.4-5%, and were slower at the LeNet shapes).
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/matmul_epilogue.py);
// returns the launch's cudaError_t:
//   paddle_matmul_bias_act_f32(x, w, bias, out, m, n, k, act, variant,
//                              stream)
// act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (exact erf).
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3,
           ACT_GELU = 4 };

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_RELU) return v < 0.f ? 0.f : v;
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  if (ACT == ACT_TANH) return tanhf(v);
  if (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
  return v;
}

// BM x BN outputs a CTA, BK deep stages, WM x WN warps, at least MINB
// CTAs an SM
template <int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_, MINB = MINB_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's sub-tile
  static constexpr int QM = WTM / 16, QN = WTN / 32;   // 4 x 4 quadrants
  static constexpr int AW = BM + 4;                    // As row, in words
  static_assert(QM >= 1 && QN >= 1 && WTM % 16 == 0 && WTN % 32 == 0,
                "a lane holds whole 4 x 4 quadrants");
  static_assert(kThreads % BK == 0 && kThreads % (BN / 4) == 0 &&
                    (BM * BK) % kThreads == 0 && (BK * BN / 4) % kThreads == 0,
                "every thread copies the same count, at one k and column");
  static constexpr int kSmemBytes =
      STAGES * BK * (AW + BN) * (int)sizeof(float);
};

template <class TL, bool W16, int ACT>
__global__ void __launch_bounds__(TL::kThreads, TL::MINB)
matmul_bias_act_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, long long m, long long n,
                       long long k, long long n_tiles) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, S = TL::STAGES;
  constexpr int T = TL::kThreads, QM = TL::QM, QN = TL::QN, AW = TL::AW;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // [S][BK][AW]: x, k-major
  float* Bs = smem + S * BK * AW;    // [S][BK][BN]: w, as it lies

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / TL::WN, wn = warp % TL::WN;
  const int lr = lane / 8, lc = lane % 8;
  // column tiles first: the CTAs in flight share x's row tiles
  const long long tile = blockIdx.x;
  const long long m0 = (tile / n_tiles) * BM;
  const long long n0 = (tile % n_tiles) * BN;
  const int k_tiles = (int)((k + BK - 1) / BK);

  // what each thread copies, fixed across stages: x at one k offset (a
  // warp reads whole row segments) of rows a_row + i * A_STEP, stored
  // transposed; w (16-byte copies) at one column chunk of k rows b_k + i
  // * B_STEP, or (4-byte copies) at one column of k rows b_k + i * B_STEP
  constexpr int A_N = BM * BK / T, A_STEP = T / BK;
  const int a_kk = tid % BK, a_row = tid / BK;
  constexpr int B_CH = W16 ? BN / 4 : BN;        // copies a w row
  constexpr int B_N = BK * B_CH / T, B_STEP = T / B_CH;
  const int b_col = (tid % B_CH) * (W16 ? 4 : 1), b_k = tid / B_CH;
  const float* xa = x + (m0 + a_row) * k + a_kk;
  const float* wb = w + (long long)b_k * n + n0 + b_col;
  unsigned a_rows_ok = 0;   // bit i: row a_row + i * A_STEP lies inside M
#pragma unroll
  for (int i = 0; i < A_N; ++i)
    if (m0 + a_row + i * A_STEP < m) a_rows_ok |= 1u << i;
  static_assert(A_N <= 32, "row mask");
  const bool b_col_ok = n0 + b_col < n;

  const long long a_stride = (long long)A_STEP * k;   // x, between copies
  const long long b_stride = (long long)B_STEP * n;   // w, between copies
  // a tile wholly inside M and N copies its whole stages unpredicated
  const bool tile_full = m0 + BM <= m && n0 + BN <= n;
  constexpr int B_BYTES = W16 ? 16 : 4;

  auto load_stage = [&](int slot, int kt) {
    const long long k0 = (long long)kt * BK;
    float* as = As + (slot * BK + a_kk) * AW + a_row;
    float* bs = Bs + (slot * BK + b_k) * BN + b_col;
    const float* xk = xa + k0;
    const float* wk = wb + k0 * n;
    if (tile_full && k0 + BK <= k) {
#pragma unroll
      for (int i = 0; i < A_N; ++i)
        hopper::cp_async<4>(as + i * A_STEP, xk + i * a_stride, 4u);
#pragma unroll
      for (int i = 0; i < B_N; ++i)
        hopper::cp_async<B_BYTES>(bs + i * B_STEP * BN, wk + i * b_stride,
                                  (unsigned)B_BYTES);
      return;
    }
    const bool a_k_ok = k0 + a_kk < k;
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const bool ok = a_k_ok && (a_rows_ok >> i & 1u);
      hopper::cp_async<4>(as + i * A_STEP, ok ? xk + i * a_stride : x,
                          ok ? 4u : 0u);
    }
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      // N % 4 == 0 for 16-byte copies: a chunk lies wholly inside N or
      // wholly past it
      const bool ok = b_col_ok && k0 + b_k + i * B_STEP < k;
      hopper::cp_async<B_BYTES>(bs + i * B_STEP * BN,
                                ok ? wk + i * b_stride : w,
                                ok ? (unsigned)B_BYTES : 0u);
    }
  };

  float acc[QM * 4][QN * 4];
#pragma unroll
  for (int i = 0; i < QM * 4; ++i)
#pragma unroll
    for (int j = 0; j < QN * 4; ++j) acc[i][j] = 0.f;

  // the ring: S - 1 stages in flight before the first FMA
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    hopper::cp_async_commit();
  }

  const int a_off = wm * TL::WTM + lr * 4;   // + 16 qm
  const int b_off = wn * TL::WTN + lc * 4;   // + 32 qn
  for (int kt = 0; kt < k_tiles; ++kt) {
    // stage kt has landed (one group a stage; S - 2 later ones may fly),
    // and every thread is past stage kt - 1, whose slot is refilled next
    hopper::cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < k_tiles) load_stage((kt + S - 1) % S, kt + S - 1);
    hopper::cp_async_commit();
    const float* as = As + (kt % S) * BK * AW + a_off;
    const float* bs = Bs + (kt % S) * BK * BN + b_off;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[QM * 4], b[QN * 4];
#pragma unroll
      for (int qm = 0; qm < QM; ++qm) {
        const float4 t =
            *reinterpret_cast<const float4*>(as + kk * AW + 16 * qm);
        a[4 * qm] = t.x;
        a[4 * qm + 1] = t.y;
        a[4 * qm + 2] = t.z;
        a[4 * qm + 3] = t.w;
      }
#pragma unroll
      for (int qn = 0; qn < QN; ++qn) {
        const float4 t =
            *reinterpret_cast<const float4*>(bs + kk * BN + 32 * qn);
        b[4 * qn] = t.x;
        b[4 * qn + 1] = t.y;
        b[4 * qn + 2] = t.z;
        b[4 * qn + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < QM * 4; ++i)
#pragma unroll
        for (int j = 0; j < QN * 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  hopper::cp_async_wait<0>();

  // the epilogue, on the accumulators: + bias, act, one store; a lane's 4
  // neighbouring columns go out as one 16-byte store where N % 4 == 0 (out
  // is the wrapper's own, 16-byte aligned)
  const bool vec = (n & 3) == 0;
#pragma unroll
  for (int qn = 0; qn < QN; ++qn) {
    const long long c0 = n0 + b_off + 32 * qn;
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = c0 + j < n ? __ldg(bias + c0 + j) : 0.f;
#pragma unroll
    for (int i = 0; i < QM * 4; ++i) {
      const long long row = m0 + a_off + 16 * (i / 4) + i % 4;
      if (row >= m) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = act_fn<ACT>(__fadd_rn(acc[i][4 * qn + j], bv[j]));
      float* dst = out + row * n + c0;
      if (vec && c0 + 3 < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < n) dst[j] = v[j];
      }
    }
  }
}

template <class TL, bool W16, int ACT>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, long long m, long long n, long long k,
                   cudaStream_t stream) {
  const long long m_tiles = (m + TL::BM - 1) / TL::BM;
  const long long n_tiles = (n + TL::BN - 1) / TL::BN;
  if (m_tiles * n_tiles > 2147483647LL) return cudaErrorInvalidValue;
  auto kernel = matmul_bias_act_kernel<TL, W16, ACT>;
  if (TL::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)(m_tiles * n_tiles), TL::kThreads, TL::kSmemBytes,
           stream>>>(x, w, bias, out, m, n, k, n_tiles);
  return cudaGetLastError();
}

template <class TL, bool W16>
cudaError_t launch_act(int act, const float* x, const float* w,
                       const float* bias, float* out, long long m, long long n,
                       long long k, cudaStream_t stream) {
  switch (act) {
    case ACT_NONE:
      return launch<TL, W16, ACT_NONE>(x, w, bias, out, m, n, k, stream);
    case ACT_RELU:
      return launch<TL, W16, ACT_RELU>(x, w, bias, out, m, n, k, stream);
    case ACT_SIGMOID:
      return launch<TL, W16, ACT_SIGMOID>(x, w, bias, out, m, n, k, stream);
    case ACT_TANH:
      return launch<TL, W16, ACT_TANH>(x, w, bias, out, m, n, k, stream);
    case ACT_GELU:
      return launch<TL, W16, ACT_GELU>(x, w, bias, out, m, n, k, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the tiles, in the order of the variants' numbers
using Tile128 = Tile<128, 128, 16, 3, 4, 2, 2>;
using Tile32x64 = Tile<32, 64, 32, 4, 2, 2, 4>;

}  // namespace

extern "C" int paddle_matmul_bias_act_f32(const float* x, const float* w,
                                          const float* bias, float* out,
                                          long long m, long long n,
                                          long long k, int act, int variant,
                                          void* stream_ptr) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  // 16-byte w copies need 16-byte rows and base
  const bool w16 = variant % 2 == 0;
  if (w16 && (n % 4 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
#define MBA_TILE(I, TL)                                                      \
  case 2 * I:                                                                \
    e = launch_act<TL, true>(act, x, w, bias, out, m, n, k, s);              \
    break;                                                                   \
  case 2 * I + 1:                                                            \
    e = launch_act<TL, false>(act, x, w, bias, out, m, n, k, s);             \
    break;
  switch (variant) {
    MBA_TILE(0, Tile128)
    MBA_TILE(1, Tile32x64)
    default:
      e = cudaErrorInvalidValue;
  }
#undef MBA_TILE
  return (int)e;
}
