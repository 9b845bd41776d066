// The fc epilogue of a fused matmul -> bias -> activation chain, float32,
// for Hopper (sm_90a).
//
// Replaces _matmul_bias_act_kernel (paddle_tpu/ops/pallas_kernels.py:1186,
// launched by matmul_bias_act :1207):
//   out = act(x @ w + bias),  x (M, K), w (K, N), bias (N,), row-major.
// As in the TPU kernel, the bias and the activation are applied to the f32
// accumulator in registers before the one store of each output element:
// neither the product x @ w nor the pre-activation sum ever reaches device
// memory.
//
// What bounds it: 2*M*N*K f32 operations against (M*K + K*N + N + M*N)*4
// bytes.  At BERT-base's FFN-in shape (22528 x 768 x 3072) that is 106
// GFLOP, 1.59 ms at the H100's 67 TFLOP/s f32 rate outside the tensor cores
// (no TF32 here), against 0.11 ms of bytes at 3.35 TB/s: operations.  At
// LeNet's fc layers (M 256; K 400 / 120; N 120 / 84) both bounds are under
// half a microsecond, and the launch and the K loop's load latency are the
// time.
//
// The design (the first kernel: right, simple, not yet fast):
//   * one CTA of 256 threads per 64 x 64 output tile; each thread keeps a
//     4 x 4 block of accumulators in registers, at rows ty + 16*i and
//     columns tx + 16*j (tx = tid % 16, ty = tid / 16), so a warp's
//     shared-memory reads are broadcasts (x) or 16 neighbouring words (w),
//     and its stores cover 16 neighbouring columns;
//   * a loop over K inside the CTA, 16 deep per step, takes the place of
//     the TPU's sequential k grid axis and its acc_scr VMEM scratch: the x
//     slice (stored transposed, rows padded by one word against bank
//     conflicts) and the w slice are staged in shared memory;
//   * loads are masked with zero fill and the store is masked at the ragged
//     M, N and K edges, so any M, N, K >= 1 runs: the TPU's block ladders
//     (_pick_div over 512/256/128/8) and its fallback have no counterpart;
//   * full f32 FMAs (fmaf), no TF32 and no fast-math; the activations are
//     csrc/bn_act.cu's: relu, sigmoid as 1 / (1 + expf(-v)), tanhf and
//     exact-erf gelu.
// wgmma, TMA and a multistage ring of tiles are later work.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/matmul_epilogue.py);
// returns the launch's cudaError_t:
//   paddle_matmul_bias_act_f32(x, w, bias, out, m, n, k, act, stream)
// act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (exact erf).
#include <cuda_runtime.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3,
           ACT_GELU = 4 };

constexpr int kBM = 64;        // output rows per CTA
constexpr int kBN = 64;        // output columns per CTA
constexpr int kBK = 16;        // depth of one K step
constexpr int kThreads = 256;
constexpr int kLanes = 16;     // threads along each side of the CTA tile
constexpr int kTM = kBM / kLanes;   // accumulator rows per thread
constexpr int kTN = kBN / kLanes;   // accumulator columns per thread

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_RELU) return v < 0.f ? 0.f : v;
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  if (ACT == ACT_TANH) return tanhf(v);
  if (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
  return v;
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
matmul_bias_act_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, long long m, long long n,
                       long long k) {
  __shared__ float xs[kBK][kBM + 1];   // x slice, transposed: xs[kk][row]
  __shared__ float ws[kBK][kBN];       // w slice: ws[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % kLanes, ty = tid / kLanes;
  const long long m0 = (long long)blockIdx.x * kBM;
  const long long n0 = (long long)blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < k; k0 += kBK) {
    // 64 x 16 of x: 16 neighbouring threads read 16 neighbouring words
#pragma unroll
    for (int e = 0; e < kBM * kBK / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const long long gr = m0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? x[gr * k + gc] : 0.f;
    }
    // 16 x 64 of w: 64 neighbouring threads read one row's 64 words
#pragma unroll
    for (int e = 0; e < kBK * kBN / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const long long gr = k0 + r, gc = n0 + c;
      ws[r][c] = (gr < k && gc < n) ? w[gr * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + kLanes * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + kLanes * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the epilogue, on the accumulators: + bias, act, one store
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const long long col = n0 + tx + kLanes * j;
    if (col >= n) continue;
    const float bv = __ldg(bias + col);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const long long row = m0 + ty + kLanes * i;
      if (row < m) out[row * n + col] = act_fn<ACT>(__fadd_rn(acc[i][j], bv));
    }
  }
}

template <int ACT>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, long long m, long long n, long long k,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((n + kBN - 1) / kBN));
  matmul_bias_act_kernel<ACT><<<grid, kThreads, 0, stream>>>(x, w, bias, out,
                                                             m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paddle_matmul_bias_act_f32(const float* x, const float* w,
                                          const float* bias, float* out,
                                          long long m, long long n,
                                          long long k, int act,
                                          void* stream_ptr) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  // grid.x holds the row tiles (up to 2^31 - 1), grid.y the column tiles
  if ((m + kBM - 1) / kBM > 2147483647LL || (n + kBN - 1) / kBN > 65535LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (act) {
    case ACT_NONE:
      return (int)launch<ACT_NONE>(x, w, bias, out, m, n, k, stream);
    case ACT_RELU:
      return (int)launch<ACT_RELU>(x, w, bias, out, m, n, k, stream);
    case ACT_SIGMOID:
      return (int)launch<ACT_SIGMOID>(x, w, bias, out, m, n, k, stream);
    case ACT_TANH:
      return (int)launch<ACT_TANH>(x, w, bias, out, m, n, k, stream);
    case ACT_GELU:
      return (int)launch<ACT_GELU>(x, w, bias, out, m, n, k, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
