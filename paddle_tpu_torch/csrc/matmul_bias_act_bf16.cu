// The fc epilogue of a fused matmul -> bias -> activation chain on bf16
// operands, for Hopper (sm_90a), on the tensor cores.
//
// Replaces the bf16 variant of _matmul_bias_act_kernel
// (paddle_tpu/ops/pallas_kernels.py:1186, launched by matmul_bias_act
// :1207):  out = act(x @ w + bias),  x (M, K) and w (K, N) bf16, row-major,
// bias (N,) f32 or bf16, f32 accumulation.
//
// Rounding follows the static AMP program, not the Pallas kernel.  In a
// rewritten program the chain is mul (bf16 x bf16 -> bf16) ->
// elementwise_add (bf16 + f32 bias -> f32, as jnp promotes) -> act, and
// the JAX package's own fallback (_matmul_bias_act_jnp, fused_ops.py:577)
// computes exactly that; its Pallas kernel instead adds the bias to the
// unrounded f32 accumulator and stores bf16 (result_type(x, w)).  Fusion
// must not change numerics (fused_ops.py:422-423), so here:
//   v = bf16(acc)                 the mul's bf16 output
//   v = v + bias                  in f32 (bias upcast)
//   v = bf16(v) if bias is bf16   the bf16 add's rounding
//   out = act(v)                  stored f32 for an f32 bias, bf16 else.
// The product and the pre-activation sum never reach device memory.
//
// What bounds it: 2*M*N*K operations at 989 TFLOP/s (bf16 tensor cores)
// against (M*K + K*N)*2 + N*4 + M*N*4 bytes at 3.35 TB/s.  At BERT-base's
// FFN-in shape (22528 x 768 x 3072) that is 0.107 ms of operations against
// 0.095 ms of bytes; at LeNet's and word2vec's widths both are far under
// a microsecond and the launch is the time.
//
// The design (the first tensor-core kernel: right and simple, not fast):
//   * one CTA of 4 warps per 64 x 64 output tile, each warp a 32 x 32
//     quarter: 2 x 4 mma.sync.m16n8k16 (bf16 in, f32 accumulators in
//     registers) per 16 of K;
//   * a loop over K, 32 deep per step, stages the x slice (64 x 32) and the
//     w slice (32 x 64) in shared memory, rows padded by 16 bytes against
//     bank conflicts; fragments come from ldmatrix (x4 for A, x4.trans for
//     B, whose rows are K);
//   * 16-byte loads where a row's 8 elements are in bounds and aligned,
//     zero-filled scalar loads at the ragged M, N and K edges, masked
//     stores: any M, N, K >= 1;
//   * no software pipelining, no TMA, no wgmma: later work.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/matmul_epilogue.py);
// returns the launch's cudaError_t:
//   paddle_matmul_bias_act_bf16(x, w, bias, out, m, n, k, act, bias_bf16,
//                               stream)
// act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (exact erf); bias_bf16 0:
// bias and out are f32, 1: both are bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3,
           ACT_GELU = 4 };

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kPadA = kBK + 8;   // 80-byte rows
constexpr int kPadB = kBN + 8;   // 144-byte rows

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_RELU) return v < 0.f ? 0.f : v;
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  if (ACT == ACT_TANH) return tanhf(v);
  if (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one 8-element (16-byte) chunk of a row-major (rows x cols) matrix at
// (r, c) into shared memory, zero-filled outside it
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long rows, long long cols,
                                           long long r, long long c,
                                           bool vec_ok) {
  if (r < rows && vec_ok && c + 8 <= cols) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + r * cols + c);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = (r < rows && c + e < cols) ? src[r * cols + c + e]
                                        : __float2bfloat16_rn(0.f);
  }
}

template <int ACT, typename TB>
__global__ void __launch_bounds__(kThreads)
matmul_bias_act_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const TB* __restrict__ bias, TB* __restrict__ out,
                            long long m, long long n, long long k,
                            bool x_vec, bool w_vec) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kPadA];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK][kPadB];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;   // the warp's rows in the tile
  const int wn = (warp & 1) * 32;    // and columns
  const long long m0 = (long long)blockIdx.x * kBM;
  const long long n0 = (long long)blockIdx.y * kBN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (long long k0 = 0; k0 < k; k0 += kBK) {
    // 256 chunks of 8 for each slice, two per thread
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = tid + t * kThreads;
      const int ar = c >> 2, ac = (c & 3) * 8;      // A: 64 rows x 4 chunks
      load_chunk(&As[ar][ac], x, m, k, m0 + ar, k0 + ac, x_vec);
      const int br = c >> 3, bc = (c & 7) * 8;      // B: 32 rows x 8 chunks
      load_chunk(&Bs[br][bc], w, k, n, k0 + br, n0 + bc, w_vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &As[wm + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[kk + (lane & 15)][wn + p * 16 + (lane >> 4) * 8]);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue on the accumulators: c0, c1 at (group, 2*tig + {0, 1}),
  // c2, c3 eight rows further down
  const int group = lane >> 2, tig = lane & 3;
  constexpr bool kLowOut = sizeof(TB) == 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + wm + i * 16 + group + (e >> 1) * 8;
        const long long col = n0 + wn + j * 8 + tig * 2 + (e & 1);
        if (row >= m || col >= n) continue;
        float v = round_bf16(acc[i][j][e]);
        float bv;
        if constexpr (kLowOut) {
          bv = __bfloat162float(bias[col]);
        } else {
          bv = bias[col];
        }
        v = __fadd_rn(v, bv);
        if (kLowOut) v = round_bf16(v);
        v = act_fn<ACT>(v);
        if constexpr (kLowOut) {
          out[row * n + col] = __float2bfloat16_rn(v);
        } else {
          out[row * n + col] = v;
        }
      }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int ACT, typename TB>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   long long m, long long n, long long k,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((n + kBN - 1) / kBN));
  matmul_bias_act_bf16_kernel<ACT, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const TB*>(bias),
      static_cast<TB*>(out), m, n, k, k % 8 == 0 && aligned16(x),
      n % 8 == 0 && aligned16(w));
  return cudaGetLastError();
}

template <typename TB>
cudaError_t dispatch(int act, const void* x, const void* w, const void* bias,
                     void* out, long long m, long long n, long long k,
                     cudaStream_t stream) {
  switch (act) {
    case ACT_NONE: return launch<ACT_NONE, TB>(x, w, bias, out, m, n, k, stream);
    case ACT_RELU: return launch<ACT_RELU, TB>(x, w, bias, out, m, n, k, stream);
    case ACT_SIGMOID:
      return launch<ACT_SIGMOID, TB>(x, w, bias, out, m, n, k, stream);
    case ACT_TANH: return launch<ACT_TANH, TB>(x, w, bias, out, m, n, k, stream);
    case ACT_GELU: return launch<ACT_GELU, TB>(x, w, bias, out, m, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paddle_matmul_bias_act_bf16(const void* x, const void* w,
                                           const void* bias, void* out,
                                           long long m, long long n,
                                           long long k, int act,
                                           int bias_bf16, void* stream_ptr) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  // grid.x holds the row tiles (up to 2^31 - 1), grid.y the column tiles
  if ((m + kBM - 1) / kBM > 2147483647LL || (n + kBN - 1) / kBN > 65535LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bias_bf16)
    return (int)dispatch<__nv_bfloat16>(act, x, w, bias, out, m, n, k, stream);
  return (int)dispatch<float>(act, x, w, bias, out, m, n, k, stream);
}
