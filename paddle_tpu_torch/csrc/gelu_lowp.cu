// Exact-erf GELU on bfloat16 and float16 tensors, forward and backward,
// for Hopper (sm_90a), rounding where the JAX package's compiled lowering
// rounds.
//
// Replaces no Pallas kernel: the JAX package computes a low-precision gelu
// with jax.nn.gelu(approximate=False) (paddle_tpu/ops/math_ops.py, the
// "gelu" activation), which XLA fuses into one elementwise loop.  Its
// compiled form on the CPU keeps these roundings (read from the compiled
// HLO's surviving converts, and checked against jax.jit on 4,000 inputs
// a dtype, tests/test_torch_amp.py).  bf16:
//   forward:  u  = -x * 0.70703125            (f32, sqrt(1/2) in bf16)
//             e  = bf16(erfc(u))              (XLA's f32 erfc)
//             y  = bf16(bf16(0.5 * x) * e)
//   backward: every op of jax.vjp rounds to bf16:
//             r2 = bf16(bf16(0.5 x) * dy);  r3 = bf16(r2 * -1.125)
//             ee = bf16(exp(bf16(-bf16(bf16(u)^2))))
//             t1 = bf16(-bf16(bf16(r3 * ee) * 0.70703125))
//             t2 = bf16(bf16(dy * e) * 0.5);   dx = bf16(t1 + t2)
// and the CPU flushes subnormal results (and reads subnormal inputs) as
// zero.  fp16 (2/sqrt(pi) rounds to 1.1279296875, sqrt(1/2) to the same
// 0.70703125):
//   forward:  u  = fp16(-x * 0.70703125);  e = fp16(erfc(u))
//             y  = fp16(fp16(0.5 * x) * e)
//   backward: r2 = fp16(fp16(0.5 x) * dy);  r3 = fp16(r2 * -1.1279296875)
//             ee = fp16(exp(-fp16(u * u)));  m3 = fp16(r3 * ee)
//             t2 = fp16(fp16(dy * e) * 0.5);  dx = fp16(t2 - m3 * 0.70703125)
// (m3 * 0.70703125 is exact in f32, so XLA's one unrounded product there
// is no rounding), with fp16 subnormals kept, as XLA's CPU keeps them.
// The plain versions (paddle_tpu_torch/ops/gelu.py) spell the same ops out
// in PyTorch; these kernels do them in one pass, with __fmul_rn /
// __fadd_rn so nvcc does not contract them into FMAs, __frcp_rn for 1/v
// (the correctly rounded reciprocal, the value of an IEEE 1/v), expf (not
// __expf), and the same explicit flushes, so on the card they equal the
// plain versions bit for bit.
//
// What bounds them: bytes (2 bytes read and 2 written per element
// forward, 4 read and 2 written backward, against about 40 flops).  A
// grid-stride loop, 8 elements (16 bytes) per thread and access where
// aligned.
//
// C interface (ctypes, paddle_tpu_torch/ops/gelu.py); each returns the
// launch's cudaError_t:
//   paddle_gelu_fwd_{bf16,fp16}(x, y, n, stream)
//   paddle_gelu_bwd_{bf16,fp16}(x, dy, dx, n, stream)
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr float kFltMin = 1.17549435082228750797e-38f;

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) >= kFltMin ? v : v * 0.f;
}
// a subnormal f32 result is flushed first (the CPU's flush-to-zero), then
// rounded to bf16: a normal f32 always rounds to a normal bf16
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(ftz(v)));
}
__device__ __forceinline__ __nv_bfloat16 out16(float v) {
  return __float2bfloat16_rn(ftz(v));
}
__device__ __forceinline__ float in16(__nv_bfloat16 v) {
  return ftz(__bfloat162float(v));  // subnormal inputs read as zero
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// XLA's f32 erfc (the Cephes erfcf polynomials), op for op
__device__ float erfc_xla(float u) {
  const float au = fabsf(u);
  const float z = mul(u, u);
  float p = add(mul(z, 7.85386146e-05f), -0.000801019371f);
  p = add(mul(p, z), 0.00518832775f);
  p = add(mul(p, z), -0.0268538129f);
  p = add(mul(p, z), 0.112835854f);
  p = add(mul(p, z), -0.37612626f);
  p = add(mul(p, z), 1.12837911f);
  const float small = __fsub_rn(1.f, mul(u, p));
  const float q = ftz(mul(ftz(expf(-z)), __frcp_rn(au)));
  const float w = __frcp_rn(z);
  float r1 = add(mul(w, 0.0232682f), -0.138703942f);
  r1 = add(mul(r1, w), 0.368742466f);
  r1 = add(mul(r1, w), -0.582473278f);
  r1 = add(mul(r1, w), 0.621000469f);
  r1 = add(mul(r1, w), -0.494451523f);
  r1 = add(mul(r1, w), 0.340488f);
  r1 = add(mul(r1, w), -0.274112701f);
  r1 = add(mul(r1, w), 0.563825965f);
  float r2 = add(mul(w, -10.477664f), 12.9772f);
  r2 = add(mul(r2, w), -7.49551868f);
  r2 = add(mul(r2, w), 2.92101908f);
  r2 = add(mul(r2, w), -1.01526523f);
  r2 = add(mul(r2, w), 0.42184633f);
  r2 = add(mul(r2, w), -0.282076746f);
  r2 = add(mul(r2, w), 0.564189494f);
  float y = ftz(mul(q, au < 2.f ? r1 : r2));
  if (-z < -88.7228394f) y = 0.f;
  if (u < 0.f) y = __fsub_rn(2.f, y);
  return au < 1.f ? small : y;
}

// fp16 rounding of an f32 value, kept as f32 (subnormals kept)
__device__ __forceinline__ float rh(float v) {
  return __half2float(__float2half_rn(v));
}

// The rounding points of one storage type: in, out, the forward and the
// backward of one element, in f32 registers.
template <typename T>
struct Gelu;

template <>
struct Gelu<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 v) {
    return in16(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return out16(v);
  }
  static __device__ __forceinline__ float fwd(float x);
  static __device__ __forceinline__ float bwd(float x, float dy);
};

template <>
struct Gelu<__half> {
  static __device__ __forceinline__ float in(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half out(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ float fwd(float x) {
    const float e = rh(erfc_xla(rh(mul(x, -0.70703125f))));
    return mul(rh(mul(0.5f, x)), e);
  }
  static __device__ __forceinline__ float bwd(float x, float dy) {
    const float u = rh(mul(x, -0.70703125f));
    const float e = rh(erfc_xla(u));
    const float r2 = rh(mul(rh(mul(x, 0.5f)), dy));
    const float r3 = rh(mul(r2, -1.1279296875f));
    const float ee = rh(expf(-rh(mul(u, u))));
    const float m3 = rh(mul(r3, ee));
    const float t2 = rh(mul(rh(mul(dy, e)), 0.5f));
    return __fsub_rn(t2, mul(m3, 0.70703125f));
  }
};

__device__ __forceinline__ float Gelu<__nv_bfloat16>::fwd(float x) {
  const float e = rb(erfc_xla(mul(x, -0.70703125f)));
  return mul(rb(mul(0.5f, x)), e);
}

__device__ __forceinline__ float Gelu<__nv_bfloat16>::bwd(float x, float dy) {
  const float u32 = mul(x, -0.70703125f);
  const float e = rb(erfc_xla(u32));
  const float r2 = rb(mul(rb(mul(0.5f, x)), dy));
  const float r3 = rb(mul(r2, -1.125f));
  const float u = rb(u32);
  const float ee = rb(ftz(expf(-rb(mul(u, u)))));
  const float t1 = rb(-rb(mul(rb(mul(r3, ee)), 0.70703125f)));
  const float t2 = rb(mul(rb(mul(dy, e)), 0.5f));
  return add(t1, t2);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  using G = Gelu<T>;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (!VEC) {
    for (; i < n; i += stride) y[i] = G::out(G::fwd(G::in(x[i])));
    return;
  }
  const uint4* x8 = reinterpret_cast<const uint4*>(x);
  uint4* y8 = reinterpret_cast<uint4*>(y);
  for (; i < n / 8; i += stride) {
    alignas(16) T in[8], out[8];
    *reinterpret_cast<uint4*>(in) = x8[i];
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = G::out(G::fwd(G::in(in[k])));
    y8[i] = *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ dx, long long n) {
  using G = Gelu<T>;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (!VEC) {
    for (; i < n; i += stride)
      dx[i] = G::out(G::bwd(G::in(x[i]), G::in(dy[i])));
    return;
  }
  const uint4* x8 = reinterpret_cast<const uint4*>(x);
  const uint4* d8 = reinterpret_cast<const uint4*>(dy);
  uint4* o8 = reinterpret_cast<uint4*>(dx);
  for (; i < n / 8; i += stride) {
    alignas(16) T xv[8], dv[8], out[8];
    *reinterpret_cast<uint4*>(xv) = x8[i];
    *reinterpret_cast<uint4*>(dv) = d8[i];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      out[k] = G::out(G::bwd(G::in(xv[k]), G::in(dv[k])));
    o8[i] = *reinterpret_cast<const uint4*>(out);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int grid_for(long long work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kCtasPerSm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int gelu_fwd(const void* x, void* y, long long n, void* stream_ptr) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xb = static_cast<const T*>(x);
  auto* yb = static_cast<T*>(y);
  if (n % 8 == 0 && aligned16(x) && aligned16(y))
    gelu_fwd_kernel<T, true><<<grid_for(n / 8), kThreads, 0, stream>>>(xb, yb,
                                                                      n);
  else
    gelu_fwd_kernel<T, false><<<grid_for(n), kThreads, 0, stream>>>(xb, yb, n);
  return (int)cudaGetLastError();
}

template <typename T>
int gelu_bwd(const void* x, const void* dy, void* dx, long long n,
             void* stream_ptr) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xb = static_cast<const T*>(x);
  const auto* db = static_cast<const T*>(dy);
  auto* ob = static_cast<T*>(dx);
  if (n % 8 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx))
    gelu_bwd_kernel<T, true><<<grid_for(n / 8), kThreads, 0, stream>>>(
        xb, db, ob, n);
  else
    gelu_bwd_kernel<T, false><<<grid_for(n), kThreads, 0, stream>>>(xb, db,
                                                                   ob, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paddle_gelu_fwd_bf16(const void* x, void* y, long long n,
                                    void* stream) {
  return gelu_fwd<__nv_bfloat16>(x, y, n, stream);
}

extern "C" int paddle_gelu_bwd_bf16(const void* x, const void* dy, void* dx,
                                    long long n, void* stream) {
  return gelu_bwd<__nv_bfloat16>(x, dy, dx, n, stream);
}

extern "C" int paddle_gelu_fwd_fp16(const void* x, void* y, long long n,
                                    void* stream) {
  return gelu_fwd<__half>(x, y, n, stream);
}

extern "C" int paddle_gelu_bwd_fp16(const void* x, const void* dy, void* dx,
                                    long long n, void* stream) {
  return gelu_bwd<__half>(x, dy, dx, n, stream);
}
