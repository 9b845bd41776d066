// The conv epilogue of a fused conv -> BatchNorm (-> residual add) ->
// activation chain, forward and backward, in float32 and in bfloat16, for
// Hopper (sm_90a).
//
// Replaces, in paddle_tpu/ops/pallas_kernels.py:
//   * _scale_shift_act_kernel (:1039, launched by bn_act_apply :1100):
//       y = act(x*a + b [+ z]), a and b per channel;
//   * _bn_act_bwd_kernel (:1131, launched by bn_act_bwd_apply :1146):
//       g = act'(y)*dy;  dx = g*cg + (x - mean)*cx + c0, per-channel
//       cg, mean, cx, c0; g written out too when asked for.
//
// What bounds them: bytes.  Each element is read once (x, and z; y, dy
// and x backward) and written once (y; dx, and g), against a handful of
// flops, so an H100 at 3.35 TB/s is the limit and the design only has to
// keep the loads wide and the memory system busy:
//   * a grid-stride loop over the flat tensor, about 8 CTAs of 256
//     threads per SM, so every shape fills the card without a grid per
//     shape;
//   * 16-byte loads and stores (4 floats or 8 bf16) when every pointer is
//     16-byte aligned and the elements of one access share a channel (the
//     inner extent L of a channels-first (B, C, L) view is a multiple of
//     the width) or are neighbouring channels (channels-last, C a multiple
//     of the width); a scalar loop otherwise, so any shape with C >= 1
//     works;
//   * the channel of element i is (i / inner) % C, one division per
//     access; the per-channel vectors are read through the read-only cache
//     and stay there (they are a few KB);
//   * the TPU kernel's VMEM tiling gates (c % 8, the block ladders) have
//     no counterpart: nothing here is tiled.
//
// Storage types: T is float or __nv_bfloat16 for x, z, y, dy, dx, g and the
// per-channel a, b, cg, mean, cx; c0 is always float.  The math is f32,
// and every multiply, add and subtract is written with __fmul_rn /
// __fadd_rn / __fsub_rn (no FMA contraction) and rounded to T right after
// (Elem<T>::round, the identity for float), in the TPU kernel's term
// order: for bf16 the Pallas kernel in interpret mode gives
// relu(bf16(bf16(bf16(x*a) + b) + z)) on every element, and the backward
// rounds c0 to bf16 before its add (:1140).  So the results equal the
// plain versions (paddle_tpu_torch/ops/bn_act.py), which are PyTorch ops
// in T, bit for bit for act "" and relu and in the backward; sigmoid,
// tanh and gelu run in f32 on the rounded sum (accurate libdevice
// functions, no fast-math) and round once.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/bn_act.py);
// each function returns the launch's cudaError_t:
//   paddle_bn_act_fwd_{f32,bf16}(x, a, b, z|NULL, y, n, channels, inner,
//                                act, stream)
//   paddle_bn_act_bwd_{f32,bf16}(y, dy, x, cg, mean, cx, c0, dx, g|NULL, n,
//                                channels, inner, act, stream)
// act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (exact erf); the
// backward takes 0 and 1 only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3,
           ACT_GELU = 4 };
// vector modes: element-wise scalar, one 16-byte access within one
// channel, one 16-byte access over neighbouring channels
enum Vec { VEC_SCALAR = 0, VEC_SAME_CHANNEL = 1, VEC_NEXT_CHANNELS = 2 };

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// elements per 16-byte access
template <typename T>
__host__ __device__ constexpr int width() { return 16 / (int)sizeof(T); }

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_RELU) return v < 0.f ? 0.f : v;
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  if (ACT == ACT_TANH) return tanhf(v);
  if (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
  return v;
}

template <typename T, int ACT, bool HAS_Z>
__device__ __forceinline__ T fwd_one(T x, T a, T b, T z) {
  using E = Elem<T>;
  float y = E::round(__fadd_rn(E::round(__fmul_rn(E::load(x), E::load(a))),
                               E::load(b)));
  if (HAS_Z) y = E::round(__fadd_rn(y, E::load(z)));
  return E::store(act_fn<ACT>(y));
}

template <typename T, int ACT, bool HAS_Z, int VEC, typename Idx>
__global__ void __launch_bounds__(kThreads)
bn_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const T* __restrict__ b, const T* __restrict__ z,
                  T* __restrict__ y, Idx n, Idx channels, Idx inner) {
  const Idx stride = (Idx)gridDim.x * kThreads;
  Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x;
  if (VEC == VEC_SCALAR) {
    for (; i < n; i += stride) {
      const Idx c = (i / inner) % channels;
      y[i] = fwd_one<T, ACT, HAS_Z>(x[i], __ldg(a + c), __ldg(b + c),
                                    HAS_Z ? z[i] : x[i]);
    }
    return;
  }
  constexpr int W = width<T>();
  const Idx nv = n / W;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* z4 = reinterpret_cast<const uint4*>(z);
  uint4* y4 = reinterpret_cast<uint4*>(y);
  for (; i < nv; i += stride) {
    const Idx e = i * W;
    alignas(16) T xv[W], zv[W], out[W];
    *reinterpret_cast<uint4*>(xv) = x4[i];
    if (HAS_Z) *reinterpret_cast<uint4*>(zv) = z4[i];
    if (VEC == VEC_SAME_CHANNEL) {
      const Idx c = (e / inner) % channels;
      const T ac = __ldg(a + c), bc = __ldg(b + c);
#pragma unroll
      for (int k = 0; k < W; ++k)
        out[k] = fwd_one<T, ACT, HAS_Z>(xv[k], ac, bc, HAS_Z ? zv[k] : xv[k]);
    } else {  // neighbouring channels, channels a multiple of W
      const Idx c = e % channels;
#pragma unroll
      for (int k = 0; k < W; ++k)
        out[k] = fwd_one<T, ACT, HAS_Z>(xv[k], __ldg(a + c + k),
                                        __ldg(b + c + k),
                                        HAS_Z ? zv[k] : xv[k]);
    }
    y4[i] = *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T, int ACT>
__device__ __forceinline__ T bwd_one(T y, T dy, T x, T cg, T m, T cx,
                                     float c0, T* g_out) {
  using E = Elem<T>;
  const float yv = E::load(y), dyv = E::load(dy);
  const float g = (ACT == ACT_RELU) ? (yv > 0.f ? dyv : 0.f) : dyv;
  *g_out = E::store(g);
  const float t0 = E::round(__fmul_rn(g, E::load(cg)));
  const float t1 = E::round(
      __fmul_rn(E::round(__fsub_rn(E::load(x), E::load(m))), E::load(cx)));
  return E::store(__fadd_rn(E::round(__fadd_rn(t0, t1)), E::round(c0)));
}

template <typename T, int ACT, bool WANT_G, int VEC, typename Idx>
__global__ void __launch_bounds__(kThreads)
bn_act_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                  const T* __restrict__ x, const T* __restrict__ cg,
                  const T* __restrict__ mean, const T* __restrict__ cx,
                  const float* __restrict__ c0, T* __restrict__ dx,
                  T* __restrict__ g, Idx n, Idx channels, Idx inner) {
  const Idx stride = (Idx)gridDim.x * kThreads;
  Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x;
  if (VEC == VEC_SCALAR) {
    for (; i < n; i += stride) {
      const Idx c = (i / inner) % channels;
      T gv;
      dx[i] = bwd_one<T, ACT>(y[i], dy[i], x[i], __ldg(cg + c),
                              __ldg(mean + c), __ldg(cx + c), __ldg(c0 + c),
                              &gv);
      if (WANT_G) g[i] = gv;
    }
    return;
  }
  constexpr int W = width<T>();
  const Idx nv = n / W;
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  const uint4* dy4 = reinterpret_cast<const uint4*>(dy);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* dx4 = reinterpret_cast<uint4*>(dx);
  uint4* g4 = reinterpret_cast<uint4*>(g);
  for (; i < nv; i += stride) {
    const Idx e = i * W;
    alignas(16) T yv[W], dyv[W], xv[W], out[W], gv[W];
    *reinterpret_cast<uint4*>(yv) = y4[i];
    *reinterpret_cast<uint4*>(dyv) = dy4[i];
    *reinterpret_cast<uint4*>(xv) = x4[i];
    if (VEC == VEC_SAME_CHANNEL) {
      const Idx c = (e / inner) % channels;
      const T s0 = __ldg(cg + c), s1 = __ldg(mean + c), s2 = __ldg(cx + c);
      const float s3 = __ldg(c0 + c);
#pragma unroll
      for (int k = 0; k < W; ++k)
        out[k] = bwd_one<T, ACT>(yv[k], dyv[k], xv[k], s0, s1, s2, s3, &gv[k]);
    } else {
      const Idx c = e % channels;
#pragma unroll
      for (int k = 0; k < W; ++k)
        out[k] = bwd_one<T, ACT>(yv[k], dyv[k], xv[k], __ldg(cg + c + k),
                                 __ldg(mean + c + k), __ldg(cx + c + k),
                                 __ldg(c0 + c + k), &gv[k]);
    }
    dx4[i] = *reinterpret_cast<const uint4*>(out);
    if (WANT_G) g4[i] = *reinterpret_cast<const uint4*>(gv);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the vector mode for (channels, inner) at W elements per access:
// VEC_SCALAR unless every pointer is 16-byte aligned and an access never
// straddles a channel boundary (then n is a multiple of W too, so there
// is no scalar tail)
int pick_vec(long long channels, long long inner, bool aligned, int w) {
  if (!aligned) return VEC_SCALAR;
  if (inner % w == 0) return VEC_SAME_CHANNEL;
  if (inner == 1 && channels % w == 0) return VEC_NEXT_CHANNELS;
  return VEC_SCALAR;
}

int grid_for(long long work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kCtasPerSm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

// 32-bit indices while i + stride cannot wrap, 64-bit beyond
template <typename F>
cudaError_t with_index(long long n, F&& f) {
  if (n < (1LL << 31)) return f(0u);
  return f(0ull);
}

template <typename T, int ACT, bool HAS_Z>
cudaError_t launch_fwd(const T* x, const T* a, const T* b, const T* z, T* y,
                       long long n, long long channels, long long inner,
                       int vec, cudaStream_t stream) {
  const long long work = vec == VEC_SCALAR ? n : n / width<T>();
  const int grid = grid_for(work);
  return with_index(n, [&](auto zero) {
    using Idx = decltype(zero);
    const Idx nn = (Idx)n, cc = (Idx)channels, in = (Idx)inner;
    if (vec == VEC_SAME_CHANNEL)
      bn_act_fwd_kernel<T, ACT, HAS_Z, VEC_SAME_CHANNEL, Idx>
          <<<grid, kThreads, 0, stream>>>(x, a, b, z, y, nn, cc, in);
    else if (vec == VEC_NEXT_CHANNELS)
      bn_act_fwd_kernel<T, ACT, HAS_Z, VEC_NEXT_CHANNELS, Idx>
          <<<grid, kThreads, 0, stream>>>(x, a, b, z, y, nn, cc, in);
    else
      bn_act_fwd_kernel<T, ACT, HAS_Z, VEC_SCALAR, Idx>
          <<<grid, kThreads, 0, stream>>>(x, a, b, z, y, nn, cc, in);
    return cudaGetLastError();
  });
}

template <typename T, int ACT>
cudaError_t launch_fwd_z(const T* x, const T* a, const T* b, const T* z,
                         T* y, long long n, long long channels,
                         long long inner, int vec, cudaStream_t stream) {
  if (z != nullptr)
    return launch_fwd<T, ACT, true>(x, a, b, z, y, n, channels, inner, vec,
                                    stream);
  return launch_fwd<T, ACT, false>(x, a, b, z, y, n, channels, inner, vec,
                                   stream);
}

template <typename T, int ACT, bool WANT_G>
cudaError_t launch_bwd(const T* y, const T* dy, const T* x, const T* cg,
                       const T* mean, const T* cx, const float* c0, T* dx,
                       T* g, long long n, long long channels, long long inner,
                       int vec, cudaStream_t stream) {
  const long long work = vec == VEC_SCALAR ? n : n / width<T>();
  const int grid = grid_for(work);
  return with_index(n, [&](auto zero) {
    using Idx = decltype(zero);
    const Idx nn = (Idx)n, cc = (Idx)channels, in = (Idx)inner;
    if (vec == VEC_SAME_CHANNEL)
      bn_act_bwd_kernel<T, ACT, WANT_G, VEC_SAME_CHANNEL, Idx>
          <<<grid, kThreads, 0, stream>>>(y, dy, x, cg, mean, cx, c0, dx, g,
                                          nn, cc, in);
    else if (vec == VEC_NEXT_CHANNELS)
      bn_act_bwd_kernel<T, ACT, WANT_G, VEC_NEXT_CHANNELS, Idx>
          <<<grid, kThreads, 0, stream>>>(y, dy, x, cg, mean, cx, c0, dx, g,
                                          nn, cc, in);
    else
      bn_act_bwd_kernel<T, ACT, WANT_G, VEC_SCALAR, Idx>
          <<<grid, kThreads, 0, stream>>>(y, dy, x, cg, mean, cx, c0, dx, g,
                                          nn, cc, in);
    return cudaGetLastError();
  });
}

template <typename T, int ACT>
cudaError_t launch_bwd_g(const T* y, const T* dy, const T* x, const T* cg,
                         const T* mean, const T* cx, const float* c0, T* dx,
                         T* g, long long n, long long channels,
                         long long inner, int vec, cudaStream_t stream) {
  if (g != nullptr)
    return launch_bwd<T, ACT, true>(y, dy, x, cg, mean, cx, c0, dx, g, n,
                                    channels, inner, vec, stream);
  return launch_bwd<T, ACT, false>(y, dy, x, cg, mean, cx, c0, dx, g, n,
                                   channels, inner, vec, stream);
}

template <typename T>
int fwd(const T* x, const T* a, const T* b, const T* z, T* y, long long n,
        long long channels, long long inner, int act, void* stream_ptr) {
  if (n <= 0 || channels <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool aligned = aligned16(x) && aligned16(a) && aligned16(b) &&
                       aligned16(z) && aligned16(y);
  const int vec = pick_vec(channels, inner, aligned, width<T>());
  switch (act) {
    case ACT_NONE:
      return (int)launch_fwd_z<T, ACT_NONE>(x, a, b, z, y, n, channels, inner,
                                            vec, stream);
    case ACT_RELU:
      return (int)launch_fwd_z<T, ACT_RELU>(x, a, b, z, y, n, channels, inner,
                                            vec, stream);
    case ACT_SIGMOID:
      return (int)launch_fwd_z<T, ACT_SIGMOID>(x, a, b, z, y, n, channels,
                                               inner, vec, stream);
    case ACT_TANH:
      return (int)launch_fwd_z<T, ACT_TANH>(x, a, b, z, y, n, channels, inner,
                                            vec, stream);
    case ACT_GELU:
      return (int)launch_fwd_z<T, ACT_GELU>(x, a, b, z, y, n, channels, inner,
                                            vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd(const T* y, const T* dy, const T* x, const T* cg, const T* mean,
        const T* cx, const float* c0, T* dx, T* g, long long n,
        long long channels, long long inner, int act, void* stream_ptr) {
  if (n <= 0 || channels <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // c0 is float in both variants and is read per element, never as a
  // vector: only the T arrays need the 16-byte alignment
  const bool aligned = aligned16(y) && aligned16(dy) && aligned16(x) &&
                       aligned16(dx) && aligned16(g);
  const int vec = pick_vec(channels, inner, aligned, width<T>());
  switch (act) {
    case ACT_NONE:
      return (int)launch_bwd_g<T, ACT_NONE>(y, dy, x, cg, mean, cx, c0, dx, g,
                                            n, channels, inner, vec, stream);
    case ACT_RELU:
      return (int)launch_bwd_g<T, ACT_RELU>(y, dy, x, cg, mean, cx, c0, dx, g,
                                            n, channels, inner, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

typedef __nv_bfloat16 bf16;

extern "C" int paddle_bn_act_fwd_f32(const float* x, const float* a,
                                     const float* b, const float* z,
                                     float* y, long long n,
                                     long long channels, long long inner,
                                     int act, void* stream_ptr) {
  return fwd<float>(x, a, b, z, y, n, channels, inner, act, stream_ptr);
}

extern "C" int paddle_bn_act_fwd_bf16(const bf16* x, const bf16* a,
                                      const bf16* b, const bf16* z, bf16* y,
                                      long long n, long long channels,
                                      long long inner, int act,
                                      void* stream_ptr) {
  return fwd<bf16>(x, a, b, z, y, n, channels, inner, act, stream_ptr);
}

extern "C" int paddle_bn_act_bwd_f32(const float* y, const float* dy,
                                     const float* x, const float* cg,
                                     const float* mean, const float* cx,
                                     const float* c0, float* dx, float* g,
                                     long long n, long long channels,
                                     long long inner, int act,
                                     void* stream_ptr) {
  return bwd<float>(y, dy, x, cg, mean, cx, c0, dx, g, n, channels, inner,
                    act, stream_ptr);
}

extern "C" int paddle_bn_act_bwd_bf16(const bf16* y, const bf16* dy,
                                      const bf16* x, const bf16* cg,
                                      const bf16* mean, const bf16* cx,
                                      const float* c0, bf16* dx, bf16* g,
                                      long long n, long long channels,
                                      long long inner, int act,
                                      void* stream_ptr) {
  return bwd<bf16>(y, dy, x, cg, mean, cx, c0, dx, g, n, channels, inner,
                   act, stream_ptr);
}
