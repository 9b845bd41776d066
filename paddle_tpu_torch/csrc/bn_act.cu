// The conv epilogue of a fused conv -> BatchNorm (-> residual add) ->
// activation chain, forward and backward, float32, for Hopper (sm_90a).
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
//   * 16-byte float4 loads and stores when every pointer is 16-byte
//     aligned and four neighbouring elements share a channel (the inner
//     extent L of a channels-first (B, C, L) view is a multiple of 4) or
//     are four neighbouring channels (channels-last, C a multiple of 4);
//     a scalar loop otherwise, so any shape with C >= 1 works;
//   * the channel of element i is (i / inner) % C, one division per
//     four elements; the per-channel vectors are read through the
//     read-only cache and stay there (they are a few KB);
//   * the TPU kernel's VMEM tiling gates (c % 8, the block ladders) have
//     no counterpart: nothing here is tiled.
//
// Arithmetic: x*a + b and the backward affine are written with
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc does not contract them into
// FMAs and every step rounds as PyTorch's separate eager ops do.  The
// results then equal the plain versions (paddle_tpu_torch/ops/bn_act.py)
// bit for bit for act "" and relu, and in the backward.  sigmoid, tanh
// and gelu use the accurate libdevice functions (no fast-math).
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/bn_act.py);
// each function returns the launch's cudaError_t:
//   paddle_bn_act_fwd_f32(x, a, b, z|NULL, y, n, channels, inner, act,
//                         stream)
//   paddle_bn_act_bwd_f32(y, dy, x, cg, mean, cx, c0, dx, g|NULL, n,
//                         channels, inner, act, stream)
// act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (exact erf); the
// backward takes 0 and 1 only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3,
           ACT_GELU = 4 };
// vector modes: element-wise scalar, float4 within one channel, float4
// over four neighbouring channels
enum Vec { VEC_SCALAR = 0, VEC_SAME_CHANNEL = 1, VEC_NEXT_CHANNELS = 2 };

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_RELU) return v < 0.f ? 0.f : v;
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  if (ACT == ACT_TANH) return tanhf(v);
  if (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
  return v;
}

template <int ACT, bool HAS_Z>
__device__ __forceinline__ float fwd_one(float x, float a, float b, float z) {
  float y = __fadd_rn(__fmul_rn(x, a), b);
  if (HAS_Z) y = __fadd_rn(y, z);
  return act_fn<ACT>(y);
}

template <int ACT, bool HAS_Z, int VEC, typename Idx>
__global__ void __launch_bounds__(kThreads)
bn_act_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ z,
                  float* __restrict__ y, Idx n, Idx channels, Idx inner) {
  const Idx stride = (Idx)gridDim.x * kThreads;
  Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x;
  if (VEC == VEC_SCALAR) {
    for (; i < n; i += stride) {
      const Idx c = (i / inner) % channels;
      y[i] = fwd_one<ACT, HAS_Z>(x[i], __ldg(a + c), __ldg(b + c),
                                 HAS_Z ? z[i] : 0.f);
    }
    return;
  }
  const Idx n4 = n >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* z4 = reinterpret_cast<const float4*>(z);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (; i < n4; i += stride) {
    const Idx e = i << 2;
    float4 av, bv;
    if (VEC == VEC_SAME_CHANNEL) {
      const Idx c = (e / inner) % channels;
      const float ac = __ldg(a + c), bc = __ldg(b + c);
      av = make_float4(ac, ac, ac, ac);
      bv = make_float4(bc, bc, bc, bc);
    } else {  // four neighbouring channels, c a multiple of 4
      const Idx c = e % channels;
      av = __ldg(reinterpret_cast<const float4*>(a + c));
      bv = __ldg(reinterpret_cast<const float4*>(b + c));
    }
    const float4 xv = x4[i];
    float4 zv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (HAS_Z) zv = z4[i];
    float4 out;
    out.x = fwd_one<ACT, HAS_Z>(xv.x, av.x, bv.x, zv.x);
    out.y = fwd_one<ACT, HAS_Z>(xv.y, av.y, bv.y, zv.y);
    out.z = fwd_one<ACT, HAS_Z>(xv.z, av.z, bv.z, zv.z);
    out.w = fwd_one<ACT, HAS_Z>(xv.w, av.w, bv.w, zv.w);
    y4[i] = out;
  }
}

template <int ACT>
__device__ __forceinline__ float bwd_one(float y, float dy, float x,
                                         float cg, float m, float cx,
                                         float c0, float* g_out) {
  const float g = (ACT == ACT_RELU) ? (y > 0.f ? dy : 0.f) : dy;
  *g_out = g;
  return __fadd_rn(__fadd_rn(__fmul_rn(g, cg),
                             __fmul_rn(__fsub_rn(x, m), cx)), c0);
}

template <int ACT, bool WANT_G, int VEC, typename Idx>
__global__ void __launch_bounds__(kThreads)
bn_act_bwd_kernel(const float* __restrict__ y, const float* __restrict__ dy,
                  const float* __restrict__ x, const float* __restrict__ cg,
                  const float* __restrict__ mean,
                  const float* __restrict__ cx, const float* __restrict__ c0,
                  float* __restrict__ dx, float* __restrict__ g, Idx n,
                  Idx channels, Idx inner) {
  const Idx stride = (Idx)gridDim.x * kThreads;
  Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x;
  if (VEC == VEC_SCALAR) {
    for (; i < n; i += stride) {
      const Idx c = (i / inner) % channels;
      float gv;
      dx[i] = bwd_one<ACT>(y[i], dy[i], x[i], __ldg(cg + c), __ldg(mean + c),
                           __ldg(cx + c), __ldg(c0 + c), &gv);
      if (WANT_G) g[i] = gv;
    }
    return;
  }
  const Idx n4 = n >> 2;
  const float4* y4 = reinterpret_cast<const float4*>(y);
  const float4* dy4 = reinterpret_cast<const float4*>(dy);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* dx4 = reinterpret_cast<float4*>(dx);
  float4* g4 = reinterpret_cast<float4*>(g);
  for (; i < n4; i += stride) {
    const Idx e = i << 2;
    float4 cgv, mv, cxv, c0v;
    if (VEC == VEC_SAME_CHANNEL) {
      const Idx c = (e / inner) % channels;
      const float s0 = __ldg(cg + c), s1 = __ldg(mean + c),
                  s2 = __ldg(cx + c), s3 = __ldg(c0 + c);
      cgv = make_float4(s0, s0, s0, s0);
      mv = make_float4(s1, s1, s1, s1);
      cxv = make_float4(s2, s2, s2, s2);
      c0v = make_float4(s3, s3, s3, s3);
    } else {
      const Idx c = e % channels;
      cgv = __ldg(reinterpret_cast<const float4*>(cg + c));
      mv = __ldg(reinterpret_cast<const float4*>(mean + c));
      cxv = __ldg(reinterpret_cast<const float4*>(cx + c));
      c0v = __ldg(reinterpret_cast<const float4*>(c0 + c));
    }
    const float4 yv = y4[i], dyv = dy4[i], xv = x4[i];
    float4 out, gv;
    out.x = bwd_one<ACT>(yv.x, dyv.x, xv.x, cgv.x, mv.x, cxv.x, c0v.x, &gv.x);
    out.y = bwd_one<ACT>(yv.y, dyv.y, xv.y, cgv.y, mv.y, cxv.y, c0v.y, &gv.y);
    out.z = bwd_one<ACT>(yv.z, dyv.z, xv.z, cgv.z, mv.z, cxv.z, c0v.z, &gv.z);
    out.w = bwd_one<ACT>(yv.w, dyv.w, xv.w, cgv.w, mv.w, cxv.w, c0v.w, &gv.w);
    dx4[i] = out;
    if (WANT_G) g4[i] = gv;
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the vector mode for (channels, inner): VEC_SCALAR unless every pointer
// is 16-byte aligned and a float4 never straddles a channel boundary
// (then n is a multiple of 4 too, so there is no scalar tail)
int pick_vec(long long channels, long long inner, bool aligned) {
  if (!aligned) return VEC_SCALAR;
  if (inner % 4 == 0) return VEC_SAME_CHANNEL;
  if (inner == 1 && channels % 4 == 0) return VEC_NEXT_CHANNELS;
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

template <int ACT, bool HAS_Z>
cudaError_t launch_fwd(const float* x, const float* a, const float* b,
                       const float* z, float* y, long long n,
                       long long channels, long long inner, int vec,
                       cudaStream_t stream) {
  const long long work = vec == VEC_SCALAR ? n : n / 4;
  const int grid = grid_for(work);
  return with_index(n, [&](auto zero) {
    using Idx = decltype(zero);
    const Idx nn = (Idx)n, cc = (Idx)channels, in = (Idx)inner;
    if (vec == VEC_SAME_CHANNEL)
      bn_act_fwd_kernel<ACT, HAS_Z, VEC_SAME_CHANNEL, Idx>
          <<<grid, kThreads, 0, stream>>>(x, a, b, z, y, nn, cc, in);
    else if (vec == VEC_NEXT_CHANNELS)
      bn_act_fwd_kernel<ACT, HAS_Z, VEC_NEXT_CHANNELS, Idx>
          <<<grid, kThreads, 0, stream>>>(x, a, b, z, y, nn, cc, in);
    else
      bn_act_fwd_kernel<ACT, HAS_Z, VEC_SCALAR, Idx>
          <<<grid, kThreads, 0, stream>>>(x, a, b, z, y, nn, cc, in);
    return cudaGetLastError();
  });
}

template <int ACT>
cudaError_t launch_fwd_z(const float* x, const float* a, const float* b,
                         const float* z, float* y, long long n,
                         long long channels, long long inner, int vec,
                         cudaStream_t stream) {
  if (z != nullptr)
    return launch_fwd<ACT, true>(x, a, b, z, y, n, channels, inner, vec,
                                 stream);
  return launch_fwd<ACT, false>(x, a, b, z, y, n, channels, inner, vec,
                                stream);
}

template <int ACT, bool WANT_G>
cudaError_t launch_bwd(const float* y, const float* dy, const float* x,
                       const float* cg, const float* mean, const float* cx,
                       const float* c0, float* dx, float* g, long long n,
                       long long channels, long long inner, int vec,
                       cudaStream_t stream) {
  const long long work = vec == VEC_SCALAR ? n : n / 4;
  const int grid = grid_for(work);
  return with_index(n, [&](auto zero) {
    using Idx = decltype(zero);
    const Idx nn = (Idx)n, cc = (Idx)channels, in = (Idx)inner;
    if (vec == VEC_SAME_CHANNEL)
      bn_act_bwd_kernel<ACT, WANT_G, VEC_SAME_CHANNEL, Idx>
          <<<grid, kThreads, 0, stream>>>(y, dy, x, cg, mean, cx, c0, dx, g,
                                          nn, cc, in);
    else if (vec == VEC_NEXT_CHANNELS)
      bn_act_bwd_kernel<ACT, WANT_G, VEC_NEXT_CHANNELS, Idx>
          <<<grid, kThreads, 0, stream>>>(y, dy, x, cg, mean, cx, c0, dx, g,
                                          nn, cc, in);
    else
      bn_act_bwd_kernel<ACT, WANT_G, VEC_SCALAR, Idx>
          <<<grid, kThreads, 0, stream>>>(y, dy, x, cg, mean, cx, c0, dx, g,
                                          nn, cc, in);
    return cudaGetLastError();
  });
}

template <int ACT>
cudaError_t launch_bwd_g(const float* y, const float* dy, const float* x,
                         const float* cg, const float* mean, const float* cx,
                         const float* c0, float* dx, float* g, long long n,
                         long long channels, long long inner, int vec,
                         cudaStream_t stream) {
  if (g != nullptr)
    return launch_bwd<ACT, true>(y, dy, x, cg, mean, cx, c0, dx, g, n,
                                 channels, inner, vec, stream);
  return launch_bwd<ACT, false>(y, dy, x, cg, mean, cx, c0, dx, g, n,
                                channels, inner, vec, stream);
}

}  // namespace

extern "C" int paddle_bn_act_fwd_f32(const float* x, const float* a,
                                     const float* b, const float* z,
                                     float* y, long long n,
                                     long long channels, long long inner,
                                     int act, void* stream_ptr) {
  if (n <= 0 || channels <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool aligned = aligned16(x) && aligned16(a) && aligned16(b) &&
                       aligned16(z) && aligned16(y);
  const int vec = pick_vec(channels, inner, aligned);
  switch (act) {
    case ACT_NONE:
      return (int)launch_fwd_z<ACT_NONE>(x, a, b, z, y, n, channels, inner,
                                         vec, stream);
    case ACT_RELU:
      return (int)launch_fwd_z<ACT_RELU>(x, a, b, z, y, n, channels, inner,
                                         vec, stream);
    case ACT_SIGMOID:
      return (int)launch_fwd_z<ACT_SIGMOID>(x, a, b, z, y, n, channels,
                                            inner, vec, stream);
    case ACT_TANH:
      return (int)launch_fwd_z<ACT_TANH>(x, a, b, z, y, n, channels, inner,
                                         vec, stream);
    case ACT_GELU:
      return (int)launch_fwd_z<ACT_GELU>(x, a, b, z, y, n, channels, inner,
                                         vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int paddle_bn_act_bwd_f32(const float* y, const float* dy,
                                     const float* x, const float* cg,
                                     const float* mean, const float* cx,
                                     const float* c0, float* dx, float* g,
                                     long long n, long long channels,
                                     long long inner, int act,
                                     void* stream_ptr) {
  if (n <= 0 || channels <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool aligned = aligned16(y) && aligned16(dy) && aligned16(x) &&
                       aligned16(cg) && aligned16(mean) && aligned16(cx) &&
                       aligned16(c0) && aligned16(dx) && aligned16(g);
  const int vec = pick_vec(channels, inner, aligned);
  switch (act) {
    case ACT_NONE:
      return (int)launch_bwd_g<ACT_NONE>(y, dy, x, cg, mean, cx, c0, dx, g,
                                         n, channels, inner, vec, stream);
    case ACT_RELU:
      return (int)launch_bwd_g<ACT_RELU>(y, dy, x, cg, mean, cx, c0, dx, g,
                                         n, channels, inner, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
