// Ragged paged-decode attention for Hopper (sm_90a), f32 KV pages.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` /
// `_paged_decode_call` (paddle_tpu/ops/pallas_kernels.py:845-957), f32
// pools only.  Computes, for every sequence b and query head h,
//
//   out[b, h] = softmax_j(scale * q[b, h] . K[h / group, page(b, j), j % ps])
//               . V[h / group, page(b, j), j % ps]        over j < ctx[b]
//
// where page(b, j) = block_tables[b, j / ps].  Only the ctx[b] live token
// rows are read: pages past the context are never touched, the tail page
// is read up to ctx[b], and a row with no live token (ctx 0) writes zeros
// (the TPU kernel's l == 0 guard).
//
// Bound.  Decode attention does 4 * D flops per (head, token) on 8 * D
// bytes of K/V (f32): about 0.5 flop per byte, so the kernel is bound by
// device-memory bytes: every live K/V row read once, plus q and out.
//
// Design.  The TPU grid walks pages in order and carries the online
// softmax state in VMEM from one grid step to the next.  Here one CTA
// serves one (sequence, kv head) pair and the whole GQA group of query
// heads that reads it, so each K/V row is fetched from device memory
// once per kv head, not once per query head.  The page walk is a loop
// inside the CTA: its 8 warps take the live tokens in interleaved
// chunks of kUnroll rows (all loads of a chunk are issued before any
// arithmetic, to keep several rows in flight per warp); lanes split D,
// so each lane holds D / 32 contiguous elements and one row is one
// coalesced D * 4-byte read.  Each q . k is a warp-shuffle reduction;
// each warp keeps its own online-softmax state (m, l, acc) in registers,
// and the warps' states are merged once at the end through shared
// memory, in a fixed order (results are run-to-run deterministic).
// Split-K over pages (to fill all SMs at small batch), TMA and
// multi-stage pipelining are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kThreads = kWarps * 32;

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __ldg(p);
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x;
    x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      x[i] = t.x;
      x[i + 1] = t.y;
      x[i + 2] = t.z;
      x[i + 3] = t.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC = D / 32 elements per lane; MAXG = compile-time bound on the GQA
// group (the runtime `group` is <= MAXG).
template <int VEC, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pool,
                        const float* __restrict__ v_pool,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ context_lens,
                        float* __restrict__ out,
                        int n_q_heads, int n_pages, int page_size, int width,
                        int group, float scale) {
  constexpr int D = VEC * 32;
  const int b = blockIdx.x;
  const int hkv = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h0 = hkv * group;

  float qr[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
      load_row<VEC>(q + ((size_t)b * n_q_heads + h0 + g) * D + lane * VEC,
                    qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[g][i] = 0.f;
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // a context longer than the table covers cannot be read: clamp to it
  const int n = min(context_lens[b], width * page_size);
  const int* __restrict__ table = block_tables + (size_t)b * width;
  const float* __restrict__ k_head = k_pool + (size_t)hkv * n_pages * page_size * D;
  const float* __restrict__ v_head = v_pool + (size_t)hkv * n_pages * page_size * D;

  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    float kr[kUnroll][VEC], vr[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u;
      if (j < n) {
        const int page = table[j / page_size];
        const size_t row = ((size_t)page * page_size + j % page_size) * D + lane * VEC;
        load_row<VEC>(k_head + row, kr[u]);
        load_row<VEC>(v_head + row, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        float s[kUnroll];
        float chunk_max = -INFINITY;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) d = fmaf(qr[g][i], kr[u][i], d);
          d = warp_sum(d) * scale;
          s[u] = (base + u < n) ? d : -INFINITY;
          chunk_max = fmaxf(chunk_max, s[u]);
        }
        // base < n, so s[0] is live and m_new is finite
        const float m_new = fmaxf(m[g], chunk_max);
        const float alpha = expf(m[g] - m_new);  // 0 on the first chunk
        float p_sum = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float p = expf(s[u] - m_new);  // 0 past the context
          p_sum += p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vr[u][i], acc[g][i]);
        }
        l[g] = l[g] * alpha + p_sum;
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states: [kWarps][MAXG] m and l,
  // then [kWarps][MAXG][D] acc
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = sm_m + kWarps * MAXG;
  float* sm_acc = sm_l + kWarps * MAXG;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
      if (lane == 0) {
        sm_m[warp * MAXG + g] = m[g];
        sm_l[warp * MAXG + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        sm_acc[(warp * MAXG + g) * D + lane * VEC + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w * MAXG + g]);
    float l_all = 0.f, a_all = 0.f;
    if (m_all != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm_m[w * MAXG + g];
        if (mw != -INFINITY) {
          const float c = expf(mw - m_all);
          l_all = fmaf(c, sm_l[w * MAXG + g], l_all);
          a_all = fmaf(c, sm_acc[(w * MAXG + g) * D + d], a_all);
        }
      }
    }
    out[((size_t)b * n_q_heads + h0 + g) * D + d] =
        (l_all == 0.f) ? 0.f : a_all / l_all;
  }
}

template <int VEC, int MAXG>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* block_tables, const int* context_lens,
                   float* out, int n_seqs, int n_q_heads, int n_kv_heads,
                   int n_pages, int page_size, int width, float scale,
                   cudaStream_t stream) {
  auto kernel = paged_decode_f32_kernel<VEC, MAXG>;
  const size_t smem = (size_t)kWarps * MAXG * (2 + VEC * 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_seqs, n_kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, block_tables, context_lens, out, n_q_heads, n_pages,
      page_size, width, n_q_heads / n_kv_heads, scale);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_group(int group, const float* q, const float* k_pool,
                           const float* v_pool, const int* block_tables,
                           const int* context_lens, float* out, int n_seqs,
                           int n_q_heads, int n_kv_heads, int n_pages,
                           int page_size, int width, float scale,
                           cudaStream_t stream) {
#define PD_LAUNCH(G)                                                         \
  return launch<VEC, G>(q, k_pool, v_pool, block_tables, context_lens, out, \
                        n_seqs, n_q_heads, n_kv_heads, n_pages, page_size,  \
                        width, scale, stream)
  if (group <= 1) PD_LAUNCH(1);
  if (group <= 2) PD_LAUNCH(2);
  if (group <= 4) PD_LAUNCH(4);
  if (group <= 8) PD_LAUNCH(8);
#undef PD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// The C entry point bound with ctypes.  Every tensor is contiguous f32
// (int32 for the tables and lengths) on the current device; the caller
// allocates `out` (n_seqs, n_q_heads, head_dim).  Supported: head_dim in
// {32, 64, 128, 256}, q_heads / kv_heads in 1..8.  Returns the launch's
// cudaError_t (0 on success); nothing is synchronised.
extern "C" int paddle_paged_decode_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    int n_seqs, int n_q_heads, int n_kv_heads, int n_pages, int page_size,
    int width, int head_dim, float scale, void* stream) {
  if (n_seqs <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      page_size <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  const int group = n_q_heads / n_kv_heads;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (head_dim) {
    case 32:
      e = dispatch_group<1>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                            n_kv_heads, n_pages, page_size, width, scale, s);
      break;
    case 64:
      e = dispatch_group<2>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                            n_kv_heads, n_pages, page_size, width, scale, s);
      break;
    case 128:
      e = dispatch_group<4>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                            n_kv_heads, n_pages, page_size, width, scale, s);
      break;
    case 256:
      e = dispatch_group<8>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                            n_kv_heads, n_pages, page_size, width, scale, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}
