// Ragged paged-decode attention for Hopper (sm_90a): f32, bf16 and int8
// KV pages.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` /
// `_paged_decode_call` (paddle_tpu/ops/pallas_kernels.py:845-957).  The
// f32 kernel comes first; the kernel for bf16 and int8 pages follows it
// (`paged_decode_q_kernel`, with its own note).  Computes, for every
// sequence b and query head h,
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// --------------------------------------------------------------------------
// bf16 and int8 pages
//
// The same walk over quantized pages: the TPU kernel's bf16 variant casts
// each page tile to f32 in the loop (pallas_kernels.py:886-888); its int8
// variant dequantizes it as `k * (scale / 127)` with the per-(kv head,
// page) f32 scale (:872-885).  Both dots accumulate in f32, p is never
// rounded, and the output is f32.
//
// Bound.  Still about 1 flop per byte of K/V (bf16) or 2 (int8): bound by
// device-memory bytes, now half (bf16) or a quarter (int8, plus 8 bytes of
// scales a page) of the f32 pages' bytes.
//
// Design.  One CTA per (sequence, kv head) serving its whole GQA group,
// 8 warps, a register online softmax per warp and the f32 kernel's
// fixed-order merge across warps.  What changes is the lane-to-row
// mapping.  Each lane reads 16 bytes of a K row and 16 of the V row at a
// time: 8 bf16 or 16 int8, widened to f32 exactly.  A row of D elements
// takes LPR = D / EPL lanes (EPL elements a lane), so a warp reads
// RPW = 32 / LPR rows at once (bf16 at D = 64: 8 lanes a row, 4 rows;
// int8 at D = 64: 4 lanes a row, 8 rows), and U of those loads are in
// flight per lane, so that a warp always has at least 4 rows in flight.
// q . k is a shuffle sum over the LPR lanes of a row; the chunk's row
// maximum is a shuffle max across the rows, so the softmax state (m) is
// one per warp and the rows' partial sums (l, acc) share it; they are
// summed across the rows of the warp at the end, in a fixed order.
// q sits in shared memory (f32), read as float4.  The sequence's page
// ids, and for int8 each page's two scales already divided by 127, are
// read once per CTA into shared memory: a scale is read once a page, not
// once an element.
// --------------------------------------------------------------------------
template <typename T>
struct PageVec;

// 8 bf16 in 16 bytes, low half of each 32-bit word first
template <>
struct PageVec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void unpack(const uint4 r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 16 int8 in 16 bytes, lowest byte first
template <>
struct PageVec<int8_t> {
  static constexpr int kElems = 16;
  __device__ __forceinline__ static void unpack(const uint4 r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = __int2float_rn(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
    }
  }
};

template <typename T, int D, int MAXG>
struct QLayout {
  static constexpr int EPL = PageVec<T>::kElems;  // elements a lane loads
  static constexpr int LPR = D / EPL;             // lanes a row
  static constexpr int RPW = 32 / LPR;            // rows a warp loads at once
  static constexpr int U = RPW >= 4 ? 1 : 4 / RPW;
  static constexpr int ROWS = RPW * U;            // rows a warp step
  static_assert(D % EPL == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0,
                "head_dim must be a multiple of 16 bytes, at most 32 lanes");
  // shared memory, in 4-byte words: q, the warps' m and l, their acc,
  // then the page ids and (int8) the two scale rows, each `width` long
  static size_t words(int width, bool quant) {
    return (size_t)MAXG * D + 2 * kWarps * MAXG + (size_t)kWarps * MAXG * D +
           (size_t)width * (quant ? 3 : 1);
  }
};

template <typename T, int D, int MAXG, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_decode_q_kernel(const float* __restrict__ q,
                      const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ context_lens,
                      float* __restrict__ out,
                      int n_q_heads, int n_pages, int page_size, int width,
                      int group, float scale) {
  using L = QLayout<T, D, MAXG>;
  constexpr int EPL = L::EPL, LPR = L::LPR, RPW = L::RPW, U = L::U;
  const int b = blockIdx.x;
  const int hkv = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPR;  // which of the warp's RPW rows
  const int li = lane % LPR;    // which EPL-wide slice of that row
  const int h0 = hkv * group;

  extern __shared__ __align__(16) float qsmem[];
  float* sm_q = qsmem;                        // [MAXG][D]
  float* sm_m = sm_q + MAXG * D;              // [kWarps][MAXG]
  float* sm_l = sm_m + kWarps * MAXG;         // [kWarps][MAXG]
  float* sm_acc = sm_l + kWarps * MAXG;       // [kWarps][MAXG][D]
  int* sm_page = reinterpret_cast<int*>(sm_acc + kWarps * MAXG * D);
  float* sm_ks = reinterpret_cast<float*>(sm_page + width);
  float* sm_vs = sm_ks + width;

  // a context longer than the table covers cannot be read: clamp to it
  const int n = min(context_lens[b], width * page_size);
  const int n_used = (n + page_size - 1) / page_size;
  const float* qb = q + ((size_t)b * n_q_heads + h0) * D;
  for (int i = threadIdx.x; i < group * D; i += kThreads) sm_q[i] = qb[i];
  const int* table = block_tables + (size_t)b * width;
  for (int i = threadIdx.x; i < n_used; i += kThreads) {
    const int page = table[i];
    sm_page[i] = page;
    if constexpr (QUANT) {
      // the Pallas kernel's order: scale / 127 first, then k * that
      sm_ks[i] = k_scale[(size_t)hkv * n_pages + page] / 127.f;
      sm_vs[i] = v_scale[(size_t)hkv * n_pages + page] / 127.f;
    }
  }
  __syncthreads();

  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  const size_t head = (size_t)hkv * n_pages * page_size * D;
  const T* __restrict__ k_head = k_pool + head;
  const T* __restrict__ v_head = v_pool + head;

  for (int base = warp * L::ROWS; base < n; base += kWarps * L::ROWS) {
    uint4 kraw[U], vraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPW + slot;
      if (j < n) {
        const size_t row =
            ((size_t)sm_page[j / page_size] * page_size + j % page_size) * D +
            li * EPL;
        kraw[u] = __ldg(reinterpret_cast<const uint4*>(k_head + row));
        vraw[u] = __ldg(reinterpret_cast<const uint4*>(v_head + row));
      } else {
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float kr[U][EPL], vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      PageVec<T>::unpack(kraw[u], kr[u]);
      PageVec<T>::unpack(vraw[u], vr[u]);
      if constexpr (QUANT) {
        const int j = base + u * RPW + slot;
        const int pi = (j < n ? j : 0) / page_size;
        const float kd = sm_ks[pi], vd = sm_vs[pi];
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          kr[u][i] *= kd;
          vr[u][i] *= vd;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        const float* qg = sm_q + g * D + li * EPL;
        float s[U];
        float chunk_max = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; i += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + i);
            d = fmaf(qv.x, kr[u][i], d);
            d = fmaf(qv.y, kr[u][i + 1], d);
            d = fmaf(qv.z, kr[u][i + 2], d);
            d = fmaf(qv.w, kr[u][i + 3], d);
          }
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          d *= scale;
          s[u] = (base + u * RPW + slot < n) ? d : -INFINITY;
          chunk_max = fmaxf(chunk_max, s[u]);
        }
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          chunk_max = fmaxf(chunk_max, __shfl_xor_sync(0xffffffffu, chunk_max, o));
        // row `base` is live, so the chunk's maximum is finite
        const float m_new = fmaxf(m[g], chunk_max);
        const float alpha = expf(m[g] - m_new);  // 0 on the first chunk
        float p_sum = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = expf(s[u] - m_new);  // 0 past the context
          p_sum += p;
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(p, vr[u][i], acc[g][i]);
        }
        l[g] = l[g] * alpha + p_sum;
        m[g] = m_new;
      }
    }
  }

  // the warp's rows share m: sum their l and acc (lanes of one slice)
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
      }
      if (slot == 0) {
        if (li == 0) {
          sm_m[warp * MAXG + g] = m[g];
          sm_l[warp * MAXG + g] = l[g];
        }
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          sm_acc[(warp * MAXG + g) * D + li * EPL + i] = acc[g][i];
      }
    }
  }
  __syncthreads();
  // merge the warps' states in a fixed order, as the f32 kernel does
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

// the largest dynamic shared memory a block may use on Hopper
constexpr size_t kMaxSmem = 232448;

template <typename T, int D, int MAXG>
cudaError_t launch_q(const float* q, const T* k_pool, const T* v_pool,
                     const float* k_scale, const float* v_scale,
                     const int* block_tables, const int* context_lens,
                     float* out, int n_seqs, int n_q_heads, int n_kv_heads,
                     int n_pages, int page_size, int width, float scale,
                     cudaStream_t stream) {
  constexpr bool kQuant = sizeof(T) == 1;
  auto kernel = paged_decode_q_kernel<T, D, MAXG, kQuant>;
  const size_t smem = QLayout<T, D, MAXG>::words(width, kQuant) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_seqs, n_kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, context_lens, out,
      n_q_heads, n_pages, page_size, width, n_q_heads / n_kv_heads, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_q_group(int group, const float* q, const T* k_pool,
                             const T* v_pool, const float* k_scale,
                             const float* v_scale, const int* block_tables,
                             const int* context_lens, float* out, int n_seqs,
                             int n_q_heads, int n_kv_heads, int n_pages,
                             int page_size, int width, float scale,
                             cudaStream_t stream) {
#define PDQ_LAUNCH(G)                                                       \
  return launch_q<T, D, G>(q, k_pool, v_pool, k_scale, v_scale,            \
                           block_tables, context_lens, out, n_seqs,        \
                           n_q_heads, n_kv_heads, n_pages, page_size,      \
                           width, scale, stream)
  if (group <= 1) PDQ_LAUNCH(1);
  if (group <= 2) PDQ_LAUNCH(2);
  if (group <= 4) PDQ_LAUNCH(4);
  if (group <= 8) PDQ_LAUNCH(8);
#undef PDQ_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
int paged_decode_q(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* context_lens,
                   void* out, int n_seqs, int n_q_heads, int n_kv_heads,
                   int n_pages, int page_size, int width, int head_dim,
                   float scale, void* stream) {
  if (n_seqs <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      page_size <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  const int group = n_q_heads / n_kv_heads;
  const float* qf = static_cast<const float*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define PDQ_D(DIM)                                                          \
  case DIM:                                                                 \
    return (int)dispatch_q_group<T, DIM>(group, qf, kp, vp, ks, vs, bt, cl, \
                                         of, n_seqs, n_q_heads, n_kv_heads, \
                                         n_pages, page_size, width, scale,  \
                                         s);
    PDQ_D(32)
    PDQ_D(64)
    PDQ_D(128)
    PDQ_D(256)
#undef PDQ_D
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// bf16 pages: q and out f32, pools bf16, tables and lengths int32; the same
// shapes and limits as the f32 entry point.  The page ids (and int8's
// scales) sit in shared memory, so `width` is bounded too: an invalid
// value is returned when they do not fit (the wrapper allows 8,192).
extern "C" int paddle_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    int n_seqs, int n_q_heads, int n_kv_heads, int n_pages, int page_size,
    int width, int head_dim, float scale, void* stream) {
  return paged_decode_q<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, block_tables, context_lens, out,
      n_seqs, n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim,
      scale, stream);
}

// int8 pages with their (n_kv_heads, n_pages) f32 scale pools: the page
// of kv head h dequantizes as `code * (scale[h, page] / 127)`.
extern "C" int paddle_paged_decode_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* context_lens, void* out, int n_seqs, int n_q_heads,
    int n_kv_heads, int n_pages, int page_size, int width, int head_dim,
    float scale, void* stream) {
  return paged_decode_q<int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, context_lens, out,
      n_seqs, n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim,
      scale, stream);
}
