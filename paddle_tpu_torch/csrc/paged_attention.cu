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
// softmax state in VMEM from one grid step to the next.  Here a CTA
// serves one (sequence, kv head) pair and the whole GQA group of query
// heads that reads it, so each K/V row is fetched from device memory
// once per kv head, not once per query head; each warp keeps its own
// online-softmax state (m, l, acc) in registers, and the states are
// merged in a fixed order, so results are run-to-run deterministic.
//   * f32 pages (`paged_decode_f32_kernel`): one CTA of 8 warps walks the
//     whole context of its pair; the warps take the live tokens in
//     interleaved chunks of kUnroll rows (all loads of a chunk issued
//     before any arithmetic); lanes split D, so one row is one coalesced
//     D * 4-byte read, and each q . k is a warp-shuffle reduction.
//   * bf16 and int8 pages (`paged_decode_q_kernel`, its own note below):
//     the walk is split into fixed spans of pages, one CTA of 4 warps
//     each, with 16 rows in flight a warp, so that a small batch fills
//     the card; the last split of a pair to finish merges the splits'
//     states in split order, in the same launch.  At the serving shape
//     that moved bf16 pages from 96 CTAs and 0.30 TB/s (0.0274 ms) to
//     0.0108 ms and 0.77 TB/s.

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
// group (the runtime `group` is <= MAXG); FULL: the head dim is D itself.
template <int VEC, int MAXG, bool FULL>
__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pool,
                        const float* __restrict__ v_pool,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ context_lens,
                        float* __restrict__ out,
                        int n_q_heads, int n_pages, int page_size, int width,
                        int group, float scale, int head_dim) {
  constexpr int D = VEC * 32;
  const int b = blockIdx.x;
  const int hkv = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // hd <= D is the real head dim and the row stride of q, the pools and
  // out (a compile-time D when FULL); lanes past it hold zeros (hd % 8 ==
  // 0, so a lane's VEC elements lie all inside hd or all past it)
  const int hd = FULL ? D : head_dim;
  const bool live = FULL || lane * VEC < hd;
  const int h0 = hkv * group;

  float qr[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group && live) {
      load_row<VEC>(q + ((size_t)b * n_q_heads + h0 + g) * hd + lane * VEC,
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
  const float* __restrict__ k_head = k_pool + (size_t)hkv * n_pages * page_size * hd;
  const float* __restrict__ v_head = v_pool + (size_t)hkv * n_pages * page_size * hd;

  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    float kr[kUnroll][VEC], vr[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u;
      if (j < n && live) {
        const int page = table[j / page_size];
        const size_t row = ((size_t)page * page_size + j % page_size) * hd + lane * VEC;
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
  for (int idx = threadIdx.x; idx < group * hd; idx += kThreads) {
    const int g = idx / hd;
    const int d = idx % hd;
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
    out[((size_t)b * n_q_heads + h0 + g) * hd + d] =
        (l_all == 0.f) ? 0.f : a_all / l_all;
  }
}

template <int VEC, int MAXG, bool FULL>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* block_tables, const int* context_lens,
                   float* out, int n_seqs, int n_q_heads, int n_kv_heads,
                   int n_pages, int page_size, int width, float scale,
                   int hd, cudaStream_t stream) {
  auto kernel = paged_decode_f32_kernel<VEC, MAXG, FULL>;
  const size_t smem = (size_t)kWarps * MAXG * (2 + VEC * 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_seqs, n_kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, block_tables, context_lens, out, n_q_heads, n_pages,
      page_size, width, n_q_heads / n_kv_heads, scale, hd);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_group(int group, const float* q, const float* k_pool,
                           const float* v_pool, const int* block_tables,
                           const int* context_lens, float* out, int n_seqs,
                           int n_q_heads, int n_kv_heads, int n_pages,
                           int page_size, int width, float scale, int hd,
                           cudaStream_t stream) {
#define PD_LAUNCH(G)                                                        \
  return hd == VEC * 32                                                    \
             ? launch<VEC, G, true>(q, k_pool, v_pool, block_tables,       \
                                    context_lens, out, n_seqs, n_q_heads,  \
                                    n_kv_heads, n_pages, page_size, width, \
                                    scale, hd, stream)                     \
             : launch<VEC, G, false>(q, k_pool, v_pool, block_tables,      \
                                     context_lens, out, n_seqs, n_q_heads, \
                                     n_kv_heads, n_pages, page_size,       \
                                     width, scale, hd, stream)
  if (group <= 1) PD_LAUNCH(1);
  if (group <= 2) PD_LAUNCH(2);
  if (group <= 4) PD_LAUNCH(4);
  if (group <= 8) PD_LAUNCH(8);
#undef PD_LAUNCH
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------------------------
// bf16 and int8 pages: a split page walk
//
// The same function over quantized pages: the TPU kernel's bf16 variant
// casts each page tile to f32 in the loop (pallas_kernels.py:886-888); its
// int8 variant dequantizes it as `k * (scale / 127)` with the per-(kv
// head, page) f32 scale (:872-885).  Both dots accumulate in f32, p is
// never rounded, and the output is f32.
//
// Bound.  About 1 flop per byte of K/V (bf16) or 2 (int8): device-memory
// bytes bound it, half (bf16) or a quarter (int8, plus 8 bytes of scales a
// page) of the f32 pages' bytes.  At the serving shape (12 heads, D 64,
// page 16, 2,697 live tokens over 8 rows) the live bf16 K/V are 8.3 MB,
// 2.5 us at 3.35 TB/s.
//
// The old limit.  One CTA of 8 warps per (sequence, kv head) walked the
// whole context: 96 CTAs at the serving shape, fewer than the 132 SMs, and
// the 1024-token sequence's 12 CTAs ran 32 dependent rounds of one
// 16-byte load a lane (4 rows a warp in flight), each a cold latency,
// while the other SMs sat idle: 27.4 us, 0.30 TB/s, 9% of HBM.
//
// The split.  The grid is (sequence, kv head, split).  Split s walks the
// fixed span of pages [s * span, (s + 1) * span) of its table row; the
// span comes from the host (ops/paged_attention.py:decode_splits) and
// depends only on the table's width, the page size and the grid, never on
// context_lens, which live on the card: no host sync, and the launch
// can be captured in a CUDA graph.  A split whose span starts at or past
// ctx[b] returns at once.  Each CTA has 4 warps; a lane loads a 16-byte
// (or 8-byte) slice of a K row and of its V row, LPR lanes a row, RPW = 32
// / LPR rows a warp at once, and U of those loads per lane are issued
// before any arithmetic, so a warp has 16 rows in flight (8 at bf16 D 256,
// where the loads' registers cap U at 8).  The warps take the span's rows
// in interleaved rounds of 4 x RPW x U.  (The other way to keep loads in
// flight, one cp.async.bulk a page of K and of V into a ring of stages
// with an mbarrier, was not built: this one met its targets.)  Spans hold
// at least 128 tokens
// and double until the grid is at most 12 CTAs an SM: at the serving
// shape 8 pages, 768 CTAs of which 312 live (timed against spans of 1 to
// 64 pages: 4 and 8 pages tie there, 8 wins at the GQA shape by 19%).
//
// The merge, one launch, in a fixed order.  Each warp keeps an online
// softmax state per query head of its GQA group (m, l, acc) in registers;
// the CTA merges its warps' states in warp order through shared memory.
// A sequence whose context fits one split writes `out` there.  Otherwise
// each live split writes its unnormalised (m, l, acc[hd]) per query head
// to an f32 scratch (the wrapper's torch.empty), then __threadfence and
// one atomicAdd on the pair's ticket (an int32 buffer the wrapper keeps
// zeroed per device and stream); the split that draws the last ticket
// merges all live splits of its (sequence, kv head) in split order,
// writes `out`, and sets the ticket back to 0.  Which split comes last
// does not change a bit: the result is run-to-run identical, and a graph
// replay equals an eager call.  A context of 0 writes zeros (the TPU
// kernel's l == 0 guard).
//
// Head dims.  The real head dim hd (any multiple of 8 up to 256) is the
// row stride of q, the pools and out; the kernel runs at the next
// instantiated width D in {32, 64, 128, 256}, and the lanes whose slice
// lies past hd load nothing and hold zeros, which leave every dot product
// and sum unchanged.  A slice lies wholly inside hd or wholly past it:
// bf16 slices are 8 elements, and int8 pools whose hd is not a multiple
// of 16 take 8-byte slices of 8 codes (EPL = 8), so that every load is
// also aligned to its own size.  A head dim that is the width itself runs
// an instance (FULL) whose row stride is the compile-time D.
//
// Measured (chip_smoke.py phase l; H100 80GB HBM3, 700 W): bf16 pages
// 0.0108 ms at the serving shape, 771 GB/s, 23% of HBM's 3.35 TB/s (was
// 0.0274), and 0.0229 at the GQA shape (32 / 8 heads, D 128), 644 GB/s,
// 19% (was 0.0608); int8 pages 0.0109 / 0.0245, 386 / 306 GB/s, 12% / 9%
// (was 0.0199 / 0.0811).  A call is a chain of dependent latencies
// (lengths, table, K/V, ticket, partials), not yet its bytes.
// --------------------------------------------------------------------------
constexpr int kQWarps = 4;
constexpr int kQThreads = kQWarps * 32;

template <typename T, int EPL>
struct PageVec;

// 8 bf16 in 16 bytes, low half of each 32-bit word first
template <>
struct PageVec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static uint4 load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(const uint4 r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// EPL int8 codes in EPL bytes (16, or 8 in .x and .y), lowest byte first
template <int EPL>
struct Int8Vec {
  __device__ __forceinline__ static uint4 load(const int8_t* p) {
    if constexpr (EPL == 16) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      return make_uint4(t.x, t.y, 0u, 0u);
    }
  }
  __device__ __forceinline__ static void unpack(const uint4 r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < EPL / 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = __int2float_rn(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
    }
  }
};
template <>
struct PageVec<int8_t, 16> : Int8Vec<16> {};
template <>
struct PageVec<int8_t, 8> : Int8Vec<8> {};

template <int EPL_, int D, int MAXG>
struct QLayout {
  static constexpr int EPL = EPL_;                // elements a lane loads
  static constexpr int LPR = D / EPL;             // lanes a row
  static constexpr int RPW = 32 / LPR;            // rows a warp loads at once
  // loads in flight per lane: 16 rows a warp, at most 8 loads (registers)
  static constexpr int U = RPW >= 16 ? 1 : (16 / RPW > 8 ? 8 : 16 / RPW);
  static constexpr int ROWS = RPW * U;            // rows a warp a round
  static_assert(D % EPL == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0,
                "head_dim must be a multiple of 16 bytes, at most 32 lanes");
  // shared memory, in 4-byte words: q, the warps' m and l, their acc, the
  // span's page ids and (int8) its two scale rows, and the ticket's word
  static size_t words(int span, bool quant) {
    return (size_t)MAXG * D + 2 * kQWarps * MAXG +
           (size_t)kQWarps * MAXG * D + (size_t)span * (quant ? 3 : 1) + 1;
  }
};

template <typename T, int EPL_, int D, int MAXG, bool QUANT, bool FULL>
__global__ void __launch_bounds__(kQThreads)
paged_decode_q_kernel(const float* __restrict__ q,
                      const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ context_lens,
                      float* __restrict__ out, float* __restrict__ part,
                      int* __restrict__ tickets, int n_q_heads, int n_pages,
                      int page_size, int width, int group, float scale,
                      int head_dim, int span) {
  using L = QLayout<EPL_, D, MAXG>;
  using V = PageVec<T, EPL_>;
  constexpr int EPL = L::EPL, LPR = L::LPR, RPW = L::RPW, U = L::U;
  const int b = blockIdx.x;
  const int hkv = blockIdx.y;
  const int split = blockIdx.z;
  // a context longer than the table covers cannot be read: clamp to it
  const int n = min(context_lens[b], width * page_size);
  const int span_tokens = span * page_size;
  const int n_live = max(1, (n + span_tokens - 1) / span_tokens);
  if (split >= n_live) return;   // the span starts past the context
  const int t0 = split * span_tokens;
  const int t1 = min(n, t0 + span_tokens);
  const int p0 = split * span;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPR;  // which of the warp's RPW rows
  const int li = lane % LPR;    // which EPL-wide slice of that row
  // the row stride (a compile-time D when FULL), and whether this lane's
  // slice lies inside the head dim
  const int hd = FULL ? D : head_dim;
  const bool live = FULL || li * EPL < hd;
  const int h0 = hkv * group;

  extern __shared__ __align__(16) float qsmem[];
  float* sm_q = qsmem;                        // [MAXG][D]
  float* sm_m = sm_q + MAXG * D;              // [kQWarps][MAXG]
  float* sm_l = sm_m + kQWarps * MAXG;        // [kQWarps][MAXG]
  float* sm_acc = sm_l + kQWarps * MAXG;      // [kQWarps][MAXG][D]
  int* sm_page = reinterpret_cast<int*>(sm_acc + kQWarps * MAXG * D);
  float* sm_ks = reinterpret_cast<float*>(sm_page + span);
  float* sm_vs = sm_ks + span;
  int* sm_last = sm_page + span * (QUANT ? 3 : 1);

  const float* qb = q + ((size_t)b * n_q_heads + h0) * hd;
  for (int i = threadIdx.x; i < group * D; i += kQThreads)
    sm_q[i] = i % D < hd ? qb[(i / D) * hd + i % D] : 0.f;
  const int* table = block_tables + (size_t)b * width + p0;
  const int n_used = t1 > t0 ? (t1 - t0 + page_size - 1) / page_size : 0;
  for (int i = threadIdx.x; i < n_used; i += kQThreads) {
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

  const size_t head = (size_t)hkv * n_pages * page_size * hd;
  const T* __restrict__ k_head = k_pool + head;
  const T* __restrict__ v_head = v_pool + head;

  for (int base = t0 + warp * L::ROWS; base < t1;
       base += kQWarps * L::ROWS) {
    // every load of the round before any arithmetic
    uint4 kraw[U], vraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPW + slot;
      if (j < t1 && live) {
        const int pj = j / page_size;
        const size_t row =
            ((size_t)sm_page[pj - p0] * page_size + (j - pj * page_size)) * hd +
            li * EPL;
        kraw[u] = V::load(k_head + row);
        vraw[u] = V::load(v_head + row);
      } else {
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float kd[U], vd[U];
    if constexpr (QUANT) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = base + u * RPW + slot;
        const int pi = (j < t1 ? j : t0) / page_size - p0;
        kd[u] = sm_ks[pi];
        vd[u] = sm_vs[pi];
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
          float kx[EPL];
          V::unpack(kraw[u], kx);
          if constexpr (QUANT) {
#pragma unroll
            for (int i = 0; i < EPL; ++i) kx[i] *= kd[u];
          }
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; i += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + i);
            d = fmaf(qv.x, kx[i], d);
            d = fmaf(qv.y, kx[i + 1], d);
            d = fmaf(qv.z, kx[i + 2], d);
            d = fmaf(qv.w, kx[i + 3], d);
          }
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          d *= scale;
          s[u] = (base + u * RPW + slot < t1) ? d : -INFINITY;
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
          float vx[EPL];
          V::unpack(vraw[u], vx);
          if constexpr (QUANT) {
#pragma unroll
            for (int i = 0; i < EPL; ++i) vx[i] *= vd[u];
          }
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(p, vx[i], acc[g][i]);
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

  // the CTA's state: its warps' states merged in warp order; one split
  // writes out, several write their part: per split, [group][hd] acc, then
  // [group] m, then [group] l
  const size_t pair = (size_t)b * gridDim.y + hkv;
  const int part_words = group * (hd + 2);
  float* my_part = part + (pair * gridDim.z + split) * part_words;
  for (int idx = threadIdx.x; idx < group * hd; idx += kQThreads) {
    const int g = idx / hd;
    const int d = idx % hd;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kQWarps; ++w) m_all = fmaxf(m_all, sm_m[w * MAXG + g]);
    float l_all = 0.f, a_all = 0.f;
    if (m_all != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kQWarps; ++w) {
        const float mw = sm_m[w * MAXG + g];
        if (mw != -INFINITY) {
          const float c = expf(mw - m_all);
          l_all = fmaf(c, sm_l[w * MAXG + g], l_all);
          a_all = fmaf(c, sm_acc[(w * MAXG + g) * D + d], a_all);
        }
      }
    }
    if (n_live == 1) {
      out[((size_t)b * n_q_heads + h0 + g) * hd + d] =
          (l_all == 0.f) ? 0.f : a_all / l_all;
    } else {
      my_part[idx] = a_all;
      if (d == 0) {
        my_part[group * hd + g] = m_all;
        my_part[group * hd + group + g] = l_all;
      }
    }
  }
  if (n_live == 1) return;

  // the last live split of the pair to finish merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *sm_last = atomicAdd(tickets + pair, 1) == n_live - 1;
  __syncthreads();
  if (!*sm_last) return;
  __threadfence();
  const float* parts = part + pair * gridDim.z * part_words;
  for (int idx = threadIdx.x; idx < group * hd; idx += kQThreads) {
    const int g = idx / hd;
    float m_all = -INFINITY;
    for (int s = 0; s < n_live; ++s)
      m_all = fmaxf(m_all, __ldcg(parts + s * part_words + group * hd + g));
    float l_all = 0.f, a_all = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ps = parts + s * part_words;
      const float c = expf(__ldcg(ps + group * hd + g) - m_all);
      l_all = fmaf(c, __ldcg(ps + group * hd + group + g), l_all);
      a_all = fmaf(c, __ldcg(ps + idx), a_all);
    }
    out[((size_t)b * n_q_heads + h0) * hd + idx] =
        (l_all == 0.f) ? 0.f : a_all / l_all;
  }
  if (threadIdx.x == 0) tickets[pair] = 0;
}

// the largest dynamic shared memory a block may use on Hopper
constexpr size_t kMaxSmem = 232448;

// what every instance of the quantized kernel takes
template <typename T>
struct QArgs {
  const float* q;
  const T* k_pool;
  const T* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* context_lens;
  float* out;
  float* part;
  int* tickets;
  int n_seqs, n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim;
  float scale;
  int n_splits, span;
};

template <typename T, int EPL, int D, int MAXG, bool FULL>
cudaError_t launch_q(const QArgs<T>& a, cudaStream_t stream) {
  constexpr bool kQuant = sizeof(T) == 1;
  auto kernel = paged_decode_q_kernel<T, EPL, D, MAXG, kQuant, FULL>;
  const size_t smem = QLayout<EPL, D, MAXG>::words(a.span, kQuant) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.n_seqs, a.n_kv_heads, a.n_splits);
  kernel<<<grid, kQThreads, smem, stream>>>(
      a.q, a.k_pool, a.v_pool, a.k_scale, a.v_scale, a.block_tables,
      a.context_lens, a.out, a.part, a.tickets, a.n_q_heads, a.n_pages,
      a.page_size, a.width, a.n_q_heads / a.n_kv_heads, a.scale, a.head_dim,
      a.span);
  return cudaGetLastError();
}

template <typename T, int EPL, int D>
cudaError_t dispatch_q_group(const QArgs<T>& a, cudaStream_t stream) {
  // int8 slices of 8 codes serve only head dims that are no multiple of
  // 16, never the full width: no FULL instance of those
  constexpr bool kCanBeFull = !(sizeof(T) == 1 && EPL == 8);
  const int group = a.n_q_heads / a.n_kv_heads;
#define PDQ_LAUNCH(G)                                                \
  return a.head_dim == D ? launch_q<T, EPL, D, G, kCanBeFull>(a, stream) \
                         : launch_q<T, EPL, D, G, false>(a, stream)
  if (group <= 1) PDQ_LAUNCH(1);
  if (group <= 2) PDQ_LAUNCH(2);
  if (group <= 4) PDQ_LAUNCH(4);
  if (group <= 8) PDQ_LAUNCH(8);
#undef PDQ_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
int paged_decode_q(const QArgs<T>& a, void* stream) {
  if (a.n_seqs <= 0 || a.n_kv_heads <= 0 ||
      a.n_q_heads % a.n_kv_heads != 0 || a.page_size <= 0 || a.width <= 0 ||
      a.span <= 0 || a.n_splits <= 0 || a.n_splits > 65535 ||
      (long long)a.n_splits * a.span < a.width ||
      (long long)(a.n_splits - 1) * a.span >= a.width ||
      a.n_kv_heads > 65535 ||
      (a.n_splits > 1 && (a.part == nullptr || a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = a.head_dim;
  if (hd <= 0 || hd % 8 != 0 || hd > 256) return (int)cudaErrorInvalidValue;
  // the next instantiated width; int8 rows of 8 (mod 16) codes take
  // 8-byte slices
  const int D = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
#define PDQ_D(EPL, DIM) \
  if (D == DIM) return (int)dispatch_q_group<T, EPL, DIM>(a, s);
#define PDQ_ALL_D(EPL) PDQ_D(EPL, 32) PDQ_D(EPL, 64) PDQ_D(EPL, 128) PDQ_D(EPL, 256)
  if constexpr (sizeof(T) == 2) {
    PDQ_ALL_D(8)
  } else {
    if (hd % 16 != 0) {
      PDQ_ALL_D(8)
    } else {
      PDQ_ALL_D(16)
    }
  }
#undef PDQ_ALL_D
#undef PDQ_D
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The C entry point bound with ctypes.  Every tensor is contiguous f32
// (int32 for the tables and lengths) on the current device; the caller
// allocates `out` (n_seqs, n_q_heads, head_dim).  Supported: head_dim a
// multiple of 8 up to 256, q_heads / kv_heads in 1..8.  Returns the launch's
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
  // the narrowest lane layout that holds the row: VEC = D / 32
  cudaError_t e;
  if (head_dim <= 0 || head_dim % 8 != 0 || head_dim > 256) {
    e = cudaErrorInvalidValue;
  } else if (head_dim <= 32) {
    e = dispatch_group<1>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                          n_kv_heads, n_pages, page_size, width, scale,
                          head_dim, s);
  } else if (head_dim <= 64) {
    e = dispatch_group<2>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                          n_kv_heads, n_pages, page_size, width, scale,
                          head_dim, s);
  } else if (head_dim <= 128) {
    e = dispatch_group<4>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                          n_kv_heads, n_pages, page_size, width, scale,
                          head_dim, s);
  } else {
    e = dispatch_group<8>(group, qf, kf, vf, bt, cl, of, n_seqs, n_q_heads,
                          n_kv_heads, n_pages, page_size, width, scale,
                          head_dim, s);
  }
  return (int)e;
}

// bf16 pages: q and out f32, pools bf16, tables and lengths int32; the same
// shapes and limits as the f32 entry point.  The walk is split into
// n_splits spans of `span` pages (ops/paged_attention.py:decode_splits:
// (n_splits - 1) * span < width <= n_splits * span); with more than one
// split, `part` is an f32 scratch of n_seqs * n_kv_heads * n_splits *
// group * (head_dim + 2) words and `tickets` n_seqs * n_kv_heads int32
// zeros, which the kernel leaves zero (one launch at a time on them).  A
// span's page ids (and int8's scales) sit in shared memory, so `span` is
// bounded: an invalid value is returned when they do not fit.
extern "C" int paddle_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    void* part, void* tickets, int n_seqs, int n_q_heads, int n_kv_heads,
    int n_pages, int page_size, int width, int head_dim, float scale,
    int n_splits, int span, void* stream) {
  const QArgs<__nv_bfloat16> a{
      static_cast<const float*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), nullptr, nullptr,
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), n_seqs,
      n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim, scale,
      n_splits, span};
  return paged_decode_q(a, stream);
}

// int8 pages with their (n_kv_heads, n_pages) f32 scale pools: the page
// of kv head h dequantizes as `code * (scale[h, page] / 127)`.
extern "C" int paddle_paged_decode_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* context_lens, void* out, void* part, void* tickets,
    int n_seqs, int n_q_heads, int n_kv_heads, int n_pages, int page_size,
    int width, int head_dim, float scale, int n_splits, int span,
    void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  const QArgs<int8_t> a{
      static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), n_seqs,
      n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim, scale,
      n_splits, span};
  return paged_decode_q(a, stream);
}
