// Ragged paged-decode attention for Hopper (sm_90a): one kernel over f32,
// bf16 and int8 KV pages, at any block-table width.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` /
// `_paged_decode_call` (paddle_tpu/ops/pallas_kernels.py:845-957).
// Computes, for every sequence b and query head h,
//
//   out[b, h] = softmax_j(scale * q[b, h] . K[h / group, page(b, j), j % ps])
//               . V[h / group, page(b, j), j % ps]        over j < ctx[b]
//
// where page(b, j) = block_tables[b, j / ps].  Only the ctx[b] live token
// rows are read: pages past the context are never touched, the tail page
// is read up to ctx[b], a length past the table is clamped to it, and a
// row with no live token (ctx 0) writes zeros (the TPU kernel's l == 0
// guard).  Over bf16 pages the TPU kernel casts each page tile to f32 in
// the loop (pallas_kernels.py:886-888); over int8 pages it dequantizes as
// `k * (scale / 127)` with the per-(kv head, page) f32 scale (:872-885).
// Every dot accumulates in f32, p is never rounded, q and out are f32.
//
// Bound.  Decode attention does 4 * D flops per (query head, token) on
// 8 * D bytes of K/V per kv head at f32 (4 * D at bf16, 2 * D plus 8
// bytes of scales a page at int8): at most 2 flops per byte, so
// device-memory bytes bound it, every live K/V row read once, plus q, out,
// tables and lengths.  At the serving shape (12 heads, D 64, page 16,
// 2,697 live tokens over 8 rows) the live f32 K/V are 16.6 MB, 4.96 us at
// 3.35 TB/s; bf16 half that, int8 a quarter.
//
// The split page walk.  One CTA per (sequence, kv head) walking the whole
// context leaves most SMs idle at a small batch (96 CTAs at the serving
// shape) while the longest sequence's CTAs run long chains of dependent
// loads.  So the grid is (sequence, kv head, split): split s walks the
// fixed span of pages [s * span, (s + 1) * span) of its table row; the
// span comes from the host (ops/paged_attention.py:decode_splits) and
// depends only on the table's width, the page size and the grid, never
// on context_lens, which live on the card: no host sync, and the launch
// can be captured in a CUDA graph.  A split whose span starts at or past
// ctx[b] returns at once.  Spans hold at least 128 tokens and double
// until the grid is at most 12 CTAs an SM, up to 8,192 pages (a span's
// page ids, and int8's scales, sit in shared memory: at most 96 KB of
// them); a wider table takes more splits, so every width runs.  At the
// serving shape: 8 pages, 768 CTAs of which 312 live.
//
// Loads.  Each CTA has 4 warps.  A lane loads NV 16-byte words (or one
// 8-byte word of int8 codes) of a K row and of its V row: EPW elements a
// word (f32 4, bf16 8, int8 16 or 8), the lane's words strided across the
// row (word w at element w * D / NV + lane * EPW), so that each load
// instruction of a warp reads contiguous bytes.  LPR lanes a row, RPW =
// 32 / LPR rows a warp at once, and U of those rows per lane are loaded
// before any arithmetic, so that a warp has 16 rows in flight (8 at f32
// D 128 and at bf16 D 256, 4 at f32 D 256, where 8 words of K and 8 of V
// a lane cap U for the registers; 4 words each, so 8 rows, for int8's
// 16-code words at D 256 and GQA group bound 8, whose acc takes 128).  f32 rows take two words a lane (EPL
// 8): at D 64 that is 8 lanes a row and 4 rows a warp, whose dots share
// each of 3 shuffle steps, where one word a lane would take 16 lanes and
// 4 steps for 2 rows (measured: 3% slower at the serving shape, 16% at
// the GQA one).  The warps take the span's rows in interleaved rounds of
// 4 x RPW x U.
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
// replay equals an eager call.
//
// Head dims.  The real head dim hd (any multiple of 8 up to 256) is the
// row stride of q, the pools and out; the kernel runs at the next
// instantiated width D in {32, 64, 128, 256}, and the words that lie past
// hd load nothing and hold zeros, which leave every dot product and sum
// unchanged.  A word lies wholly inside hd or wholly past it: f32 words
// are 4 elements and bf16 words 8, and int8 pools whose hd is not a
// multiple of 16 take 8-byte words of 8 codes, so that every load is also
// aligned to its own size.  A head dim that is the width itself runs an
// instance (FULL) whose row stride is the compile-time D.
//
// Measured (chip_smoke.py phases 3-4 and l; NVIDIA H100 80GB HBM3,
// 700 W; CUDA-graph replay, cold L2; the one-CTA-per-pair design in
// brackets): f32 pages 0.0130 ms at the serving shape, 1.28 TB/s, 38% of
// the bound (0.0432), 0.0251 at the GQA shape (32 / 8 heads, D 128),
// 1.17 TB/s, 35% (0.0768), and 0.0885 over a wide batch of 64 sequences x
// 12 heads, 2.66 TB/s, 79% (0.0997); bf16 pages 0.0111 / 0.0234, 750 /
// 630 GB/s, 22% / 19% (0.0274 / 0.0608); int8 pages 0.0111 / 0.0247, 379
// / 303 GB/s, 11% / 9% (0.0199 / 0.0811).  A call is a chain of dependent
// latencies (lengths, table, K/V, ticket, partials), not yet its bytes.
// (The other way to keep loads in flight, one cp.async.bulk a page of K
// and of V into a ring of stages with an mbarrier, was not built: this
// one met its targets over bf16, int8 and f32 pages.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// one word of EPW page elements: `load` reads it from the pool, `unpack`
// widens it to f32
template <typename T, int EPW>
struct PageVec;

// 4 f32 in 16 bytes
template <>
struct PageVec<float, 4> {
  __device__ __forceinline__ static uint4 load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(const uint4 r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};

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

// EPW int8 codes in EPW bytes (16, or 8 in .x and .y), lowest byte first
template <int EPW>
struct Int8Vec {
  __device__ __forceinline__ static uint4 load(const int8_t* p) {
    if constexpr (EPW == 16) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      return make_uint4(t.x, t.y, 0u, 0u);
    }
  }
  __device__ __forceinline__ static void unpack(const uint4 r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < EPW / 4; ++i) {
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

template <int EPW_, int NV_, int D, int MAXG>
struct Layout {
  static constexpr int EPW = EPW_;                // elements a word
  static constexpr int NV = NV_;                  // words a lane loads of a row
  static constexpr int EPL = EPW * NV;            // elements a lane
  static constexpr int STRIDE = D / NV;           // elements between its words
  static constexpr int LPR = D / EPL;             // lanes a row
  static constexpr int RPW = 32 / LPR;            // rows a warp loads at once
  // words of K (and of V) in flight per lane, for the registers: 8, or 4
  // where acc takes 128 (int8's 16-code words at GQA group bound 8)
  static constexpr int WORDS = MAXG * EPL > 64 ? 4 : 8;
  // rows in flight per lane: 16 rows a warp, within WORDS
  static constexpr int U =
      RPW >= 16 ? 1 : (16 / RPW * NV > WORDS ? WORDS / NV : 16 / RPW);
  static constexpr int ROWS = RPW * U;            // rows a warp a round
  static_assert(D % EPL == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0 &&
                    U >= 1,
                "head_dim must be a multiple of 16 bytes, at most 32 lanes");
  // shared memory, in 4-byte words: q, the warps' m and l, their acc, the
  // span's page ids and (int8) its two scale rows, and the ticket's word
  static size_t words(int span, bool quant) {
    return (size_t)MAXG * D + 2 * kWarps * MAXG +
           (size_t)kWarps * MAXG * D + (size_t)span * (quant ? 3 : 1) + 1;
  }
};

template <typename T, int EPW, int NV, int D, int MAXG, bool QUANT, bool FULL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
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
  using L = Layout<EPW, NV, D, MAXG>;
  using V = PageVec<T, EPW>;
  constexpr int EPL = L::EPL, STRIDE = L::STRIDE, LPR = L::LPR,
                RPW = L::RPW, U = L::U;
  const int b = blockIdx.x;
  const int hkv = blockIdx.y;
  const int split = blockIdx.z;
  // a context longer than the table covers cannot be read: clamp to it
  // (a table may cover more than 2^31 tokens, a context never does)
  const int ctx = context_lens[b];
  const int n = (long long)width * page_size < ctx ? width * page_size : ctx;
  const int span_tokens = span * page_size;
  const int n_live = max(1, (n + span_tokens - 1) / span_tokens);
  if (split >= n_live) return;   // the span starts past the context
  const int t0 = split * span_tokens;
  const int t1 = min(n, t0 + span_tokens);
  const int p0 = split * span;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPR;  // which of the warp's RPW rows
  const int li = lane % LPR;    // which EPW-wide word of each STRIDE
  // the row stride (a compile-time D when FULL), and whether each of this
  // lane's words lies inside the head dim
  const int hd = FULL ? D : head_dim;
  bool live[NV];
#pragma unroll
  for (int w = 0; w < NV; ++w) live[w] = FULL || w * STRIDE + li * EPW < hd;
  const int h0 = hkv * group;

  extern __shared__ __align__(16) float shared[];
  float* sm_q = shared;                       // [MAXG][D]
  float* sm_m = sm_q + MAXG * D;              // [kWarps][MAXG]
  float* sm_l = sm_m + kWarps * MAXG;         // [kWarps][MAXG]
  float* sm_acc = sm_l + kWarps * MAXG;       // [kWarps][MAXG][D]
  int* sm_page = reinterpret_cast<int*>(sm_acc + kWarps * MAXG * D);
  float* sm_ks = reinterpret_cast<float*>(sm_page + span);
  float* sm_vs = sm_ks + span;
  int* sm_last = sm_page + span * (QUANT ? 3 : 1);

  const float* qb = q + ((size_t)b * n_q_heads + h0) * hd;
  for (int i = threadIdx.x; i < group * D; i += kThreads)
    sm_q[i] = i % D < hd ? qb[(i / D) * hd + i % D] : 0.f;
  const int* table = block_tables + (size_t)b * width + p0;
  const int n_used = t1 > t0 ? (t1 - t0 + page_size - 1) / page_size : 0;
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

  const size_t head = (size_t)hkv * n_pages * page_size * hd;
  const T* __restrict__ k_head = k_pool + head;
  const T* __restrict__ v_head = v_pool + head;

  for (int base = t0 + warp * L::ROWS; base < t1;
       base += kWarps * L::ROWS) {
    // every load of the round before any arithmetic
    uint4 kraw[U][NV], vraw[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPW + slot;
      size_t row = 0;
      if (j < t1) {
        const int pj = j / page_size;
        row = ((size_t)sm_page[pj - p0] * page_size + (j - pj * page_size)) * hd +
              li * EPW;
      }
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        if (j < t1 && live[w]) {
          kraw[u][w] = V::load(k_head + row + w * STRIDE);
          vraw[u][w] = V::load(v_head + row + w * STRIDE);
        } else {
          kraw[u][w] = vraw[u][w] = make_uint4(0u, 0u, 0u, 0u);
        }
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
        const float* qg = sm_q + g * D + li * EPW;
        float s[U];
        float chunk_max = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d = 0.f;
#pragma unroll
          for (int w = 0; w < NV; ++w) {
            float kx[EPW];
            V::unpack(kraw[u][w], kx);
            if constexpr (QUANT) {
#pragma unroll
              for (int i = 0; i < EPW; ++i) kx[i] *= kd[u];
            }
#pragma unroll
            for (int i = 0; i < EPW; i += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qg + w * STRIDE + i);
              d = fmaf(qv.x, kx[i], d);
              d = fmaf(qv.y, kx[i + 1], d);
              d = fmaf(qv.z, kx[i + 2], d);
              d = fmaf(qv.w, kx[i + 3], d);
            }
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
#pragma unroll
          for (int w = 0; w < NV; ++w) {
            float vx[EPW];
            V::unpack(vraw[u][w], vx);
            if constexpr (QUANT) {
#pragma unroll
              for (int i = 0; i < EPW; ++i) vx[i] *= vd[u];
            }
#pragma unroll
            for (int i = 0; i < EPW; ++i)
              acc[g][w * EPW + i] = fmaf(p, vx[i], acc[g][w * EPW + i]);
          }
        }
        l[g] = l[g] * alpha + p_sum;
        m[g] = m_new;
      }
    }
  }

  // the warp's rows share m: sum their l and acc (lanes of one word)
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
        for (int w = 0; w < NV; ++w) {
#pragma unroll
          for (int i = 0; i < EPW; ++i)
            sm_acc[(warp * MAXG + g) * D + w * STRIDE + li * EPW + i] =
                acc[g][w * EPW + i];
        }
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
  for (int idx = threadIdx.x; idx < group * hd; idx += kThreads) {
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

// the largest dynamic shared memory a block may use on Hopper; a span
// from decode_splits (at most 8,192 pages) needs at most 139,524 bytes
// (int8, GQA group 8, D 256)
constexpr size_t kMaxSmem = 232448;

// what every instance of the kernel takes
template <typename T>
struct Args {
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

template <typename T, int EPW, int NV, int D, int MAXG, bool FULL>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  constexpr bool kQuant = sizeof(T) == 1;
  auto kernel = paged_decode_kernel<T, EPW, NV, D, MAXG, kQuant, FULL>;
  const size_t smem = Layout<EPW, NV, D, MAXG>::words(a.span, kQuant) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.n_seqs, a.n_kv_heads, a.n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.q, a.k_pool, a.v_pool, a.k_scale, a.v_scale, a.block_tables,
      a.context_lens, a.out, a.part, a.tickets, a.n_q_heads, a.n_pages,
      a.page_size, a.width, a.n_q_heads / a.n_kv_heads, a.scale, a.head_dim,
      a.span);
  return cudaGetLastError();
}

template <typename T, int EPW, int NV, int D>
cudaError_t dispatch_group(const Args<T>& a, cudaStream_t stream) {
  // int8 words of 8 codes serve only head dims that are no multiple of
  // 16, never the full width: no FULL instance of those
  constexpr bool kCanBeFull = !(sizeof(T) == 1 && EPW == 8);
  const int group = a.n_q_heads / a.n_kv_heads;
#define PD_LAUNCH(G)                                                      \
  return a.head_dim == D ? launch<T, EPW, NV, D, G, kCanBeFull>(a, stream) \
                         : launch<T, EPW, NV, D, G, false>(a, stream)
  if (group <= 1) PD_LAUNCH(1);
  if (group <= 2) PD_LAUNCH(2);
  if (group <= 4) PD_LAUNCH(4);
  if (group <= 8) PD_LAUNCH(8);
#undef PD_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
int paged_decode(const Args<T>& a, void* stream) {
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
  // the next instantiated width; f32 rows take two words a lane; int8 rows
  // of 8 (mod 16) codes take 8-byte words
  const int D = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
#define PD_D(EPW, NV, DIM) \
  if (D == DIM) return (int)dispatch_group<T, EPW, NV, DIM>(a, s);
#define PD_ALL_D(EPW, NV) \
  PD_D(EPW, NV, 32) PD_D(EPW, NV, 64) PD_D(EPW, NV, 128) PD_D(EPW, NV, 256)
  if constexpr (sizeof(T) == 4) {
    PD_ALL_D(4, 2)
  } else if constexpr (sizeof(T) == 2) {
    PD_ALL_D(8, 1)
  } else {
    if (hd % 16 != 0) {
      PD_ALL_D(8, 1)
    } else {
      PD_ALL_D(16, 1)
    }
  }
#undef PD_ALL_D
#undef PD_D
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The C entry points bound with ctypes.  q and out are contiguous f32
// (n_seqs, n_q_heads, head_dim), the pools (n_kv_heads, n_pages,
// page_size, head_dim) in the page dtype, tables and lengths int32, all
// on the current device; the caller allocates `out`.  Supported: head_dim
// a multiple of 8 up to 256, q_heads / kv_heads in 1..8.  The walk is
// split into n_splits spans of `span` pages
// (ops/paged_attention.py:decode_splits: (n_splits - 1) * span < width <=
// n_splits * span); with more than one split, `part` is an f32 scratch of
// n_seqs * n_kv_heads * n_splits * group * (head_dim + 2) words and
// `tickets` n_seqs * n_kv_heads int32 zeros, which the kernel leaves zero
// (one launch at a time on them).  A span's page ids (and int8's scales)
// sit in shared memory: an invalid value is returned when they do not
// fit.  Each returns the launch's cudaError_t (0 on success); nothing is
// synchronised.
extern "C" int paddle_paged_decode_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    void* part, void* tickets, int n_seqs, int n_q_heads, int n_kv_heads,
    int n_pages, int page_size, int width, int head_dim, float scale,
    int n_splits, int span, void* stream) {
  const Args<float> a{
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), nullptr, nullptr,
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), n_seqs,
      n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim, scale,
      n_splits, span};
  return paged_decode(a, stream);
}

// bf16 pages, widened to f32 exactly
extern "C" int paddle_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    void* part, void* tickets, int n_seqs, int n_q_heads, int n_kv_heads,
    int n_pages, int page_size, int width, int head_dim, float scale,
    int n_splits, int span, void* stream) {
  const Args<__nv_bfloat16> a{
      static_cast<const float*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), nullptr, nullptr,
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), n_seqs,
      n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim, scale,
      n_splits, span};
  return paged_decode(a, stream);
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
  const Args<int8_t> a{
      static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), n_seqs,
      n_q_heads, n_kv_heads, n_pages, page_size, width, head_dim, scale,
      n_splits, span};
  return paged_decode(a, stream);
}
