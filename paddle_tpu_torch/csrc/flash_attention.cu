// Flash attention for Hopper (sm_90a), in float32 and in bfloat16:
// forward, fused backward, and the split dQ and dK/dV backward, with
// attention-probs dropout regenerated inside every kernel.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels.py,
// each in both of the dtypes they take:
//
//   flash_fwd_{f32,bf16}        _fwd_single_block_kernel :203 and
//                               _fwd_kernel :150 (_flash_fwd :256-341)
//   flash_bwd_fused_{f32,bf16}  _bwd_fused_kernel :449 (_flash_bwd_fused :477)
//   flash_bwd_dq_{f32,bf16}     _bwd_dq_kernel :386    (_flash_bwd :523-574)
//   flash_bwd_dkv_{f32,bf16}    _bwd_dkv_kernel :413   (_flash_bwd :576-621)
//
// bf16.  Every kernel is a template on the storage type T of q, k, v, dO
// and the outputs; the padding bias, lse and delta stay float32, and all
// arithmetic (products, online softmax, dS) is float32, as on the TPU
// (preferred_element_type=float32).  With T = bf16 the kernels round where
// the TPU kernels cast: the dropped probabilities before the PV product
// (pd.astype(v.dtype), :190/:229) and before dV (:436/:470), dS before the
// dQ and dK products (ds.astype(k.dtype) / ds.astype(q.dtype), :405/:440/
// :467/:473), and each output once, at its store.  The forward rounds p
// relative to the running row max of its kv tile, as the TPU's blocked
// kernel does; the single-block TPU kernel rounds it relative to the
// final max, so the two differ in the last bf16 bit of some p.  dQ is
// never rounded before its last sum: the split dQ kernel keeps it in
// registers, and the fused kernel, whose CTA adds every kv tile's share
// into dQ in device memory, adds into a float32 scratch (b, h, sq, d)
// that the wrapper allocates, and converts it to bf16 once at the end
// (the TPU keeps an f32 VMEM scratch for the same reason, :393-410).
// With T = float the scratch is dQ itself and nothing is rounded, so the
// f32 kernels compute what they always did.
//
// Semantics (the JAX package's): q, k, v are (b, h, s, d) row-major;
// s = q.k * scale + bias[b, key] (the additive padding bias, optional),
// then DEFAULT_MASK_VALUE where key > query if causal; p = softmax(s).
// With dropout, the softmax normalises the UNDROPPED p and only the PV
// product sees the mask: out = (keep(p) / (1 - rate)) @ v.  lse = m + log l
// is (b, h, sq) float32 (the TPU's lane-broadcast (.., 128) copy is a
// layout artifact and is not kept).  A row whose l is 0 yields zeros and
// lse = m (the TPU kernel's l == 0 guard).  The backward recomputes P from
// lse:  dS = P * (keep(dP) / (1 - rate) - delta) * scale, with
// delta = rowsum(dO * O) computed by the caller; dQ = dS K, dK = dS^T Q,
// dV = keep(P)^T dO / (1 - rate).
//
// Bound.  At the BERT-base shape (b 44, h 12, s 512, d 64) the forward
// does 4 b h s^2 d = 35.4 GFLOP on 0.28 GB, about 127 flop per byte: on
// this card (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s) the
// kernels are bound by operations, not bytes.  The backward does
// 10 b h s^2 d (fused) on about twice the bytes.  In bf16 the bytes
// halve and the bound is the tensor cores' 989 TFLOP/s, which these SIMT
// kernels do not use: the bf16 kernels run at about the f32 kernels'
// speed, and tensor-core products (wgmma with bf16 operands, TMA loads)
// are the later work that closes the gap.
//
// Design.  The TPU walks the grid in order and carries the online softmax
// (m, l, acc) in VMEM from one kv block to the next; here a loop inside
// each CTA takes the place of that sequential grid axis, so no state
// crosses CTAs.  Every kernel works on 64 x 64 score tiles with 256
// threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of each score tile, and rows ty + 16 i, columns
// tx + 16 jd of each (64, d) accumulator.  Tiles of q, k, v and dO live in
// shared memory with a row stride of d + 1, so both the dot-product reads
// (16 different rows, one column) and the accumulate reads (one row, 16
// consecutive columns) are free of bank conflicts; the products are
// SIMT f32 FMAs (the reference is full f32; no TF32).  The 16 threads of
// a row are 16 consecutive lanes of one warp, so the row max and row sum
// are 4-step shuffles.  Ragged edges are masked in the kernel (rows past
// sq or keys past sk load as zeros and take no probability), so any
// sq, sk >= 1 is accepted; under causal masking the kv tiles wholly above
// the diagonal are skipped.
//
// * forward: grid (q tile, b h); the kv loop keeps m, l and the output
//   accumulator in registers; one kv tile is the single-block kernel
//   (row 1), more is the blocked one (row 2).
// * dQ: grid (q tile, b h), kv loop inside; dK/dV: grid (kv tile, b h),
//   q loop inside.  Each recomputes S and dP from lse, as the TPU kernels
//   do, so S is computed twice over the pair.
// * fused: one CTA per (b, h).  For each kv tile, dK and dV accumulate in
//   registers over every q tile; dQ of that q tile is read, added to and
//   written back in device memory.  Only this CTA touches this (b, h) and
//   each dQ element is always updated by the same thread, so there is no
//   race and no atomic, and the result is deterministic.
//
// Dropout.  A Philox-4x32-10 generator, keyed by the 64-bit seed and
// counted by (column group, query row, b h, offset), decides every
// element (b, h, i, j) on its own: column j takes word (j % 64) / 16 of
// the call for group (j / 64) * 16 + j % 16.  The mask is therefore the
// same in the forward, the fused and the split backward whatever their
// tiles (on the TPU it is drawn per block, pallas_kernels.py:135), and
// flash_dropout_mask writes it out through the same function, so a plain
// version can be fed exactly the kernels' mask.  Element kept iff its
// 32 random bits >= thresh = rate * 2^32 (the TPU kernel's rule).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLP = kTile + 1;   // row stride of a score tile in shared memory
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Attn {
  int h, sq, sk;
  float scale;
  int causal;
  const float* bias;             // (b, sk) or null
  const long long* seed;         // device scalar, or null: no dropout
  uint32_t thresh;               // keep iff bits >= thresh
  float keep_scale;              // 1 / (1 - rate)
  uint32_t offset;
};

// Loads, stores and the cast-and-back of one element of storage type T.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  // a bf16 is the high half of the float32 with the same value
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float((uint32_t)u << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// The random words of columns j, j + 16, j + 32, j + 48 of row i, for a
// column j with j % 64 < 16 (one Philox call).
__device__ __forceinline__ uint4 drop_bits(const Attn& a, uint64_t seed,
                                           int bh, int i, int j) {
  const uint32_t group = (uint32_t)((j >> 6) * 16 + (j & 15));
  return philox(make_uint4(group, (uint32_t)i, (uint32_t)bh, a.offset),
                (uint32_t)seed, (uint32_t)(seed >> 32));
}

__device__ __forceinline__ uint32_t word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of an (n, D) row-major matrix into s[64][D + 1];
// rows past n are zero
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ s,
                                          const T* __restrict__ g, int row0,
                                          int n) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    s[r * (D + 1) + c] =
        (row0 + r < n) ? Elem<T>::load(g + (size_t)(row0 + r) * D + c) : 0.f;
  }
}

// acc[i][j] = a[ty + 16 i] . b[tx + 16 j]   (a, b: [64][D + 1])
template <int D>
__device__ __forceinline__ void dot_tile(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         float (&acc)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][jd] += sum_c p[ty + 16 i][c] * x[c][tx + 16 jd]
//   (p: [64][65] score tile, x: [64][D + 1]) -- O += P V, dQ += dS K
template <int D>
__device__ __forceinline__ void acc_rows(const float* __restrict__ p,
                                         const float* __restrict__ x,
                                         float (&acc)[4][D / 16], int ty,
                                         int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float pv[4], xv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kLP + c];
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) xv[jd] = x[c * (D + 1) + tx + 16 * jd];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd)
        acc[i][jd] = fmaf(pv[i], xv[jd], acc[i][jd]);
  }
}

// acc[i][jd] += sum_r p[r][ty + 16 i] * x[r][tx + 16 jd]
//   (the transposed product) -- dV += PD^T dO, dK += dS^T Q
template <int D>
__device__ __forceinline__ void acc_cols(const float* __restrict__ p,
                                         const float* __restrict__ x,
                                         float (&acc)[4][D / 16], int ty,
                                         int tx) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pv[4], xv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[r * kLP + ty + 16 * i];
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) xv[jd] = x[r * (D + 1) + tx + 16 * jd];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd)
        acc[i][jd] = fmaf(pv[i], xv[jd], acc[i][jd]);
  }
}

// The scaled, biased, masked score of tile element (i, j); -inf past sk.
__device__ __forceinline__ float score(const Attn& a, float dot, float bias,
                                       int r, int c) {
  if (c >= a.sk) return -INFINITY;
  float x = dot * a.scale + bias;
  if (a.causal && c > r) x = kMaskValue;
  return x;
}

// Number of kv tiles the q tile at row0 reads.
__device__ __forceinline__ int kv_tiles(const Attn& a, int row0) {
  int n = (a.sk + kTile - 1) / kTile;
  if (a.causal) n = min(n, min(row0 + kTile - 1, a.sq - 1) / kTile + 1);
  return n;
}

// First q tile that reads the kv tile at col0.
__device__ __forceinline__ int first_q_tile(const Attn& a, int col0) {
  return a.causal ? col0 / kTile : 0;
}

// The backward's per-tile terms: from the dot products s = Q.K and
// dp = dO.V of the tile at (row0, col0), the dropped probabilities
// pd -> ps and dS -> dss (both [64][65] in shared memory), each rounded
// to T as the products that read them take it.
template <typename T>
__device__ __forceinline__ void bwd_terms(const Attn& a, uint64_t seed,
                                          int bh, int bi, int row0, int col0,
                                          const float (&s)[4][4],
                                          const float (&dp)[4][4],
                                          const float (&lse)[4],
                                          const float (&delta)[4],
                                          float* __restrict__ ps,
                                          float* __restrict__ dss, int ty,
                                          int tx) {
  float bj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + tx + 16 * j;
    bj[j] = (a.bias != nullptr && c < a.sk) ? __ldg(a.bias + (size_t)bi * a.sk + c)
                                            : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (a.seed != nullptr) bits = drop_bits(a, seed, bh, r, col0 + tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      const bool valid = r < a.sq && c < a.sk;
      const float p =
          valid ? expf(score(a, s[i][j], bj[j], r, c) - lse[i]) : 0.f;
      float pd = p, dpd = dp[i][j];
      if (a.seed != nullptr) {
        const bool keep = word(bits, j) >= a.thresh;
        pd = keep ? p * a.keep_scale : 0.f;
        dpd = keep ? dpd * a.keep_scale : 0.f;
      }
      ps[(ty + 16 * i) * kLP + tx + 16 * j] = Elem<T>::round(pd);
      dss[(ty + 16 * i) * kLP + tx + 16 * j] =
          Elem<T>::round(p * (dpd - delta[i]) * a.scale);
    }
  }
}

// ---------------------------------------------------------------- forward
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Attn a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, VD = D / 16;
  float* qs = smem;
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  const int bh = blockIdx.y, bi = bh / a.h;
  const int row0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * a.sq * D, koff = (size_t)bh * a.sk * D;
  const uint64_t seed = a.seed != nullptr ? (uint64_t)*a.seed : 0ull;

  load_tile<D>(qs, q + qoff, row0, a.sq);
  float m[4], l[4], acc[4][VD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < VD; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kv = kv_tiles(a, row0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();   // the previous tile's ks, vs, ps are consumed
    load_tile<D>(ks, k + koff, col0, a.sk);
    load_tile<D>(vs, v + koff, col0, a.sk);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(qs, ks, s, ty, tx);
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      bj[j] = (a.bias != nullptr && c < a.sk)
                  ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(a, s[i][j], bj[j], r, col0 + tx + 16 * j);
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_next = fmaxf(m[i], row_max16(mc));
      const float base = m_next == -INFINITY ? 0.f : m_next;
      const float alpha = expf(m[i] - base);
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (a.seed != nullptr) bits = drop_bits(a, seed, bh, r, col0 + tx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - base);
        rs += p;
        float pd = p;
        if (a.seed != nullptr)
          pd = word(bits, j) >= a.thresh ? p * a.keep_scale : 0.f;
        ps[(ty + 16 * i) * kLP + tx + 16 * j] = Elem<T>::round(pd);
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_next;
#pragma unroll
      for (int jd = 0; jd < VD; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
    acc_rows<D>(ps, vs, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= a.sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int jd = 0; jd < VD; ++jd)
      Elem<T>::store(out + qoff + (size_t)r * D + tx + 16 * jd,
                     acc[i][jd] * inv);
    if (tx == 0) lse[(size_t)bh * a.sq + r] = m[i] + logf(l_safe);
  }
}

// -------------------------------------------------------- backward: dQ
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Attn a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, VD = D / 16;
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  float* dss = ps + kTile * kLP;
  const int bh = blockIdx.y, bi = bh / a.h;
  const int row0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * a.sq * D, koff = (size_t)bh * a.sk * D;
  const uint64_t seed = a.seed != nullptr ? (uint64_t)*a.seed : 0ull;

  load_tile<D>(qs, q + qoff, row0, a.sq);
  load_tile<D>(dos, dout + qoff, row0, a.sq);
  float lr[4], dr[4], acc[4][VD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    lr[i] = r < a.sq ? __ldg(lse + (size_t)bh * a.sq + r) : 0.f;
    dr[i] = r < a.sq ? __ldg(delta + (size_t)bh * a.sq + r) : 0.f;
#pragma unroll
    for (int jd = 0; jd < VD; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kv = kv_tiles(a, row0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();
    load_tile<D>(ks, k + koff, col0, a.sk);
    load_tile<D>(vs, v + koff, col0, a.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(qs, ks, s, ty, tx);
    dot_tile<D>(dos, vs, dp, ty, tx);
    bwd_terms<T>(a, seed, bh, bi, row0, col0, s, dp, lr, dr, ps, dss, ty,
                 tx);
    __syncthreads();
    acc_rows<D>(dss, ks, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= a.sq) continue;
#pragma unroll
    for (int jd = 0; jd < VD; ++jd)
      Elem<T>::store(dq + qoff + (size_t)r * D + tx + 16 * jd, acc[i][jd]);
  }
}

// ----------------------------------- backward: dK/dV, and the fused form
// FUSED = false: grid (kv tile, b h), this CTA's kv tile is blockIdx.x.
// FUSED = true:  grid (b h), the CTA walks every kv tile and also adds
//                into dq_acc (float32, in device memory); for T = bf16 it
//                then writes dq from dq_acc, for T = float dq_acc is dq.
template <int D, bool FUSED, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq_acc,
                    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                    Attn a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, VD = D / 16;
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;
  float* dss = ps + kTile * kLP;
  const int bh = FUSED ? blockIdx.x : blockIdx.y;
  const int bi = bh / a.h;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * a.sq * D, koff = (size_t)bh * a.sk * D;
  const uint64_t seed = a.seed != nullptr ? (uint64_t)*a.seed : 0ull;
  const int n_q = (a.sq + kTile - 1) / kTile;
  const int kt_begin = FUSED ? 0 : (int)blockIdx.x;
  const int kt_end = FUSED ? (a.sk + kTile - 1) / kTile : (int)blockIdx.x + 1;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();   // the previous kv tile's last products are done
    load_tile<D>(ks, k + koff, col0, a.sk);
    load_tile<D>(vs, v + koff, col0, a.sk);
    float dka[4][VD], dva[4][VD];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jd = 0; jd < VD; ++jd) dka[i][jd] = dva[i][jd] = 0.f;

    for (int qt = first_q_tile(a, col0); qt < n_q; ++qt) {
      const int row0 = qt * kTile;
      __syncthreads();   // qs, dos, ps, dss of the last q tile are consumed
      load_tile<D>(qs, q + qoff, row0, a.sq);
      load_tile<D>(dos, dout + qoff, row0, a.sq);
      float lr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + ty + 16 * i;
        lr[i] = r < a.sq ? __ldg(lse + (size_t)bh * a.sq + r) : 0.f;
        dr[i] = r < a.sq ? __ldg(delta + (size_t)bh * a.sq + r) : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<D>(qs, ks, s, ty, tx);
      dot_tile<D>(dos, vs, dp, ty, tx);
      bwd_terms<T>(a, seed, bh, bi, row0, col0, s, dp, lr, dr, ps, dss, ty,
                   tx);
      __syncthreads();
      acc_cols<D>(ps, dos, dva, ty, tx);
      acc_cols<D>(dss, qs, dka, ty, tx);
      if (FUSED) {
        float dqa[4][VD];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jd = 0; jd < VD; ++jd) dqa[i][jd] = 0.f;
        acc_rows<D>(dss, ks, dqa, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + ty + 16 * i;
          if (r >= a.sq) continue;
#pragma unroll
          for (int jd = 0; jd < VD; ++jd) {
            float* p = dq_acc + qoff + (size_t)r * D + tx + 16 * jd;
            // kv tile 0 reads every q tile first: it initialises dQ
            *p = (kt == 0 ? 0.f : *p) + dqa[i][jd];
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = col0 + ty + 16 * i;
      if (c >= a.sk) continue;
#pragma unroll
      for (int jd = 0; jd < VD; ++jd) {
        Elem<T>::store(dk + koff + (size_t)c * D + tx + 16 * jd, dka[i][jd]);
        Elem<T>::store(dv + koff + (size_t)c * D + tx + 16 * jd, dva[i][jd]);
      }
    }
  }

  if (FUSED && (const void*)dq != (const void*)dq_acc) {
    // dq_acc's elements were each written by this thread only (the same
    // (ty, tx) slots of every q tile), so it reads back its own sums
    for (int row0 = 0; row0 < a.sq; row0 += kTile) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + ty + 16 * i;
        if (r >= a.sq) continue;
#pragma unroll
        for (int jd = 0; jd < VD; ++jd) {
          const size_t o = qoff + (size_t)r * D + tx + 16 * jd;
          Elem<T>::store(dq + o, dq_acc[o]);
        }
      }
    }
  }
}

// ------------------------------------------------------- dropout mask out
// keep[bh, i, j] (uint8) through the kernels' own drop_bits; grid
// (kv tile, 16-row group, b h), 256 threads as 16 rows x 16 columns.
__global__ void __launch_bounds__(kThreads)
flash_dropout_mask_kernel(unsigned char* __restrict__ keep, Attn a) {
  const int bh = blockIdx.z;
  const int i = blockIdx.y * 16 + threadIdx.x / 16;
  const int j0 = blockIdx.x * kTile + threadIdx.x % 16;
  if (i >= a.sq) return;
  const uint4 bits = drop_bits(a, (uint64_t)*a.seed, bh, i, j0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = j0 + 16 * j;
    if (c < a.sk)
      keep[((size_t)bh * a.sq + i) * a.sk + c] = word(bits, j) >= a.thresh;
  }
}

constexpr size_t fwd_smem(int d) {
  return sizeof(float) * (3 * kTile * (d + 1) + kTile * kLP);
}
constexpr size_t bwd_smem(int d) {
  return sizeof(float) * (4 * kTile * (d + 1) + 2 * kTile * kLP);
}

// Above 48 KB a kernel's dynamic shared memory must be allowed once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Attn make_attn(int h, int sq, int sk, float scale, int causal,
               const float* bias, const long long* seed, unsigned int thresh,
               float keep_scale, unsigned int offset) {
  Attn a;
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.causal = causal;
  a.bias = bias;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.offset = offset;
  return a;
}

template <int D, typename T>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, T* out, float* lse,
                       int b, const Attn& a, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kTile - 1) / kTile, b * a.h);
  flash_fwd_kernel<D, T><<<grid, kThreads, smem, stream>>>(q, k, v, out, lse,
                                                           a);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, T* dq, int b,
                      const Attn& a, cudaStream_t stream) {
  const size_t smem = bwd_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kTile - 1) / kTile, b * a.h);
  flash_bwd_dq_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, a);
  return cudaGetLastError();
}

template <int D, bool FUSED, typename T>
cudaError_t launch_kv(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, float* dq_acc,
                      T* dq, T* dk, T* dv, int b, const Attn& a,
                      cudaStream_t stream) {
  const size_t smem = bwd_smem(D);
  cudaError_t err = allow_smem(flash_bwd_kv_kernel<D, FUSED, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid = FUSED ? dim3(b * a.h) : dim3((a.sk + kTile - 1) / kTile, b * a.h);
  flash_bwd_kv_kernel<D, FUSED, T><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, a);
  return cudaGetLastError();
}

// The entry points' bodies, one per kernel, for either storage type.
template <typename T>
int fwd_entry(const T* q, const T* k, const T* v, T* out, float* lse, int b,
              int d, const Attn& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_fwd<32>(q, k, v, out, lse, b, a, stream);
    case 64: return launch_fwd<64>(q, k, v, out, lse, b, a, stream);
    case 128: return launch_fwd<128>(q, k, v, out, lse, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dq_entry(const T* q, const T* k, const T* v, const T* dout,
             const float* lse, const float* delta, T* dq, int b, int d,
             const Attn& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, b, a, stream);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, b, a, stream);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED, typename T>
int kv_entry(const T* q, const T* k, const T* v, const T* dout,
             const float* lse, const float* delta, float* dq_acc, T* dq,
             T* dk, T* dv, int b, int d, const Attn& a, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_kv<32, FUSED>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                  dv, b, a, stream);
    case 64:
      return launch_kv<64, FUSED>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                  dv, b, a, stream);
    case 128:
      return launch_kv<128, FUSED>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                   dv, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points: every pointer is a device pointer (bias and seed may be
// null), launches go on `stream`, and each returns the cudaError_t of the
// launch.  d must be 32, 64 or 128 (else cudaErrorInvalidValue).  The
// _bf16 functions take q, k, v, dout and the outputs in bf16; bias, lse
// and delta are float32 in both.
#define ATTN_ARGS                                                        \
  int h, int sq, int sk, int d, float scale, int causal,                 \
      const long long *seed, unsigned int thresh, float keep_scale,      \
      unsigned int offset, cudaStream_t stream
#define MAKE_ATTN \
  make_attn(h, sq, sk, scale, causal, bias, seed, thresh, keep_scale, offset)

typedef __nv_bfloat16 bf16;

extern "C" {

int paddle_flash_fwd_f32(const float* q, const float* k, const float* v,
                         const float* bias, float* out, float* lse, int b,
                         ATTN_ARGS) {
  return fwd_entry(q, k, v, out, lse, b, d, MAKE_ATTN, stream);
}

int paddle_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                          const float* bias, bf16* out, float* lse, int b,
                          ATTN_ARGS) {
  return fwd_entry(q, k, v, out, lse, b, d, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                            const float* bias, const float* dout,
                            const float* lse, const float* delta, float* dq,
                            int b, ATTN_ARGS) {
  return dq_entry(q, k, v, dout, lse, delta, dq, b, d, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                             const float* bias, const bf16* dout,
                             const float* lse, const float* delta, bf16* dq,
                             int b, ATTN_ARGS) {
  return dq_entry(q, k, v, dout, lse, delta, dq, b, d, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                             const float* bias, const float* dout,
                             const float* lse, const float* delta, float* dk,
                             float* dv, int b, ATTN_ARGS) {
  return kv_entry<false>(q, k, v, dout, lse, delta, (float*)nullptr,
                         (float*)nullptr, dk, dv, b, d, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const float* bias, const bf16* dout,
                              const float* lse, const float* delta, bf16* dk,
                              bf16* dv, int b, ATTN_ARGS) {
  return kv_entry<false>(q, k, v, dout, lse, delta, (float*)nullptr,
                         (bf16*)nullptr, dk, dv, b, d, MAKE_ATTN, stream);
}

int paddle_flash_bwd_fused_f32(const float* q, const float* k, const float* v,
                               const float* bias, const float* dout,
                               const float* lse, const float* delta, float* dq,
                               float* dk, float* dv, int b, ATTN_ARGS) {
  return kv_entry<true>(q, k, v, dout, lse, delta, dq, dq, dk, dv, b, d,
                        MAKE_ATTN, stream);
}

// dq_acc: a float32 (b, h, sq, d) scratch the kernel fully writes
int paddle_flash_bwd_fused_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const float* bias, const bf16* dout,
                                const float* lse, const float* delta,
                                float* dq_acc, bf16* dq, bf16* dk, bf16* dv,
                                int b, ATTN_ARGS) {
  return kv_entry<true>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, b, d,
                        MAKE_ATTN, stream);
}

int paddle_flash_dropout_mask(unsigned char* keep, int b, int h, int sq,
                              int sk, const long long* seed,
                              unsigned int thresh, unsigned int offset,
                              cudaStream_t stream) {
  const Attn a = make_attn(h, sq, sk, 1.f, 0, nullptr, seed, thresh, 1.f,
                           offset);
  dim3 grid((sk + kTile - 1) / kTile, (sq + 15) / 16, b * h);
  flash_dropout_mask_kernel<<<grid, kThreads, 0, stream>>>(keep, a);
  return cudaGetLastError();
}

}  // extern "C"
