// Exact-erf GELU on bfloat16 and float16 tensors, forward and backward,
// for Hopper (sm_90a), rounding where the JAX package's compiled lowering
// rounds.
//
// Replaces no Pallas kernel: the JAX package computes a low-precision gelu
// with jax.nn.gelu(approximate=False) (paddle_tpu/ops/math_ops.py, the
// "gelu" activation), which XLA fuses into one elementwise loop.  Its
// compiled form on the CPU keeps these roundings (read from the compiled
// HLO's surviving converts, and checked against jax.jit on every finite
// 16-bit input, tests/test_torch_gelu_lowp.py).  bf16:
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
// in PyTorch.
//
// What bounds them: bytes (2 bytes read and 2 written per element
// forward, 4 read and 2 written backward).  Evaluated op for op, XLA's
// erfc (both tail polynomials, two reciprocals, an exp; each step two
// uncontracted instructions) and the flushes cost about 120 instructions
// an element forward and 200 backward: three times the bytes' time.  So
// what depends on x alone, e = erfc(u) and ee = exp(-u^2) (16-bit values),
// is computed once per device into tables indexed by x's bits
// (gelu_tables_kernel, by Gelu<T> op for op as above, with __fmul_rn /
// __fadd_rn so nvcc does not contract them, __frcp_rn, the explicit
// flushes and exp correctly rounded, as the CPU's and XLA's exp are on
// these inputs):
//   * e and ee for |x| in a band [lo, hi) of each sign: below lo a term
//     is that of lo, from hi - 1 up (Inf included; a NaN x gives a NaN
//     output whatever they are) that of hi - 1, so the index is |x|
//     clamped into the band.  bf16 pairs e and ee in one 32-bit entry
//     over one band; fp16 keeps ee (even in x) in its own band of one
//     sign, and its e band starts at |u| = 1: below it the kernels
//     evaluate erfc's small branch, 1 - u p(u^2), with fmas (which round
//     to the same fp16 on every input there).
//   The bands (ops/gelu.py:GELU_BANDS) are proven on every input
//   (tests/test_torch_gelu_lowp.py): bf16 12.7 KB, fp16 24.6 KB.
// The forward is then rb(rb(0.5 x) * e), the backward the dy-dependent
// chain above: in bf16 each rounded product is a mul.rn.ftz.f32 and half
// a cvt (two elements share one): every product and sum there is of two
// normal bf16 values or zeros, so the hardware's flush equals the CPU's
// flush of the rounded f32 result; in fp16 each is half a mul.rn.f16x2
// (fp16 x fp16 is exact in f32, so one fp16 rounding of the f32 product is
// the correctly rounded fp16 product, subnormals kept).
//
// Where x, dy and the output are 16-byte aligned and n a multiple of 8,
// each CTA loads a contiguous chunk, 16 bytes a thread and access, copies
// the tables into shared memory and gathers from them
// (gelu_chunk_kernel); other launches take an element-wise kernel
// (gelu_scalar_kernel).
//
// C interface (ctypes, paddle_tpu_torch/ops/gelu.py); each returns the
// launch's cudaError_t:
//   paddle_gelu_tables_{bf16,fp16}(tables, lo_e, span_e, lo_ee, span_ee,
//                                  stream)
//   paddle_gelu_fwd_{bf16,fp16}(x, y, n, tables, lo_e, span_e, lo_ee,
//                               span_ee, stream)
//   paddle_gelu_bwd_{bf16,fp16}(x, dy, dx, n, tables, lo_e, span_e, lo_ee,
//                               span_ee, stream)
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
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

// exp correctly rounded to f32 (by way of f64), as the CPU's exp is on the
// inputs the tables need; expf's result can be a rounding step off, and
// at bf16 x = -1.71875 that moves e across a bf16 rounding tie
__device__ __forceinline__ float exp_rn(float v) {
  return (float)exp((double)v);
}

// XLA's f32 erfc for |u| < 1: 1 - u p(u^2), op for op
__device__ __forceinline__ float erfc_small(float u) {
  const float z = mul(u, u);
  float p = add(mul(z, 7.85386146e-05f), -0.000801019371f);
  p = add(mul(p, z), 0.00518832775f);
  p = add(mul(p, z), -0.0268538129f);
  p = add(mul(p, z), 0.112835854f);
  p = add(mul(p, z), -0.37612626f);
  p = add(mul(p, z), 1.12837911f);
  return __fsub_rn(1.f, mul(u, p));
}

// The same with each step contracted into one fma: on every fp16 u with
// |u| < 1 it rounds to the same fp16 as erfc_small (proven on all 30,720,
// tests/test_torch_gelu_lowp.py), in half the instructions
__device__ __forceinline__ float erfc_small_fma(float u) {
  const float z = mul(u, u);
  float p = __fmaf_rn(z, 7.85386146e-05f, -0.000801019371f);
  p = __fmaf_rn(p, z, 0.00518832775f);
  p = __fmaf_rn(p, z, -0.0268538129f);
  p = __fmaf_rn(p, z, 0.112835854f);
  p = __fmaf_rn(p, z, -0.37612626f);
  p = __fmaf_rn(p, z, 1.12837911f);
  return __fmaf_rn(-u, p, 1.f);
}

// XLA's f32 erfc (the Cephes erfcf polynomials), op for op
__device__ float erfc_xla(float u) {
  const float au = fabsf(u);
  const float z = mul(u, u);
  const float small = erfc_small(u);
  const float q = ftz(mul(ftz(exp_rn(-z)), __frcp_rn(au)));
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

// What depends on x alone, op for op: the backward's e and ee (the
// forward's e too), in f32 registers.
template <typename T>
struct Gelu;

template <>
struct Gelu<__nv_bfloat16> {
  static __device__ __forceinline__ float in(uint16_t b) {
    return in16(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ uint16_t out(float v) {
    return __bfloat16_as_ushort(out16(v));
  }
  static __device__ __forceinline__ void xterms(float x, float& e,
                                                float& ee) {
    const float u32 = mul(x, -0.70703125f);
    e = rb(erfc_xla(u32));
    const float u = rb(u32);
    ee = rb(ftz(exp_rn(-rb(mul(u, u)))));
  }
};

template <>
struct Gelu<__half> {
  static __device__ __forceinline__ float in(uint16_t b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ uint16_t out(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
  static __device__ __forceinline__ void xterms(float x, float& e,
                                                float& ee) {
    const float u = rh(mul(x, -0.70703125f));
    e = rh(erfc_xla(u));
    ee = rh(exp_rn(-rh(mul(u, u))));
  }
};

// ------------------------------------------------------------ the tables
// The tables of one dtype, one array of 16-bit values, for |x| in a band
// [lo, lo + span) of each sign (entry sign * span + |x| - lo):
//   * bf16: e and ee share one band, paired in a 32-bit entry (e low);
//   * fp16: e over [lo_e, lo_e + span_e), then, from ee_off() on, ee over
//     its own band [lo_ee, lo_ee + span_ee) of one sign (ee is even in x).
struct Bands {
  int lo_e, span_e, lo_ee, span_ee;
  __host__ __device__ int ee_off() const { return (2 * span_e + 7) / 8 * 8; }
};

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// the 16-bit values of the tables (all of them, or the forward's share)
template <typename T, bool BWD>
__host__ __device__ __forceinline__ int table_len(const Bands& k) {
  if (!kIsHalf<T>) return 4 * k.span_e;
  return BWD ? k.ee_off() + k.span_ee : 2 * k.span_e;
}

// thread i: entry i of e (and of the paired or separate ee)
template <typename T>
__global__ void __launch_bounds__(256)
gelu_tables_kernel(uint16_t* __restrict__ tables, Bands k) {
  using G = Gelu<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float e, ee;
  if (i < 2 * k.span_e) {
    const int sign = i >= k.span_e;
    G::xterms(G::in((uint16_t)((sign << 15) | (k.lo_e + i - sign * k.span_e))),
              e, ee);
    if (kIsHalf<T>) {
      tables[i] = G::out(e);
    } else {
      tables[2 * i] = G::out(e);
      tables[2 * i + 1] = G::out(ee);
    }
  }
  if (kIsHalf<T> && i < k.span_ee) {
    G::xterms(G::in((uint16_t)(k.lo_ee + i)), e, ee);
    tables[k.ee_off() + i] = G::out(ee);
  }
}

// --------------------------------------------------- forward and backward
__device__ __forceinline__ float mulz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float addz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ float h_lo(uint32_t v) {
  return __half2float(__ushort_as_half((uint16_t)(v & 0xFFFFu)));
}
__device__ __forceinline__ float h_hi(uint32_t v) {
  return __half2float(__ushort_as_half((uint16_t)(v >> 16)));
}
// the low and high bf16 of a word as f32
__device__ __forceinline__ float b_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float b_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// a and b rounded to bf16 (nearest even) by one cvt: a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two flushed f32 values rounded to bf16, kept as f32
__device__ __forceinline__ void rb2(float& a, float& b) {
  const uint32_t p = pack_bf16(a, b);
  a = b_lo(p);
  b = b_hi(p);
}

// The index of input bits b (in the low 16 bits): |x| clamped into the
// band, each sign its own half.
__device__ __forceinline__ int band_index(uint32_t b, int lo, int span) {
  return (int)((b >> 15) & 1u) * span +
         min(max((int)(b & 0x7FFFu), lo), lo + span - 1) - lo;
}

// fp16's e and ee of input bits b as 16-bit values: e from its band, or,
// where |u| < 1 (u the fp16 bits of fp16(-0.70703125 x)), XLA's small
// erfc evaluated; ee from its band of |x|
__device__ __forceinline__ uint32_t e_half(uint32_t b, uint32_t u,
                                           const uint16_t* tab,
                                           const Bands& k) {
  const uint32_t t = tab[band_index(b, k.lo_e, k.span_e)];
  if ((u & 0x7FFFu) >= 0x3C00u) return t;   // |u| >= 1, or NaN
  return __half_as_ushort(__float2half_rn(
      erfc_small_fma(__half2float(__ushort_as_half((uint16_t)u)))));
}
__device__ __forceinline__ uint32_t ee_half(uint32_t b, const uint16_t* tab,
                                            const Bands& k) {
  return tab[k.ee_off() + band_index(b & 0x7FFFu, k.lo_ee, k.span_ee)];
}

// bf16: two elements at once, x and dy two bf16 values a word, ea and eb
// the (e, ee) entries of the low and the high one (e in the low half)
__device__ __forceinline__ uint32_t bf16_fwd2(uint32_t x2, uint32_t ea,
                                              uint32_t eb) {
  float a = mulz(b_lo(x2), 0.5f), b = mulz(b_hi(x2), 0.5f);
  rb2(a, b);                                         // rb(0.5 x)
  return pack_bf16(mulz(a, b_lo(ea)), mulz(b, b_lo(eb)));   // * e
}
__device__ __forceinline__ uint32_t bf16_bwd2(uint32_t x2, uint32_t d2,
                                              uint32_t ea, uint32_t eb) {
  const float da = b_lo(d2), db = b_hi(d2);
  float a = mulz(b_lo(x2), 0.5f), b = mulz(b_hi(x2), 0.5f);
  rb2(a, b);                                         // rb(0.5 x)
  a = mulz(a, da);                                   // r2
  b = mulz(b, db);
  rb2(a, b);
  a = mulz(a, -1.125f);                              // r3
  b = mulz(b, -1.125f);
  rb2(a, b);
  a = mulz(a, b_hi(ea));                             // r3 * ee
  b = mulz(b, b_hi(eb));
  rb2(a, b);
  a = mulz(a, -0.70703125f);                         // t1
  b = mulz(b, -0.70703125f);
  rb2(a, b);
  float c = mulz(da, b_lo(ea)), d = mulz(db, b_lo(eb));     // dy * e
  rb2(c, d);
  c = mulz(c, 0.5f);                                 // t2
  d = mulz(d, 0.5f);
  rb2(c, d);
  return pack_bf16(addz(a, c), addz(b, d));          // t1 + t2
}

// fp16: two elements at once, x, dy, e and ee two fp16 values a word
constexpr uint32_t kHalf2 = 0x38003800u;             // 0.5, 0.5
__device__ __forceinline__ uint32_t half_fwd2(uint32_t x2, uint32_t e2) {
  return hmul2(hmul2(x2, kHalf2), e2);
}
__device__ __forceinline__ uint32_t half_bwd2(uint32_t x2, uint32_t d2,
                                              uint32_t e2, uint32_t ee2) {
  // r3 = fp16(fp16(fp16(0.5 x) * dy) * -1.1279296875)
  const uint32_t r3 = hmul2(hmul2(hmul2(x2, kHalf2), d2), 0xBC83BC83u);
  const uint32_t m3 = hmul2(r3, ee2);
  const uint32_t t2 = hmul2(hmul2(d2, e2), kHalf2);
  // t2 - m3 * 0.70703125 rounded once: the product is exact in f32
  const float lo = __fmaf_rn(-h_lo(m3), 0.70703125f, h_lo(t2));
  const float hi = __fmaf_rn(-h_hi(m3), 0.70703125f, h_hi(t2));
  return (uint32_t)__half_as_ushort(__float2half_rn(lo)) |
         ((uint32_t)__half_as_ushort(__float2half_rn(hi)) << 16);
}

// the outputs of one word of x (and dy): two elements
template <typename T, bool BWD>
__device__ __forceinline__ uint32_t word(uint32_t x2, uint32_t d2,
                                         const uint16_t* tab, const Bands& k) {
  if constexpr (!kIsHalf<T>) {
    const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tab);
    const uint32_t ea = t32[band_index(x2 & 0xFFFFu, k.lo_e, k.span_e)];
    const uint32_t eb = t32[band_index(x2 >> 16, k.lo_e, k.span_e)];
    return BWD ? bf16_bwd2(x2, d2, ea, eb) : bf16_fwd2(x2, ea, eb);
  } else {
    // u = fp16(-0.70703125 x), one correctly rounded fp16 product
    const uint32_t u2 = hmul2(x2, 0xB9A8B9A8u);
    const uint32_t e2 = e_half(x2 & 0xFFFFu, u2 & 0xFFFFu, tab, k) |
                        (e_half(x2 >> 16, u2 >> 16, tab, k) << 16);
    if (!BWD) return half_fwd2(x2, e2);
    const uint32_t ee2 = ee_half(x2 & 0xFFFFu, tab, k) |
                         (ee_half(x2 >> 16, tab, k) << 16);
    return half_bwd2(x2, d2, e2, ee2);
  }
}

// the tables one direction reads, in 16-byte words
template <typename T, bool BWD>
__device__ __host__ __forceinline__ int table_words(const Bands& k) {
  return (table_len<T, BWD>(k) + 7) / 8;
}

__device__ __forceinline__ void stage_tables(uint4* smem,
                                             const uint16_t* tables,
                                             int words, int threads) {
  const uint4* t4 = reinterpret_cast<const uint4*>(tables);
  for (int i = threadIdx.x; i < words; i += threads) smem[i] = __ldg(t4 + i);
}

// The aligned path: one CTA per contiguous chunk of kThreads * unroll
// 16-byte words of x (and dy), four CTAs an SM at most 64 registers a
// thread (the fastest of the thread counts and unrolls measured, and the
// largest without spills): a CTA issues its loads first, then copies the
// tables it reads into shared memory, then gathers and stores.  (On the
// H100, persistent CTAs, which would copy the tables once per SM,
// streamed slower even without arithmetic, whether each thread strode
// through memory or thread 0 kept a ring of bulk asynchronous copies in
// flight.)
constexpr int kFwdUnroll = 4;
constexpr int kBwdUnroll = 2;

template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads, 4)
gelu_chunk_kernel(const uint4* __restrict__ x, const uint4* __restrict__ dy,
                  uint4* __restrict__ out, long long n8,
                  const uint16_t* __restrict__ tables, Bands k) {
  extern __shared__ uint4 smem_chunk[];
  constexpr int U = BWD ? kBwdUnroll : kFwdUnroll;
  const long long base = (long long)blockIdx.x * kThreads * U + threadIdx.x;
  uint4 xv[U], dv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = base + (long long)u * kThreads;
    if (j < n8) {
      xv[u] = __ldg(x + j);
      if (BWD) dv[u] = __ldg(dy + j);
    }
  }
  stage_tables(smem_chunk, tables, table_words<T, BWD>(k), kThreads);
  __syncthreads();
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem_chunk);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = base + (long long)u * kThreads;
    if (j < n8) {
      const uint4 d = BWD ? dv[u] : xv[u];
      out[j] = make_uint4(word<T, BWD>(xv[u].x, d.x, tab, k),
                          word<T, BWD>(xv[u].y, d.y, tab, k),
                          word<T, BWD>(xv[u].z, d.z, tab, k),
                          word<T, BWD>(xv[u].w, d.w, tab, k));
    }
  }
}

// Any other size or alignment: one CTA per kScalarPerThread * kThreads
// elements, the tables in shared memory, element by element.
constexpr int kScalarPerThread = 16;

template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads)
gelu_scalar_kernel(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ dy,
                   uint16_t* __restrict__ out, long long n,
                   const uint16_t* __restrict__ tables, Bands k) {
  extern __shared__ uint4 smem_tab[];
  stage_tables(smem_tab, tables, table_words<T, BWD>(k), kThreads);
  __syncthreads();
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem_tab);
  const long long base =
      (long long)blockIdx.x * kThreads * kScalarPerThread + threadIdx.x;
  for (int u = 0; u < kScalarPerThread; ++u) {
    const long long j = base + (long long)u * kThreads;
    if (j < n)
      out[j] = (uint16_t)word<T, BWD>(x[j], BWD ? dy[j] : 0u, tab, k);
  }
}

// ------------------------------------------------------------------ host
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool bands_ok(const Bands& k) {
  return k.lo_e >= 0 && k.span_e >= 1 && k.lo_e + k.span_e <= 0x8000 &&
         k.lo_ee >= 0 && k.span_ee >= 1 && k.lo_ee + k.span_ee <= 0x8000;
}

template <typename T, bool BWD>
cudaError_t launch_chunks(const void* x, const void* dy, void* out,
                          long long n, const void* tables, const Bands& k,
                          cudaStream_t stream) {
  const size_t smem = (size_t)table_words<T, BWD>(k) * 16;
  const long long per_cta = (long long)kThreads * (BWD ? kBwdUnroll
                                                       : kFwdUnroll);
  const long long blocks = (n / 8 + per_cta - 1) / per_cta;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gelu_chunk_kernel<T, BWD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  gelu_chunk_kernel<T, BWD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(dy),
      static_cast<uint4*>(out), n / 8, static_cast<const uint16_t*>(tables),
      k);
  return cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t launch_scalar(const void* x, const void* dy, void* out,
                          long long n, const void* tables, const Bands& k,
                          cudaStream_t stream) {
  const size_t smem = (size_t)table_words<T, BWD>(k) * 16;
  const long long per_cta = (long long)kThreads * kScalarPerThread;
  const long long blocks = (n + per_cta - 1) / per_cta;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gelu_scalar_kernel<T, BWD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  gelu_scalar_kernel<T, BWD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
      static_cast<uint16_t*>(out), n, static_cast<const uint16_t*>(tables),
      k);
  return cudaGetLastError();
}

template <typename T, bool BWD>
int gelu(const void* x, const void* dy, void* out, long long n,
         const void* tables, Bands k, void* stream_ptr) {
  if (n <= 0 || !bands_ok(k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = n % 8 == 0 && aligned16(x) && aligned16(out) &&
                   (!BWD || aligned16(dy));
  return (int)(vec ? launch_chunks<T, BWD>(x, dy, out, n, tables, k, st)
                   : launch_scalar<T, BWD>(x, dy, out, n, tables, k, st));
}

template <typename T>
int gelu_tables(void* tables, Bands k, void* stream_ptr) {
  if (!bands_ok(k)) return (int)cudaErrorInvalidValue;
  const int work = 2 * k.span_e > k.span_ee ? 2 * k.span_e : k.span_ee;
  gelu_tables_kernel<T><<<(work + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<uint16_t*>(tables), k);
  return (int)cudaGetLastError();
}

Bands bands(int lo_e, int span_e, int lo_ee, int span_ee) {
  Bands k;
  k.lo_e = lo_e;
  k.span_e = span_e;
  k.lo_ee = lo_ee;
  k.span_ee = span_ee;
  return k;
}

}  // namespace

// (lo_e, span_e, lo_ee, span_ee): the bands of the tables (Bands above)
extern "C" int paddle_gelu_tables_bf16(void* tables, int lo_e, int span_e,
                                       int lo_ee, int span_ee, void* stream) {
  return gelu_tables<__nv_bfloat16>(
      tables, bands(lo_e, span_e, lo_ee, span_ee), stream);
}

extern "C" int paddle_gelu_tables_fp16(void* tables, int lo_e, int span_e,
                                       int lo_ee, int span_ee, void* stream) {
  return gelu_tables<__half>(tables, bands(lo_e, span_e, lo_ee, span_ee),
                             stream);
}

extern "C" int paddle_gelu_fwd_bf16(const void* x, void* y, long long n,
                                    const void* tables, int lo_e, int span_e,
                                    int lo_ee, int span_ee, void* stream) {
  return gelu<__nv_bfloat16, false>(x, nullptr, y, n, tables,
                                    bands(lo_e, span_e, lo_ee, span_ee),
                                    stream);
}

extern "C" int paddle_gelu_fwd_fp16(const void* x, void* y, long long n,
                                    const void* tables, int lo_e, int span_e,
                                    int lo_ee, int span_ee, void* stream) {
  return gelu<__half, false>(x, nullptr, y, n, tables,
                             bands(lo_e, span_e, lo_ee, span_ee), stream);
}

extern "C" int paddle_gelu_bwd_bf16(const void* x, const void* dy, void* dx,
                                    long long n, const void* tables,
                                    int lo_e, int span_e, int lo_ee,
                                    int span_ee, void* stream) {
  return gelu<__nv_bfloat16, true>(x, dy, dx, n, tables,
                                   bands(lo_e, span_e, lo_ee, span_ee),
                                   stream);
}

extern "C" int paddle_gelu_bwd_fp16(const void* x, const void* dy, void* dx,
                                    long long n, const void* tables,
                                    int lo_e, int span_e, int lo_ee,
                                    int span_ee, void* stream) {
  return gelu<__half, true>(x, dy, dx, n, tables,
                            bands(lo_e, span_e, lo_ee, span_ee), stream);
}
