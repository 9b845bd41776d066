// Flash attention for Hopper (sm_90a), in float32, bfloat16 and float16:
// forward, fused backward, and the split dQ and dK/dV backward, with
// attention-probs dropout regenerated inside every kernel.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels.py,
// each in every dtype they take:
//
//   flash_fwd_{f32,bf16,fp16}        _fwd_single_block_kernel :203 and
//                                    _fwd_kernel :150 (_flash_fwd :256-341)
//   flash_bwd_fused_{f32,bf16,fp16}  _bwd_fused_kernel :449
//                                    (_flash_bwd_fused :477)
//   flash_bwd_dq_{f32,bf16,fp16}     _bwd_dq_kernel :386 (_flash_bwd :523-574)
//   flash_bwd_dkv_{f32,bf16,fp16}    _bwd_dkv_kernel :413 (_flash_bwd :576-621)
//
// In bf16 and fp16 every kernel runs on the tensor cores (wgmma, TMA):
// the forward flash_fwd_tc_kernel (the pallas_calls at :281 and :320),
// the fused backward flash_bwd_fused_tc_kernel (:502) and the split pair
// flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel (:562, :599).  The f32
// kernels are SIMT f32 arithmetic (below), in full f32 (no TF32).
//
// bf16.  Every kernel is a template on the storage type T of q, k, v, dO
// and the outputs; the padding bias, lse and delta stay float32, and all
// arithmetic (products, online softmax, dS) is float32, as on the TPU
// (preferred_element_type=float32).  With T = bf16 the kernels round where
// the TPU kernels cast: the dropped probabilities before the PV product
// (pd.astype(v.dtype), :190/:229) and before dV (:436/:470), dS before the
// dQ and dK products (ds.astype(k.dtype) / ds.astype(q.dtype), :405/:440/
// :467/:473), and each output once, at its store.  The forward rounds p
// relative to the running row max of its 64-wide kv tile, as the TPU's
// blocked kernel does; the single-block TPU kernel rounds it relative to
// the final max, so the two differ in the last bf16 bit of some p.  dQ is
// never rounded before its last sum: the split dQ kernel keeps it in
// registers, and the fused kernel, whose kv-tile CTAs each add a share
// into dQ, sums the shares in a float32 scratch (b, h, sq, d) that the
// wrapper allocates, in kv order, and the last share's CTA rounds the sum
// to bf16 once (the TPU keeps an f32 VMEM scratch for the same reason,
// :393-410).  The f32 fused kernel sums the shares in f32 in the same
// order (below), and nothing is rounded.
//
// fp16.  T = __half takes the same rounding points as bf16, each a
// round-to-nearest-even __float2half_rn that keeps subnormals (as the TPU
// kernel's astype does on XLA's CPU): dS of a long row sits largely below
// fp16's smallest normal when no loss scale lifts it.  The padding bias
// and the mask value stay float32.
//
// Head dims.  The kernels run at a tile width D in {32, 64, 128}: a head
// dim d (any multiple of 8 up to 128) runs at the smallest D >= d, with d
// as the row stride of q, k, v, dO and every output.  The tiles' columns
// d..D-1 are zeros in shared memory, which leaves every dot product
// unchanged, and only the first d columns are stored.  When d is the tile
// width, the SIMT kernels' tile loads and the fused kernel's dQ updates
// take a branch with the compile-time stride D (uniform across the
// block): the runtime stride alone slowed the d = 64 kernels measurably.
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
// this card (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s) the f32
// kernels are bound by operations, not bytes.  The backward does
// 10 b h s^2 d (fused, 88.6 GFLOP) on about twice the bytes.  In bf16 and
// fp16 the bytes halve: the forward's products take 0.036 ms at the
// tensor cores' 989 TFLOP/s and its bytes 0.042 ms at 3.35 TB/s (q, k,
// v, out, the bias and lse, each once), so it is bound by bytes; the
// fused backward is bound by operations, 0.090 ms.
//
// SIMT design (the f32 kernels).  The TPU walks the grid in order and
// carries the online softmax (m, l, acc) in VMEM from one kv block to the
// next; here a loop inside each CTA takes the place of that sequential
// grid axis, so no state crosses CTAs.  The products are SIMT f32 FMAs
// (the reference is full f32; no TF32).  Ragged edges are masked in the
// kernel (rows past sq or keys past sk load as zeros and take no
// probability), so any sq, sk >= 1 is accepted; under causal masking the
// kv tiles wholly above the diagonal are skipped.
//
// SIMT forward and fused backward (flash_fwd_f32_kernel,
// flash_bwd_fused_f32_kernel), built from the split pair's pieces below
// (score_tile, acc_tile, cp_tile, split_probs / split_grads, the keep bits
// drawn a tile ahead).  At the BERT-base shape the forward does 35.4
// GFLOP (0.529 ms at 67 TFLOP/s) and the fused backward 88.6 (S, dP, dV,
// dK, dQ: 1.322 ms), against 14 b h s^2 d for the split pair; the first
// SIMT kernels (4 x 4 scalar reads over rows of d + 1 floats, synchronous
// loads, and one CTA per (b, h) for the fused one) reached 31% / 34%.
// * forward: grid (q tile of 64 H queries, b h), H groups of 64 queries
//   (two of 128 threads up to D = 64, one of 256 at D = 128); Q loaded
//   once, K and V through a 2-stage cp.async ring shared by the groups.
//   A thread scores 4 queries (2 at D = 128) against the 8 keys g + 8 n +
//   16 j (g = lane % 8) of two Philox calls, so a query row's 64 keys lie
//   in the 8 lanes of one warp and its max and sum are 3-step shuffles
//   (the pair's layout puts a row in two warps).  The row's l stays a
//   per-thread partial, rescaled by alpha each tile and summed once at
//   the end.  P (dropped) goes to shared memory as P^T [key][query,
//   2-bit fields swapped], alpha by query beside it; after a barrier of
//   the group each thread rescales its 8 x 4 outputs and adds P V by
//   acc_tile.  p is normalised against the running max of its 64-key
//   tile; under causal masking an earlier group's tile above its
//   diagonal changes nothing (alpha 1, p 0).
// * fused: the dK/dV kernel's CTA (two 64-key groups over 2-stage rings
//   of Q, dO, lse and delta up to D = 64; one group of 256 threads with
//   one slot, refilled after the tile's products, at D = 128, where a
//   second stage would take 238,848 bytes) plus, for each q tile, the
//   CTA's dQ share, dS K over its 128 (64) keys: a thread's 4 x 4 outputs
//   (D / 16 rows x 4 at other widths) read 4 keys of a dS row by one
//   LDS.128, then those keys' K rows.  Grid: (kv tile, b h) flattened,
//   4,224 CTAs at the BERT shape against 528 for one a (b, h).  dQ is
//   summed across the kv-tile CTAs of a (b, h) in f32, rank (kv order) 0
//   first, so two calls give the same bits: each CTA stores its share of
//   every q tile to a float32 scratch, one (b, h, sq, d) slice per rank,
//   and a second launch (flash_dq_parts_sum_kernel) sums the slices in
//   rank order.  The scratch holds at most 256 MiB
//   (kFusedF32ScratchBytes), or 4 slices where they are larger, and the
//   CTAs run in launches of as many ranks as it holds, each summed onto
//   the last one's dQ, so the scratch grows with sq, not sq x sk (the
//   sum's order, and so its bits, do not change with the launches); one
//   CTA per (b, h) stores dQ itself.  No red.add, so no f32 atomic
//   flushes a small sum to zero.  At the BERT shape a thread-block
//   cluster of the 4 CTAs summing through distributed shared memory was
//   slower on an H100 (3.01-3.02 ms against 2.80-2.82): one CTA an SM,
//   clusters of 4 held 120 of the 132 SMs.  Shared memory at D = 64:
//   210,432 bytes.
//
// SIMT split pair (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel).
// At b 2, h 12, s 2048, d 64 dQ does 38.7 GFLOP (S, dP, dS K: 0.577 ms at
// 67 TFLOP/s) and dK/dV 51.5 (S, dP, P^T dO, dS^T Q: 0.769).  The first pair
// reached 32% / 35% of that: 8 scalar LDS.32 for 16 FFMAs a thread and k
// capped its loops, and every tile waited out its copy.  Each kernel
// recomputes S and dP from lse, as the TPU kernels do.
// * Tiles: 64 queries x 64 keys a loop step, scored by a group of 128
//   threads.  Up to D = 64 a CTA is two groups (256 threads, one CTA an
//   SM: 171 KB of shared memory for dQ, 206 KB for dK/dV at D 64) that
//   share the tiles they stream.  dQ: grid (128-query tile, b h), each
//   group its 64 queries, the kv loop inside; dK/dV: grid (128-key tile,
//   b h), each group its 64 keys, the q loop inside.  At D 128 a CTA is
//   one group of 256 threads, where dK and dV take 2 x 64 x 128 floats.
// * Micro-tiles: a thread scores SQ = 8 queries (qb + 4 (i % 4) +
//   16 (i / 4)) against the 4 keys g, g + 16, g + 32, g + 48 of one
//   Philox call: 8 x 4 accumulators each for S and dP (4 x 4 at 256
//   threads a group).  It accumulates 8 x 4 outputs (of dQ, or of dK and
//   of dV).
// * Layouts: q, k, v and dO row-major, row stride D + 4 floats (4 mod 32
//   words).  The products over d (S = Q K^T, dP = dO V^T) read 4
//   consecutive d of a row by one LDS.128; the 4 rows (or 8) a warp reads
//   at once lie in distinct bank groups, one wavefront each: 12 LDS.128
//   for 128 FFMAs.  The products over the tile's rows (dQ += dS K,
//   dV += P^T dO, dK += dS^T Q) read 4 consecutive d of a K, dO or Q row
//   and 4 consecutive outputs' values of one row of a P or dS tile (row
//   stride 68): 3 LDS.128 for 32 FFMAs.  Each group writes its P / dS
//   tiles from registers in the order that read wants, one STS.128 per 4
//   values (4 wavefronts a warp, the least for 512 bytes).  dQ: dS^T
//   [key][query with the two 2-bit fields of its index within 16
//   swapped]; dK/dV: P and dS [query][4 (key % 16) + key / 16].  No
//   transposed copy of any input.
// * Copies: 16-byte cp.async (d % 8 == 0, and _tma_ready's 16-byte
//   bases), zero-filled past sq / sk and past d; lse and delta by 4-byte
//   copies.  Up to D 64, 2-stage rings: dQ loads each group's Q, dO, lse
//   and delta once and streams K and V; dK/dV loads each group's K, V and
//   bias row once and streams Q, dO, lse and delta.  A tile's copy is
//   issued after the CTA barrier at the top of the tile before it, so it
//   has that tile's products to land; a barrier of the group
//   (bar.sync 1 + group, 128 threads) puts its dS^T (dQ) or P and dS
//   (dK/dV) writes before its products: two barriers a tile.  Under
//   causal masking a CTA walks the tiles its last group needs; the first
//   group's extra tile lies above its diagonal and adds zeros.  At D 128
//   a second stage does not fit: dQ streams K through a 2-stage ring and
//   V through one slot refilled under the dQ product; dK/dV has one slot
//   for Q (with lse) and one for dO (with delta), the next q tile's Q
//   copied under the dV product and its dO under the S^T product.
// * Per element: the masks only on tiles that a ragged edge or the
//   diagonal reaches; the bias once per kv tile (dQ) or CTA (dK/dV);
//   expf.  Dropout is a template argument: a step's 32 keep decisions are
//   one register, drawn by 8 drop_bits calls in the step before (dK/dV:
//   spread over the dV product's blocks, among its FFMAs; dQ: after its
//   dQ product, while the other warps reach the barrier).
// Measured (H100 80GB HBM3, 700 W; b 2 h 12 s 2048 d 64, padding bias,
// dropout 0.1, dQ / dK/dV ms; chip_smoke.py's flash phase run on copies
// of the tree in turns, one call): two groups over the rings 1.047-1.048
// / 1.317 (pair 2.365; dropout off 0.956 / 1.223); one group a CTA at two
// CTAs an SM, with dQ's K ring and V slot and dK/dV's single Q and dO
// slots, 1.051 / 1.375-1.376 (2.426-2.427); the dK/dV ring alone (dQ one
// group) 1.064-1.072 / 1.317-1.326; a dK/dV ring at one group a CTA,
// which leaves one 128-thread CTA an SM, 3.185 for the pair.  The first
// pair: 1.795 / 2.177.
// What lost before the rings (one group a CTA, two CTAs an SM; each
// against the design of its day in the same call): partly unrolled loops
// (score k by 4, accumulate c by 8: 1.165 / 1.452 against 1.117 / 1.403
// fully unrolled k and c by 16); 256 threads with 4 x 4 micro-tiles at D
// 64 (1.205 / 1.557 against 1.165 / 1.452); score k unrolled by 4 (1.069
// / 1.397 against 1.052 / 1.375; by 8 a tie, 1.046 / 1.375); a dQ of four
// tiles (one K slot, V and dS^T sharing one) at three CTAs an SM and 168
// registers (1.208 against 1.064); dQ's V slot taking dS^T behind a third
// barrier (1.058 against 1.059: a tie, the two-barrier form stays); the
// keep bits drawn before the products (spills), or among the dQ
// product's FFMAs (1.161 against 1.059); P computed row by row among the
// dP product's FFMAs (1.091 / 1.390 against 1.059 / 1.387, and a spill in
// dQ).
//
// Tensor-core split pair (bf16, fp16).  At b 2, h 12, s 2048, d 64 the
// dQ kernel does 6 b h s^2 d = 38.7 GFLOP (S, dP, dS K) and the dK/dV
// kernel 8 b h s^2 d = 51.5 GFLOP (S^T, dP^T, P^T dO, dS^T Q) on about
// 32 and 38 MB: bound by operations at 989 TFLOP/s, 0.039 + 0.052 ms
// (the bytes take 0.010 + 0.011 ms at 3.35 TB/s).  What the design does
// about it (hopper.cuh holds the primitives):
// * every product is a wgmma.m64nNk16 with T operands and f32
//   accumulators.  dQ: S = Q K^T and dP = dO V^T read both operands from
//   shared memory K-major; dQ += dS K takes dS from registers and K
//   MN-major through the transpose bit.  dK/dV computes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T come out in accumulator layout, are
//   rounded to T in registers (cvt.rn into T x 2 pairs: the accumulator
//   layout of 16 columns is the A-operand layout of one k16 step) and
//   feed dV += P^T dO and dK += dS^T Q as the register A operand, with
//   dO and Q MN-major.  No score tile goes through shared memory;
// * TMA loads every tile, by 3-D tensor maps (d, s, b h) with a box of
//   one swizzle atom (64 columns, 128-byte swizzle; 32 columns, 64-byte
//   swizzle at D = 32; two atoms at D = 128) by the tile's rows: columns
//   d..D-1 and rows past s of each head arrive as zeros, so head dims
//   and ragged edges cost nothing, and the swizzle is the one the wgmma
//   descriptors name.  Q and dO (dQ) or K and V (dK/dV) are loaded once;
//   K, V (dQ) or Q, dO, lse, delta (dK/dV; lse and delta by 1-D maps)
//   stream through a 2-stage ring of mbarrier-tracked buffers, the next
//   tile's copy in flight while the current one is computed.  One thread
//   issues every copy, and a __syncthreads after a tile's last wgmma
//   releases its stage;
// * one warpgroup (128 threads) per CTA, grid (64-row tile, b h): 768
//   CTAs at s 2048, several resident on an SM (the largest shared-memory
//   carveout), whose interleaving hides what warp specialisation would.
//   The dK/dV kernel's q tile is 64 rows, 32 at D = 128, where dK and dV
//   alone take 128 accumulators a thread;
// * dropout on the accumulator fragment, through drop_bits, bit for bit
//   the forward's mask.  In the dQ kernel a thread's 16 columns of a row
//   are the columns {g, g + 16, g + 32, g + 48} of four Philox groups g:
//   one call per 4 elements.  In the dK/dV kernel the query is the
//   fragment's column, and the kv tile sits in shared memory in swap34
//   order (8-row TMA boxes), so a thread's two rows are kv rows j and
//   j + 16 and warp w ^ 2's (same lane) j + 32 and j + 48: one call
//   (query, group of j) serves both warps, which split the calls and
//   trade words through shared memory, again one call per 4 elements;
// * P = exp(S scale + bias - lse), the mask and dS are f32 on the
//   fragments, in the order of bwd_terms (tiles that no ragged edge or
//   causal mask reaches skip the masks); each output is rounded once at
//   its store; no atomics, so the result is deterministic.
//
// Tensor-core forward and fused backward (bf16, fp16), built from the
// split pair's pieces.  At the BERT-base shape the forward is bound by
// its bytes (0.042 ms; products 0.036 ms) and the fused backward by its
// five products (0.090 ms); what keeps both from those bounds is the f32
// work on the fragments (Philox, expf, masks), which the design keeps to
// one Philox call per 4 elements and to edge tiles only:
// * forward (replaces _fwd_kernel :150 and _fwd_single_block_kernel
//   :203): grid (64-row q tile, b h), one warpgroup; Q by TMA once, K and
//   V through the dQ kernel's 2-stage ring.  S = Q K^T by wgmma (both
//   K-major); the online softmax runs on the accumulator fragment, where
//   a row's 64 columns sit in the 4 lanes of a quad (two shuffles for
//   the max and for the sum); O is rescaled by alpha, then O += P V takes
//   the dropped p, rounded to T in registers, as the A operand and V
//   MN-major.  The kv tile stays 64 wide, so p is rounded against the
//   same running max as the SIMT kernel's.  O is stored once in T, lse in
//   f32; causal skips the tiles above the diagonal;
// * fused backward (replaces _bwd_fused_kernel :449): the dK/dV kernel,
//   grid (kv tile x b h), plus the fifth product.  dS^T goes from
//   registers to shared memory (a 64 x NQ tile of T in TMA's swizzle, in
//   the bytes of the Philox exchange once they are read); dK += dS^T Q
//   reads it K-major, and dQ^T = K^T dS^T reads K and it MN-major (M = D
//   in m64 blocks, so head dims up to 32 run at the 64 tile).  One CTA
//   per kv tile keeps the split pair's parallelism (4,224 CTAs at the
//   BERT shape, against 528 for one CTA per (b, h), which would fill 1.33
//   waves of 3 CTAs an SM).  dQ is summed across the kv-tile CTAs of a
//   (b, h) in float32 in kv order, so it is the same bits in every run:
//   up to 8 kv tiles (sk <= 512) the CTAs form a thread-block cluster and
//   sum each q tile's shares through distributed shared memory after one
//   cluster barrier, with no traffic to device memory but dQ itself;
//   above that, through a float32 scratch in device memory, each CTA
//   adding its share once a flag says the CTA before it has (at the BERT
//   shape that chain's fences, flag polls and L2 atomics made the kernel
//   slower than the split pair).
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Attn {
  int h, sq, sk;
  int d;                         // the real head dim, the row stride
                                 // (<= the tile width D)
  float scale;
  int causal;
  const float* bias;             // (b, sk) or null
  const long long* seed;         // device scalar, or null: no dropout
  uint32_t thresh;               // keep iff bits >= thresh
  float keep_scale;              // 1 / (1 - rate)
  uint32_t offset;
};

// The store of one element of storage type T (the bf16 / fp16 kernels'
// rounding of an f32 sum at its store).
template <typename T>
struct Elem;

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void store(__half* p, float x) {
    *p = __float2half_rn(x);   // keeps subnormals, as the TPU's cast does
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
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

// ------------------------------------------- backward, f32: the split pair
// The f32 dQ and dK/dV kernels (see "SIMT split pair" at the top): a
// 64 x 64 score tile a loop step, each thread scoring SQ queries against
// the four keys g, g + 16, g + 32, g + 48 of one Philox call; products
// from row-major tiles (row stride D + 4) read by 16-byte loads; tiles
// copied by cp.async, the next one in flight over the current products.
template <int D>
struct SplitF32 {
  static constexpr int kNT = D == 128 ? 256 : 128;   // threads a group
  static constexpr int kSQ = kNT == 128 ? 8 : 4;     // queries a thread scores
  static constexpr int kLS = kTile + 4;              // P / dS tile row
  static constexpr int kCW = D / 32;                 // warps across an output
  static constexpr int kRW = kNT / 32 / kCW;         // warps down an output
  static constexpr int kAR = kTile / kRW / 4;        // output rows a thread
  static constexpr int kTileF = kTile * (D + 4);     // floats of a q/k/v/dO tile
  static constexpr int kScoreF = kTile * kLS;        // floats of a P / dS tile
  static_assert(kAR % 4 == 0, "output rows in blocks of 4 positions");
};

// Tile query of a thread's score element i: qb + 4 (i % 4) + 16 (i / 4),
// qb = 4 SQ (warp / 2) + lane / 8.  For each i the 4 lane rows of a warp
// read 4 consecutive q or dO rows, in 4 distinct bank groups.
__device__ __forceinline__ int score_row(int qb, int i) {
  return qb + 4 * (i % 4) + 16 * (i / 4);
}

// rows [row0, row0 + R) of an (n, d) row-major f32 matrix into
// s[R][D + 4], by 16-byte cp.async (d % 8 == 0: a chunk of 4 columns is
// wholly inside d or past it); rows past n and columns d..D-1 arrive as
// zeros.  Each thread copies one column chunk of every NT / (D / 4)-th row.
template <int D, int NT, int R = kTile>
__device__ __forceinline__ void cp_tile(float* __restrict__ s,
                                        const float* __restrict__ g, int row0,
                                        int n, int d) {
  constexpr int kC = D / 4, kStep = NT / kC;
  static_assert(NT % kC == 0, "every thread copies one column chunk");
  const int c4 = threadIdx.x % kC, r0 = threadIdx.x / kC;
  const bool col_ok = 4 * c4 < d;
#pragma unroll
  for (int i = 0; i < R / kStep; ++i) {
    const int r = r0 + i * kStep;
    const bool ok = col_ok && row0 + r < n;
    hopper::cp_async<16>(s + r * (D + 4) + 4 * c4,
                         ok ? g + (size_t)(row0 + r) * d + 4 * c4 : g,
                         ok ? 16u : 0u);
  }
}

// x[row0 .. row0 + R) into s[R] by threads 0..R-1 (4-byte copies: lse
// and delta rows start anywhere), zeros past n
template <int R = kTile>
__device__ __forceinline__ void cp_row_vec(float* __restrict__ s,
                                           const float* __restrict__ x,
                                           int row0, int n) {
  const int r = threadIdx.x;
  if (r < R) {
    const bool ok = row0 + r < n;
    hopper::cp_async<4>(s + r, ok ? x + row0 + r : x, ok ? 4u : 0u);
  }
}

// s[i][4 n + j] = a[score_row(i)] . b[g + 8 n + 16 j] over the tile's D
// columns, one f32 FMA chain a product in column order (a, b: [64][D + 4]);
// per 4 columns SQ + 4 NG LDS.128 for 16 SQ NG FFMAs.  NG = 1: the keys
// g, g + 16, g + 32, g + 48 of one Philox call (the split pair); NG = 2
// (the forward): those of g and of g + 8
template <int D, int SQ, int NG = 1>
__device__ __forceinline__ void score_tile(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float (&s)[SQ][4 * NG], int qb,
                                           int g) {
  constexpr int NK = 4 * NG;
#pragma unroll
  for (int i = 0; i < SQ; ++i)
#pragma unroll
    for (int j = 0; j < NK; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 4) {
    float4 av[SQ], bv[NK];
#pragma unroll
    for (int i = 0; i < SQ; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          a + score_row(qb, i) * (D + 4) + k);
#pragma unroll
    for (int j = 0; j < NK; ++j)
      bv[j] = *reinterpret_cast<const float4*>(
          b + (g + 8 * (j / 4) + 16 * (j % 4)) * (D + 4) + k);
#pragma unroll
    for (int i = 0; i < SQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
#pragma unroll
    for (int i = 0; i < SQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
#pragma unroll
    for (int i = 0; i < SQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
#pragma unroll
    for (int i = 0; i < SQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
  }
}

// acc[4 m + t][e] += sum_c p[c][pb + 16 m + t] * x[c][dc + e], c in tile
// order (p: [64][68], a P or dS tile with the output's rows as its
// columns; x: [64][D + 4]); per c AR / 4 + 1 LDS.128 for 4 AR FFMAs.  In
// kAccBlocks blocks of c, each opened by step(block): work that its FFMAs
// hide.  (One block of all 64 c made the dK/dV loop too long: 3.34 ms
// against 1.39 at b 2 s 2048; two blocks 1.45.)
constexpr int kAccBlocks = 4;
template <int D, int AR, class Step>
__device__ __forceinline__ void acc_tile(const float* __restrict__ p,
                                         const float* __restrict__ x,
                                         float (&acc)[AR][4], int pb, int dc,
                                         Step step) {
  constexpr int kC = kTile / kAccBlocks;
#pragma unroll 1
  for (int blk = 0; blk < kAccBlocks; ++blk) {
    step(blk);
#pragma unroll
    for (int c = blk * kC; c < (blk + 1) * kC; ++c) {
      float4 pv[AR / 4];
#pragma unroll
      for (int m = 0; m < AR / 4; ++m)
        pv[m] = *reinterpret_cast<const float4*>(p + c * (kTile + 4) + pb +
                                                 16 * m);
      const float4 xv =
          *reinterpret_cast<const float4*>(x + c * (D + 4) + dc);
      const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int m = 0; m < AR / 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[4 * m][e] = fmaf(pv[m].x, xe[e], acc[4 * m][e]);
          acc[4 * m + 1][e] = fmaf(pv[m].y, xe[e], acc[4 * m + 1][e]);
          acc[4 * m + 2][e] = fmaf(pv[m].z, xe[e], acc[4 * m + 2][e]);
          acc[4 * m + 3][e] = fmaf(pv[m].w, xe[e], acc[4 * m + 3][e]);
        }
    }
  }
}

// s (dot products Q.K) -> P = exp(s scale + bias - lse) of the thread's
// elements (queries row0 + score_row(i), keys col0 + g + 16 j); EDGE: the
// tile reaches past sq or sk or the causal diagonal, so bwd_terms' masks
// apply (score(), zero outside), else none does
template <int SQ, bool EDGE>
__device__ __forceinline__ void split_probs(const Attn& a, int row0, int col0,
                                            int qb, int g, float (&s)[SQ][4],
                                            const float (&lse)[SQ],
                                            const float (&bias)[4]) {
#pragma unroll
  for (int i = 0; i < SQ; ++i) {
    const int r = row0 + score_row(qb, i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + g + 16 * j;
      if (EDGE)
        s[i][j] = (r < a.sq && c < a.sk)
                      ? expf(score(a, s[i][j], bias[j], r, c) - lse[i])
                      : 0.f;
      else
        s[i][j] = expf(s[i][j] * a.scale + bias[j] - lse[i]);
    }
  }
}

// The keep decisions of the thread's elements i0 .. i0 + n - 1 (bit
// 4 i + j: query row0 + score_row(i), key col0 + g + 16 j), one drop_bits
// call a query.  Kept in one register, a tile's are drawn during the tile
// before it: in dK/dV a few queries in each block of its dV product,
// among the FFMAs; in dQ after its last product, before the barrier that
// waits for the other warps (spread over the dQ product's blocks they
// took registers it does not have: 1.16 ms against 1.06 at b 2 s 2048).
template <int SQ>
__device__ __forceinline__ uint32_t keep_bits(const Attn& a, uint64_t seed,
                                              int bh, int row0, int col0,
                                              int qb, int g, int i0 = 0,
                                              int n = SQ) {
  static_assert(4 * SQ <= 32, "one bit an element");
  uint32_t keep = 0;
#pragma unroll
  for (int i = i0; i < i0 + n; ++i) {
    const uint4 w = drop_bits(a, seed, bh, row0 + score_row(qb, i), col0 + g);
    keep |= ((uint32_t)(w.x >= a.thresh) | (uint32_t)(w.y >= a.thresh) << 1 |
             (uint32_t)(w.z >= a.thresh) << 2 |
             (uint32_t)(w.w >= a.thresh) << 3) << (4 * i);
  }
  return keep;
}

// p (P) and dp (dO.V) -> the dropped P in p and dS in dp, as bwd_terms
// (DROP: with dropout, `keep` from keep_bits)
template <int SQ, bool DROP>
__device__ __forceinline__ void split_grads(const Attn& a, float (&p)[SQ][4],
                                            float (&dp)[SQ][4],
                                            const float (&delta)[SQ],
                                            uint32_t keep) {
#pragma unroll
  for (int i = 0; i < SQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pv = p[i][j];
      float pd = pv, dpd = dp[i][j];
      if (DROP) {
        const bool kept = (keep >> (4 * i + j)) & 1u;
        pd = kept ? pv * a.keep_scale : 0.f;
        dpd = kept ? dpd * a.keep_scale : 0.f;
      }
      dp[i][j] = pv * (dpd - delta[i]) * a.scale;
      p[i][j] = pd;
    }
}

__device__ __forceinline__ bool edge_tile(const Attn& a, int row0, int col0) {
  return row0 + kTile > a.sq || col0 + kTile > a.sk ||
         (a.causal && col0 + kTile - 1 > row0);
}

// dQ at D = 128: grid (q tile, b h), one group of 256 threads a CTA; K of
// each kv tile through a 2-stage ring, V through one slot refilled under
// the dQ product, dS^T in a tile of its own: two barriers a kv tile (DROP:
// with dropout)
template <int D, bool DROP>
__device__ __forceinline__ void dq_f32_slots(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             float* __restrict__ dq, Attn a) {
  using C = SplitF32<D>;
  constexpr int NT = C::kNT, SQ = C::kSQ, AR = C::kAR;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + C::kTileF;
  float* ks = dos + C::kTileF;       // [2][64][D + 4]
  float* vs = ks + 2 * C::kTileF;
  float* dst = vs + C::kTileF;       // dS^T [key][position of query]
  float* lse_s = dst + C::kScoreF;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y, bi = bh / a.h;
  const int row0 = blockIdx.x * kTile;
  const size_t qoff = (size_t)bh * a.sq * a.d, koff = (size_t)bh * a.sk * a.d;
  const uint64_t seed = DROP ? (uint64_t)*a.seed : 0ull;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // scores: keys g + 16 j, queries score_row(qb, i)
  const int g = 8 * (warp % 2) + lane % 8;
  const int qb = 4 * SQ * (warp / 2) + lane / 8;
  // dQ: columns dc .. dc + 3 of dS^T positions pb + 16 m + t
  const int dc = 32 * (warp % C::kCW) + 4 * (lane % 8);
  const int pb = (kTile / C::kRW) * (warp / C::kCW) + 4 * (lane / 8);
  const int n_kv = kv_tiles(a, row0);

  cp_tile<D, NT>(qs, q + qoff, row0, a.sq, a.d);
  cp_tile<D, NT>(dos, dout + qoff, row0, a.sq, a.d);
  cp_tile<D, NT>(ks, k + koff, 0, a.sk, a.d);
  cp_tile<D, NT>(vs, v + koff, 0, a.sk, a.d);
  cp_row_vec(lse_s, lse + (size_t)bh * a.sq, row0, a.sq);
  cp_row_vec(delta_s, delta + (size_t)bh * a.sq, row0, a.sq);
  hopper::cp_async_commit();
  float acc[AR][4];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t keep = DROP ? keep_bits<SQ>(a, seed, bh, row0, 0, qb, g) : 0u;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int col0 = kt * kTile;
    const float* kst = ks + (kt & 1) * C::kTileF;
    hopper::cp_async_wait<0>();
    __syncthreads();   // K and V of tile kt have landed; all threads are
                       // past tile kt - 1's dQ product
    if (kt + 1 < n_kv)
      cp_tile<D, NT>(ks + ((kt + 1) & 1) * C::kTileF, k + koff, col0 + kTile,
                     a.sk, a.d);
    hopper::cp_async_commit();
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + g + 16 * j;
      bj[j] = (a.bias != nullptr && c < a.sk)
                  ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
    }
    float s[SQ][4], dp[SQ][4], lr[SQ], dr[SQ];
    score_tile<D, SQ>(qs, kst, s, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) lr[i] = lse_s[score_row(qb, i)];
    if (edge_tile(a, row0, col0))
      split_probs<SQ, true>(a, row0, col0, qb, g, s, lr, bj);
    else
      split_probs<SQ, false>(a, row0, col0, qb, g, s, lr, bj);
    score_tile<D, SQ>(dos, vs, dp, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) dr[i] = delta_s[score_row(qb, i)];
    split_grads<SQ, DROP>(a, s, dp, dr, keep);
    // dS^T[key][position]: query 16 m' + 4 t + l sits at position
    // 16 m' + 4 l + t, so a thread's queries 4 m .. 4 m + 3 are one STS.128
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < SQ / 4; ++m)
        *reinterpret_cast<float4*>(dst + (g + 16 * j) * C::kLS +
                                   4 * SQ * (warp / 2) + 16 * m +
                                   4 * (lane / 8)) =
            make_float4(dp[4 * m][j], dp[4 * m + 1][j], dp[4 * m + 2][j],
                        dp[4 * m + 3][j]);
    __syncthreads();   // dS^T is whole; every warp has read V
    if (kt + 1 < n_kv)
      cp_tile<D, NT>(vs, v + koff, col0 + kTile, a.sk, a.d);
    hopper::cp_async_commit();
    acc_tile<D, AR>(dst, kst, acc, pb, dc, [](int) {});
    // the next tile's keep bits, while the other warps finish their FFMAs
    if (DROP) keep = keep_bits<SQ>(a, seed, bh, row0, col0 + kTile, qb, g);
  }
  hopper::cp_async_wait<0>();

  // position pb + 16 m + t holds query (pb & ~15) + 16 m + 4 t + lane / 8
#pragma unroll
  for (int m = 0; m < AR / 4; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = row0 + (kTile / C::kRW) * (warp / C::kCW) + 16 * m +
                    4 * t + lane / 8;
      if (r < a.sq && dc < a.d)
        *reinterpret_cast<float4*>(dq + qoff + (size_t)r * a.d + dc) =
            make_float4(acc[4 * m + t][0], acc[4 * m + t][1],
                        acc[4 * m + t][2], acc[4 * m + t][3]);
    }
}

// dK/dV at D = 128: grid (kv tile, b h), one group of 256 threads a CTA;
// K, V and the bias loaded once; Q with lse and dO with delta in one slot
// each (a second would not fit), the next q tile's Q copied over the dV
// product and its dO over its S^T product (DROP: with dropout)
template <int D, bool DROP>
__device__ __forceinline__ void dkv_f32_slots(const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              const float* __restrict__ dout,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              float* __restrict__ dk,
                                              float* __restrict__ dv, Attn a) {
  using C = SplitF32<D>;
  constexpr int NT = C::kNT, SQ = C::kSQ, AR = C::kAR;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + C::kTileF;
  float* qs = vs + C::kTileF;
  float* dos = qs + C::kTileF;
  float* ps = dos + C::kTileF;     // dropped P [query][position of key]
  float* dss = ps + C::kScoreF;    // dS [query][position of key]
  float* lse_s = dss + C::kScoreF;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y, bi = bh / a.h;
  const int col0 = blockIdx.x * kTile;
  const size_t qoff = (size_t)bh * a.sq * a.d, koff = (size_t)bh * a.sk * a.d;
  const float* lse_h = lse + (size_t)bh * a.sq;
  const float* delta_h = delta + (size_t)bh * a.sq;
  const uint64_t seed = DROP ? (uint64_t)*a.seed : 0ull;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = 8 * (warp % 2) + lane % 8;
  const int qb = 4 * SQ * (warp / 2) + lane / 8;
  const int dc = 32 * (warp % C::kCW) + 4 * (lane % 8);
  const int pb = (kTile / C::kRW) * (warp / C::kCW) + 4 * (lane / 8);
  const int n_q = (a.sq + kTile - 1) / kTile;
  const int qt0 = first_q_tile(a, col0);

  cp_tile<D, NT>(ks, k + koff, col0, a.sk, a.d);
  cp_tile<D, NT>(vs, v + koff, col0, a.sk, a.d);
  if (qt0 < n_q) {
    cp_tile<D, NT>(qs, q + qoff, qt0 * kTile, a.sq, a.d);
    cp_row_vec(lse_s, lse_h, qt0 * kTile, a.sq);
  }
  hopper::cp_async_commit();
  float bj[4], dka[AR][4], dva[AR][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + g + 16 * j;
    bj[j] = (a.bias != nullptr && c < a.sk)
                ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  uint32_t keep =
      DROP ? keep_bits<SQ>(a, seed, bh, qt0 * kTile, col0, qb, g) : 0u;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int row0 = qt * kTile;
    hopper::cp_async_wait<0>();
    __syncthreads();   // Q, lse of tile qt have landed; all threads are
                       // past tile qt - 1's dV product
    cp_tile<D, NT>(dos, dout + qoff, row0, a.sq, a.d);
    cp_row_vec(delta_s, delta_h, row0, a.sq);
    hopper::cp_async_commit();
    const bool edge = edge_tile(a, row0, col0);
    float s[SQ][4], dp[SQ][4], lr[SQ], dr[SQ];
    score_tile<D, SQ>(qs, ks, s, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) lr[i] = lse_s[score_row(qb, i)];
    if (edge)
      split_probs<SQ, true>(a, row0, col0, qb, g, s, lr, bj);
    else
      split_probs<SQ, false>(a, row0, col0, qb, g, s, lr, bj);
    hopper::cp_async_wait<0>();
    __syncthreads();   // dO, delta of tile qt have landed
    score_tile<D, SQ>(dos, vs, dp, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) dr[i] = delta_s[score_row(qb, i)];
    split_grads<SQ, DROP>(a, s, dp, dr, keep);
    // key g + 16 j sits at position 4 g + j: a thread's 4 keys of a query
    // are one STS.128
#pragma unroll
    for (int i = 0; i < SQ; ++i) {
      const int r = score_row(qb, i) * C::kLS + 4 * g;
      *reinterpret_cast<float4*>(ps + r) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(dss + r) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();
    acc_tile<D, AR>(dss, qs, dka, pb, dc, [](int) {});
    __syncthreads();   // every warp has read Q and lse: the next tile's go in
    if (qt + 1 < n_q) {
      cp_tile<D, NT>(qs, q + qoff, row0 + kTile, a.sq, a.d);
      cp_row_vec(lse_s, lse_h, row0 + kTile, a.sq);
    }
    hopper::cp_async_commit();
    // the next tile's keep bits, drawn among this product's FFMAs
    keep = 0u;
    acc_tile<D, AR>(ps, dos, dva, pb, dc, [&](int blk) {
      if (DROP)
        keep |= keep_bits<SQ>(a, seed, bh, row0 + kTile, col0, qb, g,
                              blk * SQ / kAccBlocks, SQ / kAccBlocks);
    });
  }
  hopper::cp_async_wait<0>();

  // position p = pb + 16 m + t holds key (p >> 2) + 16 (p & 3)
#pragma unroll
  for (int m = 0; m < AR / 4; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = col0 + ((pb + 16 * m) >> 2) + 16 * t;
      if (c >= a.sk || dc >= a.d) continue;
      const size_t o = koff + (size_t)c * a.d + dc;
      *reinterpret_cast<float4*>(dk + o) =
          make_float4(dka[4 * m + t][0], dka[4 * m + t][1], dka[4 * m + t][2],
                      dka[4 * m + t][3]);
      *reinterpret_cast<float4*>(dv + o) =
          make_float4(dva[4 * m + t][0], dva[4 * m + t][1], dva[4 * m + t][2],
                      dva[4 * m + t][3]);
    }
}

// the 128 threads of group grp (barrier 1 + grp; the whole CTA if H == 1)
template <int H>
__device__ __forceinline__ void group_sync(int grp) {
  if (H == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, 128;" ::"r"(1 + grp) : "memory");
}

// dQ over a 2-stage ring (D <= 64): grid (q tile of 64 H queries, b h), H
// groups of 128 threads, each scoring and accumulating its 64 queries as
// dq_f32_slots' CTA does.  The groups share each kv tile's K and V, copied one kv tile
// ahead into the other stage: a CTA-wide barrier at the top of a kv tile
// and a barrier of the group between its dS^T writes and its dQ product
template <int D, bool DROP, int H>
__device__ __forceinline__ void dq_f32_ring(const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            float* __restrict__ dq, Attn a) {
  using C = SplitF32<D>;
  static_assert(C::kNT == 128, "groups of 128 threads");
  constexpr int NT = 128 * H, SQ = C::kSQ, AR = C::kAR;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [H][64][D + 4]
  float* dos = qs + H * C::kTileF;        // [H][64][D + 4]
  float* ks = dos + H * C::kTileF;        // [2][64][D + 4]
  float* vs = ks + 2 * C::kTileF;         // [2][64][D + 4]
  float* dst = vs + 2 * C::kTileF;        // [H] dS^T [key][position]
  float* lse_s = dst + H * C::kScoreF;    // [H][64]
  float* delta_s = lse_s + H * kTile;     // [H][64]
  const int bh = blockIdx.y, bi = bh / a.h;
  const int grp = threadIdx.x / 128;
  const int cta0 = blockIdx.x * H * kTile, row0 = cta0 + grp * kTile;
  const float* qsg = qs + grp * C::kTileF;
  const float* dosg = dos + grp * C::kTileF;
  float* dstg = dst + grp * C::kScoreF;
  const float* lsg = lse_s + grp * kTile;
  const float* dlg = delta_s + grp * kTile;
  const size_t qoff = (size_t)bh * a.sq * a.d, koff = (size_t)bh * a.sk * a.d;
  const uint64_t seed = DROP ? (uint64_t)*a.seed : 0ull;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = 8 * (warp % 2) + lane % 8;
  const int qb = 4 * SQ * (warp / 2) + lane / 8;
  const int dc = 32 * (warp % C::kCW) + 4 * (lane % 8);
  const int pb = (kTile / C::kRW) * (warp / C::kCW) + 4 * (lane / 8);
  // the last group's kv tiles: under causal masking an earlier group's
  // extra tiles lie wholly above its diagonal and add zeros
  const int n_kv = kv_tiles(a, cta0 + (H - 1) * kTile);

  cp_tile<D, NT, H * kTile>(qs, q + qoff, cta0, a.sq, a.d);
  cp_tile<D, NT, H * kTile>(dos, dout + qoff, cta0, a.sq, a.d);
  cp_tile<D, NT>(ks, k + koff, 0, a.sk, a.d);
  cp_tile<D, NT>(vs, v + koff, 0, a.sk, a.d);
  cp_row_vec<H * kTile>(lse_s, lse + (size_t)bh * a.sq, cta0, a.sq);
  cp_row_vec<H * kTile>(delta_s, delta + (size_t)bh * a.sq, cta0, a.sq);
  hopper::cp_async_commit();
  float acc[AR][4];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t keep = DROP ? keep_bits<SQ>(a, seed, bh, row0, 0, qb, g) : 0u;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int col0 = kt * kTile, st = kt & 1;
    const float* kst = ks + st * C::kTileF;
    const float* vst = vs + st * C::kTileF;
    hopper::cp_async_wait<0>();
    __syncthreads();   // K and V of tile kt have landed; every thread is
                       // past tile kt - 1's dQ product, so its stage and
                       // dS^T are free
    if (kt + 1 < n_kv) {
      const int nx = (st ^ 1) * C::kTileF;
      cp_tile<D, NT>(ks + nx, k + koff, col0 + kTile, a.sk, a.d);
      cp_tile<D, NT>(vs + nx, v + koff, col0 + kTile, a.sk, a.d);
    }
    hopper::cp_async_commit();
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + g + 16 * j;
      bj[j] = (a.bias != nullptr && c < a.sk)
                  ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
    }
    float s[SQ][4], dp[SQ][4], lr[SQ], dr[SQ];
    score_tile<D, SQ>(qsg, kst, s, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) lr[i] = lsg[score_row(qb, i)];
    if (edge_tile(a, row0, col0))
      split_probs<SQ, true>(a, row0, col0, qb, g, s, lr, bj);
    else
      split_probs<SQ, false>(a, row0, col0, qb, g, s, lr, bj);
    score_tile<D, SQ>(dosg, vst, dp, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) dr[i] = dlg[score_row(qb, i)];
    split_grads<SQ, DROP>(a, s, dp, dr, keep);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < SQ / 4; ++m)
        *reinterpret_cast<float4*>(dstg + (g + 16 * j) * C::kLS +
                                   4 * SQ * (warp / 2) + 16 * m +
                                   4 * (lane / 8)) =
            make_float4(dp[4 * m][j], dp[4 * m + 1][j], dp[4 * m + 2][j],
                        dp[4 * m + 3][j]);
    group_sync<H>(grp);   // the group's dS^T is whole
    acc_tile<D, AR>(dstg, kst, acc, pb, dc, [](int) {});
    if (DROP) keep = keep_bits<SQ>(a, seed, bh, row0, col0 + kTile, qb, g);
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < AR / 4; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = row0 + (kTile / C::kRW) * (warp / C::kCW) + 16 * m +
                    4 * t + lane / 8;
      if (r < a.sq && dc < a.d)
        *reinterpret_cast<float4*>(dq + qoff + (size_t)r * a.d + dc) =
            make_float4(acc[4 * m + t][0], acc[4 * m + t][1],
                        acc[4 * m + t][2], acc[4 * m + t][3]);
    }
}

// dK/dV over a 2-stage ring (D <= 64): grid (kv tile of 64 H keys, b h), H
// groups of 128 threads, each scoring and accumulating its 64 keys as
// dkv_f32_slots' CTA does.  The groups share each q tile's Q, dO, lse and delta, copied one q
// tile ahead into the other stage, so a copy has a whole tile's products
// to land: a CTA-wide barrier at the top of a q tile and a barrier of the
// group between its P / dS writes and its products (DROP: with dropout)
template <int D, bool DROP, int H>
__device__ __forceinline__ void dkv_f32_ring(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             float* __restrict__ dk,
                                             float* __restrict__ dv, Attn a) {
  using C = SplitF32<D>;
  static_assert(C::kNT == 128, "groups of 128 threads");
  constexpr int NT = 128 * H, SQ = C::kSQ, AR = C::kAR;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [H][64][D + 4]
  float* vs = ks + H * C::kTileF;         // [H][64][D + 4]
  float* qs = vs + H * C::kTileF;         // [2][64][D + 4]
  float* dos = qs + 2 * C::kTileF;        // [2][64][D + 4]
  float* ps = dos + 2 * C::kTileF;        // [H] dropped P [query][position]
  float* dss = ps + H * C::kScoreF;       // [H] dS [query][position]
  float* lse_s = dss + H * C::kScoreF;    // [2][64]
  float* delta_s = lse_s + 2 * kTile;     // [2][64]
  float* bias_s = delta_s + 2 * kTile;    // [H][64]
  const int bh = blockIdx.y, bi = bh / a.h;
  const int grp = threadIdx.x / 128;
  const int cta0 = blockIdx.x * H * kTile, col0 = cta0 + grp * kTile;
  const float* bsg = bias_s + grp * kTile;
  const float* ksg = ks + grp * C::kTileF;
  const float* vsg = vs + grp * C::kTileF;
  float* psg = ps + grp * C::kScoreF;
  float* dssg = dss + grp * C::kScoreF;
  const size_t qoff = (size_t)bh * a.sq * a.d, koff = (size_t)bh * a.sk * a.d;
  const float* lse_h = lse + (size_t)bh * a.sq;
  const float* delta_h = delta + (size_t)bh * a.sq;
  const uint64_t seed = DROP ? (uint64_t)*a.seed : 0ull;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = 8 * (warp % 2) + lane % 8;
  const int qb = 4 * SQ * (warp / 2) + lane / 8;
  const int dc = 32 * (warp % C::kCW) + 4 * (lane % 8);
  const int pb = (kTile / C::kRW) * (warp / C::kCW) + 4 * (lane / 8);
  const int n_q = (a.sq + kTile - 1) / kTile;
  const int qt0 = first_q_tile(a, cta0);

  cp_tile<D, NT, H * kTile>(ks, k + koff, cta0, a.sk, a.d);
  cp_tile<D, NT, H * kTile>(vs, v + koff, cta0, a.sk, a.d);
  if (qt0 < n_q) {
    cp_tile<D, NT>(qs, q + qoff, qt0 * kTile, a.sq, a.d);
    cp_tile<D, NT>(dos, dout + qoff, qt0 * kTile, a.sq, a.d);
    cp_row_vec(lse_s, lse_h, qt0 * kTile, a.sq);
    cp_row_vec(delta_s, delta_h, qt0 * kTile, a.sq);
  }
  hopper::cp_async_commit();
  if (threadIdx.x % 128 < kTile) {   // the group's bias row
    const int c = col0 + threadIdx.x % 128;
    bias_s[threadIdx.x % 128 + grp * kTile] =
        (a.bias != nullptr && c < a.sk)
            ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
  }
  float dka[AR][4], dva[AR][4];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  uint32_t keep =
      DROP ? keep_bits<SQ>(a, seed, bh, qt0 * kTile, col0, qb, g) : 0u;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int row0 = qt * kTile, st = (qt - qt0) & 1;
    const float* qst = qs + st * C::kTileF;
    const float* dost = dos + st * C::kTileF;
    const float* lst = lse_s + st * kTile;
    const float* dlt = delta_s + st * kTile;
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile qt has landed; every thread is past tile
                       // qt - 1's products, so its stage, P and dS are free
    if (qt + 1 < n_q) {
      const int nx = (st ^ 1) * C::kTileF;
      cp_tile<D, NT>(qs + nx, q + qoff, row0 + kTile, a.sq, a.d);
      cp_tile<D, NT>(dos + nx, dout + qoff, row0 + kTile, a.sq, a.d);
      cp_row_vec(lse_s + (st ^ 1) * kTile, lse_h, row0 + kTile, a.sq);
      cp_row_vec(delta_s + (st ^ 1) * kTile, delta_h, row0 + kTile, a.sq);
    }
    hopper::cp_async_commit();
    float s[SQ][4], dp[SQ][4], lr[SQ], dr[SQ], bj[4];
    score_tile<D, SQ>(qst, ksg, s, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) lr[i] = lst[score_row(qb, i)];
#pragma unroll
    for (int j = 0; j < 4; ++j) bj[j] = bsg[g + 16 * j];
    if (edge_tile(a, row0, col0))
      split_probs<SQ, true>(a, row0, col0, qb, g, s, lr, bj);
    else
      split_probs<SQ, false>(a, row0, col0, qb, g, s, lr, bj);
    score_tile<D, SQ>(dost, vsg, dp, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) dr[i] = dlt[score_row(qb, i)];
    split_grads<SQ, DROP>(a, s, dp, dr, keep);
#pragma unroll
    for (int i = 0; i < SQ; ++i) {
      const int r = score_row(qb, i) * C::kLS + 4 * g;
      *reinterpret_cast<float4*>(psg + r) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(dssg + r) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    group_sync<H>(grp);   // the group's P and dS are whole
    acc_tile<D, AR>(dssg, qst, dka, pb, dc, [](int) {});
    keep = 0u;
    acc_tile<D, AR>(psg, dost, dva, pb, dc, [&](int blk) {
      if (DROP)
        keep |= keep_bits<SQ>(a, seed, bh, row0 + kTile, col0, qb, g,
                              blk * SQ / kAccBlocks, SQ / kAccBlocks);
    });
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < AR / 4; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = col0 + ((pb + 16 * m) >> 2) + 16 * t;
      if (c >= a.sk || dc >= a.d) continue;
      const size_t o = koff + (size_t)c * a.d + dc;
      *reinterpret_cast<float4*>(dk + o) =
          make_float4(dka[4 * m + t][0], dka[4 * m + t][1], dka[4 * m + t][2],
                      dka[4 * m + t][3]);
      *reinterpret_cast<float4*>(dv + o) =
          make_float4(dva[4 * m + t][0], dva[4 * m + t][1], dva[4 * m + t][2],
                      dva[4 * m + t][3]);
    }
}

// The pair's kernels: two groups over the rings up to D = 64, the single
// slots at D = 128 (whose dK and dV alone take 64 accumulators a thread);
// 256 threads and one CTA an SM either way.
template <int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Attn a) {
  if constexpr (D == 128)
    dq_f32_slots<D, DROP>(q, k, v, dout, lse, delta, dq, a);
  else
    dq_f32_ring<D, DROP, 2>(q, k, v, dout, lse, delta, dq, a);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Attn a) {
  if constexpr (D == 128)
    dkv_f32_slots<D, DROP>(q, k, v, dout, lse, delta, dk, dv, a);
  else
    dkv_f32_ring<D, DROP, 2>(q, k, v, dout, lse, delta, dk, dv, a);
}

// =================================== forward and fused backward, f32 (SIMT)
// Built from the split pair's pieces (see "SIMT forward and fused
// backward" at the top).

// Where query r of a 64-row tile sits in a P^T row: the two 2-bit fields
// of r % 16 swapped, so that a thread's queries r, r + 4, r + 8, r + 12
// lie side by side (one STS.128) and acc_tile's positions pb + 16 m + t
// are the queries (pb & ~15) + 16 m + 4 t + lane / 8.
__device__ __forceinline__ int qpos(int r) {
  return (r & ~15) | ((r & 3) << 2) | ((r >> 2) & 3);
}

// The forward's keep decisions of queries i0 .. i0 + n - 1 of the thread
// (bit 8 i + 4 n' + j: query row0 + fq + 4 i, key col0 + g + 8 n' + 16 j),
// one drop_bits call per query and key group
__device__ __forceinline__ uint32_t fwd_keep_bits(const Attn& a,
                                                  uint64_t seed, int bh,
                                                  int row0, int col0, int fq,
                                                  int g, int i0, int n) {
  uint32_t keep = 0;
  for (int i = i0; i < i0 + n; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 w =
          drop_bits(a, seed, bh, row0 + fq + 4 * i, col0 + g + 8 * h);
      keep |= ((uint32_t)(w.x >= a.thresh) | (uint32_t)(w.y >= a.thresh) << 1 |
               (uint32_t)(w.z >= a.thresh) << 2 |
               (uint32_t)(w.w >= a.thresh) << 3) << (8 * i + 4 * h);
    }
  return keep;
}

__device__ __forceinline__ float max8(float v) {   // over lane % 8
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum8(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The forward: grid (q tile of 64 H queries, b h), H groups of 64 queries
// (H = 2, 128 threads each, up to D = 64; H = 1, 256 threads, at D = 128).
// A thread scores SQ queries fq + 4 i against the 8 keys g + 8 n + 16 j of
// two Philox calls, so a query row's 64 keys lie in the 8 lanes of one
// warp: its max and sum are 3-step shuffles.  It accumulates the outputs
// of acc_tile's positions.  Q is loaded once; K and V stream through a
// 2-stage ring, one kv tile ahead; a CTA-wide barrier at the top of a kv
// tile and a barrier of the group between its P^T / alpha writes and its
// O += P V product (DROP: with dropout).
template <int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Attn a) {
  using C = SplitF32<D>;
  constexpr int H = 256 / C::kNT, NT = 256, AR = C::kAR;
  constexpr int SQ = C::kNT == 128 ? 4 : 2;   // queries a thread scores
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [H][64][D + 4]
  float* ks = qs + H * C::kTileF;         // [2][64][D + 4]
  float* vs = ks + 2 * C::kTileF;         // [2][64][D + 4]
  float* pt = vs + 2 * C::kTileF;         // [H] dropped P^T [key][qpos]
  float* rs = pt + H * C::kScoreF;        // [H][64] alpha, then 1 / l, by qpos
  const int bh = blockIdx.y, bi = bh / a.h;
  const int grp = threadIdx.x / C::kNT;
  const int cta0 = blockIdx.x * H * kTile, row0 = cta0 + grp * kTile;
  const float* qsg = qs + grp * C::kTileF;
  float* ptg = pt + grp * C::kScoreF;
  float* rsg = rs + grp * kTile;
  const size_t qoff = (size_t)bh * a.sq * a.d, koff = (size_t)bh * a.sk * a.d;
  const uint64_t seed = DROP ? (uint64_t)*a.seed : 0ull;
  const int warp = (threadIdx.x % C::kNT) / 32, lane = threadIdx.x % 32;
  // scores: queries fq + 4 i, keys g + 8 n + 16 j (element [i][4 n + j])
  const int g = lane % 8, fq = 4 * SQ * warp + lane / 8;
  // O: columns dc .. dc + 3 of P^T positions pb + 16 m + t
  const int dc = 32 * (warp % C::kCW) + 4 * (lane % 8);
  const int pb = (kTile / C::kRW) * (warp / C::kCW) + 4 * (lane / 8);
  // the last group's kv tiles: under causal masking an earlier group's
  // extra tile lies wholly above its diagonal (alpha 1, p 0: no change)
  const int n_kv = kv_tiles(a, cta0 + (H - 1) * kTile);

  cp_tile<D, NT, H * kTile>(qs, q + qoff, cta0, a.sq, a.d);
  cp_tile<D, NT>(ks, k + koff, 0, a.sk, a.d);
  cp_tile<D, NT>(vs, v + koff, 0, a.sk, a.d);
  hopper::cp_async_commit();
  float acc[AR][4], m[SQ], l[SQ];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < SQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;   // this thread's 8 keys of the row; summed at the end
  }
  uint32_t keep =
      DROP ? fwd_keep_bits(a, seed, bh, row0, 0, fq, g, 0, SQ) : 0u;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int col0 = kt * kTile, st = kt & 1;
    const float* kst = ks + st * C::kTileF;
    const float* vst = vs + st * C::kTileF;
    hopper::cp_async_wait<0>();
    __syncthreads();   // K and V of tile kt have landed; every thread is
                       // past tile kt - 1's product, so its stage, P^T
                       // and alpha are free
    if (kt + 1 < n_kv) {
      const int nx = (st ^ 1) * C::kTileF;
      cp_tile<D, NT>(ks + nx, k + koff, col0 + kTile, a.sk, a.d);
      cp_tile<D, NT>(vs + nx, v + koff, col0 + kTile, a.sk, a.d);
    }
    hopper::cp_async_commit();
    float s[SQ][8], bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + g + 8 * (j / 4) + 16 * (j % 4);
      bj[j] = (a.bias != nullptr && c < a.sk)
                  ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
    }
    score_tile<D, SQ, 2>(qsg, kst, s, fq, g);
    if (edge_tile(a, row0, col0)) {   // the masks only where they reach
#pragma unroll
      for (int i = 0; i < SQ; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = score(a, s[i][j], bj[j], row0 + fq + 4 * i,
                          col0 + g + 8 * (j / 4) + 16 * (j % 4));
    } else {
#pragma unroll
      for (int i = 0; i < SQ; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = s[i][j] * a.scale + bj[j];
    }
#pragma unroll
    for (int i = 0; i < SQ; ++i) {
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mc = fmaxf(mc, s[i][j]);
      const float m_next = fmaxf(m[i], max8(mc));
      const float base = m_next == -INFINITY ? 0.f : m_next;
      const float alpha = expf(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - base);
        sum += p;
        s[i][j] = DROP ? ((keep >> (8 * i + j)) & 1u ? p * a.keep_scale : 0.f)
                       : p;
      }
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
      if (g == 0) rsg[qpos(fq + 4 * i)] = alpha;
    }
    // P^T[key][qpos]: the thread's SQ queries of a key are side by side
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* dst = ptg + (g + 8 * (j / 4) + 16 * (j % 4)) * C::kLS + qpos(fq);
      if constexpr (SQ == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(s[0][j], s[1][j]);
    }
    group_sync<H>(grp);   // the group's P^T and alpha are whole
#pragma unroll
    for (int mm = 0; mm < AR / 4; ++mm) {
      const float4 al = *reinterpret_cast<const float4*>(rsg + pb + 16 * mm);
      const float ae[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * mm + t][e] *= ae[t];
    }
    // the next tile's keep bits, a query in each of the first SQ blocks
    if (DROP) keep = 0u;
    acc_tile<D, AR>(ptg, vst, acc, pb, dc, [&](int blk) {
      if (DROP && blk < SQ)
        keep |= fwd_keep_bits(a, seed, bh, row0, col0 + kTile, fq, g, blk, 1);
    });
  }
  hopper::cp_async_wait<0>();

  group_sync<H>(grp);   // every thread of the group has read alpha
#pragma unroll
  for (int i = 0; i < SQ; ++i) {
    const float lr = sum8(l[i]);
    const float l_safe = lr == 0.f ? 1.f : lr;
    const int r = row0 + fq + 4 * i;
    if (g == 0) {
      rsg[qpos(fq + 4 * i)] = 1.f / l_safe;
      if (r < a.sq) lse[(size_t)bh * a.sq + r] = m[i] + logf(l_safe);
    }
  }
  group_sync<H>(grp);   // 1 / l of every row
#pragma unroll
  for (int mm = 0; mm < AR / 4; ++mm) {
    const float4 il = *reinterpret_cast<const float4*>(rsg + pb + 16 * mm);
    const float ie[4] = {il.x, il.y, il.z, il.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = row0 + (kTile / C::kRW) * (warp / C::kCW) + 16 * mm +
                    4 * t + lane / 8;
      if (r < a.sq && dc < a.d)
        *reinterpret_cast<float4*>(out + qoff + (size_t)r * a.d + dc) =
            make_float4(acc[4 * mm + t][0] * ie[t], acc[4 * mm + t][1] * ie[t],
                        acc[4 * mm + t][2] * ie[t],
                        acc[4 * mm + t][3] * ie[t]);
    }
  }
}

// The fused backward's CTA: H kv tiles of 64 keys (H = 2 up to D = 64,
// H = 1 at D = 128), one group of the dK/dV kernel's each, and its dQ
// share of every q tile, a 64 x D f32 tile.  Thread t (warp w, lane l)
// holds rows qr + kRStep i (i < D / 16), qr = l / 8 + 4 (w / (kCB / 8)),
// at columns 4 cb .. 4 cb + 3, cb = l % 8 + 8 (w % (kCB / 8)): a warp
// reads 4 dS rows and 8 contiguous 16-byte chunks of a K row, one
// wavefront each.
template <int D>
struct FusedF32 {
  static constexpr int kH = D == 128 ? 1 : 2;
  static constexpr int kKeys = kH * kTile;    // keys a CTA
  static constexpr int kCB = D / 4;           // 4-column blocks of a row
  static constexpr int kRQ = D / 16;          // share rows a thread
  static constexpr int kRStep = 256 / kCB;    // between a thread's rows
};

// The float32 scratch of the f32 fused backward's dQ shares, one (b, h,
// sq, d) slice a kv-tile CTA of a (b, h), holds at most this many bytes,
// or kFusedF32MinParts slices where they are larger (4 takes every sk <=
// 512 up to head dim 64); the CTAs run in launches of as many ranks as
// it holds
constexpr size_t kFusedF32ScratchBytes = size_t{256} << 20;
constexpr int kFusedF32MinParts = 4;

// acc[i][e] += sum over the CTA's keys c of dS[qr + kRStep i][c] K[c][4 cb
// + e], in the order (kv tile, position): per 4 keys RQ + 4 LDS.128 for
// 16 RQ FFMAs (dS: [H][64][68] by position, K: [H][64][D + 4])
template <int D>
__device__ __forceinline__ void dq_share(const float* __restrict__ dss,
                                         const float* __restrict__ ks,
                                         float (&acc)[FusedF32<D>::kRQ][4],
                                         int qr, int cb) {
  using C = SplitF32<D>;
  using F = FusedF32<D>;
#pragma unroll
  for (int h = 0; h < F::kH; ++h)
#pragma unroll 4
    for (int p = 0; p < kTile; p += 4) {
      float4 dv[F::kRQ];
#pragma unroll
      for (int i = 0; i < F::kRQ; ++i)
        dv[i] = *reinterpret_cast<const float4*>(
            dss + h * C::kScoreF + (qr + F::kRStep * i) * C::kLS + p);
#pragma unroll
      for (int t = 0; t < 4; ++t) {   // position p + t: key p / 4 + 16 t
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + h * C::kTileF + (p / 4 + 16 * t) * (D + 4) + 4 * cb);
#pragma unroll
        for (int i = 0; i < F::kRQ; ++i) {
          const float x = t == 0 ? dv[i].x : t == 1 ? dv[i].y
                        : t == 2 ? dv[i].z : dv[i].w;
          acc[i][0] = fmaf(x, kv.x, acc[i][0]);
          acc[i][1] = fmaf(x, kv.y, acc[i][1]);
          acc[i][2] = fmaf(x, kv.z, acc[i][2]);
          acc[i][3] = fmaf(x, kv.w, acc[i][3]);
        }
      }
    }
}

// The fused backward: the dK/dV kernel's CTA (dkv_f32_ring, two groups
// over 2-stage rings up to D = 64; at D = 128 one group with one slot for
// Q, dO, lse and delta, refilled after the tile's products) plus, for each
// q tile, the CTA's dQ share.  1-D grid: CTA r + n_part bh runs rank (kv
// tile of F::kKeys keys) r0 + r.  Each CTA stores its share of every q
// tile it sees to parts[r][b h][sq][d], which flash_dq_parts_sum_kernel
// sums onto dQ in rank order, so every run gives the same bits; with one
// rank in all (sk <= F::kKeys) parts is dQ itself.  Under causal masking
// rank r has no share of the q tiles before its first (r H).
template <int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_fused_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ parts, float* __restrict__ dk,
                           float* __restrict__ dv, int r0, int n_part,
                           Attn a) {
  using C = SplitF32<D>;
  using F = FusedF32<D>;
  constexpr int H = F::kH, ST = F::kH;   // groups, ring stages
  constexpr int NT = 256, SQ = C::kSQ, AR = C::kAR, RQ = F::kRQ;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [H][64][D + 4]
  float* vs = ks + H * C::kTileF;         // [H][64][D + 4]
  float* qs = vs + H * C::kTileF;         // [ST][64][D + 4]
  float* dos = qs + ST * C::kTileF;       // [ST][64][D + 4]
  float* ps = dos + ST * C::kTileF;       // [H] dropped P [query][position]
  float* dss = ps + H * C::kScoreF;       // [H] dS [query][position]
  float* lse_s = dss + H * C::kScoreF;    // [ST][64]
  float* delta_s = lse_s + ST * kTile;    // [ST][64]
  float* bias_s = delta_s + ST * kTile;   // [H][64]
  const int part = blockIdx.x % n_part, bh = blockIdx.x / n_part;
  const int bi = bh / a.h, grp = threadIdx.x / C::kNT;
  const int cta0 = (r0 + part) * F::kKeys, col0 = cta0 + grp * kTile;
  const float* bsg = bias_s + grp * kTile;
  const float* ksg = ks + grp * C::kTileF;
  const float* vsg = vs + grp * C::kTileF;
  float* psg = ps + grp * C::kScoreF;
  float* dssg = dss + grp * C::kScoreF;
  const size_t qoff = (size_t)bh * a.sq * a.d, koff = (size_t)bh * a.sk * a.d;
  float* share =
      parts + (size_t)part * (gridDim.x / n_part) * a.sq * a.d + qoff;
  const float* lse_h = lse + (size_t)bh * a.sq;
  const float* delta_h = delta + (size_t)bh * a.sq;
  const uint64_t seed = DROP ? (uint64_t)*a.seed : 0ull;
  const int warp = (threadIdx.x % C::kNT) / 32, lane = threadIdx.x % 32;
  const int g = 8 * (warp % 2) + lane % 8;
  const int qb = 4 * SQ * (warp / 2) + lane / 8;
  const int dc = 32 * (warp % C::kCW) + 4 * (lane % 8);
  const int pb = (kTile / C::kRW) * (warp / C::kCW) + 4 * (lane / 8);
  // dQ share: rows qr + kRStep i, columns 4 cb .. 4 cb + 3
  const int cb = lane % 8 + 8 * ((threadIdx.x / 32) % (F::kCB / 8));
  const int qr = lane / 8 + 4 * ((threadIdx.x / 32) / (F::kCB / 8));
  const int n_q = (a.sq + kTile - 1) / kTile;
  const int qt0 = first_q_tile(a, cta0);

  // tile qt's Q, dO, lse and delta into stage st
  auto load_q = [&](int qt, int st) {
    cp_tile<D, NT>(qs + st * C::kTileF, q + qoff, qt * kTile, a.sq, a.d);
    cp_tile<D, NT>(dos + st * C::kTileF, dout + qoff, qt * kTile, a.sq, a.d);
    cp_row_vec(lse_s + st * kTile, lse_h, qt * kTile, a.sq);
    cp_row_vec(delta_s + st * kTile, delta_h, qt * kTile, a.sq);
  };
  cp_tile<D, NT, H * kTile>(ks, k + koff, cta0, a.sk, a.d);
  cp_tile<D, NT, H * kTile>(vs, v + koff, cta0, a.sk, a.d);
  if (qt0 < n_q) load_q(qt0, 0);
  hopper::cp_async_commit();
  if (threadIdx.x % C::kNT < kTile) {   // the group's bias row
    const int c = col0 + threadIdx.x % C::kNT;
    bias_s[threadIdx.x % C::kNT + grp * kTile] =
        (a.bias != nullptr && c < a.sk)
            ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
  }
  float dka[AR][4], dva[AR][4];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  uint32_t keep =
      DROP ? keep_bits<SQ>(a, seed, bh, qt0 * kTile, col0, qb, g) : 0u;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int row0 = qt * kTile;
    const int st = (qt - qt0) % ST;
    const float* qst = qs + st * C::kTileF;
    const float* dost = dos + st * C::kTileF;
    const float* lst = lse_s + st * kTile;
    const float* dlt = delta_s + st * kTile;
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile qt has landed; every thread is past tile qt -
                       // 1's products, so the other stage, P and dS are free
    if (ST == 2 && qt + 1 < n_q) load_q(qt + 1, st ^ 1);
    hopper::cp_async_commit();
    float s[SQ][4], dp[SQ][4], lr[SQ], dr[SQ], bj[4];
    score_tile<D, SQ>(qst, ksg, s, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) lr[i] = lst[score_row(qb, i)];
#pragma unroll
    for (int j = 0; j < 4; ++j) bj[j] = bsg[g + 16 * j];
    if (edge_tile(a, row0, col0))
      split_probs<SQ, true>(a, row0, col0, qb, g, s, lr, bj);
    else
      split_probs<SQ, false>(a, row0, col0, qb, g, s, lr, bj);
    score_tile<D, SQ>(dost, vsg, dp, qb, g);
#pragma unroll
    for (int i = 0; i < SQ; ++i) dr[i] = dlt[score_row(qb, i)];
    split_grads<SQ, DROP>(a, s, dp, dr, keep);
#pragma unroll
    for (int i = 0; i < SQ; ++i) {
      const int r = score_row(qb, i) * C::kLS + 4 * g;
      *reinterpret_cast<float4*>(psg + r) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(dssg + r) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();   // every group's P and dS are whole (dQ reads all)
    acc_tile<D, AR>(dssg, qst, dka, pb, dc, [](int) {});
    keep = 0u;
    acc_tile<D, AR>(psg, dost, dva, pb, dc, [&](int blk) {
      if (DROP)
        keep |= keep_bits<SQ>(a, seed, bh, row0 + kTile, col0, qb, g,
                              blk * SQ / kAccBlocks, SQ / kAccBlocks);
    });
    float dqs[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqs[i][e] = 0.f;
    dq_share<D>(dss, ks, dqs, qr, cb);
    if (ST == 1 && qt + 1 < n_q) {
      __syncthreads();   // every thread has read the slot
      load_q(qt + 1, 0);
      hopper::cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = row0 + qr + F::kRStep * i;
      if (r < a.sq && 4 * cb < a.d)
        *reinterpret_cast<float4*>(share + (size_t)r * a.d + 4 * cb) =
            make_float4(dqs[i][0], dqs[i][1], dqs[i][2], dqs[i][3]);
    }
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < AR / 4; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = col0 + ((pb + 16 * m) >> 2) + 16 * t;
      if (c >= a.sk || dc >= a.d) continue;
      const size_t o = koff + (size_t)c * a.d + dc;
      *reinterpret_cast<float4*>(dk + o) =
          make_float4(dka[4 * m + t][0], dka[4 * m + t][1], dka[4 * m + t][2],
                      dka[4 * m + t][3]);
      *reinterpret_cast<float4*>(dv + o) =
          make_float4(dva[4 * m + t][0], dva[4 * m + t][1], dva[4 * m + t][2],
                      dva[4 * m + t][3]);
    }
}

// dq[bh][i][j..j+3] (+)= parts[0] + parts[1] + ... over the launch's ranks
// r0 .. r0 + n_part - 1 that hold a share of row i, in that order: rank 0's
// launch stores the sum, a later one adds it to dQ's sum so far (rank
// order whatever the launches).  One thread per 4 floats.
__global__ void __launch_bounds__(256)
flash_dq_parts_sum_kernel(const float* __restrict__ parts,
                          float* __restrict__ dq, int r0, int n_part,
                          int cta_tiles, size_t n4, Attn a) {
  const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n4) return;
  const size_t o = 4 * x;               // into (b h, sq, d)
  const int i = (int)(o / a.d % a.sq);
  const int last = a.causal ? min(n_part - 1, i / kTile / cta_tiles - r0)
                            : n_part - 1;
  if (last < 0) return;
  float4 sum = *reinterpret_cast<const float4*>(parts + o);
  if (r0 > 0) {
    const float4 y = *reinterpret_cast<const float4*>(dq + o);
    sum = make_float4(y.x + sum.x, y.y + sum.y, y.z + sum.z, y.w + sum.w);
  }
  for (int r = 1; r <= last; ++r) {
    const float4 y =
        *reinterpret_cast<const float4*>(parts + (size_t)r * 4 * n4 + o);
    sum.x += y.x;
    sum.y += y.y;
    sum.z += y.z;
    sum.w += y.w;
  }
  *reinterpret_cast<float4*>(dq + o) = sum;
}

// ====================================== split backward on the tensor cores
// The bf16 / fp16 dQ and dK/dV kernels (T = __nv_bfloat16 or __half): one
// warpgroup per CTA, wgmma products with f32 accumulators, TMA-fed tiles
// in shared memory (see the note at the top).
constexpr int kTcThreads = 128;

// This thread's place in an m64 accumulator: rows tc_row() and
// tc_row() + 8, columns 8 n + tc_col() + e (e < 2).
__device__ __forceinline__ int tc_row() {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4;
}
__device__ __forceinline__ int tc_col() { return 2 * (threadIdx.x % 4); }

// Row R of the dK/dV kernel's kv tile holds kv row swap34(R): bits 3 and 4
// exchanged, so a thread's two accumulator rows R and R + 8 are kv rows j
// and j + 16, two words of one Philox call.
__device__ __forceinline__ int swap34(int r) {
  return (r & ~24) | ((r & 8) << 1) | ((r & 16) >> 1);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (hopper::smem_addr(p) & 1023u)) & 1023u);
}

// the R-row tile of head bh at row0 of a (b h, s, d) map into `tile`
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint8_t* tile, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
  using G = hopper::TileCols<D>;
#pragma unroll
  for (int at = 0; at < G::kAtoms; ++at)
    hopper::tma_load_3d(tile + at * R * G::kRowBytes, map, bar,
                        at * G::kAtomCols, row0, bh);
}

// the 64-row kv tile at col0 in swap34 order, as 8-row boxes (the map's)
template <int D>
__device__ __forceinline__ void tma_kv_swapped(uint8_t* tile,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int col0,
                                               int bh) {
  using G = hopper::TileCols<D>;
#pragma unroll
  for (int at = 0; at < G::kAtoms; ++at)
#pragma unroll
    for (int blk = 0; blk < kTile / 8; ++blk)
      hopper::tma_load_3d(tile + (at * kTile + 8 * blk) * G::kRowBytes, map,
                          bar, at * G::kAtomCols, col0 + swap34(8 * blk), bh);
}

// dS of one 64 x 64 tile of the dQ kernel, from this thread's elements of
// S = Q K^T and dP = dO V^T (rows row0 + tc_row() + 8 h, columns col0 +
// 8 n + tc_col() + e), rounded to T and packed as the A operand of
// dQ += dS K (k16 step c in ds[c]).  The arithmetic of bwd_terms; with
// EDGE false (a tile inside sq x sk that no causal mask reaches) the
// masks are left out.
template <typename T, bool EDGE>
__device__ __forceinline__ void dq_terms(const Attn& a, uint64_t seed, int bh,
                                         int bi, int row0, int col0,
                                         const float (&s)[32],
                                         const float (&dp)[32],
                                         const float (&lr)[2],
                                         const float (&dr)[2],
                                         uint32_t (&ds)[4][4]) {
  const int rr = tc_row(), cc = tc_col();
  float bj[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + 8 * n + cc + e;
      bj[n][e] = (a.bias != nullptr && (!EDGE || c < a.sk))
                     ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
    }
  float v[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rr + 8 * h;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // one Philox call: columns col0 + 8 n + cc + e, n = m, m + 2,
        // m + 4, m + 6 (word n / 2)
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if (a.seed != nullptr)
          bits = drop_bits(a, seed, bh, r, col0 + 8 * m + cc + e);
#pragma unroll
        for (int n = m; n < 8; n += 2) {
          const int i = 4 * n + 2 * h + e;
          const int c = col0 + 8 * n + cc + e;
          float p;
          if (EDGE) {
            const bool valid = r < a.sq && c < a.sk;
            p = valid ? expf(score(a, s[i], bj[n][e], r, c) - lr[h]) : 0.f;
          } else {
            p = expf(s[i] * a.scale + bj[n][e] - lr[h]);
          }
          float dpd = dp[i];
          if (a.seed != nullptr)
            dpd = word(bits, n >> 1) >= a.thresh ? dpd * a.keep_scale : 0.f;
          v[i] = p * (dpd - dr[h]) * a.scale;
        }
      }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ds[c][m] = hopper::pack2<T>(v[8 * c + 2 * m], v[8 * c + 2 * m + 1]);
}

// -------------------------------------------- backward: dQ, tensor cores
// grid (q tile, b h).  Q and dO (64 rows) stay in shared memory; K and V
// tiles stream through a 2-stage TMA ring.
template <int D, typename T>
__global__ void __launch_bounds__(kTcThreads, D == 128 ? 1 : 3)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       Attn a) {
  using namespace hopper;
  constexpr int kBytes = kTile * D * 2;   // one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* dos = qs + kBytes;
  uint8_t* kv = dos + kBytes;   // stage st: K at kv + 2 st kBytes, then V
  // bar[0]: Q and dO; bar[1 + st]: ring stage st
  uint64_t* bar = reinterpret_cast<uint64_t*>(kv + 4 * kBytes);
  const int bh = blockIdx.y, bi = bh / a.h;
  const int row0 = blockIdx.x * kTile;
  const int n_kv = kv_tiles(a, row0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], 2 * kBytes);
    tma_tile<D, kTile>(qs, &tq, &bar[0], row0, bh);
    tma_tile<D, kTile>(dos, &tdo, &bar[0], row0, bh);
    for (int st = 0; st < 2 && st < n_kv; ++st) {
      mbar_expect_tx(&bar[1 + st], 2 * kBytes);
      tma_tile<D, kTile>(kv + 2 * st * kBytes, &tk, &bar[1 + st],
                         st * kTile, bh);
      tma_tile<D, kTile>(kv + (2 * st + 1) * kBytes, &tv, &bar[1 + st],
                         st * kTile, bh);
    }
  }
  const int rr = tc_row(), cc = tc_col();
  const uint64_t seed = a.seed != nullptr ? (uint64_t)*a.seed : 0ull;
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rr + 8 * h;
    lr[h] = r < a.sq ? __ldg(lse + (size_t)bh * a.sq + r) : 0.f;
    dr[h] = r < a.sq ? __ldg(delta + (size_t)bh * a.sq + r) : 0.f;
  }
  float acc[D / 2];
  mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    uint8_t* ks = kv + 2 * st * kBytes;
    uint8_t* vs = ks + kBytes;
    mbar_wait(&bar[1 + st], (kt >> 1) & 1);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0>(s, desc_kmajor<D, kTile>(qs, kk),
                     desc_kmajor<D, kTile>(ks, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0>(dp, desc_kmajor<D, kTile>(dos, kk),
                     desc_kmajor<D, kTile>(vs, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t ds[4][4];
    const int col0 = kt * kTile;
    if (row0 + kTile > a.sq || col0 + kTile > a.sk ||
        (a.causal && col0 + kTile - 1 > row0))
      dq_terms<T, true>(a, seed, bh, bi, row0, col0, s, dp, lr, dr, ds);
    else
      dq_terms<T, false>(a, seed, bh, bi, row0, col0, s, dp, lr, dr, ds);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_rs<T, 1>(acc, ds[c], desc_mnmajor<D, kTile>(ks, c),
                     kt > 0 || c > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(ds[c]);
    __syncthreads();   // every warp is done with stage st
    if (threadIdx.x == 0 && kt + 2 < n_kv) {
      mbar_expect_tx(&bar[1 + st], 2 * kBytes);
      tma_tile<D, kTile>(ks, &tk, &bar[1 + st], (kt + 2) * kTile, bh);
      tma_tile<D, kTile>(vs, &tv, &bar[1 + st], (kt + 2) * kTile, bh);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rr + 8 * h;
    if (r >= a.sq) continue;
    T* row = dq + ((size_t)bh * a.sq + r) * a.d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n + cc < a.d)
        *reinterpret_cast<uint32_t*>(row + 8 * n + cc) =
            pack2<T>(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  }
}

// The dK/dV kernel's q tile: 64 rows, or 32 at D = 128, where dK and dV
// alone hold 128 accumulators a thread.
template <int D>
constexpr int kDkvQRows = D == 128 ? 32 : 64;

// P^T (dropped) and dS^T of one kv x q tile of the dK/dV kernel, from this
// thread's elements of S^T = K Q^T and dP^T = V dO^T (kv rows jr[h],
// query columns q0 + 8 n + tc_col() + e), rounded to T and packed as the
// A operands of dV += P^T dO (pa) and dK += dS^T Q (da).  EDGE as in
// dq_terms.
//
// Dropout: one Philox call (query, group of jr[0]) holds the keep words of
// kv rows jr[0], jr[0] + 16 (this thread's: words 2 half, 2 half + 1,
// half = warp / 2) and jr[0] + 32, jr[0] + 48 (warp ^ 2's, same lane).
// So warps w and w ^ 2 share their calls: each draws those of the column
// blocks n with n % 2 == half into xchg (shared memory, kDkvXchg<NQ>
// bytes), and both read their two words from there: one call per 4
// elements.
template <int NQ>   // the calls' words: (warp % 2, n % 2, n / 2, e, lane)
constexpr int kDkvXchg = 2 * 2 * (NQ / 16) * 2 * 32 * (int)sizeof(uint4);

template <typename T, int NQ, bool EDGE>
__device__ __forceinline__ void dkv_terms(
    const Attn& a, uint64_t seed, int bh, int q0, const int (&jr)[2],
    const float (&br)[2], const float (&s)[NQ / 2],
    const float (&dp)[NQ / 2], const float* lse_s, const float* delta_s,
    uint4* xchg, uint32_t (&pa)[NQ / 16][4], uint32_t (&da)[NQ / 16][4]) {
  const int cc = tc_col(), lane = threadIdx.x % 32;
  const int half = threadIdx.x / 64, pair = threadIdx.x / 32 % 2;
  constexpr int kSlot = (NQ / 16) * 2 * 32;   // one (pair, n % 2)'s calls
  const uint2* words = reinterpret_cast<const uint2*>(xchg + pair * 2 * kSlot);
  if (a.seed != nullptr) {
    uint4* mine = xchg + (pair * 2 + half) * kSlot;
#pragma unroll
    for (int m = 0; m < NQ / 16; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mine[(2 * m + e) * 32 + lane] = drop_bits(
            a, seed, bh, q0 + 16 * m + 8 * half + cc + e, jr[0]);
    __syncthreads();   // the partner's calls are in xchg
  }
  float pv[NQ / 2], dv[NQ / 2];
#pragma unroll
  for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ci = 8 * n + cc + e;
      const int i = q0 + ci;
      const float li = lse_s[ci], di = delta_s[ci];
      uint2 kw = make_uint2(0u, 0u);   // keep words of kv rows jr[0], jr[1]
      if (a.seed != nullptr)
        kw = words[2 * (((n & 1) * (NQ / 16) + (n >> 1)) * 2 * 32 + e * 32 +
                        lane) + half];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * n + 2 * h + e;
        float p;
        if (EDGE) {
          const bool valid = i < a.sq && jr[h] < a.sk;
          p = valid ? expf(score(a, s[x], br[h], i, jr[h]) - li) : 0.f;
        } else {
          p = expf(s[x] * a.scale + br[h] - li);
        }
        float pd = p, dpd = dp[x];
        if (a.seed != nullptr) {
          const bool keep = (h ? kw.y : kw.x) >= a.thresh;
          pd = keep ? p * a.keep_scale : 0.f;
          dpd = keep ? dpd * a.keep_scale : 0.f;
        }
        pv[x] = pd;
        dv[x] = p * (dpd - di) * a.scale;
      }
    }
#pragma unroll
  for (int c = 0; c < NQ / 16; ++c)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      pa[c][m] = hopper::pack2<T>(pv[8 * c + 2 * m], pv[8 * c + 2 * m + 1]);
      da[c][m] = hopper::pack2<T>(dv[8 * c + 2 * m], dv[8 * c + 2 * m + 1]);
    }
}

// ----------------------------------------- backward: dK/dV, tensor cores
// grid (kv tile, b h).  K and V (64 rows, swap34 order) stay in shared
// memory; Q, dO, lse and delta tiles stream through a 2-stage TMA ring.
// lse and delta of a q tile arrive as kDkvQRows + 4 floats from the
// 16-byte boundary at or before the tile's first row (TMA's 1-D boxes
// start there), each in a 128-byte aligned slot (TMA's destinations are)
template <int D>
constexpr int kDkvVecBox = kDkvQRows<D> + 4;
template <int D>
constexpr int kDkvVecSlot = (kDkvVecBox<D> * 4 + 127) / 128 * 128;
template <int D>   // one ring stage (Q, dO, lse, delta), 1024-aligned
constexpr int kDkvStageBytes =
    (2 * kDkvQRows<D> * D * 2 + 2 * kDkvVecSlot<D> + 1023) / 1024 * 1024;

template <int D, typename T>
__global__ void __launch_bounds__(kTcThreads, D == 128 ? 1 : 3)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tlse,
                        const __grid_constant__ CUtensorMap tdelta,
                        T* __restrict__ dk, T* __restrict__ dv, Attn a) {
  using namespace hopper;
  constexpr int NQ = kDkvQRows<D>;
  constexpr int kKvBytes = kTile * D * 2, kQBytes = NQ * D * 2;
  constexpr int kStage = kDkvStageBytes<D>;
  constexpr int kVec = kDkvVecSlot<D>;
  constexpr uint32_t kStageTx = 2 * kQBytes + 2 * kDkvVecBox<D> * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align_1024(smem_raw);
  uint8_t* vs = ks + kKvBytes;
  uint8_t* ring = vs + kKvBytes;   // stage st: Q, dO, lse, delta
  uint4* xchg = reinterpret_cast<uint4*>(ring + 2 * kStage);
  // bar[0]: K and V; bar[1 + st]: ring stage st
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(ring + 2 * kStage + kDkvXchg<NQ>);
  const int bh = blockIdx.y, bi = bh / a.h;
  const int col0 = blockIdx.x * kTile;
  // the q tiles that see this kv tile (causal: none above the diagonal)
  const int q_begin = a.causal ? col0 / NQ : 0;
  const int n_q = (a.sq + NQ - 1) / NQ - q_begin;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto load_q = [&](int it, int st) {   // thread 0: q tile q_begin + it
    uint8_t* stage = ring + st * kStage;
    const int q0 = (q_begin + it) * NQ;
    mbar_expect_tx(&bar[1 + st], kStageTx);
    tma_tile<D, NQ>(stage, &tq, &bar[1 + st], q0, bh);
    tma_tile<D, NQ>(stage + kQBytes, &tdo, &bar[1 + st], q0, bh);
    const int v0 = (bh * a.sq + q0) & ~3;
    tma_load_1d(stage + 2 * kQBytes, &tlse, &bar[1 + st], v0);
    tma_load_1d(stage + 2 * kQBytes + kVec, &tdelta, &bar[1 + st], v0);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], 2 * kKvBytes);
    tma_kv_swapped<D>(ks, &tk, &bar[0], col0, bh);
    tma_kv_swapped<D>(vs, &tv, &bar[0], col0, bh);
    for (int st = 0; st < 2 && st < n_q; ++st) load_q(st, st);
  }
  const int rr = tc_row(), cc = tc_col();
  const uint64_t seed = a.seed != nullptr ? (uint64_t)*a.seed : 0ull;
  const int jr[2] = {col0 + swap34(rr), col0 + swap34(rr) + 16};
  float br[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    br[h] = (a.bias != nullptr && jr[h] < a.sk)
                ? __ldg(a.bias + (size_t)bi * a.sk + jr[h]) : 0.f;
  float dka[D / 2], dva[D / 2];
  mbar_wait(&bar[0], 0);

  for (int it = 0; it < n_q; ++it) {
    const int st = it & 1;
    uint8_t* qs = ring + st * kStage;
    uint8_t* dos = qs + kQBytes;
    const int q0 = (q_begin + it) * NQ;
    // lse and delta of row q0 + ci at lse_s[ci], delta_s[ci]
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kQBytes) +
                         ((bh * a.sq + q0) & 3);
    const float* delta_s = lse_s + kVec / 4;
    mbar_wait(&bar[1 + st], (it >> 1) & 1);
    float s[NQ / 2], dp[NQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0>(s, desc_kmajor<D, kTile>(ks, kk),
                     desc_kmajor<D, NQ>(qs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0>(dp, desc_kmajor<D, kTile>(vs, kk),
                     desc_kmajor<D, NQ>(dos, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t pa[NQ / 16][4], da[NQ / 16][4];
    if (q0 + NQ > a.sq || col0 + kTile > a.sk ||
        (a.causal && col0 + kTile - 1 > q0))
      dkv_terms<T, NQ, true>(a, seed, bh, q0, jr, br, s, dp, lse_s, delta_s,
                             xchg, pa, da);
    else
      dkv_terms<T, NQ, false>(a, seed, bh, q0, jr, br, s, dp, lse_s, delta_s,
                              xchg, pa, da);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NQ / 16; ++c)
      wgmma_rs<T, 1>(dva, pa[c], desc_mnmajor<D, NQ>(dos, c),
                     it > 0 || c > 0);
#pragma unroll
    for (int c = 0; c < NQ / 16; ++c)
      wgmma_rs<T, 1>(dka, da[c], desc_mnmajor<D, NQ>(qs, c),
                     it > 0 || c > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
#pragma unroll
    for (int c = 0; c < NQ / 16; ++c) {
      fence_regs(pa[c]);
      fence_regs(da[c]);
    }
    __syncthreads();   // every warp is done with stage st
    if (threadIdx.x == 0 && it + 2 < n_q) load_q(it + 2, st);
  }

  if (n_q <= 0) {   // no query sees this kv tile
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = jr[h];
    if (j >= a.sk) continue;
    const size_t o = ((size_t)bh * a.sk + j) * a.d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n + cc < a.d) {
        const int x = 4 * n + 2 * h;
        *reinterpret_cast<uint32_t*>(dk + o + 8 * n + cc) =
            pack2<T>(dka[x], dka[x + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + 8 * n + cc) =
            pack2<T>(dva[x], dva[x + 1]);
      }
  }
}

// ------------------------------------------------- forward, tensor cores
// The forward's softmax on the fragment of one 64 x 64 tile S = Q K^T
// (rows row0 + tc_row() + 8 h, columns col0 + 8 n + tc_col() + e): the
// online max and sum of flash_fwd_kernel, with a row's 64 columns in the
// 4 lanes of a quad (two shuffles).  l takes the undropped p; the dropped
// p, rounded to T, is packed as the A operand of O += P V (k16 step c in
// pa[c]).  alpha[h] rescales row h's output.  Dropout draws one Philox
// call per 4 elements, as dq_terms does.  EDGE as in dq_terms.
template <typename T, bool EDGE>
__device__ __forceinline__ void fwd_terms(const Attn& a, uint64_t seed,
                                          int bh, int bi, int row0, int col0,
                                          float (&s)[32], float (&m)[2],
                                          float (&l)[2], float (&alpha)[2],
                                          uint32_t (&pa)[4][4]) {
  const int rr = tc_row(), cc = tc_col();
  float bj[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + 8 * n + cc + e;
      bj[n][e] = (a.bias != nullptr && (!EDGE || c < a.sk))
                     ? __ldg(a.bias + (size_t)bi * a.sk + c) : 0.f;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rr + 8 * h;
    float mc = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * h + e;
        s[i] = EDGE ? score(a, s[i], bj[n][e], r, col0 + 8 * n + cc + e)
                    : s[i] * a.scale + bj[n][e];
        mc = fmaxf(mc, s[i]);
      }
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_next = fmaxf(m[h], mc);
    const float base = m_next == -INFINITY ? 0.f : m_next;
    alpha[h] = expf(m[h] - base);
    float rs = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        // one Philox call: columns col0 + 8 n + cc + e, n = mm, mm + 2,
        // mm + 4, mm + 6 (word n / 2)
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if (a.seed != nullptr)
          bits = drop_bits(a, seed, bh, r, col0 + 8 * mm + cc + e);
#pragma unroll
        for (int n = mm; n < 8; n += 2) {
          const int i = 4 * n + 2 * h + e;
          const float p = expf(s[i] - base);
          rs += p;
          s[i] = p;
          if (a.seed != nullptr)
            s[i] = word(bits, n >> 1) >= a.thresh ? p * a.keep_scale : 0.f;
        }
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[h] = alpha[h] * l[h] + rs;
    m[h] = m_next;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
      pa[c][mm] = hopper::pack2<T>(s[8 * c + 2 * mm], s[8 * c + 2 * mm + 1]);
}

// grid (q tile, b h), one warpgroup.  Q (64 rows) stays in shared memory;
// K and V tiles stream through a 2-stage TMA ring, as in the dQ kernel.
// S = Q K^T reads both operands K-major; O += P V takes P from registers
// and V MN-major.  m, l and O live in registers across the kv loop.
template <int D, typename T>
__global__ void __launch_bounds__(kTcThreads, D == 128 ? 2 : 3)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    T* __restrict__ out, float* __restrict__ lse, Attn a) {
  using namespace hopper;
  constexpr int kBytes = kTile * D * 2;   // one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* kv = qs + kBytes;   // stage st: K at kv + 2 st kBytes, then V
  // bar[0]: Q; bar[1 + st]: ring stage st
  uint64_t* bar = reinterpret_cast<uint64_t*>(kv + 4 * kBytes);
  const int bh = blockIdx.y, bi = bh / a.h;
  const int row0 = blockIdx.x * kTile;
  const int n_kv = kv_tiles(a, row0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], kBytes);
    tma_tile<D, kTile>(qs, &tq, &bar[0], row0, bh);
    for (int st = 0; st < 2 && st < n_kv; ++st) {
      mbar_expect_tx(&bar[1 + st], 2 * kBytes);
      tma_tile<D, kTile>(kv + 2 * st * kBytes, &tk, &bar[1 + st],
                         st * kTile, bh);
      tma_tile<D, kTile>(kv + (2 * st + 1) * kBytes, &tv, &bar[1 + st],
                         st * kTile, bh);
    }
  }
  const uint64_t seed = a.seed != nullptr ? (uint64_t)*a.seed : 0ull;
  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    uint8_t* ks = kv + 2 * st * kBytes;
    uint8_t* vs = ks + kBytes;
    mbar_wait(&bar[1 + st], (kt >> 1) & 1);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0>(s, desc_kmajor<D, kTile>(qs, kk),
                     desc_kmajor<D, kTile>(ks, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const int col0 = kt * kTile;
    float alpha[2];
    uint32_t pa[4][4];
    if (col0 + kTile > a.sk || (a.causal && col0 + kTile - 1 > row0))
      fwd_terms<T, true>(a, seed, bh, bi, row0, col0, s, m, l, alpha, pa);
    else
      fwd_terms<T, false>(a, seed, bh, bi, row0, col0, s, m, l, alpha, pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_rs<T, 1>(o, pa[c], desc_mnmajor<D, kTile>(vs, c), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(pa[c]);
    __syncthreads();   // every warp is done with stage st
    if (threadIdx.x == 0 && kt + 2 < n_kv) {
      mbar_expect_tx(&bar[1 + st], 2 * kBytes);
      tma_tile<D, kTile>(ks, &tk, &bar[1 + st], (kt + 2) * kTile, bh);
      tma_tile<D, kTile>(vs, &tv, &bar[1 + st], (kt + 2) * kTile, bh);
    }
  }

  const int rr = tc_row(), cc = tc_col();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rr + 8 * h;
    if (r >= a.sq) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / l_safe;
    T* row = out + ((size_t)bh * a.sq + r) * a.d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n + cc < a.d)
        *reinterpret_cast<uint32_t*>(row + 8 * n + cc) = pack2<T>(
            o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
    if (cc == 0) lse[(size_t)bh * a.sq + r] = m[h] + logf(l_safe);
  }
}

// ------------------------------------------ fused backward, tensor cores
// A T x 2 pair v at (row r, column col) of a 16-bit shared-memory tile of
// `cols` (32 or 64) columns in TMA's swizzle (64- or 128-byte), the
// layout the wgmma descriptors read.
__device__ __forceinline__ void st_swizzled(uint8_t* tile, int cols, int r,
                                            int col, uint32_t v) {
  const int x = cols == 64 ? (r & 7) : ((r >> 1) & 3);
  *reinterpret_cast<uint32_t*>(tile + r * 2 * cols +
                               (((col >> 3) ^ x) << 4) + (col & 7) * 2) = v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// after a __syncthreads: every store and red of this CTA is visible on
// the device, then *flag = v
__device__ __forceinline__ void publish(int* flag, int v) {
  __threadfence();
  st_release(flag, v);
}

// spins until *flag == want; traps after about 2^34 clocks, as mbar_wait
__device__ __forceinline__ void wait_flag(const int* flag, int want) {
  const long long t0 = clock64();
  while (ld_acquire(flag) != want)
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// The last kv tile that adds into the q tile at q0 (NQ rows): every kv
// tile, or when causal the last whose first q tile (col0 / NQ) is at or
// before it.
template <int NQ>
__device__ __forceinline__ int last_kv_tile(const Attn& a, int q0) {
  const int last = (a.sk + kTile - 1) / kTile - 1;
  return a.causal ? min(last, (q0 + NQ - 1) / kTile) : last;
}

// The dK/dV kernel's body plus dQ.  dS^T, which dkv_terms leaves in
// registers in kv-row layout, is stored to shared memory as a 64 x NQ tile
// of T in TMA's swizzle (in the bytes of the Philox exchange, once its
// words are read); from there it is the A operand of dK += dS^T Q
// (K-major) and the B operand of dQ^T = K^T dS^T (both MN-major, M = D in
// m64 blocks: so head dims up to 32 run at the 64 tile).  The kv rows of K
// and dS^T are both in swap34 order, which the sum over kv does not see.
//
// dQ is summed in float32 across the kv tiles of a (b, h) in kv order, so
// that every run gives the same bits, in one of two ways:
// * clustered (up to kFusedMaxCluster kv tiles, every sk <= 512): grid
//   (kv tile, b h), the (b, h)'s kv-tile CTAs one thread-block cluster.
//   For each q tile every CTA writes its f32 share of dQ over the tile's
//   Q and dO in its own ring stage (consumed by then) and, after a
//   cluster barrier, sums a slice of the tile over the cluster's shares,
//   rank 0 first, read 16 bytes at a time through distributed shared
//   memory, and stores it in T.  The next barrier, one q tile later,
//   says that the cluster has read the share: only then does its stage
//   take the next q tile.  One cluster barrier a q tile, no device memory
//   but dQ; the q tiles run in step across the cluster (a CTA with no
//   share of a causal q tile only sums);
// * chained (more kv tiles): grid (kv tile x b h), flattened.  CTA (kt,
//   bh) adds its share of q tile qt into dq_acc (device memory, through
//   L2) once CTA (kt - 1, bh) has, by a flag per (b h, q tile) that counts
//   the shares added: kv tile 0 stores, the middle ones add (red.add;
//   like every f32 atomic it flushes sums below 2^-126 to zero), the last
//   reads, adds and stores in T.  A CTA polls its flag while its last
//   products of the tile run, and raises the next one's after the next
//   tile's first products are issued.  The CTAs take their (kt, bh) from
//   a counter in the order they start, so the CTA a flag waits on has
//   started (it waits only on earlier ones): no deadlock, whatever the
//   number of CTAs.
constexpr int kFusedMaxCluster = 8;   // the portable cluster size

// The float offset of dQ element (query i, dim j) of a q tile's share:
// rows of D floats, the dims' 8-float groups XOR-swizzled by the query so
// that the fragment's stores (4 queries x 8 dims a warp) hit 32 banks.
template <int D>
__device__ __forceinline__ int part_off(int i, int j) {
  return i * D + (j ^ (((i >> 1) & 3) << 3));
}

template <int D, typename T>
__global__ void __launch_bounds__(kTcThreads, D == 128 ? 1 : 3)
flash_bwd_fused_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tlse,
                          const __grid_constant__ CUtensorMap tdelta,
                          float* __restrict__ dq_acc, int* __restrict__ flags,
                          T* __restrict__ dq, T* __restrict__ dk,
                          T* __restrict__ dv, Attn a) {
  using namespace hopper;
  constexpr int NQ = kDkvQRows<D>;
  constexpr int kKvBytes = kTile * D * 2, kQBytes = NQ * D * 2;
  constexpr int kStage = kDkvStageBytes<D>;
  constexpr int kVec = kDkvVecSlot<D>;
  constexpr uint32_t kStageTx = 2 * kQBytes + 2 * kDkvVecBox<D> * 4;
  constexpr int MB = D / 64;   // m64 blocks of dQ^T
  static_assert(NQ * D * 4 == 2 * kQBytes, "a share fits over Q and dO");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align_1024(smem_raw);
  uint8_t* vs = ks + kKvBytes;
  uint8_t* ring = vs + kKvBytes;   // stage st: Q, dO, lse, delta
  uint4* xchg = reinterpret_cast<uint4*>(ring + 2 * kStage);
  uint8_t* dst = reinterpret_cast<uint8_t*>(xchg);   // dS^T
  // bar[0]: K and V; bar[1 + st]: ring stage st; then the CTA's number
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(ring + 2 * kStage + kDkvXchg<NQ>);
  int* order = reinterpret_cast<int*>(&bar[3]);
  const int n_kv = (a.sk + kTile - 1) / kTile;
  const bool clustered = cluster_size() > 1;
  if (threadIdx.x == 0) {
    if (!clustered) *order = atomicAdd(&flags[0], 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int kt = clustered ? (int)cluster_rank() : *order % n_kv;
  const int bh = clustered ? (int)blockIdx.y : *order / n_kv;
  const int bi = bh / a.h, col0 = kt * kTile;
  const int n_qt = (a.sq + NQ - 1) / NQ;
  int* qflag = flags + 1 + (size_t)bh * n_qt;   // chained: one per q tile
  // the q tiles that see this kv tile (causal: none above the diagonal)
  const int q_begin = a.causal ? col0 / NQ : 0;
  const int n_q = n_qt - q_begin;

  auto load_q = [&](int it, int st) {   // thread 0: q tile q_begin + it
    uint8_t* stage = ring + st * kStage;
    const int q0 = (q_begin + it) * NQ;
    mbar_expect_tx(&bar[1 + st], kStageTx);
    tma_tile<D, NQ>(stage, &tq, &bar[1 + st], q0, bh);
    tma_tile<D, NQ>(stage + kQBytes, &tdo, &bar[1 + st], q0, bh);
    const int v0 = (bh * a.sq + q0) & ~3;
    tma_load_1d(stage + 2 * kQBytes, &tlse, &bar[1 + st], v0);
    tma_load_1d(stage + 2 * kQBytes + kVec, &tdelta, &bar[1 + st], v0);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], 2 * kKvBytes);
    tma_kv_swapped<D>(ks, &tk, &bar[0], col0, bh);
    tma_kv_swapped<D>(vs, &tv, &bar[0], col0, bh);
    for (int st = 0; st < 2 && st < n_q; ++st) load_q(st, st);
  }
  const int rr = tc_row(), cc = tc_col();
  const uint64_t seed = a.seed != nullptr ? (uint64_t)*a.seed : 0ull;
  const int jr[2] = {col0 + swap34(rr), col0 + swap34(rr) + 16};
  float br[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    br[h] = (a.bias != nullptr && jr[h] < a.sk)
                ? __ldg(a.bias + (size_t)bi * a.sk + jr[h]) : 0.f;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float* acc = dq_acc + (size_t)bh * a.sq * a.d;
  T* dqh = dq + (size_t)bh * a.sq * a.d;
  mbar_wait(&bar[0], 0);

  // clustered: every q tile, in step with the cluster; chained: this kv
  // tile's q tiles
  for (int qt = clustered ? 0 : q_begin; qt < n_qt; ++qt) {
    const int it = qt - q_begin, q0 = qt * NQ;
    const int last = last_kv_tile<NQ>(a, q0);   // the last share's kv tile
    float dqt[MB][NQ / 2];
    if (it >= 0) {
      const int st = it & 1;
      uint8_t* qs = ring + st * kStage;
      uint8_t* dos = qs + kQBytes;
      // lse and delta of row q0 + ci at lse_s[ci], delta_s[ci]
      const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kQBytes) +
                           ((bh * a.sq + q0) & 3);
      const float* delta_s = lse_s + kVec / 4;
      mbar_wait(&bar[1 + st], (it >> 1) & 1);
      float s[NQ / 2], dp[NQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, 0>(s, desc_kmajor<D, kTile>(ks, kk),
                       desc_kmajor<D, NQ>(qs, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, 0>(dp, desc_kmajor<D, kTile>(vs, kk),
                       desc_kmajor<D, NQ>(dos, kk), kk);
      wgmma_commit();
      // chained: the last q tile's share is in L2; tell kv tile kt + 1
      // while the products run
      if (!clustered && threadIdx.x == 0 && it > 0)
        publish(&qflag[qt - 1], kt + 1);
      __syncwarp();   // warp 0 whole again for the aligned wait
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      uint32_t pa[NQ / 16][4], da[NQ / 16][4];
      if (q0 + NQ > a.sq || col0 + kTile > a.sk ||
          (a.causal && col0 + kTile - 1 > q0))
        dkv_terms<T, NQ, true>(a, seed, bh, q0, jr, br, s, dp, lse_s,
                               delta_s, xchg, pa, da);
      else
        dkv_terms<T, NQ, false>(a, seed, bh, q0, jr, br, s, dp, lse_s,
                                delta_s, xchg, pa, da);
      if (a.seed != nullptr) __syncthreads();   // xchg's words are read
      // da[c][mm]: kv row rr + 8 (mm % 2), queries 16 c + 8 (mm / 2) + cc
      // and + 1
#pragma unroll
      for (int c = 0; c < NQ / 16; ++c)
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
          st_swizzled(dst, NQ, rr + 8 * (mm & 1),
                      16 * c + 8 * (mm >> 1) + cc, da[c][mm]);
      fence_async_smem();
      __syncthreads();   // dS^T is whole
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NQ / 16; ++c)
        wgmma_rs<T, 1>(dva, pa[c], desc_mnmajor<D, NQ>(dos, c), 1);
#pragma unroll
      for (int c = 0; c < NQ / 16; ++c)
        wgmma_rs<T, 1>(dka, da[c], desc_mnmajor<D, NQ>(qs, c), 1);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int c = 0; c < kTile / 16; ++c)
          wgmma_ss<T, 1, 1>(dqt[mb],
                            desc_mnmajor<64, kTile>(ks + mb * kTile * 128, c),
                            desc_mnmajor<NQ, kTile>(dst, c), c > 0);
      wgmma_commit();
      // chained: kv tiles 0 .. kt - 1 have added their shares of this tile
      if (!clustered && threadIdx.x == 0) wait_flag(&qflag[qt], kt);
      __syncwarp();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(dqt[mb]);
#pragma unroll
      for (int c = 0; c < NQ / 16; ++c) {
        fence_regs(pa[c]);
        fence_regs(da[c]);
      }
      __syncthreads();   // stage st and dst are free
      if (threadIdx.x == 0 && it + 2 < n_q && !clustered) load_q(it + 2, st);
    }
    // dqt[mb][4 n + 2 h + e]: dim 64 mb + rr + 8 h, query q0 + 8 n + cc + e
    if (clustered) {
      // the share goes over this tile's Q and dO in its ring stage
      float* mine = reinterpret_cast<float*>(ring + (it & 1) * kStage);
      if (it >= 0) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mine[part_off<D>(8 * n + cc + e, 64 * mb + rr + 8 * h)] =
                    dqt[mb][4 * n + 2 * h + e];
      }
      cluster_sync();   // every share of this q tile is written
      if (threadIdx.x == 0 && it >= 1 && it + 1 < n_q) {
        // the stage of q tile it - 1 held its share, which the cluster
        // has read: it takes q tile it + 1
        fence_async_smem();
        load_q(it + 1, (it + 1) & 1);
      }
      // this CTA sums the tile's chunks kt, kt + n_kv, ... of 128 groups
      // of 4 floats (4 dims of one query, contiguous in every share)
      for (int g = kt * kTcThreads + threadIdx.x; g < NQ * D / 4;
           g += n_kv * kTcThreads) {
        const int i = 4 * g / D, j = 4 * g % D;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c <= last; ++c) {
          // CTA c's share, over its stage of q tile qt
          const int qb = a.causal ? c * kTile / NQ : 0;
          const float4 x = ld_cluster_f32x4(
              reinterpret_cast<const float*>(ring + ((qt - qb) & 1) * kStage) +
                  part_off<D>(i, j),
              c);
          if (c == 0) {
            sum = x;
          } else {
            sum.x += x.x;
            sum.y += x.y;
            sum.z += x.z;
            sum.w += x.w;
          }
        }
        if (q0 + i < a.sq && j < a.d)
          *reinterpret_cast<uint2*>(dqh + (size_t)(q0 + i) * a.d + j) =
              make_uint2(pack2<T>(sum.x, sum.y), pack2<T>(sum.z, sum.w));
      }
    } else {
      // kv tile 0 stores its share, the middle ones add theirs in L2 (red,
      // which waits for nothing), the last reads the sum, adds and rounds
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = q0 + 8 * n + cc + e, j = 64 * mb + rr + 8 * h;
              if (i >= a.sq || j >= a.d) continue;
              const size_t o = (size_t)i * a.d + j;
              const float x = dqt[mb][4 * n + 2 * h + e];
              if (kt == last)
                Elem<T>::store(dqh + o, kt == 0 ? x : __ldcg(acc + o) + x);
              else if (kt == 0)
                __stcg(acc + o, x);
              else
                atomicAdd(acc + o, x);
            }
      __syncthreads();   // every share is issued: the publish covers them
    }
  }
  if (!clustered && threadIdx.x == 0 && n_q > 0)
    publish(&qflag[n_qt - 1], kt + 1);
  if (clustered) cluster_sync();   // the last shares are read

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = jr[h];
    if (j >= a.sk) continue;
    const size_t o = ((size_t)bh * a.sk + j) * a.d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n + cc < a.d) {
        const int x = 4 * n + 2 * h;
        *reinterpret_cast<uint32_t*>(dk + o + 8 * n + cc) =
            pack2<T>(dka[x], dka[x + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + 8 * n + cc) =
            pack2<T>(dva[x], dva[x + 1]);
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

// Above 48 KB a kernel's dynamic shared memory must be allowed once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Attn make_attn(int h, int sq, int sk, int d, float scale, int causal,
               const float* bias, const long long* seed, unsigned int thresh,
               float keep_scale, unsigned int offset) {
  Attn a;
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.scale = scale;
  a.causal = causal;
  a.bias = bias;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.offset = offset;
  return a;
}

// the f32 forward's shared memory: Q of each group, two stages of K and
// V, and each group's P^T and its row of alpha / 1 / l
template <int D>
constexpr size_t fwd_f32_smem() {
  using C = SplitF32<D>;
  constexpr int H = 256 / C::kNT;
  return sizeof(float) * ((H + 4) * C::kTileF + H * C::kScoreF + H * kTile);
}

template <int D, bool DROP>
cudaError_t launch_fwd_f32(const float* q, const float* k, const float* v,
                           float* out, float* lse, int b, const Attn& a,
                           cudaStream_t stream) {
  const int rows = (256 / SplitF32<D>::kNT) * kTile;
  const size_t smem = fwd_f32_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D, DROP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + rows - 1) / rows, b * a.h);
  flash_fwd_f32_kernel<D, DROP><<<grid, 256, smem, stream>>>(q, k, v, out,
                                                             lse, a);
  return cudaGetLastError();
}

// the f32 fused backward's shared memory: K, V, P, dS and the bias row of
// each group, the stages of Q, dO, lse and delta
template <int D>
constexpr size_t fused_f32_smem() {
  using C = SplitF32<D>;
  constexpr int H = FusedF32<D>::kH;
  return sizeof(float) *
         (4 * H * C::kTileF + 2 * H * C::kScoreF + 3 * H * kTile);
}

// the (b, h, sq, d) slices of the f32 fused backward's dQ scratch: one a
// kv-tile CTA of a (b, h), as many as kFusedF32ScratchBytes holds but at
// least kFusedF32MinParts; none with one CTA, which stores dQ itself
template <int D>
int fused_f32_parts(int b, const Attn& a) {
  const int n_cta = (a.sk + FusedF32<D>::kKeys - 1) / FusedF32<D>::kKeys;
  const size_t slice = sizeof(float) * b * a.h * a.sq * a.d;
  const size_t fit = kFusedF32ScratchBytes / (slice > 0 ? slice : 1);
  const int parts = fit < (size_t)kFusedF32MinParts ? kFusedF32MinParts
                    : fit < (size_t)n_cta            ? (int)fit
                                                     : n_cta;
  return n_cta == 1 ? 0 : parts < n_cta ? parts : n_cta;
}

// parts: a float32 scratch of fused_f32_parts<D>(b, a) b h sq d floats
// (null when that is 0).  The kv-tile CTAs run as many ranks a launch,
// each launch followed by the sum of its shares onto dQ.
template <int D, bool DROP>
cudaError_t launch_fused_f32(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, float* parts, float* dq,
                             float* dk, float* dv, int b, const Attn& a,
                             cudaStream_t stream) {
  const int bh = b * a.h;
  const int n_cta = (a.sk + FusedF32<D>::kKeys - 1) / FusedF32<D>::kKeys;
  const int n_parts = fused_f32_parts<D>(b, a);
  const bool direct = n_parts == 0;
  if (!direct && parts == nullptr) return cudaErrorInvalidValue;
  const size_t smem = fused_f32_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_fused_f32_kernel<D, DROP>, smem);
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)bh * a.sq * a.d / 4;
  const int step = direct ? 1 : n_parts;
  for (int r0 = 0; r0 < n_cta; r0 += step) {
    const int n_part = n_cta - r0 < step ? n_cta - r0 : step;
    flash_bwd_fused_f32_kernel<D, DROP>
        <<<(unsigned)(n_part * bh), 256, smem, stream>>>(
            q, k, v, dout, lse, delta, direct ? dq : parts, dk, dv, r0,
            n_part, a);
    err = cudaGetLastError();
    if (err != cudaSuccess || direct) return err;
    flash_dq_parts_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0,
                                stream>>>(parts, dq, r0, n_part,
                                          FusedF32<D>::kH, n4, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// the f32 split pair's shared memory: Q, dO, a 2-stage ring of K, V,
// dS^T, lse and delta (dQ); K, V, Q, dO, P, dS, lse and delta (dK/dV)
template <int D>
constexpr size_t dq_f32_smem() {
  using C = SplitF32<D>;
  return sizeof(float) * (5 * C::kTileF + C::kScoreF + 2 * kTile);
}
template <int D>
constexpr size_t dkv_f32_smem() {
  using C = SplitF32<D>;
  return sizeof(float) * (4 * C::kTileF + 2 * C::kScoreF + 2 * kTile);
}
// ... and over the 2-stage rings, two groups a CTA: Q, dO, lse, delta and
// dS^T of each group and two stages of K and V (dQ); K, V, P, dS and the
// bias row of each group and two stages of Q, dO, lse and delta (dK/dV)
template <int D>
constexpr size_t dq_ring_f32_smem() {
  using C = SplitF32<D>;
  return sizeof(float) * (8 * C::kTileF + 2 * C::kScoreF + 4 * kTile);
}
template <int D>
constexpr size_t dkv_ring_f32_smem() {
  using C = SplitF32<D>;
  return sizeof(float) * (8 * C::kTileF + 4 * C::kScoreF + 6 * kTile);
}

template <int D, bool DROP>
cudaError_t launch_dq_f32(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* delta, float* dq, int b, const Attn& a,
                          cudaStream_t stream) {
  const int rows = D == 128 ? kTile : 2 * kTile;
  const size_t smem = D == 128 ? dq_f32_smem<D>() : dq_ring_f32_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D, DROP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + rows - 1) / rows, b * a.h);
  flash_bwd_dq_f32_kernel<D, DROP><<<grid, 256, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, a);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv_f32(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* delta, float* dk, float* dv, int b,
                           const Attn& a, cudaStream_t stream) {
  const int rows = D == 128 ? kTile : 2 * kTile;
  const size_t smem = D == 128 ? dkv_f32_smem<D>() : dkv_ring_f32_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel<D, DROP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sk + rows - 1) / rows, b * a.h);
  flash_bwd_dkv_f32_kernel<D, DROP><<<grid, 256, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, a);
  return cudaGetLastError();
}

// ... and for the tensor-core kernels the largest shared-memory carveout,
// so that three or four CTAs (one warpgroup each) share an SM
template <typename K>
cudaError_t allow_smem_carveout(K kernel, size_t bytes) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return hopper::kIsBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// the 3-D map of a (b h, s, d) tensor of T, boxes of one atom x `rows`
template <int D, typename T>
cudaError_t head_map(CUtensorMap* map, const T* base, int s, int bh, int d,
                     int rows) {
  using G = hopper::TileCols<D>;
  return hopper::encode_3d(map, base, tma_type<T>(), d, s, bh, G::kAtomCols,
                           rows, G::kTmaSwizzle);
}

template <int D>
constexpr size_t dq_tc_smem() {
  return 6 * kTile * D * 2 + 3 * sizeof(uint64_t) + 1024;
}
template <int D>
constexpr size_t dkv_tc_smem() {
  return 2 * kTile * D * 2 + 2 * kDkvStageBytes<D> +
         kDkvXchg<kDkvQRows<D>> + 3 * sizeof(uint64_t) + 1024;
}

template <int D, typename T>
cudaError_t launch_dq_tc(const T* q, const T* k, const T* v, const T* dout,
                         const float* lse, const float* delta, T* dq, int b,
                         const Attn& a, cudaStream_t stream) {
  const int bh = b * a.h;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = head_map<D>(&tq, q, a.sq, bh, a.d, kTile)) != cudaSuccess ||
      (err = head_map<D>(&tk, k, a.sk, bh, a.d, kTile)) != cudaSuccess ||
      (err = head_map<D>(&tv, v, a.sk, bh, a.d, kTile)) != cudaSuccess ||
      (err = head_map<D>(&tdo, dout, a.sq, bh, a.d, kTile)) != cudaSuccess)
    return err;
  const size_t smem = dq_tc_smem<D>();
  err = allow_smem_carveout(flash_bwd_dq_tc_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kTile - 1) / kTile, bh);
  flash_bwd_dq_tc_kernel<D, T><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, dq, a);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv_tc(const T* q, const T* k, const T* v, const T* dout,
                          const float* lse, const float* delta, T* dk, T* dv,
                          int b, const Attn& a, cudaStream_t stream) {
  constexpr int NQ = kDkvQRows<D>;
  const int bh = b * a.h;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  cudaError_t err;
  if ((err = head_map<D>(&tq, q, a.sq, bh, a.d, NQ)) != cudaSuccess ||
      (err = head_map<D>(&tk, k, a.sk, bh, a.d, 8)) != cudaSuccess ||
      (err = head_map<D>(&tv, v, a.sk, bh, a.d, 8)) != cudaSuccess ||
      (err = head_map<D>(&tdo, dout, a.sq, bh, a.d, NQ)) != cudaSuccess ||
      (err = hopper::encode_1d_f32(&tlse, lse, (uint64_t)bh * a.sq,
                                   kDkvVecBox<D>)) != cudaSuccess ||
      (err = hopper::encode_1d_f32(&tdelta, delta, (uint64_t)bh * a.sq,
                                   kDkvVecBox<D>)) != cudaSuccess)
    return err;
  const size_t smem = dkv_tc_smem<D>();
  err = allow_smem_carveout(flash_bwd_dkv_tc_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sk + kTile - 1) / kTile, bh);
  flash_bwd_dkv_tc_kernel<D, T><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, dk, dv, a);
  return cudaGetLastError();
}

template <int D>
constexpr size_t fwd_tc_smem() {
  return 5 * kTile * D * 2 + 3 * sizeof(uint64_t) + 1024;
}
template <int D>   // the dK/dV kernel's, and a slot for the CTA's number
constexpr size_t fused_tc_smem() {
  return dkv_tc_smem<D>() + sizeof(uint64_t);
}

template <int D, typename T>
cudaError_t launch_fwd_tc(const T* q, const T* k, const T* v, T* out,
                          float* lse, int b, const Attn& a,
                          cudaStream_t stream) {
  const int bh = b * a.h;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = head_map<D>(&tq, q, a.sq, bh, a.d, kTile)) != cudaSuccess ||
      (err = head_map<D>(&tk, k, a.sk, bh, a.d, kTile)) != cudaSuccess ||
      (err = head_map<D>(&tv, v, a.sk, bh, a.d, kTile)) != cudaSuccess)
    return err;
  const size_t smem = fwd_tc_smem<D>();
  err = allow_smem_carveout(flash_fwd_tc_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kTile - 1) / kTile, bh);
  flash_fwd_tc_kernel<D, T><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv,
                                                                out, lse, a);
  return cudaGetLastError();
}

// dq_acc: the float32 (b h, sq, d) sums, then the order flags (zeroed
// by the caller): the CTA counter and one flag per (b h, q tile)
template <int D, typename T>
cudaError_t launch_fused_tc(const T* q, const T* k, const T* v,
                            const T* dout, const float* lse,
                            const float* delta, float* dq_acc, T* dq, T* dk,
                            T* dv, int b, const Attn& a, cudaStream_t stream) {
  constexpr int NQ = kDkvQRows<D>;
  const int bh = b * a.h;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  cudaError_t err;
  if ((err = head_map<D>(&tq, q, a.sq, bh, a.d, NQ)) != cudaSuccess ||
      (err = head_map<D>(&tk, k, a.sk, bh, a.d, 8)) != cudaSuccess ||
      (err = head_map<D>(&tv, v, a.sk, bh, a.d, 8)) != cudaSuccess ||
      (err = head_map<D>(&tdo, dout, a.sq, bh, a.d, NQ)) != cudaSuccess ||
      (err = hopper::encode_1d_f32(&tlse, lse, (uint64_t)bh * a.sq,
                                   kDkvVecBox<D>)) != cudaSuccess ||
      (err = hopper::encode_1d_f32(&tdelta, delta, (uint64_t)bh * a.sq,
                                   kDkvVecBox<D>)) != cudaSuccess)
    return err;
  const size_t smem = fused_tc_smem<D>();
  err = allow_smem_carveout(flash_bwd_fused_tc_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  int* flags = reinterpret_cast<int*>(dq_acc + (size_t)bh * a.sq * a.d);
  const int n_kv = (a.sk + kTile - 1) / kTile;
  if (n_kv < 2 || n_kv > kFusedMaxCluster || bh > 65535) {   // chained
    flash_bwd_fused_tc_kernel<D, T><<<n_kv * bh, kTcThreads, smem, stream>>>(
        tq, tk, tv, tdo, tlse, tdelta, dq_acc, flags, dq, dk, dv, a);
    return cudaGetLastError();
  }
  // clustered: the kv-tile CTAs of a (b, h) form one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_kv, bh);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_kv;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_fused_tc_kernel<D, T>, tq, tk, tv,
                           tdo, tlse, tdelta, dq_acc, flags, dq, dk, dv, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// CTAs of the fused kernel resident on one SM (its launch's attributes
// set first), for a report
template <int D, typename T>
cudaError_t fused_tc_occupancy(int* blocks) {
  const size_t smem = fused_tc_smem<D>();
  const cudaError_t err =
      allow_smem_carveout(flash_bwd_fused_tc_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_bwd_fused_tc_kernel<D, T>, kTcThreads, smem);
}

// The tile width a head dim runs at: the smallest of 32, 64, 128 that
// holds it (0: not taken).  Any d % 8 == 0 up to 128 is taken, as by the
// TPU kernels (pallas_kernels.py:702); above 128 the f32 fused kernel's
// tiles do not fit a CTA (fused_f32_smem<256>() = 367,360 B > 227 KB).
int tile_width(int d) {
  if (d <= 0 || d % 8 != 0 || d > 128) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// the f32 kernels' instance: tile width x dropout
#define SPLIT_F32_CASES(LAUNCH, ...)                                      \
  switch (tile_width(a.d) * 2 + (a.seed != nullptr)) {                    \
    case 64: return LAUNCH<32, false>(__VA_ARGS__);                       \
    case 65: return LAUNCH<32, true>(__VA_ARGS__);                        \
    case 128: return LAUNCH<64, false>(__VA_ARGS__);                      \
    case 129: return LAUNCH<64, true>(__VA_ARGS__);                       \
    case 256: return LAUNCH<128, false>(__VA_ARGS__);                     \
    case 257: return LAUNCH<128, true>(__VA_ARGS__);                      \
    default: return cudaErrorInvalidValue;                                \
  }

int dq_f32_entry(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 float* dq, int b, const Attn& a, cudaStream_t stream) {
  SPLIT_F32_CASES(launch_dq_f32, q, k, v, dout, lse, delta, dq, b, a, stream)
}

int dkv_f32_entry(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dk, float* dv, int b, const Attn& a,
                  cudaStream_t stream) {
  SPLIT_F32_CASES(launch_dkv_f32, q, k, v, dout, lse, delta, dk, dv, b, a,
                  stream)
}
int fwd_f32_entry(const float* q, const float* k, const float* v,
                  float* out, float* lse, int b, const Attn& a,
                  cudaStream_t stream) {
  SPLIT_F32_CASES(launch_fwd_f32, q, k, v, out, lse, b, a, stream)
}

int fused_f32_entry(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    float* parts, float* dq, float* dk, float* dv, int b,
                    const Attn& a, cudaStream_t stream) {
  SPLIT_F32_CASES(launch_fused_f32, q, k, v, dout, lse, delta, parts, dq, dk,
                  dv, b, a, stream)
}
#undef SPLIT_F32_CASES

// the bf16 / fp16 kernels, on the tensor cores
template <typename T>
int fwd_tc_entry(const T* q, const T* k, const T* v, T* out, float* lse,
                 int b, const Attn& a, cudaStream_t stream) {
  switch (tile_width(a.d)) {
    case 32: return launch_fwd_tc<32>(q, k, v, out, lse, b, a, stream);
    case 64: return launch_fwd_tc<64>(q, k, v, out, lse, b, a, stream);
    case 128: return launch_fwd_tc<128>(q, k, v, out, lse, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the fused kernel's tile width: 64 for head dims up to 64
int fused_width(int d) {
  const int w = tile_width(d);
  return w == 32 ? 64 : w;
}

template <typename T>
int fused_tc_entry(const T* q, const T* k, const T* v, const T* dout,
                   const float* lse, const float* delta, float* dq_acc,
                   T* dq, T* dk, T* dv, int b, const Attn& a,
                   cudaStream_t stream) {
  switch (fused_width(a.d)) {
    case 64:
      return launch_fused_tc<64>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                 dv, b, a, stream);
    case 128:
      return launch_fused_tc<128>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                  dv, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dq_tc_entry(const T* q, const T* k, const T* v, const T* dout,
                const float* lse, const float* delta, T* dq, int b,
                const Attn& a, cudaStream_t stream) {
  switch (tile_width(a.d)) {
    case 32:
      return launch_dq_tc<32>(q, k, v, dout, lse, delta, dq, b, a, stream);
    case 64:
      return launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, b, a, stream);
    case 128:
      return launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_tc_entry(const T* q, const T* k, const T* v, const T* dout,
                 const float* lse, const float* delta, T* dk, T* dv, int b,
                 const Attn& a, cudaStream_t stream) {
  switch (tile_width(a.d)) {
    case 32:
      return launch_dkv_tc<32>(q, k, v, dout, lse, delta, dk, dv, b, a,
                               stream);
    case 64:
      return launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, b, a,
                               stream);
    case 128:
      return launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, b, a,
                                stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points: every pointer is a device pointer (bias and seed may be
// null), launches go on `stream`, and each returns the cudaError_t of the
// launch.  d must be a multiple of 8 up to 128 (else
// cudaErrorInvalidValue).  The _bf16 and _fp16 functions take q, k, v,
// dout and the outputs in bf16 or fp16; bias, lse and delta are float32 in
// all three.
#define ATTN_ARGS                                                        \
  int h, int sq, int sk, int d, float scale, int causal,                 \
      const long long *seed, unsigned int thresh, float keep_scale,      \
      unsigned int offset, cudaStream_t stream
#define MAKE_ATTN \
  make_attn(h, sq, sk, d, scale, causal, bias, seed, thresh, keep_scale, \
            offset)

typedef __nv_bfloat16 bf16;
typedef __half fp16;

extern "C" {

int paddle_flash_fwd_f32(const float* q, const float* k, const float* v,
                         const float* bias, float* out, float* lse, int b,
                         ATTN_ARGS) {
  return fwd_f32_entry(q, k, v, out, lse, b, MAKE_ATTN, stream);
}

int paddle_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                          const float* bias, bf16* out, float* lse, int b,
                          ATTN_ARGS) {
  return fwd_tc_entry(q, k, v, out, lse, b, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                            const float* bias, const float* dout,
                            const float* lse, const float* delta, float* dq,
                            int b, ATTN_ARGS) {
  return dq_f32_entry(q, k, v, dout, lse, delta, dq, b, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                             const float* bias, const bf16* dout,
                             const float* lse, const float* delta, bf16* dq,
                             int b, ATTN_ARGS) {
  return dq_tc_entry(q, k, v, dout, lse, delta, dq, b, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                             const float* bias, const float* dout,
                             const float* lse, const float* delta, float* dk,
                             float* dv, int b, ATTN_ARGS) {
  return dkv_f32_entry(q, k, v, dout, lse, delta, dk, dv, b, MAKE_ATTN,
                       stream);
}

int paddle_flash_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const float* bias, const bf16* dout,
                              const float* lse, const float* delta, bf16* dk,
                              bf16* dv, int b, ATTN_ARGS) {
  return dkv_tc_entry(q, k, v, dout, lse, delta, dk, dv, b, MAKE_ATTN,
                      stream);
}

// parts: a float32 scratch of n b h sq d floats, n from
// paddle_flash_fused_f32_parts (null when n is 0)
int paddle_flash_bwd_fused_f32(const float* q, const float* k, const float* v,
                               const float* bias, const float* dout,
                               const float* lse, const float* delta,
                               float* parts, float* dq, float* dk, float* dv,
                               int b, ATTN_ARGS) {
  return fused_f32_entry(q, k, v, dout, lse, delta, parts, dq, dk, dv, b,
                         MAKE_ATTN, stream);
}

// dq_acc: a float32 scratch of b h sq d floats (dQ's sums), then
// b h ceil(sq / 32) + 1 words that the caller zeroes (the kernel's order
// flags); q, k, v, dout, lse and delta 16-byte aligned (TMA)
int paddle_flash_bwd_fused_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const float* bias, const bf16* dout,
                                const float* lse, const float* delta,
                                float* dq_acc, bf16* dq, bf16* dk, bf16* dv,
                                int b, ATTN_ARGS) {
  return fused_tc_entry(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, b,
                        MAKE_ATTN, stream);
}

int paddle_flash_fwd_fp16(const fp16* q, const fp16* k, const fp16* v,
                          const float* bias, fp16* out, float* lse, int b,
                          ATTN_ARGS) {
  return fwd_tc_entry(q, k, v, out, lse, b, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dq_fp16(const fp16* q, const fp16* k, const fp16* v,
                             const float* bias, const fp16* dout,
                             const float* lse, const float* delta, fp16* dq,
                             int b, ATTN_ARGS) {
  return dq_tc_entry(q, k, v, dout, lse, delta, dq, b, MAKE_ATTN, stream);
}

int paddle_flash_bwd_dkv_fp16(const fp16* q, const fp16* k, const fp16* v,
                              const float* bias, const fp16* dout,
                              const float* lse, const float* delta, fp16* dk,
                              fp16* dv, int b, ATTN_ARGS) {
  return dkv_tc_entry(q, k, v, dout, lse, delta, dk, dv, b, MAKE_ATTN,
                      stream);
}

// dq_acc: as the bf16 fused backward's
int paddle_flash_bwd_fused_fp16(const fp16* q, const fp16* k, const fp16* v,
                                const float* bias, const fp16* dout,
                                const float* lse, const float* delta,
                                float* dq_acc, fp16* dq, fp16* dk, fp16* dv,
                                int b, ATTN_ARGS) {
  return fused_tc_entry(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, b,
                        MAKE_ATTN, stream);
}

// *blocks: the bf16 (is_fp16 = 0) or fp16 fused kernel's CTAs resident
// on one SM at head dim d
int paddle_flash_fused_occupancy(int d, int is_fp16, int* blocks) {
  switch (fused_width(d) * 2 + (is_fp16 != 0)) {
    case 128: return fused_tc_occupancy<64, bf16>(blocks);
    case 129: return fused_tc_occupancy<64, fp16>(blocks);
    case 256: return fused_tc_occupancy<128, bf16>(blocks);
    case 257: return fused_tc_occupancy<128, fp16>(blocks);
    default: return cudaErrorInvalidValue;
  }
}

// *parts: the (b, h, sq, d) float32 slices that the f32 fused backward's
// scratch must hold (0: it takes none)
int paddle_flash_fused_f32_parts(int b, int h, int sq, int sk, int d,
                                 int* parts) {
  Attn a = {};
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  if (b < 1 || h < 1 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  switch (tile_width(d)) {
    case 32: *parts = fused_f32_parts<32>(b, a); return cudaSuccess;
    case 64: *parts = fused_f32_parts<64>(b, a); return cudaSuccess;
    case 128: *parts = fused_f32_parts<128>(b, a); return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

int paddle_flash_dropout_mask(unsigned char* keep, int b, int h, int sq,
                              int sk, const long long* seed,
                              unsigned int thresh, unsigned int offset,
                              cudaStream_t stream) {
  const Attn a = make_attn(h, sq, sk, 0, 1.f, 0, nullptr, seed, thresh, 1.f,
                           offset);
  dim3 grid((sk + kTile - 1) / kTile, (sq + 15) / 16, b * h);
  flash_dropout_mask_kernel<<<grid, kThreads, 0, stream>>>(keep, a);
  return cudaGetLastError();
}

}  // extern "C"
