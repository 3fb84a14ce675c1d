// Flash attention forward (K1) and backward (K2) for Hopper (sm_90a), on
// the tensor cores at f32 accuracy.
//
// Replaces the TPU kernels of bluefog_tpu/ops/pallas_attention.py:
//
//   flash_fwd       <- attention_block_partial  (kernel _partial_kernel)
//   flash_bwd_dkdv  \  attention_block_backward (kernel _backward_kernel)
//   flash_bwd_dq    /
//
// Shapes: q [B, Tq, H, D], k/v [B, Tk, Hkv, D] (f32 or bf16), grouped
// query attention by index: q head h reads kv head h / (H / Hkv).  Masks
// come from the global offsets: with `causal`, key position koff + j is
// visible to query position qoff + i iff koff + j <= qoff + i and, with a
// window w > 0, qoff + i - (koff + j) < w.  Any Tq, Tk; D is 64, 128 or
// 256.
//
// What the kernels compute (unchanged from the SIMT kernels they replace):
//   flash_fwd: one CTA per (b, h, tile of q rows) streams K/V tiles
//     (64 keys; 32 at D = 256) with an f32 online softmax, so the running
//     max ends as the row max over all of Tk and (o, l, m) are relative
//     to it, as the TPU partial's are.  Rows with no visible key write
//     m = -inf, l = 0, o = 0.  With f32 inputs q is scaled before the dot, as
//     _partial_kernel does; with bf16 inputs the exact dot is scaled
//     (q * scale would leave TF32; the two differ by one f32 rounding).
//   flash_bwd_dkdv / flash_bwd_dq: the FlashAttention-2 backward given the
//     global lse and delta = rowsum(do * out): p = exp(s * scale - lse)
//     (0 where masked or lse = -inf), ds = p * (do v^T - delta),
//     dv = p^T do, dk = scale * ds^T q (summed over the GQA group),
//     dq = scale * ds k.
//
// What bounds them on this card: at the trainer's shape (q/k/v [4, 2048,
// 16, 64] f32, causal) the forward needs 4 * B * H * T (T + 1) / 2 * D =
// 3.4e10 FLOP against 0.04 ms of bytes, so products bound it; the
// backward's five products are 2.5 times that.  The tolerances the port
// holds (m to 1e-5, o/l and gradients to 1e-4, the trainer's step-1 loss
// to rtol 1e-5, with torch's TF32 switched off as the JAX reference
// trains) rule out a single TF32 pass (10-bit mantissa, ~5e-4 relative).
// So every product is 3xTF32, as CUTLASS's OpMultiplyAddFastF32: each f32
// operand x splits into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x -
// big), and mma.sync.m16n8k8.tf32 accumulates small*big + big*small before
// big*big in f32 (495 / 3 = 165 TFLOP/s of f32-accurate products, against
// 67 TFLOP/s on the CUDA cores).  A bf16 value is exact in TF32 (small =
// 0), so its small terms are dropped at compile time: q.k^T at bf16
// inputs takes one MMA, p.v two; every product touching dO, P or dS
// (f32) keeps its small term.  The tensor cores add into their
// accumulator by truncation, which drifts one way by about an ulp of |c|
// per MMA; so each tile's products go to a zeroed fragment that is added
// to the running f32 sums (o, dq, dk, dv) with round-to-nearest once per
// tile, and K1's scores, whose max m is held to 1e-5, add each k-step so.
//
// Layout.  A CTA is W warps; each warp owns 16 rows (q rows in flash_fwd
// and flash_bwd_dq, keys in flash_bwd_dkdv), FA-2 style, so the products
// and the softmax stay in the warp's registers; the streamed tiles are 64
// rows.  m16n8k8 fragments, with lane = 4 g + t:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4);
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//     c3 (g + 8, 2t + 1).
// An accumulator (P, dS) feeds the next product as its A operand without
// any move: the k index of a product may be permuted as long as A and B
// agree, so A slot t stands for column 2t and slot t + 4 for 2t + 1
// (a = {c0, c2, c1, c3}), and B is read at rows k0 + 2t and k0 + 2t + 1.
// The row-wise max and sum of the online softmax are quad shuffles.
// Every shared tile is row major with a row stride of 4 (mod 32) 32-bit
// words (D + 4 floats, D + 8 bf16): B read as (k = d, n = row) touches
// word 4 g + t, B read as (k = row, n = d) through the permutation touches
// word 8 t + g, A touches 4 g + t: no bank conflicts, and every row stays
// 16-byte aligned for cp.async.
//
// Staging.  The tiles a CTA streams (K/V in flash_fwd and flash_bwd_dq;
// Q, dO, lse and delta in flash_bwd_dkdv) go through two stages filled by
// cp.async (16-byte cg copies, zero-filled past the ragged edge; 4-byte
// copies for the strided lse/delta), so tile i + 1 loads while tile i
// computes (one stage in the backward at D = 128, below).  At D = 64 each
// streamed f32 tile is split once after it lands, by the whole CTA: the
// big parts over the values, the small ones into a tile beside them, so
// the 8 warps that read it load both parts instead of each splitting
// every value again (three ALU operations a value).  bf16 tiles stay
// bf16 in shared memory and widen at the fragment load.  Only tiles the
// mask cuts (the diagonal, a window edge, a ragged edge) test each
// element; wholly masked tiles are skipped.  Q tiles with the most
// visible keys (the last ones when causal) launch first, and key tiles
// with the most visible queries (the first ones), so causal work leaves
// no tail wave.
//
// Why no atomics: the TPU accumulates dk/dv over a sequential grid axis;
// a GPU grid runs in no order, so the backward is split: flash_bwd_dkdv
// (one CTA per (b, kv head, 16 W keys), looping over the GQA group's heads
// and the visible q tiles) and flash_bwd_dq (one CTA per (b, h, 16 W q
// rows)).  Both recompute s and do.v^T (7 products instead of 5), and two
// runs on the same inputs give bit-identical results.
//
// CTA shapes (Shape<T, D>).  W = 8 warps (128 rows): one CTA fills an
// SM's shared memory (about 175 KB at D = 64 with the split tiles, 203 KB
// at D = 128 without them) and 8 warps share each staged tile.  At D =
// 128 the backward's streamed tiles are single-staged to fit.  The bf16
// forward at D = 64 has nothing to split and keeps 4 warps (two CTAs an
// SM).  The dK and dV accumulators of 16 keys x 128 would take 128
// registers a thread beside s and dP, so dkdv runs two sweeps at D = 128,
// dV first and then dK (s recomputed: 960 products per tile pair instead
// of 768); at D = 64 one sweep does both.  At D = 64 flash_fwd splits each
// warp's f32 q rows once (big in place, small beside); the other A
// operands are read from shared memory and split per k-step (one fragment
// serves 8 MMAs).
//
// D = 256 (Shape<T, 256>) cannot carry the D = 128 shape up: 8 warps of
// q rows and two stages of 64-row K/V tiles at 1 KB a row would need
// about 400 KB of shared memory, and a warp's 16 x 256 f32 output
// accumulator (beside the tile's zeroed product fragment) 256 registers
// a thread.  So at D = 256 a CTA is 4 warps (64 rows) that stream 32-row
// tiles, single-staged in the backward (about 195 KB in f32), and it
// accumulates only DO = 128 of the output columns: the grid runs two
// CTAs per row tile, one per column half, each recomputing the tile's
// scores (and dP in the backward) over all 256 columns and writing its
// half of o (dq, dk, dv).  The two halves of a forward row tile compute
// the same m and l; the first writes them.  That costs a third more
// products in the forward (q.k^T twice) and more in the backward, for
// the register budget of D = 128.
//
// Every kernel is declared __launch_bounds__(threads, 1): without the
// minimum ptxas capped an f32 forward of 4 warps at 168 registers (three
// CTAs an SM, which shared memory never allows) and spilled.
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

// CTA shape: W warps of 16 rows (FWD_W in flash_fwd), the number of
// stages of the backward's streamed tiles (the forward always has 2), the
// rows of a streamed tile (KT) and the output columns one CTA accumulates
// (DO: the grid runs D / DO CTAs per row tile); see the header
template <typename T, int D> struct Shape {
  static constexpr int W = D == 256 ? 4 : 8;
  static constexpr int FWD_W = D == 256 || (sizeof(T) == 2 && D == 64)
                                   ? 4 : 8;
  static constexpr int BWD_NS = D == 64 ? 2 : 1;
  static constexpr int KT = D == 256 ? 32 : 64;
  static constexpr int DO = D == 256 ? 128 : D;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// row stride (elements) of a shared tile of D columns of T: 4 (mod 32)
// words, rows 16-byte aligned
template <typename T, int D>
__host__ __device__ constexpr int stride_of() {
  return D + 16 / (int)sizeof(T);
}

struct Mask {
  int causal, window, qoff, koff;

  // local indices: query i of this call against key j of this call
  __device__ __forceinline__ bool keep(int i, int j) const {
    if (!causal) return true;
    const int d = (qoff + i) - (koff + j);
    return d >= 0 && (window <= 0 || d < window);
  }

  // true iff some pair of the tile [q0, q0 + nq) x [k0, k0 + nk) is kept:
  // the tile's position differences span [qfirst - klast, qlast - kfirst]
  __device__ __forceinline__ bool visible(int q0, int nq, int k0,
                                          int nk) const {
    if (!causal) return true;
    const int hi = (qoff + q0 + nq - 1) - (koff + k0);
    const int lo = (qoff + q0) - (koff + k0 + nk - 1);
    return hi >= 0 && (window <= 0 || lo < window);
  }

  // true iff every pair of the full tile [q0, q0 + nq) x [k0, k0 + nk)
  // is kept
  __device__ __forceinline__ bool all_kept(int q0, int nq, int k0,
                                           int nk) const {
    if (!causal) return true;
    const int lo = (qoff + q0) - (koff + k0 + nk - 1);
    const int hi = (qoff + q0 + nq - 1) - (koff + k0);
    return lo >= 0 && (window <= 0 || hi < window);
  }
};

// -- cp.async ------------------------------------------------------------

// rows [0, nvalid) of a [ROWS, D] slice with the given row stride
// (elements) into a shared tile of stride_of<T, D>(), by NT threads; rows
// past nvalid are zero
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           size_t stride, int nvalid) {
  constexpr int E = 16 / (int)sizeof(T);     // elements per 16-byte chunk
  constexpr int CH = D / E, SD = stride_of<T, D>();
  for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
    const int r = c / CH, e = (c % CH) * E;
    const bool ok = r < nvalid;
    cp16(dst + r * SD + e, src + (size_t)(ok ? r : 0) * stride + e, ok);
  }
}

// KT values with the given stride into dst; rows past nvalid read 0
template <int KT, int NT>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          size_t stride, int nvalid) {
  for (int i = threadIdx.x; i < KT; i += NT)
    cp4(dst + i, src + (size_t)(i < nvalid ? i : 0) * stride, i < nvalid);
}

// -- 3xTF32 fragments and products ---------------------------------------

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// c += d, element by element (round-to-nearest)
template <int N>
__device__ __forceinline__ void add(float (&c)[N][4], const float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += d[n][e];
}

// A = X[r0 .. r0 + 16) x [c0 .. c0 + 8) of a row-major shared tile, times mul
template <typename T, int SD, bool EXACT>
__device__ __forceinline__ FragA load_a(const T* X, int r0, int c0,
                                        float mul = 1.f) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = X + (r0 + g) * SD + c0 + t;
  const float v[4] = {widen(p[0]), widen(p[8 * SD]), widen(p[4]),
                      widen(p[8 * SD + 4])};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split<EXACT>(v[i] * mul, f.b[i], f.s[i]);
  return f;
}

// A from parts split beforehand (big, small) in two row-major tiles
template <int SD>
__device__ __forceinline__ FragA load_a_split(const uint32_t* B,
                                              const uint32_t* S, int r0,
                                              int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int i = (r0 + g) * SD + c0 + t;
  const int off[4] = {0, 8 * SD, 4, 8 * SD + 4};
  FragA f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f.b[j] = B[i + off[j]];
    f.s[j] = S[i + off[j]];
  }
  return f;
}

// the B fragment of elements i and i + step of a shared tile
template <typename T, bool EXACT, bool PRE>
__device__ __forceinline__ FragB load_b_at(const T* X, const uint32_t* S,
                                           int i, int step) {
  FragB f;
  if constexpr (PRE) {
    const uint32_t* B = reinterpret_cast<const uint32_t*>(X);
    f.b[0] = B[i];
    f.b[1] = B[i + step];
    f.s[0] = S[i];
    f.s[1] = S[i + step];
  } else {
    split<EXACT>(widen(X[i]), f.b[0], f.s[0]);
    split<EXACT>(widen(X[i + step]), f.b[1], f.s[1]);
  }
  return f;
}

// Splits a landed f32 tile of ROWS rows in place, by NT threads: the big
// parts over the values, the small ones into S (the same layout)
template <int D, int ROWS, int NT>
__device__ __forceinline__ void presplit(float* X, uint32_t* S) {
  constexpr int SF = stride_of<float, D>(), C4 = D / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += NT) {
    const int i = (e / C4) * SF + (e % C4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(X + i);
    uint4 b, sm;
    split<false>(x.x, b.x, sm.x);
    split<false>(x.y, b.y, sm.y);
    split<false>(x.z, b.z, sm.z);
    split<false>(x.w, b.w, sm.w);
    *reinterpret_cast<uint4*>(X + i) = b;
    *reinterpret_cast<uint4*>(S + i) = sm;
  }
}

// B(k = d, n = row) from a row-major [row][d] shared tile: rows n0 + g,
// columns k0 + t and k0 + t + 4
// (PRE: X holds the big parts and S the small ones, split beforehand)
template <typename T, int SD, bool EXACT, bool PRE = false>
__device__ __forceinline__ FragB load_b_rows(const T* X, int n0, int k0,
                                             const uint32_t* S = nullptr) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  return load_b_at<T, EXACT, PRE>(X, S, (n0 + g) * SD + k0 + t, 4);
}

// B(k = row, n = d) from a row-major [row][d] shared tile, k permuted to
// match a_from_acc: rows k0 + 2t and k0 + 2t + 1, column n0 + g
template <typename T, int SD, bool EXACT, bool PRE = false>
__device__ __forceinline__ FragB load_b_cols(const T* X, int k0, int n0,
                                             const uint32_t* S = nullptr) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  return load_b_at<T, EXACT, PRE>(X, S, (k0 + 2 * t) * SD + n0 + g, SD);
}

// an accumulator tile (16 x 8) as the A operand of the next product, with
// slot t standing for column 2t and slot t + 4 for column 2t + 1
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  FragA f;
  split<false>(c[0], f.b[0], f.s[0]);
  split<false>(c[2], f.b[1], f.s[1]);
  split<false>(c[1], f.b[2], f.s[2]);
  split<false>(c[3], f.b[3], f.s[3]);
  return f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// first and last tile of [0, n) (tiles of KT along the streamed axis)
// that the mask leaves visible against the fixed tile; lo > hi if none.
// Visibility is an interval of position differences, so the visible
// tiles are contiguous.
template <bool STREAM_KEYS, int KT>
__device__ __forceinline__ void visible_range(const Mask& mask, int fixed0,
                                              int nfixed, int n, int& lo,
                                              int& hi) {
  lo = 0;
  hi = -1;
  const int nt = (n + KT - 1) / KT;
  for (int i = 0; i < nt; ++i) {
    const int s0 = i * KT, ns = min(KT, n - s0);
    const bool vis = STREAM_KEYS ? mask.visible(fixed0, nfixed, s0, ns)
                                 : mask.visible(s0, ns, fixed0, nfixed);
    if (vis) {
      if (hi < 0) lo = i;
      hi = i;
    }
  }
}

// -- K1: flash_fwd -------------------------------------------------------

// One CTA per (b, h, 16 W q rows, DO output columns); warp w owns rows
// 16 w .. 16 w + 15.
template <typename T, int D>
__global__ void __launch_bounds__(Shape<T, D>::FWD_W * 32, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ l, float* __restrict__ m, int Tq, int Tk,
                 int H, int Hkv, float scale, Mask mask) {
  using SH = Shape<T, D>;
  constexpr int SD = stride_of<T, D>(), KS = D / 8, NO = SH::DO / 8;
  constexpr int KT = SH::KT, NK = KT / 8, NC = D / SH::DO;
  constexpr int W = SH::FWD_W, NT = W * 32, ROWS = W * 16;
  constexpr bool EX = sizeof(T) == 2;          // bf16: exact in TF32
  // f32 at D = 64: q split once, K/V split once a tile (see the header)
  constexpr bool PRE = !EX && D == 64;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + ROWS * SD;                      // 2 stages
  T* Vs = Ks + 2 * KT * SD;                    // 2 stages
  // PRE: the small parts of q * scale, K and V (big ones in place)
  uint32_t* Qsm = reinterpret_cast<uint32_t*>(Vs + 2 * KT * SD);
  uint32_t* Ksm = Qsm + ROWS * SD;
  uint32_t* Vsm = Ksm + KT * SD;

  // the last q tiles (most visible keys when causal) launch first; the
  // NC CTAs of a tile write output columns c0 .. c0 + DO
  const int nc = (int)blockIdx.x % NC, blk = (int)blockIdx.x / NC;
  const int nqt = (Tq + ROWS - 1) / ROWS, BH = gridDim.x / NC / nqt;
  const int qt = nqt - 1 - blk / BH, bh = blk % BH, c0 = nc * SH::DO;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qt * ROWS, nq = min(ROWS, Tq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const T* kbase = k + ((size_t)b * Tk * Hkv + hk) * D;
  const T* vbase = v + ((size_t)b * Tk * Hkv + hk) * D;
  // f32: q scaled before the dot; bf16: the exact dot is scaled
  const float qmul = EX ? 1.f : scale, smul = EX ? scale : 1.f;

  int lo, hi;
  visible_range<true, KT>(mask, q0, nq, Tk, lo, hi);
  stage_rows<T, D, ROWS, NT>(Qs, q + ((size_t)b * Tq * H + h) * D + q0 * qs,
                             qs, nq);
  if (lo <= hi) {
    const int n0 = min(KT, Tk - lo * KT);
    stage_rows<T, D, KT, NT>(Ks, kbase + lo * KT * ks, ks, n0);
    stage_rows<T, D, KT, NT>(Vs, vbase + lo * KT * ks, ks, n0);
  }
  cp_commit();

  float acc[NO][4], mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  zero(acc);

  for (int kt = lo, it = 0; kt <= hi; ++kt, ++it) {
    const int st = it & 1, k0 = kt * KT;
    if (kt < hi) {                       // prefetch the next tile
      const int k1 = k0 + KT, n1 = min(KT, Tk - k1);
      stage_rows<T, D, KT, NT>(Ks + (st ^ 1) * KT * SD, kbase + k1 * ks, ks,
                               n1);
      stage_rows<T, D, KT, NT>(Vs + (st ^ 1) * KT * SD, vbase + k1 * ks, ks,
                               n1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * KT * SD;
    const T* Vt = Vs + st * KT * SD;
    if constexpr (PRE) {
      if (it == 0) {                     // this warp's q rows, split once
        uint32_t* Qb = reinterpret_cast<uint32_t*>(Qs);
        for (int e = lane; e < 16 * D; e += 32) {
          const int i = (r0 + e / D) * SD + e % D;
          split<false>(Qs[i] * scale, Qb[i], Qsm[i]);
        }
      }
      presplit<D, KT, NT>(Ks + st * KT * SD, Ksm);
      presplit<D, KT, NT>(Vs + st * KT * SD, Vsm);
      __syncthreads();
    }

    // s = q k^T: 16 rows x KT keys in NK accumulator tiles, each k-step
    // added with round-to-nearest (m is held to 1e-5)
    float s[NK][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA a =
          PRE ? load_a_split<SD>(reinterpret_cast<const uint32_t*>(Qs), Qsm,
                                 r0, kk * 8)
              : load_a<T, SD, EX>(Qs, r0, kk * 8, qmul);
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mma3_rn<EX, EX>(s[n], a, load_b_rows<T, SD, EX, PRE>(Kt, n * 8,
                                                             kk * 8, Ksm));
    }

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const bool cut = !mask.all_kept(q0, ROWS, k0, KT) || k0 + KT > Tk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * smul;
        if (cut) {
          const int i = q0 + r0 + g + (e >> 1) * 8;
          const int j = k0 + n * 8 + 2 * t + (e & 1);
          if (j >= Tk || !mask.keep(i, j)) x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(mrow[r], quad_max(mx[r]));
      safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = mrow[r] == -INFINITY ? 0.f : expf(mrow[r] - safe[r]);
      mrow[r] = m_new;
      lrow[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x == -INFINITY ? 0.f : expf(x - safe[e >> 1]);
        s[n][e] = p;
        lrow[e >> 1] += p;
      }

    // o = o corr + p v over this CTA's columns: the accumulators of p are
    // the A operand, 8 keys a k-step; the tile's p v goes to a zeroed
    // fragment
    float pv[NO][4];
    zero(pv);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const FragA a = a_from_acc(s[j]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        mma3<false, EX>(pv[n], a, load_b_cols<T, SD, EX, PRE>(
                                      Vt, j * 8, c0 + n * 8, Vsm));
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
    __syncthreads();                     // this stage is refilled next
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(lrow[r]);
    const int i = q0 + r0 + g + 8 * r;
    if (i >= Tq) continue;
    const size_t row = ((size_t)b * Tq + i) * H + h;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(o + row * D + c0 + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    if (t == 0 && nc == 0) {             // every column CTA has the same
      l[row] = lsum;
      m[row] = mrow[r];
    }
  }
}

// Waits for the streamed tile of iteration `it` to land in its stage and
// makes it visible to the CTA.  With NS = 2 the next tile is staged first
// (`stage_next`, which commits), so it loads while this one computes;
// with NS = 1 the tile is staged here (`stage_this`) after the previous
// iteration's closing barrier.
template <int NS, typename Next, typename This>
__device__ __forceinline__ void await_tile(int it, bool has_next,
                                           Next stage_next,
                                           This stage_this) {
  if (NS == 2 && has_next) {
    stage_next();
    cp_wait<1>();
  } else {
    if (NS == 1 && it > 0) stage_this();
    cp_wait<0>();
  }
  __syncthreads();
}

// -- K2: flash_bwd_dkdv --------------------------------------------------

// One CTA per (b, kv head, 16 W keys, DO output columns); warp w owns
// keys 16 w .. 16 w + 15.  DV / DK select what this sweep accumulates
// (both at D = 64; at D = 128 and 256 one launch each, see the header).
template <typename T, int D, bool DV, bool DK>
__global__ void __launch_bounds__(Shape<T, D>::W * 32, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Tq,
                      int Tk, int H, int Hkv, float scale, Mask mask) {
  constexpr int SD = stride_of<T, D>(), SF = stride_of<float, D>();
  using SH = Shape<T, D>;
  constexpr int KS = D / 8, NO = SH::DO / 8, NS = SH::BWD_NS;
  constexpr int KT = SH::KT, NK = KT / 8, NC = D / SH::DO;
  constexpr int NT = SH::W * 32, ROWS = SH::W * 16;
  constexpr bool EX = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + ROWS * SD;
  T* Qs = Vs + ROWS * SD;                        // NS stages
  float* dOs = reinterpret_cast<float*>(Qs + NS * KT * SD);  // NS stages
  float* Ls = dOs + NS * KT * SF;             // NS stages
  float* Dl = Ls + NS * KT;                   // NS stages
  // at D = 64 dO (and an f32 Q) are split once a tile: small parts here
  constexpr bool PRE_O = D == 64, PRE_Q = PRE_O && !EX;
  uint32_t* dOsm = reinterpret_cast<uint32_t*>(Dl + NS * KT);
  uint32_t* Qsm = dOsm + KT * SF;

  // the first key tiles (most visible queries when causal) launch first
  const int nc = (int)blockIdx.x % NC, blk = (int)blockIdx.x / NC;
  const int nkt = (Tk + ROWS - 1) / ROWS, BHk = gridDim.x / NC / nkt;
  const int kt = blk / BHk, bhk = blk % BHk, c0 = nc * SH::DO;
  const int b = bhk / Hkv, hk = bhk % Hkv, G = H / Hkv;
  const int k0 = kt * ROWS, nk = min(ROWS, Tk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const size_t kbase = ((size_t)b * Tk * Hkv + hk) * D + k0 * ks;

  int lo, hi;
  visible_range<false, KT>(mask, k0, nk, Tq, lo, hi);
  const int nqt = hi - lo + 1, items = nqt > 0 ? G * nqt : 0;
  // item i: q head hk * G + i / nqt, q tile lo + i % nqt
  auto stage_item = [&](int i, int st) {
    const int h = hk * G + i / nqt, q0 = (lo + i % nqt) * KT;
    const int nq = min(KT, Tq - q0);
    const size_t base = ((size_t)b * Tq * H + h) * D + q0 * qs;
    const size_t rbase = ((size_t)b * Tq + q0) * H + h;
    stage_rows<T, D, KT, NT>(Qs + st * KT * SD, q + base, qs, nq);
    stage_rows<float, D, KT, NT>(dOs + st * KT * SF, dout + base, qs,
                                    nq);
    stage_vec<KT, NT>(Ls + st * KT, lse + rbase, H, nq);
    if (DK) stage_vec<KT, NT>(Dl + st * KT, delta + rbase, H, nq);
    cp_commit();
  };
  stage_rows<T, D, ROWS, NT>(Ks, k + kbase, ks, nk);
  if (DK) stage_rows<T, D, ROWS, NT>(Vs, v + kbase, ks, nk);
  if (items > 0) stage_item(0, 0);      // commits K, V and item 0
  else cp_commit();

  float dva[DV ? NO : 1][4], dka[DK ? NO : 1][4];
  zero(dva);
  zero(dka);

  for (int it = 0; it < items; ++it) {
    const int st = NS == 2 ? it & 1 : 0, q0 = (lo + it % nqt) * KT;
    await_tile<NS>(it, it + 1 < items, [&] { stage_item(it + 1, st ^ 1); },
                   [&] { stage_item(it, 0); });
    const T* Qt = Qs + st * KT * SD;
    const float* dOt = dOs + st * KT * SF;
    const float* Lt = Ls + st * KT;
    const float* Dt = Dl + st * KT;
    if constexpr (PRE_O) {
      if constexpr (PRE_Q)
        presplit<D, KT, NT>(reinterpret_cast<float*>(Qs) + st * KT * SD,
                               Qsm);
      presplit<D, KT, NT>(dOs + st * KT * SF, dOsm);
      __syncthreads();
    }

    // s^T = k q^T: 16 keys x KT queries
    float s[NK][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA a = load_a<T, SD, EX>(Ks, r0, kk * 8);
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mma3<EX, EX>(s[n], a, load_b_rows<T, SD, EX, PRE_Q>(Qt, n * 8,
                                                            kk * 8, Qsm));
    }
    // p^T = exp(s^T scale - lse), 0 where masked, past Tq or lse = -inf
    const bool cut =
        !mask.all_kept(q0, KT, k0, ROWS) || q0 + KT > Tq;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const float L = Lt[c];
        bool ok = L != -INFINITY;
        if (cut) {
          const int j = k0 + r0 + g + (e >> 1) * 8;
          ok = ok && q0 + c < Tq && mask.keep(q0 + c, j);
        }
        s[n][e] = ok ? expf(s[n][e] * scale - L) : 0.f;
      }

    if (DK) {
      // dp^T = v do^T, then ds^T = p^T (dp^T - delta)
      float dp[NK][4];
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const FragA a = load_a<T, SD, EX>(Vs, r0, kk * 8);
#pragma unroll
        for (int n = 0; n < NK; ++n)
          mma3<EX, false>(dp[n], a, load_b_rows<float, SF, false, PRE_O>(
                                        dOt, n * 8, kk * 8, dOsm));
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - Dt[n * 8 + 2 * t + (e & 1)]);
      // dk += ds^T q over this CTA's columns, the tile's part in a
      // zeroed fragment
      float part[DK ? NO : 1][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const FragA a = a_from_acc(dp[j]);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma3<false, EX>(part[DK ? n : 0], a,
                          load_b_cols<T, SD, EX, PRE_Q>(Qt, j * 8,
                                                        c0 + n * 8, Qsm));
      }
      add(dka, part);
    }
    if (DV) {
      // dv += p^T do over this CTA's columns, the tile's part in a
      // zeroed fragment
      float part[DV ? NO : 1][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const FragA a = a_from_acc(s[j]);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma3<false, false>(part[DV ? n : 0], a,
                             load_b_cols<float, SF, false, PRE_O>(
                                 dOt, j * 8, c0 + n * 8, dOsm));
      }
      add(dva, part);
    }
    __syncthreads();                     // this stage is refilled next
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + r0 + g + 8 * r;
    if (j >= Tk) continue;
    const size_t row = (((size_t)b * Tk + j) * Hkv + hk) * D + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (DK)
        *reinterpret_cast<float2*>(dk + row + n * 8 + 2 * t) = make_float2(
            dka[DK ? n : 0][2 * r] * scale, dka[DK ? n : 0][2 * r + 1] * scale);
      if (DV)
        *reinterpret_cast<float2*>(dv + row + n * 8 + 2 * t) = make_float2(
            dva[DV ? n : 0][2 * r], dva[DV ? n : 0][2 * r + 1]);
    }
  }
}

// -- K2: flash_bwd_dq ----------------------------------------------------

// One CTA per (b, h, 16 W q rows, DO output columns); warp w owns rows
// 16 w .. 16 w + 15.
template <typename T, int D>
__global__ void __launch_bounds__(Shape<T, D>::W * 32, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int H, int Hkv, float scale, Mask mask) {
  constexpr int SD = stride_of<T, D>(), SF = stride_of<float, D>();
  using SH = Shape<T, D>;
  constexpr int KS = D / 8, NO = SH::DO / 8, NS = SH::BWD_NS;
  constexpr int KT = SH::KT, NK = KT / 8, NC = D / SH::DO;
  constexpr int NT = SH::W * 32, ROWS = SH::W * 16;
  constexpr bool EX = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + ROWS * SD;                        // NS stages
  T* Vs = Ks + NS * KT * SD;                  // NS stages
  float* dOs = reinterpret_cast<float*>(Vs + NS * KT * SD);
  // f32 at D = 64: K/V split once a tile, small parts here
  constexpr bool PRE = !EX && D == 64;
  uint32_t* Ksm = reinterpret_cast<uint32_t*>(dOs + ROWS * SF);
  uint32_t* Vsm = Ksm + KT * SD;

  const int nc = (int)blockIdx.x % NC, blk = (int)blockIdx.x / NC;
  const int nqt = (Tq + ROWS - 1) / ROWS, BH = gridDim.x / NC / nqt;
  const int qt = nqt - 1 - blk / BH, bh = blk % BH, c0 = nc * SH::DO;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qt * ROWS, nq = min(ROWS, Tq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const T* kbase = k + ((size_t)b * Tk * Hkv + hk) * D;
  const T* vbase = v + ((size_t)b * Tk * Hkv + hk) * D;

  int lo, hi;
  visible_range<true, KT>(mask, q0, nq, Tk, lo, hi);
  auto stage_kv = [&](int kt, int st) {
    const int k1 = kt * KT, n1 = min(KT, Tk - k1);
    stage_rows<T, D, KT, NT>(Ks + st * KT * SD, kbase + k1 * ks, ks,
                                n1);
    stage_rows<T, D, KT, NT>(Vs + st * KT * SD, vbase + k1 * ks, ks,
                                n1);
    cp_commit();
  };
  const size_t base = ((size_t)b * Tq * H + h) * D + q0 * qs;
  stage_rows<T, D, ROWS, NT>(Qs, q + base, qs, nq);
  stage_rows<float, D, ROWS, NT>(dOs, dout + base, qs, nq);
  if (lo <= hi) stage_kv(lo, 0);        // commits Q, dO and tile lo
  else cp_commit();
  // lse and delta of this thread's rows g and g + 8 (rows past Tq: p = 0)
  float Lr[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + g + 8 * r;
    const size_t row = ((size_t)b * Tq + i) * H + h;
    Lr[r] = i < Tq ? lse[row] : -INFINITY;
    Dr[r] = i < Tq ? delta[row] : 0.f;
  }

  float dqa[NO][4];
  zero(dqa);

  for (int kt = lo, it = 0; kt <= hi; ++kt, ++it) {
    const int st = NS == 2 ? it & 1 : 0, k0 = kt * KT;
    await_tile<NS>(it, kt < hi, [&] { stage_kv(kt + 1, st ^ 1); },
                   [&] { stage_kv(kt, 0); });
    const T* Kt = Ks + st * KT * SD;
    const T* Vt = Vs + st * KT * SD;
    if constexpr (PRE) {
      presplit<D, KT, NT>(Ks + st * KT * SD, Ksm);
      presplit<D, KT, NT>(Vs + st * KT * SD, Vsm);
      __syncthreads();
    }

    // s = q k^T and dp = do v^T: 16 rows x KT keys each
    float s[NK][4], dp[NK][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA a = load_a<T, SD, EX>(Qs, r0, kk * 8);
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mma3<EX, EX>(s[n], a, load_b_rows<T, SD, EX, PRE>(Kt, n * 8, kk * 8,
                                                          Ksm));
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA a = load_a<float, SF, false>(dOs, r0, kk * 8);
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mma3<false, EX>(dp[n], a, load_b_rows<T, SD, EX, PRE>(
                                      Vt, n * 8, kk * 8, Vsm));
    }
    // ds = p (dp - delta), p = exp(s scale - lse) or 0
    const bool cut =
        !mask.all_kept(q0, ROWS, k0, KT) || k0 + KT > Tk;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float L = Lr[e >> 1];
        bool ok = L != -INFINITY;
        if (cut) {
          const int i = q0 + r0 + g + (e >> 1) * 8;
          const int j = k0 + n * 8 + 2 * t + (e & 1);
          ok = ok && j < Tk && mask.keep(i, j);
        }
        const float p = ok ? expf(s[n][e] * scale - L) : 0.f;
        dp[n][e] = p * (dp[n][e] - Dr[e >> 1]);
      }
    // dq += ds k over this CTA's columns, the tile's part in a zeroed
    // fragment (s is dead)
    float part[NO][4];
    zero(part);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const FragA a = a_from_acc(dp[j]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        mma3<false, EX>(part[n], a, load_b_cols<T, SD, EX, PRE>(
                                        Kt, j * 8, c0 + n * 8, Ksm));
    }
    add(dqa, part);
    __syncthreads();                     // this stage is refilled next
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + g + 8 * r;
    if (i >= Tq) continue;
    const size_t row = (((size_t)b * Tq + i) * H + h) * D + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dq + row + n * 8 + 2 * t) =
          make_float2(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

// shared memory of each kernel, in bytes
template <typename T, int D> constexpr size_t tile_bytes(int rows) {
  return (size_t)rows * stride_of<T, D>() * sizeof(T);
}
template <typename T, int D> constexpr size_t fwd_smem() {
  // Q, 2 x K, 2 x V, and at D = 64 in f32 the small parts of Q, K, V
  constexpr int R = Shape<T, D>::FWD_W * 16, KT = Shape<T, D>::KT;
  return tile_bytes<T, D>(R + 4 * KT) +
         (sizeof(T) == 4 && D == 64 ? tile_bytes<float, D>(R + 2 * KT) : 0);
}
template <typename T, int D> constexpr size_t dkdv_smem() {
  // K, V, NS x (Q, dO, lse, delta), and at D = 64 the small parts of dO
  // (and of an f32 Q)
  constexpr int R = Shape<T, D>::W * 16, NS = Shape<T, D>::BWD_NS;
  constexpr int KT = Shape<T, D>::KT;
  constexpr int SMALL = D == 64 ? (sizeof(T) == 4 ? 2 : 1) * KT : 0;
  return tile_bytes<T, D>(2 * R + NS * KT) +
         tile_bytes<float, D>(NS * KT + SMALL) + 2 * NS * KT * sizeof(float);
}
template <typename T, int D> constexpr size_t dq_smem() {
  // Q, NS x (K, V), dO, and at D = 64 in f32 the small parts of K, V
  constexpr int R = Shape<T, D>::W * 16, NS = Shape<T, D>::BWD_NS;
  constexpr int KT = Shape<T, D>::KT;
  return tile_bytes<T, D>(R + 2 * NS * KT) + tile_bytes<float, D>(R) +
         (sizeof(T) == 4 && D == 64 ? tile_bytes<float, D>(2 * KT) : 0);
}

// every instance fits the 227 KB a CTA may use
template <typename T, int D> constexpr bool fits() {
  return fwd_smem<T, D>() <= 232448 && dkdv_smem<T, D>() <= 232448 &&
         dq_smem<T, D>() <= 232448;
}
static_assert(fits<float, 64>() && fits<float, 128>() &&
              fits<float, 256>() && fits<__nv_bfloat16, 64>() &&
              fits<__nv_bfloat16, 128>() && fits<__nv_bfloat16, 256>(),
              "a flash attention CTA needs more than 227 KB");

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* l,
        void* m, int B, int Tq, int Tk, int H, int Hkv, float scale,
        Mask mask, cudaStream_t st) {
  constexpr int W = Shape<T, D>::FWD_W, NC = D / Shape<T, D>::DO;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kern, fwd_smem<T, D>());
  if (e != cudaSuccess) return (int)e;
  kern<<<B * H * ceil_div(Tq, 16 * W) * NC, 32 * W, fwd_smem<T, D>(),
         st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o),
      static_cast<float*>(l), static_cast<float*>(m), Tq, Tk, H, Hkv, scale,
      mask);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool DV, bool DK>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int Tq, int Tk, int H,
                        int Hkv, float scale, Mask mask, cudaStream_t st) {
  constexpr int W = Shape<T, D>::W, NC = D / Shape<T, D>::DO;
  auto kern = flash_bwd_dkdv_kernel<T, D, DV, DK>;
  cudaError_t e = allow_smem(kern, dkdv_smem<T, D>());
  if (e != cudaSuccess) return e;
  kern<<<B * Hkv * ceil_div(Tk, 16 * W) * NC, 32 * W, dkdv_smem<T, D>(),
         st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, H, Hkv,
      scale, mask);
  return cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int B, int Tq, int Tk, int H, int Hkv, float scale, Mask mask,
        cudaStream_t st) {
  constexpr int W = Shape<T, D>::W, NC = D / Shape<T, D>::DO;
  cudaError_t e;
  if constexpr (D == 64) {
    e = launch_dkdv<T, D, true, true>(q, k, v, dout, lse, delta, dk, dv, B,
                                      Tq, Tk, H, Hkv, scale, mask, st);
  } else {                               // two sweeps: dv, then dk
    e = launch_dkdv<T, D, true, false>(q, k, v, dout, lse, delta, dk, dv, B,
                                       Tq, Tk, H, Hkv, scale, mask, st);
    if (e == cudaSuccess)
      e = launch_dkdv<T, D, false, true>(q, k, v, dout, lse, delta, dk, dv,
                                         B, Tq, Tk, H, Hkv, scale, mask, st);
  }
  if (e != cudaSuccess) return (int)e;
  auto q_kern = flash_bwd_dq_kernel<T, D>;
  e = allow_smem(q_kern, dq_smem<T, D>());
  if (e != cudaSuccess) return (int)e;
  q_kern<<<B * H * ceil_div(Tq, 16 * W) * NC, 32 * W, dq_smem<T, D>(),
           st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Tq, Tk, H, Hkv, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16 (q, k and v share it).  D is 64, 128 or 256.  Outputs
// are f32: o [B, Tq, H, D], l and m [B, Tq, H].  Every pointer 16-byte
// aligned.
int bf_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* l, void* m, int B, int Tq, int Tk, int H, int Hkv,
                 int D, float scale, int causal, int window, int q_offset,
                 int k_offset, int dtype, void* stream) {
  const Mask mask{causal, window, q_offset, k_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return fwd<float, 64>(q, k, v, o, l, m, B, Tq, Tk, H, Hkv, scale, mask,
                          st);
  if (dtype == 0 && D == 128)
    return fwd<float, 128>(q, k, v, o, l, m, B, Tq, Tk, H, Hkv, scale, mask,
                           st);
  if (dtype == 1 && D == 64)
    return fwd<__nv_bfloat16, 64>(q, k, v, o, l, m, B, Tq, Tk, H, Hkv,
                                  scale, mask, st);
  if (dtype == 1 && D == 128)
    return fwd<__nv_bfloat16, 128>(q, k, v, o, l, m, B, Tq, Tk, H, Hkv,
                                   scale, mask, st);
  if (dtype == 0 && D == 256)
    return fwd<float, 256>(q, k, v, o, l, m, B, Tq, Tk, H, Hkv, scale, mask,
                           st);
  if (dtype == 1 && D == 256)
    return fwd<__nv_bfloat16, 256>(q, k, v, o, l, m, B, Tq, Tk, H, Hkv,
                                   scale, mask, st);
  return (int)cudaErrorInvalidValue;
}

// dout, lse and delta are f32; dq [B, Tq, H, D] and dk/dv [B, Tk, Hkv, D]
// are written in f32.  Launches flash_bwd_dkdv (twice at D = 128 and 256:
// dv, then dk), then flash_bwd_dq.
int bf_flash_bwd(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H,
                 int Hkv, int D, float scale, int causal, int window,
                 int q_offset, int k_offset, int dtype, void* stream) {
  const Mask mask{causal, window, q_offset, k_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return bwd<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Tq, Tk,
                          H, Hkv, scale, mask, st);
  if (dtype == 0 && D == 128)
    return bwd<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Tq, Tk,
                           H, Hkv, scale, mask, st);
  if (dtype == 1 && D == 64)
    return bwd<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                  Tq, Tk, H, Hkv, scale, mask, st);
  if (dtype == 1 && D == 128)
    return bwd<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                   Tq, Tk, H, Hkv, scale, mask, st);
  if (dtype == 0 && D == 256)
    return bwd<float, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Tq, Tk,
                           H, Hkv, scale, mask, st);
  if (dtype == 1 && D == 256)
    return bwd<__nv_bfloat16, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                   Tq, Tk, H, Hkv, scale, mask, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
