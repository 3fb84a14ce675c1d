// Paged flash-decode attention for Hopper (sm_90a), split across the key
// axis (flash-decoding).
//
// Replaces the TPU kernel bluefog_tpu/ops/pallas_decode.py::_flash_attend
// (kernel _flash_kernel): lane s's query t (T per lane, t at position
// lengths[s] + t) of q head h attends keys 0 .. lengths[s] + t of its
// slot's pages [rows, Hkv, L, Dh] through kv head h / G, G = H / Hkv.
// Blocks of bk keys whose end lies within prefix_lens[s] (a multiple of
// bk by contract) are read from the prefix row prefix_slots[s], the rest
// from slots[s].  int8 / e4m3 pages carry f32 scales per (position,
// head): the k scale multiplies score columns, the v scale probability
// columns.  q is f32 or bf16, the output is in q's type, all math is f32.
//
// What bounds it: the bytes.  One row of q against each key (T * G rows
// in all) is a few FLOP per byte of page, far below what the tensor cores
// could use; the least time is sum_s (lengths[s] + T) * Hkv * Dh * 2 *
// itemsize (plus the scales) over the memory rate.  So the design only
// tries to move the pages at full bandwidth:
//
//   * Split-KV grid (S, Hkv, splits).  The wrapper picks `splits` and the
//     keys per split (`chunk`, a multiple of 32) from S * Hkv and L alone,
//     never from lengths, so that small batches still put several CTAs on
//     each of the 132 SMs.  A CTA walks keys [sp * chunk, (sp + 1) *
//     chunk) of its lane, cut at the last key any of its rows sees; a CTA
//     whose chunk lies wholly past it writes m = -inf, l = 0, o = 0 and
//     exits (K1's rule for rows with no visible key).  The prefix row is
//     picked per key by the key's bk-block, so a split may end inside a
//     block.
//   * Staging.  Each 32-key f32 tile (64 keys bf16, 128 int8 / e4m3: 8 KB
//     of K at Dh 64) is copied by cp.async, 16 bytes a thread with
//     neighbouring threads on neighbouring addresses, K and V into their
//     own buffers as separate commit groups, two tiles deep: V's copy
//     overlaps the scores and the next tile's copies overlap both.  Keys
//     past the CTA's last visible key are zero-filled, not read.  Quantized
//     pages stay 8-bit in shared memory and widen in registers.
//   * Math at the warp level.  The CTA's 128 threads are 16 groups of 8
//     lanes; the lanes of a group split Dh (Dh / 8 values each) and reduce
//     a dot product with 3 shuffles.  Groups split the T * G rows (up to
//     16 row groups, 1 or 4 rows each) and the tile's keys (16 / row
//     groups ways), so at T * G = 1 every group works on its own keys and
//     no thread idles.  q lives in registers, pre-scaled.  Each group
//     keeps its own f32 online softmax (m, l and its Dh / 8 outputs per
//     row in registers) over its keys; at the end the groups' partials
//     meet in shared memory and are merged in group order.
//   * Merge.  With one split the CTA normalizes and writes the output.
//     Otherwise it writes its partial (o, l, m) to an f32 scratch
//     [S, Hkv, splits, T * G, Dh] (+ m, l) that the wrapper allocates, and
//     a second, small launch merges the splits in split order and writes
//     o / l in q's type.  No atomics: reruns are bit-identical.
//
//   * Head dims.  The kernel is built for head-dim buckets DH = 32, 64,
//     128 and 256 and takes the actual head dim dr (any dr <= 256, odd
//     ones too) at run time: rows of q, pages and the output are dr
//     values apart, and the staged tiles are DH wide with the columns
//     past dr zero-filled,
//     so they add nothing to q.k and give output columns that are not
//     written.  A tile row arrives by 16-byte cp.async when dr fills whole
//     16-byte chunks (dr % 4 == 0 for f32 pages, % 8 for bf16, % 16 for
//     int8 / e4m3); otherwise each value is copied by a plain load and
//     store, since a row then does not start on a 16-byte boundary.  At
//     DH = 256 a lane holds 32 values of each of its rows' q and output
//     in registers, so the 4-row groups (T * G > 16) hold 256 of them:
//     ptxas spills those to local memory (chip_smoke prints its lines).
//     Shared memory stays inside the card's 232,448 bytes at T * G = 64:
//     at DH = 256 it takes 205,824 (f32 pages), 214,528 (bf16) and
//     231,936 (int8 / e4m3, 128-key tiles).
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = kThreads / 8;   // groups of 8 lanes
constexpr int kMaxRows = 64;            // T * G: 16 row groups x 4 rows

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) {
  return (float)x;
}

__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// the unsigned type of a page value's bits (the scalar staging path)
template <int N> struct RawOf;
template <> struct RawOf<1> { using T = uint8_t; };
template <> struct RawOf<2> { using T = uint16_t; };
template <> struct RawOf<4> { using T = uint32_t; };

// the built head dim a run-time head dim dr runs at (0: none)
__host__ __device__ inline int dh_bucket(int dr) {
  if (dr < 1 || dr > 256) return 0;
  return dr <= 32 ? 32 : dr <= 64 ? 64 : dr <= 128 ? 128 : 256;
}

// keys per staged tile: 8 KB of K at Dh 64 for every page type
template <typename PT>
__host__ __device__ constexpr int keys_per_tile() {
  return 32 * 4 / (int)sizeof(PT);
}

// Shared memory: K and V tiles [2][KT][Dh] each (page type), their
// scales [2][KT] each, the scores [TG][KT], and the groups' partials
// [groups][TG][Dh + 2] (f32).
__host__ __device__ inline size_t smem_bytes(int TG, int DH, int item,
                                             int KT, int kg) {
  return (size_t)4 * KT * DH * item + (size_t)4 * KT * 4 +
         (size_t)TG * KT * 4 + (size_t)kg * TG * (DH + 2) * 4;
}

// row groups: the least power of two >= TG, at most 16
__host__ __device__ inline int row_groups(int TG) {
  int n = 1;
  while (n < TG && n < kGroups) n <<= 1;
  return n;
}

// VEC values of a lane's piece of a shared row, widened
template <typename PT, int VEC>
__device__ __forceinline__ void widen_piece(const PT* src, float* dst) {
  constexpr int B = VEC * (int)sizeof(PT);
  if constexpr (B == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const PT* e = reinterpret_cast<const PT*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = widen(e[i]);
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const PT* e = reinterpret_cast<const PT*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = widen(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = widen(src[i]);
  }
}

// Lane li of a group owns the values d = (p * 8 + li) * VEC + e of a row
// (piece p < NP, e < VEC): 8 lanes read 8 neighbouring pieces.
template <typename PT, int DH> struct Slice {
  static constexpr int DPL = DH / 8;
  static constexpr int VEC = DPL < 16 / (int)sizeof(PT)
                                 ? DPL : 16 / (int)sizeof(PT);
  static constexpr int NP = DPL / VEC;
  __device__ static __forceinline__ int d(int li, int j) {
    return ((j / VEC) * 8 + li) * VEC + j % VEC;
  }
  __device__ static __forceinline__ void load(const PT* row, int li,
                                              float (&x)[DPL]) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      widen_piece<PT, VEC>(row + (p * 8 + li) * VEC, x + p * VEC);
  }
};

// One CTA: lane s = blockIdx.x, kv head h = blockIdx.y, split blockIdx.z.
// RPG: rows a group holds in registers (1, or 4 when T * G > 16).  DH is
// the head-dim bucket, dr <= DH the head dim of q, pages and output.
template <typename QT, typename PT, int DH, int RPG>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                    const PT* __restrict__ vp,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ slots,
                    const int* __restrict__ lengths,
                    const int* __restrict__ prefix_slots,
                    const int* __restrict__ prefix_lens,
                    QT* __restrict__ out, float* __restrict__ part, int T,
                    int H, int Hkv, int L, int bk, int G, float scale,
                    int chunk, int dr) {
  using SL = Slice<PT, DH>;
  constexpr int KT = keys_per_tile<PT>(), DPL = SL::DPL;
  constexpr int EPC = 16 / (int)sizeof(PT);      // values per 16 bytes
  constexpr int CH = DH / EPC;                   // 16-byte chunks a key
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = gridDim.x, nsplit = gridDim.z;
  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int TG = T * G;
  const int tid = threadIdx.x, li = tid & 7, gi = tid >> 3;
  const int nrg = row_groups(TG), nkg = kGroups / nrg;
  const int rg = gi % nrg, kg = gi / nrg;

  PT* kbuf = reinterpret_cast<PT*>(smem);
  PT* vbuf = kbuf + 2 * KT * DH;
  float* ksh = reinterpret_cast<float*>(vbuf + 2 * KT * DH);
  float* vsh = ksh + 2 * KT;
  float* s_sh = vsh + 2 * KT;          // [TG][KT]
  float* red = s_sh + TG * KT;         // [nkg][TG][DH + 2]

  const int len = lengths[s], slot = slots[s];
  const int prow = prefix_slots ? prefix_slots[s] : slot;
  const int plen = prefix_slots ? prefix_lens[s] : 0;
  const bool quant = ksc != nullptr;
  const int last = min(len + T - 1, L - 1);      // last key a row sees
  const int c0 = sp * chunk;
  const int c1 = min(min(c0 + chunk, L), last + 1);
  // this split's partial rows in the scratch: o, then m, then l
  const size_t prow0 = (((size_t)s * Hkv + h) * nsplit + sp) * TG;
  const size_t nrows_all = (size_t)S * Hkv * nsplit * TG;
  float* po = part;
  float* pm = part + nrows_all * DH;
  float* pl = pm + nrows_all;

  if (c0 >= c1) {                      // nothing visible in this split
    for (int e = tid; e < TG * DH; e += kThreads) po[prow0 * DH + e] = 0.f;
    for (int r = tid; r < TG; r += kThreads) {
      pm[prow0 + r] = -INFINITY;
      pl[prow0 + r] = 0.f;
    }
    return;
  }

  float qr[RPG][DPL], acc[RPG][DPL], m[RPG], l[RPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    const int r = rg + nrg * i;
    const int t = r / G, g = r % G;
    const size_t qi = (((size_t)s * T + t) * H + (size_t)h * G + g) * dr;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = SL::d(li, j);
      qr[i][j] = r < TG && d < dr ? widen(q[qi + d]) * scale : 0.f;
      acc[i][j] = 0.f;
    }
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  // 16-byte copies need rows made of whole 16-byte chunks
  const bool vec = dr % EPC == 0;
  using Raw = typename RawOf<(int)sizeof(PT)>::T;

  // K then V of the tile starting at key kb0, each its own commit group
  auto stage = [&](int kb0, int buf) {
    const PT* src[2] = {kp, vp};
    PT* dst[2] = {kbuf + buf * KT * DH, vbuf + buf * KT * DH};
    const float* ssrc[2] = {ksc, vsc};
    float* sdst[2] = {ksh + buf * KT, vsh + buf * KT};
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      if (vec) {
        for (int c = tid; c < KT * CH; c += kThreads) {
          const int j = c / CH, x = c % CH, kpos = kb0 + j;
          const bool ok = kpos < c1 && x * EPC < dr;
          const int kk = kpos < c1 ? kpos : 0;
          const int row = ((kk / bk + 1) * bk <= plen) ? prow : slot;
          const size_t off = (((size_t)row * Hkv + h) * L + kk) * dr +
                             (ok ? x * EPC : 0);
          cp16(dst[w] + j * DH + x * EPC, src[w] + off, ok);
        }
      } else {
        const Raw* rs = reinterpret_cast<const Raw*>(src[w]);
        Raw* rd = reinterpret_cast<Raw*>(dst[w]);
        for (int c = tid; c < KT * DH; c += kThreads) {
          const int j = c / DH, d = c % DH, kpos = kb0 + j;
          Raw val = 0;
          if (kpos < c1 && d < dr) {
            const int row = ((kpos / bk + 1) * bk <= plen) ? prow : slot;
            val = rs[(((size_t)row * Hkv + h) * L + kpos) * dr + d];
          }
          rd[j * DH + d] = val;
        }
      }
      if (quant)
        for (int j = tid; j < KT; j += kThreads) {
          const int kpos = kb0 + j;
          const bool ok = kpos < c1;
          const int kk = ok ? kpos : 0;
          const int row = ((kk / bk + 1) * bk <= plen) ? prow : slot;
          cp4(sdst[w] + j, ssrc[w] + ((size_t)row * Hkv + h) * L + kk, ok);
        }
      cp_commit();
    }
  };

  const int nt = (c1 - c0 + KT - 1) / KT;
  stage(c0, 0);
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1, kb0 = c0 + it * KT;
    if (it + 1 < nt) {
      stage(kb0 + KT, buf ^ 1);
    } else {
      cp_commit();
      cp_commit();
    }
    cp_wait<3>();                      // this tile's K has landed
    __syncthreads();

    // scores of the group's keys j = kg, kg + nkg, ...
    const PT* kt = kbuf + buf * KT * DH;
    float tmax[RPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i) tmax[i] = -INFINITY;
    for (int j = kg; j < KT; j += nkg) {
      float kv[DPL];
      SL::load(kt + j * DH, li, kv);
      const int kpos = kb0 + j;
      const float ks = quant ? ksh[buf * KT + j] : 1.f;
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        const int r = rg + nrg * i;
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) a = fmaf(qr[i][e], kv[e], a);
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        a += __shfl_xor_sync(0xffffffffu, a, 4);
        const bool vis = r < TG && kpos < c1 && kpos <= len + r / G;
        a = vis ? a * ks : -INFINITY;
        if (li == 0 && r < TG) s_sh[r * KT + j] = a;
        tmax[i] = fmaxf(tmax[i], a);
      }
    }
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const float mn = fmaxf(m[i], tmax[i]);
      if (mn != -INFINITY) {
        const float c = expf(m[i] - mn);
        l[i] *= c;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] *= c;
        m[i] = mn;
      }
    }
    cp_wait<2>();                      // this tile's V has landed
    __syncthreads();

    const PT* vt = vbuf + buf * KT * DH;
    for (int j = kg; j < KT; j += nkg) {
      float vv[DPL];
      SL::load(vt + j * DH, li, vv);
      const float vs = quant ? vsh[buf * KT + j] : 1.f;
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        const int r = rg + nrg * i;
        const float sc = r < TG ? s_sh[r * KT + j] : -INFINITY;
        const float p = sc == -INFINITY ? 0.f : expf(sc - m[i]);
        l[i] += p;
        const float pv = p * vs;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pv, vv[e], acc[i][e]);
      }
    }
    __syncthreads();                   // buffers and scores free again
  }

  // the groups' partials meet in shared memory, merged in group order
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    const int r = rg + nrg * i;
    if (r < TG) {
      float* rr = red + ((size_t)kg * TG + r) * (DH + 2);
#pragma unroll
      for (int j = 0; j < DPL; ++j) rr[SL::d(li, j)] = acc[i][j];
      if (li == 0) {
        rr[DH] = m[i];
        rr[DH + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < TG * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    if (nsplit == 1 && d >= dr) continue;    // a column not written
    float M = -INFINITY;
    for (int k = 0; k < nkg; ++k)
      M = fmaxf(M, red[((size_t)k * TG + r) * (DH + 2) + DH]);
    float O = 0.f, Ls = 0.f;
    if (M != -INFINITY)
      for (int k = 0; k < nkg; ++k) {
        const float* rr = red + ((size_t)k * TG + r) * (DH + 2);
        const float w = expf(rr[DH] - M);
        Ls += rr[DH + 1] * w;
        O += rr[d] * w;
      }
    if (nsplit == 1) {
      const int t = r / G, g = r % G;
      const size_t oi =
          (((size_t)s * T + t) * H + (size_t)h * G + g) * dr + d;
      narrow(out + oi, Ls > 0.f ? O / Ls : 0.f);
    } else {
      po[(prow0 + r) * DH + d] = O;
      if (d == 0) {
        pm[prow0 + r] = M;
        pl[prow0 + r] = Ls;
      }
    }
  }
}

// Merges the splits' partials of lane blockIdx.x, kv head blockIdx.y in
// split order and writes o / l in q's type (the first dr columns).
template <typename QT, int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_merge(const float* __restrict__ part, QT* __restrict__ out,
                   int T, int H, int Hkv, int G, int nsplit, int dr) {
  const int S = gridDim.x, s = blockIdx.x, h = blockIdx.y, TG = T * G;
  const size_t nrows_all = (size_t)S * Hkv * nsplit * TG;
  const float* pm = part + nrows_all * DH;
  const float* pl = pm + nrows_all;
  const size_t base = ((size_t)s * Hkv + h) * nsplit * TG;
  for (int e = threadIdx.x; e < TG * dr; e += kThreads) {
    const int r = e / dr, d = e % dr;
    float M = -INFINITY;
    for (int k = 0; k < nsplit; ++k) M = fmaxf(M, pm[base + k * TG + r]);
    float O = 0.f, Ls = 0.f;
    if (M != -INFINITY)
      for (int k = 0; k < nsplit; ++k) {
        const size_t i = base + k * TG + r;
        const float w = expf(pm[i] - M);
        Ls += pl[i] * w;
        O += part[i * DH + d] * w;
      }
    const int t = r / G, g = r % G;
    const size_t oi = (((size_t)s * T + t) * H + (size_t)h * G + g) * dr + d;
    narrow(out + oi, Ls > 0.f ? O / Ls : 0.f);
  }
}

template <typename PT>
size_t smem_for(int TG, int DH) {
  return smem_bytes(TG, DH, (int)sizeof(PT), keys_per_tile<PT>(),
                    kGroups / row_groups(TG));
}

template <typename QT, typename PT, int DH>
int launch(const void* q, const void* k, const void* v, const void* ksc,
           const void* vsc, const void* slots, const void* lengths,
           const void* prefix_slots, const void* prefix_lens, void* out,
           void* part, int S, int T, int H, int Hkv, int L, int bk,
           int chunk, int nsplit, float scale, int dr, cudaStream_t stream) {
  const int G = H / Hkv, TG = T * G;
  if (TG > kMaxRows || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_for<PT>(TG, DH);
  const bool wide = (TG + row_groups(TG) - 1) / row_groups(TG) > 1;
  auto kern = wide ? flash_decode_kernel<QT, PT, DH, 4>
                   : flash_decode_kernel<QT, PT, DH, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(S, Hkv, nsplit), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(slots),
      static_cast<const int*>(lengths),
      static_cast<const int*>(prefix_slots),
      static_cast<const int*>(prefix_lens), static_cast<QT*>(out),
      static_cast<float*>(part), T, H, Hkv, L, bk, G, scale, chunk, dr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  flash_decode_merge<QT, DH><<<dim3(S, Hkv), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<QT*>(out), T, H, Hkv, G,
      nsplit, dr);
  return (int)cudaGetLastError();
}

#define BF_DECODE_ARGS                                                    \
  q, k, v, ksc, vsc, slots, lengths, ps, pl, out, part, S, T, H, Hkv, L, \
      bk, chunk, nsplit, scale, st
#define BF_LAUNCH_ARGS                                                    \
  q, k, v, ksc, vsc, slots, lengths, ps, pl, out, part, S, T, H, Hkv, L, \
      bk, chunk, nsplit, scale, Dh, st

template <typename QT, typename PT>
int by_dh(int Dh, const void* q, const void* k, const void* v,
          const void* ksc, const void* vsc, const void* slots,
          const void* lengths, const void* ps, const void* pl, void* out,
          void* part, int S, int T, int H, int Hkv, int L, int bk,
          int chunk, int nsplit, float scale, cudaStream_t st) {
  switch (dh_bucket(Dh)) {
    case 32: return launch<QT, PT, 32>(BF_LAUNCH_ARGS);
    case 64: return launch<QT, PT, 64>(BF_LAUNCH_ARGS);
    case 128: return launch<QT, PT, 128>(BF_LAUNCH_ARGS);
    case 256: return launch<QT, PT, 256>(BF_LAUNCH_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int by_page(int page_dtype, int Dh, const void* q, const void* k,
            const void* v, const void* ksc, const void* vsc,
            const void* slots, const void* lengths, const void* ps,
            const void* pl, void* out, void* part, int S, int T, int H,
            int Hkv, int L, int bk, int chunk, int nsplit, float scale,
            cudaStream_t st) {
  switch (page_dtype) {
    case 0: return by_dh<QT, float>(Dh, BF_DECODE_ARGS);
    case 1: return by_dh<QT, __nv_bfloat16>(Dh, BF_DECODE_ARGS);
    case 2: return by_dh<QT, int8_t>(Dh, BF_DECODE_ARGS);
    case 3: return by_dh<QT, __nv_fp8_e4m3>(Dh, BF_DECODE_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory bytes one CTA needs at T * G = TG rows and head dim Dh
// (the wrapper checks it against the card's 227 KB before launching).
size_t bf_flash_decode_smem_bytes(int TG, int Dh, int page_dtype) {
  const int DH = dh_bucket(Dh);
  switch (page_dtype) {
    case 0: return smem_for<float>(TG, DH);
    case 1: return smem_for<__nv_bfloat16>(TG, DH);
    default: return smem_for<int8_t>(TG, DH);
  }
}

// q_dtype: 0 f32, 1 bf16.  page_dtype: 0 f32, 1 bf16, 2 int8, 3 e4m3.
// ksc/vsc are null for a raw store; prefix_slots/prefix_lens are null
// when no lane reads through a prefix page.  part: f32 scratch of
// S * Hkv * nsplit * T * G * (DH + 2) values, DH the head-dim bucket of
// Dh (null when nsplit is 1); split sp covers keys [sp * chunk, (sp + 1)
// * chunk).  Dh: any head dim from 1 to 256.
int bf_flash_decode(const void* q, const void* k, const void* v,
                    const void* ksc, const void* vsc, const void* slots,
                    const void* lengths, const void* ps, const void* pl,
                    void* out, void* part, int S, int T, int H, int Hkv,
                    int L, int Dh, int bk, int chunk, int nsplit,
                    float scale, int q_dtype, int page_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || nsplit < 1 || (long long)chunk * nsplit < L)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return by_page<float>(page_dtype, Dh, BF_DECODE_ARGS);
  if (q_dtype == 1)
    return by_page<__nv_bfloat16>(page_dtype, Dh, BF_DECODE_ARGS);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
