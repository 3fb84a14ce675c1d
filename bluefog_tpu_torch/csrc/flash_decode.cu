// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel bluefog_tpu/ops/pallas_decode.py::_flash_attend
// (kernel _flash_kernel).  Same function, rethought for the GPU:
//
//   * One CTA per (lane s, kv head h).  The TPU walks the KV blocks on a
//     sequential grid axis with a clamped block table; here the CTA loops
//     over blocks b = 0 .. (lengths[s] + T - 1) / bk itself, so cost
//     follows the lane's context, not the cache capacity.
//   * Each block loads its own indices: its page row is prefix_slots[s]
//     when (b + 1) * bk <= prefix_lens[s] (prefix lengths are block
//     aligned by contract), else slots[s].  No host-side tables.
//   * The CTA's q tile is [T*G, Dh] in shared memory, query t of group
//     lane g at row t*G + g, so each K/V block is read once for its whole
//     GQA group and all T chunk queries.
//   * Pages are widened to f32 in shared memory (bf16 by intrinsic, int8
//     by cast, e4m3 through cuda_fp8.h).  With a quantized store the k
//     scale multiplies score columns and the v scale probability columns.
//   * Scores are f32 FMAs of the pre-scaled q against K; the mask is
//     kpos <= lengths[s] + row / G; an f32 online softmax keeps running m,
//     l and acc; the output is acc / l cast to q's type.
//
// What bounds it: it is memory bound.  The bytes it must move are
// sum_s (lengths[s] + T) * Hkv * Dh * 2 * itemsize, plus 2 * 4 bytes of
// scales per (position, head) for a quantized store, plus q and the
// output.  This first version leaves bandwidth on the table: S * Hkv CTAs
// (8 * 16 = 128 at the engine's shape) is under one wave on 132 SMs, and
// each CTA loads a block, waits for it, then computes.  A later version
// splits each lane's blocks across CTAs (flash-decoding, merging the
// partials) so small batches fill the card, and stages blocks with
// cp.async / TMA so loads overlap the math.
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: q and acc [TG][DH] each, one K-or-V block
// [bk][DH + 1] (padded so neighbouring keys fall in different banks),
// scores / probabilities [TG][bk], the block's scales [bk], m, l, corr [TG].
__host__ __device__ inline size_t smem_floats(int TG, int DH, int bk) {
  return (size_t)2 * TG * DH + (size_t)bk * (DH + 1) + (size_t)TG * bk +
         bk + 3 * (size_t)TG;
}

template <typename QT, typename PT, int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                    const PT* __restrict__ vp,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ slots,
                    const int* __restrict__ lengths,
                    const int* __restrict__ prefix_slots,
                    const int* __restrict__ prefix_lens,
                    QT* __restrict__ out, int T, int H, int Hkv, int L,
                    int bk, int G, float scale) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y;
  const int TG = T * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q_sh = smem;
  float* acc_sh = q_sh + TG * DH;
  float* kv_sh = acc_sh + TG * DH;
  float* p_sh = kv_sh + bk * (DH + 1);
  float* sc_sh = p_sh + TG * bk;
  float* m_sh = sc_sh + bk;
  float* l_sh = m_sh + TG;
  float* corr_sh = l_sh + TG;

  const int len = lengths[s];
  const int slot = slots[s];
  const int prow = prefix_slots ? prefix_slots[s] : slot;
  const int plen = prefix_slots ? prefix_lens[s] : 0;
  const bool quantized = ksc != nullptr;

  for (int e = tid; e < TG * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int t = r / G, g = r % G;
    const size_t qi = (((size_t)s * T + t) * H + (size_t)h * G + g) * DH + d;
    q_sh[e] = widen(q[qi]) * scale;
    acc_sh[e] = 0.f;
  }
  for (int r = tid; r < TG; r += kThreads) {
    m_sh[r] = -INFINITY;
    l_sh[r] = 0.f;
  }
  __syncthreads();

  const int nb = L / bk;
  int last = (len + T - 1) / bk;
  if (last > nb - 1) last = nb - 1;
  for (int b = 0; b <= last; ++b) {
    const int row = ((b + 1) * bk <= plen) ? prow : slot;
    // flat index of the block's first (position) in [rows, Hkv, L]
    const size_t page = ((size_t)row * Hkv + h) * L + (size_t)b * bk;

    const PT* kb = kp + page * DH;
    for (int e = tid; e < bk * DH; e += kThreads)
      kv_sh[(e / DH) * (DH + 1) + e % DH] = widen(kb[e]);
    if (quantized)
      for (int j = tid; j < bk; j += kThreads) sc_sh[j] = ksc[page + j];
    __syncthreads();

    for (int e = tid; e < TG * bk; e += kThreads) {
      const int r = e / bk, j = e % bk;
      const float* qr = q_sh + r * DH;
      const float* kr = kv_sh + j * (DH + 1);
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) a = fmaf(qr[d], kr[d], a);
      if (quantized) a *= sc_sh[j];
      const int kpos = b * bk + j;
      p_sh[e] = (kpos <= len + r / G) ? a : -INFINITY;
    }
    __syncthreads();

    // K is consumed: the same buffer takes the V block
    const PT* vb = vp + page * DH;
    for (int e = tid; e < bk * DH; e += kThreads)
      kv_sh[(e / DH) * (DH + 1) + e % DH] = widen(vb[e]);
    if (quantized)
      for (int j = tid; j < bk; j += kThreads) sc_sh[j] = vsc[page + j];
    __syncthreads();

    // online softmax, one warp per q row.  Block 0 always holds key 0,
    // which every row may see, so m is finite from then on and no
    // exp(-inf - -inf) arises.
    for (int r = warp; r < TG; r += kWarps) {
      float* pr = p_sh + r * bk;
      float mx = -INFINITY;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float p = expf(pr[j] - m_new);
        sum += p;
        pr[j] = quantized ? p * sc_sh[j] : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr_sh[r] = c;
        l_sh[r] = l_sh[r] * c + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < TG * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      const float* pr = p_sh + r * bk;
      float a = 0.f;
      for (int j = 0; j < bk; ++j) a = fmaf(pr[j], kv_sh[j * (DH + 1) + d], a);
      acc_sh[e] = acc_sh[e] * corr_sh[r] + a;
    }
    __syncthreads();
  }

  for (int e = tid; e < TG * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int t = r / G, g = r % G;
    const size_t oi = (((size_t)s * T + t) * H + (size_t)h * G + g) * DH + d;
    narrow(out + oi, acc_sh[e] / l_sh[r]);
  }
}

template <typename QT, typename PT, int DH>
int launch(const void* q, const void* k, const void* v, const void* ksc,
           const void* vsc, const void* slots, const void* lengths,
           const void* prefix_slots, const void* prefix_lens, void* out,
           int S, int T, int H, int Hkv, int L, int bk, float scale,
           cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = smem_floats(T * G, DH, bk) * sizeof(float);
  auto kern = flash_decode_kernel<QT, PT, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(S, Hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(slots),
      static_cast<const int*>(lengths),
      static_cast<const int*>(prefix_slots),
      static_cast<const int*>(prefix_lens), static_cast<QT*>(out), T, H,
      Hkv, L, bk, G, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT>
int by_dh(int Dh, const void* q, const void* k, const void* v,
          const void* ksc, const void* vsc, const void* slots,
          const void* lengths, const void* ps, const void* pl, void* out,
          int S, int T, int H, int Hkv, int L, int bk, float scale,
          cudaStream_t st) {
  if (Dh == 64)
    return launch<QT, PT, 64>(q, k, v, ksc, vsc, slots, lengths, ps, pl, out,
                              S, T, H, Hkv, L, bk, scale, st);
  if (Dh == 128)
    return launch<QT, PT, 128>(q, k, v, ksc, vsc, slots, lengths, ps, pl,
                               out, S, T, H, Hkv, L, bk, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int by_page(int page_dtype, int Dh, const void* q, const void* k,
            const void* v, const void* ksc, const void* vsc,
            const void* slots, const void* lengths, const void* ps,
            const void* pl, void* out, int S, int T, int H, int Hkv, int L,
            int bk, float scale, cudaStream_t st) {
  switch (page_dtype) {
    case 0:
      return by_dh<QT, float>(Dh, q, k, v, ksc, vsc, slots, lengths, ps, pl,
                              out, S, T, H, Hkv, L, bk, scale, st);
    case 1:
      return by_dh<QT, __nv_bfloat16>(Dh, q, k, v, ksc, vsc, slots, lengths,
                                      ps, pl, out, S, T, H, Hkv, L, bk,
                                      scale, st);
    case 2:
      return by_dh<QT, int8_t>(Dh, q, k, v, ksc, vsc, slots, lengths, ps, pl,
                               out, S, T, H, Hkv, L, bk, scale, st);
    case 3:
      return by_dh<QT, __nv_fp8_e4m3>(Dh, q, k, v, ksc, vsc, slots, lengths,
                                      ps, pl, out, S, T, H, Hkv, L, bk,
                                      scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory bytes one CTA needs (the wrapper checks it against the
// card's 227 KB before launching).
size_t bf_flash_decode_smem_bytes(int TG, int Dh, int bk) {
  return smem_floats(TG, Dh, bk) * sizeof(float);
}

// q_dtype: 0 f32, 1 bf16.  page_dtype: 0 f32, 1 bf16, 2 int8, 3 e4m3.
// ksc/vsc are null for a raw store; prefix_slots/prefix_lens are null
// when no lane reads through a prefix page.
int bf_flash_decode(const void* q, const void* k, const void* v,
                    const void* ksc, const void* vsc, const void* slots,
                    const void* lengths, const void* prefix_slots,
                    const void* prefix_lens, void* out, int S, int T, int H,
                    int Hkv, int L, int Dh, int bk, float scale, int q_dtype,
                    int page_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return by_page<float>(page_dtype, Dh, q, k, v, ksc, vsc, slots, lengths,
                          prefix_slots, prefix_lens, out, S, T, H, Hkv, L,
                          bk, scale, st);
  if (q_dtype == 1)
    return by_page<__nv_bfloat16>(page_dtype, Dh, q, k, v, ksc, vsc, slots,
                                  lengths, prefix_slots, prefix_lens, out, S,
                                  T, H, Hkv, L, bk, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
