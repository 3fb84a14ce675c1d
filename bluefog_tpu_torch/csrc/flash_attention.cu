// Flash attention forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernels of bluefog_tpu/ops/pallas_attention.py:
//
//   flash_fwd       <- attention_block_partial  (kernel _partial_kernel)
//   flash_bwd_dkdv  \  attention_block_backward (kernel _backward_kernel)
//   flash_bwd_dq    /
//
// Same functions, rethought for the GPU.  Shapes: q [B, Tq, H, D], k/v
// [B, Tk, Hkv, D] (f32 or bf16, widened to f32 in shared memory), grouped
// query attention by index: q head h reads kv head h / (H / Hkv).  Masks
// come from the global offsets: with `causal`, key position koff + j is
// visible to query position qoff + i iff koff + j <= qoff + i and, with a
// window w > 0, qoff + i - (koff + j) < w.
//
// flash_fwd: one CTA per (b, h, tile of 64 q rows).  The TPU kernel holds
//   a whole [block_q, Tk] score tile in VMEM; here the CTA loops over K/V
//   tiles of 64 keys staged in shared memory with an f32 online softmax,
//   so the running max ends as the row max over all of Tk and o, l come
//   out relative to it, exactly as the TPU partial's do.  q is scaled
//   before the dot (as _partial_kernel does).  Rows with no visible key
//   write m = -inf, l = 0, o = 0.  Tiles wholly masked by the causal or
//   window mask are skipped: their terms are exact zeros.
//
// K2 (FlashAttention-2 backward, given the global lse and delta = rowsum
//   (do * out)).  The TPU accumulates dk/dv over a sequential grid axis;
//   a GPU grid runs in no order, so the backward is split in two kernels
//   and needs no atomics (runs are deterministic):
//   flash_bwd_dkdv: one CTA per (b, kv head, tile of 64 keys).  It loops
//     over the G q heads of its group and every q tile that sees the key
//     tile, recomputes s and p = exp(s * scale - lse) (0 where masked or
//     where lse = -inf), and accumulates dv += p^T do and
//     dk += scale * ds^T q with ds = p * (do v^T - delta) in registers.
//   flash_bwd_dq: one CTA per (b, h, tile of 64 q rows); loops over the
//     visible key tiles and accumulates dq += scale * ds k.
//   As on the TPU (_backward_kernel), the scale multiplies after the q.k
//   dot, then the mask, then the exponent.
//
// What bounds them: at the trainer's shape (q/k/v [4, 2048, 16, 64] f32,
// causal) the forward needs 4 * B * H * T (T + 1) / 2 * D = 3.4e10 FLOP,
// 0.51 ms at the card's 67 TFLOP/s f32 rate, against 0.04 ms of bytes, so
// it is bound by operations; the backward's five products are 2.5 times
// that.  With bf16 inputs the same products could run on the tensor cores
// (989 TFLOP/s).  These first kernels are SIMT: 256 threads, each owning a
// 4 x 4 block of the 64 x 64 score tile and 4 x D/16 of the output, with
// f32 FMAs from shared memory (padded rows, no bank conflicts), so they
// run well below either bound.  The backward also recomputes s and do.v^T
// in both kernels (7 products, not 5) to avoid atomics.  A later PR moves
// the products to mma.sync / wgmma (bf16 or TF32 where the caller allows
// it) and stages the tiles with cp.async / TMA so loads overlap math.
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // q rows and keys per tile
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kPP = kTile + 1;      // padded row stride of a 64 x 64 tile

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
};

// sum / max over the 16 lanes of a half warp (one tile row's threads)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [0, nvalid) of a [64, D] slice with the given row stride (elements)
// into a padded [64][D + 1] f32 tile; rows past nvalid are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int nvalid,
                                          float mul) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] =
        r < nvalid ? widen(src[(size_t)r * stride + d]) * mul : 0.f;
  }
}

// acc[r][c] += A[ty + 16 r][:] . B[tx + 16 c][:] over D, both tiles padded
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* Bt, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * DP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bt[(tx + 16 * c) * DP + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ l, float* __restrict__ m, int Tq, int Tk,
                 int H, int Hkv, float scale, Mask mask) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* Ps = Vs + kTile * DP;

  const int nqt = (Tq + kTile - 1) / kTile;
  const int qt = blockIdx.x % nqt, bh = blockIdx.x / nqt;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qt * kTile, nq = min(kTile, Tq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const T* kbase = k + ((size_t)b * Tk * Hkv + hk) * D;
  const T* vbase = v + ((size_t)b * Tk * Hkv + hk) * D;

  load_tile<T, D>(Qs, q + ((size_t)b * Tq * H + h) * D + q0 * qs, qs, nq,
                  scale);
  float acc[4][NC], mrow[4], lrow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    const int nk = min(kTile, Tk - k0);
    if (!mask.visible(q0, nq, k0, nk)) continue;      // uniform in the CTA
    __syncthreads();                                   // last tile consumed
    load_tile<T, D>(Ks, kbase + k0 * ks, ks, nk, 1.f);
    load_tile<T, D>(Vs, vbase + k0 * ks, ks, nk, 1.f);
    __syncthreads();

    float s[4][4] = {};
    dot_tile<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        if (j >= nk || !mask.keep(i, k0 + j)) s[r][c] = -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(mrow[r], mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[r][c] == -INFINITY ? 0.f : expf(s[r][c] - safe);
        s[r][c] = p;
        sum += p;
        Ps[(ty + 16 * r) * kPP + tx + 16 * c] = p;
      }
      sum = row_sum(sum);
      const float corr = mrow[r] == -INFINITY ? 0.f : expf(mrow[r] - safe);
      lrow[r] = lrow[r] * corr + sum;
      mrow[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(ty + 16 * r) * kPP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Tq) continue;
    const size_t row = ((size_t)b * Tq + i) * H + h;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[row * D + tx + 16 * c] = acc[r][c];
    if (tx == 0) {
      l[row] = lrow[r];
      m[row] = mrow[r];
    }
  }
}

// Loads the q-side operands of one (b, h, q tile): q, do, lse, delta.
// Rows past Tq get lse = -inf, so their p (and ds) are exact zeros.
template <typename T, int D>
__device__ __forceinline__ void load_q_side(
    float* Qs, float* dOs, float* Ls, float* Dl, const T* q,
    const float* dout, const float* lse, const float* delta, int b, int h,
    int q0, int nq, int Tq, int H) {
  const size_t qs = (size_t)H * D;
  const size_t base = ((size_t)b * Tq * H + h) * D + q0 * qs;
  load_tile<T, D>(Qs, q + base, qs, nq, 1.f);
  load_tile<float, D>(dOs, dout + base, qs, nq, 1.f);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const size_t row = ((size_t)b * Tq + q0 + i) * H + h;
    Ls[i] = i < nq ? lse[row] : -INFINITY;
    Dl[i] = i < nq ? delta[row] : 0.f;
  }
}

// p and ds of one (q tile, key tile) pair: rows ty + 16 r (queries),
// columns tx + 16 c (keys), written to the padded P / dS tiles
template <int D>
__device__ __forceinline__ void p_and_ds(float* Ps, float* dSs,
                                         const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         const float* Ls, const float* Dl,
                                         int q0, int k0, int nk, float scale,
                                         const Mask& mask, int ty, int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  dot_tile<D>(s, Qs, Ks, ty, tx);
  dot_tile<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const float L = Ls[i], dl = Dl[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const bool ok =
          j < nk && L != -INFINITY && mask.keep(q0 + i, k0 + j);
      const float p = ok ? expf(s[r][c] * scale - L) : 0.f;
      if (Ps) Ps[i * kPP + j] = p;
      dSs[i * kPP + j] = p * (dp[r][c] - dl);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Tq,
                      int Tk, int H, int Hkv, float scale, Mask mask) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * DP;
  float* Qs = Vs + kTile * DP;
  float* dOs = Qs + kTile * DP;
  float* Ps = dOs + kTile * DP;
  float* dSs = Ps + kTile * kPP;
  float* Ls = dSs + kTile * kPP;
  float* Dl = Ls + kTile;

  const int nkt = (Tk + kTile - 1) / kTile;
  const int kt = blockIdx.x % nkt, bhk = blockIdx.x / nkt;
  const int b = bhk / Hkv, hk = bhk % Hkv, G = H / Hkv;
  const int k0 = kt * kTile, nk = min(kTile, Tk - k0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t ks = (size_t)Hkv * D;
  const size_t kbase = ((size_t)b * Tk * Hkv + hk) * D + k0 * ks;
  load_tile<T, D>(Ks, k + kbase, ks, nk, 1.f);
  load_tile<T, D>(Vs, v + kbase, ks, nk, 1.f);

  float dka[4][NC] = {}, dva[4][NC] = {};     // key rows ty + 16 r
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = 0; q0 < Tq; q0 += kTile) {
      const int nq = min(kTile, Tq - q0);
      if (!mask.visible(q0, nq, k0, nk)) continue;
      __syncthreads();
      load_q_side<T, D>(Qs, dOs, Ls, Dl, q, dout, lse, delta, b, h, q0, nq,
                        Tq, H);
      __syncthreads();
      p_and_ds<D>(Ps, dSs, Qs, dOs, Ks, Vs, Ls, Dl, q0, k0, nk, scale, mask,
                  ty, tx);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        float dov[NC], qv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dOs[i * DP + tx + 16 * c];
          qv[c] = Qs[i * DP + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = Ps[i * kPP + ty + 16 * r];
          const float ds = dSs[i * kPP + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dva[r][c] = fmaf(p, dov[c], dva[r][c]);
            dka[r][c] = fmaf(ds, qv[c], dka[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= Tk) continue;
    const size_t row = (((size_t)b * Tk + j) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row + tx + 16 * c] = dka[r][c] * scale;
      dv[row + tx + 16 * c] = dva[r][c];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int H, int Hkv, float scale, Mask mask) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * DP;
  float* Ks = dOs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* dSs = Vs + kTile * DP;
  float* Ls = dSs + kTile * kPP;
  float* Dl = Ls + kTile;

  const int nqt = (Tq + kTile - 1) / kTile;
  const int qt = blockIdx.x % nqt, bh = blockIdx.x / nqt;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qt * kTile, nq = min(kTile, Tq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t ks = (size_t)Hkv * D;
  const T* kbase = k + ((size_t)b * Tk * Hkv + hk) * D;
  const T* vbase = v + ((size_t)b * Tk * Hkv + hk) * D;
  load_q_side<T, D>(Qs, dOs, Ls, Dl, q, dout, lse, delta, b, h, q0, nq, Tq,
                    H);

  float dqa[4][NC] = {};                       // q rows ty + 16 r
  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    const int nk = min(kTile, Tk - k0);
    if (!mask.visible(q0, nq, k0, nk)) continue;
    __syncthreads();
    load_tile<T, D>(Ks, kbase + k0 * ks, ks, nk, 1.f);
    load_tile<T, D>(Vs, vbase + k0 * ks, ks, nk, 1.f);
    __syncthreads();
    p_and_ds<D>(nullptr, dSs, Qs, dOs, Ks, Vs, Ls, Dl, q0, k0, nk, scale,
                mask, ty, tx);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[j * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = dSs[(ty + 16 * r) * kPP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) dqa[r][c] = fmaf(ds, kv[c], dqa[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Tq) continue;
    const size_t row = (((size_t)b * Tq + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[row + tx + 16 * c] = dqa[r][c] * scale;
  }
}

// shared memory of each kernel, in bytes
template <int D> constexpr size_t fwd_smem() {
  return (3 * (size_t)kTile * (D + 1) + (size_t)kTile * kPP) * sizeof(float);
}
template <int D> constexpr size_t dkdv_smem() {
  return (4 * (size_t)kTile * (D + 1) + 2 * (size_t)kTile * kPP + 2 * kTile) *
         sizeof(float);
}
template <int D> constexpr size_t dq_smem() {
  return (4 * (size_t)kTile * (D + 1) + (size_t)kTile * kPP + 2 * kTile) *
         sizeof(float);
}

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
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kern, fwd_smem<D>());
  if (e != cudaSuccess) return (int)e;
  kern<<<B * H * ceil_div(Tq, kTile), kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o),
      static_cast<float*>(l), static_cast<float*>(m), Tq, Tk, H, Hkv, scale,
      mask);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int B, int Tq, int Tk, int H, int Hkv, float scale, Mask mask,
        cudaStream_t st) {
  auto kv_kern = flash_bwd_dkdv_kernel<T, D>;
  auto q_kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = allow_smem(kv_kern, dkdv_smem<D>());
  if (e == cudaSuccess) e = allow_smem(q_kern, dq_smem<D>());
  if (e != cudaSuccess) return (int)e;
  kv_kern<<<B * Hkv * ceil_div(Tk, kTile), kThreads, dkdv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, H, Hkv,
      scale, mask);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q_kern<<<B * H * ceil_div(Tq, kTile), kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Tq, Tk, H, Hkv, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16 (q, k and v share it).  D is 64 or 128.  Outputs
// are f32: o [B, Tq, H, D], l and m [B, Tq, H].
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
  return (int)cudaErrorInvalidValue;
}

// dout, lse and delta are f32; dq [B, Tq, H, D] and dk/dv [B, Tk, Hkv, D]
// are written in f32.  Launches flash_bwd_dkdv, then flash_bwd_dq.
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
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
