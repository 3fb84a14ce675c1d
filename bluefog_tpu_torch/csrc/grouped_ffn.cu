// Grouped expert FFN for dropless MoE on Hopper (sm_90a).
//
// Replaces the TPU kernel bluefog_tpu/ops/pallas_moe.py::_forward (kernel
// _grouped_kernel): for every row tile g of the expert-sorted buffer,
//
//     out[g] = gelu_tanh(xt[g] @ w1[tile_eid[g]]) @ w2[tile_eid[g]]
//
// with xt [G, tile, D], tile_eid [G] int32, w1 [E, D, F], w2 [E, F, D],
// f32 or bf16 operands (all alike), f32 accumulation, the output in xt's
// type.  Same function, rethought for the GPU:
//
//   * Two launches, no atomics, deterministic.  (a) the up-projection and
//     gelu: one block per (tile g, slice of F columns) writes the f32
//     scratch u [G, tile, F]; (b) the down-projection: one block per
//     (tile g, slice of D columns) reads u.  The TPU runs its grid (G,)
//     in order on one core; a GPU grid of G blocks would leave most of the
//     132 SMs idle at decode (G = 12 tiles for 8 lanes x top-2 over 8
//     experts), so each pass also splits the output columns: the block
//     width (128, 64 or 32 columns) is the widest that still gives at
//     least four blocks per SM.  A block is always 128 threads: with
//     fewer columns its warps split the reduction (2 or 4 ways, strided),
//     and the partial sums meet in shared memory in a fixed order.
//   * Each block reads its tile's expert id itself (the TPU's scalar
//     prefetch becomes one load).  Threads own neighbouring output
//     columns, so every row of w1[e] / w2[e] is read coalesced.  The
//     block stages R rows of its input (x or u) in shared memory, 256
//     reduction entries at a time, and each thread keeps R f32 sums in
//     registers: every weight it loads feeds R FMAs.  R is the tile rounded
//     up to a power of two, at most 8; longer tiles loop over R-row chunks.
//   * No padding to 8 rows (a TPU sublane rule): ``tile`` is a loop bound
//     and any positive tile works.  Every tile is computed, including the
//     tail tiles the layout clamps to the last expert: their rows are
//     zeros, so their outputs are zeros.
//
// What bounds it: at serving shapes it is memory bound.  One expert's
// w1 + w2 is 2 * D * F * itemsize (33.5 MB at D 1024, F 4096, f32), and
// the least the function must read is that for each distinct expert the
// tiles name; the FLOPs are 4 * G * tile * D * F.  At decode (G 12,
// tile 2) that is 268 MB against 0.40 GFLOP, so bytes bound it (80 us at
// 3.35 TB/s).  This first version has one block per tile and column
// slice, so every tile re-reads its expert's weights: 12 tiles read 403
// MB at decode, and the 135 tiles of a 512-token prefill read 4.5 GB
// unless L2 (50 MB, about one expert's pair) catches the repeats.  The
// products run on the CUDA cores in f32.  A later version walks all tiles
// of one expert in one block so its weights are read once, stages them
// with cp.async / TMA, and runs bf16 products on the tensor cores.
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;       // reduction entries staged per pass
constexpr int kMaxRows = 8;       // rows of one register block
constexpr int kFillBlocks = 4 * 132;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True), torch's approximate="tanh"
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// out[g, r, n] = act(sum_k in[g, r, k] * w[eid[g], k, n]) for the block's
// tile g = blockIdx.y and columns blockIdx.x * cols .. + cols - 1, with
// cols = kThreads / KS; thread t owns column t % cols and the reduction
// entries k = t / cols (mod KS).  KS is a template parameter so the
// strided loop keeps a constant stride the compiler can pipeline.
template <typename Tin, typename Tw, typename Tout, int R, int KS,
          bool kGelu>
__global__ void __launch_bounds__(kThreads)
grouped_rows(const Tin* __restrict__ in, const int* __restrict__ eid,
             const Tw* __restrict__ w, Tout* __restrict__ out, int tile,
             int K, int N) {
  constexpr int cols = kThreads / KS;
  __shared__ float xs[R * kChunk];
  __shared__ float part[KS > 1 ? kThreads * R : 1];  // [KS][R][cols]
  // without a split the loop starts at a constant 0: from a start it
  // cannot see, the compiler does not pipeline the loads as well
  const int c = threadIdx.x % cols, ks = KS == 1 ? 0 : threadIdx.x / cols;
  const int g = blockIdx.y;
  const int n = blockIdx.x * cols + c;
  const bool live = n < N;
  const Tin* xg = in + (size_t)g * tile * K;
  const Tw* wg = w + (size_t)eid[g] * K * N;
  for (int r0 = 0; r0 < tile; r0 += R) {
    const int nr = min(R, tile - r0);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int nk = min(kChunk, K - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
        const int r = i / kChunk, k = i - r * kChunk;
        xs[i] = (r < nr && k < nk)
                    ? widen(xg[(size_t)(r0 + r) * K + k0 + k]) : 0.f;
      }
      __syncthreads();
      if (live) {
        const Tw* wk = wg + (size_t)k0 * N + n;
#pragma unroll 8
        for (int k = ks; k < nk; k += KS) {
          const float wv = widen(wk[(size_t)k * N]);
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(xs[r * kChunk + k], wv, acc[r]);
        }
      }
    }
    if (KS > 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) part[(ks * R + r) * cols + c] = acc[r];
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int j = 0; j < KS; ++j) acc[r] += part[(j * R + r) * cols + c];
        }
      }
    }
    if (ks == 0 && live) {
      Tout* og = out + ((size_t)g * tile + r0) * N + n;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) narrow(og + (size_t)r * N, kGelu ? gelu_tanh(acc[r])
                                                     : acc[r]);
    }
  }
}

// Reduction split of a pass over N output columns: the fewest ways (1, 2
// or 4, giving 128-, 64- or 32-column blocks) that still make at least
// four blocks per SM.
int split_for(int N, int G) {
  for (int ks = 1; ks < 4; ks *= 2) {
    const int cols = kThreads / ks;
    if ((long long)((N + cols - 1) / cols) * G >= kFillBlocks) return ks;
  }
  return 4;
}

template <typename Tin, typename Tw, typename Tout, int R, bool kGelu>
int pass(const Tin* in, const int* eid, const Tw* w, Tout* out, int G,
         int tile, int K, int N, cudaStream_t stream) {
  const int ks = split_for(N, G), cols = kThreads / ks;
  const dim3 grid((N + cols - 1) / cols, G);
  if (ks == 1)
    grouped_rows<Tin, Tw, Tout, R, 1, kGelu>
        <<<grid, kThreads, 0, stream>>>(in, eid, w, out, tile, K, N);
  else if (ks == 2)
    grouped_rows<Tin, Tw, Tout, R, 2, kGelu>
        <<<grid, kThreads, 0, stream>>>(in, eid, w, out, tile, K, N);
  else
    grouped_rows<Tin, Tw, Tout, R, 4, kGelu>
        <<<grid, kThreads, 0, stream>>>(in, eid, w, out, tile, K, N);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int run(const void* xt, const int* eid, const void* w1, const void* w2,
        float* u, void* out, int G, int tile, int D, int F,
        cudaStream_t stream) {
  const int e = pass<T, T, float, R, true>(
      static_cast<const T*>(xt), eid, static_cast<const T*>(w1), u, G, tile,
      D, F, stream);
  if (e != 0) return e;
  return pass<float, T, T, R, false>(u, eid, static_cast<const T*>(w2),
                                     static_cast<T*>(out), G, tile, F, D,
                                     stream);
}

template <typename T>
int dispatch_rows(const void* xt, const int* eid, const void* w1,
                  const void* w2, float* u, void* out, int G, int tile,
                  int D, int F, cudaStream_t stream) {
  const int rows = tile < kMaxRows ? tile : kMaxRows;
  if (rows <= 1) return run<T, 1>(xt, eid, w1, w2, u, out, G, tile, D, F,
                                   stream);
  if (rows <= 2) return run<T, 2>(xt, eid, w1, w2, u, out, G, tile, D, F,
                                   stream);
  if (rows <= 4) return run<T, 4>(xt, eid, w1, w2, u, out, G, tile, D, F,
                                   stream);
  return run<T, 8>(xt, eid, w1, w2, u, out, G, tile, D, F, stream);
}

}  // namespace

extern "C" {

// xt [G, tile, D], tile_eid [G] int32 (every id in [0, E)), w1 [E, D, F],
// w2 [E, F, D], u [G, tile, F] f32 scratch, out [G, tile, D];
// dtype 0 = f32, 1 = bf16 (xt, w1, w2 and out alike).
int bf_grouped_ffn(const void* xt, const void* tile_eid, const void* w1,
                   const void* w2, void* u, void* out, int G, int tile,
                   int D, int F, int dtype, void* stream) {
  if (G < 1 || tile < 1 || D < 1 || F < 1 || G > 65535) return -1;
  const int* eid = static_cast<const int*>(tile_eid);
  float* uf = static_cast<float*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_rows<float>(xt, eid, w1, w2, uf, out, G, tile, D, F,
                                st);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(xt, eid, w1, w2, uf, out, G, tile,
                                        D, F, st);
  return -2;
}

}  // extern "C"
