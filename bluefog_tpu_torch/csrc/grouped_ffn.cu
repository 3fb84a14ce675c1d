// Grouped expert FFN for dropless MoE on Hopper (sm_90a), expert-major
// on the tensor cores.
//
// Replaces the TPU kernel bluefog_tpu/ops/pallas_moe.py::_forward (kernel
// _grouped_kernel): for every row tile g of the expert-sorted buffer,
//
//     out[g] = gelu_tanh(xt[g] @ w1[tile_eid[g]]) @ w2[tile_eid[g]]
//
// with xt [G, tile, D], tile_eid [G] int32, w1 [E, D, F], w2 [E, F, D],
// f32 or bf16 operands (all alike), f32 accumulation, the output in xt's
// type.  Any tile size and any tile order.
//
// What bounds it: at decode the bytes (each named expert's w1 + w2,
// 2 * D * F * itemsize, 33.5 MB at D 1024, F 4096, f32), at a 512-token
// prefill the operations (4 * G * tile * D * F, at 495 / 3 = 165 TFLOP/s
// for f32-accurate 3xTF32 products).  The design:
//
//   * Two launches, no atomics, deterministic: (a) u = gelu(x @ w1) into
//     an f32 scratch u [G * tile, F], (b) out = u @ w2.  Both run the same
//     kernel, expert_rows.
//   * Expert-major blocks.  A block owns one expert e (blockIdx.y) and NC
//     output columns (blockIdx.x).  Its first warp scans tile_eid (the
//     TPU's scalar prefetch becomes these loads) and gathers e's rows, tile
//     after tile in tile_eid's order, into chunks of MR rows; the block
//     multiplies a chunk at a time, so the weight slice is read once per
//     chunk of rows, not once per tile.  When an expert holds more rows
//     than one chunk, `slots` blocks (blockIdx.z) share its chunks
//     round-robin, so a long reduction is not walked chunk after chunk by
//     one block.  A block without a chunk exits after the scan.  Any tile
//     order works; the dropless layout's sorted order only makes the
//     scan's hits contiguous.
//   * Filling the card.  The wrapper's plan picks MR from the rows an
//     expert holds on average (16, 32 or 64), slots = ceil(rows / MR) and,
//     per launch, the widest NC of 64, 32, 16 that still gives two blocks
//     per SM: at decode (D 1024, F 4096, 8 experts) the up-projection runs
//     512 blocks of 64 columns, the down-projection 512 of 16.  The block's
//     4 warps split the chunk's rows MR / 16 ways and the reduction the
//     rest (4, 2 or 1 ways): at MR 16 every warp takes a quarter of each
//     staged slab of the reduction, and the quarters' sums meet in shared
//     memory in warp order.
//   * Tensor cores.  f32 products are 3xTF32 mma.sync.m16n8k8 (see
//     hopper_common.cuh: f32 accurate; a stage's products go to a zeroed
//     fragment added to the running sum with round-to-nearest).  bf16
//     products (the up-projection of bf16 operands) are
//     mma.sync.m16n8k16.bf16 with f32 accumulation: exact products.  The
//     down-projection of bf16 weights reads the f32 u, so it is TF32 with
//     the weight exact (two MMAs a product).  Rows past the chunk's end
//     (a 2-row decode tile fills 2 of the 16 rows of a fragment) are
//     zero-filled in shared memory, never in device memory, and a warp
//     whose 16 rows all lie past it skips its products.
//   * Staging.  A stage is the chunk's rows x KB reduction entries and KB x
//     NC weights, copied by cp.async 16 bytes a thread, two or four stages
//     deep (see Geo).  D and F must be multiples of 8 (the wrapper pads
//     other widths).
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// c += a . b, bf16 operands, f32 accumulation; fragments of m16n8k16 with
// lane = 4 g + t: a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
// a3 (g + 8, 2t + 8..); b0 (k = 2t.., n = g), b1 (k = 2t + 8.., n = g);
// each register holds two neighbouring k, the lower k in the low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

// The block's geometry: MR rows, NC columns, WM warps over the rows and
// WK over the reduction; each warp takes 32 reduction entries of a stage
// of KB, and NS stages are in flight: two at MR 16 (128 entries a stage,
// up to five blocks an SM), four at MR 32 and 64 (64 and 32 entries a
// stage, whose compute is short: with one stage ahead, each waited out a
// whole memory latency).  Shared row strides (elements) keep every
// fragment read free of bank conflicts (A: 4 mod 32 words; B: 8 mod 32
// words f32, 4 mod 16 words bf16) and rows 16-byte aligned.
template <typename Tin, typename Tw, int MR, int NC> struct Geo {
  static constexpr int WM = MR / 16, WK = kWarps / WM;
  static constexpr int KW = 32, KB = KW * WK, NS = MR == 16 ? 2 : 4;
  static constexpr int SA = KB + 16 / (int)sizeof(Tin);
  static constexpr int SB = NC + 8;
  static constexpr int SR = NC + 4;                 // partial sums
  static constexpr size_t A_BYTES = (size_t)MR * SA * sizeof(Tin);
  static constexpr size_t B_BYTES = (size_t)KB * SB * sizeof(Tw);
  static constexpr size_t STAGE = A_BYTES + B_BYTES;
  static constexpr size_t RED = (size_t)WK * MR * SR * 4;
  static constexpr size_t SMEM = NS * STAGE > RED ? NS * STAGE : RED;
};

// out[row, n] = act(sum_k in[row, k] * w[e, k, n]) for the rows of
// expert e = blockIdx.y and the columns n0 .. n0 + NC - 1, n0 = blockIdx.x
// * NC: e's rows, taken tile after tile in tile_eid's order, form chunks
// of MR; the block takes chunks blockIdx.z, blockIdx.z + gridDim.z, ...
// in [G * tile, K], w [E, K, N], out [G * tile, N].
template <typename Tin, typename Tw, typename Tout, int MR, int NC,
          bool kGelu>
__global__ void __launch_bounds__(kThreads)
expert_rows(const Tin* __restrict__ in, const int* __restrict__ eid,
            const Tw* __restrict__ w, Tout* __restrict__ out, int G,
            int tile, int K, int N) {
  using Gm = Geo<Tin, Tw, MR, NC>;
  constexpr int WM = Gm::WM, WK = Gm::WK, KB = Gm::KB, SA = Gm::SA,
                SB = Gm::SB, SR = Gm::SR, NS = Gm::NS, KW = Gm::KW,
                NT = NC / 8;
  constexpr bool kBf16 = sizeof(Tin) == 2;          // bf16 x bf16 products
  constexpr bool kWExact = sizeof(Tw) == 2;         // bf16 weights in TF32
  constexpr int EA = 16 / (int)sizeof(Tin), CA = KB / EA;
  constexpr int EB = 16 / (int)sizeof(Tw), CB = NC / EB;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows_sh[MR];
  __shared__ int nrows_sh;

  const int e = blockIdx.y, n0 = blockIdx.x * NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wk = warp / WM;
  const Tw* we = w + (size_t)e * K * N;
  float* red = reinterpret_cast<float*>(smem);

  // warp 0's cursor over e's rows: the tile it is in, rows of it passed
  int cg = 0, cr = 0;
  // warp 0 passes up to `want` more of e's rows, recording them in
  // rows_sh when `keep`; returns how many it passed
  auto walk = [&](int want, bool keep) {
    int n = 0;
    while (n < want && cg < G) {
      if (cr == 0) {                   // the next tile of e at or after cg
        const int i = cg + lane;
        const unsigned hit = __ballot_sync(0xffffffffu,
                                           i < G && eid[i] == e);
        if (!hit) {
          cg += 32;
          continue;
        }
        cg += __ffs(hit) - 1;
      }
      const int take = min(tile - cr, want - n);
      if (keep)
        for (int i = lane; i < take; i += 32)
          rows_sh[n + i] = cg * tile + cr + i;
      n += take;
      cr += take;
      if (cr == tile) {
        cr = 0;
        ++cg;
      }
    }
    return n;
  };

  if (warp == 0) walk(blockIdx.z * MR, false);
  for (;;) {
    // -- gather the block's next chunk of expert e's rows ----------------
    if (warp == 0) {
      const int n = walk(MR, true);
      if (lane == 0) nrows_sh = n;
      walk((gridDim.z - 1) * MR, false);
    }
    __syncthreads();
    const int nrows = nrows_sh;
    if (nrows == 0) return;

    // -- stage ks: the rows' entries [k0, k0 + KB) and the weights --------
    auto stage = [&](int ks) {
      const int k0 = ks * KB;
      Tin* abuf = reinterpret_cast<Tin*>(smem + (ks % NS) * Gm::STAGE);
      Tw* bbuf = reinterpret_cast<Tw*>(smem + (ks % NS) * Gm::STAGE +
                                       Gm::A_BYTES);
      for (int c = tid; c < MR * CA; c += kThreads) {
        const int r = c / CA, kk = k0 + (c % CA) * EA;
        const bool ok = r < nrows && kk < K;
        const Tin* src =
            in + (size_t)rows_sh[ok ? r : 0] * K + (ok ? kk : 0);
        cp16(abuf + r * SA + (c % CA) * EA, src, ok);
      }
      for (int c = tid; c < KB * CB; c += kThreads) {
        const int kr = c / CB, nn = n0 + (c % CB) * EB;
        const bool ok = k0 + kr < K && nn < N;
        const Tw* src = we + (ok ? (size_t)(k0 + kr) * N + nn : 0);
        cp16(bbuf + kr * SB + (c % CB) * EB, src, ok);
      }
    };

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    const int nk = (K + KB - 1) / KB;
    const int r0 = wm * 16, kw0 = wk * KW;
    // NS - 1 stages ahead; a commit group for every stage, empty past nk
    for (int ks = 0; ks < NS - 1; ++ks) {
      if (ks < nk) stage(ks);
      cp_commit();
    }
    for (int ks = 0; ks < nk; ++ks) {
      if (ks + NS - 1 < nk) stage(ks + NS - 1);
      cp_commit();
      cp_wait<NS - 1>();               // stage ks has landed
      __syncthreads();
      const Tin* A =
          reinterpret_cast<const Tin*>(smem + (ks % NS) * Gm::STAGE);
      const Tw* B = reinterpret_cast<const Tw*>(smem + (ks % NS) * Gm::STAGE +
                                                Gm::A_BYTES);
      float d[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
      if (r0 >= nrows) {
        // this warp's 16 rows are all past the chunk's end: nothing to do
      } else if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < KW; kk += 16) {
          const int c0 = kw0 + kk;
          const Tin* ap = A + (r0 + g) * SA + c0 + 2 * t;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(ap);
          a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * SA);
          a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * SA + 8);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const Tw* bp = B + (c0 + 2 * t) * SB + n * 8 + g;
            mma_bf16(d[n], a, pack_bf16(bp, bp + SB),
                     pack_bf16(bp + 8 * SB, bp + 9 * SB));
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KW; kk += 8) {
          const int c0 = kw0 + kk;
          const Tin* ap = A + (r0 + g) * SA + c0 + t;
          const float av[4] = {widen(ap[0]), widen(ap[8 * SA]),
                               widen(ap[4]), widen(ap[8 * SA + 4])};
          FragA a;
#pragma unroll
          for (int i = 0; i < 4; ++i) split<false>(av[i], a.b[i], a.s[i]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const Tw* bp = B + (c0 + t) * SB + n * 8 + g;
            FragB b;
            split<kWExact>(widen(bp[0]), b.b[0], b.s[0]);
            split<kWExact>(widen(bp[4 * SB]), b.b[1], b.s[1]);
            mma3<false, kWExact>(d[n], a, b);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += d[n][i];
      __syncthreads();                 // the stage is free again
    }

    // -- the warps' partial sums meet in shared memory, in warp order -----
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* p = red + (wk * MR + r0 + g) * SR + n * 8 + 2 * t;
      p[0] = acc[n][0];
      p[1] = acc[n][1];
      p[8 * SR] = acc[n][2];
      p[8 * SR + 1] = acc[n][3];
    }
    __syncthreads();
    for (int i = tid; i < MR * NC; i += kThreads) {
      const int r = i / NC, c = i % NC;
      if (r >= nrows || n0 + c >= N) continue;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < WK; ++k) v += red[(k * MR + r) * SR + c];
      narrow(out + (size_t)rows_sh[r] * N + n0 + c, kGelu ? gelu_tanh(v) : v);
    }
    __syncthreads();                   // rows_sh and red free again
  }
}

template <typename Tin, typename Tw, typename Tout, int MR, int NC,
          bool kGelu>
int launch(const Tin* in, const int* eid, const Tw* w, Tout* out, int G,
           int tile, int E, int Z, int K, int N, cudaStream_t stream) {
  constexpr size_t smem = Geo<Tin, Tw, MR, NC>::SMEM;
  auto kern = expert_rows<Tin, Tw, Tout, MR, NC, kGelu>;
  static bool sized = false;    // dynamic + static shared memory may pass
  if (!sized) {                 // 48 KB: raise the limit once per kernel
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kern<<<dim3((N + NC - 1) / NC, E, Z), kThreads, smem, stream>>>(
      in, eid, w, out, G, tile, K, N);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tw, typename Tout, int MR, bool kGelu>
int by_cols(int NC, const Tin* in, const int* eid, const Tw* w, Tout* out,
            int G, int tile, int E, int Z, int K, int N, cudaStream_t st) {
  if (NC == 64)
    return launch<Tin, Tw, Tout, MR, 64, kGelu>(in, eid, w, out, G, tile,
                                                E, Z, K, N, st);
  if (NC == 32)
    return launch<Tin, Tw, Tout, MR, 32, kGelu>(in, eid, w, out, G, tile,
                                                E, Z, K, N, st);
  if (NC == 16)
    return launch<Tin, Tw, Tout, MR, 16, kGelu>(in, eid, w, out, G, tile,
                                                E, Z, K, N, st);
  return (int)cudaErrorInvalidValue;
}

template <typename Tin, typename Tw, typename Tout, bool kGelu>
int by_rows(int MR, int NC, const Tin* in, const int* eid, const Tw* w,
            Tout* out, int G, int tile, int E, int Z, int K, int N,
            cudaStream_t st) {
  if (MR == 16)
    return by_cols<Tin, Tw, Tout, 16, kGelu>(NC, in, eid, w, out, G, tile,
                                             E, Z, K, N, st);
  if (MR == 32)
    return by_cols<Tin, Tw, Tout, 32, kGelu>(NC, in, eid, w, out, G, tile,
                                             E, Z, K, N, st);
  if (MR == 64)
    return by_cols<Tin, Tw, Tout, 64, kGelu>(NC, in, eid, w, out, G, tile,
                                             E, Z, K, N, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* xt, const int* eid, const void* w1, const void* w2,
        float* u, void* out, int G, int tile, int E, int D, int F, int MR,
        int Z, int up_cols, int down_cols, cudaStream_t st) {
  const int e = by_rows<T, T, float, true>(
      MR, up_cols, static_cast<const T*>(xt), eid,
      static_cast<const T*>(w1), u, G, tile, E, Z, D, F, st);
  if (e != 0) return e;
  return by_rows<float, T, T, false>(MR, down_cols, u, eid,
                                     static_cast<const T*>(w2),
                                     static_cast<T*>(out), G, tile, E, Z, F,
                                     D, st);
}

}  // namespace

extern "C" {

// xt [G, tile, D], tile_eid [G] int32 (every id in [0, E)), w1 [E, D, F],
// w2 [E, F, D], u [G, tile, F] f32 scratch, out [G, tile, D]; D and F
// multiples of 8; dtype 0 = f32, 1 = bf16 (xt, w1, w2 and out alike).
// rows: the chunk of an expert's rows a block multiplies at once (16, 32
// or 64); slots: the blocks that share an expert's chunks for each column
// slice; up_cols / down_cols: the columns of a block in the up- and
// down-projection (16, 32 or 64).
int bf_grouped_ffn(const void* xt, const void* tile_eid, const void* w1,
                   const void* w2, void* u, void* out, int G, int tile,
                   int E, int D, int F, int rows, int slots, int up_cols,
                   int down_cols, int dtype, void* stream) {
  if (G < 1 || tile < 1 || E < 1 || E > 65535 || D < 8 || F < 8 ||
      D % 8 || F % 8 || slots < 1 || slots > 65535)
    return -1;
  const int* eid = static_cast<const int*>(tile_eid);
  float* uf = static_cast<float*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(xt, eid, w1, w2, uf, out, G, tile, E, D, F, rows,
                      slots, up_cols, down_cols, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(xt, eid, w1, w2, uf, out, G, tile, E, D, F,
                              rows, slots, up_cols, down_cols, st);
  return -2;
}

}  // extern "C"
