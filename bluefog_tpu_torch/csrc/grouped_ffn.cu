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
// The backward (replaces the plain-XLA custom_vjp backward
// bluefog_tpu/ops/pallas_moe.py::_grouped_bwd, which gathers w1[tile_eid]
// and w2[tile_eid] per tile and scatter-adds per-tile weight gradients):
// with s = xt @ w1[e] kept by the forward (f32, [G * tile, F]) and g the
// output's cotangent,
//
//     ds  = (g @ w2[e]^T) * gelu'(s),  u = gelu(s)       (dgrad, launch 1)
//     dxt = ds @ w1[e]^T                                  (dgrad, launch 2)
//     dw1[e] = sum over e's rows of xt^T ds,  dw2[e] = of u^T g   (wgrad)
//
// What bounds it: the operations, 8 * G * tile * D * F at the 3xTF32
// rate, as the forward's prefill.  The design:
//
//   * dgrad runs the forward's expert_rows with the weights read
//     transposed (kWT: a stage holds NC weight rows of KB entries, laid
//     out as an A tile, so the fragment reads stay conflict free), and an
//     epilogue that reads s and writes ds and u (u is rebuilt here, not
//     kept by the forward: one f32 [rows, F] buffer less held per layer).
//   * wgrad, expert_wgrad: one block per (expert, 64 x 64 tile of dw,
//     split).  Its first warp walks the expert's rows in tile_eid's order
//     as the forward's does, 128 rows a chunk, and the block sums A^T B
//     over them, 32 rows a cp.async stage, two stages deep, each stage's
//     products into a zeroed fragment added with round-to-nearest.  When
//     the plan gives too few blocks for the card, `splits` blocks take an
//     expert's chunks round-robin into an f32 scratch [splits, E, M, N]
//     and a second launch adds the splits in split order.  No atomics: two
//     runs are bit-identical.  A block whose expert has no rows writes an
//     exact zero.  The clamped tail tiles of the dropless layout hold zero
//     rows of xt and of g, so they add exact zeros.
//   * Nothing reads tile_eid on the host; the plans come from shapes.
//   * Stacked peers: the weights may be [P, E, D, F] with any stride
//     between peers (a layer's slice of a stacked parameter) and ids in
//     [0, P * E); expert e reads peer e / E's block e % E, so the folded
//     call copies no weight.  The backward is f32 only.
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  // d/dx of gelu_tanh, torch's GeluBackward (approximate="tanh") formula
  const float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
  const float t = tanhf(kBeta * (x + kKappa * x * x * x));
  return 0.5f * (1.f + t) +
         0.5f * x * (1.f - t * t) * kBeta * (1.f + 3.f * kKappa * x * x);
}

// the epilogue of expert_rows: store v; gelu(v) (and v into aux when it
// is not null: the pre-activation the backward needs); or v * gelu'(s)
// with u = gelu(s) into aux (the dgrad's first launch)
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_DGELU = 2 };

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
//
// kWT (the weights read transposed, w [E, N, K]): a stage holds NC weight
// rows of KB entries with the A tile's stride rule (SBT), so the fragment
// reads (k = t, n = g) are conflict free as A's are.
template <typename Tin, typename Tw, int MR, int NC, bool kWT = false>
struct Geo {
  static constexpr int WM = MR / 16, WK = kWarps / WM;
  static constexpr int KW = 32, KB = KW * WK, NS = MR == 16 ? 2 : 4;
  static constexpr int SA = KB + 16 / (int)sizeof(Tin);
  static constexpr int SB = NC + 8;
  static constexpr int SBT = KB + 16 / (int)sizeof(Tw);
  static constexpr int SR = NC + 4;                 // partial sums
  static constexpr size_t A_BYTES = (size_t)MR * SA * sizeof(Tin);
  static constexpr size_t B_BYTES =
      kWT ? (size_t)NC * SBT * sizeof(Tw) : (size_t)KB * SB * sizeof(Tw);
  static constexpr size_t STAGE = A_BYTES + B_BYTES;
  static constexpr size_t RED = (size_t)WK * MR * SR * 4;
  static constexpr size_t SMEM = NS * STAGE > RED ? NS * STAGE : RED;
};

// out[row, n] = act(sum_k in[row, k] * w[e, k, n]) for the rows of
// expert e = blockIdx.y and the columns n0 .. n0 + NC - 1, n0 = blockIdx.x
// * NC: e's rows, taken tile after tile in tile_eid's order, form chunks
// of MR; the block takes chunks blockIdx.z, blockIdx.z + gridDim.z, ...
// in [G * tile, K], w [E, K, N] (kWT: [E, N, K]), out [G * tile, N]; expert
// e's weights start at (e / epp) * pstride + (e % epp) * K * N (stacked
// peers of epp experts each, pstride elements apart); s [G * tile, N] is
// read and aux [G * tile, N] written by the epilogues above.
template <typename Tin, typename Tw, typename Tout, int MR, int NC,
          int kEpi, bool kWT>
__global__ void __launch_bounds__(kThreads)
expert_rows(const Tin* __restrict__ in, const int* __restrict__ eid,
            const Tw* __restrict__ w, Tout* __restrict__ out,
            const float* __restrict__ s, float* __restrict__ aux, int G,
            int tile, int K, int N, int epp, long long pstride) {
  using Gm = Geo<Tin, Tw, MR, NC, kWT>;
  constexpr int WM = Gm::WM, WK = Gm::WK, KB = Gm::KB, SA = Gm::SA,
                SB = Gm::SB, SBT = Gm::SBT, SR = Gm::SR, NS = Gm::NS,
                KW = Gm::KW, NT = NC / 8;
  constexpr bool kBf16 = sizeof(Tin) == 2;          // bf16 x bf16 products
  constexpr bool kWExact = sizeof(Tw) == 2;         // bf16 weights in TF32
  static_assert(!kWT || (!kBf16 && !kWExact), "kWT is f32 only");
  constexpr int EA = 16 / (int)sizeof(Tin), CA = KB / EA;
  constexpr int EB = 16 / (int)sizeof(Tw), CB = NC / EB, CBT = KB / EB;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows_sh[MR];
  __shared__ int nrows_sh;

  const int e = blockIdx.y, n0 = blockIdx.x * NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wk = warp / WM;
  // expert e's weights (stacked peers: epp experts a peer, pstride
  // elements apart), computed once into shared memory and read by each
  // stage: a pointer held in registers across the loop, rebuilt from the
  // division and the 64-bit product, made the up-projection spill
  __shared__ long long we_off;
  if (tid == 0)
    we_off = (long long)(e / epp) * pstride + (long long)(e % epp) * K * N;
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
      const Tw* we = w + *(volatile long long*)&we_off;
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
      if constexpr (kWT) {
        for (int c = tid; c < NC * CBT; c += kThreads) {
          const int nr = c / CBT, kk = k0 + (c % CBT) * EB;
          const bool ok = n0 + nr < N && kk < K;
          const Tw* src = we + (ok ? (size_t)(n0 + nr) * K + kk : 0);
          cp16(bbuf + nr * SBT + (c % CBT) * EB, src, ok);
        }
      } else {
        for (int c = tid; c < KB * CB; c += kThreads) {
          const int kr = c / CB, nn = n0 + (c % CB) * EB;
          const bool ok = k0 + kr < K && nn < N;
          const Tw* src = we + (ok ? (size_t)(k0 + kr) * N + nn : 0);
          cp16(bbuf + kr * SB + (c % CB) * EB, src, ok);
        }
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
            FragB b;
            if constexpr (kWT) {
              const Tw* bp = B + (n * 8 + g) * SBT + c0 + t;
              split<kWExact>(widen(bp[0]), b.b[0], b.s[0]);
              split<kWExact>(widen(bp[4]), b.b[1], b.s[1]);
            } else {
              const Tw* bp = B + (c0 + t) * SB + n * 8 + g;
              split<kWExact>(widen(bp[0]), b.b[0], b.s[0]);
              split<kWExact>(widen(bp[4 * SB]), b.b[1], b.s[1]);
            }
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
      const size_t o = (size_t)rows_sh[r] * N + n0 + c;
      if constexpr (kEpi == EPI_GELU) {
        narrow(out + o, gelu_tanh(v));
        if (aux) aux[o] = v;
      } else if constexpr (kEpi == EPI_DGELU) {
        const float sv = s[o];
        narrow(out + o, v * gelu_tanh_grad(sv));
        aux[o] = gelu_tanh(sv);
      } else {
        narrow(out + o, v);
      }
    }
    __syncthreads();                   // rows_sh and red free again
  }
}

// -- expert_wgrad: dw[e] = sum over e's rows of a^T b ---------------------

constexpr int WG_MT = 64, WG_NT = 64;   // a block's tile of dw
constexpr int WG_KR = 32;               // rows a cp.async stage
constexpr int WG_CH = 128;              // rows a gathered chunk
constexpr int WG_NS = 2;                // stages in flight
// row strides 8 mod 32 words: the fragment reads (k = t, m or n = g) hit
// 32 distinct banks; rows stay 16-byte aligned
constexpr int WG_SA = WG_MT + 8, WG_SB = WG_NT + 8;
constexpr size_t WG_STAGE = (size_t)WG_KR * (WG_SA + WG_SB) * 4;
constexpr size_t WG_SMEM = WG_NS * WG_STAGE;         // 36,864 bytes

// out[e, m, n] for the block's 64 x 64 tile (blockIdx.x over tiles_n
// columns of tiles), expert e = blockIdx.y: the sum over e's rows r, taken
// tile after tile in tile_eid's order, 128 a chunk, chunks blockIdx.z,
// blockIdx.z + gridDim.z, ... of a[r, m] * b[r, n].  a [G * tile, M],
// b [G * tile, N], f32, M and N multiples of 4; out [gridDim.z, E, M, N]
// (split s's partial sums at s; the whole sum when gridDim.z is 1).  The
// 4 warps own 32 x 32 quarters of the tile.
__global__ void __launch_bounds__(kThreads)
expert_wgrad(const float* __restrict__ a, const float* __restrict__ b,
             const int* __restrict__ eid, float* __restrict__ out, int G,
             int tile, int M, int N, int tiles_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows_sh[WG_CH];
  __shared__ int nrows_sh;
  const int e = blockIdx.y, E = gridDim.y;
  const int m0 = (blockIdx.x / tiles_n) * WG_MT;
  const int n0 = (blockIdx.x % tiles_n) * WG_NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  // warp 0's cursor over e's rows, as in expert_rows; the scan for the
  // next tile of e reads 128 ids a round, four loads in flight a lane
  int cg = 0, cr = 0;
  auto walk = [&](int want, bool keep) {
    int n = 0;
    while (n < want && cg < G) {
      if (cr == 0) {
        int ids[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = cg + j * 32 + lane;
          ids[j] = i < G ? eid[i] : -1;
        }
        int found = -1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned hit = __ballot_sync(0xffffffffu, ids[j] == e);
          if (found < 0 && hit) found = j * 32 + __ffs(hit) - 1;
        }
        if (found < 0) {
          cg += 128;
          continue;
        }
        cg += found;
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

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (warp == 0) walk(blockIdx.z * WG_CH, false);
  for (;;) {
    if (warp == 0) {
      const int n = walk(WG_CH, true);
      if (lane == 0) nrows_sh = n;
      walk((gridDim.z - 1) * WG_CH, false);
    }
    __syncthreads();
    const int nrows = nrows_sh;
    if (nrows == 0) break;
    const int nst = (nrows + WG_KR - 1) / WG_KR;

    auto stage = [&](int ks) {
      float* as = reinterpret_cast<float*>(smem + (ks % WG_NS) * WG_STAGE);
      float* bs = as + WG_KR * WG_SA;
      for (int c = tid; c < WG_KR * (WG_MT / 4); c += kThreads) {
        const int r = c / (WG_MT / 4), mm = m0 + (c % (WG_MT / 4)) * 4;
        const int rr = ks * WG_KR + r;
        const bool ok = rr < nrows && mm < M;
        cp16(as + r * WG_SA + (c % (WG_MT / 4)) * 4,
             a + (ok ? (size_t)rows_sh[rr] * M + mm : 0), ok);
      }
      for (int c = tid; c < WG_KR * (WG_NT / 4); c += kThreads) {
        const int r = c / (WG_NT / 4), nn = n0 + (c % (WG_NT / 4)) * 4;
        const int rr = ks * WG_KR + r;
        const bool ok = rr < nrows && nn < N;
        cp16(bs + r * WG_SB + (c % (WG_NT / 4)) * 4,
             b + (ok ? (size_t)rows_sh[rr] * N + nn : 0), ok);
      }
    };

    stage(0);
    cp_commit();
    for (int ks = 0; ks < nst; ++ks) {
      if (ks + 1 < nst) stage(ks + 1);
      cp_commit();
      cp_wait<1>();                    // stage ks has landed
      __syncthreads();
      const float* as =
          reinterpret_cast<const float*>(smem + (ks % WG_NS) * WG_STAGE);
      const float* bs = as + WG_KR * WG_SA;
      float d[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[i][j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < WG_KR; kk += 8) {
        // A (m x k) is a^T: a0 (m g, k t), a1 (m g + 8, k t), a2 (m g,
        // k t + 4), a3 (m g + 8, k t + 4), read from the [k][m] stage
        FragA fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* ap = as + (kk + t) * WG_SA + wm + i * 16 + g;
          const float av[4] = {ap[0], ap[8], ap[4 * WG_SA],
                               ap[4 * WG_SA + 8]};
#pragma unroll
          for (int q = 0; q < 4; ++q) split<false>(av[q], fa[i].b[q],
                                                   fa[i].s[q]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bp = bs + (kk + t) * WG_SB + wn + j * 8 + g;
          FragB fb;
          split<false>(bp[0], fb.b[0], fb.s[0]);
          split<false>(bp[4 * WG_SB], fb.b[1], fb.s[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma3<false, false>(d[i][j], fa[i], fb);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += d[i][j][q];
      __syncthreads();                 // the stage (and rows_sh) free again
    }
  }

  float* o = out + ((size_t)blockIdx.z * E + e) * (size_t)M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm + i * 16 + g, col = n0 + wn + j * 8 + 2 * t;
      if (col >= N) continue;          // N is a multiple of 4: col + 1 too
      if (row < M) {
        o[(size_t)row * N + col] = acc[i][j][0];
        o[(size_t)row * N + col + 1] = acc[i][j][1];
      }
      if (row + 8 < M) {
        o[(size_t)(row + 8) * N + col] = acc[i][j][2];
        o[(size_t)(row + 8) * N + col + 1] = acc[i][j][3];
      }
    }
}

// out[i] = sum over s = 0 .. splits - 1, in that order, of part[s, i]
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, long long n,
                           int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[(size_t)s * n + i];
    out[i] = v;
  }
}

// -- launches --------------------------------------------------------------

struct Rows {
  const void* in;
  const int* eid;
  const void* w;
  void* out;
  const float* s;
  float* aux;
  int G, tile, E, Z, K, N, epp;
  long long pstride;
};

template <typename Tin, typename Tw, typename Tout, int MR, int NC,
          int kEpi, bool kWT>
int launch(const Rows& a, cudaStream_t stream) {
  constexpr size_t smem = Geo<Tin, Tw, MR, NC, kWT>::SMEM;
  auto kern = expert_rows<Tin, Tw, Tout, MR, NC, kEpi, kWT>;
  static bool sized = false;    // dynamic + static shared memory may pass
  if (!sized) {                 // 48 KB: raise the limit once per kernel
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kern<<<dim3((a.N + NC - 1) / NC, a.E, a.Z), kThreads, smem, stream>>>(
      static_cast<const Tin*>(a.in), a.eid, static_cast<const Tw*>(a.w),
      static_cast<Tout*>(a.out), a.s, a.aux, a.G, a.tile, a.K, a.N, a.epp,
      a.pstride);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tw, typename Tout, int MR, int kEpi,
          bool kWT>
int by_cols(int NC, const Rows& a, cudaStream_t st) {
  if (NC == 64) return launch<Tin, Tw, Tout, MR, 64, kEpi, kWT>(a, st);
  if (NC == 32) return launch<Tin, Tw, Tout, MR, 32, kEpi, kWT>(a, st);
  if (NC == 16) return launch<Tin, Tw, Tout, MR, 16, kEpi, kWT>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename Tin, typename Tw, typename Tout, int kEpi,
          bool kWT = false>
int by_rows(int MR, int NC, const Rows& a, cudaStream_t st) {
  if (MR == 16) return by_cols<Tin, Tw, Tout, 16, kEpi, kWT>(NC, a, st);
  if (MR == 32) return by_cols<Tin, Tw, Tout, 32, kEpi, kWT>(NC, a, st);
  if (MR == 64) return by_cols<Tin, Tw, Tout, 64, kEpi, kWT>(NC, a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* xt, const int* eid, const void* w1, const void* w2,
        float* u, float* s, void* out, int G, int tile, int E, int epp,
        long long p1, long long p2, int D, int F, int MR, int Z,
        int up_cols, int down_cols, cudaStream_t st) {
  const int e = by_rows<T, T, float, EPI_GELU>(
      MR, up_cols, Rows{xt, eid, w1, u, nullptr, s, G, tile, E, Z, D, F, epp,
                        p1}, st);
  if (e != 0) return e;
  return by_rows<float, T, T, EPI_NONE>(
      MR, down_cols, Rows{u, eid, w2, out, nullptr, nullptr, G, tile, E, Z,
                          F, D, epp, p2}, st);
}

int wgrad(const float* a, const float* b, const int* eid, float* dw,
          float* scratch, int G, int tile, int E, int M, int N, int splits,
          cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        expert_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)WG_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int tiles_m = (M + WG_MT - 1) / WG_MT;
  const int tiles_n = (N + WG_NT - 1) / WG_NT;
  float* dst = splits > 1 ? scratch : dw;
  expert_wgrad<<<dim3(tiles_m * tiles_n, E, splits), kThreads, WG_SMEM,
                 st>>>(a, b, eid, dst, G, tile, M, N, tiles_n);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long n = (long long)E * M * N;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 65536);
  sum_splits<<<blocks, 256, 0, st>>>(scratch, dw, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xt [G, tile, D], tile_eid [G] int32 (every id in [0, E)), w1 [E, D, F],
// w2 [E, F, D], u [G, tile, F] f32 scratch, s [G, tile, F] f32 or null
// (the pre-activation, kept for the backward), out [G, tile, D]; D and F
// multiples of 8; dtype 0 = f32, 1 = bf16 (xt, w1, w2 and out alike).
// The experts are stacked peers of epp each: expert e's w1 block starts
// p1 * (e / epp) + (e % epp) * D * F elements into w1, its w2 block p2 *
// (e / epp) + ... into w2 (E = epp: one contiguous [E, ...] tensor).
// rows: the chunk of an expert's rows a block multiplies at once (16, 32
// or 64); slots: the blocks that share an expert's chunks for each column
// slice; up_cols / down_cols: the columns of a block in the up- and
// down-projection (16, 32 or 64).
int bf_grouped_ffn(const void* xt, const void* tile_eid, const void* w1,
                   const void* w2, void* u, void* s, void* out, int G,
                   int tile, int E, int epp, long long p1, long long p2,
                   int D, int F, int rows, int slots, int up_cols,
                   int down_cols, int dtype, void* stream) {
  if (G < 1 || tile < 1 || E < 1 || E > 65535 || epp < 1 || E % epp ||
      D < 8 || F < 8 || D % 8 || F % 8 || p1 % 8 || p2 % 8 || slots < 1 ||
      slots > 65535)
    return -1;
  const int* eid = static_cast<const int*>(tile_eid);
  float* uf = static_cast<float*>(u);
  float* sf = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(xt, eid, w1, w2, uf, sf, out, G, tile, E, epp, p1, p2,
                      D, F, rows, slots, up_cols, down_cols, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(xt, eid, w1, w2, uf, sf, out, G, tile, E, epp,
                              p1, p2, D, F, rows, slots, up_cols, down_cols,
                              st);
  return -2;
}

// The dgrad, f32: g [G, tile, D] the output's cotangent, s [G, tile, F]
// the forward's pre-activation; writes ds [G, tile, F] = (g @ w2^T) *
// gelu'(s), u [G, tile, F] = gelu(s) and dxt [G, tile, D] = ds @ w1^T.
// Weights, strides and the plan as bf_grouped_ffn's.
int bf_grouped_ffn_dgrad(const void* g, const void* tile_eid, const void* w1,
                         const void* w2, const void* s, void* ds, void* u,
                         void* dxt, int G, int tile, int E, int epp,
                         long long p1, long long p2, int D, int F, int rows,
                         int slots, int up_cols, int down_cols,
                         void* stream) {
  if (G < 1 || tile < 1 || E < 1 || E > 65535 || epp < 1 || E % epp ||
      D < 8 || F < 8 || D % 8 || F % 8 || p1 % 8 || p2 % 8 || slots < 1 ||
      slots > 65535)
    return -1;
  const int* eid = static_cast<const int*>(tile_eid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = by_rows<float, float, float, EPI_DGELU, true>(
      rows, up_cols,
      Rows{g, eid, w2, ds, static_cast<const float*>(s),
           static_cast<float*>(u), G, tile, E, slots, D, F, epp, p2},
      st);
  if (e != 0) return e;
  return by_rows<float, float, float, EPI_NONE, true>(
      rows, down_cols,
      Rows{ds, eid, w1, dxt, nullptr, nullptr, G, tile, E, slots, F, D, epp,
           p1},
      st);
}

// The wgrad, f32: dw1 [E, D, F] = per expert xt^T ds, dw2 [E, F, D] = u^T
// g, over the rows of xt, ds, u, g ([G, tile, *]); splits > 1 sums each
// expert's rows in that many round-robin parts into scratch [splits, E,
// D * F] f32, then adds the parts in order.
int bf_grouped_ffn_wgrad(const void* xt, const void* ds, const void* u,
                         const void* g, const void* tile_eid, void* dw1,
                         void* dw2, void* scratch, int G, int tile, int E,
                         int D, int F, int splits, void* stream) {
  if (G < 1 || tile < 1 || E < 1 || E > 65535 || D < 4 || F < 4 || D % 4 ||
      F % 4 || splits < 1 || splits > 65535 || (splits > 1 && !scratch))
    return -1;
  const int* eid = static_cast<const int*>(tile_eid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = wgrad(static_cast<const float*>(xt),
                      static_cast<const float*>(ds), eid,
                      static_cast<float*>(dw1), static_cast<float*>(scratch),
                      G, tile, E, D, F, splits, st);
  if (e != 0) return e;
  return wgrad(static_cast<const float*>(u), static_cast<const float*>(g),
               eid, static_cast<float*>(dw2), static_cast<float*>(scratch),
               G, tile, E, F, D, splits, st);
}

}  // extern "C"
