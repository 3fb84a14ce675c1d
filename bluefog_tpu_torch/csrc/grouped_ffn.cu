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
// type.  Any tile size and any tile order.  A tile whose id is -1 is
// trash (the dropless dispatch marks so the tiles past an owner's last
// group, which hold only zero rows: about half of an expert-parallel
// owner's buffer): no block takes it, and zero_marked_tiles writes its
// output rows as zeros.
//
// Two routes, picked by the wrapper from host integers alone (ffn_route
// in ops/grouped_ffn.py): expert_rows below an even share of 52 rows an
// expert (decode, small prefills), forward_gemm from it (prefills of 256
// tokens and up, training row counts; see "The forward on the plan"
// below; the card's crossover behind the threshold is in ffn_route's
// docstring).  Both keep the TPU kernel's
// rounding points: f32 products, u = gelu(s) kept in f32, the output
// rounded once to xt's type.
//
// expert_rows.  What bounds it: at decode the bytes (each named expert's
// w1 + w2, 2 * D * F * itemsize, 33.5 MB at D 1024, F 4096, f32), at a
// 512-token prefill the operations (4 * G * tile * D * F, at 495 / 3 =
// 165 TFLOP/s for f32-accurate 3xTF32 products).  The design:
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
// The forward on the plan (forward_gemm route).  At the MoE trainer's
// steady tick (65,536 rows over 32 folded experts, D 1024, F 2048) the
// operations bound it: 4 rows D F, 3.3 ms at the 3xTF32 rate, 1.4 ms in
// bf16 (the up-projection at the bf16 rate, the down-projection at half
// the TF32 rate).  expert_rows there ran 32,768 blocks of 64 x 64 a
// product, each block's first warp scanning tile_eid from the start, the
// operands re-read through L2 once per 64 rows or columns, with
// mma.sync.  This route takes the backward's engine instead: the wrapper
// launches backward_plan (its row blocks: up to 128 rows of one run of an
// expert's tiles) and hands the plan to the backward, which launches
// none of its own; then two persistent GEMMs over the row blocks, each
// item a 128 x 128 output tile over its whole reduction, on the TMA ring
// and wgmma of the backward (see below):
//
//   * up: s = xt @ w1[e], the epilogue writing s (f32, when kept) and u =
//     gelu(s) (f32); down: out = u @ w2[e], summed in f32 and rounded
//     once to xt's type; zero_marked_tiles then writes the trash tiles'
//     rows.  The weights w[e] [K, N] hold N innermost (MN-major), so TMA
//     stages them in 128-byte lines of N, as the wgrad's second operand.
//   * f32: 3xTF32 (forward_gemm), the split pass transposing the staged
//     weights into K-major core matrices.  bf16: the up-projection is
//     bf16 x bf16 wgmma with B through the transpose immediate
//     (forward_gemm16: exact products, f32 sums); the down-projection
//     multiplies the f32 u, split into big and small TF32 parts, by the
//     bf16 w2 widened to TF32 exactly (its small part is zero and skipped:
//     two wgmmas a product, forward_gemm).  u is never rounded to bf16.
//   * No atomics on data and no scan of tile_eid in the GEMMs: the plan's
//     item counter only hands out tiles, so reruns are bit-identical, and
//     a hot expert gets as many items as its rows need.
//
// The backward (replaces the plain-XLA custom_vjp backward
// bluefog_tpu/ops/pallas_moe.py::_grouped_bwd, which gathers w1[tile_eid]
// and w2[tile_eid] per tile and scatter-adds per-tile weight gradients):
// with s = xt @ w1[e] kept by the forward (f32, [G * tile, F]) and g the
// output's cotangent,
//
//     ds  = (g @ w2[e]^T) * gelu'(s),  u = gelu(s)       (dgrad, product 1)
//     dxt = ds @ w1[e]^T                                  (dgrad, product 2)
//     dw1[e] = sum over e's rows of xt^T ds,  dw2[e] = of u^T g   (wgrad)
//
// What bounds it: the operations, 8 * G * tile * D * F at the 3xTF32 rate
// (6.7 ms at the MoE trainer's steady tick: 65,536 rows, D 1024, F 2048).
// Routing is uneven, so work sized for an even share of rows per expert
// leaves a hot expert on a handful of blocks; thin tiles re-read their
// operands from L2; and splitting f32 into TF32 parts at each fragment
// read costs about one conversion per product.  The design:
//
//   * A routing plan built on the device (backward_plan, one block): from
//     tile_eid alone, each expert's rows, its runs of consecutive tiles in
//     tile order, the dgrad's row blocks (up to 128 rows of one run) and
//     the wgrad's parts (a stretch of one expert's rows; an expert holding
//     more than its share of the card is split into parts), and the
//     experts whose dw a second pass writes (split ones: their parts
//     summed in part order; ones without rows: exact zeros).  The host
//     sizes the plan and the part scratch from the shapes alone and never
//     reads either back; the plan writes no entry past those sizes, and a
//     routing that would need more sets a fault word on which the GEMMs
//     trap.  The work follows the routing: a hot expert gets as many
//     blocks as its rows need, and no block scans tile_eid.
//   * One GEMM kernel, backward_gemm, for the four products: a persistent
//     grid of one 256-thread block per SM whose blocks take items from a
//     counter in the plan (an item: a 128 x 128 tile of the output over its
//     whole reduction; the last block out resets the counter).  Its two
//     warpgroups each multiply 64 rows by the 128 columns with wgmma
//     m64n128k8 tf32, A from registers, B from shared memory.
//   * 3xTF32 split once per staged element: each thread splits its own A
//     fragment values (each A element of a stage is read by one thread),
//     and one pass splits each staged B element into big and small parts
//     written K-major, in core matrices, into shared memory: the only
//     layout tf32 wgmma takes.  The dgrad's B (the weights w[e] [N, K]) is
//     K-major in device memory already; the wgrad's (rows x N) is
//     transposed by that same pass, and its A fragments are read
//     transposed from the staged tile.  Two stages' 24 wgmmas go to a
//     zeroed accumulator (scale-d 0) that is then added to the running sum
//     with round-to-nearest, as the forward's mma3_rn does for one.
//   * Staging: a ring of 5 stages of 32 reduction entries fed by TMA, one
//     thread asking for each stage's boxes on an mbarrier (an item's rows
//     are one run of the plan, so contiguous): threads issuing their own
//     cp.async copies kept too few bytes in flight, and the loads and the
//     products barely overlapped.  The boxes carry the 128-byte swizzle,
//     which the split pass and the fragment reads follow.  Columns past N
//     and rows past the tensor are zero-filled by TMA; rows past a run's
//     end (a box may reach into the next expert's rows) are zeroed as they
//     are read.  Stage k + 1 is split and its A fragments loaded (two
//     register buffers) while stage k's wgmmas run.
//   * No atomics on data: two runs are bit-identical.  Tiles of the
//     dropless layout's clamped tail hold zero rows of xt and g, so they
//     add exact zeros; marked ones (id -1) form runs of no expert, which
//     get no row block and no part, and zero_marked_tiles writes their
//     rows of dxt as zeros.
//   * Stacked peers: the weights may be [P, E, D, F] with any stride
//     between peers (a layer's slice of a stacked parameter) and ids in
//     [0, P * E); expert e reads peer e / E's block e % E, so the folded
//     call copies no weight.
//
// The bf16 backward (bf16 xt, g and weights; s f32 from the forward) runs
// on the same plan with its own GEMM kernel, backward_gemm16, and none of
// the 3xTF32 machinery: bf16 x bf16 products are exact in f32, so wgmma
// m64n64k16.f32.bf16.bf16 takes both operands straight from the TMA-staged
// tiles (128-byte lines, the 128-byte swizzle), K-major for the dgrad
// (rows and weights hold the reduction innermost) and MN-major for the
// wgrad (the reduction runs over rows: the transpose immediates replace
// the f32 kernel's transposing pass).  A stage is 64 reduction entries
// (one 128-byte line of bf16), 16 KB an operand; with no split buffers
// the ring is 6 stages deep.  The wgrad's stages still stop at a run's
// and a part's end (the plan cuts parts at 32 rows): the lines past a
// stage's rows are zeroed in shared memory before its products.  Rounding
// points, those of the plain version: du = g @ w2^T accumulates in f32;
// ds = du * gelu'(s) and u = gelu(s) are rounded to bf16 once (they are
// the next products' operands); dxt = ds @ w1^T accumulates in f32 and is
// rounded once; each expert's dw1 / dw2 is summed over all its rows in
// f32 (split experts' parts in part order) and rounded once.  What bounds
// it: the operations, 8 * G * tile * D * F at the bf16 rate (1.1 ms at the
// steady tick), where the f32 kernel needs three TF32 products for one.
//
// The C interface takes every pointer as void* (ctypes passes them as
// c_void_p) and returns cudaGetLastError() after the launches.

#include <cuda.h>                // CUtensorMap (the encoder is fetched
#include <cuda_runtime.h>        // from the driver at run time)
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// the epilogue of expert_rows: store v, or gelu(v) (and v into aux when
// it is not null: the pre-activation the backward needs)
enum { EPI_NONE = 0, EPI_GELU = 1 };

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
template <typename Tin, typename Tw, int MR, int NC>
struct Geo {
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
// in [G * tile, K], w [E, K, N], out [G * tile, N]; expert e's weights
// start at (e / epp) * pstride + (e % epp) * K * N (stacked peers of epp
// experts each, pstride elements apart); aux [G * tile, N] is written by
// the epilogue above.
template <typename Tin, typename Tw, typename Tout, int MR, int NC,
          int kEpi>
__global__ void __launch_bounds__(kThreads)
expert_rows(const Tin* __restrict__ in, const int* __restrict__ eid,
            const Tw* __restrict__ w, Tout* __restrict__ out,
            float* __restrict__ aux, int G, int tile, int K, int N, int epp,
            long long pstride) {
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
            FragB b;
            const Tw* bp = B + (c0 + t) * SB + n * 8 + g;
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
      const size_t o = (size_t)rows_sh[r] * N + n0 + c;
      if constexpr (kEpi == EPI_GELU) {
        narrow(out + o, gelu_tanh(v));
        if (aux) aux[o] = v;
      } else {
        narrow(out + o, v);
      }
    }
    __syncthreads();                   // rows_sh and red free again
  }
}

// -- the backward: a routing plan built on the device ---------------------

constexpr int kBM = 128, kBN = 128;   // a GEMM block's tile of the output
constexpr int kBK = 32;               // reduction entries a stage
constexpr int kBS = 5;                // stages in the TMA ring
constexpr int kBT = 256;              // two warpgroups
constexpr int kPlanThreads = 1024;

// the plan's header, int32 words: the lists' lengths, the GEMMs' item
// counter, and H_FAULT, set when the routing needs more row blocks, parts
// or scratch slots than the host sized (the plan then writes no list
// entry past its room, and every kernel that reads it traps)
enum { H_RUNS = 0, H_ROWBLK = 1, H_PARTS = 2, H_FIX = 3, H_SLOTS = 4,
       H_NEXT = 5, H_FAULT = 6, H_WORDS = 16 };

// offsets (int32 words) of the plan's lists; the wrapper reads them and
// the total through bf_grouped_ffn_backward_layout:
//   erows [E]       rows of each expert
//   eptr [E + 1]    expert e's runs are eruns[eptr[e] .. eptr[e + 1])
//   ecur [E]        scratch (runs per expert, then a cursor)
//   runs [G][2]     (expert, first tile) of each run, in tile order
//   eruns [G][2]    (first row, rows) of each run, by expert, tile order
//   rowblk [rb_max][3]  the dgrad's row blocks: (first row, rows, expert)
//   parts [p_max][4]    the wgrad's parts: (expert, first and end offset
//                       into the expert's rows, scratch slot or -1)
//   fix [E][3]      experts whose dw the part sum writes: (expert, first
//                   slot, parts), 0 parts for an expert without rows
struct PlanLayout {
  int erows, eptr, ecur, runs, eruns, rowblk, parts, fix, total;
  __host__ __device__ PlanLayout(int G, int E, int rb_max, int p_max) {
    erows = H_WORDS;
    eptr = erows + E;
    ecur = eptr + E + 1;
    runs = ecur + E;
    eruns = runs + 2 * G;
    rowblk = eruns + 2 * G;
    parts = rowblk + 3 * rb_max;
    fix = parts + 4 * p_max;
    total = fix + 3 * E;
  }
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// exclusive prefix sum of v over a block of kPlanThreads threads; *sum
// gets the total.  Every thread of the block calls it.
__device__ int block_scan(int v, int* sum) {
  __shared__ int part[kPlanThreads / 32];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = part[lane];
    int s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    part[lane] = s - w;
    if (lane == 31) total = s;
  }
  __syncthreads();
  const int r = part[warp] + x - v;
  *sum = total;
  __syncthreads();                     // part and total free again
  return r;
}

// The plan (one block): tile_eid [G] (ids in [-1, E): -1 marks a trash
// tile, whose runs are listed but hold no rows), tile rows a tile;
// tiles_mn the 128 x 128 tiles of one expert's dw; an expert's rows are
// split into parts when it holds more than target / tiles_mn of all rows'
// share of the card's work (and each part keeps min_part rows), or into
// `splits` parts when splits > 0; parts start on kBK-row boundaries.  At
// most rb_max row blocks, p_max parts and slots_max scratch slots are
// written; a routing that needs more sets H_FAULT.
__global__ void __launch_bounds__(kPlanThreads)
backward_plan(const int* __restrict__ eid, int* __restrict__ plan, int G,
              int tile, int E, int tiles_mn, int target, int min_part,
              int splits, int rb_max, int p_max, int slots_max) {
  const PlanLayout L(G, E, rb_max, p_max);
  const int tid = threadIdx.x;
  int* erows = plan + L.erows;
  int* eptr = plan + L.eptr;
  int* ecur = plan + L.ecur;
  int* runs = plan + L.runs;
  for (int e = tid; e < E; e += kPlanThreads) erows[e] = ecur[e] = 0;
  __syncthreads();

  // runs of consecutive tiles of one expert, in tile order; rows and
  // runs of each expert
  int nruns = 0;
  for (int g0 = 0; g0 < G; g0 += kPlanThreads) {
    const int g = g0 + tid;
    const int x = g < G ? eid[g] : -1;
    const bool head = g < G && (g == 0 || eid[g - 1] != x);
    int n;
    const int r = nruns + block_scan(head, &n);
    if (head) {
      runs[2 * r] = x;                 // a trash run ends the run before
      runs[2 * r + 1] = g;
      if (x >= 0) atomicAdd(ecur + x, 1);
    }
    // one atomic per expert a warp: a hot expert's tiles meet in few adds
    const unsigned valid = __ballot_sync(0xffffffffu, g < G);
    if (g < G) {
      const unsigned same = __match_any_sync(valid, x);
      if (x >= 0 && (tid & 31) == __ffs(same) - 1)
        atomicAdd(erows + x, tile * __popc(same));
    }
    nruns += n;
  }
  __syncthreads();

  // per expert: where its runs go, its wgrad parts, its part-sum entry
  const long long all_rows = (long long)G * tile;
  int run0 = 0, part0 = 0, slot0 = 0, fix0 = 0;
  for (int e0 = 0; e0 < E; e0 += kPlanThreads) {
    const int e = e0 + tid;
    int nr = 0, rows = 0, np = 0, psize = 1;
    if (e < E) {
      nr = ecur[e];
      rows = erows[e];
      if (rows > 0) {
        long long s;
        if (splits > 0) {
          s = min((long long)splits, (long long)ceil_div(rows, kBK));
        } else {
          const long long den = all_rows * tiles_mn;
          s = ((long long)rows * target + den - 1) / den;
          s = min(s, (long long)ceil_div(rows, min_part));
        }
        s = max(s, 1LL);
        psize = ceil_div(ceil_div(rows, (int)s), kBK) * kBK;
        np = ceil_div(rows, psize);
      }
    }
    int n_runs, n_parts, n_slots, n_fix;
    const int ro = run0 + block_scan(nr, &n_runs);
    const int po = part0 + block_scan(np, &n_parts);
    const int so = slot0 + block_scan(np > 1 ? np : 0, &n_slots);
    const int fo = fix0 + block_scan(e < E && np != 1, &n_fix);
    if (e < E) {
      eptr[e] = ecur[e] = ro;
      for (int k = 0; k < np && po + k < p_max; ++k) {
        int* q = plan + L.parts + 4 * (po + k);
        q[0] = e;
        q[1] = k * psize;
        q[2] = min(rows, (k + 1) * psize);
        q[3] = np > 1 ? so + k : -1;
      }
      if (np != 1) {
        int* q = plan + L.fix + 3 * fo;
        q[0] = e;
        q[1] = so;
        q[2] = np;
      }
    }
    run0 += n_runs;
    part0 += n_parts;
    slot0 += n_slots;
    fix0 += n_fix;
  }

  // the dgrad's row blocks: each run's rows, kBM at a time
  int blk0 = 0;
  for (int r0 = 0; r0 < nruns; r0 += kPlanThreads) {
    const int r = r0 + tid;
    int nb = 0, x = 0, first = 0, rows = 0;
    if (r < nruns) {
      x = runs[2 * r];
      first = runs[2 * r + 1] * tile;
      rows = ((r + 1 < nruns ? runs[2 * r + 3] : G) - runs[2 * r + 1]) *
             tile;
      nb = x < 0 ? 0 : ceil_div(rows, kBM);
    }
    int n;
    const int bo = blk0 + block_scan(nb, &n);
    for (int b = 0; b < nb && bo + b < rb_max; ++b) {
      int* q = plan + L.rowblk + 3 * (bo + b);
      q[0] = first + b * kBM;
      q[1] = min(kBM, rows - b * kBM);
      q[2] = x;
    }
    blk0 += n;
  }
  __syncthreads();                     // eptr and ecur are written

  // each expert's runs in tile order: a stable bucketing by one warp, 32
  // runs a round (the lanes of one expert take consecutive places)
  if (tid < 32) {
    for (int r0 = 0; r0 < nruns; r0 += 32) {
      const int r = r0 + tid;
      const unsigned act = __ballot_sync(0xffffffffu, r < nruns);
      if (r < nruns) {
        const int x = runs[2 * r], g0 = runs[2 * r + 1];
        const int g1 = r + 1 < nruns ? runs[2 * r + 3] : G;
        const unsigned same = __match_any_sync(act, x);
        const int rank = __popc(same & ((1u << tid) - 1u));
        const int base = x >= 0 ? ecur[x] : 0;
        if (x >= 0) {                  // trash runs belong to no expert
          plan[L.eruns + 2 * (base + rank)] = g0 * tile;
          plan[L.eruns + 2 * (base + rank) + 1] = (g1 - g0) * tile;
        }
        __syncwarp(act);
        if (rank == 0 && x >= 0) ecur[x] = base + __popc(same);
      }
      __syncwarp();
    }
  }
  if (tid == 0) {
    eptr[E] = run0;
    plan[H_RUNS] = nruns;
    plan[H_ROWBLK] = blk0;
    plan[H_PARTS] = part0;
    plan[H_FIX] = fix0;
    plan[H_SLOTS] = slot0;
    plan[H_NEXT] = 0;
    plan[H_FAULT] = blk0 > rb_max || part0 > p_max || slot0 > slots_max;
  }
}

// -- the GEMMs on wgmma: the backward's, and the forward's on its plan -----

// the backward's three products, then the forward's two (on the plan's
// row blocks, as the dgrad's; the weights [K, N] are MN-major there)
enum { BW_DGELU = 0, BW_DGRAD = 1, BW_WGRAD = 2, FW_UP = 3, FW_DOWN = 4 };

// A stage holds each operand as TMA wrote it, 16 KB with the 128-byte
// swizzle (16-byte chunk c of a 128-byte row r at chunk c ^ (r % 8)): the
// dgrad's as 128 rows of kBK entries (one box), the wgrad's as four boxes
// of kBK rows x 32 columns.  Either way the split pass and the fragment
// reads meet few bank conflicts.  Then B's big and small parts, K-major,
// in two alternating buffers; then the ring's barriers.
constexpr int kRawOp = kBM * kBK;     // floats of one operand's stage
constexpr int kSplitOp = kBN * kBK;   // B's big (or small) parts
constexpr size_t kSplitBytes = 4 * (size_t)kSplitOp * 4;    // 64 KB
constexpr size_t kRawBytes = kBS * 2 * (size_t)kRawOp * 4;  // 160 KB
constexpr size_t kBwSmem = 1024 + kSplitBytes + kRawBytes + 8 * kBS +
                           4 * kBS + 16;  // + the slack for 1 KB alignment
static_assert(kBM == kBN && kBK * 4 == 128 && kBwSmem <= 232448,
              "backward GEMM geometry");

// float offset of (row r, entry k) in a dgrad stage operand [128][kBK]
__device__ __forceinline__ int sw_rows(int r, int k) {
  return r * kBK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}
// float offset of (stage row k, column c) in a wgrad stage operand: four
// boxes [kBK rows][32 columns]
__device__ __forceinline__ int sw_cols(int k, int c) {
  return (c >> 5) * (kBK * 32) + k * 32 + ((((c & 31) >> 2) ^ (k & 7)) << 2) +
         (c & 3);
}
// bf16 offset of (stage row k, column c) in a stage of bf16 weights
// [K, N]: two boxes [kBK rows][64 columns]
__device__ __forceinline__ int sw_cols16(int k, int c) {
  return (c >> 6) * (kBK * 64) + k * 64 + ((((c & 63) >> 3) ^ (k & 7)) << 3) +
         (c & 7);
}

// the operands of one GEMM: A in TA, B in TB, the outputs in TO (the
// backward's all f32 or all bf16)
template <typename TA, typename TB = TA, typename TO = TA>
struct BwT {
  const TA* a;          // dgrad, forward: the rows [R, K]; wgrad: [R, M]
  const TB* b;          // dgrad: the weights, expert e at [N, K]; forward:
                        // at [K, N]; wgrad: the rows [R, N]
  const float* s;       // the first dgrad product: s [R, N] (f32 always)
  TO* out;              // dgrad, forward: [R, N] (the up-projection: s,
                        // or null); wgrad: dw [E, M, N]
  TO* aux;              // the first dgrad product and the up-projection:
                        // u = gelu(s) [R, N]
  float* scratch;       // wgrad: split experts' parts [slots, M, N]
  int* plan;
  int M, N, K;          // dgrad, forward: N columns over K entries;
                        // wgrad: M x N
  int G, tile, E, rb_max, p_max, epp;
  long long pstride;    // the weights: expert e at (e / epp) * pstride +
                        // (e % epp) * N * K
};
using Bw = BwT<float>;

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// walks one wgrad part: the expert's rows [r0, r1) in tile order, a stage
// of at most kStage rows at a time, a stage never crossing a run's end
template <int kStage>
struct RowCursor {
  const int* eruns;
  int j, o, pos, end, first, len;
  __device__ void init(const int* er, int j0, int r0, int r1) {
    eruns = er;
    j = j0;
    pos = r0;
    end = r1;
    int cum = 0;
    for (;;) {
      first = er[2 * j];
      len = er[2 * j + 1];
      if (cum + len > r0) break;
      cum += len;
      ++j;
    }
    o = r0 - cum;
  }
  __device__ bool more() const { return pos < end; }
  __device__ void next(int& row, int& cnt) {
    cnt = min(min(kStage, len - o), end - pos);
    row = first + o;
    o += cnt;
    pos += cnt;
    if (o == len && pos < end) {
      ++j;
      first = eruns[2 * j];
      len = eruns[2 * j + 1];
      o = 0;
    }
  }
};

// One persistent block per SM; an item is a 128 x 128 tile of the output
// over its whole reduction: dgrad and forward item i is row block i /
// tiles_n, column tile i % tiles_n; wgrad item i is part i / (tiles_m
// tiles_n), dw tile i % (tiles_m tiles_n).  ma / mb point at the
// operands' TMA maps: the dgrad's rows [R, K] (boxes of kBK x 128) and
// weights [P, epp, N, K] (kBK x 128 x 1 x 1), the wgrad's rows [R, M] and
// [R, N] (32 x kBK), the forward's rows [R, K] (kBK x 128) and weights
// [P, epp, K, N] (128-byte lines: 32 f32 or 64 bf16 columns x kBK rows x
// 1 x 1).  Thread 0 issues every stage's boxes; a stage's rows past its
// run's end (the box may reach into the next expert's rows) are zeroed as
// they are read, so they add exact zeros.  B of type bf16 (the bf16
// forward's down-projection: the weight w2) is exact in TF32: its small
// part is zero, so a product is two wgmmas, not three.
template <int kMode, typename TB, typename TO>
__device__ __forceinline__ void gemm_tf32(const BwT<float, TB, TO> p,
                                          const void* ma, const void* mb) {
  constexpr bool kW = kMode == BW_WGRAD;
  constexpr bool kF = kMode == FW_UP || kMode == FW_DOWN;
  constexpr bool kBExact = sizeof(TB) == 2;
  extern __shared__ __align__(16) unsigned char smem_in[];
  // the swizzle pattern repeats every 1 KB: the tiles start on 1 KB
  unsigned char* smem =
      smem_in + ((1024u - (smem_addr(smem_in) & 1023u)) & 1023u);
  uint32_t* split_buf = reinterpret_cast<uint32_t*>(smem);  // [2][big|small]
  float* raw = reinterpret_cast<float*>(smem + kSplitBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kSplitBytes + kRawBytes);
  int* rows_sh = reinterpret_cast<int*>(full + kBS);  // a stage's rows
  int* item_sh = rows_sh + kBS;
  const PlanLayout L(p.G, p.E, p.rb_max, p.p_max);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this thread's first A row of the tile: warpgroup, warp, fragment row
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int tiles_n = ceil_div(p.N, kBN);
  const int tiles = kW ? ceil_div(p.M, kBM) * tiles_n : tiles_n;
  if (p.plan[H_FAULT]) __trap();       // the plan outgrew its room
  const int n_items = (kW ? p.plan[H_PARTS] : p.plan[H_ROWBLK]) * tiles;
  if (tid == 0) {
    for (int i = 0; i < kBS; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  int base = 0;                        // stages issued for earlier items
  for (;;) {
    if (tid == 0) *item_sh = atomicAdd(p.plan + H_NEXT, 1);
    __syncthreads();
    const int item = *item_sh;
    if (item >= n_items) {
      // every block ends on one failed take: the last one resets the
      // counter for the plan's next launch
      if (tid == 0 && item == n_items + (int)gridDim.x - 1)
        p.plan[H_NEXT] = 0;
      return;
    }
    int m0 = 0, n0, e, rows0 = 0, nrows = kBM, slot_out = -1;
    RowCursor<kBK> cur;
    if constexpr (kW) {
      const int* q = p.plan + L.parts + 4 * (item / tiles);
      e = q[0];
      slot_out = q[3];
      m0 = (item % tiles) / tiles_n * kBM;
      n0 = (item % tiles) % tiles_n * kBN;
      cur.init(p.plan + L.eruns, p.plan[L.eptr + e], q[1], q[2]);
    } else {
      const int* q = p.plan + L.rowblk + 3 * (item / tiles_n);
      rows0 = q[0];
      nrows = q[1];
      e = q[2];
      n0 = (item % tiles_n) * kBN;
    }

    // -- stage `issued` into its ring slot: thread 0 asks for the boxes --
    int issued = 0;
    auto issue = [&]() {
      const int slot = (base + issued) % kBS;
      float* ra = raw + slot * 2 * kRawOp;
      float* rb = ra + kRawOp;
      if constexpr (kW) {
        if (!cur.more()) return;
        int row, cnt;
        cur.next(row, cnt);
        if (tid == 0) {
          rows_sh[slot] = cnt;
          mbar_expect_tx(full + slot, 2 * kRawOp * 4);
          for (int b = 0; b < kBM / 32; ++b) {
            tma_load_2d(ra + b * kBK * 32, ma, full + slot, m0 + 32 * b,
                        row);
            tma_load_2d(rb + b * kBK * 32, mb, full + slot, n0 + 32 * b,
                        row);
          }
        }
      } else {
        if (issued * kBK >= p.K) return;
        if (tid == 0) {
          mbar_expect_tx(full + slot, kRawOp * 4 + kBK * kBN * sizeof(TB));
          tma_load_2d(ra, ma, full + slot, issued * kBK, rows0);
          if constexpr (kF) {          // 128-byte lines of kBN columns
            constexpr int bw = 128 / sizeof(TB);
            for (int b = 0; b < kBN / bw; ++b)
              tma_load_4d(rb + b * kBK * 32, mb, full + slot, n0 + bw * b,
                          issued * kBK, e % p.epp, e / p.epp);
          } else {
            tma_load_4d(rb, mb, full + slot, issued * kBK, n0, e % p.epp,
                        e / p.epp);
          }
        }
      }
      ++issued;
    };
    auto wait_stage = [&](int ks) {
      mbar_wait(full + (base + ks) % kBS, ((base + ks) / kBS) & 1);
    };

    // -- B of stage ks split into big and small parts, K-major: core
    //    matrix (k / 4, n / 8) of 8 rows x 4 entries at word (k / 4 *
    //    kBN / 8 + n / 8) * 32 ---------------------------------------------
    auto split_b = [&](int ks) {
      const int slot = (base + ks) % kBS;
      const float* rb = raw + slot * 2 * kRawOp + kRawOp;
      const int lim = kW ? rows_sh[slot] : kBK;
      uint32_t* big = split_buf + (ks & 1) * 2 * kSplitOp;
      uint32_t* sml = big + kSplitOp;
      for (int i = tid; i < kBN * (kBK / 4); i += kBT) {
        const int n = i % kBN, kc = i / kBN;
        float v[4];
        if constexpr (kW || kF) {      // MN-major: transposed here
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = kc * 4 + q;
            if constexpr (kBExact)
              v[q] = widen(
                  reinterpret_cast<const TB*>(rb)[sw_cols16(k, n)]);
            else
              v[q] = k < lim ? rb[sw_cols(k, n)] : 0.f;
          }
        } else {
          const float4 x =
              *reinterpret_cast<const float4*>(rb + sw_rows(n, kc * 4));
          v[0] = x.x;
          v[1] = x.y;
          v[2] = x.z;
          v[3] = x.w;
        }
        uint32_t hb[4], hs[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split<kBExact>(v[q], hb[q], hs[q]);
        const int o = (kc * (kBN / 8) + n / 8) * 32 + (n % 8) * 4;
        *reinterpret_cast<uint4*>(big + o) =
            make_uint4(hb[0], hb[1], hb[2], hb[3]);
        if constexpr (!kBExact)
          *reinterpret_cast<uint4*>(sml + o) =
              make_uint4(hs[0], hs[1], hs[2], hs[3]);
      }
    };

    // -- A fragments of stage ks (each element read by one thread), split
    //    in registers: ab / as[k step][register] --------------------------
    auto load_a = [&](int ks, uint32_t(&ab)[4][4], uint32_t(&as)[4][4]) {
      const int slot = (base + ks) % kBS;
      const float* ra = raw + slot * 2 * kRawOp;
      const int lim = kW ? rows_sh[slot] : nrows;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = arow + (i & 1) * 8, k = j * 8 + t + (i >> 1) * 4;
          const float x = kW ? (k < lim ? ra[sw_cols(k, r)] : 0.f)
                             : (r < lim ? ra[sw_rows(r, k)] : 0.f);
          split<false>(x, ab[j][i], as[j][i]);
        }
    };

    // Stage ks's 12 wgmmas (A in ab / as; 8 with an exact B) go to `part`;
    // stage ks + 1 is split and its A fragments loaded (into nb / ns)
    // while they run, once stage ks - 1's wgmmas are done.  `part` takes
    // two stages (an even stage starts it zeroed, scale-d 0) before it
    // joins the running sum rounded to nearest, so the tensor pipe drains
    // once every two stages.  Thread 0 asks TMA for a stage only where no
    // wgmma is in flight (the start of an even step, the end of an odd
    // one): its branch while they run would make the compiler serialize
    // them.
    float acc[64], part[64];
    auto step = [&](auto odd_tag, int ks, uint32_t(&ab)[4][4],
                    uint32_t(&as)[4][4], uint32_t(&nb)[4][4],
                    uint32_t(&ns)[4][4]) {
      constexpr bool odd = decltype(odd_tag)::value;
      if constexpr (!odd) {
        issue();                       // into the slot stage ks freed
#pragma unroll
        for (int i = 0; i < 64; ++i) keep(part[i]);
      }
      const uint32_t* big = split_buf + (ks & 1) * 2 * kSplitOp;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k step j: core matrices 2j and 2j + 1 along K, 2 KB apart; the
        // 16 groups of 8 columns 128 bytes apart
        const uint64_t b_big = wgmma_desc(big + j * 1024, 2048, 128);
        const uint64_t b_small =
            wgmma_desc(big + kSplitOp + j * 1024, 2048, 128);
        wgmma_tf32_m64n128(part, as[j], b_big, odd || j > 0);
        if constexpr (!kBExact)
          wgmma_tf32_m64n128(part, ab[j], b_small, 1);
        wgmma_tf32_m64n128(part, ab[j], b_big, 1);
      }
      wgmma_commit();
      const bool more = ks + 1 < issued;
      wgmma_wait<1>();                 // stage ks - 1's wgmmas are done
      if (more) {
        wait_stage(ks + 1);
        split_b(ks + 1);
        load_a(ks + 1, nb, ns);
        fence_proxy_async();
      }
      if constexpr (odd) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          keep(part[i]);
          acc[i] += part[i];           // round to nearest (see the header)
        }
        issue();                       // into the slot stage ks freed
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          keep(ab[j][i]);
          keep(as[j][i]);
        }
      __syncthreads();                 // the split buffer and slot free
    };

    uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    for (int i = 0; i < kBS; ++i) issue();
    wait_stage(0);
    split_b(0);
    load_a(0, ab0, as0);
    fence_proxy_async();
    __syncthreads();
    for (int ks = 0; ks < issued; ks += 2) {
      step(std::false_type{}, ks, ab0, as0, ab1, as1);
      if (ks + 1 < issued)
        step(std::true_type{}, ks + 1, ab1, as1, ab0, as0);
    }
    wgmma_wait<0>();                   // an even last stage's partial
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      keep(part[i]);
      if (issued & 1) acc[i] += part[i];
    }
    base += issued;

    // -- the epilogue: rows arow and arow + 8, columns 8j + 2t, + 1 -------
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = arow + 8 * h, c = n0 + 8 * j + 2 * t;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (kW) {
          if (m0 + r < p.M && c < p.N) {
            float* dst = slot_out >= 0
                             ? p.scratch + (size_t)slot_out * p.M * p.N
                             : p.out + (size_t)e * p.M * p.N;
            *reinterpret_cast<float2*>(dst + (size_t)(m0 + r) * p.N + c) =
                make_float2(v0, v1);
          }
        } else if (r < nrows && c < p.N) {
          const size_t o = (size_t)(rows0 + r) * p.N + c;
          if constexpr (kMode == BW_DGELU) {
            const float2 sv = *reinterpret_cast<const float2*>(p.s + o);
            *reinterpret_cast<float2*>(p.out + o) =
                make_float2(v0 * gelu_tanh_grad(sv.x),
                            v1 * gelu_tanh_grad(sv.y));
            *reinterpret_cast<float2*>(p.aux + o) =
                make_float2(gelu_tanh(sv.x), gelu_tanh(sv.y));
          } else if constexpr (kMode == FW_UP) {
            if (p.out) store2(p.out + o, v0, v1);     // s, when kept
            store2(p.aux + o, gelu_tanh(v0), gelu_tanh(v1));
          } else {
            store2(p.out + o, v0, v1);
          }
        }
      }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kBT, 1)
backward_gemm(const Bw p, const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b) {
  gemm_tf32<kMode>(p, &map_a, &map_b);
}

// The forward's products on f32 A (the rows xt, or u = gelu(s)): see
// gemm_tf32; an entry point of its own, so that traces tell it apart
template <int kMode, typename TB, typename TO>
__global__ void __launch_bounds__(kBT, 1)
forward_gemm(const BwT<float, TB, TO> p,
             const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b) {
  gemm_tf32<kMode>(p, &map_a, &map_b);
}

// -- the GEMMs in bf16: the backward's, and the forward's up-projection --

constexpr int kHK = 64;               // bf16 reduction entries a stage
constexpr int kHS = 6;                // stages in the bf16 ring
constexpr int kHOp = kBM * kHK * 2;   // bytes of one operand's stage, 16 KB
constexpr size_t kHRawBytes = (size_t)kHS * 2 * kHOp;   // 192 KB
constexpr size_t kHSmem = 1024 + kHRawBytes + 8 * kHS + 4 * kHS + 16;
static_assert(kBM == 128 && kHK * 2 == 128 && kHSmem <= 232448,
              "bf16 backward GEMM geometry");

// The bf16 twin of gemm_tf32: the same persistent grid, items and plan,
// with a stage of kHK entries staged as TMA writes it and consumed in
// place by wgmma (see the header).  Warpgroup w multiplies rows 64w ..
// 64w + 63 of the item's tile by its 128 columns as two m64n64 halves.
// The dgrad's A and B are K-major (boxes of kHK entries x 128 rows); the
// wgrad's are MN-major (two boxes of 64 columns x kHK rows each), and a
// stage holding fewer than kHK rows (a run's or a part's end) has its
// other lines zeroed before its products; the forward's A is K-major and
// its B (the weights [K, N]) MN-major.  Rows past a row block's end only
// reach output rows that are never written.
template <int kMode, typename TO>
__device__ __forceinline__ void gemm_bf16(
    const BwT<__nv_bfloat16, __nv_bfloat16, TO> p, const void* ma,
    const void* mb) {
  constexpr bool kW = kMode == BW_WGRAD;
  constexpr bool kF = kMode == FW_UP;
  extern __shared__ __align__(16) unsigned char smem_in[];
  unsigned char* smem =
      smem_in + ((1024u - (smem_addr(smem_in) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kHRawBytes);
  int* rows_sh = reinterpret_cast<int*>(full + kHS);   // a stage's rows
  int* item_sh = rows_sh + kHS;
  const PlanLayout L(p.G, p.E, p.rb_max, p.p_max);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  // this thread's first output row of the tile
  const int arow = wg * 64 + (warp & 3) * 16 + g;
  const int tiles_n = ceil_div(p.N, kBN);
  const int tiles = kW ? ceil_div(p.M, kBM) * tiles_n : tiles_n;
  if (p.plan[H_FAULT]) __trap();       // the plan outgrew its room
  const int n_items = (kW ? p.plan[H_PARTS] : p.plan[H_ROWBLK]) * tiles;
  if (tid == 0) {
    for (int i = 0; i < kHS; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  int base = 0;                        // stages issued for earlier items
  for (;;) {
    if (tid == 0) *item_sh = atomicAdd(p.plan + H_NEXT, 1);
    __syncthreads();
    const int item = *item_sh;
    if (item >= n_items) {
      if (tid == 0 && item == n_items + (int)gridDim.x - 1)
        p.plan[H_NEXT] = 0;            // the last block out resets it
      return;
    }
    int m0 = 0, n0, e, rows0 = 0, nrows = kBM, slot_out = -1;
    RowCursor<kHK> cur;
    if constexpr (kW) {
      const int* q = p.plan + L.parts + 4 * (item / tiles);
      e = q[0];
      slot_out = q[3];
      m0 = (item % tiles) / tiles_n * kBM;
      n0 = (item % tiles) % tiles_n * kBN;
      cur.init(p.plan + L.eruns, p.plan[L.eptr + e], q[1], q[2]);
    } else {
      const int* q = p.plan + L.rowblk + 3 * (item / tiles_n);
      rows0 = q[0];
      nrows = q[1];
      e = q[2];
      n0 = (item % tiles_n) * kBN;
    }

    // -- stage `issued` into its ring slot: thread 0 asks for the boxes --
    int issued = 0;
    auto issue = [&]() {
      const int slot = (base + issued) % kHS;
      unsigned char* ra = smem + slot * 2 * kHOp;
      unsigned char* rb = ra + kHOp;
      if constexpr (kW) {
        if (!cur.more()) return;
        int row, cnt;
        cur.next(row, cnt);
        if (tid == 0) {
          rows_sh[slot] = cnt;
          mbar_expect_tx(full + slot, 2 * kHOp);
          for (int b = 0; b < 2; ++b) {
            tma_load_2d(ra + b * kHK * 128, ma, full + slot, m0 + 64 * b,
                        row);
            tma_load_2d(rb + b * kHK * 128, mb, full + slot, n0 + 64 * b,
                        row);
          }
        }
      } else {
        if (issued * kHK >= p.K) return;
        if (tid == 0) {
          mbar_expect_tx(full + slot, 2 * kHOp);
          tma_load_2d(ra, ma, full + slot, issued * kHK, rows0);
          if constexpr (kF) {          // two boxes of 64 columns
            for (int b = 0; b < 2; ++b)
              tma_load_4d(rb + b * kHK * 128, mb, full + slot, n0 + 64 * b,
                          issued * kHK, e % p.epp, e / p.epp);
          } else {
            tma_load_4d(rb, mb, full + slot, issued * kHK, n0, e % p.epp,
                        e / p.epp);
          }
        }
      }
      ++issued;
    };

    float acc[2][32];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    for (int i = 0; i < kHS; ++i) issue();
    for (int ks = 0; ks < issued; ++ks) {
      const int q = base + ks, slot = q % kHS;
      unsigned char* ra = smem + slot * 2 * kHOp;
      unsigned char* rb = ra + kHOp;
      mbar_wait(full + slot, (q / kHS) & 1);
      if constexpr (kW) {
        const int cnt = rows_sh[slot];
        if (cnt < kHK) {               // the same for every thread
          // lines cnt .. kHK - 1 of the four boxes (A's two, then B's)
          const int per = kHK - cnt;
          for (int i = tid; i < 4 * per * 8; i += kBT) {
            const int chunk = i & 7, l = i >> 3;
            uint4* line = reinterpret_cast<uint4*>(
                ra + (l / per) * kHK * 128 + (cnt + l % per) * 128);
            line[chunk] = make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();         // visible to wgmma's reads
          __syncthreads();
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kHK / 16; ++j) {
        // MN-major: k step j = lines 16j ..; K-major: 32 bytes along
        // the lines
        const uint64_t a =
            kW ? wgmma_desc_sw128(ra + wg * kHK * 128 + j * 2048, 1024, 1024)
               : wgmma_desc_sw128(ra + wg * 64 * 128 + j * 32, 16, 1024);
        uint64_t b0, b1;
        if constexpr (kW || kF) {
          b0 = wgmma_desc_sw128(rb + j * 2048, 1024, 1024);
          b1 = wgmma_desc_sw128(rb + kHK * 128 + j * 2048, 1024, 1024);
        } else {
          b0 = wgmma_desc_sw128(rb + j * 32, 16, 1024);
          b1 = wgmma_desc_sw128(rb + 64 * 128 + j * 32, 16, 1024);
        }
        wgmma_bf16_m64n64<kW, kW || kF>(acc[0], a, b0, 1);
        wgmma_bf16_m64n64<kW, kW || kF>(acc[1], a, b1, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncthreads();                 // the slot is free again
      issue();                         // into it
    }
    base += issued;

    // -- the epilogue: rows arow and arow + 8, columns 64h + 8j + 2t, + 1 -
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = arow + 8 * hr, c = n0 + 64 * h + 8 * j + 2 * t;
          const float v0 = acc[h][4 * j + 2 * hr],
                      v1 = acc[h][4 * j + 2 * hr + 1];
          if constexpr (kW) {
            if (m0 + r < p.M && c < p.N) {
              if (slot_out >= 0) {     // a split expert's f32 part
                float* dst = p.scratch + (size_t)slot_out * p.M * p.N;
                *reinterpret_cast<float2*>(dst + (size_t)(m0 + r) * p.N +
                                           c) = make_float2(v0, v1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(
                    p.out + (size_t)e * p.M * p.N + (size_t)(m0 + r) * p.N +
                    c) = __floats2bfloat162_rn(v0, v1);
              }
            }
          } else if (r < nrows && c < p.N) {
            const size_t o = (size_t)(rows0 + r) * p.N + c;
            if constexpr (kMode == BW_DGELU) {
              const float2 sv = *reinterpret_cast<const float2*>(p.s + o);
              *reinterpret_cast<__nv_bfloat162*>(p.out + o) =
                  __floats2bfloat162_rn(v0 * gelu_tanh_grad(sv.x),
                                        v1 * gelu_tanh_grad(sv.y));
              *reinterpret_cast<__nv_bfloat162*>(p.aux + o) =
                  __floats2bfloat162_rn(gelu_tanh(sv.x), gelu_tanh(sv.y));
            } else if constexpr (kF) {   // f32 s (when kept) and u
              if (p.out) store2(p.out + o, v0, v1);
              store2(p.aux + o, gelu_tanh(v0), gelu_tanh(v1));
            } else {
              *reinterpret_cast<__nv_bfloat162*>(p.out + o) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kBT, 1)
backward_gemm16(const BwT<__nv_bfloat16> p,
                const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b) {
  gemm_bf16<kMode>(p, &map_a, &map_b);
}

// The forward's up-projection on bf16 rows and weights (s and u f32): see
// gemm_bf16; an entry point of its own, so that traces tell it apart
template <int kMode>
__global__ void __launch_bounds__(kBT, 1)
forward_gemm16(const BwT<__nv_bfloat16, __nv_bfloat16, float> p,
               const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b) {
  gemm_bf16<kMode>(p, &map_a, &map_b);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// dw[e] for the experts the plan lists: the sum of e's f32 parts in part
// order (rounded once to Tout), or exact zeros for an expert without rows
// (mn = M * N, a multiple of 4)
template <typename Tout>
__global__ void wgrad_parts_sum(const int* __restrict__ plan,
                                const float* __restrict__ scratch,
                                Tout* __restrict__ out, int G, int E,
                                int rb_max, int p_max, long long mn) {
  const PlanLayout L(G, E, rb_max, p_max);
  if (plan[H_FAULT]) __trap();
  const long long n4 = mn / 4, total = (long long)plan[H_FIX] * n4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int* q = plan + L.fix + 3 * (int)(i / n4);
    const long long j = i % n4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < q[2]; ++k) {
      const float4 x =
          reinterpret_cast<const float4*>(scratch + (q[1] + k) * mn)[j];
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    store4(out + q[0] * mn + 4 * j, v);
  }
}

// -- launches --------------------------------------------------------------

struct Rows {
  const void* in;
  const int* eid;
  const void* w;
  void* out;
  float* aux;
  int G, tile, E, Z, K, N, epp;
  long long pstride;
};

template <typename Tin, typename Tw, typename Tout, int MR, int NC,
          int kEpi>
int launch(const Rows& a, cudaStream_t stream) {
  constexpr size_t smem = Geo<Tin, Tw, MR, NC>::SMEM;
  auto kern = expert_rows<Tin, Tw, Tout, MR, NC, kEpi>;
  static bool sized = false;    // dynamic + static shared memory may pass
  if (!sized) {                 // 48 KB: raise the limit once per kernel
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kern<<<dim3((a.N + NC - 1) / NC, a.E, a.Z), kThreads, smem, stream>>>(
      static_cast<const Tin*>(a.in), a.eid, static_cast<const Tw*>(a.w),
      static_cast<Tout*>(a.out), a.aux, a.G, a.tile, a.K, a.N, a.epp,
      a.pstride);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tw, typename Tout, int MR, int kEpi>
int by_cols(int NC, const Rows& a, cudaStream_t st) {
  if (NC == 64) return launch<Tin, Tw, Tout, MR, 64, kEpi>(a, st);
  if (NC == 32) return launch<Tin, Tw, Tout, MR, 32, kEpi>(a, st);
  if (NC == 16) return launch<Tin, Tw, Tout, MR, 16, kEpi>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename Tin, typename Tw, typename Tout, int kEpi>
int by_rows(int MR, int NC, const Rows& a, cudaStream_t st) {
  if (MR == 16) return by_cols<Tin, Tw, Tout, 16, kEpi>(NC, a, st);
  if (MR == 32) return by_cols<Tin, Tw, Tout, 32, kEpi>(NC, a, st);
  if (MR == 64) return by_cols<Tin, Tw, Tout, 64, kEpi>(NC, a, st);
  return (int)cudaErrorInvalidValue;
}

// zeros over the rows of every marked tile (id -1) of out [G, tile, *]:
// vec 16-byte words a tile; a block a tile at a time, grid-strided
__global__ void __launch_bounds__(256)
zero_marked_tiles(const int* __restrict__ eid, uint4* __restrict__ out,
                  int G, long long vec) {
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    if (eid[g] >= 0) continue;
    uint4* p = out + (long long)g * vec;
    for (long long i = threadIdx.x; i < vec; i += blockDim.x)
      p[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

int zero_marked(const int* eid, void* out, int G, long long tile_bytes,
                cudaStream_t st) {
  zero_marked_tiles<<<std::min(G, 1024), 256, 0, st>>>(
      eid, static_cast<uint4*>(out), G, tile_bytes / 16);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* xt, const int* eid, const void* w1, const void* w2,
        float* u, float* s, void* out, int G, int tile, int E, int epp,
        long long p1, long long p2, int D, int F, int MR, int Z,
        int up_cols, int down_cols, cudaStream_t st) {
  const int e = by_rows<T, T, float, EPI_GELU>(
      MR, up_cols, Rows{xt, eid, w1, u, s, G, tile, E, Z, D, F, epp, p1},
      st);
  if (e != 0) return e;
  const int e2 = by_rows<float, T, T, EPI_NONE>(
      MR, down_cols, Rows{u, eid, w2, out, nullptr, G, tile, E, Z, F, D, epp,
                          p2}, st);
  if (e2 != 0) return e2;
  return zero_marked(eid, out, G, (long long)tile * D * sizeof(T), st);
}

// the card's SM count, queried once (0 if the query fails)
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// library links no libcuda); null if the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a tensor map of `rank` dims of T (innermost first; strides in bytes of
// dims 1 ..) with boxes `box`, 128-byte swizzle, zeros out of bounds;
// 0 or -3 when the driver refuses it
template <typename T>
int tensor_map(CUtensorMap* m, const T* base, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  const EncodeTiled enc = encoder();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (enc == nullptr ||
      enc(m, map_type<T>(), rank, const_cast<T*>(base), dims, strides, box,
          ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -3;
  return 0;
}

// rows [rows, width] of T, boxes of bw columns x bh rows
template <typename T>
int rows_map(CUtensorMap* m, const T* base, long long rows, int width,
             int bw, int bh) {
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)bh};
  return tensor_map(m, base, 2, dims, strides, box);
}

// weights [P, epp, outer, inner] of T (expert e at (e / epp) * pstride +
// (e % epp) * outer * inner elements), boxes of bi inner x bo outer
template <typename T>
int weights_map(CUtensorMap* m, const T* base, int inner, int outer, int E,
                int epp, long long pstride, int bi, int bo) {
  constexpr cuuint64_t it = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)epp, (cuuint64_t)(E / epp)};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * it,
                                 (cuuint64_t)outer * inner * it,
                                 (cuuint64_t)pstride * it};
  const cuuint32_t box[4] = {(cuuint32_t)bi, (cuuint32_t)bo, 1, 1};
  return tensor_map(m, base, 4, dims, strides, box);
}

// one GEMM over the plan's items: a persistent grid of one block per SM
// (fewer when the items can never fill it); backward_gemm for the f32
// backward, backward_gemm16 for bf16, forward_gemm for the forward's
// products on f32 A (f32, or the bf16 down-projection's u), forward_gemm16
// for its bf16 up-projection
template <int kMode, typename TA, typename TB, typename TO>
int gemm(const BwT<TA, TB, TO>& p, const CUtensorMap& ma,
         const CUtensorMap& mb, long long items_max, cudaStream_t st) {
  constexpr bool kF32 = std::is_same<TA, float>::value;
  constexpr size_t smem = kF32 ? kBwSmem : kHSmem;
  const auto kern = [] {
    if constexpr (kMode >= FW_UP && kF32) return forward_gemm<kMode, TB, TO>;
    else if constexpr (kMode >= FW_UP) return forward_gemm16<kMode>;
    else if constexpr (kF32) return backward_gemm<kMode>;
    else return backward_gemm16<kMode>;
  }();
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)std::min<long long>(std::max(items_max, 1LL), sms);
  kern<<<grid, kBT, smem, st>>>(p, ma, mb);
  return (int)cudaGetLastError();
}

// reduction entries a stage of T: kBK f32, kHK bf16 (one 128-byte line)
template <typename T>
constexpr int stage_k() {
  return std::is_same<T, float>::value ? kBK : kHK;
}

// a dgrad product: rows p.a [R, K] times expert e's weights p.b, [N, K]
// at (e / epp) * pstride + (e % epp) * N * K
template <typename T, int kMode>
int dgrad(const BwT<T>& p, cudaStream_t st) {
  constexpr int kk = stage_k<T>();
  CUtensorMap ma, mb;
  int err = rows_map(&ma, p.a, (long long)p.G * p.tile, p.K, kk, kBM);
  if (err == 0)
    err = weights_map(&mb, p.b, p.K, p.N, p.E, p.epp, p.pstride, kk, kBN);
  if (err != 0) return err;
  return gemm<kMode>(p, ma, mb, (long long)p.rb_max * ceil_div(p.N, kBN),
                     st);
}

// a forward product: rows p.a [R, K] times expert e's weights p.b, [K, N]
// at (e / epp) * pstride + (e % epp) * K * N, over the plan's row blocks;
// the weights are staged in 128-byte lines of N (MN-major)
template <int kMode, typename TA, typename TB, typename TO>
int forward(const BwT<TA, TB, TO>& p, cudaStream_t st) {
  constexpr int kk = stage_k<TA>();
  CUtensorMap ma, mb;
  int err = rows_map(&ma, p.a, (long long)p.G * p.tile, p.K, kk, kBM);
  if (err == 0)
    err = weights_map(&mb, p.b, p.N, p.K, p.E, p.epp, p.pstride,
                      128 / (int)sizeof(TB), kk);
  if (err != 0) return err;
  return gemm<kMode>(p, ma, mb, (long long)p.rb_max * ceil_div(p.N, kBN),
                     st);
}

// a wgrad product: dw [E, M, N] from rows p.a [R, M] and p.b [R, N] by
// the plan's parts, then the part sum; the f32 kernel stages boxes of 32
// columns x kBK rows, the bf16 one boxes of 64 columns x kHK rows
template <typename T>
int wgrad(const BwT<T>& p, cudaStream_t st) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int bw = kF32 ? 32 : 64, bh = stage_k<T>();
  CUtensorMap ma, mb;
  const long long R = (long long)p.G * p.tile;
  int err = rows_map(&ma, p.a, R, p.M, bw, bh);
  if (err == 0) err = rows_map(&mb, p.b, R, p.N, bw, bh);
  if (err == 0)
    err = gemm<BW_WGRAD>(p, ma, mb,
                         (long long)p.p_max * ceil_div(p.M, kBM) *
                             ceil_div(p.N, kBN),
                         st);
  if (err != 0) return err;
  wgrad_parts_sum<T><<<4 * sm_count(), 256, 0, st>>>(
      p.plan, p.scratch, p.out, p.G, p.E, p.rb_max, p.p_max,
      (long long)p.M * p.N);
  return (int)cudaGetLastError();
}

// the dgrad's two products on T operands (see bf_grouped_ffn_dgrad)
template <typename T>
int run_dgrad(const void* g, const int* eid, const void* w1, const void* w2,
              const float* s, void* ds, void* u, void* dxt, int* plan,
              int G, int tile, int E, int epp, long long p1, long long p2,
              int D, int F, int rb_max, int p_max, cudaStream_t st) {
  BwT<T> a{};
  a.a = static_cast<const T*>(g);
  a.b = static_cast<const T*>(w2);
  a.s = s;
  a.out = static_cast<T*>(ds);
  a.aux = static_cast<T*>(u);
  a.plan = plan;
  a.N = F;
  a.K = D;
  a.G = G;
  a.tile = tile;
  a.E = E;
  a.rb_max = rb_max;
  a.p_max = p_max;
  a.epp = epp;
  a.pstride = p2;
  const int e = dgrad<T, BW_DGELU>(a, st);
  if (e != 0) return e;
  BwT<T> b = a;
  b.a = static_cast<const T*>(ds);
  b.b = static_cast<const T*>(w1);
  b.s = nullptr;
  b.out = static_cast<T*>(dxt);
  b.aux = nullptr;
  b.N = D;
  b.K = F;
  b.pstride = p1;
  const int e2 = dgrad<T, BW_DGRAD>(b, st);
  if (e2 != 0) return e2;
  return zero_marked(eid, dxt, G, (long long)tile * D * sizeof(T), st);
}

// the forward's two products on the plan's row blocks, T operands (see
// bf_grouped_ffn_gemm): up on T x T (forward_gemm16 for bf16), down on the
// f32 u x T; zero rows of out on the marked tiles
template <typename T>
int run_forward(const void* xt, const int* eid, const void* w1,
                const void* w2, float* u, float* s, void* out, int* plan,
                int G, int tile, int E, int epp, long long p1, long long p2,
                int D, int F, int rb_max, int p_max, cudaStream_t st) {
  BwT<T, T, float> a{};
  a.a = static_cast<const T*>(xt);
  a.b = static_cast<const T*>(w1);
  a.out = s;
  a.aux = u;
  a.plan = plan;
  a.N = F;
  a.K = D;
  a.G = G;
  a.tile = tile;
  a.E = E;
  a.rb_max = rb_max;
  a.p_max = p_max;
  a.epp = epp;
  a.pstride = p1;
  const int e = forward<FW_UP>(a, st);
  if (e != 0) return e;
  BwT<float, T, T> b{};
  b.a = u;
  b.b = static_cast<const T*>(w2);
  b.out = static_cast<T*>(out);
  b.plan = plan;
  b.N = D;
  b.K = F;
  b.G = G;
  b.tile = tile;
  b.E = E;
  b.rb_max = rb_max;
  b.p_max = p_max;
  b.epp = epp;
  b.pstride = p2;
  const int e2 = forward<FW_DOWN>(b, st);
  if (e2 != 0) return e2;
  return zero_marked(eid, out, G, (long long)tile * D * sizeof(T), st);
}

// the wgrad's two products on T operands (see bf_grouped_ffn_wgrad)
template <typename T>
int run_wgrad(const void* xt, const void* ds, const void* u, const void* g,
              int* plan, void* dw1, void* dw2, float* scratch, int G,
              int tile, int E, int D, int F, int rb_max, int p_max,
              cudaStream_t st) {
  BwT<T> a{};
  a.a = static_cast<const T*>(xt);
  a.b = static_cast<const T*>(ds);
  a.out = static_cast<T*>(dw1);
  a.scratch = scratch;
  a.plan = plan;
  a.M = D;
  a.N = F;
  a.G = G;
  a.tile = tile;
  a.E = E;
  a.rb_max = rb_max;
  a.p_max = p_max;
  const int e = wgrad<T>(a, st);
  if (e != 0) return e;
  a.a = static_cast<const T*>(u);
  a.b = static_cast<const T*>(g);
  a.out = static_cast<T*>(dw2);
  a.M = F;
  a.N = D;
  return wgrad<T>(a, st);
}

}  // namespace

extern "C" {

// xt [G, tile, D], tile_eid [G] int32 (every id in [-1, E); -1 marks a
// trash tile, whose rows of out are written as zeros), w1 [E, D, F],
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

// The forward on the plan's row blocks (built by
// bf_grouped_ffn_backward_plan from tile_eid with rb_max and p_max), for
// the training row counts: operands, u, s and out as bf_grouped_ffn's, two
// persistent GEMM launches (s = xt @ w1[e] with u = gelu(s) in its
// epilogue, then out = u @ w2[e]), then zero rows of out on the marked
// tiles; u and s are left unwritten there.  dtype 0 = f32 (3xTF32
// products), 1 = bf16 (bf16 x bf16 up-projection, then f32 u x bf16 w2 as
// 2xTF32: no rounding of u).  -3 when the driver has no TMA encoder.
int bf_grouped_ffn_gemm(const void* xt, const void* tile_eid, const void* w1,
                        const void* w2, void* u, void* s, void* out,
                        void* plan, int G, int tile, int E, int epp,
                        long long p1, long long p2, int D, int F,
                        int rb_max, int p_max, int dtype, void* stream) {
  if (G < 1 || tile < 1 || E < 1 || epp < 1 || E % epp || D < 8 || F < 8 ||
      D % 8 || F % 8 || p1 % 8 || p2 % 8 || rb_max < 1 || p_max < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  float* uf = static_cast<float*>(u);
  float* sf = static_cast<float*>(s);
  int* pl = static_cast<int*>(plan);
  if (dtype == 0)
    return run_forward<float>(xt, eid, w1, w2, uf, sf, out, pl, G, tile, E,
                              epp, p1, p2, D, F, rb_max, p_max, st);
  if (dtype == 1)
    return run_forward<__nv_bfloat16>(xt, eid, w1, w2, uf, sf, out, pl, G,
                                      tile, E, epp, p1, p2, D, F, rb_max,
                                      p_max, st);
  return -2;
}

// The plan's format, for the wrapper (host only): out[0..16] = the GEMM
// tile's rows (kBM) and the stage's (kBK); the header words H_RUNS,
// H_ROWBLK, H_PARTS, H_FIX, H_SLOTS and H_FAULT; PlanLayout(G, E, rb_max,
// p_max)'s offsets erows .. fix and its total.
int bf_grouped_ffn_backward_layout(int G, int E, int rb_max, int p_max,
                                   int* out) {
  if (G < 1 || E < 1 || rb_max < 1 || p_max < 1 || !out) return -1;
  const PlanLayout L(G, E, rb_max, p_max);
  const int v[] = {kBM,     kBK,      H_RUNS, H_ROWBLK, H_PARTS, H_FIX,
                   H_SLOTS, H_FAULT,  L.erows, L.eptr,  L.ecur,  L.runs,
                   L.eruns, L.rowblk, L.parts, L.fix,   L.total};
  for (int i = 0; i < 17; ++i) out[i] = v[i];
  return 0;
}

// The backward's plan for tile_eid [G] int32 (ids in [0, E)) into plan
// (int32, PlanLayout(G, E, rb_max, p_max).total words): rb_max, p_max and
// slots_max bound the row blocks, parts and scratch slots (the wrapper's
// plan_sizes), the wgrad's dw is D x F; target: the wgrad items a launch
// aims for, min_part the least rows of a part; splits > 0 forces that
// many parts on every expert with rows.
int bf_grouped_ffn_backward_plan(const void* tile_eid, void* plan, int G,
                                 int tile, int E, int D, int F, int target,
                                 int min_part, int splits, int rb_max,
                                 int p_max, int slots_max, void* stream) {
  if (G < 1 || tile < 1 || E < 1 || D < 1 || F < 1 || target < 1 ||
      min_part < 1 || splits < 0 || rb_max < 1 || p_max < 1 ||
      slots_max < 0)
    return -1;
  backward_plan<<<1, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_eid), static_cast<int*>(plan), G, tile, E,
      ceil_div(D, kBM) * ceil_div(F, kBN), target, min_part, splits, rb_max,
      p_max, slots_max);
  return (int)cudaGetLastError();
}

// The dgrad: g [G, tile, D] the output's cotangent, s [G, tile, F] the
// forward's pre-activation (f32); writes ds [G, tile, F] = (g @ w2^T) *
// gelu'(s), u [G, tile, F] = gelu(s) and dxt [G, tile, D] = ds @ w1^T, by
// the plan's row blocks (built from tile_eid), and zero rows of dxt on the
// marked tiles (ds and u are left unwritten there).  Weights and strides
// as bf_grouped_ffn's; dtype 0 = f32, 1 = bf16 (g, the weights, ds, u and
// dxt alike).
int bf_grouped_ffn_dgrad(const void* g, const void* tile_eid, const void* w1,
                         const void* w2, const void* s, void* ds, void* u,
                         void* dxt, void* plan, int G, int tile, int E,
                         int epp, long long p1, long long p2, int D, int F,
                         int rb_max, int p_max, int dtype, void* stream) {
  if (G < 1 || tile < 1 || E < 1 || epp < 1 || E % epp || D < 8 || F < 8 ||
      D % 8 || F % 8 || p1 % 8 || p2 % 8 || rb_max < 1 || p_max < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  const float* sf = static_cast<const float*>(s);
  int* pl = static_cast<int*>(plan);
  if (dtype == 0)
    return run_dgrad<float>(g, eid, w1, w2, sf, ds, u, dxt, pl, G, tile, E,
                            epp, p1, p2, D, F, rb_max, p_max, st);
  if (dtype == 1)
    return run_dgrad<__nv_bfloat16>(g, eid, w1, w2, sf, ds, u, dxt, pl, G,
                                    tile, E, epp, p1, p2, D, F, rb_max,
                                    p_max, st);
  return -2;
}

// The wgrad: dw1 [E, D, F] = per expert xt^T ds, dw2 [E, F, D] = u^T g,
// over the rows of xt, ds, u, g ([G, tile, *]) by the plan's parts;
// scratch [slots, D * F] f32 holds the parts of split experts (null when
// the plan can split none).  dtype 0 = f32 (D, F multiples of 4), 1 =
// bf16 (multiples of 8): the operands and dw1, dw2 alike.
int bf_grouped_ffn_wgrad(const void* xt, const void* ds, const void* u,
                         const void* g, void* plan, void* dw1, void* dw2,
                         void* scratch, int G, int tile, int E, int D, int F,
                         int rb_max, int p_max, int dtype, void* stream) {
  const int width = dtype == 1 ? 8 : 4;
  if (G < 1 || tile < 1 || E < 1 || D < width || F < width || D % width ||
      F % width || rb_max < 1 || p_max < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* pl = static_cast<int*>(plan);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return run_wgrad<float>(xt, ds, u, g, pl, dw1, dw2, sc, G, tile, E, D,
                            F, rb_max, p_max, st);
  if (dtype == 1)
    return run_wgrad<__nv_bfloat16>(xt, ds, u, g, pl, dw1, dw2, sc, G, tile,
                                    E, D, F, rb_max, p_max, st);
  return -2;
}

}  // extern "C"
