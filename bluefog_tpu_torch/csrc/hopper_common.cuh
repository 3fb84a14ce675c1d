// Helpers shared by the port's Hopper kernels (K1/K2 flash_attention.cu,
// K3 flash_decode.cu, K4 grouped_ffn.cu): cp.async staging, the 3xTF32
// tensor-core products, and the mbarrier, TMA and wgmma pieces of K4's
// backward (tf32 with A in registers, bf16 with both operands in shared
// memory).  Included inside each source's own translation unit;
// everything here is in an anonymous namespace.
//
// 3xTF32: an f32 operand x splits into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big); mma.sync.m16n8k8.tf32 accumulates small*big +
// big*small before big*big in f32, which is f32 accurate.  A value that
// is exact in TF32 (a widened bf16) has small = 0 and its small MMA is
// dropped at compile time.  The tensor cores add into their accumulator
// by truncation, so mma3_rn takes the product into a zeroed fragment and
// adds it to the running sum with round-to-nearest.
//
// m16n8k8 fragments, with lane = 4 g + t:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4);
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//     c3 (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- cp.async ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- 3xTF32 fragments and products ---------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as big + small TF32 parts; EXACT (a widened bf16) has small = 0
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  if (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
  }
}

struct FragA { uint32_t b[4], s[4]; };
struct FragB { uint32_t b[2], s[2]; };

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b at f32 accuracy: the small terms first, then big . big
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  if (!A_EXACT) mma(c, a.s, b.b[0], b.b[1]);
  if (!B_EXACT) mma(c, a.b, b.s[0], b.s[1]);
  mma(c, a.b, b.b[0], b.b[1]);
}

// the same into a zeroed fragment that is then added to c with
// round-to-nearest (the tensor cores add by truncation; see the header)
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3_rn(float (&c)[4], const FragA& a,
                                        const FragB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma3<A_EXACT, B_EXACT>(d, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// -- mbarriers and TMA (sm_90) ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// the barriers' initialization made visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
// a box of a 2-D / 4-D tensor map (`map`: the address of a
// __grid_constant__ CUtensorMap) into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma (sm_90a): tf32 m64n128k8 with A in registers --------------------
//
// A warpgroup (four warps, 128 threads) multiplies a 64 x 8 A (registers,
// the m16n8k8 fragment above per warp: warp w of the group holds rows
// 16w .. 16w + 15) by an 8 x 128 B read from shared memory through a
// descriptor.  tf32 wgmma takes only K-major operands from shared memory
// (its transpose flags are for 16-bit types): B is stored as 128 rows n
// of K entries, in 8-row x 16-byte core matrices (no swizzle), the core
// matrices of one 8-row group `lbo` bytes apart along K and the 8-row
// groups `sbo` bytes apart along N.  The accumulator d[64] holds, for
// each 8-column block j, d[4j] (row g, col 8j + 2t), d[4j + 1] (g, 8j +
// 2t + 1), d[4j + 2] (g + 8, 8j + 2t), d[4j + 3] (g + 8, 8j + 2t + 1) of
// the warp's 16 rows.  With scale_d 0 the product overwrites d.

__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  // start address, LBO and SBO in 16-byte units; base offset 0; layout
  // type 0 (no swizzle) in bits 62-63
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of r across the point
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b_desc,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(scale_d));
}

// -- wgmma (sm_90a): bf16 m64n64k16, both operands in shared memory --------
//
// A (64 x 16) and B (16 x 64) are read through descriptors of tiles that
// TMA wrote with the 128-byte swizzle: 128-byte lines, line l's 16-byte
// chunk c at chunk c ^ (l % 8), 8 lines (1 KB, 1 KB aligned) an atom.
// K-major (trans 0): a line is one row of 64 reduction entries; a k step
// of 16 entries starts 32 bytes further along the line; the 8-line atoms
// along M / N are `sbo` bytes apart.  MN-major (trans 1): a line is one
// reduction entry's 64 rows (or columns); the 8-line atoms along the
// reduction are `sbo` bytes apart, a k step starts two atoms further, and
// 64 rows are one atom wide, so the atom stride along M / N (`lbo`) is
// never crossed.  The accumulator d[32] holds, per 8-column block j,
// d[4j] .. d[4j + 3] as the tf32 product's d[64] does.

__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  // layout type 1 (128-byte swizzle) in bits 62-63, base offset 0 (atoms
  // 1 KB aligned)
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16_m64n64(float (&d)[32],
                                                  uint64_t a_desc,
                                                  uint64_t b_desc,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(kTransA),
        "n"(kTransB));
}

}  // namespace
