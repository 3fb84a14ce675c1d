// Helpers shared by the port's Hopper kernels (K1/K2 flash_attention.cu,
// K3 flash_decode.cu, K4 grouped_ffn.cu): cp.async staging and the
// 3xTF32 tensor-core products.  Included inside each source's own
// translation unit; everything here is in an anonymous namespace.
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

}  // namespace
