// The 3xTF32 tensor-core and cp.async helpers shared by the tc variants of
// matmul.cu (K1, K2), flash_attention.cu (K3) and ssd.cu (K7).
//
// 3xTF32: v = big + small, both TF32, and a product of two f32 operands is
// big*big + big*small + small*big summed in f32, which keeps f32 accuracy
// where one TF32 pass keeps ~3 digits.  The tensor cores' accumulator
// truncates, so callers sum each 8-deep step from zero and add it to their
// own f32 registers.
//
// kernels/_build.py hashes this header with every source that includes it,
// so an edited header rebuilds their libraries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// big is v truncated to TF32's 10 mantissa bits, small the exact remainder
// v - big truncated the same way, so |v - big - small| <= 2^-20 |v|.
// Masks, not cvt.rna (a quarter-rate instruction that each warp would repeat
// for every fragment element).  Finite inputs: an infinite v gives a NaN
// small.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

// c += a . b on one m16n8k8 tile.  a: a0 (row g, k t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b: b0 (k t, col g), b1 (t + 4, g);
// c: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1), with
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g));
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n (0 to 3) copy groups of this thread are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

}  // namespace
