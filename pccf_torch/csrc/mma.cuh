// Warp-level TF32 tensor-core helpers shared by the kNN distance tiles
// (knn.cu) and the stacks' attention (wformer.cu).
//
// mma.sync.m16n8k8 with TF32 operands and fp32 accumulation.  Fragment
// layout (PTX ISA, "Matrix Fragments for mma.m16n8k8" with .tf32), with
// g = lane / 4 and t = lane % 4:
//   A (16x8, row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8x8,  col):  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C (16x8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pccf {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both representable in TF32 (the 3xTF32 split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a * b at ~fp32 accuracy: small products first, then the big one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2], const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

}  // namespace pccf
