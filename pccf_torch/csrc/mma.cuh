// Warp-level TF32 tensor-core helpers shared by the PCGen and CVAE kernels.
//
// mma.sync.m16n8k8 with TF32 operands and fp32 accumulation.  Fragment
// layout (PTX ISA, "Matrix Fragments for mma.m16n8k8" with .tf32), with
// g = lane / 4 and t = lane % 4:
//   A (16x8, row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8x8,  col):  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C (16x8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// The kernels permute the reduction index inside each 16-wide k block: in
// step s (0 or 1) lane t feeds physical columns 4t+2s and 4t+2s+1 into the
// MMA slots t and t+4.  A dot product does not depend on the order of its
// terms, and the permutation lets every lane fetch its whole k block with one
// 16-byte (fp32) or 8-byte (bf16) load.  With row strides of 16 (mod 32)
// words, the 16-byte shared-memory loads are bank-conflict free.

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

// bf16 bits -> fp32 bits: exact, and exact in TF32 too
__device__ __forceinline__ uint32_t bf16_bits_to_f32(uint16_t h) { return (uint32_t)h << 16; }

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragments for both k steps of a 16-wide k block, from a row-major fp32
// tile in shared memory: rows r0 and r0+8, columns k0 + 4t .. 4t+3.
__device__ __forceinline__ void load_a_k16(const float* tile, int stride, int r0, int k0, int lane,
                                           float4& top, float4& bottom) {
  const int g = lane >> 2, t = lane & 3;
  top = *reinterpret_cast<const float4*>(tile + (r0 + g) * stride + k0 + 4 * t);
  bottom = *reinterpret_cast<const float4*>(tile + (r0 + g + 8) * stride + k0 + 4 * t);
}

// the A fragment of step s from the two float4 of load_a_k16, rounded to TF32
__device__ __forceinline__ void a_frag(const float4& top, const float4& bottom, int s, uint32_t (&a)[4]) {
  a[0] = tf32(s ? top.z : top.x);
  a[1] = tf32(s ? bottom.z : bottom.x);
  a[2] = tf32(s ? top.w : top.y);
  a[3] = tf32(s ? bottom.w : bottom.y);
}

// the same, split into big and small TF32 parts (3xTF32)
__device__ __forceinline__ void a_frag_split(const float4& top, const float4& bottom, int s, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
  split_tf32(s ? top.z : top.x, big[0], small[0]);
  split_tf32(s ? bottom.z : bottom.x, big[1], small[1]);
  split_tf32(s ? top.w : top.y, big[2], small[2]);
  split_tf32(s ? bottom.w : bottom.y, big[3], small[3]);
}

// acc += a * b at ~fp32 accuracy: small products first, then the big one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2], const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

}  // namespace pccf
