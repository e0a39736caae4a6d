// The pieces shared by the kernels that sweep every point pair of two clouds
// (emd.cu, nn_distance.cu, sinkhorn.cu).
//
// A group of LANES threads owns one point of one cloud ("its row") and
// strides over the other cloud, which the block stages in shared memory TILE
// points at a time, each with one per-point scalar; the group then reduces
// across its lanes with shuffles.  A block of THREADS threads serves GROUPS
// rows of one sample, so every staged point is read by all of them.
//
// Squared distances are ((dx*dx + dy*dy) + dz*dz) without fused multiply-adds,
// the rounding of pccf_torch.kernels.ops.pair_square_distance, so minima and
// argmins (strict <, the lowest index on ties) agree with the plain versions
// bit for bit.  fl(a - b) = -fl(b - a) under round-to-nearest, so the
// distance is the same whichever cloud owns the rows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANES = 8;    // threads that share one row
constexpr int GROUPS = 32;  // rows per block
constexpr int THREADS = LANES * GROUPS;
constexpr int TILE = 1024;  // points of the other cloud staged per step (16 KB)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// 2^(level2 * d): exp(level * d) with the level folded with log2(e) on the
// host, one multiply and the special-function unit's ex2 (flushing results
// below 2^-126 to zero)
__device__ __forceinline__ float exp2_level(float level2, float d) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(level2 * d));
  return y;
}

// stage points [p0, p0 + cnt) of a (P, 3) cloud, each with its scalar (0 when
// scalar is null)
__device__ __forceinline__ void stage(float4* tile, const float* pts, const float* scalar, int p0, int cnt) {
  for (int t = threadIdx.x; t < cnt; t += THREADS) {
    const float* q = pts + (long long)(p0 + t) * 3;
    tile[t] = make_float4(q[0], q[1], q[2], scalar ? scalar[p0 + t] : 0.f);
  }
}

__device__ __forceinline__ float lane_sum(float v) {
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the lexicographic (distance, index) minimum across the lanes of a group;
// every lane of the group ends with it
__device__ __forceinline__ void lane_argmin(float& best, int& best_i) {
  for (int o = LANES / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, best_i, o);
    if (ob < best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
}

// out[b] = sum over the n row values of sample b, in a fixed order (no
// atomics: the same result on every run); one block per sample
__global__ void __launch_bounds__(THREADS) sample_sum_kernel(const float* __restrict__ rows, float* __restrict__ out,
                                                             int n) {
  __shared__ float part[THREADS];
  const float* c = rows + (long long)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) s += c[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

}  // namespace
