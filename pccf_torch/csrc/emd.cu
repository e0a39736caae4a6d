// ApproxMatch EMD with its analytic gradients, and optionally the Chamfer
// nearest-neighbour min/argmin of both directions, on Hopper.
//
// Replaces pccf/kernels/pallas_emd.py:218 _call_emd_kernel (_emd_kernel:64,
// _chamfer_fold.py), which serves match_cost_tpu:302 (Chamfer off) and
// chamfer_match_cost_tpu:326 (Chamfer on).
//
// Contract (pccf/kernels/ops.py:277-342): nine relaxation levels -4^j,
// j = 7 .. -1; per level, phase 1 sets the row ratios
// ratio_l = remain_l / (K @ remain_r + 1e-9), phase 2 the column demand
// (K^T @ ratio_l) * remain_r, the consumption min(remain_r / (demand + 1e-9), 1)
// and ratio_r, phase 3 assigns w = K * ratio_l * ratio_r and updates both
// remains; K = exp(level * d2).  The cost is sum w * sqrt(d2) and the
// gradients hold the plan constant, weighting each pair by
// w * rsqrt(max(d2, 1e-20)).
//
// What bounds it: instruction issue per pair (d2, the exponential, the
// accumulations), and below that the special-function units: a schedule of one
// exp a phase needs 27 ex2 and 18 rsqrt a pair over the run, 45 x 33.5 M pairs
// at (8, 2048, 3)^2 over 16 a clock an SM x 132 SMs x ~1.75 GHz, ~0.4 ms; the
// fused sweeps' squarings below bring it to 37 a pair.  The TPU kernel keeps
// d2, K and the accumulated plan as three (N, M) fp32 matrices resident in VMEM
// (50 MB a sample) and sweeps d2 once a level; a block on the card has 227 KB
// of shared memory.  So nothing quadratic is stored: every sweep recomputes d2
// from the coordinates, staged in shared memory 1024 points at a time, and the
// per-point state (remains, ratios, cost and gradient accumulators) lives in
// global memory between launches.  The plan is never formed either: w factors
// as ratio_l[n] * ratio_r[m] * K[n, m], so the row side of phase 3 accumulates
// the cost and grad1 per row, and the column side of phase 2 accumulates grad2
// per column, scaled by ratio_r[m] once the column's demand is known.
//
// Schedule: 19 pair sweeps, as the TPU kernel fuses its phases (sweep0,
// sweepL, sweep_last at pallas_emd.py:137-191).  Phase 1 of the next level
// reads remain_r as this level's phase 2 left it (in global memory before the
// sweep) and the row's own remain_l as this level's phase 3 leaves it (in the
// same thread group), so one rows sweep computes d2 once and carries both:
//   rows P1(-4^7) [+ Chamfer rows], then per level L: columns P2(L)
//   [+ Chamfer columns at the first], then rows P3(L) + P1(next L), and at
//   the last level rows P3 alone: 1 + 9 + 8 + 1 sweeps.
// Phase 2 stays a sweep of its own: its column sums would need a reduction
// across the blocks that own the rows, which the TPU kernel gets from its
// VMEM cache and a block here cannot hold (an N x M tile of K does not fit).
//
// The exponential is the TPU kernel's (_LOG2E, level2_of at
// pallas_emd.py:49, :102-104): K = 2^(level2 * d2), level2 = level * log2(e)
// computed on the host in double and rounded once, so each pair costs one
// multiply and one ex2.approx.ftz.  In a fused sweep this level's exponent is
// four times the next one's, exactly (both folded levels are powers of four
// times one rounded log2(e)), so K of this level is K of the next squared
// twice: one ex2 a pair, where two would cost the special-function units 8
// of the 45 a pair.
//
// Design: the pair sweep of pair_sweep.cuh; a block of 256 threads serves 32
// rows (or columns) of one sample, 8 threads a row, each thread 128 staged
// points of a full tile, its pair loop unrolled 4 times (2 in the last level's
// rows sweep, which spills 8 bytes at 4): no spills, 39 registers for the first
// rows sweep, 48 for the fused ones, 40 for the last and for the columns sweep
// (nvcc 12.8, -Xptxas -v).  No atomics: a per-sample sum of the row costs ends
// the run, so the result is the same every run.  d2 is ((dx*dx + dy*dy) +
// dz*dz) without fused multiply-adds, the same rounding as the plain version,
// so the Chamfer minima and argmins (strict <, lowest index on ties) agree with
// it exactly; Chamfer rides the first rows and columns sweeps.

#include <stdint.h>

#include <cmath>

#include "pair_sweep.cuh"

namespace {

// the level -4^j folded with log2(e), in double and rounded once
float level2(int j) { return (float)(-std::ldexp(1.0, 2 * j) * 1.4426950408889634); }

__global__ void emd_fill_kernel(float* __restrict__ p, float v, long long count) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < count) p[t] = v;
}

__device__ __forceinline__ float square(float k) { return k * k; }

// Row sweeps.  P1: ratio_l = remain_l / (sum_m K1 remain_r + 1e-9), with the
// row-side Chamfer min/argmin when d1 is given.  P3: with rr = ratio_r,
// remain_l -= ratio_l * sum_m K3 rr, and the row's cost and grad1 gain
// ratio_l * sum_m K3 rr inv * (d2, x1 - x2).  Both: P3 of level3, then P1 of
// level1 on the remain_l it leaves.  K3 and K1 take their folded levels.
template <bool P1, bool P3>
__global__ void __launch_bounds__(THREADS) emd_rows_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                                                           int n, int m, float level3, float level1,
                                                           const float* __restrict__ ratio_r,
                                                           const float* __restrict__ remain_r,
                                                           float* __restrict__ remain_l, float* __restrict__ ratio_l,
                                                           float* __restrict__ cost_rows, float* __restrict__ grad1,
                                                           float* __restrict__ d1, int* __restrict__ i1) {
  constexpr bool BOTH = P1 && P3;
  __shared__ float4 tile[TILE];               // x, y, z and ratio_r (P3) or remain_r (P1 alone)
  __shared__ float tile_remain[BOTH ? TILE : 1];  // remain_r, when both phases run
  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int row = blockIdx.x * GROUPS + threadIdx.x / LANES;
  const bool valid = row < n;
  const float* p = x1 + ((long long)b * n + (valid ? row : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float* q = x2 + (long long)b * m * 3;
  const float* s = (P3 ? ratio_r : remain_r) + (long long)b * m;
  const float* s1 = BOTH ? remain_r + (long long)b * m : nullptr;
  const bool nn = P1 && d1 != nullptr;
  float acc1 = 0.f, acc3 = 0.f, cost = 0.f, winv = 0.f, wx = 0.f, wy = 0.f, wz = 0.f;
  float best = INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < m; c0 += TILE) {
    const int cnt = min(TILE, m - c0);
    __syncthreads();
    stage(tile, q, s, c0, cnt);
    if (BOTH)
      for (int t = threadIdx.x; t < cnt; t += THREADS) tile_remain[t] = s1[c0 + t];
    __syncthreads();
    if (!valid) continue;
#pragma unroll(P1 ? 4 : 2)  // P3 alone spills 8 bytes at 4
    for (int t = lane; t < cnt; t += LANES) {
      const float4 o = tile[t];
      const float d = sqdist(px, py, pz, o.x, o.y, o.z);
      const float k1 = P1 ? exp2_level(level1, d) : 0.f;
      if (P3) {
        // fused: level3 = 4 * level1 exactly, so K3 = K1^4, two squarings for a second ex2
        const float kr = (BOTH ? square(square(k1)) : exp2_level(level3, d)) * o.w;
        const float wi = kr * rsqrtf(fmaxf(d, 1e-20f));
        acc3 += kr;
        cost = fmaf(wi, d, cost);
        winv += wi;
        wx = fmaf(wi, o.x, wx);
        wy = fmaf(wi, o.y, wy);
        wz = fmaf(wi, o.z, wz);
      }
      if (P1) {
        acc1 = fmaf(k1, BOTH ? tile_remain[t] : o.w, acc1);
        if (nn && d < best) {
          best = d;
          best_i = c0 + t;
        }
      }
    }
  }
  if (P3) {
    acc3 = lane_sum(acc3);
    cost = lane_sum(cost);
    winv = lane_sum(winv);
    wx = lane_sum(wx);
    wy = lane_sum(wy);
    wz = lane_sum(wz);
  }
  if (P1) {
    acc1 = lane_sum(acc1);
    if (nn) lane_argmin(best, best_i);
  }
  if (!valid || lane != 0) return;
  const long long r = (long long)b * n + row;
  float rem = remain_l[r];
  if (P3) {
    const float rl = ratio_l[r];
    rem = fmaxf(0.f, rem - rl * acc3);
    remain_l[r] = rem;
    cost_rows[r] += rl * cost;
    grad1[r * 3 + 0] += rl * (px * winv - wx);
    grad1[r * 3 + 1] += rl * (py * winv - wy);
    grad1[r * 3 + 2] += rl * (pz * winv - wz);
  }
  if (P1) {
    ratio_l[r] = rem / (acc1 + 1e-9f);
    if (nn) {
      d1[r] = best;
      i1[r] = best_i;
    }
  }
}

// Column sweep, phase 2: demand = remain_r * sum_n K ratio_l, ratio_r =
// min(remain_r / (demand + 1e-9), 1) * remain_r, remain_r -= demand (clamped at
// 0), and grad2 gains ratio_r * sum_n K ratio_l inv * (x2 - x1); with the
// column-side Chamfer min/argmin when d2c is given.
__global__ void __launch_bounds__(THREADS) emd_cols_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                                                           int n, int m, float level, const float* __restrict__ ratio_l,
                                                           float* __restrict__ remain_r, float* __restrict__ ratio_r,
                                                           float* __restrict__ grad2, float* __restrict__ d2c,
                                                           int* __restrict__ i2) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int col = blockIdx.x * GROUPS + threadIdx.x / LANES;
  const bool valid = col < m;
  const float* p = x2 + ((long long)b * m + (valid ? col : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float* q = x1 + (long long)b * n * 3;
  const float* s = ratio_l + (long long)b * n;
  float acc = 0.f, winv = 0.f, wx = 0.f, wy = 0.f, wz = 0.f;
  float best = INFINITY;
  int best_i = 0;
  for (int r0 = 0; r0 < n; r0 += TILE) {
    const int cnt = min(TILE, n - r0);
    __syncthreads();
    stage(tile, q, s, r0, cnt);
    __syncthreads();
    if (!valid) continue;
#pragma unroll 4
    for (int t = lane; t < cnt; t += LANES) {
      const float4 o = tile[t];
      const float d = sqdist(o.x, o.y, o.z, px, py, pz);  // x1 - x2, as the rows compute it
      const float kl = exp2_level(level, d) * o.w;
      const float wi = kl * rsqrtf(fmaxf(d, 1e-20f));
      acc += kl;
      winv += wi;
      wx = fmaf(wi, o.x, wx);
      wy = fmaf(wi, o.y, wy);
      wz = fmaf(wi, o.z, wz);
      if (d2c && d < best) {
        best = d;
        best_i = r0 + t;
      }
    }
  }
  acc = lane_sum(acc);
  winv = lane_sum(winv);
  wx = lane_sum(wx);
  wy = lane_sum(wy);
  wz = lane_sum(wz);
  if (d2c) lane_argmin(best, best_i);
  if (!valid || lane != 0) return;
  const long long c = (long long)b * m + col;
  const float rr = remain_r[c];
  const float demand = acc * rr;
  const float rat = fminf(rr / (demand + 1e-9f), 1.f) * rr;
  ratio_r[c] = rat;
  remain_r[c] = fmaxf(0.f, rr - demand);
  grad2[c * 3 + 0] += rat * (px * winv - wx);
  grad2[c * 3 + 1] += rat * (py * winv - wy);
  grad2[c * 3 + 2] += rat * (pz * winv - wz);
  if (d2c) {
    d2c[c] = best;
    i2[c] = best_i;
  }
}

}  // namespace

// x1 (B, N, 3), x2 (B, M, 3) -> cost (B,), grad1 (B, N, 3), grad2 (B, M, 3);
// with d1 (B, N), i1 (B, N), d2 (B, M), i2 (B, M) when all four are given (all
// null: EMD alone).  scratch holds B * (3N + 2M) floats.  mult_l / mult_r are
// the marginals of pccf/kernels/ops.py:268.
extern "C" int pccf_chamfer_match_cost(const float* x1, const float* x2, int b, int n, int m, float mult_l,
                                       float mult_r, float* cost, float* grad1, float* grad2, float* d1, int* i1,
                                       float* d2, int* i2, float* scratch, cudaStream_t stream) {
  const bool chamfer = d1 != nullptr;
  if (b < 1 || n < 1 || m < 1 || b > 65535 || chamfer != (i1 != nullptr) || chamfer != (d2 != nullptr) ||
      chamfer != (i2 != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long bn = (long long)b * n, bm = (long long)b * m;
  float* remain_l = scratch;
  float* ratio_l = remain_l + bn;
  float* cost_rows = ratio_l + bn;
  float* remain_r = cost_rows + bn;
  float* ratio_r = remain_r + bm;
  cudaError_t err;
  emd_fill_kernel<<<(unsigned)((bn + THREADS - 1) / THREADS), THREADS, 0, stream>>>(remain_l, mult_l, bn);
  emd_fill_kernel<<<(unsigned)((bm + THREADS - 1) / THREADS), THREADS, 0, stream>>>(remain_r, mult_r, bm);
  if ((err = cudaMemsetAsync(cost_rows, 0, sizeof(float) * bn, stream)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(grad1, 0, sizeof(float) * bn * 3, stream)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(grad2, 0, sizeof(float) * bm * 3, stream)) != cudaSuccess) return (int)err;
  const dim3 row_grid((n + GROUPS - 1) / GROUPS, b), col_grid((m + GROUPS - 1) / GROUPS, b);
  emd_rows_kernel<true, false><<<row_grid, THREADS, 0, stream>>>(x1, x2, n, m, 0.f, level2(7), nullptr, remain_r,
                                                                 remain_l, ratio_l, nullptr, nullptr, d1, i1);
  for (int j = 7; j >= -1; --j) {
    const bool first = j == 7;
    emd_cols_kernel<<<col_grid, THREADS, 0, stream>>>(x1, x2, n, m, level2(j), ratio_l, remain_r, ratio_r, grad2,
                                                      first ? d2 : nullptr, first ? i2 : nullptr);
    if (j > -1)
      emd_rows_kernel<true, true><<<row_grid, THREADS, 0, stream>>>(x1, x2, n, m, level2(j), level2(j - 1), ratio_r,
                                                                    remain_r, remain_l, ratio_l, cost_rows, grad1,
                                                                    nullptr, nullptr);
    else
      emd_rows_kernel<false, true><<<row_grid, THREADS, 0, stream>>>(x1, x2, n, m, level2(j), 0.f, ratio_r, nullptr,
                                                                     remain_l, ratio_l, cost_rows, grad1, nullptr,
                                                                     nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  sample_sum_kernel<<<b, THREADS, 0, stream>>>(cost_rows, cost, n);
  return (int)cudaGetLastError();
}
