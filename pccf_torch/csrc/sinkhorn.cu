// The Sinkhorn transport cost of two clouds with its plan-constant gradients,
// and Chamfer's nearest-neighbour minima and argmins of both directions, on
// Hopper.
//
// Replaces pccf/kernels/pallas_sinkhorn.py:163 _call_sinkhorn_kernel (kernel
// :46, pallas_call at :189) as chamfer_sinkhorn_cost_tpu:257 calls it, with
// Chamfer on: the ChamferSinkhorn objective.
//
// Contract (pccf/kernels/ops.py:383-424, pallas_sinkhorn.py:82-160): the
// row-stabilised kernel K = exp(-(d2 - rowmin) / eps) with eps = 0.02, then
// u = mult_l / max(K v, 1e-30) and v = mult_r / max(K^T u, 1e-30) twelve
// times each from v = 1; the plan is w = u K v, the cost sum w sqrt(d2) and
// the gradients weight each pair by w * rsqrt(max(d2, 1e-20)).
//
// What bounds it: arithmetic.  Each update of u or v is a reduction over the
// (N, M) pairs, 24 in all, 75 operations and one exp a pair at least
// (pccf_torch/kernels/roofline.py: SINKHORN_OPS_PER_PAIR).  The TPU kernel
// keeps d2 and K resident in VMEM, two (N, M) fp32 matrices, 32 MB a sample
// at N = M = 2048: 128 MB each at batch 8, far beyond a block's 227 KB of
// shared memory and twice the L2.  So nothing quadratic is stored: every
// sweep recomputes d2 from the coordinates, staged in shared memory, and its
// exp (a sweep that re-read a stored K from device memory, ~0.04 ms for
// 128 MB, would cost more than recomputing it, ~0.01 ms of arithmetic).  The
// per-point state (rowmin, u, v, the row costs) lives in global memory
// between launches.  The plan is never formed: w factors as u[n] K[n, m]
// v[m], so the last column sweep accumulates sum_n u K rsqrt(d2) (x2 - x1)
// for each column and scales it by its new v (grad2), and the last row sweep
// the cost and grad1 of each row.
//
// Design: the pair sweep of pair_sweep.cuh (8 threads a row, 32 rows a block)
// over rows or columns, one launch per update, 26 sweeps in all:
//   build (rows, two passes): the row minimum first, then u1 from the row
//     sums of K; the extra pass keeps the plain version's rounding, where
//     rescaling the running sum online would not.  Chamfer's row side (d1,
//     i1) is the first pass: d1 is the stabiliser itself;
//   v passes (columns) x 12, the first also Chamfer's column side (d2, i2),
//     the last also grad2;
//   u passes (rows) x 11;
//   final (rows): the cost and grad1 of each row, summed per sample in a
//     fixed order.
// No sum takes an atomic, so the result is the same on every run.  exp is
// expf (no fast math), so K differs from the plain version's only where the
// sums add in another order.

#include "pair_sweep.cuh"

namespace {

// Build: rowmin = min_m d2, which is Chamfer's d1, with its argmin i1;
// u = mult_l / max(sum_m exp((d2 - rowmin) * scale), 1e-30), scale = -1/eps
__global__ void __launch_bounds__(THREADS) build_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                                                        int n, int m, float scale, float mult_l,
                                                        float* __restrict__ rowmin, float* __restrict__ u,
                                                        float* __restrict__ d1, int* __restrict__ i1) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int row = blockIdx.x * GROUPS + threadIdx.x / LANES;
  const bool valid = row < n;
  const float* p = x1 + ((long long)b * n + (valid ? row : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float* q = x2 + (long long)b * m * 3;
  float best = INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < m; c0 += TILE) {
    const int cnt = min(TILE, m - c0);
    __syncthreads();
    stage(tile, q, nullptr, c0, cnt);
    __syncthreads();
    if (!valid) continue;
    for (int t = lane; t < cnt; t += LANES) {
      const float4 o = tile[t];
      const float d = sqdist(px, py, pz, o.x, o.y, o.z);
      if (d < best) {
        best = d;
        best_i = c0 + t;
      }
    }
  }
  lane_argmin(best, best_i);  // every lane of the group now holds the row minimum
  float acc = 0.f;
  for (int c0 = 0; c0 < m; c0 += TILE) {
    const int cnt = min(TILE, m - c0);
    __syncthreads();
    stage(tile, q, nullptr, c0, cnt);
    __syncthreads();
    if (!valid) continue;
    for (int t = lane; t < cnt; t += LANES) {
      const float4 o = tile[t];
      acc += expf((sqdist(px, py, pz, o.x, o.y, o.z) - best) * scale);
    }
  }
  acc = lane_sum(acc);
  if (!valid || lane != 0) return;
  const long long r = (long long)b * n + row;
  rowmin[r] = best;
  u[r] = mult_l / fmaxf(acc, 1e-30f);
  d1[r] = best;
  i1[r] = best_i;
}

// Row sweeps.  u pass: u = mult_l / max(sum_m K v, 1e-30).  FINAL: with the
// last u, the row's cost u sum_m K v sqrt(d2) and grad1 u sum_m K v
// rsqrt(max(d2, 1e-20)) (x1 - x2).
template <bool FINAL>
__global__ void __launch_bounds__(THREADS) rows_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                                                       int n, int m, float scale, float mult_l,
                                                       const float* __restrict__ rowmin, const float* __restrict__ v,
                                                       float* __restrict__ u, float* __restrict__ cost_rows,
                                                       float* __restrict__ grad1) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int row = blockIdx.x * GROUPS + threadIdx.x / LANES;
  const bool valid = row < n;
  const long long r = (long long)b * n + (valid ? row : 0);
  const float* p = x1 + r * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float rmin = rowmin[r];
  const float* q = x2 + (long long)b * m * 3;
  const float* s = v + (long long)b * m;
  float acc = 0.f, winv = 0.f, wx = 0.f, wy = 0.f, wz = 0.f;
  for (int c0 = 0; c0 < m; c0 += TILE) {
    const int cnt = min(TILE, m - c0);
    __syncthreads();
    stage(tile, q, s, c0, cnt);
    __syncthreads();
    if (!valid) continue;
    for (int t = lane; t < cnt; t += LANES) {
      const float4 o = tile[t];
      const float d = sqdist(px, py, pz, o.x, o.y, o.z);
      const float kv = expf((d - rmin) * scale) * o.w;
      if (FINAL) {
        const float wi = kv * rsqrtf(fmaxf(d, 1e-20f));
        acc = fmaf(wi, d, acc);  // K v sqrt(d2)
        winv += wi;
        wx = fmaf(wi, o.x, wx);
        wy = fmaf(wi, o.y, wy);
        wz = fmaf(wi, o.z, wz);
      } else {
        acc += kv;
      }
    }
  }
  acc = lane_sum(acc);
  if (FINAL) {
    winv = lane_sum(winv);
    wx = lane_sum(wx);
    wy = lane_sum(wy);
    wz = lane_sum(wz);
  }
  if (!valid || lane != 0) return;
  if (FINAL) {
    const float ur = u[r];
    cost_rows[r] = ur * acc;
    grad1[r * 3 + 0] = ur * (px * winv - wx);
    grad1[r * 3 + 1] = ur * (py * winv - wy);
    grad1[r * 3 + 2] = ur * (pz * winv - wz);
  } else {
    u[r] = mult_l / fmaxf(acc, 1e-30f);
  }
}

// Column sweep, a v pass: v = mult_r / max(sum_n K u, 1e-30), with the
// column-side Chamfer min/argmin when d2c is given.  FINAL: grad2 = v sum_n u
// K rsqrt(max(d2, 1e-20)) (x2 - x1).
template <bool FINAL>
__global__ void __launch_bounds__(THREADS) cols_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                                                       int n, int m, float scale, float mult_r,
                                                       const float* __restrict__ rowmin, const float* __restrict__ u,
                                                       float* __restrict__ v, float* __restrict__ grad2,
                                                       float* __restrict__ d2c, int* __restrict__ i2) {
  __shared__ float4 tile[TILE];
  __shared__ float tile_min[TILE];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int col = blockIdx.x * GROUPS + threadIdx.x / LANES;
  const bool valid = col < m;
  const float* p = x2 + ((long long)b * m + (valid ? col : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float* q = x1 + (long long)b * n * 3;
  const float* s = u + (long long)b * n;
  const float* mins = rowmin + (long long)b * n;
  float acc = 0.f, winv = 0.f, wx = 0.f, wy = 0.f, wz = 0.f;
  float best = INFINITY;
  int best_i = 0;
  for (int r0 = 0; r0 < n; r0 += TILE) {
    const int cnt = min(TILE, n - r0);
    __syncthreads();
    stage(tile, q, s, r0, cnt);
    for (int t = threadIdx.x; t < cnt; t += THREADS) tile_min[t] = mins[r0 + t];
    __syncthreads();
    if (!valid) continue;
    for (int t = lane; t < cnt; t += LANES) {
      const float4 o = tile[t];
      const float d = sqdist(o.x, o.y, o.z, px, py, pz);
      const float ku = expf((d - tile_min[t]) * scale) * o.w;
      acc += ku;
      if (FINAL) {
        const float wi = ku * rsqrtf(fmaxf(d, 1e-20f));
        winv += wi;
        wx = fmaf(wi, o.x, wx);
        wy = fmaf(wi, o.y, wy);
        wz = fmaf(wi, o.z, wz);
      }
      if (d2c && d < best) {
        best = d;
        best_i = r0 + t;
      }
    }
  }
  acc = lane_sum(acc);
  if (FINAL) {
    winv = lane_sum(winv);
    wx = lane_sum(wx);
    wy = lane_sum(wy);
    wz = lane_sum(wz);
  }
  if (d2c) lane_argmin(best, best_i);
  if (!valid || lane != 0) return;
  const long long c = (long long)b * m + col;
  const float vc = mult_r / fmaxf(acc, 1e-30f);
  v[c] = vc;
  if (FINAL) {
    grad2[c * 3 + 0] = vc * (px * winv - wx);
    grad2[c * 3 + 1] = vc * (py * winv - wy);
    grad2[c * 3 + 2] = vc * (pz * winv - wz);
  }
  if (d2c) {
    d2c[c] = best;
    i2[c] = best_i;
  }
}

}  // namespace

// x1 (B, N, 3), x2 (B, M, 3) -> cost (B,), grad1 (B, N, 3), grad2 (B, M, 3),
// d1 (B, N), i1 (B, N), d2 (B, M), i2 (B, M).  scratch holds B * (3N + M)
// floats.  mult_l / mult_r
// are the marginals of pccf/kernels/ops.py:268, eps the entropic
// regularisation, iters the number of (u, v) updates.
extern "C" int pccf_sinkhorn_cost(const float* x1, const float* x2, int b, int n, int m, float mult_l, float mult_r,
                                  float eps, int iters, float* cost, float* grad1, float* grad2, float* d1, int* i1,
                                  float* d2, int* i2, float* scratch, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535 || iters < 1 || !(eps > 0.f) || !d1 || !i1 || !d2 || !i2)
    return (int)cudaErrorInvalidValue;
  const long long bn = (long long)b * n;
  float* rowmin = scratch;
  float* u = rowmin + bn;
  float* cost_rows = u + bn;
  float* v = cost_rows + bn;
  const float scale = -1.f / eps;
  const dim3 row_grid((n + GROUPS - 1) / GROUPS, b), col_grid((m + GROUPS - 1) / GROUPS, b);
  cudaError_t err;
  build_kernel<<<row_grid, THREADS, 0, stream>>>(x1, x2, n, m, scale, mult_l, rowmin, u, d1, i1);
  for (int it = 1; it <= iters; ++it) {
    float* d2_it = it == 1 ? d2 : nullptr;
    int* i2_it = it == 1 ? i2 : nullptr;
    if (it < iters) {
      cols_kernel<false><<<col_grid, THREADS, 0, stream>>>(x1, x2, n, m, scale, mult_r, rowmin, u, v, nullptr, d2_it,
                                                           i2_it);
      rows_kernel<false><<<row_grid, THREADS, 0, stream>>>(x1, x2, n, m, scale, mult_l, rowmin, v, u, nullptr,
                                                           nullptr);
    } else {
      cols_kernel<true><<<col_grid, THREADS, 0, stream>>>(x1, x2, n, m, scale, mult_r, rowmin, u, v, grad2, d2_it,
                                                          i2_it);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  rows_kernel<true><<<row_grid, THREADS, 0, stream>>>(x1, x2, n, m, scale, mult_l, rowmin, v, u, cost_rows, grad1);
  sample_sum_kernel<<<b, THREADS, 0, stream>>>(cost_rows, cost, n);
  return (int)cudaGetLastError();
}
