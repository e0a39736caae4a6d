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
// What bounds it: the special-function units.  Each update of u or v is a
// reduction over the (N, M) pairs.  The TPU kernel keeps d2 and K resident in
// VMEM, two (N, M) fp32 matrices, 32 MB a sample at N = M = 2048: 128 MB each
// at batch 8, far beyond a block's 227 KB of shared memory and twice the L2.
// So nothing quadratic is stored: every sweep recomputes K from the
// coordinates staged in shared memory, one ex2 a pair (re-reading a stored K
// would move 134 MB a sweep, ~0.04 ms, four times the sweep's ex2 time).  25
// sweeps of one ex2 a pair and the two last sweeps' rsqrt, 27 x 33.5 M pairs
// at (8, 2048, 3)^2 over 16 a clock an SM x 132 SMs x 1.98 GHz, ~0.22 ms:
// that is this schedule's floor, so every other instruction of a pair is
// weighed against the ex2's 8 issue cycles a warp.
//
// The exponential is the TPU kernel's (pallas_sinkhorn.py:80, :97): K =
// 2^(s2 (d2 - rowmin)), s2 = -log2(e) / eps computed on the host in double
// and rounded once, by ex2.approx.ftz.  The scalings ride in the exponent:
// K v = 2^(s2 d2 - s2 rowmin + log2 v), so a sweep adds one term a pair and
// never multiplies.  Each sweep hands the other side a "pack" of each of its
// points, a float4 written once a point: the middle sweeps' expanded form
// (the JAX golden's |x|^2 - 2 x.y + |y|^2, ops.py:395) stages each point q
// of the other cloud as (-2 s2 q, s2 |q|^2 + t) and keeps its own point's
// s2 |p|^2 (minus s2 rowmin on the rows side), so the exponent is 3 FMAs
// and an add; the differences form (p, t) takes 3 subtractions, a multiply
// and 3 FMAs, and serves the sweeps that also need d2 itself (in the middle
// sweeps it was 5-18% slower: PERF.md, section 6).  t is log2 of
// the scaling, minus s2 rowmin for a row.
//
// Schedule, 25 sweeps (sinkhorn.py schedule() lists them):
//   build (rows): exact d2, the row minimum with its argmin (Chamfer's d1,
//     i1, the stabiliser itself) and u1 in one pass: the running sum of K is
//     rescaled by 2^(s2 (old min - new min)) when the minimum falls;
//   v passes (columns) x 12: the first on exact d2, which also takes
//     Chamfer's column side (d2, i2); the last also grad2;
//   u passes (rows) x 11;
//   final (rows): the cost and grad1 of each row, summed per sample in a
//     fixed order (sample_sum_kernel).
// The update of u needs every v and the next v every u, so the sweeps cannot
// fuse as emd.cu's do.  Where both sides' grids are the same, every sweep
// after the build is launched with programmatic dependent launch: it loads
// its own points, waits for the sweep before, then lets the next be
// scheduled, so the next grid's blocks are resident when this one drains
// (where the grids differ, the smaller one launched early would crowd onto
// the first SMs to free up, and plain launches are faster).
//
// Design: a warp owns OWN = 4 points of one side of one sample in
// registers, its 32 lanes stride over the other side's packs staged in
// shared memory (2048 at a time), so one staged pack serves four pairs; a
// block of 16 warps owns 64 points, or of 8 warps 32 where 16 would leave SMs
// without a block (shape_for, mirrored by sinkhorn.py sweep_plan): the
// larger block halves the bytes every block stages from L2.  The lanes' sums
// meet by shuffles in a fixed order.  No atomics anywhere, so a call gives
// the same bits every time.  Chamfer's minima and argmins come from d2 as
// sqdist rounds it (strict <, the lowest index on ties), bit-exact to the
// plain version.  A middle sweep issues 6 instructions a pair (4 FMAs and
// adds, the ex2, the accumulate) against the ex2's 8 cycles a warp, so the
// special-function units are its limit; no kernel spills (nvcc 12.8, at most
// 64 registers).

#include <math.h>
#include <stdint.h>

#include "pair_sweep.cuh"

namespace {

constexpr int OWN = 4;                  // points of the warp's own side held by each thread
constexpr int MAX_SWEEP_THREADS = 512;  // 16 warps; 8 where 16 would leave SMs idle (shape_for)
constexpr int SWEEP_TILE = 2048;        // packs of the other side staged per step (32 KB)

enum Mode { CHAMFER, MIDDLE, FINAL };

// One sweep over a side's points ("own") against the other side's packs.
struct Sweep {
  const float* own;        // (B, n_own, 3)
  const float4* other;     // (B, n_other) packs of the other side
  int n_own, n_other;
  float s2, mult;
  const float* rowmin;     // rows sweeps: (B, n) the stabiliser; null on the columns side
  const float* own_scale;  // the final rows sweep: u
  float* scale;            // the scaling this sweep updates (u or v)
  float4* pack;            // this side's packs for the next sweep
  float* dist;             // the first columns sweep: Chamfer's column minima and argmins
  int* idx;
  float* cost_rows;        // the final rows sweep
  float* grad;             // the final sweeps: grad1 or grad2
};

__device__ __forceinline__ float norm2(float x, float y, float z) { return fmaf(z, z, fmaf(y, y, x * x)); }

// the pack of a point (x, y, z) with term t: expanded (-2 s2 p, s2 |p|^2 + t)
// or differences (p, t)
template <bool EXPANDED>
__device__ __forceinline__ float4 make_pack(float x, float y, float z, float s2, float t) {
  if (EXPANDED) {
    const float c = -2.f * s2;
    return make_float4(c * x, c * y, c * z, fmaf(s2, norm2(x, y, z), t));
  }
  return make_float4(x, y, z, t);
}

// s2 |p - q|^2 + the terms from q's expanded pack a, c the own point's
// s2 |p|^2 + its term
__device__ __forceinline__ float exponent_expanded(float px, float py, float pz, float4 a, float c) {
  return fmaf(px, a.x, fmaf(py, a.y, fmaf(pz, a.z, a.w + c)));
}

// write the own point's new scaling and its pack (t = log2 scaling + term);
// returns the scaling
template <bool OUT_EXPANDED>
__device__ __forceinline__ float write_scale(const Sweep& s, long long i, float x, float y, float z, float acc,
                                             float term) {
  const float sc = s.mult / fmaxf(acc, 1e-30f);
  s.scale[i] = sc;
  s.pack[i] = make_pack<OUT_EXPANDED>(x, y, z, s.s2, log2f(sc) + term);
  return sc;
}

// Build: d1 = rowmin = min_m d2 with its argmin, and u = mult_l / max(sum_m
// 2^(s2 (d2 - rowmin)), 1e-30) in one pass over x2; the rows' packs in the
// differences form for the first columns sweep.
__global__ void __launch_bounds__(MAX_SWEEP_THREADS, 2) sinkhorn_build_kernel(const float* __restrict__ x1,
                                                                 const float* __restrict__ x2, int n, int m, float s2,
                                                                 float mult_l, float* __restrict__ rowmin,
                                                                 float* __restrict__ u, float4* __restrict__ pack,
                                                                 float* __restrict__ d1, int* __restrict__ i1) {
  __shared__ float4 tile[SWEEP_TILE];
  const int b = blockIdx.y, lane = threadIdx.x % 32;
  const int first = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * OWN;
  float px[OWN], py[OWN], pz[OWN], best[OWN], acc[OWN], nb[OWN];
  int best_i[OWN];
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    const float* p = x1 + ((long long)b * n + min(first + r, n - 1)) * 3;
    px[r] = p[0];
    py[r] = p[1];
    pz[r] = p[2];
    best[r] = INFINITY;
    acc[r] = 0.f;
    nb[r] = -INFINITY;
    best_i[r] = 0;
  }
  let_next_sweep_launch();
  const float* q = x2 + (long long)b * m * 3;
  for (int c0 = 0; c0 < m; c0 += SWEEP_TILE) {
    const int cnt = min(SWEEP_TILE, m - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const float* o = q + (long long)(c0 + t) * 3;
      tile[t] = make_float4(o[0], o[1], o[2], 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int t = lane; t < cnt; t += 32) {  // each lane sees its candidates in rising index
      const float4 o = tile[t];
#pragma unroll
      for (int r = 0; r < OWN; ++r) {
        const float d = sqdist(px[r], py[r], pz[r], o.x, o.y, o.z);
        if (d < best[r]) {  // the minimum falls: rescale the running sum to it; its own K is 1
          acc[r] = fmaf(acc[r], ex2_ftz(s2 * (best[r] - d)), 1.f);
          best[r] = d;
          best_i[r] = c0 + t;
          nb[r] = -(s2 * d);
        } else {
          acc[r] += ex2_ftz(fmaf(s2, d, nb[r]));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < OWN; ++r) {  // the lanes' (minimum, sum at that minimum) meet in a fixed order
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best[r], o), oa = __shfl_xor_sync(FULL, acc[r], o);
      const int oi = __shfl_xor_sync(FULL, best_i[r], o);
      const float mb = fminf(best[r], ob);
      const float mine = best[r] == mb ? acc[r] : acc[r] * ex2_ftz(s2 * (best[r] - mb));
      const float theirs = ob == mb ? oa : oa * ex2_ftz(s2 * (ob - mb));
      acc[r] = mine + theirs;  // the same sum on both lanes: fp32 addition commutes
      if (ob < best[r] || (ob == best[r] && oi < best_i[r])) best_i[r] = oi;
      best[r] = mb;
    }
  }
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    if (lane != r || first + r >= n) continue;
    const long long i = (long long)b * n + first + r;
    rowmin[i] = best[r];
    d1[i] = best[r];
    i1[i] = best_i[r];
    const float uu = mult_l / fmaxf(acc[r], 1e-30f);
    u[i] = uu;
    pack[i] = make_pack<false>(px[r], py[r], pz[r], s2, log2f(uu) - s2 * best[r]);  // the rows sweeps' term
  }
}

// A rows (ROWS) or columns sweep.  CHAMFER (the first columns sweep): v on
// exact d2, with the column minima and argmins.  MIDDLE: u or v.  FINAL: the
// last v with grad2 = v sum_n u K rsqrt(max(d2, 1e-20)) (x2 - x1), or, on the
// rows side, each row's cost u sum_m K v sqrt(d2) and grad1.  A middle
// sweep stages expanded packs, the others, which need d2 itself, differences
// packs; OUT_EXPANDED: the form of the packs written.
template <int MODE, bool ROWS, bool OUT_EXPANDED>
__global__ void __launch_bounds__(MAX_SWEEP_THREADS, 2) sinkhorn_sweep_kernel(const Sweep s) {
  static_assert(MODE != CHAMFER || !ROWS, "Chamfer's column side");
  constexpr bool IN_EXPANDED = MODE == MIDDLE;
  constexpr bool SCALES = !(MODE == FINAL && ROWS);  // every sweep but the final rows updates its scaling
  __shared__ float4 tile[SWEEP_TILE];
  const int b = blockIdx.y, lane = threadIdx.x % 32;
  const int first = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * OWN;
  float px[OWN], py[OWN], pz[OWN];
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    const float* p = s.own + ((long long)b * s.n_own + min(first + r, s.n_own - 1)) * 3;
    px[r] = p[0];
    py[r] = p[1];
    pz[r] = p[2];
  }
  wait_for_previous_sweep();
  let_next_sweep_launch();
  // term: -s2 rowmin of a row, 0 for a column; c: what the exponent adds to a staged pack's w
  float term[OWN], c[OWN];
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    term[r] = ROWS ? -s.s2 * s.rowmin[(long long)b * s.n_own + min(first + r, s.n_own - 1)] : 0.f;
    c[r] = IN_EXPANDED ? fmaf(s.s2, norm2(px[r], py[r], pz[r]), term[r]) : term[r];
  }
  float acc[OWN], winv[OWN], wx[OWN], wy[OWN], wz[OWN], best[OWN];
  int best_i[OWN];
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    acc[r] = winv[r] = wx[r] = wy[r] = wz[r] = 0.f;
    best[r] = INFINITY;
    best_i[r] = 0;
  }
  const float4* other = s.other + (long long)b * s.n_other;
  for (int c0 = 0; c0 < s.n_other; c0 += SWEEP_TILE) {
    const int cnt = min(SWEEP_TILE, s.n_other - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) tile[t] = other[c0 + t];
    __syncthreads();
#pragma unroll(MODE == MIDDLE ? 4 : 2)
    for (int t = lane; t < cnt; t += 32) {
      const float4 a = tile[t];
#pragma unroll
      for (int r = 0; r < OWN; ++r) {
        if (MODE == MIDDLE) {
          acc[r] += ex2_ftz(exponent_expanded(px[r], py[r], pz[r], a, c[r]));
        } else if (MODE == CHAMFER) {
          const float d = sqdist(a.x, a.y, a.z, px[r], py[r], pz[r]);  // x1 - x2, as the build computes it
          acc[r] += ex2_ftz(fmaf(s.s2, d, a.w));
          if (d < best[r]) {
            best[r] = d;
            best_i[r] = c0 + t;
          }
        } else {
          const float dx = px[r] - a.x, dy = py[r] - a.y, dz = pz[r] - a.z;
          const float d = norm2(dx, dy, dz);
          const float k = ex2_ftz(fmaf(s.s2, d, a.w + c[r]));  // K v (rows) or K u (columns)
          const float wi = k * rsqrtf(fmaxf(d, 1e-20f));
          acc[r] = ROWS ? fmaf(wi, d, acc[r]) : acc[r] + k;  // rows: K v sqrt(d2); columns: K u
          winv[r] += wi;
          wx[r] = fmaf(wi, a.x, wx[r]);
          wy[r] = fmaf(wi, a.y, wy[r]);
          wz[r] = fmaf(wi, a.z, wz[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    acc[r] = warp_sum(acc[r]);
    if (MODE == FINAL) {
      winv[r] = warp_sum(winv[r]);
      wx[r] = warp_sum(wx[r]);
      wy[r] = warp_sum(wy[r]);
      wz[r] = warp_sum(wz[r]);
    }
    if (MODE == CHAMFER) warp_argmin(best[r], best_i[r]);
  }
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    if (lane != r || first + r >= s.n_own) continue;
    const long long i = (long long)b * s.n_own + first + r;
    float sc;
    if (SCALES) {
      sc = write_scale<OUT_EXPANDED>(s, i, px[r], py[r], pz[r], acc[r], term[r]);
    } else {
      sc = s.own_scale[i];
      s.cost_rows[i] = sc * acc[r];
    }
    if (MODE == FINAL) {
      s.grad[i * 3 + 0] = sc * (px[r] * winv[r] - wx[r]);
      s.grad[i * 3 + 1] = sc * (py[r] * winv[r] - wy[r]);
      s.grad[i * 3 + 2] = sc * (pz[r] * winv[r] - wz[r]);
    }
    if (MODE == CHAMFER) {
      s.dist[i] = best[r];
      s.idx[i] = best_i[r];
    }
  }
}

// a sweep over the points of one side: 16 warps a block where that still
// gives every SM a block, else 8; one sample a row of the grid
struct Shape {
  dim3 grid;
  int threads;
};

Shape shape_for(int points, int b, int sms) {
  for (int threads = MAX_SWEEP_THREADS;; threads /= 2) {
    const int per_block = threads / 32 * OWN;
    const unsigned blocks = (unsigned)((points + per_block - 1) / per_block);
    if (threads == MAX_SWEEP_THREADS / 2 || (long long)blocks * b >= sms) return {dim3(blocks, b), threads};
  }
}

// programmatic launches only where both sides' grids are the same: a smaller
// grid launched early lands on the first SMs to free up, as many blocks each
// as fit, and leaves the others idle
bool same_shape(Shape rows, Shape cols) { return rows.grid.x == cols.grid.x && rows.threads == cols.threads; }

// the 24 sweeps after the build and the per-sample sum
cudaError_t sweeps(const Sweep& rows, const Sweep& cols, Shape row_shape, Shape col_shape, int iters, bool pdl,
                   float* cost, int b, cudaStream_t stream) {
  const auto on_rows = [&](auto kernel) {
    return launch(kernel, row_shape.grid, row_shape.threads, pdl, stream, rows);
  };
  const auto on_cols = [&](auto kernel) {
    return launch(kernel, col_shape.grid, col_shape.threads, pdl, stream, cols);
  };
  cudaError_t err = cudaSuccess;
  for (int it = 1; it <= iters; ++it) {
    if (it == 1)
      err = on_cols(sinkhorn_sweep_kernel<CHAMFER, false, true>);
    else if (it == iters)
      err = on_cols(sinkhorn_sweep_kernel<FINAL, false, false>);
    else
      err = on_cols(sinkhorn_sweep_kernel<MIDDLE, false, true>);
    if (err != cudaSuccess || it == iters) break;
    if (it + 1 == iters)  // the last u pass hands the final columns sweep differences packs
      err = on_rows(sinkhorn_sweep_kernel<MIDDLE, true, false>);
    else
      err = on_rows(sinkhorn_sweep_kernel<MIDDLE, true, true>);
    if (err != cudaSuccess) return err;
  }
  if (err != cudaSuccess || (err = on_rows(sinkhorn_sweep_kernel<FINAL, true, false>)) != cudaSuccess)
    return err;
  return launch(sample_sum_kernel, dim3(b), THREADS, pdl, stream, rows.cost_rows, cost, rows.n_own);
}

}  // namespace

// x1 (B, N, 3), x2 (B, M, 3) -> cost (B,), grad1 (B, N, 3), grad2 (B, M, 3),
// d1 (B, N), i1 (B, N), d2 (B, M), i2 (B, M).  scratch holds B * (7N + 5M)
// floats, 16-byte aligned.  mult_l / mult_r are the marginals of
// pccf/kernels/ops.py:268, eps the entropic regularisation, iters (>= 2) the
// number of v updates.
extern "C" int pccf_sinkhorn_cost(const float* x1, const float* x2, int b, int n, int m, float mult_l, float mult_r,
                                  float eps, int iters, float* cost, float* grad1, float* grad2, float* d1, int* i1,
                                  float* d2, int* i2, float* scratch, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535 || iters < 2 || !(eps > 0.f) || !d1 || !i1 || !d2 || !i2 ||
      ((uintptr_t)scratch & 15))
    return (int)cudaErrorInvalidValue;
  const long long bn = (long long)b * n, bm = (long long)b * m;
  float4* row_pack = reinterpret_cast<float4*>(scratch);
  float4* col_pack = row_pack + bn;
  float* rowmin = reinterpret_cast<float*>(col_pack + bm);
  float* u = rowmin + bn;
  float* cost_rows = u + bn;
  float* v = cost_rows + bn;
  const float s2 = (float)(-1.4426950408889634 / (double)eps);
  cudaError_t err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const Shape row_shape = shape_for(n, b, sms), col_shape = shape_for(m, b, sms);
  const bool pdl = same_shape(row_shape, col_shape);
  // the build follows whatever wrote x1 and x2: a plain launch
  err = launch(sinkhorn_build_kernel, row_shape.grid, row_shape.threads, false, stream, x1, x2, n, m, s2, mult_l,
               rowmin, u, row_pack, d1, i1);
  if (err != cudaSuccess) return (int)err;
  const Sweep rows{x1, col_pack, n, m, s2, mult_l, rowmin, u, u, row_pack, nullptr, nullptr, cost_rows, grad1};
  const Sweep cols{x2, row_pack, m, n, s2, mult_r, nullptr, nullptr, v, col_pack, d2, i2, nullptr, grad2};
  return (int)sweeps(rows, cols, row_shape, col_shape, iters, pdl, cost, b, stream);
}

// the sweeps' plan on a card of sms SMs: plan[0..4] = blocks a sample and
// threads a block of the rows sweeps, the same of the columns sweeps, and 1
// where the sweeps are launched programmatically
extern "C" int pccf_sinkhorn_plan(int b, int n, int m, int sms, int* plan) {
  if (b < 1 || n < 1 || m < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const Shape rows = shape_for(n, b, sms), cols = shape_for(m, b, sms);
  plan[0] = (int)rows.grid.x;
  plan[1] = rows.threads;
  plan[2] = (int)cols.grid.x;
  plan[3] = cols.threads;
  plan[4] = same_shape(rows, cols);
  return 0;
}
