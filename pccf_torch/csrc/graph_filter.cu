// Graph filtering as one fused pass on Hopper, forward and backward: the
// k = 4 search on the decoded cloud's coordinates, the gather of the three
// neighbours after slot 0, their Gaussian weights under the per-cloud
// bandwidth, and the sharpened cloud.
//
// Replaces what pccf/kernels/api.py:178-181 composes for graph filtering:
// pallas_knn.py:183 knn_tpu at k = 4, pallas_gather.py:309 _gather_forward
// (pallas_call at :312) and the XLA fusion of ops.py:207-219; in training
// also the backward of that fusion and of the gather (pallas_gather.py:341,
// whose row scatter pccf_torch/kernels/graph_filter.py still launches as
// scatter_add_rows).  What it computes is
// ops.graph_filtering_with_idx(x, knn(x, 4)):
//   dist_j  = sqrt(|sum_c (x_i - y_j)_c^2| + 1e-12), y_j = x[idx[i, j]], j = 1..3
//   sigma   = max(mean_i dist_1(i), 0.005), one per cloud
//   w_j     = exp(-dist_j / sigma)
//   out_i   = (1 + sum_j w_j) x_i - sum_j w_j y_j
//
// What bounds it: instruction issue in the search.  At (16, 2048, 3) it is
// 67 M point pairs, each a shared-memory load, a distance by knn.cu's
// arithmetic (three FMAs of the product, the norms' add, one FMA) and a
// compare against the centre's threshold into a bit mask, ~8 issue slots,
// about 0.016 ms on 132 SMs at 1.98 GHz; the bytes
// (0.4 MB in and out) and the tail (three neighbours a point) are small
// beside it.
//
// Design:
// - The search.  A block owns 256 / S centres of one cloud, each with its
//   sorted list of 4 (distance, index) in the registers of S lanes, and
//   stages the cloud's candidates (x, y, z, |x|^2) in shared memory 2048 at a
//   time.  The S lanes of a centre ("splits") take the candidates
//   j = s, s + S, s + 2S, ... : rising index in every lane, so a candidate
//   enters a lane's list on a strict < alone (ties keep the lower index, the
//   rule of knn.cu and of the stable sort of the plain version), and the S
//   lanes read S consecutive float4s, conflict-free.  An insertion is rare
//   for one list but, with 32 lists a warp, frequent for the warp, and a
//   branch taken by one lane costs them all; so a lane takes its candidates
//   in batches of 32, marks in a bit mask, without a branch, those below its
//   list's threshold as the batch found it, and only then enters the marked
//   ones, each checked again as the threshold tightens.  The threshold is
//   the list's fourth best, at most a bound the centre's S lanes share: just
//   above the smallest of their fourth bests (after each batch; at the start
//   the 4th smallest of each lane's first 8 candidates), past which no
//   candidate can be among the centre's 4 nearest.  The lanes' lists then
//   meet in a butterfly of shuffles, each step keeping the 4 smallest of two
//   sorted lists by the lexicographic (distance, index) order, so the result
//   does not depend on S.  A list holds knn.cu's ordering keys (dist_key: the
//   clamped distance's bits, every NaN one key above +inf, an empty slot
//   above that), so a NaN point ranks after every number, as in knn.cu and
//   the plain version's sort; a NaN centre's list is 0 .. 3.  A NaN passes
//   every float threshold test (!(v >= thr)) and is then judged on its key;
//   the threshold and the bound are NaN, which marks every candidate, while
//   no lane holds four finite distances.  The distances are knn.cu's FMA path exactly (the
//   norms as its fmaf chain, the product as its fmaf chain from 0, then
//   max(fmaf(-2, dot, |x_i|^2 + |x_j|^2), 0)), so the lists equal
//   knn_cuda(x, 4)'s index for index.  S, and so the grid, is the plan's
//   (filter_plan, mirrored by graph_filter.py filter_plan): the fewest splits
//   that give every SM a block.  Measured on an H100 (PERF.md, section 6):
//   one centre a thread beat 2 and 4 (fewer lists a warp), and more splits
//   than the plan's (more warps, shorter scans) lost.
// - The per-cloud mean.  Each search block adds its centres' slot-1
//   distances in a fixed tree and writes one partial; a second launch,
//   programmatically dependent on the search so that its blocks are resident
//   when the search drains, adds a cloud's partials in a fixed order in every
//   block (the same bits in each, on every call), then writes each point's
//   output from its indices, which the search wrote.  One cluster of up to
//   16 blocks a cloud, the partials added through distributed shared memory
//   in one launch, was slower at every batch (it leaves SMs idle at small
//   batch and runs in waves of whole clusters at large).  Slot 0 is dropped
//   whatever it holds: with duplicated points it is the lowest index, not
//   necessarily the point itself.
// - The tail keeps the plain version's order of operations, each rounded on
//   its own (no contraction into FMAs), so it differs from the plain version
//   only by expf's ulp and the order of the mean's sum.
// - The backward recomputes the per-point terms from x, the indices and the
//   mean the forward saved: a first launch adds sum_j (g . diff_j) w_j dist_j
//   into fixed-order block partials (the bandwidth's gradient), a second,
//   programmatically dependent, finishes dL/dsigma (zero where the 0.005
//   clamp is active; a tie passes, as torch.clamp_min's gradient does) and
//   writes four rows a point for the row scatter: slot 0 carries the point's
//   own term (index i), slots 1..3 the neighbours' terms (their indices), so
//   one atomic-free scatter_add_rows over N * 4 rows of one neighbour adds
//   them all in ascending edge order; the dropped slot 0's neighbour gets
//   nothing.
//
// Guard of every entry point: C = 3, k = 4, 4 <= N <= 65536 (the row
// scatter's rows), 1 <= B <= 65535.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_sweep.cuh"

namespace {

constexpr int kK = 4;  // neighbours, self included
constexpr int kC = 3;  // coordinates
constexpr int kSearchThreads = 256;
constexpr int kMaxSplits = 32;
constexpr int kStage = 2048;        // candidates staged in shared memory at a time (32 KB)
constexpr int kBatch = 32;          // candidates a lane marks before it enters them
constexpr int kPointThreads = 256;  // the per-point launches
constexpr int kMaxN = 65536;
constexpr int kMaxB = 65535;
constexpr float kEps = 1e-12f;
constexpr float kMinSigma = 0.005f;

struct List {
  uint32_t d[kK];  // keys (dist_key)
  int i[kK];
};

// ---------------------------------------------------------------- plan

struct Plan {
  int splits, centres, blocks;  // lanes a centre, centres a block, blocks a cloud
};

Plan plan_for(int splits, int n) {
  const int centres = kSearchThreads / splits;
  return {splits, centres, (n + centres - 1) / centres};
}

// the fewest splits (a power of two) that give every SM a block
Plan filter_plan(int b, int n, int sms) {
  Plan p = plan_for(1, n);
  while (p.splits < kMaxSplits && (long long)b * p.blocks < sms) p = plan_for(2 * p.splits, n);
  return p;
}

// -------------------------------------------------------------- search

constexpr uint32_t kNanKey = 0x7fffffffu;  // every NaN distance: after +inf (0x7f800000)
constexpr uint32_t kNone = 0xffffffffu;    // an empty slot: after every distance

// csrc/knn.cu's ordering key of a squared distance, as an unsigned integer:
// the bits of max(v, 0), a NaN kept as the canonical NaN, kNanKey (PTX
// max.NaN)
__device__ __forceinline__ uint32_t dist_key(float v) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(v), "f"(0.f));
  return __float_as_uint(d);
}

// the distance a key stands for as a threshold: the value while finite, else
// NaN, which lets every candidate through a threshold test and drops out of
// fminf
__device__ __forceinline__ float limit(uint32_t key) {
  return key < 0x7f800000u ? __uint_as_float(key) : __uint_as_float(kNanKey);
}

__device__ __forceinline__ bool before(uint32_t da, int ia, uint32_t db, int ib) {
  return da < db || (da == db && ia < ib);
}

// |x|^2 as csrc/knn.cu's knn_norms_fma_kernel: fmaf over the channels from 0
__device__ __forceinline__ float norm2(float a, float b, float c) { return fmaf(c, c, fmaf(b, b, fmaf(a, a, 0.f))); }

// enter key d of candidate j into the sorted list; j is above every listed
// index, so ties keep the listed entry.  thr: the value a candidate's
// expanded distance must be below to enter: the list's fourth best (-inf once
// that is 0), at most the bound the centre's lanes share
__device__ __forceinline__ void insert(List& l, float& thr, float bound, uint32_t d, int j) {
  if (!(d < l.d[3])) return;
  if (d < l.d[2]) {
    l.d[3] = l.d[2];
    l.i[3] = l.i[2];
    if (d < l.d[1]) {
      l.d[2] = l.d[1];
      l.i[2] = l.i[1];
      if (d < l.d[0]) {
        l.d[1] = l.d[0];
        l.i[1] = l.i[0];
        l.d[0] = d;
        l.i[0] = j;
      } else {
        l.d[1] = d;
        l.i[1] = j;
      }
    } else {
      l.d[2] = d;
      l.i[2] = j;
    }
  } else {
    l.d[3] = d;
    l.i[3] = j;
  }
  thr = l.d[3] == 0u ? -INFINITY : fminf(limit(l.d[3]), bound);
}

__device__ __forceinline__ void swap_if(List& l, int a, int b) {
  if (before(l.d[b], l.i[b], l.d[a], l.i[a])) {
    const uint32_t d = l.d[a];
    const int i = l.i[a];
    l.d[a] = l.d[b];
    l.i[a] = l.i[b];
    l.d[b] = d;
    l.i[b] = i;
  }
}

// l <- the 4 smallest of l and the list of the lane `mask` away, both sorted:
// the element-wise minimum of one and the other reversed holds them as a
// bitonic sequence, which two compare-exchange steps sort
__device__ __forceinline__ void merge_lane(List& l, int mask) {
  uint32_t od[kK];
  int oi[kK];
#pragma unroll
  for (int q = 0; q < kK; ++q) {
    od[q] = __shfl_xor_sync(FULL, l.d[q], mask);
    oi[q] = __shfl_xor_sync(FULL, l.i[q], mask);
  }
#pragma unroll
  for (int q = 0; q < kK; ++q)
    if (before(od[kK - 1 - q], oi[kK - 1 - q], l.d[q], l.i[q])) {
      l.d[q] = od[kK - 1 - q];
      l.i[q] = oi[kK - 1 - q];
    }
  swap_if(l, 0, 2);
  swap_if(l, 1, 3);
  swap_if(l, 0, 1);
  swap_if(l, 2, 3);
}

// the filter's distance of x_i to y: sqrt(|sum of squared differences| +
// 1e-12) in the plain version's order; diff = x_i - y, s the sum
__device__ __forceinline__ float filter_dist(const float (&xi)[kC], const float* y, float (&diff)[kC], float& s) {
#pragma unroll
  for (int c = 0; c < kC; ++c) diff[c] = __fsub_rn(xi[c], y[c]);
  s = __fadd_rn(__fadd_rn(__fmul_rn(diff[0], diff[0]), __fmul_rn(diff[1], diff[1])), __fmul_rn(diff[2], diff[2]));
  return __fsqrt_rn(__fadd_rn(fabsf(s), kEps));
}

// where a search block's thread finds itself: its split (the lanes of a
// centre are consecutive) and its centre
struct Seat {
  int split, centre;
};

__device__ __forceinline__ Seat seat(int splits, int centres) {
  return {(int)threadIdx.x & (splits - 1), (int)blockIdx.x * centres + (int)threadIdx.x / splits};
}

// knn.cu's distance before its clamp at 0: the dot product as fmaf over the
// channels from 0, then fmaf(-2, dot, |x_i|^2 + |x_j|^2)
__device__ __forceinline__ float expanded(const float (&c)[kC], float csq, float4 q) {
  return fmaf(-2.f, fmaf(c[2], q.z, fmaf(c[1], q.y, fmaf(c[0], q.x, 0.f))), csq + q.w);
}

// the smallest of the centre's lanes' values d, just above: no candidate past
// a lane's fourth best distance is among the centre's 4 nearest, and one at
// it may be (a lower index).  A lane's NaN (no four finite distances) bounds
// nothing; NaN when no lane bounds
__device__ __forceinline__ float group_bound(float d, int splits) {
  for (int mask = 1; mask < splits; mask <<= 1) d = fminf(d, __shfl_xor_sync(FULL, d, mask));
  return nextafterf(d, INFINITY);
}

__device__ __forceinline__ void cas(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// the 4th smallest of 8 values: each half sorted (5 compare-exchanges), then
// the 4th of the two sorted 4s, min over i of max(a[i - 1], b[3 - i])
__device__ __forceinline__ float fourth_of_8(float (&v)[8]) {
#pragma unroll
  for (int h = 0; h < 8; h += 4) {
    cas(v[h], v[h + 1]);
    cas(v[h + 2], v[h + 3]);
    cas(v[h], v[h + 2]);
    cas(v[h + 1], v[h + 3]);
    cas(v[h + 1], v[h + 2]);
  }
  return fminf(fminf(fminf(v[7], fmaxf(v[0], v[6])), fminf(fmaxf(v[1], v[5]), fmaxf(v[2], v[4]))), v[3]);
}

// the 4 nearest points, self included, of the thread's centre over the whole
// cloud xb (n points), every lane of the centre ending with the merged list;
// ci: the centre's coordinates (0 past n)
__device__ __forceinline__ void search(const float* __restrict__ xb, int n, int splits, const Seat& st,
                                       float4* cand, float (&ci)[kC], List& best) {
#pragma unroll
  for (int q = 0; q < kC; ++q) ci[q] = st.centre < n ? xb[(size_t)st.centre * kC + q] : 0.f;
  const float csq = norm2(ci[0], ci[1], ci[2]);
#pragma unroll
  for (int q = 0; q < kK; ++q) {
    best.d[q] = kNone;
    best.i[q] = 0x7fffffff;
  }
  float thr = INFINITY, bound = INFINITY;
  for (int t0 = 0; t0 < n; t0 += kStage) {
    // the stage, padded to whole batches of every lane with candidates no
    // centre takes: |x_j|^2 = inf makes the expanded value inf
    const int cnt = min(kStage, n - t0), span = kBatch * splits, padded = (cnt + span - 1) / span * span;
    __syncthreads();  // the previous stage is read
    for (int p = threadIdx.x; p < padded; p += blockDim.x) {
      if (p < cnt) {
        const float* q = xb + (size_t)(t0 + p) * kC;
        const float a = q[0], b = q[1], c = q[2];
        cand[p] = make_float4(a, b, c, norm2(a, b, c));
      } else {
        cand[p] = make_float4(0.f, 0.f, 0.f, INFINITY);
      }
    }
    __syncthreads();
    if (t0 == 0) {
      // the first threshold: the bound from the 4th smallest distance among
      // each lane's first 8 candidates, a NaN counted as +inf (no bound
      // unless four are finite)
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float e = expanded(ci, csq, cand[st.split + u * splits]);
        v[u] = e == e ? fmaxf(e, 0.f) : INFINITY;
      }
      const float f4 = fourth_of_8(v);
      thr = bound = group_bound(f4 < INFINITY ? f4 : __uint_as_float(kNanKey), splits);
    }
    for (int p0 = st.split; p0 < padded; p0 += span) {
      // a batch of the lane's next 32 candidates: mark those below the
      // threshold (predicated, no branch), then enter the marked ones in
      // rising index, each checked again against the threshold as it
      // tightens (the padding past the stage's points never); then the
      // centre's lanes share their fourth best distances
      unsigned marked = 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (!(expanded(ci, csq, cand[p0 + u * splits]) >= thr)) marked |= 1u << u;
      for (; marked; marked &= marked - 1) {
        const int p = p0 + (__ffs(marked) - 1) * splits;
        const float v = expanded(ci, csq, cand[p]);
        if (!(v >= thr) && p < cnt) insert(best, thr, bound, dist_key(v), t0 + p);
      }
      bound = fminf(bound, group_bound(limit(best.d[3]), splits));
      thr = fminf(thr, bound);
    }
  }
  for (int mask = 1; mask < splits; mask <<= 1) merge_lane(best, mask);
}

// fixed-order sum of part[0 .. count), count a power of two <= blockDim.x;
// every thread of the block takes part; the sum ends in part[0]
__device__ __forceinline__ void tree_sum(float* part, int count) {
  __syncthreads();
  for (int w = count / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
}

// fixed-order sum of vals[0 .. count), the same bits in every block that
// calls it: a strided sequential sum a thread, then a tree over the block
__device__ __forceinline__ float cloud_sum(const float* __restrict__ vals, int count, float* red) {
  float s = 0.f;
  for (int t = threadIdx.x; t < count; t += kPointThreads) s += vals[t];
  red[threadIdx.x] = s;
  tree_sum(red, kPointThreads);
  return red[0];
}

// the filtered point i from its neighbours nb (slots 1..3) and sigma
__device__ __forceinline__ void filter_point(const float* __restrict__ xb, const float (&xi)[kC], int4 nb, float sigma,
                                             float* __restrict__ out) {
  const int nbr[kK - 1] = {nb.y, nb.z, nb.w};
  float y[kK - 1][kC], w[kK - 1];
#pragma unroll
  for (int j = 0; j < kK - 1; ++j) {
#pragma unroll
    for (int c = 0; c < kC; ++c) y[j][c] = xb[(size_t)nbr[j] * kC + c];
    float diff[kC], s;
    const float dist = filter_dist(xi, y[j], diff, s);
    w[j] = expf(__fdiv_rn(-dist, sigma));
  }
  const float one_plus = __fadd_rn(1.f, __fadd_rn(__fadd_rn(w[0], w[1]), w[2]));
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float weighted = __fadd_rn(__fadd_rn(__fmul_rn(w[0], y[0][c]), __fmul_rn(w[1], y[1][c])),
                                     __fmul_rn(w[2], y[2][c]));
    out[c] = __fsub_rn(__fmul_rn(one_plus, xi[c]), weighted);
  }
}

__device__ __forceinline__ float sigma_of(float mean) { return mean < kMinSigma ? kMinSigma : mean; }

// ---------------------------------------------------------------- forward

// the search: lists to idx (B, N, 4), each block's slot-1 distances summed
// in a fixed tree to partial[b * gridDim.x + blockIdx.x]
__global__ void __launch_bounds__(kSearchThreads)
    filter_search_kernel(const float* __restrict__ x, int* __restrict__ idx, float* __restrict__ partial, int n,
                         int splits, int centres) {
  __shared__ float4 cand[kStage];
  __shared__ float part[kSearchThreads];
  let_next_sweep_launch();  // the finish waits for this grid to complete before it reads
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * n * kC;
  const Seat st = seat(splits, centres);
  float ci[kC];
  List best;
  search(xb, n, splits, st, cand, ci, best);
  // lane 0 of each centre writes its list and its slot-1 distance
  const int slot = threadIdx.x / splits;
  if (st.split == 0) {
    float dist = 0.f;
    if (st.centre < n) {
      reinterpret_cast<int4*>(idx)[(size_t)b * n + st.centre] = make_int4(best.i[0], best.i[1], best.i[2], best.i[3]);
      float diff[kC], s;
      dist = filter_dist(ci, xb + (size_t)best.i[1] * kC, diff, s);
    }
    part[slot] = dist;
  }
  tree_sum(part, centres);
  if (threadIdx.x == 0) partial[(size_t)b * gridDim.x + blockIdx.x] = part[0];
}

// the output, one point a thread: sigma from the cloud's partials; block 0
// of each cloud writes the mean for the backward
__global__ void __launch_bounds__(kPointThreads) filter_finish_kernel(const float* __restrict__ x,
                                                                      const int* __restrict__ idx,
                                                                      const float* __restrict__ partial, int blocks,
                                                                      float* __restrict__ out, float* __restrict__ mean,
                                                                      int n) {
  __shared__ float red[kPointThreads];
  const int b = blockIdx.y, i = blockIdx.x * kPointThreads + threadIdx.x;
  const float* xb = x + (size_t)b * n * kC;
  float xi[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) xi[c] = i < n ? xb[(size_t)i * kC + c] : 0.f;
  wait_for_previous_sweep();
  const float m = __fdiv_rn(cloud_sum(partial + (size_t)b * blocks, blocks, red), (float)n);
  if (blockIdx.x == 0 && threadIdx.x == 0) mean[b] = m;
  if (i >= n) return;
  const int4 nb = reinterpret_cast<const int4*>(idx)[(size_t)b * n + i];
  filter_point(xb, xi, nb, sigma_of(m), out + ((size_t)b * n + i) * kC);
}

// --------------------------------------------------------------- backward

// what the backward needs of point i: neighbours' differences, squared sums,
// distances and weights, and a_j = g . diff_j
struct Terms {
  float diff[kK - 1][kC], s[kK - 1], dist[kK - 1], w[kK - 1], a[kK - 1];
};

__device__ __forceinline__ void point_terms(const float* __restrict__ xb, const float (&xi)[kC], const float (&gi)[kC],
                                            int4 nb, float sigma, Terms& t) {
  const int nbr[kK - 1] = {nb.y, nb.z, nb.w};
#pragma unroll
  for (int j = 0; j < kK - 1; ++j) {
    float y[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) y[c] = xb[(size_t)nbr[j] * kC + c];
    t.dist[j] = filter_dist(xi, y, t.diff[j], t.s[j]);
    t.w[j] = expf(__fdiv_rn(-t.dist[j], sigma));
    t.a[j] = __fadd_rn(__fadd_rn(__fmul_rn(gi[0], t.diff[j][0]), __fmul_rn(gi[1], t.diff[j][1])),
                       __fmul_rn(gi[2], t.diff[j][2]));
  }
}

__device__ __forceinline__ void load_point(const float* __restrict__ xb, const float* __restrict__ gb, int i, int n,
                                           float (&xi)[kC], float (&gi)[kC]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    xi[c] = i < n ? xb[(size_t)i * kC + c] : 0.f;
    gi[c] = i < n ? gb[(size_t)i * kC + c] : 0.f;
  }
}

// sum_j (a_j w_j) dist_j of each point, added in a fixed tree a block
__global__ void __launch_bounds__(kPointThreads) filter_grad_partial_kernel(const float* __restrict__ x,
                                                                            const int* __restrict__ idx,
                                                                            const float* __restrict__ mean,
                                                                            const float* __restrict__ g,
                                                                            float* __restrict__ partial, int n) {
  __shared__ float red[kPointThreads];
  let_next_sweep_launch();  // the rows kernel waits for this grid to complete before it reads
  const int b = blockIdx.y, i = blockIdx.x * kPointThreads + threadIdx.x;
  const float* xb = x + (size_t)b * n * kC;
  float xi[kC], gi[kC];
  load_point(xb, g + (size_t)b * n * kC, i, n, xi, gi);
  float v = 0.f;
  if (i < n) {
    Terms t;
    point_terms(xb, xi, gi, reinterpret_cast<const int4*>(idx)[(size_t)b * n + i], sigma_of(mean[b]), t);
    v = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(t.a[0], t.w[0]), t.dist[0]),
                            __fmul_rn(__fmul_rn(t.a[1], t.w[1]), t.dist[1])),
                  __fmul_rn(__fmul_rn(t.a[2], t.w[2]), t.dist[2]));
  }
  red[threadIdx.x] = v;
  tree_sum(red, kPointThreads);
  if (threadIdx.x == 0) partial[(size_t)b * gridDim.x + blockIdx.x] = red[0];
}

// four rows of three a point for the row scatter: slot 0 the point's own
// term (row index i), slots 1..3 its neighbours' (their indices)
__global__ void __launch_bounds__(kPointThreads) filter_grad_rows_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, const float* __restrict__ mean,
    const float* __restrict__ g, const float* __restrict__ partial, int blocks, float* __restrict__ rows,
    int* __restrict__ row_idx, int n) {
  __shared__ float red[kPointThreads];
  const int b = blockIdx.y, i = blockIdx.x * kPointThreads + threadIdx.x;
  const float* xb = x + (size_t)b * n * kC;
  const float m = mean[b], sigma = sigma_of(m);
  float xi[kC], gi[kC];
  load_point(xb, g + (size_t)b * n * kC, i, n, xi, gi);
  Terms t;
  int4 nb = make_int4(0, 0, 0, 0);
  if (i < n) {
    nb = reinterpret_cast<const int4*>(idx)[(size_t)b * n + i];
    point_terms(xb, xi, gi, nb, sigma, t);
  }
  wait_for_previous_sweep();
  const float total = cloud_sum(partial + (size_t)b * blocks, blocks, red);
  if (i >= n) return;
  // dL/dsigma, through the clamp where the mean is at least 0.005, then
  // dL/dmean / N onto each point's slot-1 distance
  const float dsigma = m >= kMinSigma ? __fdiv_rn(total, __fmul_rn(sigma, sigma)) : 0.f;
  const float dmean = __fdiv_rn(dsigma, (float)n);
  float ddiff[kK - 1][kC];
#pragma unroll
  for (int j = 0; j < kK - 1; ++j) {
    float ddist = -__fdiv_rn(__fmul_rn(t.a[j], t.w[j]), sigma);
    if (j == 0) ddist = __fadd_rn(ddist, dmean);
    const float ds = t.s[j] > 0.f ? __fdiv_rn(ddist, __fmul_rn(2.f, t.dist[j])) : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) ddiff[j][c] = __fmul_rn(__fmul_rn(2.f, t.diff[j][c]), ds);
  }
  const float one_plus = __fadd_rn(1.f, __fadd_rn(__fadd_rn(t.w[0], t.w[1]), t.w[2]));
  float r[kK * kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    r[c] = __fadd_rn(__fmul_rn(one_plus, gi[c]), __fadd_rn(__fadd_rn(ddiff[0][c], ddiff[1][c]), ddiff[2][c]));
#pragma unroll
    for (int j = 0; j < kK - 1; ++j) r[(j + 1) * kC + c] = __fsub_rn(-__fmul_rn(t.w[j], gi[c]), ddiff[j][c]);
  }
  float4* rp = reinterpret_cast<float4*>(rows + ((size_t)b * n + i) * kK * kC);
  rp[0] = make_float4(r[0], r[1], r[2], r[3]);
  rp[1] = make_float4(r[4], r[5], r[6], r[7]);
  rp[2] = make_float4(r[8], r[9], r[10], r[11]);
  reinterpret_cast<int4*>(row_idx)[(size_t)b * n + i] = make_int4(i, nb.y, nb.z, nb.w);
}

bool covers(int b, int n, int c, int k) { return c == kC && k == kK && n >= kK && n <= kMaxN && b >= 1 && b <= kMaxB; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (B, N, 3) fp32 -> out (B, N, 3), idx (B, N, 4) int32 (the k = 4 lists,
// self included), mean (B,) the unclamped mean slot-1 distance; partial:
// scratch of B * ceil(N / 8) floats.  The search, then the finish
// programmatically dependent on it.  C = 3, k = 4, 4 <= N <= 65536,
// 1 <= B <= 65535; idx 16-byte aligned.
extern "C" int pccf_graph_filter(const float* x, float* out, int* idx, float* mean, float* partial, int b, int n,
                                 int c, int k, cudaStream_t stream) {
  if (!covers(b, n, c, k) || !x || !out || !idx || !mean || !partial || !aligned16(idx))
    return (int)cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const Plan p = filter_plan(b, n, sms);
  // the search follows whatever wrote x: a plain launch
  err = launch(filter_search_kernel, dim3(p.blocks, b), kSearchThreads, false, stream, x, idx, partial, n, p.splits,
               p.centres);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(filter_finish_kernel, dim3((n + kPointThreads - 1) / kPointThreads, b), kPointThreads, true,
                     stream, x, (const int*)idx, (const float*)partial, p.blocks, out, mean, n);
}

// the backward's per-point part: x (B, N, 3), idx (B, N, 4) and mean (B,) as
// the forward wrote them, g (B, N, 3) -> rows (B, N * 4, 3) and row_idx
// (B, N * 4) for scatter_add_rows; partial: scratch of B * ceil(N / 256)
// floats.  The same guard as pccf_graph_filter; idx, rows and row_idx
// 16-byte aligned.
extern "C" int pccf_graph_filter_backward(const float* x, const int* idx, const float* mean, const float* g,
                                          float* rows, int* row_idx, float* partial, int b, int n, int c, int k,
                                          cudaStream_t stream) {
  if (!covers(b, n, c, k) || !x || !idx || !mean || !g || !rows || !row_idx || !partial || !aligned16(idx) ||
      !aligned16(rows) || !aligned16(row_idx))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kPointThreads - 1) / kPointThreads;
  cudaError_t err = launch(filter_grad_partial_kernel, dim3(blocks, b), kPointThreads, false, stream, x, idx, mean, g,
                           partial, n);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(filter_grad_rows_kernel, dim3(blocks, b), kPointThreads, true, stream, x, idx, mean, g,
                     (const float*)partial, blocks, rows, row_idx, n);
}

// the search's plan for (B, N, 3) on a card of sms SMs: plan[0..2] = splits,
// centres a block, blocks a cloud
extern "C" int pccf_graph_filter_plan(int b, int n, int sms, int* plan) {
  if (!covers(b, n, kC, kK) || sms < 1 || !plan) return (int)cudaErrorInvalidValue;
  const Plan p = filter_plan(b, n, sms);
  plan[0] = p.splits;
  plan[1] = p.centres;
  plan[2] = p.blocks;
  return 0;
}
