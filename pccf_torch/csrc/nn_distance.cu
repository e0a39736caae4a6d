// Bidirectional nearest neighbours of two clouds on Hopper: for each point of
// x1 the squared distance to its nearest point of x2 and that point's index
// (the lowest on ties), and the same for each point of x2 against x1.
//
// Replaces pccf/kernels/pallas_chamfer.py:78 _nn_distance_raw (pallas_call at
// :86), which serves nn_distance_tpu:66 and chamfer_tpu:127.  The backward is
// not a kernel, in JAX either: it gathers the nearest points and scatter-adds
// with plain tensor operations (pccf_torch/kernels/chamfer.py).
//
// What bounds it: instruction issue.  Each pair needs its distance (3
// subtractions, 3 multiplies, 2 adds, no FMA: the plain version's rounding)
// and a compare and two selects for each side's running (minimum, index),
// ~14 issue slots; at (8, 2048, 3)^2 that is 33.5 M pairs, ~0.014 ms on 132
// SMs at 1.98 GHz, against 0.7 MB of inputs and outputs.  The TPU kernel
// makes each distance tile once and folds it into both the row and the
// running column minima in VMEM (pallas_chamfer.py:31-51, _chamfer_fold.py
// fold_tile).
//
// Design: each distance is computed once and folded into both sides.  A block
// owns 64 rows of x1 of one sample (8 warps of 8 rows, each lane holding its
// warp's rows in registers) against one range of x2's columns ("a split",
// staged in shared memory 512 points at a time); the 32 lanes of a warp split
// the staged points, so one read serves 8 pairs.  A row's running (minimum,
// index) lives in the lane (candidates in rising index, strict <) and meets
// the other lanes' by shuffles; a column's minimum over the warp's 8 rows is a
// tree of adjacent ranges (the lower range wins ties), the block's warps meet
// in shared memory in rising row, and each block writes its rows' partials
// (over its split) and its columns' (over its 64 rows) to scratch, 4 MB at
// (8, 2048, 3)^2, well inside L2.  A second launch, programmatically
// dependent on the first so that its blocks are resident when the fold
// drains, combines each row's partials over the splits and each column's over
// the row tiles in rising index.  The minimum by (distance, index) in
// lexicographic order does not depend on the order of combination, so every
// output is the plain version's, bit for bit; each is written exactly once,
// no atomics, no memset, the same on every call.  The wrapper chooses the
// splits (chamfer.nn_plan): the fewest that give half the SMs a block, 1 at
// stage 1's (8, 2048) clouds, 8 at (2, 512).  Designs measured and not kept
// (PERF.md, section 6): one cluster a sample combining through distributed
// shared memory, the last block of each sample, row tile or split combining
// behind an integer counter, and one cooperative launch with a grid barrier:
// none beat the second launch.

#include "pair_sweep.cuh"

namespace {

constexpr int NN_ROWS = 8;    // rows of x1 a warp holds, in every lane's registers
constexpr int NN_WARPS = 8;   // 64 rows a block
constexpr int NN_TILE = 512;  // points of x2 staged per step
constexpr int ROWS_PER_BLOCK = NN_WARPS * NN_ROWS;
constexpr int COMBINE_THREADS = 256;

// The distance of each row to each staged column, folded into the row's
// running minimum (best, best_i: rising index, strict <) and, over the
// warp's 8 rows, into the column's: (d, row) returned in d[0], cr[0]
__device__ __forceinline__ void fold_column(const float (&px)[NN_ROWS], const float (&py)[NN_ROWS],
                                            const float (&pz)[NN_ROWS], float4 o, int c, float (&best)[NN_ROWS],
                                            int (&best_i)[NN_ROWS], float (&d)[NN_ROWS], int (&cr)[NN_ROWS]) {
#pragma unroll
  for (int r = 0; r < NN_ROWS; ++r) {
    d[r] = sqdist(px[r], py[r], pz[r], o.x, o.y, o.z);
    cr[r] = r;
    if (d[r] < best[r]) {
      best[r] = d[r];
      best_i[r] = c;
    }
  }
  // a tree of adjacent ranges, the lower range winning ties: the lowest row, in 3 steps
#pragma unroll
  for (int w = 1; w < NN_ROWS; w *= 2) {
#pragma unroll
    for (int r = 0; r < NN_ROWS; r += 2 * w) {
      if (d[r + w] < d[r]) {
        d[r] = d[r + w];
        cr[r] = cr[r + w];
      }
    }
  }
}

// rows [row0, row0 + 8) of sample b from x1, those past n at infinity: their
// distance is +inf and never below a real one
__device__ __forceinline__ void load_rows(const float* x1, int b, int n, int row0, float (&px)[NN_ROWS],
                                          float (&py)[NN_ROWS], float (&pz)[NN_ROWS], float (&best)[NN_ROWS],
                                          int (&best_i)[NN_ROWS]) {
#pragma unroll
  for (int r = 0; r < NN_ROWS; ++r) {
    px[r] = py[r] = pz[r] = INFINITY;
    if (row0 + r < n) {
      const float* p = x1 + ((long long)b * n + row0 + r) * 3;
      px[r] = p[0];
      py[r] = p[1];
      pz[r] = p[2];
    }
    best[r] = INFINITY;
    best_i[r] = 0;
  }
}

// the (distance, index) minimum of one point's partials parts apart, in
// rising index; both loads unconditional: no chain of dependent reads
__device__ __forceinline__ void combine_parts(const float* pd, const int* pi, long long stride, int parts, float* d,
                                              int* i) {
  float best = __ldcg(pd);
  int best_i = __ldcg(pi);
#pragma unroll 8
  for (int t = 1; t < parts; ++t) {
    const float v = __ldcg(pd + t * stride);
    const int vi = __ldcg(pi + t * stride);
    if (v < best) {
      best = v;
      best_i = vi;
    }
  }
  *d = best;
  *i = best_i;
}

// Block (tile, b, split): rows [tile * 64, +64) of sample b against columns
// [split * cs, +cs), cs = ceil(M / splits).  Writes each row's partial over
// its columns (row_d, row_i: (B, splits, N)) and each column's over its rows
// (col_d, col_i: (B, tiles, M)).
__global__ void __launch_bounds__(NN_WARPS * 32) nn_fold_kernel(const float* __restrict__ x1,
                                                                const float* __restrict__ x2, int n, int m,
                                                                float* __restrict__ row_d, int* __restrict__ row_i,
                                                                float* __restrict__ col_d, int* __restrict__ col_i) {
  __shared__ float4 cols[NN_TILE];
  __shared__ float warp_d[NN_WARPS][NN_TILE];
  __shared__ int warp_i[NN_WARPS][NN_TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int cs = (m + gridDim.z - 1) / gridDim.z, c_begin = split * cs, c_end = min(m, c_begin + cs);
  const int row0 = tile * ROWS_PER_BLOCK + warp * NN_ROWS;
  let_next_sweep_launch();  // the combine waits for this grid to finish before it reads
  float px[NN_ROWS], py[NN_ROWS], pz[NN_ROWS], best[NN_ROWS];
  int best_i[NN_ROWS];
  load_rows(x1, b, n, row0, px, py, pz, best, best_i);
  const float* q = x2 + (long long)b * m * 3;
  float* cd = col_d + ((long long)b * gridDim.x + tile) * m;
  int* ci = col_i + ((long long)b * gridDim.x + tile) * m;
  for (int c0 = c_begin; c0 < c_end; c0 += NN_TILE) {
    const int cnt = min(NN_TILE, c_end - c0);
    __syncthreads();  // the last tile's columns are combined
    for (int t = threadIdx.x; t < cnt; t += NN_WARPS * 32) {
      const float* o = q + (long long)(c0 + t) * 3;
      cols[t] = make_float4(o[0], o[1], o[2], 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int t = lane; t < cnt; t += 32) {  // each lane sees its columns in rising index
      float d[NN_ROWS];
      int cr[NN_ROWS];
      fold_column(px, py, pz, cols[t], c0 + t, best, best_i, d, cr);
      warp_d[warp][t] = d[0];
      warp_i[warp][t] = row0 + cr[0];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += NN_WARPS * 32) {  // the block's warps in rising row
      float cb = warp_d[0][t];
      int cb_i = warp_i[0][t];
#pragma unroll
      for (int w = 1; w < NN_WARPS; ++w) {
        if (warp_d[w][t] < cb) {
          cb = warp_d[w][t];
          cb_i = warp_i[w][t];
        }
      }
      cd[c0 + t] = cb;
      ci[c0 + t] = cb_i;
    }
  }
#pragma unroll
  for (int r = 0; r < NN_ROWS; ++r) warp_argmin(best[r], best_i[r]);
#pragma unroll
  for (int r = 0; r < NN_ROWS; ++r) {
    if (lane == r && row0 + r < n) {
      const long long i = ((long long)b * gridDim.z + split) * n + row0 + r;
      row_d[i] = best[r];
      row_i[i] = best_i[r];
    }
  }
}

// blockIdx.z 0: d1, i1, each row's partials over the column splits; 1: d2,
// i2, each column's over the row tiles; both in rising index
__global__ void __launch_bounds__(COMBINE_THREADS) nn_combine_kernel(const float* __restrict__ row_d,
                                                                     const int* __restrict__ row_i,
                                                                     const float* __restrict__ col_d,
                                                                     const int* __restrict__ col_i, int n, int m,
                                                                     int splits, int tiles, float* __restrict__ d1,
                                                                     int* __restrict__ i1, float* __restrict__ d2,
                                                                     int* __restrict__ i2) {
  wait_for_previous_sweep();
  const bool rows = blockIdx.z == 0;
  const int count = rows ? n : m, parts = rows ? splits : tiles;
  const int b = blockIdx.y, c = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (c >= count) return;
  const long long base = (long long)b * parts * count + c;
  combine_parts((rows ? row_d : col_d) + base, (rows ? row_i : col_i) + base, count, parts,
                (rows ? d1 : d2) + (long long)b * count + c, (rows ? i1 : i2) + (long long)b * count + c);
}

}  // namespace

// x1 (B, N, 3), x2 (B, M, 3) -> d1 (B, N), i1 (B, N), d2 (B, M), i2 (B, M).
// splits (1-16) cuts x2 into ranges of columns, one block each; scratch holds
// 2 * B * (splits * N + ceil(N / 64) * M) words, the partials of each row
// over the splits and of each column over the row tiles.
extern "C" int pccf_nn_distance(const float* x1, const float* x2, int b, int n, int m, float* d1, int* i1, float* d2,
                                int* i2, float* scratch, int splits, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535 || splits < 1 || splits > 16) return (int)cudaErrorInvalidValue;
  const int tiles = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long rows = (long long)b * splits * n, cols = (long long)b * tiles * m;
  float* row_d = scratch;
  int* row_i = reinterpret_cast<int*>(row_d + rows);
  float* col_d = reinterpret_cast<float*>(row_i + rows);
  int* col_i = reinterpret_cast<int*>(col_d + cols);
  cudaError_t err = launch(nn_fold_kernel, dim3(tiles, b, splits), NN_WARPS * 32, false, stream, x1, x2, n, m, row_d,
                           row_i, col_d, col_i);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(nn_combine_kernel, dim3(((n > m ? n : m) + COMBINE_THREADS - 1) / COMBINE_THREADS, b, 2),
                     COMBINE_THREADS, true, stream, (const float*)row_d, (const int*)row_i, (const float*)col_d,
                     (const int*)col_i, n, m, splits, tiles, d1, i1, d2, i2);
}
