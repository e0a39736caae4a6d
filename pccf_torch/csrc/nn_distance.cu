// Bidirectional nearest neighbours of two clouds on Hopper: for each point of
// x1 the squared distance to its nearest point of x2 and that point's index
// (the lowest on ties), and the same for each point of x2 against x1.
//
// Replaces pccf/kernels/pallas_chamfer.py:78 _nn_distance_raw (pallas_call at
// :86), which serves nn_distance_tpu:66 and chamfer_tpu:127.  The backward is
// not a kernel, in JAX either: it gathers the nearest points and scatter-adds
// with plain tensor operations (pccf_torch/kernels/chamfer.py).
//
// What bounds it: arithmetic.  Each pair needs its distance (3 subtractions,
// 3 multiplies, 2 adds) and a compare for each direction, ~11 operations; at
// (8, 2048, 3)^2 that is 33.5 M pairs, ~5.5 us at the fp32 peak, against
// 0.7 MB of inputs and outputs.  The TPU kernel makes each distance tile once
// and folds it into both the row and the running column minima in VMEM.
//
// Design: the row sweep of emd.cu's first level, taken as a kernel of its
// own and run for both directions in one launch: blockIdx.z says which cloud
// owns the rows.  Every output is written once, by the group of threads that
// owns its point, so there are no atomics, no initialisation and the result is
// the same on every run.  The other design, one sweep whose column side takes
// a 64-bit atomicMin on (distance bits << 32 | index), would compute each
// distance once instead of twice, but needs its column outputs initialised and
// unpacked by two more launches and makes every block contend on the same
// columns; a second sweep costs about as much as those launches.

#include "pair_sweep.cuh"

namespace {

// blockIdx.z 0: the rows are x1's points, searched over x2 -> d1, i1;
// blockIdx.z 1: the rows are x2's points, searched over x1 -> d2, i2
__global__ void __launch_bounds__(THREADS) nn_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                                                     int n, int m, float* __restrict__ d1, int* __restrict__ i1,
                                                     float* __restrict__ d2, int* __restrict__ i2) {
  __shared__ float4 tile[TILE];
  const bool x1_rows = blockIdx.z == 0;
  const int rows = x1_rows ? n : m, cols = x1_rows ? m : n;
  if ((int)blockIdx.x * GROUPS >= rows) return;  // the whole block, before any barrier
  const float* own = x1_rows ? x1 : x2;
  const float* other = x1_rows ? x2 : x1;
  float* dist = x1_rows ? d1 : d2;
  int* idx = x1_rows ? i1 : i2;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int row = blockIdx.x * GROUPS + threadIdx.x / LANES;
  const bool valid = row < rows;
  const float* p = own + ((long long)b * rows + (valid ? row : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float* q = other + (long long)b * cols * 3;
  float best = INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < cols; c0 += TILE) {
    const int cnt = min(TILE, cols - c0);
    __syncthreads();
    stage(tile, q, nullptr, c0, cnt);
    __syncthreads();
    if (!valid) continue;
    for (int t = lane; t < cnt; t += LANES) {  // each lane sees its candidates in rising index
      const float4 o = tile[t];
      const float d = sqdist(px, py, pz, o.x, o.y, o.z);
      if (d < best) {
        best = d;
        best_i = c0 + t;
      }
    }
  }
  lane_argmin(best, best_i);
  if (!valid || lane != 0) return;
  const long long r = (long long)b * rows + row;
  dist[r] = best;
  idx[r] = best_i;
}

}  // namespace

// x1 (B, N, 3), x2 (B, M, 3) -> d1 (B, N), i1 (B, N), d2 (B, M), i2 (B, M)
extern "C" int pccf_nn_distance(const float* x1, const float* x2, int b, int n, int m, float* d1, int* i1, float* d2,
                                int* i2, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(((n > m ? n : m) + GROUPS - 1) / GROUPS, b, 2);
  nn_kernel<<<grid, THREADS, 0, stream>>>(x1, x2, n, m, d1, i1, d2, i2);
  return (int)cudaGetLastError();
}
