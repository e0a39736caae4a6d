// Exact self-kNN indices on Hopper.
//
// Replaces pccf/kernels/pallas_knn.py:183 knn_tpu (body _knn_kernel:86).
// out[b, i, :] holds the k nearest points of cloud b to point i, self
// included, ordered by (squared distance, index): the lowest index wins a
// tie, the rule of the plain version (a stable sort, pccf_torch/kernels/ops.py).
//
// What bounds it: the distance sweep, B*N*N*C multiply-adds (16*2048*2048*128
// at the largest call), and the selection of k of N candidates per centre.  A
// first version that kept one top-k per thread in local memory spent its time
// in divergent insertions, whatever C was; here selection is warp-wide.
//
// Design: a block owns 64 centres of one cloud and walks the candidates in
// tiles of 64.  Distances come from a 4x4 register tile per thread in fp32
// FMA (no tensor cores, no TF32: the TPU kernel's bf16x3 product keeps fp32
// accuracy, and reduced precision was never validated for neighbour
// selection), as |x_i|^2 + |x_j|^2 - 2 x_i.x_j like the plain version.  Each
// squared norm is the same fmaf chain as the dot product, so d(i, i) and the
// distance between exact duplicates are exactly 0.  The 64x64 tile goes to
// shared memory; then each warp takes 8 centres and, 32 candidates at a time,
// ballots the ones that beat its current k-th best and inserts them in
// ascending index order into a sorted list held across the lanes (lane r
// holds the r-th best), which keeps the lower index first on equal distances.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kTile = 64;      // centres per block, candidates per tile
constexpr int kChunk = 16;     // channels staged per pass
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 distance tile
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = kTile / kWarps;  // centres selected per warp
constexpr int kLd = kTile + 4;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__global__ void __launch_bounds__(kThreads) knn_kernel(const float* __restrict__ x, int* __restrict__ out, int n,
                                                       int c, int k) {
  extern __shared__ float smem[];
  float* sq = smem;                 // [n] squared norms of the cloud (padded to 4)
  float* cs = sq + ((n + 3) & ~3);  // [kChunk][kLd] centre channels
  float* ds = cs + kChunk * kLd;    // [kChunk][kLd] candidate channels
  float* dist = ds + kChunk * kLd;  // [kTile][kLd] distance tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y;
  const int centre0 = blockIdx.x * kTile;
  const float* xb = x + (size_t)b * n * c;

  // squared norms: the same fmaf order as the dot products below
  for (int i = tid; i < n; i += kThreads) {
    const float* row = xb + (size_t)i * c;
    float s = 0.f;
    for (int ci = 0; ci < c; ++ci) s = fmaf(row[ci], row[ci], s);
    sq[i] = s;
  }

  float best_d[kPerWarp], worst_d[kPerWarp];
  int best_i[kPerWarp], worst_i[kPerWarp];
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    best_d[q] = worst_d[q] = INFINITY;
    best_i[q] = worst_i[q] = 0x7fffffff;
  }

  for (int cand0 = 0; cand0 < n; cand0 += kTile) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < c; c0 += kChunk) {
      __syncthreads();  // the previous chunk (or the previous tile's selection) is done
      for (int e = tid; e < kTile * kChunk; e += kThreads) {
        const int p = e / kChunk, ci = e % kChunk;
        const bool in_c = c0 + ci < c;
        const int centre = centre0 + p, cand = cand0 + p;
        cs[ci * kLd + p] = (in_c && centre < n) ? xb[(size_t)centre * c + c0 + ci] : 0.f;
        ds[ci * kLd + p] = (in_c && cand < n) ? xb[(size_t)cand * c + c0 + ci] : 0.f;
      }
      __syncthreads();
      const int steps = min(kChunk, c - c0);
      for (int ci = 0; ci < steps; ++ci) {
        const float4 a = *reinterpret_cast<const float4*>(cs + ci * kLd + ty * 4);
        const float4 v = *reinterpret_cast<const float4*>(ds + ci * kLd + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int centre = centre0 + ty * 4 + i;
      const float si = centre < n ? sq[centre] : 0.f;
      float dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cand = cand0 + tx * 4 + j;
        dv[j] = cand < n ? fmaf(-2.f, acc[i][j], si + sq[cand]) : INFINITY;
      }
      *reinterpret_cast<float4*>(dist + (ty * 4 + i) * kLd + tx * 4) = make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
    __syncthreads();

    // warp-wide selection: 8 centres per warp, 32 candidates per ballot
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      const float* drow = dist + (warp * kPerWarp + q) * kLd;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = drow[h * 32 + lane];
        const int j = cand0 + h * 32 + lane;
        unsigned mask = __ballot_sync(kAll, before(d, j, worst_d[q], worst_i[q]));
        while (mask) {
          const int src = __ffs(mask) - 1;
          const float nd = __shfl_sync(kAll, d, src);
          const int ni = __shfl_sync(kAll, j, src);
          const unsigned ahead = __ballot_sync(kAll, before(nd, ni, best_d[q], best_i[q]));
          const int pos = __ffs(ahead) - 1;  // first list slot the new entry precedes
          const float up_d = __shfl_up_sync(kAll, best_d[q], 1);
          const int up_i = __shfl_up_sync(kAll, best_i[q], 1);
          if (lane > pos) {
            best_d[q] = up_d;
            best_i[q] = up_i;
          } else if (lane == pos) {
            best_d[q] = nd;
            best_i[q] = ni;
          }
          worst_d[q] = __shfl_sync(kAll, best_d[q], k - 1);
          worst_i[q] = __shfl_sync(kAll, best_i[q], k - 1);
          mask &= ~(1u << src);
          mask &= __ballot_sync(kAll, before(d, j, worst_d[q], worst_i[q]));
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int centre = centre0 + warp * kPerWarp + q;
    if (centre < n && lane < k) out[((size_t)b * n + centre) * k + lane] = best_i[q];
  }
}

}  // namespace

extern "C" int pccf_knn(const float* x, int* out, int b, int n, int c, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k > n || c < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)((n + 3) & ~3) + 2 * kChunk * kLd + kTile * kLd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTile - 1) / kTile, b);
  knn_kernel<<<grid, kThreads, smem, stream>>>(x, out, n, c, k);
  return (int)cudaGetLastError();
}
