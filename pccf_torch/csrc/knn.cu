// Exact self-kNN indices on Hopper.
//
// Replaces pccf/kernels/pallas_knn.py:183 knn_tpu (body _knn_kernel:86).
// out[b, i, :] holds the k nearest points of cloud b to point i, self
// included, ordered by (squared distance, index): the lowest index wins a
// tie, the rule of the plain version (a stable sort, pccf_torch/kernels/ops.py).
// A NaN distance (a NaN coordinate in either point) ranks after every number,
// +inf included, as that sort puts it: a NaN point is in no finite point's
// list while it has k nearer candidates, and a NaN centre's list is 0 .. k-1.
//
// What bounds it: the distance sweep, B*N*N*C multiply-adds (16*2048*2048*128
// at the largest call), and the selection of k of N candidates per centre, a
// chain of dependent warp shuffles per accepted candidate.
//
// Design:
// - Norms once.  knn_norms_kernel computes every point's squared norm once
//   per call by the arithmetic of the products below (the same fmaf chain, or
//   the diagonal of the same 3xTF32 tensor-core product), so d(i, i) is
//   exactly 0 and exact duplicates tie at the same distance.  A distance is
//   max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0), or NaN.
// - Keys.  The producers store each distance as its ordering key
//   (dist_key: the clamp at 0 that keeps a NaN, as the canonical NaN): the
//   bits of a non-negative float order as the float does, so the selectors
//   compare the bits as unsigned integers, with every NaN one key above +inf
//   and an empty slot above that.  One instruction a distance and one
//   compare a pair, as with floats, and the order is total.
// - Distances.  A block owns 64 centres of one cloud, staged once in shared
//   memory, and walks its candidates in tiles of 64.  For C > 16 four
//   producer warps compute each 64x64 tile with mma.sync m16n8k8 in 3xTF32
//   (about fp32 accuracy, as the TPU kernel's bf16x3 product; x's big part
//   is x as the tensor cores truncate it, so a split is two instructions);
//   for C <= 16 (the clouds' C = 3) in fp32 FMA.
// - Selection off the critical path.  Eight selector warps own 8 centres
//   each and keep a sorted list per centre across the lanes (lane r holds the
//   r-th best), comparing (key, index) pairs everywhere, so ties stay
//   exact.  A tile's candidates that beat the k-th best are inserted at their
//   rank, one shuffle and two compares deep each; when more than 20 of the 64
//   enter (the first tiles), they are sorted by two interleaved warp-wide
//   bitonic sorts and merged with the list instead.  The distance tile is
//   double-buffered between producers and selectors under mbarriers, and the
//   producers stage the next candidates by cp.async while the current tile is
//   written and selected, so products, loads and selection overlap.
// - Splits at small batch.  The wrapper splits each cloud's candidates into
//   S contiguous ranges of tiles (S from B, N and the SM count,
//   pccf_torch/kernels/knn.py splits); with S > 1 each block writes its
//   centres' partial sorted lists of k (distance, index) pairs, and
//   knn_merge_kernel merges the S lists of a centre with warp-wide bitonic
//   merges.  A pair's distance is the same arithmetic in every block, and the
//   order is total, so the lists do not depend on S or on the batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace pccf;

constexpr int kMaxK = 32;
constexpr int kTile = 64;                                 // centres per block, candidates per tile
constexpr int kProducers = 4;                             // warps computing distance tiles
constexpr int kSelectors = 8;                             // warps selecting
constexpr int kPerWarp = kTile / kSelectors;              // centres per selector warp
constexpr int kThreads = (kProducers + kSelectors) * 32;  // 384
constexpr int kProducerThreads = kProducers * 32;
constexpr int kSelectorThreads = kSelectors * 32;
constexpr int kDl = kTile + 8;  // distance tile row stride: conflict-free float2 stores
constexpr int kFmaMaxC = 16;    // above this, 3xTF32 tensor-core distances
constexpr int kMaxC = 256;
constexpr int kMaxSplits = 16;
constexpr int kSortMin = 20;  // above this many entrants a tile, sort and merge rather than insert
constexpr int kBarProducers = 1;  // named barrier of the producer warps (0 is __syncthreads)
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // an empty slot: after every distance, NaN's 0x7fffffff included
constexpr int kNoIndex = 0x7fffffff;

// the ordering key of a squared distance, as a float's bits: max(v, 0), a
// NaN kept as the canonical NaN 0x7fffffff, one key above +inf (PTX
// max.NaN, one instruction as fmaxf).  A -0 does not arise: the norms' sum
// is +0 or more
__device__ __forceinline__ float dist_key(float v) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(v), "f"(0.f));
  return d;
}

__device__ __forceinline__ bool before(uint32_t da, int ia, uint32_t db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// copy `bytes` (4 or 16) from global to shared memory, zero-filled when !ok
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok, bool vec) {
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// compare-exchange with the lane `mask` away, keeping the smaller (d, i) pair
// when keep_min, else the larger
__device__ __forceinline__ void cmpx(uint32_t& d, int& i, int mask, bool keep_min) {
  const uint32_t pd = __shfl_xor_sync(kAll, d, mask);
  const int pi = __shfl_xor_sync(kAll, i, mask);
  if (keep_min ? before(pd, pi, d, i) : before(d, i, pd, pi)) {
    d = pd;
    i = pi;
  }
}

// two ascending bitonic sorts of one (d, i) pair per lane, interleaved
__device__ __forceinline__ void sort32x2(uint32_t& d0, int& i0, uint32_t& d1, int& i1, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      cmpx(d0, i0, stride, keep_min);
      cmpx(d1, i1, stride, keep_min);
    }
}

// (d, i) <- the 32 smallest of two ascending lists, ascending: the element-wise
// minimum of one list and the other reversed is bitonic, then a bitonic merge
__device__ __forceinline__ void merge_lists(uint32_t& d, int& i, uint32_t od, int oi, int lane) {
  const uint32_t rd = __shfl_sync(kAll, od, 31 - lane);
  const int ri = __shfl_sync(kAll, oi, 31 - lane);
  if (before(rd, ri, d, i)) {
    d = rd;
    i = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) cmpx(d, i, stride, (lane & stride) == 0);
}

// insert (nd, ni) into the ascending list (bd, bi) at its rank; the last
// entry falls off.  The shuffle up does not wait for the new entry, so a run
// of insertions is one shuffle and two compares deep each
__device__ __forceinline__ void insert(uint32_t& bd, int& bi, uint32_t nd, int ni, int lane) {
  const uint32_t ud = __shfl_up_sync(kAll, bd, 1);
  const int ui = __shfl_up_sync(kAll, bi, 1);
  if (before(nd, ni, bd, bi)) {
    const bool here = lane == 0 || before(ud, ui, nd, ni);
    bd = here ? nd : ud;
    bi = here ? ni : ui;
  }
}

// x = big + small for 3xTF32: big is x itself, which the tensor cores read
// truncated to TF32 (its low 13 bits ignored), small = x - that exactly, read
// truncated too: it loses about 2^-22 of x, the size of the small * small
// term 3xTF32 drops.  Two instructions and no rounding conversion.
__device__ __forceinline__ void split_trunc(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xFFFFE000u));
}

// the padded channel count and row stride of a staged (64, C) tile: C to the
// mma's k step, the stride = 4 (mod 8) words, so fragment reads of 8 rows x 4
// columns hit 32 banks
__host__ __device__ __forceinline__ int pad_c(int c) { return (c + 7) & ~7; }

// ----------------------------------------------------------------- norms

// FMA path: |x|^2 as the same fmaf chain as the distance tile's dot products
__global__ void knn_norms_fma_kernel(const float* __restrict__ x, float* __restrict__ sq, int points, int c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= points) return;
  const float* row = x + (size_t)p * c;
  float s = 0.f;
  for (int ci = 0; ci < c; ++ci) s = fmaf(row[ci], row[ci], s);
  sq[p] = s;
}

// tensor-core path: a warp takes 8 points; A rows g and g + 8 and B column g
// are point g, so the product's diagonal (g, g) is |x_g|^2 by the same 3xTF32
// k steps, in the same order, as the distance tile's (i, j) entries
__global__ void knn_norms_tc_kernel(const float* __restrict__ x, float* __restrict__ sq, int points, int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int p = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 8 + g;
  const bool valid = p < points;
  const float* row = x + (size_t)(valid ? p : 0) * c;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < pad_c(c); k0 += 8) {
    const float v0 = valid && k0 + t < c ? row[k0 + t] : 0.f;
    const float v1 = valid && k0 + t + 4 < c ? row[k0 + t + 4] : 0.f;
    uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
    split_trunc(v0, a_big[0], a_small[0]);
    split_trunc(v0, a_big[1], a_small[1]);
    split_trunc(v1, a_big[2], a_small[2]);
    split_trunc(v1, a_big[3], a_small[3]);
    split_trunc(v0, b_big[0], b_small[0]);
    split_trunc(v1, b_big[1], b_small[1]);
    mma_3xtf32(acc, a_big, a_small, b_big, b_small);
  }
  // (g, g) is c0 = (g, 2t) of lane t = g / 2 for even g, c1 = (g, 2t + 1) for odd g
  if (valid && t == (g >> 1)) sq[p] = (g & 1) ? acc[1] : acc[0];
}

// ------------------------------------------------------------ selection

struct KnnArgs {
  const float* x;   // (B, N, C)
  const float* sq;  // (B, N) squared norms
  float* part_d;    // (B, S, N, k) partial lists when S > 1
  int* part_i;
  int* out;  // (B, N, k) when S == 1
  int n, c, k, splits, tiles, vec;
};

// start copying rows r0 .. r0 + 63 of a cloud into shared memory, channels
// zero-padded to pad_c(c), rows past n zero; 16-byte copies when vec (C a
// multiple of 4, x 16-byte aligned)
__device__ __forceinline__ void stage_rows(float* dst, const float* xb, int r0, int n, int c, bool vec, int tid,
                                           int threads) {
  const int cp = pad_c(c), ld = cp + 4, w = vec ? 4 : 1, q = cp / w;
  for (int e = tid; e < kTile * q; e += threads) {
    const int p = e / q, ci = (e - p * q) * w;
    const bool ok = ci < c && r0 + p < n;
    cp_async(dst + p * ld + ci, ok ? xb + (size_t)(r0 + p) * c + ci : xb, ok, vec);
  }
}

template <bool kTc>
__global__ void __launch_bounds__(kThreads, 2) knn_kernel(const KnnArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = pad_c(a.c) + 4;
  float* cen = smem;                     // [64][ld] centres
  float* cand = cen + kTile * ld;        // [64][ld] candidates of the current tile
  float* csq = cand + kTile * ld;        // [2][64] their squared norms (inf past n), by tile parity
  float* dist = csq + 2 * kTile;         // [2][64][kDl] distance tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(dist + 2 * kTile * kDl);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, split = blockIdx.y, centre0 = blockIdx.x * kTile;
  const int n = a.n;
  const int t0 = split * a.tiles / a.splits, t1 = (split + 1) * a.tiles / a.splits;
  const float* xb = a.x + (size_t)b * n * a.c;
  const float* sqb = a.sq + (size_t)b * n;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], kSelectorThreads);
    }
    mbar_fence_init();
  }
  stage_rows(cen, xb, centre0, n, a.c, a.vec, tid, kThreads);
  cp_async_wait_all();
  __syncthreads();

  if (warp < kProducers) {
    // ---- producers: one 64x64 distance tile per candidate tile ----------
    const int g = lane >> 2, t = lane & 3;
    float sq_row[2][4];  // the centres' norms at the rows this thread stores
    if (kTc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = centre0 + warp * 16 + g + 8 * h;
        sq_row[h][0] = r < n ? sqb[r] : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = centre0 + (tid >> 4) * 8 + i;
        sq_row[i >> 2][i & 3] = r < n ? sqb[r] : 0.f;
      }
    }
    // once every producer has read a tile's candidates, start the next one's
    auto stage_next = [&](int tile, int it) {
      bar_sync(kBarProducers, kProducerThreads);
      if (tile + 1 >= t1) return;
      const int next0 = (tile + 1) * kTile;
      stage_rows(cand, xb, next0, n, a.c, a.vec, tid, kProducerThreads);
      if (tid < kTile) csq[((it + 1) & 1) * kTile + tid] = next0 + tid < n ? sqb[next0 + tid] : INFINITY;
    };
    // the candidates of a tile are staged while the previous tile's distances
    // are written and selected
    stage_rows(cand, xb, t0 * kTile, n, a.c, a.vec, tid, kProducerThreads);
    if (tid < kTile) csq[tid] = t0 * kTile + tid < n ? sqb[t0 * kTile + tid] : INFINITY;
    for (int tile = t0, it = 0; tile < t1; ++tile, ++it) {
      cp_async_wait_all();
      bar_sync(kBarProducers, kProducerThreads);
      const int buf = it & 1;
      const float* tsq = csq + buf * kTile;
      float* dt = dist + buf * kTile * kDl;
      if (kTc) {
        // warp w: rows 16 w .. 16 w + 15, all 64 columns as 8 n-tiles
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
        const float* arow = cen + (warp * 16 + g) * ld + t;
        const float* brow = cand + g * ld + t;
        for (int k0 = 0; k0 < ld - 4; k0 += 8) {
          uint32_t a_big[4], a_small[4];
          split_trunc(arow[k0], a_big[0], a_small[0]);
          split_trunc(arow[8 * ld + k0], a_big[1], a_small[1]);
          split_trunc(arow[k0 + 4], a_big[2], a_small[2]);
          split_trunc(arow[8 * ld + k0 + 4], a_big[3], a_small[3]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            uint32_t b_big[2], b_small[2];
            split_trunc(brow[nt * 8 * ld + k0], b_big[0], b_small[0]);
            split_trunc(brow[nt * 8 * ld + k0 + 4], b_big[1], b_small[1]);
            mma_3xtf32(acc[nt], a_big, a_small, b_big, b_small);
          }
        }
        stage_next(tile, it);
        if (it >= 2) mbar_wait(&empty[buf], ((it >> 1) + 1) & 1);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + 2 * t;
          const float s0 = tsq[col], s1 = tsq[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float si = sq_row[h][0];
            const float d0 = dist_key(fmaf(-2.f, acc[nt][2 * h], si + s0));
            const float d1 = dist_key(fmaf(-2.f, acc[nt][2 * h + 1], si + s1));
            *reinterpret_cast<float2*>(dt + (warp * 16 + g + 8 * h) * kDl + col) = make_float2(d0, d1);
          }
        }
      } else {
        // thread: rows 8 (tid / 16) .. +7, columns 4 (tid % 16) .. +3
        const int ry = (tid >> 4) * 8, cx = (tid & 15) * 4;
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int ci = 0; ci < a.c; ++ci) {
          float av[8], bv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) av[i] = cen[(ry + i) * ld + ci];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = cand[(cx + j) * ld + ci];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        stage_next(tile, it);
        if (it >= 2) mbar_wait(&empty[buf], ((it >> 1) + 1) & 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float si = sq_row[i >> 2][i & 3];
          float dv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) dv[j] = dist_key(fmaf(-2.f, acc[i][j], si + tsq[cx + j]));
          *reinterpret_cast<float4*>(dt + (ry + i) * kDl + cx) = make_float4(dv[0], dv[1], dv[2], dv[3]);
        }
      }
      mbar_arrive(&full[buf]);
    }
    return;
  }

  // ---- selectors: 8 centres per warp, 64 candidates a tile each ---------
  const int sw = warp - kProducers;
  uint32_t best_d[kPerWarp], worst_d[kPerWarp];
  int best_i[kPerWarp], worst_i[kPerWarp];
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    best_d[q] = worst_d[q] = kNone;
    best_i[q] = worst_i[q] = kNoIndex;
  }
  const int k = a.k, count = t1 - t0;
  for (int tile = t0, it = 0; tile < t1; ++tile, ++it) {
    const int buf = it & 1, j0 = tile * kTile + lane, j1 = j0 + 32;
    mbar_wait(&full[buf], (it >> 1) & 1);
    const float* dt = dist + buf * kTile * kDl;
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      const float* drow = dt + (sw * kPerWarp + q) * kDl;
      uint32_t d0 = __float_as_uint(drow[lane]), d1 = __float_as_uint(drow[32 + lane]);
      const bool p0 = j0 < n && before(d0, j0, worst_d[q], worst_i[q]);
      const bool p1 = j1 < n && before(d1, j1, worst_d[q], worst_i[q]);
      const unsigned m0 = __ballot_sync(kAll, p0), m1 = __ballot_sync(kAll, p1);
      if (__popc(m0) + __popc(m1) > kSortMin) {
        // many enter (the first tiles): sort the tile's entrants and merge
        int i0 = p0 ? j0 : kNoIndex, i1 = p1 ? j1 : kNoIndex;
        d0 = p0 ? d0 : kNone;
        d1 = p1 ? d1 : kNone;
        sort32x2(d0, i0, d1, i1, lane);
        merge_lists(d0, i0, d1, i1, lane);
        merge_lists(best_d[q], best_i[q], d0, i0, lane);
      } else {
        // few enter: insert each at its rank, in ascending index order
        for (unsigned m = m0; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          insert(best_d[q], best_i[q], __shfl_sync(kAll, d0, src), j0 - lane + src, lane);
        }
        for (unsigned m = m1; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          insert(best_d[q], best_i[q], __shfl_sync(kAll, d1, src), j1 - lane + src, lane);
        }
      }
      worst_d[q] = __shfl_sync(kAll, best_d[q], k - 1);
      worst_i[q] = __shfl_sync(kAll, best_i[q], k - 1);
    }
    if (it + 2 < count) mbar_arrive(&empty[buf]);  // the producers refill this buffer two tiles on
  }

#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int centre = centre0 + sw * kPerWarp + q;
    if (centre >= n || lane >= k) continue;
    if (a.splits == 1) {
      a.out[((size_t)b * n + centre) * k + lane] = best_i[q];
    } else {
      const size_t at = (((size_t)b * a.splits + split) * n + centre) * k + lane;
      a.part_d[at] = __uint_as_float(best_d[q]);  // the key's bits
      a.part_i[at] = best_i[q];
    }
  }
}

// one warp per centre: merge its S sorted partial lists of k (keys) into the k best
__global__ void knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                                 int* __restrict__ out, int points, int n, int k, int splits) {
  const int gw = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (gw >= points) return;
  const int b = gw / n, i = gw - b * n;
  const size_t stride = (size_t)n * k;
  const size_t base = ((size_t)b * splits * n + i) * k;
  uint32_t d = lane < k ? __float_as_uint(part_d[base + lane]) : kNone;
  int id = lane < k ? part_i[base + lane] : kNoIndex;
  for (int s = 1; s < splits; ++s) {
    const uint32_t od = lane < k ? __float_as_uint(part_d[base + s * stride + lane]) : kNone;
    const int oi = lane < k ? part_i[base + s * stride + lane] : kNoIndex;
    merge_lists(d, id, od, oi, lane);
  }
  if (lane < k) out[(size_t)gw * k + lane] = id;
}

size_t knn_smem(int c) {
  const int ld = pad_c(c) + 4;
  return (size_t)(2 * kTile * ld + 2 * kTile + 2 * kTile * kDl) * sizeof(float) + 4 * sizeof(uint64_t);
}

}  // namespace

// out (B, N, k) int32 from x (B, N, C) fp32; sq (B, N) fp32 scratch; with
// splits > 1, part_d / part_i (B, splits, N, k) scratch (part_d holds keys).  1 <= k <= min(32, N),
// 1 <= C <= 256, 1 <= splits <= min(16, ceil(N / 64)).
extern "C" int pccf_knn(const float* x, float* sq, float* part_d, int* part_i, int* out, int b, int n, int c, int k,
                        int splits, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  if (b < 1 || n < 1 || k < 1 || k > kMaxK || k > n || c < 1 || c > kMaxC || splits < 1 || splits > kMaxSplits ||
      splits > tiles || !sq || (splits > 1 && (!part_d || !part_i)))
    return (int)cudaErrorInvalidValue;
  const bool tc = c > kFmaMaxC;
  static MaxSmem max_smem_tc, max_smem_fma;
  const cudaError_t attr = tc ? max_smem_tc((const void*)knn_kernel<true>, (int)knn_smem(kMaxC))
                              : max_smem_fma((const void*)knn_kernel<false>, (int)knn_smem(kFmaMaxC));
  if (attr != cudaSuccess) return (int)attr;
  const int points = b * n;
  if (tc)
    knn_norms_tc_kernel<<<(points + 63) / 64, 256, 0, stream>>>(x, sq, points, c);
  else
    knn_norms_fma_kernel<<<(points + 255) / 256, 256, 0, stream>>>(x, sq, points, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = c % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const KnnArgs args{x, sq, part_d, part_i, out, n, c, k, splits, tiles, vec};
  const dim3 grid(tiles, splits, b);
  if (tc)
    knn_kernel<true><<<grid, kThreads, knn_smem(c), stream>>>(args);
  else
    knn_kernel<false><<<grid, kThreads, knn_smem(c), stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  knn_merge_kernel<<<(points + 7) / 8, 256, 0, stream>>>(part_d, part_i, out, points, n, k, splits);
  return (int)cudaGetLastError();
}
