// The resident-slice pool: out[b, i, c] = reduce over j in slot order of
// x[b, idx[b, i, j], c], the device routine of graph_max_pool.cu (max), and of
// pccf_graph_sum_pool (sum) and pccf_graph_max_pool_src (max with its winning
// slot) in gather_scatter.cu.
//
// Replaces the row reads of pccf/kernels/pallas_gather.py _pool_forward:80,
// _pool_src_forward:121 and _sum_pool_forward:256.  The TPU kernels keep a
// sample's whole (N, C) block in VMEM (pallas_gather.py:88, :130, :264) and
// gather rows from there; a Hopper block has at most 227 KB of shared memory,
// too little for (2048, 256) fp32, so the block is cut along channels.
//
// What bounds it: bytes.  Each centre reduces k rows, so a kernel that
// gathers from device memory moves k times its input (838.9 MB at (16, 2048,
// 256) k=25, against 33.5 MB of x), through L1 and L2.  Here a block owns
// (sample b, channel slice [c0, c0 + S), a range of centres): it copies
// x[b, :, c0:c0+S], all N rows since neighbours are arbitrary, into dynamic
// shared memory once by TMA (boxes of 256 rows x S channels of a 2-D tensor
// map over (B * N, C), the last box as tall as the rows left, completed on
// one mbarrier), then every centre of its range reads its k rows of the slice
// from shared memory and writes out[b, i, c0:c0+S] once.  Device memory and
// L2 carry each input byte once per centre range.  What is left is the
// shared-memory traffic: k * S * 4 bytes a centre, whose 16-byte reads
// conflict when two rows of a quarter-warp share banks (with S = 16, two
// 64-byte rows a quarter-warp, half the time: ~1.5 passes a read, the least
// for two random rows a pass), and one 4-byte read of a staged neighbour
// index a slot.  A 16-channel slice of 2048 rows takes 128 KiB, so one block
// runs on an SM at a time and its copy of the slice is not overlapped.
//
// The plan (slice_plan below, mirrored by pccf_torch.kernels.gather.pool_plan)
// picks S in {16, 8, 4} and the number of centre ranges R from (B, N, C) and
// the SM count: the widest slice that fits and gives at least a third of the
// SMs a block, R the largest power of two that keeps B * (C / S) * R within one
// block an SM, ranges of at least 256 centres.  A block has 64 * S threads,
// S / 4 a centre, one float4 each: 256 centres a pass.  N is limited by the
// narrowest slice: N * 16 bytes and 9 KB of staged indices, N <= 13951.
//
// Reductions (a Reduce class: its accumulator, seed, step and store):
//   PoolMax seeds with slot 0 and takes v when v > m or v is NaN (ties keep
//     the earlier value, NaN propagates as in torch.amax), bit-identical to
//     the plain version;
//   PoolMaxSlot seeds the max and the slot with slot 0 and takes v, and its
//     slot j, only when v > m: ties keep the earliest slot and a NaN never
//     displaces the running value, the rule of the TPU kernel
//     (pallas_gather.py:111).  It differs from PoolMax (and from argmax, which
//     the plain version and pccf/kernels/ops.py:126 take) only where a NaN
//     lies past slot 0.  The slot is written as uint8 (k <= 255) beside the max;
//   PoolSum starts from slot 0's row and adds the others in slot order with
//     plain fp32 adds, the order of the TPU kernel (pallas_gather.py:246-249).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "device_attr.cuh"
#include "hopper.cuh"

namespace pccf {

constexpr int kPoolMaxSmem = 232448;  // shared memory a block can use on an H100 (227 KB)
constexpr int kPoolBoxRows = 256;     // rows of one TMA box, at most 256
constexpr int kPoolPassCentres = 256; // centres a block reduces at once
constexpr int kPoolMaxRanges = 8;     // reloads of a slice at most: below the gathered bytes for k > 8

struct SlicePlan {
  int s;       // channels a slice, 0 when the shape is not covered
  int ranges;  // centre ranges per (sample, slice)
  int smem;    // dynamic shared memory of a block, bytes
};

// the slice, a chunk of neighbour indices for the block's 256 centres (2S + 1
// words each) and the mbarrier
inline int slice_smem(int n, int s) { return n * s * 4 + kPoolPassCentres * (2 * s + 1) * 4 + 8; }

// s = 0 chooses the width; s in {4, 8, 16} fixes it (for timing the others)
inline SlicePlan slice_plan(int b, int n, int c, int s, int sms) {
  const auto fits = [&](int w) { return c % w == 0 && n <= kPoolMaxSmem && slice_smem(n, w) <= kPoolMaxSmem; };
  const auto plan = [&](int w) {
    const long long slices = (long long)b * (c / w);
    const int cap = std::max(1, std::min(kPoolMaxRanges, n / kPoolPassCentres));
    int r = 1;
    while (2 * r <= cap && slices * 2 * r <= sms) r *= 2;
    return SlicePlan{w, r, slice_smem(n, w)};
  };
  if (b < 1 || n < 1 || c < 4 || c % 4 != 0 || b > 65535) return SlicePlan{0, 0, 0};
  if (s != 0) return (s == 4 || s == 8 || s == 16) && fits(s) ? plan(s) : SlicePlan{0, 0, 0};
  SlicePlan last{0, 0, 0};
  for (int w = 16; w >= 4; w /= 2) {
    if (!fits(w)) continue;
    last = plan(w);
    if (3LL * b * (c / w) * last.ranges >= sms) return last;
  }
  return last;  // the narrowest slice that fits: the most blocks
}

struct SlicePoolArgs {
  CUtensorMap full;  // boxes of kPoolBoxRows rows x S channels
  CUtensorMap tail;  // one box of N % kPoolBoxRows rows (unused when 0)
  const int* idx;
  float* out;
  uint8_t* slot;  // PoolMaxSlot's winning slots, (B, N, C) uint8
  int n, c, k, range;
};

// A Reduce has an accumulator Acc (zero-initialised), seed(acc, v) for slot
// 0's float4, step(acc, v, j) for slot j's, and store(a, at, acc), at the
// float4 index of (b, i, c0 + 4q) in the (B, N, C) output
struct PoolMax {
  using Acc = float4;
  // running max m against a new value v: the earlier value stays on ties, a
  // NaN on either side wins
  static __device__ __forceinline__ float one(float m, float v) { return (v > m || v != v) ? v : m; }
  static __device__ __forceinline__ void seed(float4& m, const float4 v) { m = v; }
  static __device__ __forceinline__ void step(float4& m, const float4 v, int) {
    m.x = one(m.x, v.x);
    m.y = one(m.y, v.y);
    m.z = one(m.z, v.z);
    m.w = one(m.w, v.w);
  }
  static __device__ __forceinline__ void store(const SlicePoolArgs& a, long long at, const float4& m) {
    reinterpret_cast<float4*>(a.out)[at] = m;
  }
};

struct MaxSlot {
  float4 m;
  int s0, s1, s2, s3;  // one register a channel: a select a slot, packed to bytes at the store
};

struct PoolMaxSlot {
  using Acc = MaxSlot;
  static __device__ __forceinline__ void take(float& m, int& s, float v, int j) {
    if (v > m) {  // strict: ties keep the earlier slot, a NaN candidate never wins
      m = v;
      s = j;
    }
  }
  static __device__ __forceinline__ void seed(MaxSlot& acc, const float4 v) {
    acc.m = v;
    acc.s0 = acc.s1 = acc.s2 = acc.s3 = 0;
  }
  static __device__ __forceinline__ void step(MaxSlot& acc, const float4 v, int j) {
    take(acc.m.x, acc.s0, v.x, j);
    take(acc.m.y, acc.s1, v.y, j);
    take(acc.m.z, acc.s2, v.z, j);
    take(acc.m.w, acc.s3, v.w, j);
  }
  static __device__ __forceinline__ void store(const SlicePoolArgs& a, long long at, const MaxSlot& acc) {
    reinterpret_cast<float4*>(a.out)[at] = acc.m;
    reinterpret_cast<uint32_t*>(a.slot)[at] =
        (uint32_t)acc.s0 | (uint32_t)acc.s1 << 8 | (uint32_t)acc.s2 << 16 | (uint32_t)acc.s3 << 24;
  }
};

struct PoolSum {
  using Acc = float4;
  static __device__ __forceinline__ void seed(float4& s, const float4 v) { s = v; }
  static __device__ __forceinline__ void step(float4& s, const float4 v, int) {
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z);
    s.w = __fadd_rn(s.w, v.w);
  }
  static __device__ __forceinline__ void store(const SlicePoolArgs& a, long long at, const float4& s) {
    reinterpret_cast<float4*>(a.out)[at] = s;
  }
};

// grid (C / S, ranges, B), 64 * S threads, slice_smem(N, S) bytes
template <int S, class Reduce>
__global__ void __launch_bounds__(64 * S) slice_pool_kernel(const __grid_constant__ SlicePoolArgs a) {
  constexpr int kVec = S / 4;              // float4 a slice row: threads a centre
  constexpr int kCentres = 32 / kVec;      // centres a warp
  constexpr int kChunk = 2 * S;            // slots of a centre a chunk: 32, 16, 8
  constexpr int kPer = kChunk / kVec;      // indices a lane loads a chunk: 8
  constexpr int kRow = kChunk + 1;         // a staged row, padded: a warp's centres on distinct banks
  extern __shared__ __align__(128) float4 slice[];
  int* staged = reinterpret_cast<int*>(slice + (size_t)a.n * kVec);
  uint64_t* bar = reinterpret_cast<uint64_t*>(staged + kPoolPassCentres * kRow);
  staged += (threadIdx.x / 32) * kCentres * kRow;  // this warp's rows
  const int c0 = blockIdx.x * S;
  const long long row0 = (long long)blockIdx.z * a.n;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, (uint32_t)a.n * S * 4);
    const int boxes = a.n / kPoolBoxRows;
    for (int j = 0; j < boxes; ++j)
      tma_load_2d(slice + (size_t)j * kPoolBoxRows * kVec, &a.full, bar, c0, (int)(row0 + j * kPoolBoxRows));
    if (a.n % kPoolBoxRows)
      tma_load_2d(slice + (size_t)boxes * kPoolBoxRows * kVec, &a.tail, bar, c0, (int)(row0 + boxes * kPoolBoxRows));
  }

  // A warp's centres read their neighbour indices in chunks of kChunk slots:
  // the warp loads a chunk for all its centres with coalesced reads (lane +
  // 32 t walks the chunk row by row), one chunk ahead of the one it reduces
  // (the next pass's first chunk during a pass's last), and stages it in
  // shared memory, where each centre's threads read their slots.
  const int lane = threadIdx.x % 32;
  const int q = threadIdx.x % kVec;
  const int first = blockIdx.y * a.range;
  const int last = min(a.n, first + a.range);
  const int chunks = (a.k + kChunk - 1) / kChunk;
  const auto load = [&](int (&r)[kPer], int p, int j0) {
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = lane + 32 * t;
      const int i = p + (int)(threadIdx.x / 32) * kCentres + e / kChunk;
      const int j = j0 + e % kChunk;
      r[t] = i < last && j < a.k ? __ldg(a.idx + (row0 + i) * a.k + j) : 0;
    }
  };
  int next[kPer];
  load(next, first, 0);
  __syncthreads();  // the barrier is initialised before any thread waits on it
  mbar_wait(bar, 0);

  const int out_col = blockIdx.x * kVec + q;  // float4 column of (c0 + 4q)
  const long long out_stride = a.c / 4;
  const int* mine = staged + (lane / kVec) * kRow;
  // passes and chunks are the same for every thread of the block, so a
  // warp's lanes meet at every __syncwarp; centres past the range load
  // and write nothing
  for (int p = first; p < last; p += kPoolPassCentres) {
    const int i = p + (int)threadIdx.x / kVec;
    typename Reduce::Acc acc{};
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int e = lane + 32 * t;
        staged[(e / kChunk) * kRow + e % kChunk] = next[t];
      }
      __syncwarp();
      if (c + 1 < chunks)
        load(next, p, (c + 1) * kChunk);
      else
        load(next, p + kPoolPassCentres, 0);
      const int slots = min(kChunk, a.k - c * kChunk);
      int u = 0;
      if (c == 0) {
        Reduce::seed(acc, slice[mine[0] * kVec + q]);  // slot 0 seeds the reduction
        u = 1;
      }
#pragma unroll 8
      for (; u < slots; ++u) Reduce::step(acc, slice[mine[u] * kVec + q], c * kChunk + u);
      __syncwarp();  // every lane has read the chunk before it is overwritten
    }
    if (i < last) Reduce::store(a, (row0 + i) * out_stride + out_col, acc);
  }
}

// rows of a (rows, cols) fp32 matrix in boxes of box_rows x s columns, no swizzle
inline bool encode_slice_map(EncodeTiled fn, CUtensorMap* map, const float* x, long long rows, int cols, int s,
                             int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)s, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the current device's SM count, read once a device
inline int device_sms() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

template <int S, class Reduce>
int launch_slice_pool(const SlicePlan& p, const float* x, const int* idx, float* out, uint8_t* slot, int b, int n,
                      int c, int k, cudaStream_t stream) {
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)slice_pool_kernel<S, Reduce>, kPoolMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  SlicePoolArgs a = {};
  const long long rows = (long long)b * n;
  if (n >= kPoolBoxRows && !encode_slice_map(fn, &a.full, x, rows, c, S, kPoolBoxRows))
    return (int)cudaErrorInvalidValue;
  if (n % kPoolBoxRows && !encode_slice_map(fn, &a.tail, x, rows, c, S, n % kPoolBoxRows))
    return (int)cudaErrorInvalidValue;
  a.idx = idx;
  a.out = out;
  a.slot = slot;
  a.n = n;
  a.c = c;
  a.k = k;
  a.range = (n + p.ranges - 1) / p.ranges;
  slice_pool_kernel<S, Reduce><<<dim3(c / S, p.ranges, b), 64 * S, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// x (B, N, C), idx (B, N, k) with entries in [0, N) -> out (B, N, C) (and, for
// PoolMaxSlot, slot (B, N, C) uint8, 4-byte aligned); C % 4 == 0, x and out
// 16-byte aligned, k >= 1, N <= 13951; slice_width 0 takes the plan's
template <class Reduce>
int slice_pool(const float* x, const int* idx, float* out, int b, int n, int c, int k, int slice_width,
               cudaStream_t stream, uint8_t* slot = nullptr) {
  const SlicePlan p = slice_plan(b, n, c, slice_width, device_sms());
  if (p.s == 0 || k < 1 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (p.s) {
    case 16: return launch_slice_pool<16, Reduce>(p, x, idx, out, slot, b, n, c, k, stream);
    case 8: return launch_slice_pool<8, Reduce>(p, x, idx, out, slot, b, n, c, k, stream);
    default: return launch_slice_pool<4, Reduce>(p, x, idx, out, slot, b, n, c, k, stream);
  }
}

}  // namespace pccf
