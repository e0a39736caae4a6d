// Neighbour gather, sum-pool, max-pool with winning slot, and the scatter-add
// backwards of all three, on Hopper.
//
// Replaces, in pccf/kernels/pallas_gather.py:
//   _gather_forward:309 (gather_neighbors_tpu:329)  -> pccf_gather_neighbors
//   _scatter_add_rows:182 (backward of sum-pool and gather) -> pccf_scatter_add_rows
//   _pool_src_forward:121 (train forward of graph_max_pool_tpu) -> pccf_graph_max_pool_src
//   _scatter_add_slots:200 (backward of graph_max_pool_tpu) -> pccf_scatter_add_slots
//   _sum_pool_forward:256 (graph_sum_pool_tpu:275) -> pccf_graph_sum_pool
//
// What bounds them: bytes.  Every forward reads k rows per centre (mostly L2
// hits: each row is read by ~k centres) and writes one row (pools) or k rows
// (gather).  The TPU kernels keep the (N, C) operand resident in VMEM and
// accumulate the scatters in place across grid steps that run in order, so
// each output element gets its terms in ascending centre order from 0.0;
// blocks on the card run in parallel and in no order.  Neither scatter here
// uses atomics: each keeps the TPU kernel's order, so dx equals its plain
// version run on the CPU bit for bit, on every run.
//
// The row scatter is a sum-pool over the transposed graph instead, with no
// atomics: two launches build each sample's reverse adjacency (row offsets,
// and for each row the source centres of its in-edges e = i * k + j in
// ascending e), and a third sums those g rows in list order from 0.0 with
// plain fp32 adds.  Ascending e is the
// order of the TPU kernel's grid and of index_add_ on the CPU.  A row no edge
// reaches is written as zeros; nothing clears dx first.
//
// The slot scatter holds a dx slice in shared memory instead: a block owns
// dx[b, rows r0..r1, c0:c0+S] (slot_scatter_plan), zeroes it there, walks
// all of the sample's centres in ascending i and adds g[b, i, c] onto row
// idx[b, i, slot[b, i, c]] when it lies in the block's rows, each row's
// terms by one lane in ascending i; then it writes its rows once.  Ascending i is the order of the TPU
// kernel (pallas_gather.py:161-179) and of scatter_add_ on the CPU.
//
// The three pools are the resident-slice pool of slice_pool.cuh: a block
// copies one channel slice of a sample into shared memory once by TMA and
// reduces its centres' rows from there (the sum in slot order, the max with
// its winning slot by the TPU kernel's strict >, pallas_gather.py:111).
// The slot output is uint8 (k <= 255), a quarter of the int32 slots of the
// TPU kernel: it is written once and read once per training step.
//
// The gather: one thread per output element, or per 4 channels (one 16-byte
// load per neighbour) where C % 4 == 0, so a warp covers consecutive channels
// of one row and every access is coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "slice_pool.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

unsigned grid_for(long long total) { return (unsigned)((total + THREADS - 1) / THREADS); }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// out[b, i, j, :] = x[b, idx[b, i, j], :]; T is float or float4, cv = C / width(T)
template <typename T>
__global__ void gather_kernel(const T* __restrict__ x, const int* __restrict__ idx, T* __restrict__ out, int n,
                              int k, int cv, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / cv;  // flat (b, i, j)
  const int ch = (int)(t - row * cv);
  const long long b = row / ((long long)n * k);
  out[t] = __ldg(x + (b * n + __ldg(idx + row)) * cv + ch);
}

// ---- the row scatter: dx[b, r] = sum over the edges e = i * k + j with
// idx[b, i, j] = r, in ascending e, of g[b, i] ----
//
// Each edge is read twice in all, by three launches:
//   partition: block (c, b) takes a chunk of the sample's E = M * k edges and
//     writes them grouped by bucket (R = 2^rbits consecutive rows), each
//     group in ascending e, with each bucket's start and count in the chunk;
//   lists: block (g, b) reads bucket g's edges chunk by chunk, so in
//     ascending e, and writes the row offsets of its R rows (CSR) and, in
//     each row's list, the centre i = e / k of every edge into it;
//   gather: one thread per (row, channel vector) sums the g rows of its list
//     in order, as sum_pool_kernel does.
// A stable grouping inside a block: its warps take contiguous runs of the
// edges, 32 at a time; each warp counts into a histogram of its own, the
// lowest lane of each group of lanes with one label (matched by one ballot a
// label bit) adding the group's count, so no two threads write a counter at
// once; an exclusive scan over (label, warp) gives each warp's start for each
// label, and an edge's place is that start plus its rank among its group.
// A warp loads a batch of up to STEPS x 32 edges before it counts or places
// any: one memory latency a batch, not one a step (a short run takes fewer
// steps: at graph filtering's k = 1 a bucket's warp has ~32 edges).  Degree skew costs nothing but
// time: lists live in global scratch, and a hub row's edges are any number of
// the bucket's.
constexpr int PART_THREADS = 256;  // partition: 8 warps a chunk
constexpr int PART_WARPS = PART_THREADS / 32;
constexpr int PART_STEPS = 4;  // a warp's batch: 128 edges, a chunk of 1024 one batch a warp
constexpr int LIST_THREADS = 256;  // lists: 8 warps a bucket
constexpr int LIST_WARPS = LIST_THREADS / 32;
constexpr int LIST_STEPS = 8;
constexpr int MAX_GROUPS = 256;  // buckets a sample, and chunks a sample, at most
constexpr int MAX_RBITS = 8;  // rows a bucket at most 256
constexpr int EDGE_BITS = 23;  // (row in bucket) << 23 | e packs one non-negative int

struct ScatterPlan {
  int rbits, groups, gbits, chunk, chunks;
};

ScatterPlan scatter_plan(int n, int e_count) {
  ScatterPlan p;
  p.rbits = 6;  // 64 rows a bucket: 32 buckets at n = 2048
  while (p.rbits < MAX_RBITS && ((n + (1 << p.rbits) - 1) >> p.rbits) > MAX_GROUPS) ++p.rbits;
  p.groups = (n + (1 << p.rbits) - 1) >> p.rbits;
  p.gbits = 0;
  while ((1 << p.gbits) < p.groups) ++p.gbits;
  const int batch = PART_WARPS * 32 * PART_STEPS;
  const int even = (e_count + MAX_GROUPS - 1) / MAX_GROUPS;  // at most MAX_GROUPS chunks
  p.chunk = (even + batch - 1) / batch * batch;
  p.chunks = (e_count + p.chunk - 1) / p.chunk;
  return p;
}

// the lanes whose `bits`-bit label equals this lane's, among `members`;
// every lane of the warp calls it
__device__ __forceinline__ unsigned match_label(unsigned members, int label, int bits) {
  unsigned peers = members;
  for (int i = 0; i < bits; ++i) {
    const bool bit = (label >> i) & 1;
    const unsigned set = __ballot_sync(FULL_MASK, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// one step of a warp's stable grouping: count (PLACE false) or place the
// lanes' items by label into the warp's counters `mine`; place(at) stores
// this lane's item at its place
template <bool PLACE, typename Store>
__device__ __forceinline__ void group_step(int* mine, bool ok, int label, int bits, Store place) {
  const unsigned lower = (1u << (threadIdx.x % 32)) - 1u;
  const unsigned members = __ballot_sync(FULL_MASK, ok);
  const unsigned peers = match_label(members, label, bits);
  if (ok) {
    if (PLACE) {
      const int at = mine[label];
      place(at + __popc(peers & lower));
      __syncwarp(members);
      if ((peers & lower) == 0) mine[label] = at + __popc(peers);
    } else if ((peers & lower) == 0) {
      mine[label] += __popc(peers);
    }
  }
  __syncwarp();
}

// exclusive prefix sum of v over the block's threads (WARPS warps); total gets the sum
template <int WARPS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_part, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int p = warp_part[w];
    before += w < warp ? p : 0;
    total += p;
  }
  __syncthreads();
  return before + incl - v;
}

// hist[w][l] (a warp's counts of each label) -> the warp's start for each
// label, after base and every lower label's and lower warp's; one thread a
// label.  Returns the label's first place (its total in `count`).
template <int WARPS>
__device__ __forceinline__ int starts_from_counts(int* hist, int labels, int base, int* warp_part, int& count,
                                                  int& total) {
  count = 0;
  if (threadIdx.x < labels)
    for (int w = 0; w < WARPS; ++w) count += hist[w * labels + threadIdx.x];
  const int first = base + block_exclusive_scan<WARPS>(count, warp_part, total);
  if (threadIdx.x < labels) {
    int run = first;
    for (int w = 0; w < WARPS; ++w) {
      const int c = hist[w * labels + threadIdx.x];
      hist[w * labels + threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  return first;
}

// partition: chunk c of sample b -> packed[b][chunk c's span], grouped by
// bucket, ascending e in each; counts[b][c][g] = (start in the chunk, count)
__global__ void __launch_bounds__(PART_THREADS) scatter_partition_kernel(const int* __restrict__ idx,
                                                                         int* __restrict__ packed,
                                                                         int* __restrict__ counts, int e_count,
                                                                         int n, ScatterPlan p) {
  __shared__ int hist[PART_WARPS * MAX_GROUPS];
  __shared__ int warp_part[PART_WARPS];
  const int b = blockIdx.y, c = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = c * p.chunk, len = min(p.chunk, e_count - c0);
  const int lo = c0 + (int)((long long)len * warp / PART_WARPS);
  const int hi = c0 + (int)((long long)len * (warp + 1) / PART_WARPS);
  const int* ib = idx + (long long)b * e_count;
  int* pb = packed + (long long)b * e_count + c0;
  int* mine = hist + warp * p.groups;
  for (int t = threadIdx.x; t < PART_WARPS * p.groups; t += PART_THREADS) hist[t] = 0;
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    for (int e0 = lo; e0 < hi; e0 += 32 * PART_STEPS) {
      const int steps = min(PART_STEPS, (hi - e0 + 31) / 32);  // the same for the whole warp
      int d[PART_STEPS];
#pragma unroll
      for (int u = 0; u < PART_STEPS; ++u) {
        const int e = e0 + u * 32 + lane;
        d[u] = e < hi ? __ldg(ib + e) : -1;
      }
#pragma unroll
      for (int u = 0; u < PART_STEPS; ++u) {
        if (u == steps) break;
        const int e = e0 + u * 32 + lane;
        const bool ok = (unsigned)d[u] < (unsigned)n;  // an index outside [0, n) reaches no row
        const int grp = ok ? d[u] >> p.rbits : 0;
        if (pass == 0)
          group_step<false>(mine, ok, grp, p.gbits, [](int) {});
        else
          group_step<true>(mine, ok, grp, p.gbits, [&](int at) {
            pb[at] = ((d[u] & ((1 << p.rbits) - 1)) << EDGE_BITS) | e;
          });
      }
    }
    if (pass == 0) {
      __syncthreads();
      int count, total;
      const int first = starts_from_counts<PART_WARPS>(hist, p.groups, 0, warp_part, count, total);
      if (threadIdx.x < p.groups)
        reinterpret_cast<int2*>(counts)[((long long)b * p.chunks + c) * p.groups + threadIdx.x] =
            make_int2(first, count);
    }
  }
}

// lists: bucket g of sample b -> offsets[b][g*R .. g*R + rows] and the
// centres of each row's in-edges in ascending e, lists[b][offsets ...]
__global__ void __launch_bounds__(LIST_THREADS) scatter_lists_kernel(const int* __restrict__ packed,
                                                                     const int* __restrict__ counts,
                                                                     int* __restrict__ offsets,
                                                                     int* __restrict__ lists, int e_count, int n,
                                                                     int k, ScatterPlan p) {
  __shared__ int hist[LIST_WARPS << MAX_RBITS];
  __shared__ int seg_at[MAX_GROUPS + 1];  // where the bucket's edges of each chunk begin among its edges
  __shared__ int seg_from[MAX_GROUPS];    // and where they sit in packed
  __shared__ int warp_part[LIST_WARPS];
  const int b = blockIdx.y, g = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int labels = 1 << p.rbits;
  const int r0 = g << p.rbits, rows = min(labels, n - r0);
  // the bucket's segment in each chunk, and the edges of lower buckets (its base)
  int len = 0, below = 0;
  if (threadIdx.x < p.chunks) {
    const int2 seg =
        __ldg(reinterpret_cast<const int2*>(counts) + ((long long)b * p.chunks + threadIdx.x) * p.groups + g);
    below = seg.x;
    len = seg.y;
    seg_from[threadIdx.x] = threadIdx.x * p.chunk + below;
  }
  int t_count, base;
  const int at_c = block_exclusive_scan<LIST_WARPS>(len, warp_part, t_count);
  block_exclusive_scan<LIST_WARPS>(below, warp_part, base);
  if (threadIdx.x < p.chunks) seg_at[threadIdx.x] = at_c;
  if (threadIdx.x == 0) seg_at[p.chunks] = t_count;
  int* mine = hist + warp * labels;
  for (int t = threadIdx.x; t < LIST_WARPS * labels; t += LIST_THREADS) hist[t] = 0;
  __syncthreads();
  const int lo = (int)((long long)t_count * warp / LIST_WARPS);
  const int hi = (int)((long long)t_count * (warp + 1) / LIST_WARPS);
  const int* pb = packed + (long long)b * e_count;
  int* lb = lists + (long long)b * e_count;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t0 = lo; t0 < hi; t0 += 32 * LIST_STEPS) {
      const int steps = min(LIST_STEPS, (hi - t0 + 31) / 32);  // the same for the whole warp
      int word[LIST_STEPS];
#pragma unroll
      for (int u = 0; u < LIST_STEPS; ++u) {  // the bucket's t-th edge: its chunk by binary search
        const int t = t0 + u * 32 + lane;
        word[u] = -1;
        if (t < hi) {
          int lo_c = 0, hi_c = p.chunks;  // seg_at[lo_c] <= t < seg_at[hi_c]
          while (hi_c - lo_c > 1) {
            const int mid = (lo_c + hi_c) / 2;
            if (seg_at[mid] <= t) lo_c = mid; else hi_c = mid;
          }
          word[u] = __ldg(pb + seg_from[lo_c] + (t - seg_at[lo_c]));
        }
      }
#pragma unroll
      for (int u = 0; u < LIST_STEPS; ++u) {
        if (u == steps) break;
        const bool ok = word[u] >= 0;
        const int rel = ok ? word[u] >> EDGE_BITS : 0;
        if (pass == 0)
          group_step<false>(mine, ok, rel, p.rbits, [](int) {});
        else
          group_step<true>(mine, ok, rel, p.rbits,
                           [&](int at) { lb[at] = (word[u] & ((1 << EDGE_BITS) - 1)) / k; });
      }
    }
    if (pass == 0) {
      __syncthreads();
      int count, total;
      const int first = starts_from_counts<LIST_WARPS>(hist, labels, base, warp_part, count, total);
      int* ob = offsets + (long long)b * (n + 1) + r0;
      if (threadIdx.x < rows) ob[threadIdx.x] = first;
      if (g == p.groups - 1 && threadIdx.x == 0) ob[rows] = base + total;
    }
  }
}

__device__ __forceinline__ void add_to(float& s, float v) { s = __fadd_rn(s, v); }
__device__ __forceinline__ void add_to(float4& s, const float4& v) {
  s.x = __fadd_rn(s.x, v.x);
  s.y = __fadd_rn(s.y, v.y);
  s.z = __fadd_rn(s.z, v.z);
  s.w = __fadd_rn(s.w, v.w);
}
__device__ __forceinline__ void set_zero(float& s) { s = 0.f; }
__device__ __forceinline__ void set_zero(float4& s) { s = make_float4(0.f, 0.f, 0.f, 0.f); }

// gather: dx[b, r, ch] = the list's g rows summed in order from 0.0, plain
// fp32 adds; T is float or float4, cv = C / width(T)
template <typename T>
__global__ void scatter_gather_kernel(const T* __restrict__ g, const int* __restrict__ offsets,
                                      const int* __restrict__ lists, T* __restrict__ dx, int m, int n, int cv,
                                      int e_count, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / cv;  // b * n + r
  const int ch = (int)(t - row * cv);
  const long long b = row / n;
  const int* o = offsets + row + b;  // offsets[b][r], the sample's n + 1 entries
  const int* lb = lists + b * e_count;
  const T* gb = g + b * m * cv + ch;
  const int p1 = __ldg(o + 1);
  T s;
  set_zero(s);
#pragma unroll 4
  for (int q = __ldg(o); q < p1; ++q) add_to(s, __ldg(gb + (long long)__ldg(lb + q) * cv));
  dx[t] = s;
}

template <typename T>
void scatter_rows(const T* g, const int* idx, T* dx, int* scratch, int b, int m, int n, int cv, int k,
                  cudaStream_t stream) {
  const int e_count = m * k;
  const ScatterPlan p = scatter_plan(n, e_count);
  int* packed = scratch;
  int* lists = packed + (long long)b * e_count;
  int* offsets = lists + (long long)b * e_count;
  int* counts = offsets + ((long long)b * (n + 1) + 1) / 2 * 2;  // int2 pairs: 8-byte aligned
  const long long total = (long long)b * n * cv;
  scatter_partition_kernel<<<dim3(p.chunks, b), PART_THREADS, 0, stream>>>(idx, packed, counts, e_count, n, p);
  scatter_lists_kernel<<<dim3(p.groups, b), LIST_THREADS, 0, stream>>>(packed, counts, offsets, lists, e_count, n,
                                                                       k, p);
  scatter_gather_kernel<T><<<grid_for(total), THREADS, 0, stream>>>(g, offsets, lists, dx, m, n, cv, e_count, total);
}

// ---- the slot scatter: dx[b, r, c] = the sum, in ascending centre i from
// 0.0, of g[b, i, c] over the i with idx[b, i, slot[b, i, c]] = r ----
//
// A block owns dx[b, r0:r1, c0:c0+S] in shared memory, column by column
// (`held`, S columns of rows_pad floats), has 16 / S warps a channel (512
// threads), and walks all of the sample's centres in chunks (256 centres at
// S = 16, 512 below):
//   staging: each thread takes (centre, 4 channels) units of the chunk: it
//     loads their 4 slots and g float4 with coalesced reads two chunks
//     ahead, the 4 winning rows idx[b, i, slot] one chunk ahead (L1 hits:
//     the row of k indices is read by the slice's S / 4 units), and stores
//     rows and g column by column into one of two staging buffers;
//   adding: lane L of a channel's first warp owns the held rows r0 + key
//     with key % 64 == L (key % 32 at S = 16, one warp a channel), of the
//     second warp key % 64 == 32 + L: no two lanes ever add onto one row, so
//     the adds need no conflict test and no barrier between them, and a
//     warp's adds hit 32 distinct banks.  The channel's warps sort its
//     column of the chunk by key % 64, stably, into 64 lists in place (each
//     warp a share of the batches of 32 centres: 7 ballots a batch; then
//     the counts exchanged through shared memory, a scan over the lanes, and
//     each term placed at its list's start plus the earlier terms of its
//     list), and each owning lane walks its list in ascending i, reading a
//     term's held value one step before it adds (the previous sum forwarded
//     where both terms are one row).  Lanes as centres instead, grouping
//     equal rows with __match_any_sync or an owner byte a row, spent most
//     of the kernel in those tests.  Every add is __fadd_rn onto the held
//     value, one term at a time, so each (row, channel) gets its terms in
//     ascending i, from 0.0.
// What it costs: every block reads its sample's slots and g of its slice
// and looks up the winning rows in idx, so idx rows are read once a slice
// (and a row range); below 16 channels that is the largest stream, and with
// the sort's latency it keeps the kernel at a few times its bound.
// A slice's staged columns and held rows are padded so that the staging
// stores, the column reads and the final float4 reads hit distinct banks.
constexpr int SLOT_CHUNK = 256;      // centres a staged chunk a walking warp
constexpr int SLOT_MAX_RANGES = 8;   // row ranges a slice at most: re-reads of g, slots and idx
constexpr int SLOT_MAX_SMEM = 232448;  // shared memory a block can use on an H100 (227 KB)

struct SlotScatterPlan {
  int s;       // channels a slice, 0 when the shape is not covered
  int ranges;  // row ranges per (sample, slice)
  int rows;    // rows a range (a multiple of 8; the last range may be shorter)
  int smem;    // dynamic shared memory of a block, bytes
};

// warps a channel, 512 threads a block: they split the channel's sort by
// batches, and the first two its walk by row % 64
__host__ __device__ constexpr int slot_parts(int s) { return 16 / s; }
__host__ __device__ constexpr int slot_chunk(int s) { return SLOT_CHUNK * (s == 16 ? 1 : 2); }

int slot_col(int s) { return slot_chunk(s) + 32 / s; }
int slot_rows_pad(int rows, int s) { return (rows + 7) / 8 * 8 + 32 / s; }
// the held slice, two staging buffers of winning rows (int32) and g (fp32),
// and the sort's counts (an int a lane of each warp)
int slot_staging(int s) { return 16 * s * slot_col(s) + 128 * s * slot_parts(s); }
int slot_smem(int rows, int s) { return 4 * s * slot_rows_pad(rows, s) + slot_staging(s); }
int slot_max_rows(int s) { return ((SLOT_MAX_SMEM - slot_staging(s)) / (4 * s) - 32 / s) / 8 * 8; }

// s = 0 chooses the width (else 4, 8 or 16), ranges = 0 the fewest that fit
// (else at least that many): the widest slice whose blocks fill three
// quarters of the SMs, else the narrowest that fits (the most blocks).  A
// block walks all of its sample's centres whatever its rows, so more ranges
// add work where narrower slices do not
SlotScatterPlan slot_scatter_plan(int b, int n, int f, int s, int ranges, int sms) {
  const SlotScatterPlan none{0, 0, 0, 0};
  const auto plan = [&](int w) {
    if (f % w != 0) return none;
    const int least = (n + slot_max_rows(w) - 1) / slot_max_rows(w);
    const int r = ranges == 0 ? least : ranges;
    if (r < least || r > SLOT_MAX_RANGES) return none;
    const int rows = ((n + r - 1) / r + 7) / 8 * 8;
    return SlotScatterPlan{w, r, rows, slot_smem(rows, w)};
  };
  if (b < 1 || b > 65535 || n < 1 || f < 4 || f % 4 != 0 || ranges < 0) return none;
  if (s != 0) return s == 4 || s == 8 || s == 16 ? plan(s) : none;
  SlotScatterPlan last = none;
  for (int w = 16; w >= 4; w /= 2) {
    const SlotScatterPlan p = plan(w);
    if (p.s == 0) continue;
    last = p;
    if (4LL * b * (f / w) * p.ranges >= 3LL * sms) return p;
  }
  return last;
}

struct SlotScatterArgs {
  const float* g;
  const int* idx;
  const uint8_t* slot;
  float* dx;
  int m, n, f, k, rows, rows_pad;
};

// grid (F / S, ranges, B), 32 * S * slot_parts(S) threads, slot_smem(rows, S) bytes
template <int S>
__global__ void __launch_bounds__(32 * S * slot_parts(S)) slot_scatter_kernel(const __grid_constant__ SlotScatterArgs a) {
  constexpr int W = slot_parts(S);                         // warps a channel
  constexpr int kHalves = W > 1 ? 2 : 1;                   // lists by row % (32 kHalves), a warp's walk a half
  constexpr int kThreads = 32 * S * W;
  constexpr int kQuads = S / 4;                            // float4 columns of the slice
  constexpr int kChunk = slot_chunk(S);                    // centres a staged chunk
  constexpr int kCol = kChunk + 32 / S;                    // a staged column, padded
  constexpr int kUnits = kChunk * kQuads / kThreads;       // (centre, quad) units a thread stages: 1 or 2
  constexpr int kBatches = kChunk / 32 / W;                // batches of 32 centres a warp sorts a chunk: 4 or 8
  extern __shared__ __align__(16) float smem_f[];
  float* held = smem_f;                                             // [S][rows_pad]
  int* rows_s = reinterpret_cast<int*>(held + S * a.rows_pad);      // [2][S][kCol]
  float* g_s = reinterpret_cast<float*>(rows_s + 2 * S * kCol);     // [2][S][kCol]
  int* counts_s = reinterpret_cast<int*>(g_s + 2 * S * kCol);       // [S][W][32]
  const int c0 = blockIdx.x * S;
  const int r0 = blockIdx.y * a.rows, r1 = min(a.n, r0 + a.rows);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int channel = warp / W, part = warp % W;

  const long long centre0 = (long long)blockIdx.z * a.m;
  const int chunks = (a.m + kChunk - 1) / kChunk;
  unsigned sl[kUnits];  // a unit's 4 slots, a byte each
  float4 gv[kUnits];
  int rr[kUnits][4];    // a unit's 4 winning rows, -1 past the last centre
  // unit u = threadIdx.x + kThreads * h: centre u / kQuads of the chunk, channels c0 + 4 * (u % kQuads)
  const auto load = [&](int chunk) {
#pragma unroll
    for (int h = 0; h < kUnits; ++h) {
      const int u = threadIdx.x + kThreads * h;
      const int i = chunk * kChunk + u / kQuads;
      const long long at = (centre0 + i) * a.f + c0 + 4 * (u % kQuads);
      sl[h] = i < a.m ? __ldg(reinterpret_cast<const unsigned*>(a.slot + at)) : 0u;
      gv[h] = i < a.m ? __ldg(reinterpret_cast<const float4*>(a.g + at)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const auto lookup = [&](int chunk) {
#pragma unroll
    for (int h = 0; h < kUnits; ++h) {
      const int i = chunk * kChunk + (threadIdx.x + kThreads * h) / kQuads;
      const int* row = a.idx + (centre0 + i) * a.k;
#pragma unroll
      for (int j = 0; j < 4; ++j) rr[h][j] = i < a.m ? __ldg(row + ((sl[h] >> (8 * j)) & 255u)) : -1;
    }
  };
  const auto stage = [&](int buf, const float4 (&v)[kUnits]) {
#pragma unroll
    for (int h = 0; h < kUnits; ++h) {
      const int u = threadIdx.x + kThreads * h;
      const int at = (buf * S + 4 * (u % kQuads)) * kCol + u / kQuads;
      rows_s[at] = rr[h][0];
      rows_s[at + kCol] = rr[h][1];
      rows_s[at + 2 * kCol] = rr[h][2];
      rows_s[at + 3 * kCol] = rr[h][3];
      g_s[at] = v[h].x;
      g_s[at + kCol] = v[h].y;
      g_s[at + 2 * kCol] = v[h].z;
      g_s[at + 3 * kCol] = v[h].w;
    }
  };
  float* held_col = held + channel * a.rows_pad;
  const unsigned lower = (1u << lane) - 1u;
  // The channel's terms of a chunk are sorted, stably, into 32 * kHalves
  // lists by key % (32 kHalves), key = r - r0 the held row, each list in
  // ascending i; warp `part` of the channel sorts batches [part * kBatches,
  // +kBatches), and the first kHalves warps walk the lists part * 32 + L,
  // lane L one.  A lane's count of its list of half h sits at bit 16 h of a
  // packed word.
  const auto add = [&](int buf) {
    int* rc = rows_s + (buf * S + channel) * kCol;  // this channel's column of the chunk
    float* gc = g_s + (buf * S + channel) * kCol;
    int key[kBatches];
    float val[kBatches];
    unsigned own[kBatches], upper[kBatches];
    int counts = 0;
#pragma unroll
    for (int t = 0; t < kBatches; ++t) {
      const int at = (part * kBatches + t) * 32 + lane;
      const int r = rc[at];
      val[t] = gc[at];
      key[t] = r >= r0 && r < r1 ? r - r0 : -1;
      unsigned m = __ballot_sync(FULL_MASK, key[t] >= 0);  // own[t]: the batch's lanes of key % 32 == lane
#pragma unroll
      for (int bit = 0; bit < 5; ++bit) {
        const unsigned set = __ballot_sync(FULL_MASK, (key[t] >> bit) & 1);
        m &= (lane >> bit) & 1 ? set : ~set;
      }
      own[t] = m;
      upper[t] = kHalves == 2 ? __ballot_sync(FULL_MASK, (key[t] >> 5) & 1) : 0u;
      counts += __popc(m & ~upper[t]) | __popc(m & upper[t]) << 16;
    }
    counts_s[(channel * W + part) * 32 + lane] = counts;
    __syncthreads();  // every warp has read its batches and counted them
    int total = 0, before = 0;  // the lane's lists: all the channel's terms, and those of earlier parts
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const int c = counts_s[(channel * W + q) * 32 + lane];
      total += c;
      before += q < part ? c : 0;
    }
    int start = total;  // the lists' starts: a scan over the lanes, the upper lists after all the lower
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL_MASK, start, o);
      if (lane >= o) start += u;
    }
    start += (__shfl_sync(FULL_MASK, start, 31) & 0xffff) << 16;
    start -= total;
    int at = start + before;  // where this part's next term of each of the lane's lists goes
#pragma unroll
    for (int t = 0; t < kBatches; ++t) {
      const int d = key[t] & 31;
      const bool up = (key[t] >> 5) & 1 && kHalves == 2;
      const int base = __shfl_sync(FULL_MASK, at, d);
      const unsigned group = __shfl_sync(FULL_MASK, own[t], d) & (up ? upper[t] : ~upper[t]);
      if (key[t] >= 0) {
        const int pos = (up ? base >> 16 : base & 0xffff) + __popc(group & lower);
        rc[pos] = key[t];
        gc[pos] = val[t];
      }
      at += __popc(own[t] & ~upper[t]) | __popc(own[t] & upper[t]) << 16;
    }
    __syncthreads();  // the channel's lists are written
    // the lane's list, one term a step: term j + 1's held value is read
    // before term j's sum is stored (and replaced by it where both are one
    // row), term j + 2's row and value a step earlier still
    const int first = part ? start >> 16 : start & 0xffff;
    const int count = part >= kHalves ? 0 : part ? total >> 16 : total & 0xffff;
    const int end = first + count;
    int k0 = count > 0 ? rc[first] : 0;
    float g0 = count > 0 ? gc[first] : 0.f;
    int k1 = count > 1 ? rc[first + 1] : k0;
    float g1 = count > 1 ? gc[first + 1] : 0.f;
    float h0 = held_col[k0];
    const int steps = __reduce_max_sync(FULL_MASK, count);
    for (int j = first; j < first + steps; ++j) {
      const bool live = j < end, ahead = j + 2 < end;
      const float h1 = held_col[k1];
      const int k2 = ahead ? rc[j + 2] : k1;
      const float g2 = ahead ? gc[j + 2] : 0.f;
      const float sum = __fadd_rn(h0, g0);
      if (live) held_col[k0] = sum;
      h0 = k1 == k0 ? sum : h1;
      k0 = k1;
      g0 = g1;
      k1 = k2;
      g1 = g2;
    }
  };

  load(0);
  for (int t = threadIdx.x; t < S * a.rows_pad / 4; t += kThreads)
    reinterpret_cast<float4*>(held)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  lookup(0);
  float4 first[kUnits];
#pragma unroll
  for (int h = 0; h < kUnits; ++h) first[h] = gv[h];
  if (chunks > 1) load(1);
  stage(0, first);
  __syncthreads();  // held is zeroed and chunk 0 staged
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const bool more = chunk + 1 < chunks;  // the same for the whole block
    float4 next[kUnits];
#pragma unroll
    for (int h = 0; h < kUnits; ++h) next[h] = gv[h];
    if (more) lookup(chunk + 1);
    if (chunk + 2 < chunks) load(chunk + 2);
    add(chunk & 1);
    if (more) stage((chunk + 1) & 1, next);
    __syncthreads();
  }
  for (int t = threadIdx.x; t < (r1 - r0) * kQuads; t += kThreads) {
    const int row = t / kQuads, q = t % kQuads;
    const float* h = held + 4 * q * a.rows_pad + row;
    reinterpret_cast<float4*>(a.dx + ((long long)blockIdx.z * a.n + r0 + row) * a.f + c0)[q] =
        make_float4(h[0], h[a.rows_pad], h[2 * a.rows_pad], h[3 * a.rows_pad]);
  }
}

template <int S>
int launch_slot_scatter(const SlotScatterPlan& p, const SlotScatterArgs& a, int b, cudaStream_t stream) {
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)slot_scatter_kernel<S>, SLOT_MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  slot_scatter_kernel<S><<<dim3(a.f / S, p.ranges, b), 32 * S * slot_parts(S), p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int slot_scatter(const float* g, const int* idx, const uint8_t* slot, float* dx, int b, int m, int n, int f, int k,
                 int slice_width, int ranges, cudaStream_t stream) {
  const SlotScatterPlan p = slot_scatter_plan(b, n, f, slice_width, ranges, pccf::device_sms());
  if (p.s == 0 || m < 1 || k < 1 || k > 255 || !aligned16(g) || !aligned16(dx) ||
      reinterpret_cast<uintptr_t>(slot) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const SlotScatterArgs a{g, idx, slot, dx, m, n, f, k, p.rows, slot_rows_pad(p.rows, p.s)};
  switch (p.s) {
    case 16: return launch_slot_scatter<16>(p, a, b, stream);
    case 8: return launch_slot_scatter<8>(p, a, b, stream);
    default: return launch_slot_scatter<4>(p, a, b, stream);
  }
}

// an empty kernel, one warp: the launch floor a short kernel such as the
// gather is read against
__global__ void empty_kernel() {}

}  // namespace

extern "C" int pccf_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

// x (B, N, C), idx (B, N, k) -> out (B, N, k, C); any C >= 1
extern "C" int pccf_gather_neighbors(const float* x, const int* idx, float* out, int b, int n, int c, int k,
                                     cudaStream_t stream) {
  if (b < 1 || n < 1 || c < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (c % 4 == 0 && aligned16(x) && aligned16(out)) {
    const long long total = (long long)b * n * k * (c / 4);
    gather_kernel<float4><<<grid_for(total), THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(x), idx, reinterpret_cast<float4*>(out), n, k, c / 4, total);
  } else {
    const long long total = (long long)b * n * k * c;
    gather_kernel<float><<<grid_for(total), THREADS, 0, stream>>>(x, idx, out, n, k, c, total);
  }
  return (int)cudaGetLastError();
}

// int32 scratch that pccf_scatter_add_rows needs for (B, M, k) into n rows, or
// -1 past what it covers (n <= 65536, M * k < 2^23)
extern "C" int pccf_scatter_add_rows_scratch(int b, int m, int n, int k) {
  if (b < 1 || m < 1 || n < 1 || k < 1 || b > 65535 || n > (MAX_GROUPS << MAX_RBITS) ||
      (long long)m * k >= (1LL << EDGE_BITS))
    return -1;
  const int e_count = m * k;
  const ScatterPlan p = scatter_plan(n, e_count);
  const long long words = (long long)b * (2LL * e_count + n + 1) + 1 + 2LL * b * p.chunks * p.groups;
  return words > INT_MAX ? -1 : (int)words;
}

// g (B, M, C), idx (B, M, k) into rows of dx (B, N, C), every row written;
// scratch: pccf_scatter_add_rows_scratch(B, M, N, k) int32
extern "C" int pccf_scatter_add_rows(const float* g, const int* idx, float* dx, int* scratch, int b, int m, int n,
                                     int c, int k, cudaStream_t stream) {
  if (pccf_scatter_add_rows_scratch(b, m, n, k) < 0 || c < 1 || (long long)m * c > INT_MAX ||
      (long long)n * c > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (c % 4 == 0 && aligned16(g) && aligned16(dx))
    scatter_rows(reinterpret_cast<const float4*>(g), idx, reinterpret_cast<float4*>(dx), scratch, b, m, n, c / 4, k,
                 stream);
  else
    scatter_rows(g, idx, dx, scratch, b, m, n, c, k, stream);
  return (int)cudaGetLastError();
}

// x (B, N, F), idx (B, N, k) -> out (B, N, F) float, slot (B, N, F) uint8, the
// first slot attaining the max by strict >; F % 4 == 0, k <= 255, N <= 13951
// (the pools' slice plan, slice_pool.cuh)
extern "C" int pccf_graph_max_pool_src(const float* x, const int* idx, float* out, uint8_t* slot, int b, int n,
                                       int f, int k, cudaStream_t stream) {
  if (k > 255 || reinterpret_cast<uintptr_t>(slot) % 4 != 0) return (int)cudaErrorInvalidValue;
  return pccf::slice_pool<pccf::PoolMaxSlot>(x, idx, out, b, n, f, k, 0, stream, slot);
}

// g (B, M, F), idx (B, M, k), slot (B, M, F) into dx (B, N, F), every element
// written: each (row, channel) the sum of its terms in ascending centre from
// 0.0; F % 4 == 0, k <= 255, N <= SLOT_MAX_RANGES * slot_max_rows(4) = 98496
extern "C" int pccf_scatter_add_slots(const float* g, const int* idx, const uint8_t* slot, float* dx, int b, int m,
                                      int n, int f, int k, cudaStream_t stream) {
  return slot_scatter(g, idx, slot, dx, b, m, n, f, k, 0, 0, stream);
}

// pccf_scatter_add_slots in slices of slice_width channels (0: the plan's)
// and `ranges` row ranges (0: the fewest that fit), to time the others
extern "C" int pccf_scatter_add_slots_split(const float* g, const int* idx, const uint8_t* slot, float* dx, int b,
                                            int m, int n, int f, int k, int slice_width, int ranges,
                                            cudaStream_t stream) {
  return slot_scatter(g, idx, slot, dx, b, m, n, f, k, slice_width, ranges, stream);
}

// the slot scatter's plan for (B, N, F) on the current device: plan[0] the
// slice width, plan[1] the row ranges, plan[2] the rows a range, plan[3] the
// shared memory of a block; cudaErrorInvalidValue where none covers the shape
extern "C" int pccf_slot_scatter_plan(int b, int n, int f, int slice_width, int ranges, int* plan) {
  const SlotScatterPlan p = slot_scatter_plan(b, n, f, slice_width, ranges, pccf::device_sms());
  plan[0] = p.s;
  plan[1] = p.ranges;
  plan[2] = p.rows;
  plan[3] = p.smem;
  return p.s == 0 ? (int)cudaErrorInvalidValue : 0;
}

// x (B, N, C), idx (B, N, k) -> out (B, N, C), each row the sum of its k
// neighbour rows in slot order; C % 4 == 0, N <= 13951; slice_width 0 takes
// the plan's (slice_pool.cuh)
extern "C" int pccf_graph_sum_pool(const float* x, const int* idx, float* out, int b, int n, int c, int k,
                                   int slice_width, cudaStream_t stream) {
  return pccf::slice_pool<pccf::PoolSum>(x, idx, out, b, n, c, k, slice_width, stream);
}
