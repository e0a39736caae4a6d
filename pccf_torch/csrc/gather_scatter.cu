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
// accumulate the scatters in place across grid steps that run in order;
// blocks on the card run in parallel and in no order.  The slot scatter adds
// with fp32 atomicAdd into an output zeroed first, so its sums change from
// run to run by fp32 rounding (a few ulp of the sum), never by a lost or
// doubled term.
//
// The row scatter is a sum-pool over the transposed graph instead, with no
// atomics: two launches build each sample's reverse adjacency (row offsets,
// and for each row the source centres of its in-edges e = i * k + j in
// ascending e), and a third sums those g rows in list order from 0.0 with
// plain fp32 adds.  Ascending e is the
// order of the TPU kernel's grid and of index_add_ on the CPU, so dx equals the
// plain version run on the CPU bit for bit, on every run.  A row no edge
// reaches is written as zeros; nothing clears dx first.
//
// Design: one thread per output element, or per 4 channels (one 16-byte
// load per neighbour) where C % 4 == 0, so a warp covers consecutive
// channels of one row and every access is coalesced.  The pool's slot output
// is uint8 (k <= 255), a quarter of the int32 slots of the TPU kernel: it is
// written once and read once per training step.  The max keeps the earliest
// slot on ties (strict >, pallas_gather.py:111), so the forward is
// bit-identical to graph_max_pool.cu wherever no NaN occurs.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

__device__ __forceinline__ void take_if_greater(float& m, unsigned char& s, float v, int j) {
  if (v > m) {
    m = v;
    s = (unsigned char)j;
  }
}

// out = max over the k neighbour rows, slot = the first j attaining it
__global__ void pool_src_kernel(const float4* __restrict__ x, const int* __restrict__ idx, float4* __restrict__ out,
                                uchar4* __restrict__ slot, int n, int f4, int k, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c4 = (int)(t % f4);
  const long long point = t / f4;  // b * n + i
  const long long b = point / n;
  const int* nb = idx + point * k;
  const float4* xb = x + b * n * f4;
  float4 m = __ldg(xb + (long long)__ldg(nb) * f4 + c4);
  uchar4 s = make_uchar4(0, 0, 0, 0);
  for (int j = 1; j < k; ++j) {
    const float4 v = __ldg(xb + (long long)__ldg(nb + j) * f4 + c4);
    take_if_greater(m.x, s.x, v.x, j);
    take_if_greater(m.y, s.y, v.y, j);
    take_if_greater(m.z, s.z, v.z, j);
    take_if_greater(m.w, s.w, v.w, j);
  }
  out[t] = m;
  slot[t] = s;
}

// dx[b, idx[b, i, slot[b, i, c]], c] += g[b, i, c]: one atomic per element
__global__ void scatter_add_slots_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                                         const uint8_t* __restrict__ slot, float* __restrict__ dx, int m, int n,
                                         int f, int k, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / f;  // flat (b, i)
  const int ch = (int)(t - row * f);
  const long long b = row / m;
  const int r = __ldg(idx + row * k + slot[t]);
  atomicAdd(dx + (b * n + r) * f + ch, g[t]);
}

// out = sum over the k neighbour rows, added in slot order as the TPU kernel does
__global__ void sum_pool_kernel(const float4* __restrict__ x, const int* __restrict__ idx, float4* __restrict__ out,
                                int n, int c4, int k, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = (int)(t % c4);
  const long long point = t / c4;
  const long long b = point / n;
  const int* nb = idx + point * k;
  const float4* xb = x + b * n * c4;
  float4 s = __ldg(xb + (long long)__ldg(nb) * c4 + ch);
  for (int j = 1; j < k; ++j) {
    const float4 v = __ldg(xb + (long long)__ldg(nb + j) * c4 + ch);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[t] = s;
}

}  // namespace

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

// x (B, N, F), idx (B, N, k) -> out (B, N, F) float, slot (B, N, F) uint8; F % 4 == 0, k <= 255
extern "C" int pccf_graph_max_pool_src(const float* x, const int* idx, float* out, uint8_t* slot, int b, int n,
                                       int f, int k, cudaStream_t stream) {
  if (b < 1 || n < 1 || f % 4 != 0 || f < 4 || k < 1 || k > 255 || !aligned16(x) || !aligned16(out) ||
      reinterpret_cast<uintptr_t>(slot) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * n * (f / 4);
  pool_src_kernel<<<grid_for(total), THREADS, 0, stream>>>(reinterpret_cast<const float4*>(x), idx,
                                                           reinterpret_cast<float4*>(out),
                                                           reinterpret_cast<uchar4*>(slot), n, f / 4, k, total);
  return (int)cudaGetLastError();
}

// g (B, M, F), idx (B, M, k), slot (B, M, F) into dx (B, N, F), which is zeroed first
extern "C" int pccf_scatter_add_slots(const float* g, const int* idx, const uint8_t* slot, float* dx, int b, int m,
                                      int n, int f, int k, cudaStream_t stream) {
  if (b < 1 || m < 1 || n < 1 || f < 1 || k < 1 || k > 255) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(dx, 0, sizeof(float) * (size_t)b * n * f, stream);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)b * m * f;
  scatter_add_slots_kernel<<<grid_for(total), THREADS, 0, stream>>>(g, idx, slot, dx, m, n, f, k, total);
  return (int)cudaGetLastError();
}

// x (B, N, C), idx (B, N, k) -> out (B, N, C); C % 4 == 0
extern "C" int pccf_graph_sum_pool(const float* x, const int* idx, float* out, int b, int n, int c, int k,
                                   cudaStream_t stream) {
  if (b < 1 || n < 1 || c % 4 != 0 || c < 4 || k < 1 || !aligned16(x) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * n * (c / 4);
  sum_pool_kernel<<<grid_for(total), THREADS, 0, stream>>>(reinterpret_cast<const float4*>(x), idx,
                                                           reinterpret_cast<float4*>(out), n, c / 4, k, total);
  return (int)cudaGetLastError();
}
