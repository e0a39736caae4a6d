// Auction EMD on Hopper: an exact assignment of each point of x1 to a point
// of x2 by a compacted Jacobi auction, every round of a cloud in one block.
//
// Replaces pccf/kernels/auction_emd.py:46 auction_emd, which JAX runs as
// dense XLA ops inside lax.while_loop (:142), not as a pallas_call; the
// reference's own auction is CUDA (external/emd).  Each round the first k
// unassigned rows (by index) bid: a bidder's benefit of item j is
// -d2(i, j) - price[j]; it bids on its best item j* (the lowest index on a
// tie) the price of j* plus (best - second) + eps, where second is the best
// benefit of the other items (-1e30 when there is none).  Each item takes its
// highest bid (the lowest bidder slot on a tie), evicting its previous owner.
// The loop stops when every row is assigned or after iters rounds; dis is
// d2 to the assigned item, or the row's minimum where it is unassigned.
//
// What bounds it: instruction throughput.  A bid sweeps all M items (a
// distance without FMA: 3 subtractions, 3 multiplies, 2 adds; the benefit's
// subtraction; a compare and the running best and second), ~14 instructions
// a pair; the bids of one round are k x M pairs, and the rounds depend on
// each other.  JAX's while_loop tests its stop condition on the device; a
// loop of PyTorch launches would read any(assignment < 0) on the host every
// round, up to 10000 rounds at the eval contract (bench.py:421).
//
// Design: one launch, one block of 1024 threads a cloud, every round in the
// block with no host synchronisation.  A cloud that is fully assigned has no
// bidder and places no bid, so each cloud stopping on its own gives what
// JAX's loop over the batch gives.  The state lives in shared memory while it
// fits (auction_bytes: 72 KB at 2048 points), else in global scratch of the
// call (the same layout; the items, 256 KB at 16384 points, stay in L2):
// each item's coordinates and price as one float4, its best bid's key and
// owner, each row's assignment, each bidder slot's row, item and bid.  A
// round: a block-wide prefix scan over the unassigned flags compacts the
// first k bidders; a warp a bidder sweeps the items (the lanes split them,
// each keeping its best, index and second, and shuffles merge them: the max
// does not depend on the order, the lowest index wins a tie); lane 0 posts
// the bid as a 64-bit key (the bid's ordered bits, then the inverted slot)
// with atomicMax into the item's key, so the highest bid and the lowest slot
// win whatever the order of the atomics; each bidder reads its item's key,
// the winners evict the previous owners, then, after a barrier, take their
// items and prices and clear the keys.  Every operation on a float is the
// plain version's (pccf_torch/kernels/auction_emd.py: the same squared
// distances, __fsub_rn / __fadd_rn), so the assignment is the plain
// version's bit for bit.  One block a cloud uses one SM at batch 1: a
// thread-block cluster a cloud is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"
#include "pair_sweep.cuh"

namespace {

constexpr int kAuctionThreads = 1024;
constexpr int kAuctionWarps = kAuctionThreads / 32;
constexpr float kNeg = -1e30f;  // auction_emd.py:43
// the state's dynamic shared memory at most: the opt-in 227 KB less room for
// the static arrays
constexpr int kAuctionMaxSmem = 232448 - 1024;

// bytes of one cloud's state; with shared, the assignment too
__host__ __device__ __forceinline__ long long auction_bytes(int n, int m, int k, bool shared) {
  const long long size = 28LL * m + 12LL * k + (shared ? 4LL * n : 0);
  return (size + 15) / 16 * 16;
}

__host__ __forceinline__ int auction_smem(int n, int m, int k) {
  const long long size = auction_bytes(n, m, k, true);
  return size <= kAuctionMaxSmem ? (int)size : 0;
}

// the bid's float bits in an order that compares as the floats do, then the
// inverted slot: the max is the highest bid, the lowest slot on a tie
__device__ __forceinline__ unsigned long long bid_key(float bid, int slot) {
  const unsigned u = __float_as_uint(bid);
  const unsigned ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ordered << 32) | (unsigned)(0xffffffffu - (unsigned)slot);
}

template <bool kShared>
__global__ void __launch_bounds__(kAuctionThreads)
    auction_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int n, int m, int k, float eps,
                   int iters, float* __restrict__ dis, int* __restrict__ assignment_out, int* __restrict__ near_out,
                   int* __restrict__ counts_out, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_base[kAuctionWarps];
  __shared__ int unassigned_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long cloud = blockIdx.x;
  unsigned char* base = kShared ? smem : scratch + cloud * auction_bytes(n, m, k, false);
  float4* items = reinterpret_cast<float4*>(base);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base + 16LL * m);
  int* owner = reinterpret_cast<int*>(base + 24LL * m);
  int* assignment = kShared ? owner + m : assignment_out + cloud * n;
  int* rows = kShared ? assignment + n : owner + m;
  int* bid_item = rows + k;
  float* bid_val = reinterpret_cast<float*>(bid_item + k);
  const float* p1 = x1 + cloud * n * 3;
  const float* p2 = x2 + cloud * m * 3;

  for (int j = tid; j < m; j += kAuctionThreads) {
    items[j] = make_float4(p2[3 * j], p2[3 * j + 1], p2[3 * j + 2], 0.f);
    keys[j] = 0ull;
    owner[j] = -1;
  }
  for (int i = tid; i < n; i += kAuctionThreads) assignment[i] = -1;
  __syncthreads();

  const int chunk = (n + kAuctionThreads - 1) / kAuctionThreads;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int round = 0, bids = 0;
  for (; round < iters; ++round) {
    // compact: this thread's rows [lo, hi) in order, a block-wide exclusive scan of their unassigned counts
    int count = 0;
    for (int i = lo; i < hi; ++i) count += assignment[i] < 0;
    int incl = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_base[lane];
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += v;
      }
      warp_base[lane] = wi - w;
      if (lane == 31) unassigned_total = wi;
    }
    __syncthreads();
    const int total = unassigned_total;
    if (total == 0) break;  // the same on every thread: the cloud is assigned
    int pos = warp_base[warp] + incl - count;
    for (int i = lo; i < hi && pos < k; ++i)
      if (assignment[i] < 0) rows[pos++] = i;
    __syncthreads();
    const int active = min(total, k);
    bids += active;

    // bid: a warp a bidder, the lanes splitting the items
    for (int s = warp; s < active; s += kAuctionWarps) {
      const int i = rows[s];
      const float ax = p1[3LL * i], ay = p1[3LL * i + 1], az = p1[3LL * i + 2];
      float best = -INFINITY, second = kNeg;
      int best_j = INT_MAX;
      for (int j = lane; j < m; j += 32) {
        const float4 it = items[j];
        const float v = __fsub_rn(-sqdist(ax, ay, az, it.x, it.y, it.z), it.w);
        if (v > best) {
          second = fmaxf(second, best);
          best = v;
          best_j = j;
        } else if (v > second) {
          second = v;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, o), os = __shfl_xor_sync(FULL, second, o);
        const int oj = __shfl_xor_sync(FULL, best_j, o);
        if (ob > best || (ob == best && oj < best_j)) {
          second = fmaxf(fmaxf(second, os), best);
          best = ob;
          best_j = oj;
        } else {
          second = fmaxf(fmaxf(second, os), ob);
        }
      }
      if (lane == 0) {
        const float bid = __fadd_rn(items[best_j].w, __fadd_rn(__fsub_rn(best, second), eps));
        bid_item[s] = best_j;
        bid_val[s] = bid;
        atomicMax(&keys[best_j], bid_key(bid, s));
      }
    }
    __syncthreads();

    // each item's best bid wins; the winners evict the previous owners, the losers drop out
    for (int s = tid; s < active; s += kAuctionThreads) {
      const int j = bid_item[s];
      if (keys[j] == bid_key(bid_val[s], s)) {
        const int o = owner[j];
        if (o >= 0) assignment[o] = -1;
      } else {
        bid_item[s] = -1;
      }
    }
    __syncthreads();
    // then the winners take their items (an evicted row never bid: the two sets are apart)
    for (int s = tid; s < active; s += kAuctionThreads) {
      const int j = bid_item[s];
      if (j >= 0) {
        const int i = rows[s];
        assignment[i] = j;
        owner[j] = i;
        items[j].w = bid_val[s];
        keys[j] = 0ull;
      }
    }
    __syncthreads();
  }

  // dis: d2 to the assigned item, or the row's minimum (the lowest index on a tie); a warp a row
  for (int i = warp; i < n; i += kAuctionWarps) {
    const int a = assignment[i];
    const float ax = p1[3LL * i], ay = p1[3LL * i + 1], az = p1[3LL * i + 2];
    float best = INFINITY;
    int best_j = INT_MAX;
    if (a >= 0) {
      const float4 it = items[a];
      best = sqdist(ax, ay, az, it.x, it.y, it.z);
      best_j = a;
    } else {
      for (int j = lane; j < m; j += 32) {
        const float4 it = items[j];
        const float d = sqdist(ax, ay, az, it.x, it.y, it.z);
        if (d < best) {
          best = d;
          best_j = j;
        }
      }
      warp_argmin(best, best_j);
    }
    if (lane == 0) {
      dis[cloud * n + i] = best;
      near_out[cloud * n + i] = best_j;
      if (kShared) assignment_out[cloud * n + i] = a;
    }
  }
  if (tid == 0) {
    counts_out[2 * cloud] = round;
    counts_out[2 * cloud + 1] = bids;
  }
}

}  // namespace

// the dynamic shared memory of the kernel for one cloud's state, or 0 when it
// lives in global scratch (pccf_torch.kernels.auction_emd.smem_bytes)
extern "C" int pccf_auction_smem_bytes(int n, int m, int k) { return auction_smem(n, m, k); }

// x1 (B, N, 3), x2 (B, M, 3) float32, 1 <= N <= M, 1 <= k <= N, iters >= 0 ->
// dis (B, N), assignment (B, N) int32, near (B, N) int32 (the index dis was
// taken at), counts (B, 2) int32 (the rounds each cloud bid in, its bids).
// scratch: B x auction_bytes(n, m, k, false) bytes, 16-byte aligned, where
// pccf_auction_smem_bytes is 0 (else unread)
extern "C" int pccf_auction_emd(const float* x1, const float* x2, int b, int n, int m, int k, float eps, int iters,
                                float* dis, int* assignment, int* near, int* counts, void* scratch,
                                cudaStream_t stream) {
  if (b < 1 || n < 1 || m < n || m > (1 << 24) || k < 1 || k > n || iters < 0) return (int)cudaErrorInvalidValue;
  const int smem = auction_smem(n, m, k);
  if (smem > 0) {
    static MaxSmem max_smem;
    const cudaError_t attr = max_smem((const void*)auction_kernel<true>, kAuctionMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    auction_kernel<true><<<b, kAuctionThreads, smem, stream>>>(x1, x2, n, m, k, eps, iters, dis, assignment, near,
                                                               counts, nullptr);
  } else {
    if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0) return (int)cudaErrorInvalidValue;
    auction_kernel<false><<<b, kAuctionThreads, 0, stream>>>(x1, x2, n, m, k, eps, iters, dis, assignment, near,
                                                             counts, static_cast<unsigned char*>(scratch));
  }
  return (int)cudaGetLastError();
}
