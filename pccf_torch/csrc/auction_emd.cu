// Auction EMD on Hopper: an exact assignment of each point of x1 to a point
// of x2 by a compacted Jacobi auction, every round of a cloud in one launch,
// on a thread-block cluster while many rows bid and on one block for the
// long tail.
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
// What bounds it: instruction throughput while many rows bid (a bid sweeps
// all M items, ~14 instructions a pair: a distance without FMA, the
// benefit's subtraction, a compare and the running best and second), and
// the latency of a round's barriers once few do: the rounds depend on each
// other, and the eval contract runs thousands of rounds of a few bidders.
//
// Design: one launch; a cloud is a cluster of C blocks of 1024 threads
// (auction_plan: C up to 16, each block owning at least kMinItems items,
// halved while the card cannot hold every cloud's cluster at once, as
// cudaOccupancyMaxActiveClusters counts them: an H100 holds 7 of 16, 15 of
// 8).  Block r owns items [r Mi, (r + 1) Mi) (coordinates and
// price as one float4, the 64-bit bid key, the owner) and rows
// [r Nr, (r + 1) Nr) (the assignment), in its shared memory while a block's
// share fits there, else in global scratch of the call (the same layout,
// read through the same generic pointers).  Two facts of the algorithm
// shape the rounds:
//  - the unassigned count never rises (each item that receives bids takes
//    one winner, who was unassigned, and evicts at most one owner), so once
//    every unassigned row bids (total <= k) it stays so;
//  - bidder slots are filled in ascending row order, so "the lowest slot on
//    a tie" is "the lowest row": the bid key carries the row, and the
//    bidders may be listed in any order.
// A cluster round: each block has listed its bidders (while total > k, the
// ordered compaction of its own rows' unassigned flags; after that, the
// losers and evicted owners of its items' bids, with no scan of the rows)
// and stored its count into every block (a list holds k rows: up to k bids
// can land on one block's items, each listing one loser or evicted owner at
// most); a cluster barrier; every block gathers the first min(total, k)
// listed rows; each block sweeps its own items for every bidder (a
// power-of-two group of lanes a bidder, merged by shuffles: the max, the
// lowest index on a tie, a second best that keeps a tied best) and stores
// the partial (best, second, j, price of j) into the shared memory of the
// bidder's handler block (slot s mod C); a barrier;
// the handler merges the C partials the same way and stores the bid, a
// 64-bit key (the bid's ordered bits, then the inverted row) and the item,
// into its slot of the inbox of the block that owns j* (64-bit atomicMax on
// another block's shared memory, through a mapped pointer or as
// red.shared::cluster.max.u64, left wrong maxima on the H100; 32-bit
// atomics and stores there were right); a barrier; each block takes the max
// key of each of its items over its inbox with its own shared-memory atomics
// (the highest bid and the lowest row, whatever the order), gives the items
// to the winners (owner, price; the assignments, in the rows' blocks, by
// remote stores) and lists the losers and the evicted owners.  Cluster
// barriers (barrier.cluster arrive.release / wait.acquire) separate every
// step where blocks share state: three a round, four while the compaction
// runs (its scan must see the evictions).  Every remote access but the
// gather is a store.
// Once fewer than plan.tail rows are left (total <= k), the leader block
// gathers every item and row into its own shared memory (~66 KB at 2048
// points) and runs the rounds alone, after a last cluster barrier that keeps
// the other blocks' memory alive until it has read it: the bidders are an
// explicit list of at most 31, each swept by a power of two of warps; warp 0
// merges the warps' partials by shuffles, bids, resolves the ties through
// shared atomics and writes the next list (losers and evicted rows) with a
// ballot: two block barriers a round.  Where the gathered state does not fit
// beside the cluster's, the tail stays on the cluster.  The epilogue (dis,
// near: the row's minimum, the lowest index on a tie, where it is
// unassigned) reads x2 itself.  Every operation on a float is the plain
// version's (pccf_torch/kernels/auction_emd.py: the same squared distances,
// __fsub_rn / __fadd_rn), so the outputs equal the plain version's bit for
// bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "device_attr.cuh"
#include "pair_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kAuctionThreads = 1024;
constexpr int kAuctionWarps = kAuctionThreads / 32;
constexpr float kNeg = -1e30f;  // auction_emd.py:43
// the state's dynamic shared memory at most: the opt-in 227 KB less room for
// the static arrays
constexpr int kAuctionMaxSmem = 232448 - 1024;
constexpr int kMaxCluster = 16;  // blocks a cloud at most (non-portable past 8)
constexpr int kClusterSizes = 5;  // 1, 2, 4, 8, 16 blocks
constexpr int kMinItems = 64;    // items a block owns at least
constexpr int kTailBidders = 32;  // bidders below which one block runs the rounds: fewer than a warp's lanes

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) / 16 * 16; }

struct AuctionPlan {
  int cluster;  // blocks a cloud
  int items;    // items a block owns
  int rows;     // rows a block owns
  int handled;  // bidder slots a block handles at most (slot s: block s mod cluster)
  int shared;   // 1: the state in shared memory, 0: in global scratch
  int tail;     // bidders below which one block runs the rounds (0: never)
  int smem;     // dynamic shared memory a block
  int region;   // bytes of a block's cluster state
};

// byte offsets of a block's cluster state
struct Layout {
  long long items, keys, owner, assign, list, counts, bidders, partials, inbox, count, size;
};

__host__ __device__ __forceinline__ Layout layout(const AuctionPlan& p, int k) {
  Layout l;
  long long o = 0;
  l.items = o;
  o += align16(16LL * p.items);
  l.keys = o;
  o += align16(8LL * p.items);
  l.owner = o;
  o += align16(4LL * p.items);
  l.assign = o;
  o += align16(4LL * p.rows);
  l.list = o;  // k rows: its own first k unassigned rows, or the losers and evicted owners of the bids on its items
  o += align16(4LL * k);
  l.counts = o;  // each block's list count, pushed by that block
  o += align16(4LL * kMaxCluster);
  l.bidders = o;
  o += align16(4LL * k);
  l.partials = o;  // the handled slots' partials, one from each block
  o += 16LL * p.handled * p.cluster;
  l.inbox = o;  // the bids on this block's items, one slot for each (handler, handled slot): key, item
  o += 16LL * p.handled * p.cluster;
  l.count = o;  // this block's list count as it is built
  o += 16;
  l.size = o;
  return l;
}

// byte offsets of the leader's tail state, after its cluster state
struct TailLayout {
  long long items, keys, owner, assign, list, part, size;
};

__host__ __device__ __forceinline__ TailLayout tail_layout(int n, int m) {
  TailLayout t;
  long long o = 0;
  t.items = o;
  o += align16(16LL * m);
  t.keys = o;
  o += align16(8LL * m);
  t.owner = o;
  o += align16(4LL * m);
  t.assign = o;
  o += align16(4LL * n);
  t.list = o;  // two lists of kTailBidders (x, y, z, row)
  o += 2LL * kTailBidders * 16;
  t.part = o;  // a warp's partial
  o += 16LL * kAuctionWarps;
  t.size = o;
  return t;
}

__host__ __forceinline__ AuctionPlan plan_for(int n, int m, int k, int c) {
  AuctionPlan p{};
  p.cluster = c;
  p.items = (m + c - 1) / c;
  p.rows = (n + c - 1) / c;
  p.handled = (k + c - 1) / c;
  const long long region = layout(p, k).size, tail = tail_layout(n, m).size;
  p.region = (int)region;
  p.shared = region <= kAuctionMaxSmem;
  p.tail = p.shared && region + tail <= kAuctionMaxSmem ? kTailBidders : 0;
  p.smem = p.shared ? (int)(region + (p.tail ? tail : 0)) : 0;
  return p;
}

// the largest cluster up to kMaxCluster that leaves each block kMinItems
// items and of which the card holds all b at once (resident[i]: clusters of
// 1 << i blocks), halved while it holds fewer but not out of shared memory:
// one wave of smaller clusters beats waves of larger ones
__host__ __forceinline__ AuctionPlan auction_plan(int b, int n, int m, int k, const int* resident) {
  int c = kMaxCluster, log_c = kClusterSizes - 1;
  while (c > 1 && m < c * kMinItems) {
    c >>= 1;
    --log_c;
  }
  AuctionPlan p = plan_for(n, m, k, c);
  while (c > 1 && b > resident[log_c]) {
    const AuctionPlan half = plan_for(n, m, k, c >> 1);
    if (p.shared && !half.shared) break;
    p = half;
    c >>= 1;
    --log_c;
  }
  return p;
}

// a float's bits in an order that compares as the floats do (-0 below +0;
// a benefit -d2 - price is never +0) and back
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// the bid's ordered bits, then the inverted row: the max is the highest bid,
// the lowest row on a tie
__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  return ((unsigned long long)ordered_bits(bid) << 32) | (unsigned)(0xffffffffu - (unsigned)row);
}

__device__ __forceinline__ int key_row(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
}

__device__ __forceinline__ float key_bid(unsigned long long key) { return from_ordered((unsigned)(key >> 32)); }

// one benefit into a running (best, its index, second), without branches:
// the first strict max in the order of the calls, a second best that keeps a
// tied best
__device__ __forceinline__ void take(float v, int j, float& best, int& best_j, float& second) {
  const bool above = v > best;
  second = fmaxf(second, above ? best : v);
  best_j = above ? j : best_j;
  best = above ? v : best;
}

// two partials (best, second, index, price of the index) into one: the max,
// the lowest index on a tie, the second best over both, independent of order
__device__ __forceinline__ void merge(float& best, float& second, int& best_j, float& price, float ob, float os,
                                      int oj, float op) {
  const bool other = ob > best || (ob == best && oj < best_j);
  second = fmaxf(fmaxf(second, os), other ? best : ob);
  best = other ? ob : best;
  best_j = other ? oj : best_j;
  price = other ? op : price;
}

// merge across aligned groups of `width` lanes (a power of two up to 32);
// every lane of a group ends with the group's partial (its price too with
// kPrice)
template <bool kPrice>
__device__ __forceinline__ void merge_lanes(float& best, float& second, int& best_j, float& price, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o), os = __shfl_xor_sync(FULL, second, o);
    const float op = kPrice ? __shfl_xor_sync(FULL, price, o) : 0.f;
    const int oj = __shfl_xor_sync(FULL, best_j, o);
    merge(best, second, best_j, price, ob, os, oj, op);
  }
}

// the whole warp's partial, what merge_lanes gives at width 32, by three
// reductions: the max, the lowest index at it, and the max of every lane's
// second and every other lane's best
__device__ __forceinline__ void merge_warp(float& best, float& second, int& best_j) {
  const unsigned ob = ordered_bits(best), top = __reduce_max_sync(FULL, ob);
  const unsigned j = __reduce_min_sync(FULL, ob == top ? (unsigned)best_j : 0xffffffffu);
  const bool first = ob == top && (unsigned)best_j == j;
  second = from_ordered(__reduce_max_sync(FULL, ordered_bits(first ? second : fmaxf(second, best))));
  best = from_ordered(top);
  best_j = (int)j;
}

// the block whose list holds bidder s (the last whose list starts at or
// before s: the lists follow each other in block order) and where its list
// starts, from the blocks' counts
__device__ __forceinline__ int list_of(const int* counts, int c, int s, int& first) {
  int r = 0, at_q = 0;
  first = 0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    if (q < c && at_q <= s) {
      r = q;
      first = at_q;
    }
    at_q += q < c ? counts[q] : 0;
  }
  return r;
}

__device__ __forceinline__ unsigned long long inbox_key(uint4 in) { return ((unsigned long long)in.y << 32) | in.x; }

template <typename T>
__device__ __forceinline__ T* at(unsigned char* const* bases, int rank, long long offset) {
  return reinterpret_cast<T*>(bases[rank] + offset);
}

template <bool kShared>
__global__ void __launch_bounds__(kAuctionThreads, 1)
    auction_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int n, int m, int k, float eps,
                   int iters, AuctionPlan plan, float* __restrict__ dis, int* __restrict__ assignment_out,
                   int* __restrict__ near_out, int* __restrict__ counts_out, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned char* bases[kMaxCluster];  // each block's state, as a generic pointer
  __shared__ int warp_base[kAuctionWarps];
  __shared__ int tail_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = plan.cluster, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long cloud = blockIdx.x / c;
  const Layout lay = layout(plan, k);
  unsigned char* own = kShared ? smem : scratch + (cloud * c + rank) * lay.size;
  if (tid < c)
    bases[tid] = kShared ? cluster.map_shared_rank(smem, (unsigned)tid) : scratch + (cloud * c + tid) * lay.size;
  float4* items = reinterpret_cast<float4*>(own + lay.items);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(own + lay.keys);
  int* owner = reinterpret_cast<int*>(own + lay.owner);
  int* assign = reinterpret_cast<int*>(own + lay.assign);
  int* list = reinterpret_cast<int*>(own + lay.list);
  const int* counts = reinterpret_cast<const int*>(own + lay.counts);
  int* bidders = reinterpret_cast<int*>(own + lay.bidders);
  float4* partials = reinterpret_cast<float4*>(own + lay.partials);
  uint4* inbox = reinterpret_cast<uint4*>(own + lay.inbox);
  int* count = reinterpret_cast<int*>(own + lay.count);
  const int mi = plan.items, nr = plan.rows, kc = plan.handled;
  const int j0 = rank * mi, i0 = rank * nr;
  const int my_items = max(0, min(mi, m - j0)), my_rows = max(0, min(nr, n - i0));
  const float* p1 = x1 + cloud * n * 3;
  const float* p2 = x2 + cloud * m * 3;

  for (int jl = tid; jl < my_items; jl += kAuctionThreads) {
    const int j = j0 + jl;
    items[jl] = make_float4(p2[3LL * j], p2[3LL * j + 1], p2[3LL * j + 2], 0.f);
    keys[jl] = 0ull;
    owner[jl] = -1;
  }
  for (int il = tid; il < my_rows; il += kAuctionThreads) assign[il] = -1;
  for (int e = tid; e < kc * c; e += kAuctionThreads) inbox[e] = make_uint4(0u, 0u, 0u, 0u);
  cluster.sync();  // every block of the cluster runs: its memory may be written from here on

  // this block's list count into every block's counts
  auto publish = [&]() {
    if (tid < c) at<int>(bases, tid, lay.counts)[rank] = *count;
  };
  // this block's unassigned rows in ascending order (the first k of
  // them) and their count: a block-wide exclusive scan over contiguous chunks
  auto compact = [&]() {
    const int chunk = (my_rows + kAuctionThreads - 1) / kAuctionThreads;
    const int lo = min(my_rows, tid * chunk), hi = min(my_rows, lo + chunk);
    int cnt = 0;
    for (int il = lo; il < hi; ++il) cnt += assign[il] < 0;
    int incl = cnt;
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
      if (lane == 31) *count = wi;
    }
    __syncthreads();
    int pos = warp_base[warp] + incl - cnt;
    for (int il = lo; il < hi && pos < k; ++il)
      if (assign[il] < 0) list[pos++] = i0 + il;
    publish();
  };
  compact();

  int round = 0, bids = 0, total = 0;
  bool tail = false;
  for (; round < iters; ++round) {
    cluster.sync();  // the lists, counts and assignments of the round before
    total = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) total += q < c ? counts[q] : 0;
    if (total == 0) break;  // the same on every thread of the cluster: the cloud is assigned
    // every unassigned row bids: the next round's bidders are this round's losers and evicted rows
    const bool listed = total <= k;
    if (kShared && listed && total < plan.tail) {
      tail = true;
      break;
    }
    const int active = min(total, k);
    bids += active;
    for (int s = tid; s < active; s += kAuctionThreads) {
      int first;
      const int r = list_of(counts, c, s, first);
      bidders[s] = at<int>(bases, r, lay.list)[s - first];
    }
    __syncthreads();

    // sweep this block's items for every bidder, a group of lanes a bidder
    int lanes = 32;
    while (lanes > 1 && active * lanes > kAuctionThreads) lanes >>= 1;
    const int groups = kAuctionThreads / lanes, g = tid / lanes, gl = tid & (lanes - 1);
    for (int s0 = 0; s0 < active; s0 += groups) {
      const int s = s0 + g;
      float best = -INFINITY, second = kNeg, price = 0.f;
      int best_j = INT_MAX;
      if (s < active) {
        const int i = bidders[s];
        const float ax = p1[3LL * i], ay = p1[3LL * i + 1], az = p1[3LL * i + 2];
        for (int jl = gl; jl < my_items; jl += lanes) {
          const float4 it = items[jl];
          take(__fsub_rn(-sqdist(ax, ay, az, it.x, it.y, it.z), it.w), jl, best, best_j, second);
        }
      }
      merge_lanes<false>(best, second, best_j, price, lanes);
      if (gl == 0 && s < active) {
        const bool any = best_j != INT_MAX;
        at<float4>(bases, s % c, lay.partials)[(s / c) * c + rank] =
            make_float4(best, second, __int_as_float(any ? j0 + best_j : INT_MAX), any ? items[best_j].w : 0.f);
      }
    }
    cluster.sync();  // every partial in its handler

    if (listed && tid == 0) *count = 0;  // the next list is built from here on
    const int handled = active > rank ? (active - rank + c - 1) / c : 0;
    for (int q = tid; q - lane < handled * c; q += kAuctionThreads) {
      const int t = q / c;
      float4 pt = q < handled * c ? partials[q] : make_float4(-INFINITY, kNeg, __int_as_float(INT_MAX), 0.f);
      float best = pt.x, second = pt.y, price = pt.w;
      int best_j = __float_as_int(pt.z);
      merge_lanes<true>(best, second, best_j, price, c);
      if (q % c == 0 && t < handled) {
        // the bid into its slot of the inbox of the block that owns j* (a 64-bit max on another block's
        // shared memory left wrong maxima on the card; this block's own atomics take the max)
        const float bid = __fadd_rn(price, __fadd_rn(__fsub_rn(best, second), eps));
        const unsigned long long key = bid_key(bid, bidders[rank + c * t]);
        const int home = best_j / mi;
        at<uint4>(bases, home, lay.inbox)[rank * kc + t] =
            make_uint4((unsigned)key, (unsigned)(key >> 32), (unsigned)(best_j - home * mi), 0u);
      }
    }
    cluster.sync();  // every bid in its item's inbox

    // each item takes its best bid (a max in this block's shared memory), evicting its owner; the losers
    // and the evicted owners are the next round's bidders once every unassigned row bids
    for (int e = tid; e < kc * c; e += kAuctionThreads) {
      const uint4 in = inbox[e];
      if (in.x | in.y) atomicMax(&keys[in.z], inbox_key(in));
    }
    __syncthreads();
    for (int e = tid; e < kc * c; e += kAuctionThreads) {
      const uint4 in = inbox[e];
      if (!(in.x | in.y)) continue;
      const unsigned long long key = inbox_key(in);
      const int jl = (int)in.z;
      if (keys[jl] == key) {
        const int w = key_row(key), o = owner[jl];
        owner[jl] = w;
        items[jl].w = key_bid(key);
        at<int>(bases, w / nr, lay.assign)[w % nr] = j0 + jl;
        if (o >= 0) {
          at<int>(bases, o / nr, lay.assign)[o % nr] = -1;
          if (listed) list[atomicAdd(count, 1)] = o;
        }
      } else if (listed) {
        list[atomicAdd(count, 1)] = key_row(key);  // lost: bids again
      }
    }
    __syncthreads();
    for (int e = tid; e < kc * c; e += kAuctionThreads) {
      const uint4 in = inbox[e];
      if (in.x | in.y) {
        keys[in.z] = 0ull;
        inbox[e] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (listed) {
      publish();
    } else {
      cluster.sync();  // the evictions visible to the compaction
      compact();
    }
  }

  if (!tail) {
    cluster.sync();  // the last round's assignments; no block reads another's memory after this
    // dis: d2 to the assigned item, or the row's minimum (the lowest index on a tie); a warp a row
    for (int il = warp; il < my_rows; il += kAuctionWarps) {
      const int i = i0 + il, a = assign[il];
      const float ax = p1[3LL * i], ay = p1[3LL * i + 1], az = p1[3LL * i + 2];
      float best = INFINITY;
      int best_j = INT_MAX;
      if (a >= 0) {
        best = sqdist(ax, ay, az, p2[3LL * a], p2[3LL * a + 1], p2[3LL * a + 2]);
        best_j = a;
      } else {
        for (int j = lane; j < m; j += 32) {
          const float d = sqdist(ax, ay, az, p2[3LL * j], p2[3LL * j + 1], p2[3LL * j + 2]);
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
        assignment_out[cloud * n + i] = a;
      }
    }
    if (rank == 0 && tid == 0) {
      counts_out[2 * cloud] = round;
      counts_out[2 * cloud + 1] = bids;
    }
    return;
  }

  // the tail: the leader gathers the cloud's state and runs the rounds alone
  const TailLayout tl = tail_layout(n, m);
  unsigned char* const tbase = smem + lay.size;
  float4* titems = reinterpret_cast<float4*>(tbase + tl.items);
  unsigned long long* tkeys = reinterpret_cast<unsigned long long*>(tbase + tl.keys);
  int* towner = reinterpret_cast<int*>(tbase + tl.owner);
  int* tassign = reinterpret_cast<int*>(tbase + tl.assign);
  float4* tlist = reinterpret_cast<float4*>(tbase + tl.list);
  float4* tpart = reinterpret_cast<float4*>(tbase + tl.part);
  if (rank == 0) {
    for (int j = tid; j < m; j += kAuctionThreads) {
      titems[j] = at<float4>(bases, j / mi, lay.items)[j % mi];
      towner[j] = at<int>(bases, j / mi, lay.owner)[j % mi];
      tkeys[j] = 0ull;
    }
    for (int i = tid; i < n; i += kAuctionThreads) tassign[i] = at<int>(bases, i / nr, lay.assign)[i % nr];
    for (int s = tid; s < total; s += kAuctionThreads) {
      int first;
      const int r = list_of(counts, c, s, first);
      const int i = at<int>(bases, r, lay.list)[s - first];
      tlist[s] = make_float4(p1[3LL * i], p1[3LL * i + 1], p1[3LL * i + 2], __int_as_float(i));
    }
    if (tid == 0) tail_count = total;
  }
  cluster.sync();  // the other blocks leave once the leader has read their memory
  if (rank != 0) return;

  int cur = 0;
  for (; round < iters; ++round) {
    const int nb = tail_count;
    if (nb == 0) break;
    bids += nb;
    // a power of two of warps a bidder, each over a contiguous share of the items
    int per = kAuctionWarps, shift = 5;
    while (per * nb > kAuctionWarps) {
      per >>= 1;
      --shift;
    }
    const int s = warp >> shift, part = warp & (per - 1);
    if (s < nb) {
      const float4 b = tlist[cur * kTailBidders + s];
      const int lo = (m * part) >> shift, hi = (m * (part + 1)) >> shift;  // m * 32 < 2^31
      float best = -INFINITY, second = kNeg;
      int best_j = INT_MAX;
      for (int j = lo + lane; j < hi; j += 32) {
        const float4 it = titems[j];
        take(__fsub_rn(-sqdist(b.x, b.y, b.z, it.x, it.y, it.z), it.w), j, best, best_j, second);
      }
      merge_warp(best, second, best_j);
      if (lane == 0)
        tpart[warp] = make_float4(best, second, __int_as_float(best_j), best_j != INT_MAX ? titems[best_j].w : 0.f);
    }
    __syncthreads();
    if (warp == 0) {
      // lane w holds warp w's partial; the first lane of each group of per lanes merges its bidder's
      const float4 pt = lane < nb * per ? tpart[lane] : make_float4(-INFINITY, kNeg, __int_as_float(INT_MAX), 0.f);
      float best = pt.x, second = pt.y, price = pt.w;
      int best_j = __float_as_int(pt.z);
      merge_lanes<true>(best, second, best_j, price, per);
      const bool bidder = (lane & (per - 1)) == 0 && lane < nb * per;
      int row = -1, next = -1;
      float bid = 0.f;
      unsigned long long key = 0ull;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (bidder) {
        b = tlist[cur * kTailBidders + lane / per];
        row = __float_as_int(b.w);
        bid = __fadd_rn(price, __fadd_rn(__fsub_rn(best, second), eps));
        key = bid_key(bid, row);
        atomicMax(&tkeys[best_j], key);
      }
      __syncwarp();
      const bool won = bidder && tkeys[best_j] == key;
      __syncwarp();
      if (won) {
        const int o = towner[best_j];
        towner[best_j] = row;
        tassign[row] = best_j;
        titems[best_j].w = bid;
        tkeys[best_j] = 0ull;
        if (o >= 0) tassign[o] = -1;
        next = o;  // the evicted owner bids next round
      } else if (bidder) {
        next = row;  // lost: bids again
      }
      const unsigned keep = __ballot_sync(FULL, next >= 0);
      if (next >= 0) {
        const int pos = __popc(keep & ((1u << lane) - 1u));
        tlist[(cur ^ 1) * kTailBidders + pos] =
            won ? make_float4(p1[3LL * next], p1[3LL * next + 1], p1[3LL * next + 2], __int_as_float(next)) : b;
      }
      if (lane == 0) tail_count = __popc(keep);
    }
    cur ^= 1;
    __syncthreads();
  }

  for (int i = warp; i < n; i += kAuctionWarps) {
    const int a = tassign[i];
    const float ax = p1[3LL * i], ay = p1[3LL * i + 1], az = p1[3LL * i + 2];
    float best = INFINITY;
    int best_j = INT_MAX;
    if (a >= 0) {
      const float4 it = titems[a];
      best = sqdist(ax, ay, az, it.x, it.y, it.z);
      best_j = a;
    } else {
      for (int j = lane; j < m; j += 32) {
        const float4 it = titems[j];
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
      assignment_out[cloud * n + i] = a;
    }
  }
  if (tid == 0) {
    counts_out[2 * cloud] = round;
    counts_out[2 * cloud + 1] = bids;
  }
}

// the kernel of a plan with its attributes set on the current device, and
// its launch configuration for b clouds
template <bool kShared>
cudaError_t prepare(const AuctionPlan& p, int b, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                    cudaLaunchAttribute& attr) {
  static FuncAttr<cudaFuncAttributeNonPortableClusterSizeAllowed> non_portable;  // clusters past 8 blocks
  static MaxSmem max_smem;
  const void* kernel = (const void*)auction_kernel<kShared>;
  cudaError_t err = non_portable(kernel, 1);
  if (err == cudaSuccess && kShared) err = max_smem(kernel, kAuctionMaxSmem);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3((unsigned)b * p.cluster);
  cfg.blockDim = dim3(kAuctionThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

bool valid(int b, int n, int m, int k) {
  return b >= 1 && (long long)b * kMaxCluster <= INT_MAX && n >= 1 && m >= n && m <= (1 << 24) && k >= 1 && k <= n;
}

// clusters of 1 << i blocks the current card holds at once (out[i], i <
// kClusterSizes), from cudaOccupancyMaxActiveClusters at the most shared
// memory a plan asks for: a block of 1024 threads of more than 32 registers
// takes a whole SM whatever its shared memory, so the counts are the card's
// (its SMs and how they group), the same for every plan; queried once a card
cudaError_t resident(int* out) {
  static constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices][kClusterSizes] = {};  // the count + 1, 0 until queried
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  for (int i = 0; i < kClusterSizes; ++i) {
    out[i] = known[dev][i].load(std::memory_order_relaxed) - 1;
    if (out[i] >= 0) continue;
    AuctionPlan p{};
    p.cluster = 1 << i;
    p.smem = kAuctionMaxSmem;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = prepare<true>(p, 1, nullptr, cfg, attr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&out[i], auction_kernel<true>, &cfg);
    if (err != cudaSuccess) return err;
    known[dev][i].store(out[i] + 1, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

cudaError_t plan_here(int b, int n, int m, int k, AuctionPlan& p) {
  int counts[kClusterSizes];
  const cudaError_t err = resident(counts);
  if (err == cudaSuccess) p = auction_plan(b, n, m, k, counts);
  return err;
}

}  // namespace

// the plan of the auction of b clouds on the current card
// (pccf_torch.kernels.auction_emd.plan with pccf_auction_resident's counts):
// out = cluster, items a block, rows a block, bidder slots a block handles,
// shared (1) or global (0), the tail's bidders (0: no tail),
// dynamic shared memory a block, bytes of a block's cluster state
extern "C" int pccf_auction_plan(int b, int n, int m, int k, int* out) {
  if (!valid(b, n, m, k) || out == nullptr) return (int)cudaErrorInvalidValue;
  AuctionPlan p;
  const cudaError_t err = plan_here(b, n, m, k, p);
  if (err != cudaSuccess) return (int)err;
  const int fields[8] = {p.cluster, p.items, p.rows, p.handled, p.shared, p.tail, p.smem, p.region};
  for (int f = 0; f < 8; ++f) out[f] = fields[f];
  return 0;
}

// clusters of 1, 2, 4, 8 and 16 blocks the current card holds at once
extern "C" int pccf_auction_resident(int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident(out);
}

// x1 (B, N, 3), x2 (B, M, 3) float32, 1 <= N <= M, 1 <= k <= N, iters >= 0 ->
// dis (B, N), assignment (B, N) int32, near (B, N) int32 (the index dis was
// taken at), counts (B, 2) int32 (the rounds each cloud bid in, its bids).
// scratch: B x cluster x region bytes of the plan, 16-byte aligned, where the
// plan's state is in global memory (else unread)
extern "C" int pccf_auction_emd(const float* x1, const float* x2, int b, int n, int m, int k, float eps, int iters,
                                float* dis, int* assignment, int* near, int* counts, void* scratch,
                                cudaStream_t stream) {
  if (!valid(b, n, m, k) || iters < 0) return (int)cudaErrorInvalidValue;
  AuctionPlan p;
  cudaError_t err = plan_here(b, n, m, k, p);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (p.shared) {
    err = prepare<true>(p, b, stream, cfg, attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, auction_kernel<true>, x1, x2, n, m, k, eps, iters, p, dis, assignment, near,
                               counts, (unsigned char*)nullptr);
  } else {
    if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0) return (int)cudaErrorInvalidValue;
    err = prepare<false>(p, b, stream, cfg, attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, auction_kernel<false>, x1, x2, n, m, k, eps, iters, p, dis, assignment, near,
                               counts, static_cast<unsigned char*>(scratch));
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
