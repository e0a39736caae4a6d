// Max over gathered neighbours on Hopper (forward only).
//
// Replaces pccf/kernels/pallas_gather.py:218 graph_max_pool_tpu (forward
// _pool_forward:80).  out[b, n, c] = max_j x[b, idx[b, n, j], c].
//
// What bounds it: bytes.  It reads k rows of F floats per point
// (16*2048*25*256*4 B = 838.9 MB at the widest encoder block) and writes one
// row.
//
// Design: the resident-slice pool of slice_pool.cuh: a block copies one
// channel slice of a sample into shared memory once by TMA and reduces its
// centres' rows from there.  Max is exact, so the result is bit-identical to
// the plain version: the first neighbour seeds the maximum, ties keep the
// earlier value, and NaN propagates as in torch.amax.

#include "slice_pool.cuh"

// x (B, N, F), idx (B, N, k) -> out (B, N, F); F % 4 == 0, N <= 13951;
// slice_width 0 takes the plan's (slice_plan)
extern "C" int pccf_graph_max_pool(const float* x, const int* idx, float* out, int b, int n, int f, int k,
                                   int slice_width, cudaStream_t stream) {
  return pccf::slice_pool<pccf::PoolMax>(x, idx, out, b, n, f, k, slice_width, stream);
}

// the plan of both pools for (B, N, C) on the current device: plan[0] the
// slice width, plan[1] the centre ranges, plan[2] the shared memory of a block;
// cudaErrorInvalidValue where no slice covers the shape
extern "C" int pccf_pool_plan(int b, int n, int c, int slice_width, int* plan) {
  const pccf::SlicePlan p = pccf::slice_plan(b, n, c, slice_width, pccf::device_sms());
  plan[0] = p.s;
  plan[1] = p.ranges;
  plan[2] = p.smem;
  return p.s == 0 ? (int)cudaErrorInvalidValue : 0;
}
