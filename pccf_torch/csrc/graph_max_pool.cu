// Max over gathered neighbours on Hopper (forward only).
//
// Replaces pccf/kernels/pallas_gather.py:218 graph_max_pool_tpu (forward
// _pool_forward:80).  out[b, n, c] = max_j x[b, idx[b, n, j], c].
//
// What bounds it: bytes.  It reads k rows of F floats per point
// (16*2048*25*256*4 B = 838 MB at the widest encoder block, mostly L2 hits
// because each row is read by ~k centres) and writes one row.
//
// Design: one thread per (point, 4-channel group); each loads 16 bytes per
// neighbour, so a warp covers 128 consecutive channels of a row and every
// load is a full 512-byte coalesced segment.  The k indices of a point are
// the same for all threads of the point (a broadcast read).  Max is exact,
// so the result is bit-identical to the plain version; the first neighbour
// seeds the maximum, and NaN propagates as in torch.amax.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// running max m against a new value v: the earlier value stays on ties, a NaN
// on either side wins
__device__ __forceinline__ float fmax_nan(float m, float v) { return (v > m || v != v) ? v : m; }

__global__ void graph_max_pool_kernel(const float4* __restrict__ x, const int* __restrict__ idx,
                                      float4* __restrict__ out, int n, int f4, int k, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c4 = (int)(t % f4);
  const long long point = t / f4;  // b * n + i
  const long long b = point / n;
  const int* nb = idx + point * k;
  const float4* xb = x + b * n * f4;
  float4 m = __ldg(xb + (long long)__ldg(nb) * f4 + c4);
  for (int j = 1; j < k; ++j) {
    const float4 v = __ldg(xb + (long long)__ldg(nb + j) * f4 + c4);
    m.x = fmax_nan(m.x, v.x);
    m.y = fmax_nan(m.y, v.y);
    m.z = fmax_nan(m.z, v.z);
    m.w = fmax_nan(m.w, v.w);
  }
  out[t] = m;
}

}  // namespace

extern "C" int pccf_graph_max_pool(const float* x, const int* idx, float* out, int b, int n, int f, int k,
                                   cudaStream_t stream) {
  if (f % 4 != 0 || k < 1 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int f4 = f / 4;
  const long long total = (long long)b * n * f4;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  graph_max_pool_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), idx, reinterpret_cast<float4*>(out), n, f4, k, total);
  return (int)cudaGetLastError();
}
