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
// What bounds them: bytes and, for the scatters, atomics.  Every forward
// reads k rows per centre (mostly L2 hits: each row is read by ~k centres)
// and writes one row (pools) or k rows (gather).  The TPU kernels keep the
// (N, C) operand resident in VMEM and accumulate the scatters in place across
// grid steps that run in order; blocks on the card run in parallel and in no
// order, so the scatters add with fp32 atomicAdd into an output zeroed first.
// The order of those adds changes from run to run: a scatter's result
// differs from the plain version's by fp32 rounding (a few ulp of the sum),
// never by a lost or doubled term.
//
// Design: one thread per output element, or per 4 channels (one 16-byte
// load per neighbour) where C % 4 == 0, so a warp covers consecutive
// channels of one row and every access is coalesced.  The pool's slot output
// is uint8 (k <= 255), a quarter of the int32 slots of the TPU kernel: it is
// written once and read once per training step.  The max keeps the earliest
// slot on ties (strict >, pallas_gather.py:111), so the forward is
// bit-identical to graph_max_pool.cu wherever no NaN occurs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// dx[b, idx[b, i, j], c] += g[b, i, c] for every j
__global__ void scatter_add_rows_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                                        float* __restrict__ dx, int m, int n, int c, int k, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / c;  // flat (b, i)
  const int ch = (int)(t - row * c);
  const long long b = row / m;
  const float v = g[t];
  const int* nb = idx + row * k;
  float* base = dx + b * n * c + ch;
  for (int j = 0; j < k; ++j) atomicAdd(base + (long long)__ldg(nb + j) * c, v);
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

// g (B, M, C), idx (B, M, k) into rows of dx (B, N, C), which is zeroed first
extern "C" int pccf_scatter_add_rows(const float* g, const int* idx, float* dx, int b, int m, int n, int c, int k,
                                     cudaStream_t stream) {
  if (b < 1 || m < 1 || n < 1 || c < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(dx, 0, sizeof(float) * (size_t)b * n * c, stream);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)b * m * c;
  scatter_add_rows_kernel<<<grid_for(total), THREADS, 0, stream>>>(g, idx, dx, m, n, c, k, total);
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
