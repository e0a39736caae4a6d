// Pre-norm transformer stacks on Hopper: a tiled GEMM with a bias / GELU /
// residual epilogue, a LayerNorm, and per-(batch, head) attention.  The
// stack launchers in pccf_torch/kernels/wformer.py launch these in turn on one
// stream, layer by layer; the counterfactual CVAE chain
// (pccf_torch/kernels/cvae.py) runs its three stacks through the same launchers.
//
// Replaces pccf/kernels/pallas_wformer.py:335 wformer_encoder_tpu and :365
// wformer_decoder_tpu (layer bodies _enc_layers / _dec_layers), and with them
// pccf/kernels/pallas_cvae.py:203 cvae_cf_tpu, which is built on those
// bodies: T = 256 code tokens of width d = 512 with 8 heads of 64 at the
// flagship configuration.
//
// What bounds it: the matrix products, 1.21 GFLOP per encoder layer and
// 1.6-1.8 GFLOP per decoder layer per sample (M = B*256 rows, N and K of 512
// to 1536), against the TF32 tensor-core peak; and launch overhead: a layer
// is ~7 launches (~11 for a decoder layer).  The TPU kernel keeps every
// layer's weights and the residual stream in VMEM for the whole stack; a
// block here has 227 KB of shared memory, so the residual stream goes
// through device memory (L2 at these sizes) between launches.  A fused
// persistent stack is later work.
//
// Precision: the chain feeds a VQ argmin whose choices must agree with the
// fp32 plain version, so every product runs as 3xTF32 (x = big + small, both
// TF32; big*big + big*small + small*big with fp32 accumulation), which is
// accurate to about fp32 rounding.  LayerNorm (eps from the caller, 1e-6 as
// flax), softmax and the residual stream are fp32; GELU is the exact erf form.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace pccf;

// ------------------------------------------------------------------ GEMM
// out[M, N] = epilogue(A[M, K] · Wt[N, K]^T): + bias[N], optional exact GELU,
// then + res[(row % res_rows), N].  out may alias res (in-place residual).

constexpr int kTm = 64, kTn = 64, kTk = 32, kLd = kTk + 16;

__device__ __forceinline__ float gelu_exact(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

__global__ void __launch_bounds__(128) gemm_kernel(const float* __restrict__ a, const float* __restrict__ wt,
                                                   const float* __restrict__ bias, const float* res, float* out,
                                                   int M, int N, int K, int res_rows, int gelu) {
  __shared__ __align__(16) float as[kTm * kLd];
  __shared__ __align__(16) float bs[kTn * kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kTm, n0 = blockIdx.x * kTn;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTk) {
    // stage 64x32 tiles of A and Wt: 512 float4 each, 4 per thread
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * 128, r = e >> 3, c4 = (e & 7) * 4;
      *reinterpret_cast<float4*>(as + r * kLd + c4) =
          __ldg(reinterpret_cast<const float4*>(a + (size_t)(m0 + r) * K + k0 + c4));
      *reinterpret_cast<float4*>(bs + r * kLd + c4) =
          __ldg(reinterpret_cast<const float4*>(wt + (size_t)(n0 + r) * K + k0 + c4));
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < kTk; kb += 16) {
      float4 top[2], bot[2], bv[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a_k16(as, kLd, wm + mt * 16, kb, lane, top[mt], bot[mt]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bv[nt] = *reinterpret_cast<const float4*>(bs + (wn + nt * 8 + g) * kLd + kb + 4 * t);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t ab[2][4], asml[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) a_frag_split(top[mt], bot[mt], s, ab[mt], asml[mt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bb[2], bsml[2];
          split_tf32(s ? bv[nt].z : bv[nt].x, bb[0], bsml[0]);
          split_tf32(s ? bv[nt].w : bv[nt].y, bb[1], bsml[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_3xtf32(acc[mt][nt], ab[mt], asml[mt], bb, bsml);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + wm + mt * 16 + g + (i >> 1) * 8;
        const int c = n0 + wn + nt * 8 + 2 * t + (i & 1);
        float v = acc[mt][nt][i];
        if (bias) v += bias[c];
        if (gelu) v = gelu_exact(v);
        if (res) v += res[(size_t)(r % res_rows) * N + c];
        out[(size_t)r * N + c] = v;
      }
}

// -------------------------------------------------------------- LayerNorm
// one warp per row: out = (x − μ) · rsqrt(mean((x − μ)²) + eps) · w + b

__global__ void layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                  const float* __restrict__ b, float* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += xr[c];
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / d;
  float v = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float e = xr[c] - mu;
    v = fmaf(e, e, v);
  }
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float inv = rsqrtf(v / d + eps);
  float* orow = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32) orow[c] = (xr[c] - mu) * inv * w[c] + b[c];
}

// -------------------------------------------------------------- attention
// Block = 64 queries of one (batch, head); 4 warps x 16 queries.  Scores for
// all keys (Tk <= 256) go to shared memory, softmax runs exactly in fp32 per
// row, then P · V.  Head h reads columns h*64 .. h*64+63 of q, k and v.

constexpr int kHd = 64, kQt = 64, kMaxTk = 256, kLdq = kHd + 16;

__global__ void __launch_bounds__(128) attention_kernel(const float* __restrict__ q, int q_stride,
                                                        const float* __restrict__ k, const float* __restrict__ v,
                                                        int kv_stride, float* __restrict__ out, int out_stride,
                                                        int t_q, int t_k, float scale) {
  extern __shared__ float smem[];
  const int lds = t_k + 16;
  float* qs = smem;                      // [64][80]
  float* kv = qs + kQt * kLdq;           // K as [t_k][80], later V^T as [64][t_k + 16]
  float* ss = kv + max(t_k * kLdq, kHd * lds);  // [64][t_k + 16] scores / probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kQt, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + ((size_t)b * t_q + q0) * q_stride + h * kHd;
  const float* kb = k + (size_t)b * t_k * kv_stride + h * kHd;
  const float* vb = v + (size_t)b * t_k * kv_stride + h * kHd;

  for (int e = tid; e < kQt * kHd / 4; e += 128) {
    const int r = e / (kHd / 4), c4 = (e % (kHd / 4)) * 4;
    float4 val = *reinterpret_cast<const float4*>(qb + (size_t)r * q_stride + c4);
    val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    *reinterpret_cast<float4*>(qs + r * kLdq + c4) = val;
  }
  for (int e = tid; e < t_k * kHd / 4; e += 128) {
    const int r = e / (kHd / 4), c4 = (e % (kHd / 4)) * 4;
    *reinterpret_cast<float4*>(kv + r * kLdq + c4) = *reinterpret_cast<const float4*>(kb + (size_t)r * kv_stride + c4);
  }
  __syncthreads();

  // S = (q · scale) K^T for this warp's 16 rows, 64 keys at a time
  const int wr = warp * 16;
  for (int j0 = 0; j0 < t_k; j0 += 64) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kHd; k0 += 16) {
      float4 top, bot;
      load_a_k16(qs, kLdq, wr, k0, lane, top, bot);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t ab[4], asml[4];
        a_frag_split(top, bot, s, ab, asml);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 bv = *reinterpret_cast<const float4*>(kv + (j0 + nt * 8 + g) * kLdq + k0 + 4 * t);
          uint32_t bb[2], bsml[2];
          split_tf32(s ? bv.z : bv.x, bb[0], bsml[0]);
          split_tf32(s ? bv.w : bv.y, bb[1], bsml[1]);
          mma_3xtf32(acc[nt], ab, asml, bb, bsml);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ss[(wr + g + (i >> 1) * 8) * lds + j0 + nt * 8 + 2 * t + (i & 1)] = acc[nt][i];
  }
  __syncwarp();

  // exact softmax per row in fp32
  for (int r = wr; r < wr + 16; ++r) {
    float* sr = ss + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < t_k; c += 32) mx = fmaxf(mx, sr[c]);
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < t_k; c += 32) {
      const float e = expf(sr[c] - mx);
      sr[c] = e;
      sum += e;
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
    for (int c = lane; c < t_k; c += 32) sr[c] *= inv;
  }
  __syncthreads();  // every warp is done with K

  for (int e = tid; e < t_k * kHd; e += 128) {
    const int r = e / kHd, c = e % kHd;
    kv[c * lds + r] = vb[(size_t)r * kv_stride + c];  // V^T
  }
  __syncthreads();

  // O = P · V for this warp's 16 rows, all 64 head columns
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  for (int k0 = 0; k0 < t_k; k0 += 16) {
    float4 top, bot;
    load_a_k16(ss, lds, wr, k0, lane, top, bot);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t ab[4], asml[4];
      a_frag_split(top, bot, s, ab, asml);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 bv = *reinterpret_cast<const float4*>(kv + (nt * 8 + g) * lds + k0 + 4 * t);
        uint32_t bb[2], bsml[2];
        split_tf32(s ? bv.z : bv.x, bb[0], bsml[0]);
        split_tf32(s ? bv.w : bv.y, bb[1], bsml[1]);
        mma_3xtf32(acc[nt], ab, asml, bb, bsml);
      }
    }
  }
  float* ob = out + ((size_t)b * t_q + q0 + wr) * out_stride + h * kHd;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(ob + (size_t)(g + half * 8) * out_stride + nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
}

}  // namespace

extern "C" int pccf_gemm(const float* a, const float* wt, const float* bias, const float* res, float* out, int M,
                         int N, int K, int res_rows, int gelu, cudaStream_t stream) {
  if (M % kTm || N % kTn || K % kTk || (res && res_rows <= 0)) return (int)cudaErrorInvalidValue;
  dim3 grid(N / kTn, M / kTm);
  gemm_kernel<<<grid, 128, 0, stream>>>(a, wt, bias, res, out, M, N, K, res_rows > 0 ? res_rows : M, gelu);
  return (int)cudaGetLastError();
}

extern "C" int pccf_layer_norm(const float* x, const float* w, const float* b, float* out, int rows, int d,
                               float eps, cudaStream_t stream) {
  const int rows_per_block = 8;
  layer_norm_kernel<<<(rows + rows_per_block - 1) / rows_per_block, rows_per_block * 32, 0, stream>>>(
      x, w, b, out, rows, d, eps);
  return (int)cudaGetLastError();
}

extern "C" int pccf_attention(const float* q, int q_stride, const float* k, const float* v, int kv_stride,
                              float* out, int out_stride, int batch, int t_q, int t_k, int n_heads, int head_dim,
                              cudaStream_t stream) {
  if (head_dim != kHd || t_q % kQt || t_k % 64 || t_k > kMaxTk || q_stride % 4 || kv_stride % 4)
    return (int)cudaErrorInvalidValue;
  const int lds = t_k + 16;
  const size_t smem = (size_t)(kQt * kLdq + (t_k * kLdq > kHd * lds ? t_k * kLdq : kHd * lds) + kQt * lds) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(t_q / kQt, n_heads, batch);
  attention_kernel<<<grid, 128, smem, stream>>>(q, q_stride, k, v, kv_stride, out, out_stride, t_q, t_k,
                                                1.f / sqrtf((float)head_dim));
  return (int)cudaGetLastError();
}
