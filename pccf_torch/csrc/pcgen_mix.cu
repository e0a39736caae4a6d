// Fused PCGen eval on Hopper: map head, join, component stacks, heads and
// tempered-softmax mix in one launch.
//
// Replaces pccf/kernels/pallas_pcgen.py:133 pcgen_mix_tpu (body _kernel:82).
// For every point:   x   = w ⊙ hardtanh(m · map_w + map_b)          (D0)
//   per component g: h0  = act(x  · W0[g] + b0[g]) + interleave(x, D1)
//                    h1  = act(h0 · W1[g] + b1[g]) + h0[:D2]
//                    h2  = act(h1 · W2[g] + b2[g]) + h1[:D3]
//                    comp[g] = h2 · head_w[g] + head_b[g]             (3)
//   out = Σ_g softmax((concat_g h2) · att_w + att_b) / τ)[g] · comp[g]
// with BatchNorm folded into W and b by the wrapper.
//
// What bounds it: ~0.69 TFLOP per batch of 16 clouds of 2048 points at the
// flagship widths (D0 = D1 = 1024, D2 = 256, D3 = 16, G = 8), and the
// (G, B, N, 1024) first-layer activations, which an unfused version writes to
// and reads back from device memory (1 GB per batch).  Here nothing but the
// (B, N, 3) result leaves the chip; the weights (21 MB in bf16) are re-read
// from L2 by every block, 32 rows of points per read.
//
// Design: a block owns 32 points of one cloud and 8 warps.  The joined
// latent x stays in shared memory in fp32 for the whole block.  Layers 0 and
// 1 are fused: layer 0 is produced 256 columns at a time, activated, given
// its interleaved residual, parked in shared memory, and immediately
// multiplied into layer 1's accumulators, which live in registers; the first
// chunk's values are also kept in registers as layer 1's residual.  So the
// 1024-wide layer-0 activation never exists whole.  Layer 2 and the
// per-component features follow in shared memory; the heads, the attention
// logits and the softmax mix run in fp32 on the CUDA cores at the end.
//
// Precision: weights are rounded to bf16 by the wrapper (as in the TPU
// kernel), activations enter the tensor cores as TF32 (10-bit mantissa, finer
// than the TPU kernel's bf16), accumulation and the residual stream are
// fp32.  State: the map head, heads and mix are full fp32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace pccf;

constexpr int kRows = 32;      // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;    // layer-0 columns produced per pass (8 warps x 32)
constexpr int kPad = 16;       // row padding: strides = 16 (mod 32) words
constexpr int kMaxG = 16;

__device__ __forceinline__ float act(float v, float slope) { return v >= 0.f ? v : slope * v; }

// B fragments of one 16-wide k block from a bf16 (out, in) weight: row n,
// columns k0 + 4t .. 4t+3, as the two k steps' (b0, b1) pairs.
__device__ __forceinline__ uint2 load_b_bf16(const uint16_t* w, int in, int n, int k0, int lane) {
  return __ldg(reinterpret_cast<const uint2*>(w + (size_t)n * in + k0 + 4 * (lane & 3)));
}

__device__ __forceinline__ void b_frag_bf16(const uint2& v, int s, uint32_t (&b)[2]) {
  const uint32_t word = s ? v.y : v.x;
  b[0] = word << 16;
  b[1] = word & 0xffff0000u;
}

// acc[mt][nt] += A[rows 0..31, k] · B[k, cols n0 + 8 nt .. ], over k in [0, K)
// A: fp32 shared tile (stride lda); B: bf16 (out, in) global weight rows.
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[2][NT][4], const float* a_tile, int lda,
                                          const uint16_t* w, int in, int k_off, int n0, int K, int lane) {
  const int g = lane >> 2;
  uint2 bcur[NT], bnext[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) bcur[nt] = load_b_bf16(w, in, n0 + nt * 8 + g, k_off, lane);
  for (int k0 = 0; k0 < K; k0 += 16) {
    if (k0 + 16 < K) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) bnext[nt] = load_b_bf16(w, in, n0 + nt * 8 + g, k_off + k0 + 16, lane);
    }
    float4 top[2], bot[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) load_a_k16(a_tile, lda, mt * 16, k0, lane, top[mt], bot[mt]);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) a_frag(top[mt], bot[mt], s, a[mt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        b_frag_bf16(bcur[nt], s, b);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], a[mt], b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) bcur[nt] = bnext[nt];
  }
}

struct Params {
  const float* m;       // (B, N, Dm)
  const float* w;       // (B, D0)
  const float* map_wt;  // (Dm, D0)
  const float* map_b;   // (D0)
  const uint16_t* w0;   // (G, D1, D0) bf16
  const float* b0;      // (G, D1)
  const uint16_t* w1;   // (G, D2, D1) bf16
  const float* b1;      // (G, D2)
  const uint16_t* w2;   // (G, D3, D2) bf16
  const float* b2;      // (G, D3)
  const float* head_w;  // (G, 3, D3)
  const float* head_b;  // (G, 3)
  const float* att_w;   // (G, G * D3)
  const float* att_b;   // (G)
  float* out;           // (B, N, 3)
  int n, dm, d0, d1, d2, d3, g_count;
  float inv_tau, slope;
};

__global__ void __launch_bounds__(kThreads, 1) pcgen_mix_kernel(Params p) {
  extern __shared__ float smem[];
  const int lda_x = p.d0 + kPad;
  const int lda_c = kChunk + kPad;
  const int lda_1 = p.d2 + kPad;
  float* xs = smem;                       // [32][d0 + pad]   joined latent
  float* h0c = xs + kRows * lda_x;        // [32][256 + pad]  layer-0 chunk (map input first)
  float* h1s = h0c + kRows * lda_c;       // [32][d2 + pad]   layer-1 output
  float* feats = h1s + kRows * lda_1;     // [G][32][d3]      layer-2 output per component

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long row0 = (long long)blockIdx.x * kRows;  // flattened b * n + i
  const int b = (int)(row0 / p.n);

  // ---- map head + join: xs = w ⊙ hardtanh(m · map_w + map_b) -------------
  float* ms = h0c;  // [32][dm] staged map input (dm <= 256 + pad)
  for (int e = tid; e < kRows * p.dm; e += kThreads) ms[e] = p.m[row0 * p.dm + e];
  __syncthreads();
  for (int j = tid; j < p.d0; j += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < p.dm; ++kk) {
      const float wv = __ldg(p.map_wt + (size_t)kk * p.d0 + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(ms[r * p.dm + kk], wv, acc[r]);
    }
    const float bias = p.map_b[j], scale = p.w[(size_t)b * p.d0 + j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xs[r * lda_x + j] = scale * fminf(fmaxf(acc[r] + bias, -1.f), 1.f);
  }
  __syncthreads();

  const int reps0 = p.d1 / p.d0 + 1;   // interleave_residual(x, d1): column j <- x[j / reps0]
  const bool l1_warp = warp * 32 < p.d2;
  const int l2_tiles = 2 * (p.d3 / 8);

  for (int g = 0; g < p.g_count; ++g) {
    const uint16_t* w0 = p.w0 + (size_t)g * p.d1 * p.d0;
    const uint16_t* w1 = p.w1 + (size_t)g * p.d2 * p.d1;
    const uint16_t* w2 = p.w2 + (size_t)g * p.d3 * p.d2;
    float acc1[2][4][4], res1[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc1[mt][nt][i] = res1[mt][nt][i] = 0.f;

    for (int c0 = 0; c0 < p.d1; c0 += kChunk) {
      // layer 0, columns c0 + warp*32 .. +32 of this chunk
      float acc0[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc0[mt][nt][i] = 0.f;
      warp_gemm<4>(acc0, xs, lda_x, w0, p.d0, 0, c0 + warp * 32, p.d0, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g8 + (i >> 1) * 8;
            const int col = c0 + warp * 32 + nt * 8 + 2 * t4 + (i & 1);
            const float h = act(acc0[mt][nt][i] + p.b0[(size_t)g * p.d1 + col], p.slope) +
                            xs[r * lda_x + col / reps0];
            if (c0 == 0) res1[mt][nt][i] = h;
            h0c[r * lda_c + col - c0] = h;
          }
      __syncthreads();
      // layer 1 partial sums over this chunk's 256 inputs
      if (l1_warp) warp_gemm<4>(acc1, h0c, lda_c, w1, p.d1, c0, warp * 32, kChunk, lane);
      __syncthreads();
    }

    // layer 1 epilogue: activation + residual h0[:, :d2] (chunk 0, same fragment slots)
    if (l1_warp) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g8 + (i >> 1) * 8;
            const int col = warp * 32 + nt * 8 + 2 * t4 + (i & 1);
            h1s[r * lda_1 + col] = act(acc1[mt][nt][i] + p.b1[(size_t)g * p.d2 + col], p.slope) + res1[mt][nt][i];
          }
    }
    __syncthreads();

    // layer 2: one 16x8 output tile per warp
    if (warp < l2_tiles) {
      const int mt = warp & 1, nt = warp >> 1;
      float acc2[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < p.d2; k0 += 16) {
        float4 top, bot;
        load_a_k16(h1s, lda_1, mt * 16, k0, lane, top, bot);
        const uint2 bw = load_b_bf16(w2, p.d2, nt * 8 + g8, k0, lane);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a[4], bb[2];
          a_frag(top, bot, s, a);
          b_frag_bf16(bw, s, bb);
          mma_tf32(acc2, a, bb);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g8 + (i >> 1) * 8;
        const int col = nt * 8 + 2 * t4 + (i & 1);
        feats[(g * kRows + r) * p.d3 + col] =
            act(acc2[i] + p.b2[(size_t)g * p.d3 + col], p.slope) + h1s[r * lda_1 + col];
      }
    }
  }
  __syncthreads();

  // ---- heads, attention logits, tempered softmax, mix (fp32) -----------
  if (tid < kRows) {
    const int r = tid;
    float logits[kMaxG], comp[kMaxG][3];
    for (int gp = 0; gp < p.g_count; ++gp) logits[gp] = p.att_b[gp];
    for (int g = 0; g < p.g_count; ++g) {
      const float* f = feats + (g * kRows + r) * p.d3;
      for (int o = 0; o < 3; ++o) {
        float s = p.head_b[g * 3 + o];
        for (int j = 0; j < p.d3; ++j) s = fmaf(f[j], p.head_w[(g * 3 + o) * p.d3 + j], s);
        comp[g][o] = s;
      }
      for (int gp = 0; gp < p.g_count; ++gp) {
        const float* aw = p.att_w + (size_t)gp * p.g_count * p.d3 + g * p.d3;
        float s = 0.f;
        for (int j = 0; j < p.d3; ++j) s = fmaf(f[j], aw[j], s);
        logits[gp] += s;
      }
    }
    float mx = -INFINITY;
    for (int gp = 0; gp < p.g_count; ++gp) mx = fmaxf(mx, logits[gp] * p.inv_tau);
    float denom = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f;
    for (int gp = 0; gp < p.g_count; ++gp) {
      const float e = expf(logits[gp] * p.inv_tau - mx);
      denom += e;
      o0 = fmaf(e, comp[gp][0], o0);
      o1 = fmaf(e, comp[gp][1], o1);
      o2 = fmaf(e, comp[gp][2], o2);
    }
    float* out = p.out + (row0 + r) * 3;
    out[0] = o0 / denom;
    out[1] = o1 / denom;
    out[2] = o2 / denom;
  }
}

}  // namespace

extern "C" int pccf_pcgen_mix(const float* m, const float* w, const float* map_wt, const float* map_b,
                              const uint16_t* w0, const float* b0, const uint16_t* w1, const float* b1,
                              const uint16_t* w2, const float* b2, const float* head_w, const float* head_b,
                              const float* att_w, const float* att_b, float* out, int batch, int n, int dm,
                              int d0, int d1, int d2, int d3, int g_count, float tau, float slope,
                              cudaStream_t stream) {
  // the layouts this kernel is written for; the wrapper checks them first
  if (n % kRows || d0 % 32 || d1 % kChunk || d2 % 32 || d2 > kChunk || d3 % 8 || d3 > 32 || d3 > d2 ||
      dm > kChunk + kPad || g_count < 1 || g_count > kMaxG)
    return (int)cudaErrorInvalidValue;
  Params p{m, w, map_wt, map_b, w0, b0, w1, b1, w2, b2, head_w, head_b, att_w, att_b, out,
           n, dm, d0, d1, d2, d3, g_count, 1.f / tau, slope};
  const size_t smem =
      (size_t)(kRows * (d0 + kPad) + kRows * (kChunk + kPad) + kRows * (d2 + kPad) + g_count * kRows * d3) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pcgen_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)batch * n / kRows;
  pcgen_mix_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
