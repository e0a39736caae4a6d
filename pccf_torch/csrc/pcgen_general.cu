// PCGen eval on Hopper for every decoder the JAX package's gate takes
// (pallas_pcgen.py:60-74 pcgen_fused_supported): any number of component
// layers of any widths, non-expanding after the first, any map input and
// number of components.  The flagship's shapes run pcgen_mix.cu; this kernel runs the
// rest, one launch.
//
// Replaces pccf/kernels/pallas_pcgen.py:133 pcgen_mix_tpu (body _kernel:82)
// at those shapes.  For every point:
//   x = w ⊙ hardtanh(m · map_w^T + map_b)                                (D0)
//   per component g: h_1 = act(x · W_0[g]^T + b_0[g]) + interleave(x, D_1)
//                    h_{i+1} = act(h_i · W_i[g]^T + b_i[g]) + h_i[:D_{i+1}]
//                    comp[g] = h_L · head_w[g]^T + head_b[g]            (3)
//   out = Σ_g softmax((concat_g h_L) · att_w^T + att_b) / τ)[g] · comp[g]
// with BatchNorm folded into W and b by the wrapper; interleave(x, D)[c] is
// x[c / (D / D0 + 1)] (pccf/kernels/ops.py:146-161).
//
// Partial mode (pccf_pcgen_general_partial, the expert-parallel decode): the
// block runs the G_l components a rank holds of a decoder's G_t, att_w
// (G_t, G_l * D_L) their columns, and writes each point's partial logits
// (B, N, G_t) (att_b added, zero on all ranks but one) and its local head
// outputs (B, N, G_l, 3) in place of the mix, which the wrapper finishes
// after summing the logits over the ranks.
//
// Design: a block owns R points of one cloud (R = 64, 32 or 16, the most
// whose activations fit in shared memory; rows past N are computed on a
// repeated row and not stored) and loops over the components.  The joined
// latent x and two buffers for the layers' outputs (ping-pong) hold R rows
// in fp32, with row strides of 4 more than a multiple of 32 floats so that
// the fragment reads below hit distinct banks.  Each product is tiled in
// 16 x 32 warp tiles over mma.sync.m16n8k8: A from those buffers (or, for
// the map head, m straight from global memory), B streamed by each warp for
// its own tile in 32-wide k chunks through two stages of shared memory
// (cp.async a chunk ahead, 16-byte copies where the rows allow), K and N
// tails zero; the epilogue adds bias, activation and the residual and
// writes the next buffer.  The heads and the mix logits are fp32 warp dot
// products on the CUDA cores, accumulated in shared memory across the
// components; a thread a point ends the block with the tempered-softmax
// mix.  Where even 16 rows do not fit in 227 KB, the same buffers live in a
// global scratch of a persistent grid.  A simple kernel: every block reads
// all the component weights from L2, which bounds it at these widths
// (PERF.md records its time).  The layers' weight and bias pointers and
// widths reach the kernel as one device table (int64: L weight pointers, L
// bias pointers, L + 1 widths), so the depth has no limit.
//
// Precision: the component layers multiply TF32 operands (cvt.rna), whose
// 10-bit mantissa is the flagship kernel's fp16 one, with fp32 range and
// accumulation; the map head runs 3xTF32 (about fp32), the heads, the mix
// logits, the residual stream and the softmax fp32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"
#include "mma.cuh"

namespace {

using namespace pccf;

constexpr int kThreads = 256, kWarps = kThreads / 32, kSmemMax = 232448;
constexpr int kPersistentBlocks = 2 * 132;  // the grid when the activations live in global scratch

struct GenArgs {
  const float* m;       // (B, N, Dm)
  const float* w;       // (B, D0)
  const float* map_w;   // (D0, Dm)
  const float* map_b;   // (D0)
  const long long* table;  // device: lw_i (G, D_{i+1}, D_i), lb_i (G, D_{i+1}) as pointers, then D_0 .. D_L
  const float* head_w;  // (G, 3, D_L)
  const float* head_b;  // (G, 3)
  const float* att_w;   // (G, G * D_L)
  const float* att_b;   // (G)
  float* out;           // (B, N, 3)
  float* part_logits;   // partial mode: (B, N, G_t), else null
  float* part_heads;    // partial mode: (B, N, G_l, 3)
  float* scratch;       // a block's buffers in global memory, or null for shared memory
  int n, dm, n_layers, d0, dl, g_count, g_total, rows, ldx, ldh, tiles_n, tiles;
  float inv_tau, slope;
};

__host__ __device__ inline int row_stride(int d) { return (d + 31) / 32 * 32 + 4; }

// floats of a block's buffers: x, two layer buffers, the gt mix logits and the g heads' outputs
__host__ __device__ inline long long block_floats(int rows, int ldx, int ldh, int g, int gt) {
  return (long long)rows * (ldx + 2 * ldh + gt + 3 * g);
}

// a warp's weight stage: 32 rows (output columns) x 32 k of W, row stride
// kStageLd (4 more than 32: the fragment reads below hit distinct banks)
constexpr int kStageLd = 36, kStageFloats = 32 * kStageLd;
constexpr int kRingFloats = kWarps * 2 * kStageFloats;  // two stages a warp

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// stage W[n0 .. n0 + 31][k0 .. k0 + 31] into a warp's stage, zero past n_out
// and K: 16-byte copies where every row starts 16-byte aligned (vec), else
// 4-byte ones
__device__ __forceinline__ void stage_w(float* dst, const float* __restrict__ W, int K, int n_out, int n0, int k0,
                                        int lane, bool vec) {
  if (vec) {
#pragma unroll
    for (int e = lane; e < 32 * 8; e += 32) {
      const int r = e >> 3, c4 = (e & 7) * 4, row = n0 + r, k = k0 + c4;
      const bool ok = row < n_out && k < K;
      cp_async16(dst + r * kStageLd + c4, W + (ok ? (size_t)row * K + k : 0), ok ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int e = lane; e < 32 * 32; e += 32) {
      const int r = e >> 5, c = e & 31, row = n0 + r, k = k0 + c;
      const bool ok = row < n_out && k < K;
      cp_async4(dst + r * kStageLd + c, W + (ok ? (size_t)row * K + k : 0), ok ? 4 : 0);
    }
  }
}

// out = epi(r, c, Σ_k A[r][k] W[c][k]) for r < rows, c < n_out: A (rows, K)
// at row stride lda through a generic pointer (its row r read as row
// min(r, a_rows - 1)), W (n_out, K) row-major in global memory.  A warp owns
// 16 x 32 output tiles in turn and streams its tile's W by 32-wide k chunks
// through its two stages of ring (cp.async, a chunk ahead).  k3x: 3xTF32
template <bool k3x, typename Epi>
__device__ __forceinline__ void product(const float* A, int lda, int a_rows, int K, const float* __restrict__ W,
                                        int n_out, int rows, float* ring, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_tiles = rows / 16, items = row_tiles * ((n_out + 31) / 32), chunks = (K + 31) / 32;
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  float* stages = ring + warp * 2 * kStageFloats;
  for (int item = warp; item < items; item += kWarps) {
    const int r0 = (item % row_tiles) * 16, n0 = (item / row_tiles) * 32;
    const float* a0 = A + (size_t)min(r0 + g, a_rows - 1) * lda;
    const float* a1 = A + (size_t)min(r0 + g + 8, a_rows - 1) * lda;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    stage_w(stages, W, K, n_out, n0, 0, lane, vec);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage_w(stages + ((c + 1) & 1) * kStageFloats, W, K, n_out, n0, 32 * (c + 1), lane, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const float* st = stages + (c & 1) * kStageFloats;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int kl = 8 * s + t, ka = 32 * c + kl, kb = ka + 4;
        const bool va = ka < K, vb = kb < K;
        const float av[4] = {va ? a0[ka] : 0.f, va ? a1[ka] : 0.f, vb ? a0[kb] : 0.f, vb ? a1[kb] : 0.f};
        uint32_t a_big[4], a_small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k3x)
            split_tf32(av[i], a_big[i], a_small[i]);
          else
            a_big[i] = tf32(av[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b0 = st[(8 * j + g) * kStageLd + kl], b1 = st[(8 * j + g) * kStageLd + kl + 4];
          if (k3x) {
            uint32_t bb[2], bs[2];
            split_tf32(b0, bb[0], bs[0]);
            split_tf32(b1, bb[1], bs[1]);
            mma_3xtf32(acc[j], a_big, a_small, bb, bs);
          } else {
            const uint32_t bb[2] = {tf32(b0), tf32(b1)};
            mma_tf32(acc[j], a_big, bb);
          }
        }
      }
      __syncwarp();  // the stage is read before the next chunk's copy lands in it
    }
    // c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1) of each n8 tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, c = n0 + 8 * j + 2 * t;
        if (c < n_out) epi(r, c, acc[j][2 * half]);
        if (c + 1 < n_out) epi(r, c + 1, acc[j][2 * half + 1]);
      }
  }
}

__global__ void __launch_bounds__(kThreads) pcgen_general_kernel(const __grid_constant__ GenArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int R = p.rows, G = p.g_count, GT = p.g_total, L = p.n_layers, d0 = p.d0, dl = p.dl;
  const long long* dims = p.table + 2 * L;
  float* ring = smem;  // [kWarps][2][32][kStageLd]
  float* base = p.scratch ? p.scratch + (size_t)blockIdx.x * block_floats(R, p.ldx, p.ldh, G, GT) : smem + kRingFloats;
  float* xs = base;                 // [R][ldx]
  float* hbuf[2] = {xs + (size_t)R * p.ldx, xs + (size_t)R * p.ldx + (size_t)R * p.ldh};  // [R][ldh] each
  float* logit = hbuf[1] + (size_t)R * p.ldh;  // [R][GT]
  float* comp = logit + R * GT;                // [R][G][3]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int b = tile / p.tiles_n, p0 = (tile % p.tiles_n) * R;
    const int valid = min(R, p.n - p0);
    const float* wb = p.w + (size_t)b * d0;
    for (int i = threadIdx.x; i < R * GT; i += kThreads) logit[i] = __ldg(p.att_b + i % GT);
    // the join: x = w ⊙ hardtanh(m · map_w^T + map_b)
    product<true>(p.m + ((size_t)b * p.n + p0) * p.dm, p.dm, valid, p.dm, p.map_w, d0, R, ring,
                  [&](int r, int c, float v) {
                    xs[r * p.ldx + c] = __ldg(wb + c) * fminf(fmaxf(v + __ldg(p.map_b + c), -1.f), 1.f);
                  });
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const float* src = xs;
      int lds = p.ldx;
      for (int i = 0; i < L; ++i) {
        const int din = (int)__ldg(dims + i), dout = (int)__ldg(dims + i + 1), reps = i == 0 ? dout / din + 1 : 1;
        const float* lw = reinterpret_cast<const float*>(__ldg(p.table + i));
        const float* bias = reinterpret_cast<const float*>(__ldg(p.table + L + i)) + (size_t)g * dout;
        float* dst = hbuf[i & 1];
        const float slope = p.slope;
        const int ldh = p.ldh;
        product<false>(src, lds, R, din, lw + (size_t)g * dout * din, dout, R, ring, [&](int r, int c, float v) {
          v += __ldg(bias + c);
          dst[r * ldh + c] = (v >= 0.f ? v : slope * v) + src[r * lds + c / reps];
        });
        __syncthreads();
        src = dst;
        lds = ldh;
      }
      // component g's head outputs and its share of every mix logit: a warp a dot product
      for (int task = warp; task < R * (3 + GT); task += kWarps) {
        const int r = task / (3 + GT), o = task % (3 + GT);
        const float* wv = o < 3 ? p.head_w + ((size_t)g * 3 + o) * dl : p.att_w + ((size_t)(o - 3) * G + g) * dl;
        float s = 0.f;
        for (int c = lane; c < dl; c += 32) s = fmaf(src[r * lds + c], __ldg(wv + c), s);
#pragma unroll
        for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) {
          if (o < 3)
            comp[(r * G + g) * 3 + o] = s + __ldg(p.head_b + g * 3 + o);
          else
            logit[r * GT + o - 3] += s;
        }
      }
      __syncthreads();
    }
    if (p.part_logits) {  // partial mode: the logits and the heads as they are
      for (int i = threadIdx.x; i < valid * GT; i += kThreads)
        p.part_logits[((size_t)b * p.n + p0) * GT + i] = logit[i];
      for (int i = threadIdx.x; i < valid * G * 3; i += kThreads)
        p.part_heads[((size_t)b * p.n + p0) * G * 3 + i] = comp[i];
      __syncthreads();
      continue;
    }
    // the tempered-softmax mix, a thread a point
    for (int r = threadIdx.x; r < valid; r += kThreads) {
      float mx = -INFINITY;
      for (int q = 0; q < G; ++q) mx = fmaxf(mx, logit[r * G + q] * p.inv_tau);
      float sum = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f;
      for (int q = 0; q < G; ++q) {
        const float e = expf(logit[r * G + q] * p.inv_tau - mx);
        const float* cq = comp + (r * G + q) * 3;
        sum += e;
        o0 = fmaf(e, cq[0], o0);
        o1 = fmaf(e, cq[1], o1);
        o2 = fmaf(e, cq[2], o2);
      }
      float* o = p.out + ((size_t)b * p.n + p0 + r) * 3;
      o[0] = o0 / sum;
      o[1] = o1 / sum;
      o[2] = o2 / sum;
    }
    __syncthreads();
  }
}

bool valid_shape(int batch, int n, int dm, int n_layers, const int* dims, int g_count, int g_total) {
  if (batch < 1 || batch > 65535 || n < 1 || dm < 1 || n_layers < 1 || g_count < 1 || g_total < g_count)
    return false;
  for (int i = 0; i <= n_layers; ++i)
    if (dims[i] < 1) return false;
  for (int i = 1; i < n_layers; ++i)
    if (dims[i + 1] > dims[i]) return false;  // later layers' residual is a prefix of their input
  return true;
}

// rows a block and whether its buffers fit in shared memory
void plan(int n_layers, const int* dims, int g_count, int g_total, int* rows, bool* in_smem, int* ldx, int* ldh) {
  int dh = 0;
  for (int i = 1; i <= n_layers; ++i) dh = dims[i] > dh ? dims[i] : dh;
  *ldx = row_stride(dims[0]);
  *ldh = row_stride(dh);
  for (int r = 64; r >= 16; r /= 2) {
    *rows = r;
    *in_smem = (block_floats(r, *ldx, *ldh, g_count, g_total) + kRingFloats) * 4 <= kSmemMax;
    if (*in_smem) return;
  }
}


// floats of global scratch the kernel needs (0: none) for g_count components
// and g_total logits (equal but in partial mode), -1 for shapes it does not
// cover
int scratch_floats(int batch, int n, int dm, int n_layers, const int* dims, int g_count, int g_total) {
  if (!valid_shape(batch, n, dm, n_layers, dims, g_count, g_total)) return -1;
  int rows, ldx, ldh;
  bool in_smem;
  plan(n_layers, dims, g_count, g_total, &rows, &in_smem, &ldx, &ldh);
  if (in_smem) return 0;
  const long long tiles = (long long)batch * ((n + rows - 1) / rows);
  const long long blocks = tiles < kPersistentBlocks ? tiles : kPersistentBlocks;
  const long long floats = blocks * block_floats(rows, ldx, ldh, g_count, g_total);
  return floats > 0x7fffffffLL ? -1 : (int)floats;
}

int run(const float* m, const float* w, const float* map_w, const float* map_b, const long long* table, int n_layers,
        const int* dims, const float* head_w, const float* head_b, const float* att_w, const float* att_b, float* out,
        float* part_logits, float* part_heads, float* scratch, int batch, int n, int dm, int g_count, int g_total,
        float tau, float slope, cudaStream_t stream) {
  if (!valid_shape(batch, n, dm, n_layers, dims, g_count, g_total)) return (int)cudaErrorInvalidValue;
  GenArgs p = {};
  p.m = m;
  p.w = w;
  p.map_w = map_w;
  p.map_b = map_b;
  p.table = table;
  p.head_w = head_w;
  p.head_b = head_b;
  p.att_w = att_w;
  p.att_b = att_b;
  p.out = out;
  p.part_logits = part_logits;
  p.part_heads = part_heads;
  p.n = n;
  p.dm = dm;
  p.n_layers = n_layers;
  p.d0 = dims[0];
  p.dl = dims[n_layers];
  p.g_count = g_count;
  p.g_total = g_total;
  p.inv_tau = 1.f / tau;
  p.slope = slope;
  bool in_smem;
  plan(n_layers, dims, g_count, g_total, &p.rows, &in_smem, &p.ldx, &p.ldh);
  if (!in_smem && !scratch) return (int)cudaErrorInvalidValue;
  p.scratch = in_smem ? nullptr : scratch;
  p.tiles_n = (n + p.rows - 1) / p.rows;
  const long long tiles = (long long)batch * p.tiles_n;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const int smem = (int)((in_smem ? block_floats(p.rows, p.ldx, p.ldh, g_count, g_total) : 0) + kRingFloats) * 4;
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)pcgen_general_kernel, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = in_smem ? p.tiles : (p.tiles < kPersistentBlocks ? p.tiles : kPersistentBlocks);
  pcgen_general_kernel<<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of global scratch pccf_pcgen_general needs (0: none), -1 for shapes it does not cover
extern "C" int pccf_pcgen_general_scratch(int batch, int n, int dm, int n_layers, const int* dims, int g_count) {
  return scratch_floats(batch, n, dm, n_layers, dims, g_count, g_count);
}

// the same for pccf_pcgen_general_partial with g_local of g_total components
extern "C" int pccf_pcgen_general_partial_scratch(int batch, int n, int dm, int n_layers, const int* dims,
                                                  int g_local, int g_total) {
  return scratch_floats(batch, n, dm, n_layers, dims, g_local, g_total);
}

// out (B, N, 3) from m (B, N, Dm) and w (B, D0) through n_layers component
// layers of widths dims[0] -> ... -> dims[n_layers] (a host array); table is
// the device copy of the layers' weight pointers (G, D_{i+1}, D_i), their
// bias pointers (G, D_{i+1}), all fp32, then the widths, as int64;
// scratch: pccf_pcgen_general_scratch floats, or null where that is 0
extern "C" int pccf_pcgen_general(const float* m, const float* w, const float* map_w, const float* map_b,
                                  const long long* table, int n_layers, const int* dims, const float* head_w,
                                  const float* head_b, const float* att_w, const float* att_b, float* out,
                                  float* scratch, int batch, int n, int dm, int g_count, float tau, float slope,
                                  cudaStream_t stream) {
  return run(m, w, map_w, map_b, table, n_layers, dims, head_w, head_b, att_w, att_b, out, nullptr, nullptr, scratch,
             batch, n, dm, g_count, g_count, tau, slope, stream);
}

// partial mode: the g_local components of a rank (weights as above), att_w
// (g_total, g_local * D_L) and att_b (g_total) -> logits (B, N, g_total) and
// heads (B, N, g_local, 3); scratch: pccf_pcgen_general_partial_scratch
// floats.  Any g_local from 1 (mp = G) to g_total.
extern "C" int pccf_pcgen_general_partial(const float* m, const float* w, const float* map_w, const float* map_b,
                                          const long long* table, int n_layers, const int* dims, const float* head_w,
                                          const float* head_b, const float* att_w, const float* att_b, float* logits,
                                          float* heads, float* scratch, int batch, int n, int dm, int g_local,
                                          int g_total, float slope, cudaStream_t stream) {
  if (!logits || !heads) return (int)cudaErrorInvalidValue;
  return run(m, w, map_w, map_b, table, n_layers, dims, head_w, head_b, att_w, att_b, nullptr, logits, heads, scratch,
             batch, n, dm, g_local, g_total, 1.f, slope, stream);
}
