// Pre-norm transformer stacks on Hopper: a GEMM with a bias / GELU /
// residual epilogue over up to three weight matrices at once, a LayerNorm, and
// streaming multi-head attention.  The stack launchers in
// pccf_torch/kernels/wformer.py launch these in turn on one stream, layer by
// layer; the counterfactual CVAE chain (pccf_torch/kernels/cvae.py) runs its
// three stacks through the same launchers.
//
// Replaces pccf/kernels/pallas_wformer.py:335 wformer_encoder_tpu and :365
// wformer_decoder_tpu (layer bodies _enc_layers / _dec_layers), and with them
// pccf/kernels/pallas_cvae.py:203 cvae_cf_tpu, which is built on those
// bodies: T = 256 code tokens of width d = 512 with 8 heads of 64 at the
// flagship configuration.
//
// What bounds it: the matrix products, 1.21 GFLOP per encoder layer and
// 1.6-1.8 GFLOP per decoder layer per sample (M = B*256 rows, N and K of 512
// to 1536), against the TF32 tensor-core peak (each product is three TF32
// products, so at most a third of that peak counts); and launch overhead, 7
// launches an encoder layer and 12 a decoder layer.  The TPU kernel keeps
// every layer's weights and the residual stream in VMEM for the whole stack;
// a block here has 227 KB of shared memory, so the residual stream goes
// through device memory (L2 at these sizes) between launches.  A fused
// persistent stack is later work.
//
// Precision: the chain feeds a VQ argmin whose choices must agree with the
// fp32 plain version, so every product runs as 3xTF32 (x = big + small, both
// TF32; small*big + big*small + big*big with fp32 accumulation, the small
// products first), accurate to about 2^-22 of each term.  LayerNorm (eps
// from the caller, 1e-6 as flax), softmax and the residual stream are fp32;
// GELU is the exact erf form.
//
// GEMM design (gemm_kernel): one producer warp issues TMA loads of 32-wide k
// slices (one 128-byte swizzled row per matrix row) into a ring of 4 stages
// tracked by mbarriers; one or two consumer warpgroups each own 64 rows of the
// tile and issue wgmma.m64nNk8 on TF32. Each consumer thread loads its A
// fragments from the swizzled tile once and splits them in registers: big = x
// with its low 13 bits cleared, small = x - big rounded to TF32; all three
// products take A from registers, so shared memory serves only B to the tensor
// cores (A read from shared memory by the big products was 6% slower on an
// H100). The tensor cores read B's raw fp32 tile as its truncated TF32 big
// part. B's small part comes from a separate tensor: the stack launchers split
// every weight of a stack once per stack call with one elementwise launch
// (tf32_split_kernel), since a weight tile is read by every row tile of the
// grid and splitting it in shared memory would redo the work in every block and
// need a proxy fence before each wgmma. The tensor cores sum each k tile's 12
// products into a fresh accumulator and the tiles' sums add in registers in
// fp32: summed on the tensor cores alone over K = 1024 the result missed the
// float64 product by ~5e-6 (rel-L2, on an H100), the tile sums keep it at
// ~2e-7. The tile is 128x128 where that gives the 132 SMs a full wave, else
// 128x64, else 64x64 (the block count of a 64x64 grid, 32 at M = 256, N = 512).
//
// The bf16-weight instance (pccf_gemm_bf16w, gemm_bf16w_kernel): the server's
// bf16 cast keeps the stacks' projection and FF weights in bfloat16
// (pccf/serve.py:216-220 _cast), and the product is float32 arithmetic on
// those rounded weights, as JAX computes it (an f32 activation times a bf16
// parameter promotes to f32). What bounds it: the bytes (A, the outputs and a
// quarter of the fp32 instance's weight bytes: 0.0105 ms at (4096, 512, 512)
// x 3, where it takes ~5x that on an H100) ahead of its tensor-core work
// (below). The producer loads each weight tile as bf16 by TMA, 64-byte
// swizzled (32 x BN, 64-byte rows), and wgmma reads it as the bf16 B operand
// just as it landed: no widening pass, no proxy fence, no barrier between the
// consumers. Each consumer thread splits its fp32 A fragments into three bf16
// parts in registers (a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1 -
// a2), each residual exact: 24 significant bits, a itself), and issues
// wgmma.m64nNk16.bf16 with A from registers, smallest part first: each bf16 x
// bf16 product is exact in fp32, and the six k16 MMAs of a 32-wide k tile
// take the tensor-core time of six TF32 k8 MMAs where the fp32 instance
// issues twelve. The k tile's sum joins the fp32 accumulator in registers as
// in the fp32 instance; while one warpgroup reads and splits its next
// fragments the other's products run (nine warps hold a thread to 168
// registers, no room for a second set of fragments). A stage holds only what
// TMA loads, so the ring is eight deep.
//
// Attention design (attention_kernel): a block holds 64 queries of one
// (batch, head), their 3xTF32 fragments in registers, and walks the keys in
// tiles of 64 with K and V double-buffered in 68 KB of shared memory by
// cp.async (three blocks an SM); scores stay in registers under an online
// softmax (running max and sum per row), and P feeds P·V straight from the
// score registers, the keys of each 8-wide step taken in the order the score
// fragment holds them (V read row-major in that order, no transposed copy).
// That is the 64-wide head of the flagship; heads of 16, 32 and 128 have
// instances of their own, and any other width up to 128 runs in the next
// instance up with the staged columns past it zero.  Any number of keys in
// tiles of 64.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace pccf;

__device__ __forceinline__ float gelu_exact(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// the TF32 small part of x against the truncated big part the tensor cores read
__device__ __forceinline__ uint32_t tf32_small(float x) {
  return tf32(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u));
}

// ------------------------------------------------------------------ GEMM
// out_g[M, N] = epilogue(A[M, K] · Wt_g[N, K]^T) for each group g: + bias_g[N],
// optional exact GELU, then + res[(row % res_rows), N].  out may alias res
// (in-place residual).

constexpr int kMaxGroups = 3, kBk = 32, kStages = 4;

struct GemmArgs {
  CUtensorMap a;                     // A (M, K), boxes of 32 x (64 * warpgroups)
  CUtensorMap wt[kMaxGroups];        // Wt_g (N, K), boxes of 32 x BN, fp32 or (pccf_gemm_bf16w) bf16
  CUtensorMap wt_small[kMaxGroups];  // the TF32 small parts of fp32 Wt_g (unused for bf16 weights)
  const float* bias[kMaxGroups];
  float* out[kMaxGroups];
  const float* res;
  int N, res_rows, gelu, k_tiles, n_tiles;  // n_tiles: column tiles per group
};

// one thread's share of the output tile: rows r0 and r0 + 8, columns
// n0 + 8 j + 2 t and the next, out = acc + bias [GELU] [+ res].  With a
// residual every load is issued before the first store: out may alias res, so
// a store between two loads would keep the compiler from issuing them together
template <int kBn, bool kRes>
__device__ __forceinline__ void store_tile(const float (&acc)[kBn / 2], const GemmArgs& args, const float* bias,
                                           float* out, int n0, int r0, int t) {
  const int N = args.N;
  float rv[kBn / 2];
  if (kRes) {
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 v = *reinterpret_cast<const float2*>(
            args.res + (size_t)((r0 + 8 * half) % args.res_rows) * N + n0 + 8 * j + 2 * t);
        rv[4 * j + 2 * half] = v.x;
        rv[4 * j + 2 * half + 1] = v.y;
      }
  }
#pragma unroll
  for (int j = 0; j < kBn / 8; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    const float2 bv = bias ? *reinterpret_cast<const float2*>(bias + c) : make_float2(0.f, 0.f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v0 = acc[4 * j + 2 * half] + bv.x, v1 = acc[4 * j + 2 * half + 1] + bv.y;
      if (args.gelu) {
        v0 = gelu_exact(v0);
        v1 = gelu_exact(v1);
      }
      if (kRes) {
        v0 += rv[4 * j + 2 * half];
        v1 += rv[4 * j + 2 * half + 1];
      }
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8 * half) * N + c) = make_float2(v0, v1);
    }
  }
}

// the bytes of one pipeline stage: A, the fp32 B tile the tensor cores read,
// and B's TF32 small part
template <int kWg, int kBn>
struct GemmStage {
  static constexpr int a = 64 * kWg * kBk * 4, b = kBn * kBk * 4;
  static constexpr int bytes = a + 2 * b;
  static constexpr int smem = kStages * bytes + 1024 + 2 * kStages * 8;
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kWg, int kBn>
__global__ void __launch_bounds__(kWg * 128 + 32, 1) gemm_kernel(const __grid_constant__ GemmArgs args) {
  using S = GemmStage<kWg, kBn>;
  constexpr int kABytes = S::a, kBBytes = S::b, kStageBytes = S::bytes, kBm = 64 * kWg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = blockIdx.x / args.n_tiles;
  const int n0 = (blockIdx.x % args.n_tiles) * kBn, m0 = blockIdx.y * kBm;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWg);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kWg) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      for (int kt = 0; kt < args.k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) + 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(st, &args.a, &full[s], kt * kBk, m0);
        tma_load_2d(st + kABytes, &args.wt[group], &full[s], kt * kBk, n0);
        tma_load_2d(st + kABytes + kBBytes, &args.wt_small[group], &full[s], kt * kBk, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2, wr = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
  // part: one k tile's products, summed on the tensor cores; acc: the tiles' sums
  float acc[kBn / 2], part[kBn / 2];
#pragma unroll
  for (int i = 0; i < kBn / 2; ++i) acc[i] = part[i] = 0.f;
  fence_operands(part);

  for (int kt = 0; kt < args.k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* st = smem + s * kStageBytes;
    const float* at = reinterpret_cast<const float*>(st + wg * 64 * 128);
    // A's fragments for the four 8-wide k steps, split into big and small
    // parts, from the swizzled tile: (r, c) at float
    // r * 32 + ((c / 4) ^ (r % 8)) * 4 + c % 4, and r % 8 = g
    uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int lo = (((2 * kk) ^ g) << 2) + t, hi = (((2 * kk + 1) ^ g) << 2) + t;
      const float x[4] = {at[(wr + g) * 32 + lo], at[(wr + g + 8) * 32 + lo], at[(wr + g) * 32 + hi],
                          at[(wr + g + 8) * 32 + hi]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_big[kk][i] = __float_as_uint(x[i]) & 0xFFFFE000u;
        a_small[kk][i] = tf32_small(x[i]);
      }
    }
    const uint64_t db = desc_sw128(st + kABytes), dbs = desc_sw128(st + kABytes + kBBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, a_small[kk], db + 2 * kk, kk > 0);  // small(A) · big(B)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, a_big[kk], dbs + 2 * kk, 1);  // big(A) · small(B)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, a_big[kk], db + 2 * kk, 1);  // big(A) · big(B)
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < kBn / 2; ++i) acc[i] += part[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: lane (g, t) holds rows r0 and r0 + 8 at columns 8 j + 2 t, +1
  const int r0 = m0 + wg * 64 + wr + g;
  if (args.res)
    store_tile<kBn, true>(acc, args, args.bias[group], args.out[group], n0, r0, t);
  else
    store_tile<kBn, false>(acc, args, args.bias[group], args.out[group], n0, r0, t);
}

// ------------------------------------------------ GEMM, bf16 weights
// the stage ring of gemm_bf16w_kernel: A (fp32) and the bf16 weight tile
// TMA loads, nothing written by the consumers, so the ring can be deeper

constexpr int kBf16Stages = 8;

template <int kWg, int kBn>
struct Bf16Stage {
  static constexpr int a = 64 * kWg * kBk * 4, b = kBn * kBk * 2;
  static constexpr int bytes = a + b;
  static constexpr int smem = kBf16Stages * bytes + 1024 + 2 * kBf16Stages * 8;
};

// two fp32 values as bf16x2, rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x = p[0] + p[1] + p[2] for each half, three bf16 of 8 significant bits:
// each residual x - (the parts so far) is exact in fp32, so the third part is
// the last 8 of x's 24 bits and the sum is x itself (bar underflow)
__device__ __forceinline__ void split_bf16x3(float2 x, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  p0 = bf16x2(x.x, x.y);
  x.x -= __uint_as_float(p0 << 16);
  x.y -= __uint_as_float(p0 & 0xFFFF0000u);
  p1 = bf16x2(x.x, x.y);
  x.x -= __uint_as_float(p1 << 16);
  x.y -= __uint_as_float(p1 & 0xFFFF0000u);
  p2 = bf16x2(x.x, x.y);
}

// the A fragments of the two 16-wide k steps of a staged 32-wide k tile
// (128-byte swizzled fp32 rows, as gemm_kernel reads them), in three bf16
// parts: f[step][part][reg], reg as wgmma_rs_bf16 takes it; the k pair 2t,
// 2t + 1 of a row is one float2 of the swizzled row
__device__ __forceinline__ void a_fragments_bf16x3(const float* at, int wr, int g, int t, uint32_t (&f)[2][3][4]) {
#pragma unroll
  for (int step = 0; step < 2; ++step)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wr + g + 8 * (i & 1), chunk = 4 * step + (t >> 1) + 2 * (i >> 1);
      const float2 x = *reinterpret_cast<const float2*>(at + r * 32 + ((chunk ^ g) << 2) + 2 * (t & 1));
      split_bf16x3(x, f[step][0][i], f[step][1][i], f[step][2][i]);
    }
}

template <int kWg, int kBn>
__global__ void __launch_bounds__(kWg * 128 + 32, 1) gemm_bf16w_kernel(const __grid_constant__ GemmArgs args) {
  using S = Bf16Stage<kWg, kBn>;
  constexpr int kBm = 64 * kWg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBf16Stages * S::bytes);
  uint64_t* empty = full + kBf16Stages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = blockIdx.x / args.n_tiles;
  const int n0 = (blockIdx.x % args.n_tiles) * kBn, m0 = blockIdx.y * kBm;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kBf16Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWg);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kWg) {  // the producer warp
    if (lane == 0) {
      for (int kt = 0; kt < args.k_tiles; ++kt) {
        const int s = kt % kBf16Stages;
        if (kt >= kBf16Stages) mbar_wait(&empty[s], ((kt / kBf16Stages) + 1) & 1);
        uint8_t* st = smem + s * S::bytes;
        mbar_expect_tx(&full[s], S::bytes);
        tma_load_2d(st, &args.a, &full[s], kt * kBk, m0);
        tma_load_2d(st + S::a, &args.wt[group], &full[s], kt * kBk, n0);
      }
    }
  } else {
    const int wg = warp >> 2, wr = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
    // part: one k tile's products, summed on the tensor cores; acc: the tiles' sums
    float acc[kBn / 2], part[kBn / 2];
#pragma unroll
    for (int i = 0; i < kBn / 2; ++i) acc[i] = part[i] = 0.f;
    fence_operands(part);
    for (int kt = 0; kt < args.k_tiles; ++kt) {
      const int s = kt % kBf16Stages;
      mbar_wait(&full[s], (kt / kBf16Stages) & 1);
      const uint8_t* st = smem + s * S::bytes;
      uint32_t f[2][3][4];
      a_fragments_bf16x3(reinterpret_cast<const float*>(st + wg * 64 * 128), wr, g, t, f);
      const uint64_t db = desc_sw64(st + S::a);
      wgmma_fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)  // the smallest part first
#pragma unroll
        for (int step = 0; step < 2; ++step) wgmma_rs_bf16(part, f[step][p], db + 2 * step, p < 2 || step > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < kBn / 2; ++i) acc[i] += part[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const int r0 = m0 + wg * 64 + wr + g;
    if (args.res)
      store_tile<kBn, true>(acc, args, args.bias[group], args.out[group], n0, r0, t);
    else
      store_tile<kBn, false>(acc, args, args.bias[group], args.out[group], n0, r0, t);
  }
}

// ------------------------------------------------- weight split (3xTF32)
// dst_i = the TF32 small part of src_i, elementwise, for up to kMaxSplit
// tensors in one launch (blockIdx.y picks the tensor)

constexpr int kMaxSplit = 128;

struct SplitArgs {
  const float* src[kMaxSplit];
  float* dst[kMaxSplit];
  long long n[kMaxSplit];
};

__global__ void tf32_split_kernel(const __grid_constant__ SplitArgs args) {
  const float* src = args.src[blockIdx.y];
  float* dst = args.dst[blockIdx.y];
  const long long n = args.n[blockIdx.y];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x)
    dst[i] = __uint_as_float(tf32_small(src[i]));
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
// Block = 64 queries of one (batch, head); 4 warps x 16 queries.  Head h
// reads columns h*hd .. h*hd+hd-1 of q, k and v, staged kHd wide: kHd is the
// head width hd where hd is 16, 32, 64 or 128, else the next of those, with
// the staged q, k and v columns past hd zero (exact: they add nothing to a
// score, and the output columns past hd are not stored; the scale is
// 1/sqrt(hd)).  Fragments (mma.cuh):
// lane (g, t) holds score rows g and g+8 at keys 8n + 2t and 8n + 2t + 1; for
// P·V those two keys fill the A slots t and t+4 of an 8-key step, and the B
// fragment reads V at the same two keys.  Up to 64-wide heads a warp keeps
// its queries' 3xTF32 fragments in registers; 128-wide heads keep the
// queries in shared memory and split them again for every key tile, which
// leaves the registers to the 64 output columns.  Wider heads run
// attention_wide_kernel below.

constexpr int kQt = 64, kKt = 64;

template <int kHd>
struct AttnShape {
  static constexpr int ld = kHd + 4;      // row stride of a staged tile: conflict-free fragment reads
  static constexpr int tile = kKt * ld;   // floats of one staged 64-row tile
  static constexpr bool q_regs = kHd <= 64;
  // K and V, two stages each, and the queries where they stay in shared memory
  static constexpr size_t smem = (4 + (q_regs ? 0 : 1)) * tile * sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// stage 64 rows x hd floats at src (row stride `stride`) into dst (stride
// ld), the columns hd .. kHd - 1 zero: 16-byte async copies where hd is a
// multiple of 4, else element by element (unsigned index arithmetic: the
// signed division's sign fix-ups cost the 64-wide instance ~6% at batch 32
// on an H100)
template <int kHd, bool kPad>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int stride, int hd, int tid) {
  constexpr int ld = AttnShape<kHd>::ld, kQuads = kHd / 4;
  if (!kPad || hd % 4 == 0) {
#pragma unroll
    for (int e = tid; e < kKt * kQuads; e += 128) {
      const int r = static_cast<unsigned>(e) / kQuads, c4 = static_cast<unsigned>(e) % kQuads * 4;
      if (!kPad || c4 < hd)
        cp_async16(dst + r * ld + c4, src + (size_t)r * stride + c4);
      else
        *reinterpret_cast<float4*>(dst + r * ld + c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < kKt * kHd; e += 128) {
      const int r = static_cast<unsigned>(e) / kHd, c = static_cast<unsigned>(e) % kHd;
      dst[r * ld + c] = c < hd ? src[(size_t)r * stride + c] : 0.f;
    }
  }
}

// the 3xTF32 A fragment of (q · scale) for the 8-wide k step kk, rows wr + g
// and wr + g + 8 of the staged queries
template <int kHd>
__device__ __forceinline__ void q_fragment(const float* qs, int wr, int g, int t, int kk, float scale,
                                           uint32_t (&big)[4], uint32_t (&small)[4]) {
  constexpr int ld = AttnShape<kHd>::ld;
  const int c = 8 * kk + t;
  split_tf32(qs[(wr + g) * ld + c] * scale, big[0], small[0]);
  split_tf32(qs[(wr + g + 8) * ld + c] * scale, big[1], small[1]);
  split_tf32(qs[(wr + g) * ld + c + 4] * scale, big[2], small[2]);
  split_tf32(qs[(wr + g + 8) * ld + c + 4] * scale, big[3], small[3]);
}

template <int kHd, bool kPad>
__global__ void __launch_bounds__(128, kHd <= 64 ? 3 : 1)
    attention_kernel(const float* __restrict__ q, int q_stride, const float* __restrict__ k,
                     const float* __restrict__ v, int kv_stride, float* __restrict__ out, int out_stride, int t_q,
                     int t_k, int hd, float scale) {
  using S = AttnShape<kHd>;
  constexpr int ld = S::ld, kTileF = S::tile, kSteps = kHd / 8;
  extern __shared__ float smem[];
  float* ks = smem;               // [2][64][ld]
  float* vs = smem + 2 * kTileF;  // [2][64][ld]
  // the queries: through the second K stage where they go to registers,
  // else in a buffer of their own
  float* qs = S::q_regs ? ks + kTileF : smem + 4 * kTileF;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int q0 = blockIdx.x * kQt, h = blockIdx.y, b = blockIdx.z;
  const int head = h * (kPad ? hd : kHd);  // the head's first column
  const float* qb = q + ((size_t)b * t_q + q0) * q_stride + head;
  const float* kb = k + (size_t)b * t_k * kv_stride + head;
  const float* vb = v + (size_t)b * t_k * kv_stride + head;
  const int n_tiles = t_k / kKt;

  stage_tile<kHd, kPad>(qs, qb, q_stride, hd, tid);
  cp_async_commit();
  stage_tile<kHd, kPad>(ks, kb, kv_stride, hd, tid);
  stage_tile<kHd, kPad>(vs, vb, kv_stride, hd, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // (q · scale) as 3xTF32 A fragments for the steps over the head's columns
  uint32_t q_big[S::q_regs ? kSteps : 1][4], q_small[S::q_regs ? kSteps : 1][4];  // where they stay in registers
  if constexpr (S::q_regs) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) q_fragment<kHd>(qs, wr, g, t, kk, scale, q_big[kk], q_small[kk]);
    __syncthreads();  // the second K stage is free for tile 1
  }

  float o[kSteps][4];
#pragma unroll
  for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g and g + 8; l per lane, summed at the end

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nxt = (j + 1) & 1;
      stage_tile<kHd, kPad>(ks + nxt * kTileF, kb + (size_t)(j + 1) * kKt * kv_stride, kv_stride, hd, tid);
      stage_tile<kHd, kPad>(vs + nxt * kTileF, vb + (size_t)(j + 1) * kKt * kv_stride, kv_stride, hd, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + (j & 1) * kTileF;
    const float* vt = vs + (j & 1) * kTileF;

    // S = (q · scale) K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    if constexpr (S::q_regs) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* kr = kt + (nt * 8 + g) * ld + 8 * kk + t;
          uint32_t bb[2], bs[2];
          split_tf32(kr[0], bb[0], bs[0]);
          split_tf32(kr[4], bb[1], bs[1]);
          mma_3xtf32(s[nt], q_big[kk], q_small[kk], bb, bs);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t qf_big[4], qf_small[4];
        q_fragment<kHd>(qs, wr, g, t, kk, scale, qf_big, qf_small);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* kr = kt + (nt * 8 + g) * ld + 8 * kk + t;
          uint32_t bb[2], bs[2];
          split_tf32(kr[0], bb[0], bs[0]);
          split_tf32(kr[4], bb[1], bs[1]);
          mma_3xtf32(s[nt], qf_big, qf_small, bb, bs);
        }
      }
    }

    // online softmax: rescale the running sums and output to the new row max
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float corr = expf(m_run[half] - m_new);
      float sum = 0.f;
      // the score tiles and, for a 64-wide head, the output tiles share the loop
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * half] = expf(s[nt][2 * half] - m_new);
        s[nt][2 * half + 1] = expf(s[nt][2 * half + 1] - m_new);
        sum += s[nt][2 * half] + s[nt][2 * half + 1];
        if constexpr (kSteps == 8) {
          o[nt][2 * half] *= corr;
          o[nt][2 * half + 1] *= corr;
        }
      }
      if constexpr (kSteps != 8) {
#pragma unroll
        for (int nt = 0; nt < kSteps; ++nt) {
          o[nt][2 * half] *= corr;
          o[nt][2 * half + 1] *= corr;
        }
      }
      l_run[half] = l_run[half] * corr + sum;
      m_run[half] = m_new;
    }

    // O += P · V: the 8-key step kk is score block kk, keys 8kk + 2t (slot t)
    // and 8kk + 2t + 1 (slot t + 4)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t p_big[4], p_small[4];
      split_tf32(s[kk][0], p_big[0], p_small[0]);
      split_tf32(s[kk][2], p_big[1], p_small[1]);
      split_tf32(s[kk][1], p_big[2], p_small[2]);
      split_tf32(s[kk][3], p_big[3], p_small[3]);
      const float* v0 = vt + (8 * kk + 2 * t) * ld + g;
#pragma unroll
      for (int nt = 0; nt < kSteps; ++nt) {
        uint32_t bb[2], bs[2];
        split_tf32(v0[nt * 8], bb[0], bs[0]);
        split_tf32(v0[ld + nt * 8], bb[1], bs[1]);
        mma_3xtf32(o[nt], p_big, p_small, bb, bs);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* ob = out + ((size_t)b * t_q + q0 + wr) * out_stride + head;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt) {
      float* dst = ob + (size_t)(g + half * 8) * out_stride + nt * 8 + 2 * t;
      const float v0 = o[nt][2 * half] * inv, v1 = o[nt][2 * half + 1] * inv;
      if (!kPad) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        const int c = nt * 8 + 2 * t;
        if (c < hd) dst[0] = v0;
        if (c + 1 < hd) dst[1] = v1;
      }
    }
  }
}

// ------------------------------------------------- attention, wide heads
// Heads wider than 128 (up to the model width: 256 or 512 at d = 512 with 2
// or 1 heads).  A block takes 64 queries of one (batch, head) with two
// consumer warpgroups and a producer warpgroup, and walks the keys in score
// tiles of up to kWideKeys = 256.  For each score tile:
//
// 1. scores, once: S^T (keys x queries) = K · Q^T on wgmma m64n64k8 (TF32),
//    the head's columns 32 at a time from a two-stage TMA ring (Q's 64 x 32
//    box and K's up to 4 boxes of 64 x 32, 128-byte swizzled).  K is the A
//    operand: each consumer thread loads its fragments and splits them into
//    TF32 big and small parts in registers, as the GEMM splits A.  Q is the B
//    operand from shared memory; its small part is made once a chunk into the
//    stage (Q is 64 rows, K up to 256) by three warps of the producer
//    warpgroup as the chunk lands, fenced for the async proxy and reported
//    on an mbarrier, so the consumers do not meet per chunk.  Warpgroup u
//    owns key rows 128u .. 128u + 127 of the tile; the products of its two
//    64-row m-tiles go to the tensor cores back to back, each into a fresh
//    accumulator a chunk at a time, added in fp32.
// 2. softmax over each query's keys (a column of S^T: across lanes by
//    shuffles, across the eight warps through shared memory), exact over
//    the tile; P = exp((s - max) / sqrt(hd)) and its TF32 small part go to
//    shared memory over the score ring's bytes, as the B operand of step 3.
// 3. O^T (head columns x queries) = V^T · P^T on wgmma m64n64k8: V^T is the
//    A operand, fragments read from the 64-key x 128-column V boxes the
//    producer streams through a second ring (prefetched while step 1 runs)
//    and split in registers, so V needs no transposed copy and no small part
//    in shared memory; a k step's slots hold keys 2t and 2t + 1 (P is
//    written in that order), so those reads are free of bank conflicts.
//    Warpgroup u makes columns 64u .. 64u + 63 of each 128-column output
//    chunk; the sums run a 64-key V stage at a time in a fresh accumulator
//    and add in fp32.
//
// The output is stored from the O^T fragments divided by the row sums.  Past
// one score tile (t_k > 256) the softmax runs on: each tile's max and sum
// update the query's running ones (kept in shared memory) and the tile's
// output joins the stored one as out * l_old * corr / l_new + O / l_new, each
// thread reading back what it stored.  So every score of a head is computed
// once; Q's chunks are split once a score tile.  The TMA maps are 2-D over
// the (rows, n_heads * hd) view at its row stride, so q, k and v must start
// on 16 bytes, and a box must start on 16 bytes too: a head whose first
// column is off a multiple of 4 (any width off 4) sits sh columns into its
// boxes.  The columns of a chunk outside the head (before it in the first
// chunk, past it in the last) are zeroed in Q and in K's fragments; V's
// columns outside the head only feed output rows that are not stored.
//
// What bounds it: the products, 3 TF32 MMAs per product (4·t_q·t_k·hd
// operations a head) against 495 TFLOP/s, 0.026 ms at (32, 256, 256) with
// one head of 512 (128 blocks, one per SM), and the reads from L2: each of a
// head's query tiles reads its K and V (147 MB there).  On an H100 it takes
// about three times the products' time, each warpgroup waiting on its own
// products: three score stages instead of two measured no faster, V stages
// of 32 keys and reading half a stage's fragments while the other half's
// products run measured slower (PERF.md, PR 20).

constexpr int kWideKeys = 256;          // keys of one score tile
constexpr int kWideOut = 128;           // output columns of one P·V pass, 64 a warpgroup
constexpr int kWideThreads = 3 * 128;   // two consumer warpgroups, the producer warpgroup
// setmaxnreg: the registers a block holds, 384 threads x 168, shared out as
// 128 x 56 (producer warpgroup) + 256 x 224 (consumers) = 64512, as
// pcgen_mix.cu shares them; a request beyond the block's pool would wait forever
constexpr int kWideProducerRegs = 56, kWideConsumerRegs = 224;
constexpr int kBox = 64 * kBk * 4;      // one TMA box of 64 rows x 32 fp32 (8 KB)
// bytes from the 1024-byte aligned base: P and its small part (8 boxes of 32
// keys each) over the two score stages (Q, Q's small part, 4 boxes of K);
// the two V stages (4 boxes of 32 columns); the warps' partial maxima and
// sums; the running max and sum of each query (two score tiles' worth), then
// its 1 / sum and the stored output's factor; the mbarriers
constexpr int kWideSStage = (2 + kWideKeys / 64) * kBox;
constexpr int kWidePBytes = 2 * (kWideKeys / 32) * kBox;
constexpr int kWideVStage = (kWideOut / kBk) * kBox;
constexpr int kWideVOff = kWidePBytes;
constexpr int kWideRedOff = kWideVOff + 2 * kWideVStage;
constexpr int kWideStatOff = kWideRedOff + 2 * 8 * kQt * 4;
constexpr int kWideBarOff = kWideStatOff + 3 * 2 * kQt * 4;
constexpr int kWideSmem = kWideBarOff + 11 * 8 + 1024;
static_assert(2 * kWideSStage <= kWidePBytes, "the score ring lies inside P's bytes");

// K's 3xTF32 A fragments for one 64-key m-tile of a 32-column chunk (the
// swizzled box kt, as gemm_kernel reads A), zero at columns outside
// [c_begin, c_end)
__device__ __forceinline__ void k_fragments(const float* kt, int wr, int g, int t, int c_begin, int c_end,
                                            uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int lo = (((2 * kk) ^ g) << 2) + t, hi = (((2 * kk + 1) ^ g) << 2) + t;
    const int c_lo = 8 * kk + t, c_hi = c_lo + 4;
    const bool in_lo = c_lo >= c_begin && c_lo < c_end, in_hi = c_hi >= c_begin && c_hi < c_end;
    const float x[4] = {in_lo ? kt[(wr + g) * 32 + lo] : 0.f, in_lo ? kt[(wr + g + 8) * 32 + lo] : 0.f,
                        in_hi ? kt[(wr + g) * 32 + hi] : 0.f, in_hi ? kt[(wr + g + 8) * 32 + hi] : 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      big[kk][r] = __float_as_uint(x[r]) & 0xFFFFE000u;
      small[kk][r] = tf32_small(x[r]);
    }
  }
}

// part = the 3xTF32 product of one m-tile's four k steps with Q's chunk
// (big and small parts at dq, dqs), the small products first
__device__ __forceinline__ void score_products(float (&part)[32], const uint32_t (&big)[4][4],
                                               const uint32_t (&small)[4][4], uint64_t dq, uint64_t dqs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, small[kk], dq + 2 * kk, kk > 0);  // small(K) · big(Q)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, big[kk], dqs + 2 * kk, 1);  // big(K) · small(Q)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, big[kk], dq + 2 * kk, 1);  // big(K) · big(Q)
}

// V^T's 3xTF32 A fragments for 32 keys (four 8-key steps from k step kk0)
// of a V box (64 keys x 32 columns, swizzled): rows (columns of V) c and
// c + 8; the step's k slots t and t + 4 hold keys 2t and 2t + 1 (P is stored
// in that order, wide_p_column), so the 32 lanes of a load read 32 banks
__device__ __forceinline__ void v_fragments(const float* vt, int kk0, int c, int t, uint32_t (&big)[4][4],
                                            uint32_t (&small)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r0 = 8 * (kk0 + kk) + 2 * t, r1 = r0 + 1;
    const float x[4] = {vt[r0 * 32 + (((c >> 2) ^ (r0 & 7)) << 2) + (c & 3)],
                        vt[r0 * 32 + ((((c + 8) >> 2) ^ (r0 & 7)) << 2) + (c & 3)],
                        vt[r1 * 32 + (((c >> 2) ^ (r1 & 7)) << 2) + (c & 3)],
                        vt[r1 * 32 + ((((c + 8) >> 2) ^ (r1 & 7)) << 2) + (c & 3)]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      big[kk][r] = __float_as_uint(x[r]) & 0xFFFFE000u;
      small[kk][r] = tf32_small(x[r]);
    }
  }
}

// where P stores a key of the score tile: within each 8 keys, key 2j at
// slot j and key 2j + 1 at slot j + 4, the order v_fragments reads V in
__device__ __forceinline__ int wide_p_column(int key) { return (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1); }

// part (+)= the 3xTF32 product of four 8-key steps of V^T with P's box
// (big and small parts), the small products first
__device__ __forceinline__ void pv_products(float (&part)[32], const uint32_t (&big)[4][4],
                                            const uint32_t (&small)[4][4], const float* pb, const float* ps,
                                            bool fresh) {
  const uint64_t db = desc_sw128(pb), dbs = desc_sw128(ps);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, small[kk], db + 2 * kk, !fresh || kk > 0);  // small(V) · big(P)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, big[kk], dbs + 2 * kk, 1);  // big(V) · small(P)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, big[kk], db + 2 * kk, 1);  // big(V) · big(P)
}

template <int R, int C>
__device__ __forceinline__ void fence_fragments(uint32_t (&big)[R][C], uint32_t (&small)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    fence_operands(big[r]);
    fence_operands(small[r]);
  }
}

struct WideArgs {
  CUtensorMap q, k, v;  // (rows, n_heads * hd) views at their row strides, boxes of 32 x 64, 128-byte swizzled
  float* out;
  int out_stride, t_q, t_k, hd;
  float scale;
};

__global__ void __launch_bounds__(kWideThreads, 1) attention_wide_kernel(const __grid_constant__ WideArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + kWideRedOff);    // [2][8 warps][64 queries]
  // [score tile % 2][max, sum][64 queries], then [1 / sum, the stored output's factor][64 queries]
  float* stat = reinterpret_cast<float*>(smem + kWideStatOff);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kWideBarOff);
  uint64_t *full_s = bar, *empty_s = bar + 2, *full_v = bar + 4, *empty_v = bar + 6, *p_free = bar + 8;
  uint64_t* q_ready = bar + 9;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = args.hd, q0 = blockIdx.x * kQt;
  // TMA boxes start on 16 bytes: the head's columns lie sh columns into the
  // boxes from `base`, span columns of them in all
  const int base = (blockIdx.y * hd) & ~3, sh = blockIdx.y * hd - base, span = hd + sh;
  const int q_row = blockIdx.z * args.t_q + q0, k_row = blockIdx.z * args.t_k;
  const int n_tiles = (args.t_k + kWideKeys - 1) / kWideKeys, s_chunks = (span + kBk - 1) / kBk;
  const int o_chunks = (span + kWideOut - 1) / kWideOut;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full_s[s], 1);
      mbar_init(&empty_s[s], 8);  // one arrival per consumer warp
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], 8);
      mbar_init(&q_ready[s], 3);  // one arrival per splitting warp
    }
    mbar_init(p_free, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer warpgroup: warp 8's lane 0 issues every copy; warps 9-11
    // make each Q chunk's TF32 small part (and zero its columns outside the
    // head) as it lands, fence it for the async proxy and report it on
    // q_ready, so the consumers neither split nor meet per chunk
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProducerRegs));
    if (warp > 8) {
      const int tid = threadIdx.x - 9 * 32;
      for (int st = 0, sc = 0; st < n_tiles; ++st)
        for (int c = 0; c < s_chunks; ++c, ++sc) {
          const int s = sc & 1, c_begin = sh - c * kBk, c_end = span - c * kBk;
          mbar_wait(&full_s[s], (sc >> 1) & 1);
          float4* qb = reinterpret_cast<float4*>(smem + s * kWideSStage);
          float4* qs = reinterpret_cast<float4*>(smem + s * kWideSStage + kBox);
          // float4 e of the swizzled box holds row e / 8, columns
          // 4 ((e % 8) ^ (row % 8)) .. + 3
          for (int e = tid; e < kBox / 16; e += 96) {
            const int c4 = ((e & 7) ^ ((e >> 3) & 7)) << 2;
            float4 x = qb[e];
            if (c4 < c_begin || c4 + 4 > c_end) {
              x.x = c4 >= c_begin && c4 < c_end ? x.x : 0.f;
              x.y = c4 + 1 >= c_begin && c4 + 1 < c_end ? x.y : 0.f;
              x.z = c4 + 2 >= c_begin && c4 + 2 < c_end ? x.z : 0.f;
              x.w = c4 + 3 >= c_begin && c4 + 3 < c_end ? x.w : 0.f;
              qb[e] = x;
            }
            qs[e] = make_float4(__uint_as_float(tf32_small(x.x)), __uint_as_float(tf32_small(x.y)),
                                __uint_as_float(tf32_small(x.z)), __uint_as_float(tf32_small(x.w)));
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&q_ready[s]);
        }
    } else if (lane == 0) {
      int sc = 0, vc = 0;  // score and V stage uses so far
      for (int st = 0; st < n_tiles; ++st) {
        const int key0 = st * kWideKeys, boxes = min(kWideKeys, args.t_k - key0) / 64;
        if (st > 0) mbar_wait(p_free, (st - 1) & 1);  // P of the last tile is read: its bytes take scores again
        for (int c = 0; c < s_chunks; ++c, ++sc) {
          const int s = sc & 1;
          if (sc >= 2) mbar_wait(&empty_s[s], ((sc >> 1) + 1) & 1);
          uint8_t* stg = smem + s * kWideSStage;
          mbar_expect_tx(&full_s[s], (1 + boxes) * kBox);
          tma_load_2d(stg, &args.q, &full_s[s], base + c * kBk, q_row);
          for (int i = 0; i < boxes; ++i)
            tma_load_2d(stg + (2 + i) * kBox, &args.k, &full_s[s], base + c * kBk, k_row + key0 + 64 * i);
        }
        for (int oc = 0; oc < o_chunks; ++oc)
          for (int kb = 0; kb < boxes; ++kb, ++vc) {
            const int s = vc & 1;
            if (vc >= 2) mbar_wait(&empty_v[s], ((vc >> 1) + 1) & 1);
            uint8_t* stg = smem + kWideVOff + s * kWideVStage;
            mbar_expect_tx(&full_v[s], kWideVStage);
            for (int i = 0; i < kWideOut / kBk; ++i)
              tma_load_2d(stg + i * kBox, &args.v, &full_v[s], base + oc * kWideOut + i * kBk, k_row + key0 + 64 * kb);
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsumerRegs));
    const int u = warp >> 2, wr = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
    float* pb = reinterpret_cast<float*>(smem);  // P: box k (keys 32k .. 32k + 31) at float 2048 k, rows = queries
    float* ps = pb + (kWideKeys / 32) * (kBox / 4);  // its TF32 small part
    int sc = 0, vc = 0;
    for (int st = 0; st < n_tiles; ++st) {
      const int boxes = min(kWideKeys, args.t_k - st * kWideKeys) / 64;
      // ---- 1. S^T = K · Q^T: sacc[i] is key m-tile 2u + i; the two
      // m-tiles' products go to the tensor cores back to back, each into a
      // fresh partial sum that then joins sacc in fp32
      float sacc[2][32], part0[32], part1[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sacc[0][j] = sacc[1][j] = part0[j] = part1[j] = 0.f;
      const bool mt0 = 2 * u < boxes, mt1 = 2 * u + 1 < boxes;  // this warpgroup's m-tiles in the tile
      for (int c = 0; c < s_chunks; ++c, ++sc) {
        const int s = sc & 1, c_begin = sh - c * kBk, c_end = span - c * kBk;  // the head's columns in the chunk
        mbar_wait(&full_s[s], (sc >> 1) & 1);
        mbar_wait(&q_ready[s], (sc >> 1) & 1);  // Q's small part is in
        const uint8_t* stg = smem + s * kWideSStage;
        const uint64_t dq = desc_sw128(stg), dqs = desc_sw128(stg + kBox);
        const float* kt = reinterpret_cast<const float*>(stg + (2 + 2 * u) * kBox);
        uint32_t k0_big[4][4], k0_small[4][4], k1_big[4][4], k1_small[4][4];
        if (mt0) {
          k_fragments(kt, wr, g, t, c_begin, c_end, k0_big, k0_small);
          wgmma_fence();
          score_products(part0, k0_big, k0_small, dq, dqs);
          wgmma_commit();
        }
        if (mt1) {
          k_fragments(kt + kBox / 4, wr, g, t, c_begin, c_end, k1_big, k1_small);
          wgmma_fence();
          score_products(part1, k1_big, k1_small, dq, dqs);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        if (mt0) {
          fence_operands(part0);
#pragma unroll
          for (int j = 0; j < 32; ++j) sacc[0][j] += part0[j];
        }
        wgmma_wait<0>();
        if (mt1) {
          fence_operands(part1);
#pragma unroll
          for (int j = 0; j < 32; ++j) sacc[1][j] += part1[j];
        }
        fence_fragments(k0_big, k0_small);
        fence_fragments(k1_big, k1_small);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_s[s]);
      }

      // ---- 2. softmax down each column: lane (g, t) holds queries 8j + 2t + e
      // (x[2j + e]) at keys wr + g + 8h of each of its m-tiles
      const float* old = stat + ((st + 1) & 1) * 2 * kQt;  // the running max and sum after the last tile
      float* now = stat + (st & 1) * 2 * kQt;
      float mx[16], m_new[16], corr[16], sum[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        mx[x] = -INFINITY;
        sum[x] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (2 * u + i < boxes)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) mx[2 * j + (x & 1)] = fmaxf(mx[2 * j + (x & 1)], sacc[i][4 * j + x]);
#pragma unroll
      for (int x = 0; x < 16; ++x)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], o));
      if (g == 0)
#pragma unroll
        for (int x = 0; x < 16; ++x) red[warp * kQt + 8 * (x >> 1) + 2 * t + (x & 1)] = mx[x];
      named_barrier(1, 256);  // every warp's maxima are in, and every product of step 1 is done
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int q = 8 * (x >> 1) + 2 * t + (x & 1);
        float m = red[q];
#pragma unroll
        for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w * kQt + q]);
        const float m_old = st > 0 ? old[q] : -INFINITY;
        m_new[x] = fmaxf(m_old, m);
        corr[x] = expf((m_old - m_new[x]) * args.scale);
      }
      // P and its small part over the score ring (every stage read: the barrier
      // above), in 32-key boxes of 64 query rows, swizzled as TMA would write them
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (2 * u + i < boxes)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int key = 64 * (2 * u + i) + wr + g + 8 * (x >> 1), q = 8 * j + 2 * t + (x & 1);
              const float p = expf((sacc[i][4 * j + x] - m_new[2 * j + (x & 1)]) * args.scale);
              sum[2 * j + (x & 1)] += p;
              const int kp = wide_p_column(key);
              const int at = (kp >> 5) * (kBox / 4) + q * 32 + ((((kp & 31) >> 2) ^ (q & 7)) << 2) + (kp & 3);
              pb[at] = p;
              ps[at] = __uint_as_float(tf32_small(p));
            }
#pragma unroll
      for (int x = 0; x < 16; ++x)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], o);
      if (g == 0)
#pragma unroll
        for (int x = 0; x < 16; ++x) red[(8 + warp) * kQt + 8 * (x >> 1) + 2 * t + (x & 1)] = sum[x];
      fence_proxy_async();   // P's writes before the tensor cores read them
      named_barrier(1, 256);
      // 1 / l_new and l_old * corr / l_new (the stored output's factor) of
      // each query, the same in every warp, through shared memory for the
      // output's epilogue: in registers they would crowd out the products'
      float* fin = stat + 4 * kQt;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int q = 8 * (x >> 1) + 2 * t + (x & 1);
        float l = red[8 * kQt + q];
#pragma unroll
        for (int w = 1; w < 8; ++w) l += red[(8 + w) * kQt + q];
        const float l_old = st > 0 ? old[kQt + q] : 0.f;
        l += l_old * corr[x];
        if (g == 0) {
          fin[q] = 1.f / l;
          fin[kQt + q] = l_old * corr[x] / l;
          if (warp == 0) {
            now[q] = m_new[x];
            now[kQt + q] = l;
          }
        }
      }
      __syncwarp();

      // ---- 3. O^T = V^T · P^T, 128 output columns at a time, 64 keys (a V
      // stage) at a time (reading the second half's fragments while the first
      // half's products run measured 13% slower on an H100 than reading all
      // before the products)
      const float* vbox = reinterpret_cast<const float*>(smem + kWideVOff) + (2 * u + (wr >> 5)) * (kBox / 4);
      const int vcol = (wr & 31) + g, n_v = o_chunks * boxes;
      float oacc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) oacc[j] = 0.f;
      for (int i = 0; i < n_v; ++i) {
        const int oc = i / boxes, kb = i - oc * boxes, s = (vc + i) & 1;
        const int col0 = oc * kWideOut + 64 * u;  // this warpgroup's first column from `base`
        const bool live = col0 < span;
        mbar_wait(&full_v[s], ((vc + i) >> 1) & 1);
        if (live) {
          const float* vt = vbox + s * (kWideVStage / 4);
          uint32_t va_big[4][4], va_small[4][4], vb_big[4][4], vb_small[4][4];
          v_fragments(vt, 0, vcol, t, va_big, va_small);
          v_fragments(vt, 4, vcol, t, vb_big, vb_small);
          wgmma_fence();
          pv_products(part0, va_big, va_small, pb + 2 * kb * (kBox / 4), ps + 2 * kb * (kBox / 4), true);
          pv_products(part0, vb_big, vb_small, pb + (2 * kb + 1) * (kBox / 4), ps + (2 * kb + 1) * (kBox / 4),
                      false);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(part0);
          fence_fragments(va_big, va_small);
          fence_fragments(vb_big, vb_small);
#pragma unroll
          for (int j = 0; j < 32; ++j) oacc[j] += part0[j];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_v[s]);
        if (kb == boxes - 1) {
          if (live) {
            // lane (g, t) holds columns col0 + wr + g + 8h at queries 8j + 2t + e
            float* ob = args.out + (size_t)q_row * args.out_stride + base;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int col = col0 + wr + g + 8 * (x >> 1), q = 8 * j + 2 * t + (x & 1);
                if (col >= sh && col < span) {
                  float* dst = ob + (size_t)q * args.out_stride + col;
                  const float o = oacc[4 * j + x] * fin[q];
                  *dst = st > 0 ? *dst * fin[kQt + q] + o : o;
                }
              }
          }
#pragma unroll
          for (int j = 0; j < 32; ++j) oacc[j] = 0.f;
        }
      }
      vc += n_v;
      __syncwarp();
      if (lane == 0) mbar_arrive(p_free);
    }
  }
}

// ------------------------------------------------------ host: GEMM launch

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// a (rows, cols) fp32 matrix at row stride `stride` (floats) in boxes of 32
// columns x box_rows rows, 128-byte swizzled; columns past `cols` read as zero
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const float* ptr, int rows, int cols, long long stride,
                 int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kBk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (rows, cols) row-major fp32 matrix in boxes of 32 columns x box_rows rows,
// 128-byte swizzled
bool encode(EncodeTiled fn, CUtensorMap* map, const float* ptr, int rows, int cols, int box_rows) {
  return encode_rows(fn, map, ptr, rows, cols, cols, box_rows);
}

// a (rows, cols) row-major bf16 matrix in boxes of 32 columns x box_rows rows,
// 64-byte swizzled: the K-major B tile wgmma reads as TMA writes it
bool encode_bf16(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ops: the groups' weights, then (fp32 weights only) their small parts, then
// the biases, then the outputs; gemm_kernel for fp32 weights, gemm_bf16w_kernel
// for bf16 ones
template <int kWg, int kBn, bool kBf16W>
int launch_gemm(const float* a, int groups, const void* const* ops, const float* res, int M, int N, int K,
                int res_rows, int gelu, cudaStream_t stream) {
  constexpr int smem = kBf16W ? Bf16Stage<kWg, kBn>::smem : GemmStage<kWg, kBn>::smem;
  const void* kernel = kBf16W ? (const void*)gemm_bf16w_kernel<kWg, kBn> : (const void*)gemm_kernel<kWg, kBn>;
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem(kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  GemmArgs args = {};
  bool ok = encode(fn, &args.a, a, M, K, 64 * kWg);
  const int per = kBf16W ? 3 : 4;  // pointers of one group in ops
  for (int i = 0; i < groups; ++i) {
    if (kBf16W)
      ok = ok && encode_bf16(fn, &args.wt[i], ops[i], N, K, kBn);
    else
      ok = ok && encode(fn, &args.wt[i], static_cast<const float*>(ops[i]), N, K, kBn) &&
           encode(fn, &args.wt_small[i], static_cast<const float*>(ops[groups + i]), N, K, kBn);
    args.bias[i] = static_cast<const float*>(ops[(per - 2) * groups + i]);
    args.out[i] = static_cast<float*>(const_cast<void*>(ops[(per - 1) * groups + i]));
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  args.res = res;
  args.N = N;
  args.res_rows = res_rows;
  args.gelu = gelu;
  args.k_tiles = K / kBk;
  args.n_tiles = N / kBn;
  const dim3 grid(groups * (N / kBn), M / (64 * kWg));
  if constexpr (kBf16W)
    gemm_bf16w_kernel<kWg, kBn><<<grid, kWg * 128 + 32, smem, stream>>>(args);
  else
    gemm_kernel<kWg, kBn><<<grid, kWg * 128 + 32, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// the tile: 128x128 where that gives the 132 SMs a full wave, else 128x64,
// else 64x64 (warpgroups, columns)
void gemm_tile(int M, int N, int groups, int* wg, int* bn) {
  const long long row_tiles = (long long)groups * (M / 128);
  *wg = 1;
  *bn = 64;
  if (M % 128 == 0 && N % 128 == 0 && row_tiles * (N / 128) >= 132) {
    *wg = 2;
    *bn = 128;
  } else if (M % 128 == 0 && row_tiles * (N / 64) >= 132) {
    *wg = 2;
  }
}

// the guard both instances share, then the tile
template <bool kBf16W>
int gemm(const float* a, int groups, const void* const* ops, const float* res, int M, int N, int K, int res_rows,
         int gelu, cudaStream_t stream) {
  bool ok = groups >= 1 && groups <= kMaxGroups && M % 64 == 0 && N % 64 == 0 && K % kBk == 0 && M > 0 && N > 0 &&
            K > 0 && aligned16(a) && (!res || res_rows > 0);
  for (int i = 0; ok && i < (kBf16W ? 1 : 2) * groups; ++i) ok = aligned16(ops[i]);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (!res) res_rows = M;
  int wg, bn;
  gemm_tile(M, N, groups, &wg, &bn);
  if (bn == 128) return launch_gemm<2, 128, kBf16W>(a, groups, ops, res, M, N, K, res_rows, gelu, stream);
  if (wg == 2) return launch_gemm<2, 64, kBf16W>(a, groups, ops, res, M, N, K, res_rows, gelu, stream);
  return launch_gemm<1, 64, kBf16W>(a, groups, ops, res, M, N, K, res_rows, gelu, stream);
}

template <int kHd, bool kPad>
int launch_attention(const float* q, int q_stride, const float* k, const float* v, int kv_stride, float* out,
                     int out_stride, int batch, int t_q, int t_k, int n_heads, int head_dim, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = AttnShape<kHd>::smem;
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)attention_kernel<kHd, kPad>, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  attention_kernel<kHd, kPad><<<dim3(t_q / kQt, n_heads, batch), 128, smem, stream>>>(
      q, q_stride, k, v, kv_stride, out, out_stride, t_q, t_k, head_dim, scale);
  return (int)cudaGetLastError();
}

int launch_attention_wide(const float* q, int q_stride, const float* k, const float* v, int kv_stride, float* out,
                          int out_stride, int batch, int t_q, int t_k, int n_heads, int head_dim, float scale,
                          cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || n_heads > 65535) return (int)cudaErrorInvalidValue;
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)attention_wide_kernel, kWideSmem);
  if (attr != cudaSuccess) return (int)attr;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  WideArgs args = {};
  const int cols = n_heads * head_dim;
  if (!encode_rows(fn, &args.q, q, batch * t_q, cols, q_stride, kQt) ||
      !encode_rows(fn, &args.k, k, batch * t_k, cols, kv_stride, 64) ||
      !encode_rows(fn, &args.v, v, batch * t_k, cols, kv_stride, 64))
    return (int)cudaErrorInvalidValue;
  args.out = out;
  args.out_stride = out_stride;
  args.t_q = t_q;
  args.t_k = t_k;
  args.hd = head_dim;
  args.scale = scale;
  attention_wide_kernel<<<dim3(t_q / kQt, n_heads, batch), kWideThreads, kWideSmem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// out_g = a · wt_gᵀ + bias_g [GELU] + res[row % res_rows] for g < groups (1 to
// 3).  ops is a host array of 4 * groups device pointers: wt_g (N, K), then
// wt_small_g, the TF32 small parts of wt_g (pccf_tf32_split), then bias_g
// (may be null), then out_g (M, N).
extern "C" int pccf_gemm(const float* a, int groups, const void* const* ops, const float* res, int M, int N, int K,
                         int res_rows, int gelu, cudaStream_t stream) {
  return gemm<false>(a, groups, ops, res, M, N, K, res_rows, gelu, stream);
}

// the same with bf16 weights: ops is a host array of 3 * groups device
// pointers, wt_g (N, K) bf16, then bias_g (fp32, may be null), then out_g (M, N)
extern "C" int pccf_gemm_bf16w(const float* a, int groups, const void* const* ops, const float* res, int M, int N,
                               int K, int res_rows, int gelu, cudaStream_t stream) {
  return gemm<true>(a, groups, ops, res, M, N, K, res_rows, gelu, stream);
}

// the tile both GEMM instances take at (M, N, groups) and its shared memory:
// out = {warpgroups (64 rows each), columns, ring stages, bytes}
// (pccf_torch.kernels.wformer.gemm_plan)
extern "C" int pccf_gemm_plan(int M, int N, int groups, int bf16, int* out) {
  int wg, bn;
  gemm_tile(M, N, groups, &wg, &bn);
  out[0] = wg;
  out[1] = bn;
  out[2] = bf16 ? kBf16Stages : kStages;
  if (bf16)
    out[3] = bn == 128 ? Bf16Stage<2, 128>::smem : wg == 2 ? Bf16Stage<2, 64>::smem : Bf16Stage<1, 64>::smem;
  else
    out[3] = bn == 128 ? GemmStage<2, 128>::smem : wg == 2 ? GemmStage<2, 64>::smem : GemmStage<1, 64>::smem;
  return 0;
}

// the wide attention's plan for t_k keys and heads of head_dim (past 128):
// out = {score tiles, 32-column score chunks, 128-column output chunks (of a
// head that starts on 16 bytes; one more of each where the shift sh needs
// it), shared-memory bytes} (pccf_torch.kernels.wformer.wide_plan)
extern "C" int pccf_attention_wide_plan(int t_k, int head_dim, int* out) {
  if (head_dim <= 128 || t_k <= 0 || t_k % kKt) return (int)cudaErrorInvalidValue;
  out[0] = (t_k + kWideKeys - 1) / kWideKeys;
  out[1] = (head_dim + kBk - 1) / kBk;
  out[2] = (head_dim + kWideOut - 1) / kWideOut;
  out[3] = kWideSmem;
  return 0;
}

// dst_i[j] = the TF32 small part of src_i[j], j < n_i, for i < count
extern "C" int pccf_tf32_split(const float* const* src, float* const* dst, const long long* n, int count,
                               cudaStream_t stream) {
  for (int i0 = 0; i0 < count; i0 += kMaxSplit) {
    SplitArgs args = {};
    const int c = count - i0 < kMaxSplit ? count - i0 : kMaxSplit;
    for (int i = 0; i < c; ++i) {
      args.src[i] = src[i0 + i];
      args.dst[i] = dst[i0 + i];
      args.n[i] = n[i0 + i];
    }
    tf32_split_kernel<<<dim3(64, c), 256, 0, stream>>>(args);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
  if (head_dim < 1 || t_q % kQt || t_k % kKt || t_k <= 0 || q_stride % 4 || kv_stride % 4 ||
      out_stride % 2 || n_heads < 1 || (long long)n_heads * head_dim > q_stride ||
      (long long)n_heads * head_dim > kv_stride || (long long)n_heads * head_dim > out_stride)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)head_dim);
  if (head_dim == 64) return launch_attention<64, false>(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q,
                                                         t_k, n_heads, head_dim, scale, stream);
  if (head_dim == 16) return launch_attention<16, false>(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q,
                                                         t_k, n_heads, head_dim, scale, stream);
  if (head_dim == 32) return launch_attention<32, false>(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q,
                                                         t_k, n_heads, head_dim, scale, stream);
  if (head_dim == 128) return launch_attention<128, false>(q, q_stride, k, v, kv_stride, out, out_stride, batch,
                                                           t_q, t_k, n_heads, head_dim, scale, stream);
  if (head_dim < 16) return launch_attention<16, true>(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q,
                                                       t_k, n_heads, head_dim, scale, stream);
  if (head_dim < 32) return launch_attention<32, true>(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q,
                                                       t_k, n_heads, head_dim, scale, stream);
  if (head_dim < 64) return launch_attention<64, true>(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q,
                                                       t_k, n_heads, head_dim, scale, stream);
  if (head_dim < 128) return launch_attention<128, true>(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q,
                                                         t_k, n_heads, head_dim, scale, stream);
  return launch_attention_wide(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q, t_k, n_heads, head_dim,
                               scale, stream);
}
