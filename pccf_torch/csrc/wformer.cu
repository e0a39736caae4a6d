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
// The bf16-weight instance (pccf_gemm_bf16w, the same kernel with kBf16W):
// the server's bf16 cast keeps the stacks' projection and FF weights in
// bfloat16 (pccf/serve.py:216-220 _cast), and the product is float32
// arithmetic on those rounded weights, as JAX computes it (an f32 activation
// times a bf16 parameter promotes to f32).  The producer loads each weight
// tile as bf16 by TMA (32 x BN, 64-byte rows, unswizzled), half the bytes of
// the fp32 weight and a quarter of the fp32 weight and its small part; the
// consumer warpgroups widen it into the 128-byte-swizzled fp32 tile the
// tensor cores read (a bf16 value is the top 16 bits of its fp32 word), fence
// the generic-proxy writes for the async proxy and meet at a named barrier
// before the products.  A bf16 value has 8 significant bits and TF32 11, so
// the widened tile is its own TF32 big part with no small part: the 3xTF32
// product needs two MMAs, small(A)·B + big(A)·B, not three.
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
  CUtensorMap wt[kMaxGroups];        // Wt_g (N, K), boxes of 32 x BN, fp32 or (kBf16W) bf16
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
// and B's TF32 small part (fp32 weights) or the bf16 tile TMA loads (kBf16W)
template <int kWg, int kBn, bool kBf16W>
struct GemmStage {
  static constexpr int a = 64 * kWg * kBk * 4, b = kBn * kBk * 4, b2 = kBf16W ? kBn * kBk * 2 : b;
  static constexpr int bytes = a + b + b2;
  static constexpr int loaded = a + b2 + (kBf16W ? 0 : b);  // what TMA writes
  static constexpr int smem = kStages * bytes + 1024 + 2 * kStages * 8;
};

// widen the staged bf16 tile (kBn rows of 32, 64-byte rows) into the
// swizzled fp32 tile: 8 values a thread at a time, row r's columns 8 c8 .. 8 c8
// + 7 to the 16-byte chunks 2 c8 and 2 c8 + 1 of the row, each at chunk index
// ^ (r % 8) as TMA's 128-byte swizzle places them
template <int kBn, int kThreads>
__device__ __forceinline__ void widen_bf16_tile(float* dst, const uint4* src, int tid) {
#pragma unroll
  for (int e = tid; e < kBn * 4; e += kThreads) {
    const int r = e >> 2, c8 = e & 3;
    const uint4 v = src[e];  // little-endian: the low half of each word is the earlier column
    const float4 lo = make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                                  __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
    const float4 hi = make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xFFFF0000u),
                                  __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xFFFF0000u));
    *reinterpret_cast<float4*>(dst + r * 32 + (((2 * c8) ^ (r & 7)) << 2)) = lo;
    *reinterpret_cast<float4*>(dst + r * 32 + (((2 * c8 + 1) ^ (r & 7)) << 2)) = hi;
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kWg, int kBn, bool kBf16W>
__global__ void __launch_bounds__(kWg * 128 + 32, 1) gemm_kernel(const __grid_constant__ GemmArgs args) {
  using S = GemmStage<kWg, kBn, kBf16W>;
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
        mbar_expect_tx(&full[s], S::loaded);
        tma_load_2d(st, &args.a, &full[s], kt * kBk, m0);
        if constexpr (kBf16W) {
          tma_load_2d(st + kABytes + kBBytes, &args.wt[group], &full[s], kt * kBk, n0);
        } else {
          tma_load_2d(st + kABytes, &args.wt[group], &full[s], kt * kBk, n0);
          tma_load_2d(st + kABytes + kBBytes, &args.wt_small[group], &full[s], kt * kBk, n0);
        }
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
    if constexpr (kBf16W) {
      // every consumer thread widens its share of the tile; the fence orders
      // its writes before the tensor cores' reads, the barrier waits for all
      widen_bf16_tile<kBn, kWg * 128>(reinterpret_cast<float*>(const_cast<uint8_t*>(st + kABytes)),
                                      reinterpret_cast<const uint4*>(st + kABytes + kBBytes), threadIdx.x);
      fence_proxy_async();
      named_barrier(1, kWg * 128);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, a_small[kk], db + 2 * kk, kk > 0);  // small(A) · big(B)
    if constexpr (!kBf16W) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(part, a_big[kk], dbs + 2 * kk, 1);  // big(A) · small(B)
    }
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
// or 1 heads).  The head's columns split into chunks of kWideChunk = 128, the
// last one padded with zero columns.  A block (64 queries of one (batch,
// head), 4 warps x 16 queries, as above) produces one 128-column chunk of
// the output: for every key tile it sums the scores over the head's chunks
// (each a query chunk and a key chunk staged in shared memory, the queries
// split into 3xTF32 fragments as the 128 instance does), updates the online
// softmax, and adds P · V for its chunk's columns of V.  So a head of c
// chunks computes its scores c times, once in each of its c blocks: a simple
// kernel, right at every width, whose time PERF.md records.

constexpr int kWideChunk = 128, kWideLd = kWideChunk + 4, kWideTile = kKt * kWideLd;

// 64 rows x cw floats at src (row stride `stride`) into dst (stride
// kWideLd), the columns cw .. 127 zero; 16-byte copies where vec (every row
// and the chunk start 16-byte aligned, cw a multiple of 4), else scalar loads
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, int stride, int cw, bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < kKt * (kWideChunk / 4); e += 128) {
      const int r = e / (kWideChunk / 4), c4 = e % (kWideChunk / 4) * 4;
      if (c4 < cw)
        cp_async16(dst + r * kWideLd + c4, src + (size_t)r * stride + c4);
      else
        *reinterpret_cast<float4*>(dst + r * kWideLd + c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < kKt * kWideChunk; e += 128) {
      const int r = e / kWideChunk, c = e % kWideChunk;
      dst[r * kWideLd + c] = c < cw ? src[(size_t)r * stride + c] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(128, 1)
    attention_wide_kernel(const float* __restrict__ q, int q_stride, const float* __restrict__ k,
                          const float* __restrict__ v, int kv_stride, float* __restrict__ out, int out_stride, int t_q,
                          int t_k, int hd, float scale) {
  constexpr int kSteps = kWideChunk / 8;
  extern __shared__ float smem[];
  float* qs = smem;                // [64][kWideLd]
  float* ks = smem + kWideTile;    // [64][kWideLd]
  float* vs = smem + 2 * kWideTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int chunks = (hd + kWideChunk - 1) / kWideChunk, n_tiles = t_k / kKt;
  const int q0 = blockIdx.x * kQt, h = blockIdx.y / chunks, oc = blockIdx.y % chunks, b = blockIdx.z;
  const int head = h * hd;
  const bool vec = hd % 4 == 0;
  const float* qb = q + ((size_t)b * t_q + q0) * q_stride + head;
  const float* kb = k + (size_t)b * t_k * kv_stride + head;
  const float* vb = v + (size_t)b * t_k * kv_stride + head;

  {
    float o[kSteps][4];
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
      // S = (q · scale) K^T summed over the head's chunks
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      for (int qc = 0; qc < chunks; ++qc) {
        const int cw = min(kWideChunk, hd - qc * kWideChunk);
        __syncthreads();  // every warp is done with the staged chunks
        stage_chunk(qs, qb + qc * kWideChunk, q_stride, cw, vec, tid);
        stage_chunk(ks, kb + (size_t)j * kKt * kv_stride + qc * kWideChunk, kv_stride, cw, vec, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t qf_big[4], qf_small[4];
          q_fragment<kWideChunk>(qs, wr, g, t, kk, scale, qf_big, qf_small);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float* kr = ks + (nt * 8 + g) * kWideLd + 8 * kk + t;
            uint32_t bb[2], bs[2];
            split_tf32(kr[0], bb[0], bs[0]);
            split_tf32(kr[4], bb[1], bs[1]);
            mma_3xtf32(s[nt], qf_big, qf_small, bb, bs);
          }
        }
      }
      // online softmax, as in attention_kernel
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
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          s[nt][2 * half] = expf(s[nt][2 * half] - m_new);
          s[nt][2 * half + 1] = expf(s[nt][2 * half + 1] - m_new);
          sum += s[nt][2 * half] + s[nt][2 * half + 1];
        }
#pragma unroll
        for (int nt = 0; nt < kSteps; ++nt) {
          o[nt][2 * half] *= corr;
          o[nt][2 * half + 1] *= corr;
        }
        l_run[half] = l_run[half] * corr + sum;
        m_run[half] = m_new;
      }
      // O += P · V for the output chunk's columns
      stage_chunk(vs, vb + (size_t)j * kKt * kv_stride + oc * kWideChunk, kv_stride,
                  min(kWideChunk, hd - oc * kWideChunk), vec, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t p_big[4], p_small[4];
        split_tf32(s[kk][0], p_big[0], p_small[0]);
        split_tf32(s[kk][2], p_big[1], p_small[1]);
        split_tf32(s[kk][1], p_big[2], p_small[2]);
        split_tf32(s[kk][3], p_big[3], p_small[3]);
        const float* v0 = vs + (8 * kk + 2 * t) * kWideLd + g;
#pragma unroll
        for (int nt = 0; nt < kSteps; ++nt) {
          uint32_t bb[2], bs[2];
          split_tf32(v0[nt * 8], bb[0], bs[0]);
          split_tf32(v0[kWideLd + nt * 8], bb[1], bs[1]);
          mma_3xtf32(o[nt], p_big, p_small, bb, bs);
        }
      }
      __syncthreads();  // V is read before the next tile's chunks land
    }
    float* ob = out + ((size_t)b * t_q + q0 + wr) * out_stride + head + oc * kWideChunk;
    const int cw = min(kWideChunk, hd - oc * kWideChunk);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = l_run[half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
#pragma unroll
      for (int nt = 0; nt < kSteps; ++nt) {
        float* dst = ob + (size_t)(g + half * 8) * out_stride + nt * 8 + 2 * t;
        const int c = nt * 8 + 2 * t;
        if (c < cw) dst[0] = o[nt][2 * half] * inv;
        if (c + 1 < cw) dst[1] = o[nt][2 * half + 1] * inv;
      }
    }
  }
}

// ------------------------------------------------------ host: GEMM launch

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// a (rows, cols) row-major fp32 matrix in boxes of 32 columns x box_rows rows,
// 128-byte swizzled
bool encode(EncodeTiled fn, CUtensorMap* map, const float* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kBk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (rows, cols) row-major bf16 matrix in boxes of 32 columns x box_rows rows,
// unswizzled (64-byte rows: the consumers swizzle as they widen)
bool encode_bf16(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ops: the groups' weights, then (fp32 weights only) their small parts, then
// the biases, then the outputs
template <int kWg, int kBn, bool kBf16W>
int launch_gemm(const float* a, int groups, const void* const* ops, const float* res, int M, int N, int K,
                int res_rows, int gelu, cudaStream_t stream) {
  constexpr int smem = GemmStage<kWg, kBn, kBf16W>::smem;
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)gemm_kernel<kWg, kBn, kBf16W>, smem);
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
  gemm_kernel<kWg, kBn, kBf16W><<<dim3(groups * (N / kBn), M / (64 * kWg)), kWg * 128 + 32, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// the guard both instances share and the tile choice: 128x128 where that
// gives the 132 SMs a full wave, else 128x64, else 64x64
template <bool kBf16W>
int gemm(const float* a, int groups, const void* const* ops, const float* res, int M, int N, int K, int res_rows,
         int gelu, cudaStream_t stream) {
  bool ok = groups >= 1 && groups <= kMaxGroups && M % 64 == 0 && N % 64 == 0 && K % kBk == 0 && M > 0 && N > 0 &&
            K > 0 && aligned16(a) && (!res || res_rows > 0);
  for (int i = 0; ok && i < (kBf16W ? 1 : 2) * groups; ++i) ok = aligned16(ops[i]);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (!res) res_rows = M;
  const long long row_tiles = (long long)groups * (M / 128);
  if (M % 128 == 0 && N % 128 == 0 && row_tiles * (N / 128) >= 132)
    return launch_gemm<2, 128, kBf16W>(a, groups, ops, res, M, N, K, res_rows, gelu, stream);
  if (M % 128 == 0 && row_tiles * (N / 64) >= 132)
    return launch_gemm<2, 64, kBf16W>(a, groups, ops, res, M, N, K, res_rows, gelu, stream);
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
  constexpr int smem = 3 * kWideTile * sizeof(float);
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)attention_wide_kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int chunks = (head_dim + kWideChunk - 1) / kWideChunk;
  attention_wide_kernel<<<dim3(t_q / kQt, n_heads * chunks, batch), 128, smem, stream>>>(
      q, q_stride, k, v, kv_stride, out, out_stride, t_q, t_k, head_dim, scale);
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
  if ((long long)n_heads * ((head_dim + kWideChunk - 1) / kWideChunk) > 65535) return (int)cudaErrorInvalidValue;
  return launch_attention_wide(q, q_stride, k, v, kv_stride, out, out_stride, batch, t_q, t_k, n_heads, head_dim,
                               scale, stream);
}
