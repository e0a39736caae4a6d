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
// Partial mode (pccf_pcgen_mix_partial, the expert-parallel decode of
// pccf_torch/nn/decoders.py): the block runs the G_l components a rank holds
// of the G_t a decoder has, att_w being (G_t, G_l * D3), the columns of
// those components.  A mix thread writes its point's partial logits
// Σ_{g local} h2_g · att_w[:, g] (+ att_b, which the wrapper zeroes on all
// ranks but one), (B, N, G_t), and its local head outputs (B, N, G_l, 3),
// in place of the softmax: the wrapper sums the logits over the ranks, takes
// the tempered softmax and mixes.
//
// What bounds it: ~0.69 TFLOP per batch of 16 clouds of 2048 points at the
// flagship widths (D0 = D1 = 1024, D2 = 256, D3 = 16, G = 8) against the
// fp16 tensor-core peak (the bf16 one), and the component weights (21 MB in
// fp16), which every block of 64 points reads from L2: 10.8 GB per batch of
// 16.  Nothing but the (B, N, 3) result leaves the chip.
//
// Design: a block owns 64 points of one cloud (rows past N are zero and not
// stored), one wgmma row tile.  The joined latent x stays in shared memory in
// fp16 (128 KB at D0 = 1024) as the A operand of layer 0.  One producer warp
// streams every weight tile the block needs, in the order the consumers use
// them, by TMA into a ring of mbarrier stages (D2 rows x 64 columns of fp16,
// 128-byte swizzled).  Two consumer warpgroups split every product's columns
// and issue wgmma.m64nNk16 on fp16 with A and B from shared memory.  Layer 0
// is produced D2 columns at a time (the chunk), activated, given its
// residual, written to shared memory in fp16 and multiplied at once into
// layer 1's accumulators, which stay in registers; the chunks run last to
// first, so the last one written to shared memory is h0[:, :D2], layer 1's
// residual.  Layer 2 (n16) runs on warpgroup 0, which hands h2 to two mix
// warps of the producer warpgroup through shared memory: they keep each
// point's head outputs and mix logits (fp32, on the CUDA cores) across the
// components and end the block with the tempered-softmax mix.
//
// Registers: each consumer thread holds two accumulator sets, 128 registers at
// D2 = 256, through layer 0; everything else is kept out of them (the mix
// state in the mix warps, the residual in shared memory but for the 16 columns
// that reach the output, the first k step of a product writing its
// accumulators without reading them), so that nothing spills to local memory,
// which with 227 KB of shared memory in use has almost no L1 left and goes to
// L2.  setmaxnreg moves registers from the producer warpgroup to the consumers.
//
// Precision: the TPU kernel rounds the weights and every product's input to
// bf16 (pallas_pcgen.py:110, :121, :124, :126).  Here they are rounded to
// fp16, whose 10-bit mantissa is TF32's, in the same places for the three
// component layers (the join x, h before each later layer; the layer-0
// residual reads the fp16 join, layer 1's reads h0 in fp16 but for the 16
// columns that reach h2), and the heads and the mix logits are fp32 on the
// CUDA cores: with bf16 everywhere the decode missed the CPU's by more than
// chip_smoke.py's RECON_REL_L2 allows (on an H100; PERF.md).  fp16 has bf16's
// speed on the tensor cores and half TF32's shared memory, but not bf16's
// range: a value past 65504 becomes inf.  The wrapper refuses folded weights
// past it.  The activations keep fp32's range by a power-of-two scale per
// cloud on each fp16 operand (x, h0, h1): a block bounds |x| by max |w| of
// its cloud (hardtanh <= 1), |h0| by |x| (1 + A0) + B0 and |h1| by
// |h0| (1 + A1) + B1, where A is the largest absolute row sum of a layer's
// fp16 weights and B its largest bias (the wrapper's bounds; a (leaky) ReLU
// never grows a value), and halves the scale from 1 until the bound fits
// under 65504.  The operand is stored times its scale; the product's fp32
// accumulator and the fp16 residual reads are multiplied back by its
// inverse.  Both are exact (powers of two), so a scale of 1, which
// chip_smoke.py's random flagship weights give, leaves every bit as it was.
// The scales cost the consumers registers: ptxas reports more spill bytes
// in the epilogues, and the kernel runs longer at the flagship widths
// (PERF.md §6).
// Values below fp16's normal range (6.1e-5) after scaling keep an absolute
// error under 2^-25 of the inverse scale.
// Accumulation, the residual stream, the softmax and the mix are fp32; the
// map head is fp32 on the CUDA cores.

#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"
#include "hopper.cuh"

namespace {

using namespace pccf;

constexpr int kRows = 64;  // points per block
constexpr int kConsumers = 2;
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup (one lane issues the copies)
// setmaxnreg: the registers a block holds, 384 threads x 168, shared out as
// 128 x 56 (producer warpgroup) + 256 x 224 (consumers) = 64512; a request
// beyond the block's pool would wait forever
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kTileBytes = kRows * 128;          // one 64 x 64 fp16 operand tile
constexpr int kMaxD0 = 1024, kD3 = 16, kMaxDm = 64, kMaxG = 8, kMaxStages = 4;
constexpr int kSmemMax = 232448;
constexpr float kFp16Max = 65504.f;
// the mix warps: the producer warpgroup's second and third, a point a thread
constexpr int kMixWarp0 = kConsumerThreads / 32 + 1;
constexpr int kMixSync = 128 + kRows;                 // warpgroup 0 and the mix warps
// named barriers (0 is __syncthreads): the consumer warpgroups; h2 written
// for the mix warps; h2 read by them
constexpr int kBarConsumers = 1, kBarMixFull = 2, kBarMixEmpty = 3;

__device__ __forceinline__ float act(float v, float slope) { return v >= 0.f ? v : slope * v; }

template <bool kValue>
struct Flag {
  static constexpr bool value = kValue;
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// byte offset of fp16 element (r, c) of a 64-row operand held as tiles of 64
// columns, 128-byte swizzled as TMA writes and wgmma reads them
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return (uint32_t)((c >> 6) * kTileBytes + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

struct Args {
  CUtensorMap w0, w1, w2;  // fp16 (G * D1, D0), (G * D2, D1), (G * D3, D2), boxes of 64 columns
  const float* m;          // (B, N, Dm)
  const float* w;          // (B, D0)
  const float* map_wt;     // (Dm, D0)
  const float* map_b;      // (D0)
  const float* b0;         // (G, D1)
  const float* b1;         // (G, D2)
  const float* b2;         // (G, D3)
  const float* head_w;     // (G, 3, D3)
  const float* head_b;     // (G, 3)
  const float* att_w;      // (G, G * D3)
  const float* att_b;      // (G)
  float* out;              // (B, N, 3)
  float* part_logits;      // partial mode: (B, N, G_t), else null
  float* part_heads;       // partial mode: (B, N, G_l, 3)
  int n, dm, d0, d1, g_count, g_total, stages;
  float inv_tau, slope;
  float a0, c0, a1, c1;  // layers 0 and 1: largest absolute weight row sum, largest |bias|
};

// the power-of-two scales of a cloud's fp16 operands and their inverses
struct Scales {
  float x, ix, h0, ih0, h1, ih1;
};

// the largest power of two <= 1 that keeps bound * s within fp16's range
__device__ __forceinline__ float fp16_scale(float bound) {
  float s = 1.f;
  for (int i = 0; i < 160 && !(bound * s <= kFp16Max); ++i) s *= 0.5f;
  return s;
}

__device__ __forceinline__ Scales scales_for(const Args& p, float x_bound) {
  const float h0 = fmaf(x_bound, 1.f + p.a0, p.c0), h1 = fmaf(h0, 1.f + p.a1, p.c1);
  Scales sc;
  sc.x = fp16_scale(x_bound);
  sc.h0 = fp16_scale(h0);
  sc.h1 = fp16_scale(h1);
  sc.ix = 1.f / sc.x;
  sc.ih0 = 1.f / sc.h0;
  sc.ih1 = 1.f / sc.h1;
  return sc;
}

// the producer's and the consumers' walk over the ring: use u of stage u % S
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage_bytes, use = 0;
};

// consumer side: wait for the next stage, return it
__device__ __forceinline__ uint8_t* ring_wait(Ring& ring) {
  const int s = ring.use % ring.stages;
  mbar_wait(&ring.full[s], (ring.use / ring.stages) & 1);
  return ring.base + s * ring.stage_bytes;
}

// consumer side: this warp is done with the stage
__device__ __forceinline__ void ring_release(Ring& ring, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&ring.empty[ring.use % ring.stages]);
  ++ring.use;
}

// producer side: claim the next stage for `bytes` of TMA, return its index
__device__ __forceinline__ int ring_claim(Ring& ring, uint32_t bytes) {
  const int s = ring.use % ring.stages;
  if (ring.use >= ring.stages) mbar_wait(&ring.empty[s], ((ring.use / ring.stages) + 1) & 1);
  mbar_expect_tx(&ring.full[s], bytes);
  ++ring.use;
  return s;
}

// acc (+)= A tile · B stage over one k tile of 64.  The first k tile of a
// product writes acc without reading it, so the compiler keeps no old values
// of acc alive up to it; the callers make that choice at compile time
template <bool kFirst, int kN>
__device__ __forceinline__ void mma_k64(float (&acc)[kN], const uint8_t* a_tile, const uint8_t* b_tile) {
  const uint64_t da = desc_sw128(a_tile), db = desc_sw128(b_tile);
  if (kFirst)
    wgmma_ss_f16_first(acc, da, db);
  else
    wgmma_ss_f16(acc, da, db);
#pragma unroll
  for (int s = 1; s < 4; ++s) wgmma_ss_f16(acc, da + 2 * s, db + 2 * s);
}

template <int kN>
__device__ __forceinline__ void mma_done(float (&acc)[kN]) {
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(acc);
}

// one k tile of a product from the next ring stage (B at `offset` in it)
template <bool kFirst, int kN>
__device__ __forceinline__ void ring_mma(float (&acc)[kN], Ring& ring, const uint8_t* a_tile, int offset, int lane) {
  const uint8_t* st = ring_wait(ring);
  wgmma_fence();
  mma_k64<kFirst>(acc, a_tile, st + offset);
  mma_done(acc);
  ring_release(ring, lane);
}

// the consumer warpgroups: the three component layers.  After each
// component, warpgroup 0 leaves h2 (64 x 16, fp32) at the start of hs for the
// mix warps (mix below) and waits for them to have read it before hs is
// written again.
template <int kD2>
__device__ __forceinline__ void consume(const Args& p, const Scales& sc, const uint8_t* xs, uint8_t* hs, Ring& ring,
                                        int n_chunks, int warp, int lane) {
  constexpr int kNw = kD2 / 2;   // columns of a product per warpgroup
  constexpr int kAcc = kNw / 2;  // accumulator registers per thread
  const int d0 = p.d0, d1 = p.d1, G = p.g_count;
  // warpgroup wg owns columns wg * kNw .. + kNw of each product
  const int wg = warp >> 2, r0 = (warp & 3) * 16 + (lane >> 2), t = lane & 3;
  const int reps0 = d1 / d0 + 1;  // interleave(x, D1): column j <- x[j / reps0]
  float acc0[kAcc], acc1[kAcc], acc2[8];
  // h0[:, :16] of the last chunk in fp32 (warpgroup 0): the residual of the
  // columns of h1 that reach the output through h2; the rest of h1's residual
  // reads h0 from hs in fp16, as layer 2 reads h1
  float res16[8];
  float* h2s = reinterpret_cast<float*>(hs);  // [64][16] h2 for the mix warps

  // one chunk of layer 0, its epilogue and its share of layer 1; the last
  // chunk (h0[:, :D2]) also keeps h0[:, :16] in fp32
  auto chunk = [&](int g, int ch, auto last) {
    // layer 0, columns ch * D2 + wg * kNw .. + kNw
    ring_mma<true>(acc0, ring, xs, wg * kNw * 128, lane);
    for (int kt = 1; kt < d0 / 64; ++kt)
      ring_mma<false>(acc0, ring, xs + kt * kTileBytes, wg * kNw * 128, lane);
    if (g > 0 && ch == n_chunks - 1 && wg == 0) bar_sync(kBarMixEmpty, kMixSync);  // the mix warps hold h2
    bar_sync(kBarConsumers, kConsumerThreads);  // both warpgroups are done reading hs
    const float ix = sc.ix, s_h0 = sc.h0;
#pragma unroll
    for (int j = 0; j < kNw / 8; ++j) {
      const int c = wg * kNw + 8 * j + 2 * t, col = ch * kD2 + c;
      // __ldg: read-only loads the compiler may issue ahead of the stores to hs
      const float2 bias = __ldg(reinterpret_cast<const float2*>(p.b0 + (size_t)g * d1 + col));
      const int src0 = reps0 == 2 ? col >> 1 : col / reps0, src1 = reps0 == 2 ? src0 : (col + 1) / reps0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float v0 = act(fmaf(acc0[4 * j + 2 * h], ix, bias.x), p.slope) +
                         __half2float(*reinterpret_cast<const __half*>(xs + sw_off(r, src0))) * ix;
        const float v1 = act(fmaf(acc0[4 * j + 2 * h + 1], ix, bias.y), p.slope) +
                         __half2float(*reinterpret_cast<const __half*>(xs + sw_off(r, src1))) * ix;
        if (decltype(last)::value && j < 2) {
          res16[4 * j + 2 * h] = v0;
          res16[4 * j + 2 * h + 1] = v1;
        }
        *reinterpret_cast<__half2*>(hs + sw_off(r, c)) = __floats2half2_rn(v0 * s_h0, v1 * s_h0);
      }
    }
    fence_proxy_async();
    bar_sync(kBarConsumers, kConsumerThreads);
    // layer 1, partial sums over this chunk's D2 inputs
    if (ch == n_chunks - 1)
      ring_mma<true>(acc1, ring, hs, wg * kNw * 128, lane);
    else
      ring_mma<false>(acc1, ring, hs, wg * kNw * 128, lane);
    for (int kt = 1; kt < kD2 / 64; ++kt)
      ring_mma<false>(acc1, ring, hs + kt * kTileBytes, wg * kNw * 128, lane);
  };

  for (int g = 0; g < G; ++g) {
    for (int ch = n_chunks - 1; ch > 0; --ch) chunk(g, ch, Flag<false>());
    chunk(g, 0, Flag<true>());

    // layer-1 epilogue: h1 = act(acc1 + b1) + h0[:, :D2], in place in hs
    bar_sync(kBarConsumers, kConsumerThreads);
    const float ih0 = sc.ih0, s_h1 = sc.h1;
#pragma unroll
    for (int j = 0; j < kNw / 8; ++j) {
      const int c = wg * kNw + 8 * j + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(p.b1 + (size_t)g * kD2 + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __half2* at = reinterpret_cast<__half2*>(hs + sw_off(r0 + 8 * h, c));
        const float2 h0s = __half22float2(*at);
        const float2 h0 = (wg == 0 && j < 2) ? make_float2(res16[4 * j + 2 * h], res16[4 * j + 2 * h + 1])
                                             : make_float2(h0s.x * ih0, h0s.y * ih0);
        const float v0 = act(fmaf(acc1[4 * j + 2 * h], ih0, bias.x), p.slope) + h0.x;
        const float v1 = act(fmaf(acc1[4 * j + 2 * h + 1], ih0, bias.y), p.slope) + h0.y;
        if (j < 2) {  // h1[:, :16] in fp32 for h2's residual (warpgroup 0)
          res16[4 * j + 2 * h] = v0;
          res16[4 * j + 2 * h + 1] = v1;
        }
        *at = __floats2half2_rn(v0 * s_h1, v1 * s_h1);
      }
    }
    fence_proxy_async();
    bar_sync(kBarConsumers, kConsumerThreads);

    // layer 2 on warpgroup 0: h2 = act(h1 · W2[g]ᵀ + b2) + h1[:, :16]
    const uint8_t* st = ring_wait(ring);
    if (wg == 0) {
      wgmma_fence();
      mma_k64<true>(acc2, hs, st);
#pragma unroll
      for (int kt = 1; kt < kD2 / 64; ++kt) mma_k64<false>(acc2, hs + kt * kTileBytes, st + kt * kD3 * 128);
      mma_done(acc2);
    }
    ring_release(ring, lane);
    if (wg == 0) {
      const float ih1 = sc.ih1;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h, col = 8 * jj + 2 * t;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(p.b2 + g * kD3 + col));
          *reinterpret_cast<float2*>(h2s + (r0 + 8 * h) * kD3 + col) =
              make_float2(act(fmaf(acc2[i], ih1, bias.x), p.slope) + res16[i],
                          act(fmaf(acc2[i + 1], ih1, bias.y), p.slope) + res16[i + 1]);
        }
      bar_arrive(kBarMixFull, kMixSync);
    }
  }
}

// h · w over 16 values, w read-only in global memory
__device__ __forceinline__ float dot16(const float4 (&h)[kD3 / 4], const float* w) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kD3 / 4; ++j) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + 4 * j));
    s = fmaf(h[j].x, v.x, fmaf(h[j].y, v.y, fmaf(h[j].z, v.z, fmaf(h[j].w, v.w, s))));
  }
  return s;
}

// the mix warps: one point each.  Per component, the point's h2 from hs gives
// its head output and its share of every mix logit (fp32, on the CUDA cores);
// after the last, the tempered softmax over the logits mixes the heads, or,
// in partial mode, the logits and the heads go out as they are.
__device__ __forceinline__ void mix(const Args& p, const uint8_t* hs, int point) {
  const int G = p.g_count, GT = p.g_total;
  const float* h2s = reinterpret_cast<const float*>(hs);
  float logit[kMaxG], comp[kMaxG][3];
#pragma unroll
  for (int q = 0; q < kMaxG; ++q) {
    logit[q] = q < GT ? __ldg(p.att_b + q) : -INFINITY;
    comp[q][0] = comp[q][1] = comp[q][2] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    float4 h2[kD3 / 4];
    bar_sync(kBarMixFull, kMixSync);
#pragma unroll
    for (int j = 0; j < kD3 / 4; ++j) h2[j] = *reinterpret_cast<const float4*>(h2s + point * kD3 + 4 * j);
    if (g + 1 < G) bar_arrive(kBarMixEmpty, kMixSync);
#pragma unroll
    for (int q = 0; q < kMaxG; ++q) {  // constant indices keep logit and comp in registers
      if (q < GT) logit[q] += dot16(h2, p.att_w + ((size_t)q * G + g) * kD3);
      if (q == g)
#pragma unroll
        for (int o = 0; o < 3; ++o) comp[q][o] = __ldg(p.head_b + g * 3 + o) + dot16(h2, p.head_w + (g * 3 + o) * kD3);
    }
  }
  const int b = blockIdx.y, r = blockIdx.x * kRows + point;
  if (p.part_logits) {
    if (r < p.n) {
      float* lo = p.part_logits + ((size_t)b * p.n + r) * GT;
      float* ho = p.part_heads + ((size_t)b * p.n + r) * G * 3;
#pragma unroll
      for (int q = 0; q < kMaxG; ++q) {
        if (q < GT) lo[q] = logit[q];
        if (q < G)
#pragma unroll
          for (int o = 0; o < 3; ++o) ho[3 * q + o] = comp[q][o];
      }
    }
    return;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxG; ++q) mx = fmaxf(mx, logit[q] * p.inv_tau);
  float den = 0.f, o3[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < kMaxG; ++q) {
    if (q >= G) continue;
    const float e = expf(logit[q] * p.inv_tau - mx);
    den += e;
#pragma unroll
    for (int o = 0; o < 3; ++o) o3[o] = fmaf(e, comp[q][o], o3[o]);
  }
  if (r < p.n) {
    float* out = p.out + ((size_t)b * p.n + r) * 3;
    out[0] = o3[0] / den;
    out[1] = o3[1] / den;
    out[2] = o3[2] / den;
  }
}

template <int kD2>
__global__ void __launch_bounds__(kThreads, 1) pcgen_mix_kernel(const __grid_constant__ Args p) {
  constexpr int kStageBytes = kD2 * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* hs = xs + (p.d0 / 64) * kTileBytes;  // 64 x D2 fp16: a layer-0 chunk, then h1
  uint8_t* ring_base = hs + (kD2 / 64) * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_base + p.stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;
  unsigned* w_max = reinterpret_cast<unsigned*>(empty + kMaxStages);  // max |w| of the cloud, as float bits
  Ring ring{ring_base, full, empty, p.stages, kStageBytes};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, i0 = blockIdx.x * kRows;
  const int n = p.n, d0 = p.d0, d1 = p.d1, G = p.g_count;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
    *w_max = 0u;
  }
  __syncthreads();
  {  // the bound of |x|: non-negative floats order as their bits
    float top = 0.f;
    for (int j = tid; j < d0; j += kThreads) top = fmaxf(top, fabsf(p.w[(size_t)b * d0 + j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
    if (lane == 0) atomicMax(w_max, __float_as_uint(top));
  }

  // ---- map head + join: xs = fp16(w ⊙ hardtanh(m · map_w + map_b)) --------
  float* ms = reinterpret_cast<float*>(hs);  // [Dm][64] the map input, aliasing hs and the ring
  for (int e = tid; e < kRows * p.dm; e += kThreads) {
    const int r = e / p.dm, kk = e - r * p.dm;
    ms[kk * kRows + r] = i0 + r < n ? p.m[((size_t)b * n + i0 + r) * p.dm + kk] : 0.f;
  }
  __syncthreads();
  const Scales sc = scales_for(p, __uint_as_float(*w_max));
  if (tid < kConsumerThreads) {
    for (int j = tid; j < d0; j += kConsumerThreads) {
      const float bias = p.map_b[j], scale = p.w[(size_t)b * d0 + j];
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float acc[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[r] = 0.f;
        for (int kk = 0; kk < p.dm; ++kk) {
          const float wv = __ldg(p.map_wt + (size_t)kk * d0 + j);
          const float4* mr = reinterpret_cast<const float4*>(ms + kk * kRows + half * 32);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float4 v = mr[q];
            acc[4 * q] = fmaf(v.x, wv, acc[4 * q]);
            acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const float x = scale * fminf(fmaxf(acc[r] + bias, -1.f), 1.f);
          *reinterpret_cast<__half*>(xs + sw_off(half * 32 + r, j)) = __float2half_rn(x * sc.x);
        }
      }
    }
  }
  fence_proxy_async();  // xs is read by wgmma, the ms region rewritten by TMA
  __syncthreads();

  const int n_chunks = d1 / kD2;
  if (warp >= kConsumerThreads / 32) {
    // ---- the producer: every weight tile, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerThreads / 32 && lane == 0) {
      auto load = [&](int s, const CUtensorMap* map, int offset, int c0, int c1) {
        tma_load_2d(ring_base + s * kStageBytes + offset, map, &full[s], c0, c1);
      };
      for (int g = 0; g < G; ++g) {
        for (int ch = n_chunks - 1; ch >= 0; --ch) {
          for (int kt = 0; kt < d0 / 64; ++kt)
            load(ring_claim(ring, kStageBytes), &p.w0, 0, kt * 64, g * d1 + ch * kD2);
          for (int kt = 0; kt < kD2 / 64; ++kt)
            load(ring_claim(ring, kStageBytes), &p.w1, 0, ch * kD2 + kt * 64, g * kD2);
        }
        const int s = ring_claim(ring, (kD2 / 64) * kD3 * 128);
        for (int kt = 0; kt < kD2 / 64; ++kt) load(s, &p.w2, kt * kD3 * 128, kt * 64, g * kD3);
      }
    } else if (warp >= kMixWarp0 && warp < kMixWarp0 + kRows / 32) {
      mix(p, hs, tid - kMixWarp0 * 32);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<kD2>(p, sc, xs, hs, ring, n_chunks, warp, lane);
  }
}

// a (rows, cols) row-major fp16 matrix in boxes of 64 columns x box_rows rows,
// 128-byte swizzled
bool encode_f16(CUtensorMap* map, const uint16_t* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, const_cast<uint16_t*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD2>
int launch(Args& args, const uint16_t* w0, const uint16_t* w1, const uint16_t* w2, int batch, cudaStream_t stream) {
  constexpr int kStageBytes = kD2 * 128;
  const int fixed = (args.d0 / 64 + kD2 / 64) * kTileBytes + 1024 + 2 * kMaxStages * 8 + 16;
  int stages = (kSmemMax - fixed) / kStageBytes;
  if (stages > kMaxStages) stages = kMaxStages;
  // at least two stages, and room for the prologue's map input, which aliases hs and the ring
  if (stages < 2 || kRows * args.dm * 4 > (kD2 / 64) * kTileBytes + stages * kStageBytes)
    return (int)cudaErrorInvalidValue;
  args.stages = stages;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  const int g = args.g_count;
  if (!encode_f16(&args.w0, w0, g * args.d1, args.d0, kD2) || !encode_f16(&args.w1, w1, g * kD2, args.d1, kD2) ||
      !encode_f16(&args.w2, w2, g * kD3, kD2, kD3))
    return (int)cudaErrorInvalidValue;
  static MaxSmem max_smem;
  const cudaError_t attr = max_smem((const void*)pcgen_mix_kernel<kD2>, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((args.n + kRows - 1) / kRows, batch);
  pcgen_mix_kernel<kD2><<<grid, kThreads, fixed + stages * kStageBytes, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// the shapes the kernel covers (pccf_torch/kernels/pcgen.py flagship): three
// component layers D0 -> D1 -> D2 -> D3, G_l components a block, G_t logits
int run(const float* m, const float* w, const float* map_wt, const float* map_b, const uint16_t* w0, const float* b0,
        const uint16_t* w1, const float* b1, const uint16_t* w2, const float* b2, const float* head_w,
        const float* head_b, const float* att_w, const float* att_b, float* out, float* part_logits,
        float* part_heads, int batch, int n, int dm, int d0, int d1, int d2, int d3, int g_count, int g_total,
        float tau, float slope, float a0, float c0, float a1, float c1, cudaStream_t stream) {
  if (batch < 1 || n < 1 || d0 < 64 || d0 > kMaxD0 || d0 % 64 || (d2 != 64 && d2 != 128 && d2 != 256) || d1 % d2 ||
      d1 <= d2 || d3 != kD3 || dm < 1 || dm > kMaxDm || g_count < 1 || g_total > kMaxG || g_count > g_total)
    return (int)cudaErrorInvalidValue;
  Args args = {};
  args.m = m;
  args.w = w;
  args.map_wt = map_wt;
  args.map_b = map_b;
  args.b0 = b0;
  args.b1 = b1;
  args.b2 = b2;
  args.head_w = head_w;
  args.head_b = head_b;
  args.att_w = att_w;
  args.att_b = att_b;
  args.out = out;
  args.part_logits = part_logits;
  args.part_heads = part_heads;
  args.n = n;
  args.dm = dm;
  args.d0 = d0;
  args.d1 = d1;
  args.g_count = g_count;
  args.g_total = g_total;
  args.inv_tau = 1.f / tau;
  args.slope = slope;
  args.a0 = a0;
  args.c0 = c0;
  args.a1 = a1;
  args.c1 = c1;
  if (d2 == 64) return launch<64>(args, w0, w1, w2, batch, stream);
  if (d2 == 128) return launch<128>(args, w0, w1, w2, batch, stream);
  return launch<256>(args, w0, w1, w2, batch, stream);
}

}  // namespace

// out (B, N, 3) from m (B, N, Dm) and w (B, D0), for three component layers
// D0 -> D1 -> D2 -> D3 and 2 to 8 components; the component weights (G, Dout,
// Din) in fp16, the rest fp32; a0 / a1 the largest absolute row sum of the
// fp16 W0 / W1, c0 / c1 the largest |b0| / |b1| (the bounds of the operands'
// scales).
extern "C" int pccf_pcgen_mix(const float* m, const float* w, const float* map_wt, const float* map_b,
                              const uint16_t* w0, const float* b0, const uint16_t* w1, const float* b1,
                              const uint16_t* w2, const float* b2, const float* head_w, const float* head_b,
                              const float* att_w, const float* att_b, float* out, int batch, int n, int dm,
                              int d0, int d1, int d2, int d3, int g_count, float tau, float slope, float a0,
                              float c0, float a1, float c1, cudaStream_t stream) {
  if (g_count < 2) return (int)cudaErrorInvalidValue;
  return run(m, w, map_wt, map_b, w0, b0, w1, b1, w2, b2, head_w, head_b, att_w, att_b, out, nullptr, nullptr, batch,
             n, dm, d0, d1, d2, d3, g_count, g_count, tau, slope, a0, c0, a1, c1, stream);
}

// partial mode: the g_local components of a rank, their weights as above,
// att_w (g_total, g_local * D3) and att_b (g_total) -> logits (B, N,
// g_total) and heads (B, N, g_local, 3).  At least one local component and
// at most 8 logits: with as many ranks as components (mp = G) a block runs
// one component.
extern "C" int pccf_pcgen_mix_partial(const float* m, const float* w, const float* map_wt, const float* map_b,
                                      const uint16_t* w0, const float* b0, const uint16_t* w1, const float* b1,
                                      const uint16_t* w2, const float* b2, const float* head_w, const float* head_b,
                                      const float* att_w, const float* att_b, float* logits, float* heads, int batch,
                                      int n, int dm, int d0, int d1, int d2, int d3, int g_local, int g_total,
                                      float slope, float a0, float c0, float a1, float c1, cudaStream_t stream) {
  if (!logits || !heads) return (int)cudaErrorInvalidValue;
  return run(m, w, map_wt, map_b, w0, b0, w1, b1, w2, b2, head_w, head_b, att_w, att_b, nullptr, logits, heads, batch,
             n, dm, d0, d1, d2, d3, g_local, g_total, 1.f, slope, a0, c0, a1, c1, stream);
}
