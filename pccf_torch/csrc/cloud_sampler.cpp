// Host-side point-cloud batch assembly: a copy of pccf/native/cloud_sampler.cpp.
//
// A training batch is per-item resampling + unit-sphere normalisation +
// clipped jitter (+ the shared rotation / scale / translation), assembled in
// parallel threads with a per-item counter-based RNG (splitmix64-seeded
// xorshift64), so the result is reproducible from (seed, item).  It is host
// C++, compiled into the kernel library by pccf_torch/kernels/_build.py; a
// run on the CPU uses the numpy version in pccf_torch/data/sampler.py, which
// draws the same stream.
//
// Exposed C ABI (ctypes, pccf_torch/data/sampler.py): pccf_assemble_batch_aug
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64 for seeding + xorshift for the stream: fast, portable
struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) {
        s = seed + 0x9E3779B97f4A7C15ULL;
        s = (s ^ (s >> 30)) * 0xBF58476D1CE4E5B9ULL;
        s = (s ^ (s >> 27)) * 0x94D049BB133111EBULL;
        s = s ^ (s >> 31);
        if (s == 0) s = 0x1234567ULL;
    }
    inline uint64_t next() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        return s;
    }
    inline double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
    inline uint64_t below(uint64_t n) { return next() % n; }
    // Box-Muller
    inline void normal2(float* a, float* b) {
        double u1 = uniform(), u2 = uniform();
        if (u1 < 1e-300) u1 = 1e-300;
        double r = std::sqrt(-2.0 * std::log(u1));
        *a = (float)(r * std::cos(6.283185307179586 * u2));
        *b = (float)(r * std::sin(6.283185307179586 * u2));
    }
};

void process_item(const float* cloud, int64_t n_src, int64_t n_out,
                  uint64_t seed, int do_jitter, float sigma, float clip,
                  float* out) {
    Rng rng(seed);
    // sample with replacement
    std::vector<int64_t> pick((size_t)n_out);
    for (int64_t i = 0; i < n_out; ++i) pick[(size_t)i] = (int64_t)rng.below((uint64_t)n_src);
    // gather + mean
    double mean[3] = {0, 0, 0};
    for (int64_t i = 0; i < n_out; ++i) {
        const float* p = cloud + 3 * pick[(size_t)i];
        float* q = out + 3 * i;
        q[0] = p[0]; q[1] = p[1]; q[2] = p[2];
        mean[0] += p[0]; mean[1] += p[1]; mean[2] += p[2];
    }
    for (int c = 0; c < 3; ++c) mean[c] /= (double)n_out;
    // center + max radius
    double max_r2 = 0.0;
    for (int64_t i = 0; i < n_out; ++i) {
        float* q = out + 3 * i;
        q[0] -= (float)mean[0]; q[1] -= (float)mean[1]; q[2] -= (float)mean[2];
        double r2 = (double)q[0] * q[0] + (double)q[1] * q[1] + (double)q[2] * q[2];
        if (r2 > max_r2) max_r2 = r2;
    }
    float inv = max_r2 > 0 ? (float)(1.0 / std::sqrt(max_r2)) : 1.0f;
    for (int64_t i = 0; i < 3 * n_out; ++i) out[i] *= inv;
    // clipped gaussian jitter (all 3*n_out coordinates, incl. an odd tail)
    if (do_jitter) {
        int64_t total = 3 * n_out;
        for (int64_t i = 0; i < total; i += 2) {
            float a, b;
            rng.normal2(&a, &b);
            a *= sigma; b *= sigma;
            if (a > clip) a = clip; if (a < -clip) a = -clip;
            if (b > clip) b = clip; if (b < -clip) b = -clip;
            out[i] += a;
            if (i + 1 < total) out[i + 1] += b;
        }
    }
}

// Augmented training path (reference src/data/modelnet.py:38-59 +
// src/data/augmentations.py:29-76): input cloud = normalise(sample) +
// jitter; reference cloud = resample ? normalise(full)[sample2] : input;
// then ONE shared rotation-about-y / per-axis-scale / translation applied
// to both clouds (the pair must see the same transform).
void process_item_aug(const float* cloud, int64_t n_src, int64_t n_out,
                      uint64_t seed, int do_jitter, float sigma, float clip,
                      int do_resample, int do_rotate, int do_translate,
                      float* out, float* ref) {
    Rng rng(seed);
    process_item(cloud, n_src, n_out, rng.next(), do_jitter, sigma, clip, out);
    if (do_resample) {
        // normalise the FULL cloud (mean/radius over all n_src points,
        // matching the python path), then gather an independent sample
        double mean[3] = {0, 0, 0};
        for (int64_t i = 0; i < n_src; ++i)
            for (int c = 0; c < 3; ++c) mean[c] += cloud[3 * i + c];
        for (int c = 0; c < 3; ++c) mean[c] /= (double)n_src;
        double max_r2 = 0.0;
        for (int64_t i = 0; i < n_src; ++i) {
            double r2 = 0.0;
            for (int c = 0; c < 3; ++c) {
                double v = cloud[3 * i + c] - mean[c];
                r2 += v * v;
            }
            if (r2 > max_r2) max_r2 = r2;
        }
        float inv = max_r2 > 0 ? (float)(1.0 / std::sqrt(max_r2)) : 1.0f;
        for (int64_t i = 0; i < n_out; ++i) {
            const float* p = cloud + 3 * rng.below((uint64_t)n_src);
            for (int c = 0; c < 3; ++c)
                ref[3 * i + c] = (float)((p[c] - mean[c]) * inv);
        }
    }
    float* both[2] = {out, do_resample ? ref : nullptr};
    if (do_rotate) {
        // rotation about y: [x, z] @ [[c, -s], [s, c]]
        double theta = 2.0 * 3.141592653589793 * rng.uniform();
        float c = (float)std::cos(theta), s = (float)std::sin(theta);
        for (float* q : both) {
            if (!q) continue;
            for (int64_t i = 0; i < n_out; ++i) {
                float x = q[3 * i], z = q[3 * i + 2];
                q[3 * i] = x * c + z * s;
                q[3 * i + 2] = -x * s + z * c;
            }
        }
    }
    if (do_translate) {
        // per-axis scale in [2/3, 3/2] and translation in [-0.2, 0.2]
        float sc[3], tr[3];
        for (int c = 0; c < 3; ++c) sc[c] = (float)(rng.uniform() * 5.0 / 6.0 + 2.0 / 3.0);
        for (int c = 0; c < 3; ++c) tr[c] = (float)(rng.uniform() * 0.4 - 0.2);
        for (float* q : both) {
            if (!q) continue;
            for (int64_t i = 0; i < n_out; ++i)
                for (int c = 0; c < 3; ++c) q[3 * i + c] = q[3 * i + c] * sc[c] + tr[c];
        }
    }
    if (!do_resample) std::memcpy(ref, out, sizeof(float) * 3 * (size_t)n_out);
}

// Shared pool for both entry points: spawn/join with >= 4 items per thread
// (threads cost ~tens of us each vs ~130 us/item of work); fn(b, item_seed)
// processes one batch item with its counter-based reproducible seed.
template <typename Fn>
void run_over_batch(int64_t batch, uint64_t seed, const int64_t* item_ids, Fn fn) {
    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    if ((int64_t)n_threads > batch) n_threads = (int)batch;
    if ((int64_t)n_threads * 4 > batch) n_threads = (int)((batch + 3) / 4);
    if (n_threads < 1) n_threads = 1;
    std::vector<std::thread> pool;
    pool.reserve((size_t)n_threads);
    for (int t = 0; t < n_threads; ++t) {
        pool.emplace_back([=]() {
            for (int64_t b = t; b < batch; b += n_threads) {
                uint64_t item_seed = seed * 0x100000001B3ULL + (uint64_t)b * 0x9E3779B1ULL
                                     + (uint64_t)item_ids[b];
                fn(b, item_seed);
            }
        });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

// Validate shapes/ids before any thread touches the buffers: an id outside
// [0, n_items) would read out of bounds silently; n_src == 0 is modulo-zero
// UB in Rng::below.  Returns 0 on success.
static int validate_args(int64_t n_items, int64_t n_src, const int64_t* item_ids,
                         int64_t batch, int64_t n_out) {
    if (n_items <= 0 || n_src <= 0 || n_out <= 0 || batch < 0) return 2;
    for (int64_t b = 0; b < batch; ++b)
        if (item_ids[b] < 0 || item_ids[b] >= n_items) return 1;
    return 0;
}

// clouds: (n_items, n_src, 3) contiguous f32; item_ids: (batch,) indices;
// out, ref: (batch, n_out, 3) preallocated f32: the input clouds and their
// reference clouds, with the shared rotation / scale+translation applied.
// returns 0 ok, 1 item id out of range, 2 bad shape
extern "C" int pccf_assemble_batch_aug(const float* clouds, int64_t n_items, int64_t n_src,
                                       const int64_t* item_ids, int64_t batch, int64_t n_out,
                                       uint64_t seed, int do_jitter, float sigma, float clip,
                                       int do_resample, int do_rotate, int do_translate,
                                       float* out, float* ref) {
    if (int rc = validate_args(n_items, n_src, item_ids, batch, n_out)) return rc;
    run_over_batch(batch, seed, item_ids, [=](int64_t b, uint64_t item_seed) {
        const float* cloud = clouds + 3 * n_src * item_ids[b];
        process_item_aug(cloud, n_src, n_out, item_seed, do_jitter, sigma, clip,
                         do_resample, do_rotate, do_translate,
                         out + 3 * n_out * b, ref + 3 * n_out * b);
    });
    return 0;
}
