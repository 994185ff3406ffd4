// Native sequential SGD oracle for gfasort_tpu_torch.
//
// Bit-exact replica of the reference's single-worker SGD semantics
// (gfasort src/sgd.rs:237-614 for 1D, :773-1188 for nD) under the
// deterministic iteration contract (exactly min_term_updates successful
// updates per iteration, eta/theta from the precomputed schedule).
// This is the same contract as gfasort_tpu_torch.ops.exact (Python); the two
// are cross-checked in tests.  The C++ build exists because the oracle
// doubles as the CPU performance baseline for bench.py, standing in for
// the Rust reference (no Rust toolchain in this environment, see
// BASELINE.md).
//
// RNG stack: SplitMix64-seeded xoshiro256+ (rand_core seed_from_u64 +
// rand_xoshiro), rand 0.9 Lemire widening-multiply uniform ints, 53-bit
// f64 standard uniforms, and ODGI's fast_precise_pow
// (src/sgd.rs:153-182, magic constant 1072632447).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

struct Xoshiro256Plus {
    uint64_t s[4];

    explicit Xoshiro256Plus(uint64_t seed) {
        // rand_core SeedableRng::seed_from_u64 (SplitMix64 filler)
        uint64_t state = seed;
        for (int i = 0; i < 4; i++) {
            state += 0x9E3779B97F4A7C15ULL;
            uint64_t z = state;
            z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
            z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
            s[i] = z ^ (z >> 31);
        }
    }

    static inline uint64_t rotl(uint64_t x, int k) {
        return (x << k) | (x >> (64 - k));
    }

    inline uint64_t next_u64() {
        uint64_t result = s[0] + s[3];
        uint64_t t = s[1] << 17;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 45);
        return result;
    }

    inline double random_f64() {
        return (double)(next_u64() >> 11) * (1.0 / 9007199254740992.0);
    }
};

// rand 0.9 UniformInt for u64: Lemire with threshold rejection
struct UniformU64 {
    uint64_t low, range, thresh;

    UniformU64(uint64_t lo, uint64_t hi) : low(lo), range(hi - lo) {
        thresh = range ? (-range) % range : 0;
    }

    inline uint64_t sample(Xoshiro256Plus& rng) const {
        if (range == 0) return rng.next_u64();
        for (;;) {
            unsigned __int128 m = (unsigned __int128)rng.next_u64() * range;
            uint64_t lo64 = (uint64_t)m;
            if (lo64 >= thresh) return low + (uint64_t)(m >> 64);
        }
    }
};

// ODGI fast_precise_pow (gfasort src/sgd.rs:155-182)
inline double fast_precise_pow(double a, double b) {
    int32_t e = (int32_t)b;
    uint64_t bits;
    std::memcpy(&bits, &a, 8);
    int32_t high = (int32_t)(bits >> 32);
    int32_t new_high = (int32_t)((b - e) * (high - 1072632447) + 1072632447.0);
    uint64_t frac_bits = ((uint64_t)(int64_t)new_high) << 32;
    double frac;
    std::memcpy(&frac, &frac_bits, 8);
    double base = a, r = 1.0;
    int32_t exp = e;
    while (exp != 0) {
        if (exp & 1) r *= base;
        base *= base;
        exp >>= 1;
    }
    return r * frac;
}

// DirtyZipfian O(1) sample over [1, jump_space] (src/sgd.rs:110-151)
inline uint64_t zipf_sample(Xoshiro256Plus& rng, uint64_t jump_space,
                            double theta, double zeta, double zeta2theta) {
    uint64_t n = jump_space;
    double alpha = 1.0 / (1.0 - theta);
    double eta = (1.0 - fast_precise_pow(2.0 / (double)n, 1.0 - theta)) /
                 (1.0 - zeta2theta / zeta);
    double u = rng.random_f64();
    double uz = u * zeta;
    if (uz < 1.0) return 1;
    if (uz < 1.0 + fast_precise_pow(0.5, theta)) return 2;
    double result = 1.0 + (double)n * fast_precise_pow(eta * u - eta + 1.0, alpha);
    uint64_t r;
    if (!(result >= 0.0)) r = 0;                      // NaN / negative
    else if (result >= 18446744073709551615.0) r = UINT64_MAX;
    else r = (uint64_t)result;
    return std::min(r, jump_space);
}

inline size_t space_index(uint64_t jump_space, uint64_t space_max,
                          uint64_t quant, size_t table_len) {
    size_t idx = (jump_space > space_max)
        ? (size_t)(space_max + (jump_space - space_max) / quant + 1)
        : (size_t)jump_space;
    return std::min(idx, table_len - 1);
}

// Second-step rank sampling shared by 1D and nD (src/sgd.rs:456-495)
inline int64_t sample_rank_b(
    Xoshiro256Plus& rng, const UniformU64& flip_dist, bool cooling,
    double cur_theta, int64_t rank_a, int64_t count_p, uint64_t space,
    uint64_t space_max, uint64_t quant, const double* zetas,
    size_t zetas_len) {
    int64_t rank_b = rank_a;
    if (cooling || flip_dist.sample(rng) == 1) {
        if (rank_a > 0 &&
            (flip_dist.sample(rng) == 1 || rank_a == count_p - 1)) {
            uint64_t jump_space = std::min(space, (uint64_t)rank_a);
            size_t si = space_index(jump_space, space_max, quant, zetas_len);
            double z2t = 1.0 + fast_precise_pow(0.5, cur_theta);
            uint64_t z = zipf_sample(rng, jump_space, cur_theta, zetas[si], z2t);
            rank_b = rank_a - (int64_t)std::min(z, (uint64_t)rank_a);
        } else if (rank_a < count_p - 1) {
            uint64_t jump_space = std::min(space, (uint64_t)(count_p - rank_a - 1));
            size_t si = space_index(jump_space, space_max, quant, zetas_len);
            double z2t = 1.0 + fast_precise_pow(0.5, cur_theta);
            uint64_t z = zipf_sample(rng, jump_space, cur_theta, zetas[si], z2t);
            rank_b = std::min(rank_a + (int64_t)z, count_p - 1);
        }
    } else {
        rank_b = (int64_t)UniformU64(0, (uint64_t)count_p).sample(rng);
    }
    return rank_b;
}

}  // namespace

extern "C" {

// 1D path SGD (src/sgd.rs:237-614).  x[N] holds initial positions on
// entry, final positions on exit.  Returns total successful updates.
int64_t sgd1d_exact(
    int64_t total_steps, const int64_t* step_path, const int64_t* step_rank,
    const int64_t* step_pos, const int64_t* step_node,
    const int64_t* path_first, const int64_t* path_count,
    int64_t num_nodes, double* x,
    int64_t iter_max, int64_t min_term_updates, double theta,
    uint64_t space, uint64_t space_max, uint64_t quant,
    int64_t first_cooling_iteration, uint64_t seed,
    const double* etas, const double* zetas, int64_t zetas_len) {
    (void)num_nodes;
    Xoshiro256Plus rng(seed);
    UniformU64 step_dist(0, (uint64_t)total_steps);
    UniformU64 flip_dist(0, 2);
    int64_t total = 0;

    for (int64_t k = 0; k <= iter_max; k++) {
        double eta = etas[k];
        bool cooling = k > first_cooling_iteration;
        double cur_theta = cooling ? 0.001 : theta;
        int64_t done = 0;
        while (done < min_term_updates) {
            int64_t step_idx = (int64_t)step_dist.sample(rng);
            int64_t p = step_path[step_idx];
            int64_t count_p = path_count[p];
            if (count_p == 1) continue;
            int64_t rank_a = step_rank[step_idx];
            int64_t rank_b = sample_rank_b(
                rng, flip_dist, cooling, cur_theta, rank_a, count_p, space,
                space_max, quant, zetas, (size_t)zetas_len);
            if (rank_a == rank_b) continue;
            int64_t sa = path_first[p] + rank_a;
            int64_t sb = path_first[p] + rank_b;
            double pos_a = (double)step_pos[sa];
            double pos_b = (double)step_pos[sb];
            double term_dist = std::fabs(pos_a - pos_b);
            if (term_dist == 0.0) continue;
            double mu = eta * (1.0 / term_dist);
            if (mu > 1.0) mu = 1.0;
            int64_t i = step_node[sa];
            int64_t j = step_node[sb];
            // nodes absent from the SGD index (stale node_order after a
            // renumbering on gapped-id inputs) are skipped, matching the
            // reference's warning path (src/sgd.rs:525-538)
            if (i < 0 || j < 0) continue;
            double dx = x[i] - x[j];
            if (dx == 0.0) dx = 1e-9;
            double mag = std::fabs(dx);
            double delta = mu * (mag - term_dist) / 2.0;
            double r_x = (delta / mag) * dx;
            x[i] = x[i] - r_x;
            x[j] = x[j] + r_x;
            done++;
            total++;
        }
    }
    return total;
}

// nD layout SGD inner loop (src/sgd.rs:773-1188).  coords layout:
// [entry * dims + d] with entry = node_idx * 2 + end; caller does the
// init (including gaussian noise).  step_rev[s] = orientation bit of
// the step's handle; node_len[n] = sequence length.
int64_t sgd_nd_exact(
    int64_t total_steps, const int64_t* step_path, const int64_t* step_rank,
    const int64_t* step_pos, const int64_t* step_node, const int64_t* step_rev,
    const int64_t* path_first, const int64_t* path_count,
    const int64_t* node_len,
    int64_t num_nodes, int64_t dims, double* coords,
    int64_t iter_max, int64_t min_term_updates, double theta,
    uint64_t space, uint64_t space_max, uint64_t quant,
    int64_t first_cooling_iteration, uint64_t seed,
    const double* etas, const double* zetas, int64_t zetas_len) {
    (void)num_nodes;
    Xoshiro256Plus rng(seed);
    UniformU64 step_dist(0, (uint64_t)total_steps);
    UniformU64 flip_dist(0, 2);
    int64_t total = 0;
    double deltas_buf[64];

    for (int64_t k = 0; k <= iter_max; k++) {
        double eta = etas[k];
        bool cooling = k > first_cooling_iteration;
        double cur_theta = cooling ? 0.001 : theta;
        int64_t done = 0;
        while (done < min_term_updates) {
            int64_t step_idx = (int64_t)step_dist.sample(rng);
            int64_t p = step_path[step_idx];
            int64_t count_p = path_count[p];
            if (count_p == 1) continue;
            int64_t rank_a = step_rank[step_idx];
            int64_t rank_b = sample_rank_b(
                rng, flip_dist, cooling, cur_theta, rank_a, count_p, space,
                space_max, quant, zetas, (size_t)zetas_len);
            if (rank_a == rank_b) continue;
            int64_t sa = path_first[p] + rank_a;
            int64_t sb = path_first[p] + rank_b;
            double pos_a = (double)step_pos[sa];
            double pos_b = (double)step_pos[sb];
            int64_t i = step_node[sa];
            int64_t j = step_node[sb];

            // random end choice (rs:1060-1077).  The reference draws
            // BOTH end coins before the handle-lookup skip
            // (rs:1089-1096) and uses length 0 for a missing node
            // (rs:1051-1058 unwrap_or(0)); keep that exact stream order
            // so a gapped-id input cannot desync the RNG.
            int64_t i_rev = step_rev[sa];
            int64_t j_rev = step_rev[sb];
            int64_t end_a, end_b;
            if (flip_dist.sample(rng) == 1) {
                pos_a += i >= 0 ? (double)node_len[i] : 0.0;
                end_a = i_rev ? 0 : 1;
            } else {
                end_a = i_rev ? 1 : 0;
            }
            if (flip_dist.sample(rng) == 1) {
                pos_b += j >= 0 ? (double)node_len[j] : 0.0;
                end_b = j_rev ? 0 : 1;
            } else {
                end_b = j_rev ? 1 : 0;
            }

            double term_dist = std::fabs(pos_a - pos_b);
            if (term_dist == 0.0) continue;
            double mu = eta * (1.0 / term_dist);
            if (mu > 1.0) mu = 1.0;
            if (i < 0 || j < 0) continue;

            double* ci = coords + (i * 2 + end_a) * dims;
            double* cj = coords + (j * 2 + end_b) * dims;
            double mag_sq = 0.0;
            for (int64_t d = 0; d < dims; d++) {
                double dd = ci[d] - cj[d];
                deltas_buf[d] = dd;
                mag_sq += dd * dd;
            }
            if (mag_sq == 0.0) {
                deltas_buf[0] = 1e-9;
                mag_sq = 1e-18;
            }
            double mag = std::sqrt(mag_sq);
            double delta = mu * (mag - term_dist) / 2.0;
            double r = delta / mag;
            for (int64_t d = 0; d < dims; d++) {
                double r_d = r * deltas_buf[d];
                ci[d] -= r_d;
                cj[d] += r_d;
            }
            done++;
            total++;
        }
    }
    return total;
}

// Benchmark helper: raw pair-updates/s of the 1D inner loop without the
// iteration bookkeeping changing (fixed eta/theta), for BASELINE
// measurement.
int64_t sgd1d_bench(
    int64_t total_steps, const int64_t* step_path, const int64_t* step_rank,
    const int64_t* step_pos, const int64_t* step_node,
    const int64_t* path_first, const int64_t* path_count,
    double* x, int64_t n_updates, double eta, double theta,
    uint64_t space, uint64_t space_max, uint64_t quant, uint64_t seed,
    const double* zetas, int64_t zetas_len) {
    Xoshiro256Plus rng(seed);
    UniformU64 step_dist(0, (uint64_t)total_steps);
    UniformU64 flip_dist(0, 2);
    int64_t done = 0;
    int64_t attempts = 0;
    while (done < n_updates) {
        attempts++;
        int64_t step_idx = (int64_t)step_dist.sample(rng);
        int64_t p = step_path[step_idx];
        int64_t count_p = path_count[p];
        if (count_p == 1) continue;
        int64_t rank_a = step_rank[step_idx];
        int64_t rank_b = sample_rank_b(
            rng, flip_dist, false, theta, rank_a, count_p, space, space_max,
            quant, zetas, (size_t)zetas_len);
        if (rank_a == rank_b) continue;
        int64_t sa = path_first[p] + rank_a;
        int64_t sb = path_first[p] + rank_b;
        double pos_a = (double)step_pos[sa];
        double pos_b = (double)step_pos[sb];
        double term_dist = std::fabs(pos_a - pos_b);
        if (term_dist == 0.0) continue;
        double mu = eta * (1.0 / term_dist);
        if (mu > 1.0) mu = 1.0;
        int64_t i = step_node[sa];
        int64_t j = step_node[sb];
        if (i < 0 || j < 0) continue;
        double dx = x[i] - x[j];
        if (dx == 0.0) dx = 1e-9;
        double mag = std::fabs(dx);
        double delta = mu * (mag - term_dist) / 2.0;
        double r_x = (delta / mag) * dx;
        x[i] = x[i] - r_x;
        x[j] = x[j] + r_x;
        done++;
    }
    return attempts;
}

// Sampled 2D layout stress over a node coordinate map, bit-matching the
// compare_layouts tool's Python loop (reference:
// src/bin/compare_layouts.rs:156-255 — random step a, uniform rank b in
// a's path, normalized squared error of euclidean vs path distance).
// present[n] = 0 skips nodes missing from the loaded layout.
double layout_stress_2d(
    int64_t total_steps, const int64_t* step_path, const int64_t* step_rank,
    const int64_t* step_pos, const int64_t* step_node,
    const int64_t* path_first, const int64_t* path_count,
    const double* xs, const double* ys, const uint8_t* present,
    int64_t sample_count, uint64_t seed) {
    Xoshiro256Plus rng(seed);
    UniformU64 step_dist(0, (uint64_t)total_steps);
    double stress_sum = 0.0;
    int64_t count = 0;
    for (int64_t s = 0; s < sample_count; s++) {
        int64_t sa0 = (int64_t)step_dist.sample(rng);
        int64_t p = step_path[sa0];
        int64_t cnt = path_count[p];
        if (cnt < 2) continue;
        int64_t rank_a = step_rank[sa0];
        int64_t rank_b = (int64_t)UniformU64(0, (uint64_t)cnt).sample(rng);
        if (rank_a == rank_b) continue;
        int64_t sa = path_first[p] + rank_a;
        int64_t sb = path_first[p] + rank_b;
        double path_dist = std::fabs((double)step_pos[sa] - (double)step_pos[sb]);
        if (path_dist == 0.0) continue;
        int64_t ia = step_node[sa];
        int64_t ib = step_node[sb];
        if (ia < 0 || ib < 0 || !present[ia] || !present[ib]) continue;
        double d = std::hypot(xs[ia] - xs[ib], ys[ia] - ys[ib]);
        double err = d - path_dist;
        stress_sum += (err * err) / (path_dist * path_dist);
        count++;
    }
    return count ? std::sqrt(stress_sum / (double)count) : 0.0;
}

}  // extern "C"
