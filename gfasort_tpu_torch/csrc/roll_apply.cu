// Roll passes and combine of the sweep engines, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port's counterpart of the XLA
// fusions of the roll passes and the combine in gfasort_tpu/ops/
// sweep.py:328-380 (1D) and of the nD roll passes and the per-end
// combine in gfasort_tpu/ops/sweep_nd.py:105-185.  The plain PyTorch
// versions are ops/roll_apply.py::roll_apply_ref / roll_apply_nd_ref.
// One launch serves every roll bucket of a phase (the offsets above the
// bucket kernel's KMAX, or all of them without that kernel) and the
// combine.  For every step t and roll bucket (k, ki) in list order:
//   the pair (t, t + k): w1 = number of proposals p with my field == ki,
//     or the field of t + k == ~ki where t + k < S;
//   the pair (t, t - k): w2 = number of proposals p with my field == ~ki,
//     or the field of t - k == ki where t >= k;
// the partner is read at (t +- k) mod S (a roll: the wrap-around is
// guarded on the partner's field only), and each pair's update is that
// of the bucket kernels (d = |pos - pos_o|, w = 0 and safe = 1 where
// d == 0, mu = min(eta / safe, 1), ...).  The sums run as the plain
// version's: per bucket acc = acc + u1 + u2 and w = w + w1 + w2, from the
// bucket kernel's sums (or +0).  1D: out = xs + dsum / max(csum, 1).
// nD: upd = acc / max(wacc, 1), out = [cs[:D] + (lane0 ? upd : 0),
// cs[D:] + (lane0 ? 0 : upd)].
//
// What bounds it on the card: bytes for a few roll buckets (each step
// reads its own state and, per bucket, the two partners' position, state
// and choice words, most of them from L2), integer operations for many
// (per pair the field match over P proposals, mine and the partner's;
// chip_smoke.py::match_ops counts it per word) beside the f32 work (two
// pair evaluations per bucket, each with an IEEE divide, and in nD a
// square root and a second divide).
//
// Design: one thread per step, the step's own state and fields in
// registers, the partners read directly at t +- k (no rolled copies).
// Every pair is evaluated in full, zero weights included, so signed
// zeros come out as the plain version's.  Every f32 op is an explicit
// round-to-nearest intrinsic in the plain version's order (and the build
// passes --fmad=false); the nD rsqrt is 1 / sqrt, both correctly
// rounded, as the plain version computes it.
// Both kernels count a pair's matching fields a 4-byte word at a time
// (weight_words): the word XOR the broadcast byte of ki (or ~ki) has a
// zero byte exactly where a field matches, found without carries by
// ~(((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v) & 0x80808080; the partner's
// mask is ORed in where the guard holds, the unused fields of the last
// word are masked off (they hold 0, which ki = 0 would match), the
// words' masks are shifted into distinct bits and one __popc counts
// them.  INACTIVE8 (127) matches no ki < 64 and no ~ki.  Both are
// templated on the word count (0: P = 1 compares the raw choices), the
// nD kernel also on D, and both index in 32 bits: the host passes k mod
// S and the ahead guard's limit S - k per bucket.  The nD kernel forms
// each [D, S] / [2D, S] row's pointer once per thread in 64 bits (2D * S
// may pass 2^31 where S does not) and indexes it with the 32-bit step.
// Loads go through __ldg from __restrict__ pointers.
// The f64 route (gfasort_tpu/ops/sweep.py:328-380 and sweep_nd.py:105-185
// at f64, where every bucket of a phase is a roll bucket, k = 1 included)
// has kernels of its own, with the double ops in the same order
// (__d*_rn), the constants 1e-9, 0.5, 1e-18 and 1e30 and eta in double,
// and the nD rsqrt as 1.0 / __dsqrt_rn, as the plain version's sqrt_rn.
// There the double IEEE divide (and in nD the square root and a second
// divide) are long DFMA sequences, and each step's partners pass through
// L1 and L2 once per bucket.  Both are paid once per pair in the f64
// kernels (roll_apply_kernel_tiled, roll_apply_nd_kernel_tiled): a block
// owns kTile consecutive steps, one per thread; the leading buckets with
// k <= kHalo (the short prefix, chosen by the host to fit kSmemBudget; a
// short bucket after a long one runs on the long path, so each step's
// sums keep the list order) run from shared memory.  The tile and its
// halo h (the prefix's largest k), steps [t0 - h, t0 + kTile + h) each
// taken mod S, are staged once with cp.async.  The block then evaluates
// each pair (a, a + k) of each short bucket with an end in the tile
// once, the pairs of all short buckets round robin over its threads, into
// one pair table; after one barrier each step adds its two ends per
// bucket in list order.  The ends share d, safe, mu, |dx| and, in nD,
// mag^2 and r, since a - b = -(b - a) exactly; only the signs differ (1D:
// half_sgn, except where dx == 0 and both ends take 1e-9; nD: delta,
// except delta[0] = 1e-9 where mag^2 == 0) and the weights (equal but at
// the wrap-around, where both ends' guards fail together and each counts
// its own field).  1D tables hold both ends' updates and weights; nD ones
// r, both weights and mag^2 == 0, step t then forming -(w * r) * delta
// to its staged partner.  The long buckets follow as in the f32 kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kMaxWords = 4;
constexpr int kMaxProposals = 4 * kMaxWords;
constexpr int kMaxDims = 8;                   // ops/sweep_dense.MAX_DIMS
constexpr int kThreads = 256;
// The nD kernel's block: at 128 threads the compiler fits D = 2 in 32
// registers (36 at 256), a full SM of warps; 6% faster at D = 2, P = 8 on
// an H100 (tools/kernel_ab.py), equal at 64 threads.
constexpr int kThreadsNd = 128;
// The f64 kernels: steps per block (one per thread), the largest offset
// of a short bucket (the halo staged on each side of a tile), and the
// shared memory a block may take (the default limit; four or more blocks
// fit on an SM).  Against 256 / 128 and 512 / 256 on an H100
// (tools/kernel_ab.py, PERF.md), 128 / 64 was the fastest.
constexpr int kTile = 128;
constexpr int kHalo = 64;
constexpr int kSmemBudget = 48 * 1024;

// T: float or double, the run's dtype.
template <typename T>
struct RollParams {
  const T* xs;            // 1D: [S] positions; nD: [D, S] my_c
  const T* pos;           // [S] (nD: my_pos)
  const int* words[kMaxWords];
  const T* acc_in;        // 1D: dsum [S]; nD: acc [D, S]; NULL: +0
  const T* w_in;          // csum / wacc [S]; NULL: +0
  const uint8_t* lane0;   // nD: [S]
  const T* cs;            // nD: [2D, S]
  T* out;                 // 1D: [S]; nD: [2D, S]
  int S;
  int proposals;
  int n_words;
  int n_buckets;
  T eta;
  int k[kMaxBuckets];
  int ki[kMaxBuckets];
  int kmod[kMaxBuckets];      // k mod S
  int ahead[kMaxBuckets];     // the ahead guard t + k < S as t < ahead
  uint32_t last_live;         // the used fields' top bits, last word
  int n_short;                // f64: the short buckets, a prefix
  int halo;                   // f64: their largest k (0: none)
  int n_pairs;                // f64: their pairs per tile, sum of kTile + k
};

// Round-to-nearest arithmetic of either float type, in the plain
// version's order (the build passes --fmad=false).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
template <typename T>
__device__ __forceinline__ T to_float(int a);
template <>
__device__ __forceinline__ float to_float<float>(int a) { return __int2float_rn(a); }
template <>
__device__ __forceinline__ double to_float<double>(int a) { return __int2double_rn(a); }

// d, valid weight, safe and mu of a pair, shared by both engines.
template <typename T>
__device__ __forceinline__ void pair_base(T pa, T pb, T weight, T eta, T& w,
                                          T& safe, T& mu) {
  const T d = abs_(sub_rn(pa, pb));
  const bool valid = d != T(0);
  w = valid ? weight : T(0);
  safe = valid ? d : T(1);
  mu = min_(div_rn(eta, safe), T(1));
}

// The 1D update a receives from the pair (a, b): -w * r_x.
template <typename T>
__device__ __forceinline__ T half_1d(T xa, T pa, T xb, T pb, T weight, T eta,
                                     T& w) {
  T safe, mu;
  pair_base(pa, pb, weight, eta, w, safe, mu);
  T dx = sub_rn(xa, xb);
  dx = dx == T(0) ? T(1e-9) : dx;
  const T half_sgn = dx >= T(0) ? T(0.5) : T(-0.5);
  const T r = mul_rn(mul_rn(mu, sub_rn(abs_(dx), safe)), half_sgn);
  return mul_rn(-w, r);
}

// The nD updates a receives from the pair (a, b): -(w * r) * delta[d].
template <typename T, int D>
__device__ __forceinline__ void half_nd(T pa, const T (&ca)[D], T pb,
                                        const T (&cb)[D], T weight, T eta,
                                        T& w, T (&upd)[D]) {
  T safe, mu;
  pair_base(pa, pb, weight, eta, w, safe, mu);
  T delta[D];
#pragma unroll
  for (int d = 0; d < D; ++d) delta[d] = sub_rn(ca[d], cb[d]);
  T mag2 = mul_rn(delta[0], delta[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    mag2 = add_rn(mag2, mul_rn(delta[d], delta[d]));
  }
  if (mag2 == T(0)) {
    delta[0] = T(1e-9);
    mag2 = T(1e-18);
  }
  const T inv = div_rn(T(1), sqrt_rn(mag2));
  const T mag = mul_rn(mag2, inv);
  const T r_raw = mul_rn(mul_rn(mul_rn(mu, sub_rn(mag, safe)), T(0.5)), inv);
  // a NaN passes through, as in torch.clamp_max
  const T r = r_raw > T(1e30) ? T(1e30) : r_raw;
  const T neg_wr = -mul_rn(w, r);
#pragma unroll
  for (int d = 0; d < D; ++d) upd[d] = mul_rn(neg_wr, delta[d]);
}

// 0x80 in each 8-bit field of w equal to the broadcast byte b4, 0
// elsewhere and outside `live` (carry-free: no false matches).
__device__ __forceinline__ uint32_t eq_fields(uint32_t w, uint32_t b4,
                                              uint32_t live) {
  const uint32_t v = w ^ b4;
  return ~(((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v) & live;
}

// The weight of a pair, a word at a time: the proposals whose own
// field is the byte `mine` (broadcast), or, where `guard` holds, whose
// partner's field is `theirs`.  NW == 0: the raw choices (P == 1).
template <typename T, int NW>
__device__ __forceinline__ T weight_words(const uint32_t (&wa)[kMaxWords],
                                          const uint32_t (&wb)[kMaxWords],
                                          uint32_t mine, uint32_t theirs,
                                          bool guard, uint32_t last_live) {
  if (NW == 0) {
    return wa[0] == mine || (guard && wb[0] == theirs) ? T(1) : T(0);
  }
  const uint32_t g = guard ? 0xFFFFFFFFu : 0u;
  uint32_t m = 0u;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t live = j == NW - 1 ? last_live : 0x80808080u;
    // fields of word j land on bits 7 - j, 15 - j, 23 - j, 31 - j
    m |= (eq_fields(wa[j], mine, live) | (eq_fields(wb[j], theirs, live) & g))
         >> j;
  }
  return to_float<T>(__popc(m));
}

template <int NW, typename P>
__device__ __forceinline__ void load_words_n(const P& prm, int i,
                                             uint32_t (&w)[kMaxWords]) {
#pragma unroll
  for (int j = 0; j < (NW == 0 ? 1 : NW); ++j) {
    w[j] = static_cast<uint32_t>(__ldg(prm.words[j] + i));
  }
}

// The partners (t + k) mod S and (t - k) mod S of step t in [0, S), from
// km = k mod S, in 32 bits (S < 2^31, so t + km < 2^32).
__device__ __forceinline__ void partners(int t, int km, int S, int& ja,
                                         int& jb) {
  const uint32_t ja_u = static_cast<uint32_t>(t) + static_cast<uint32_t>(km);
  ja = static_cast<int>(
      ja_u >= static_cast<uint32_t>(S) ? ja_u - static_cast<uint32_t>(S) : ja_u);
  jb = t >= km ? t - km : t - km + S;
}

// The choices a bucket's pairs compare with: ki and ~ki raw (P == 1) or
// their byte broadcast to the 4 fields of a word.
template <int NW>
__device__ __forceinline__ void bucket_choices(int ki, uint32_t& plus,
                                               uint32_t& minus) {
  plus = NW == 0 ? static_cast<uint32_t>(ki)
                 : (static_cast<uint32_t>(ki) & 0xFFu) * 0x01010101u;
  minus = NW == 0 ? static_cast<uint32_t>(~ki)
                  : (static_cast<uint32_t>(~ki) & 0xFFu) * 0x01010101u;
}

// NW: choice words per step (1-4), 0 for the raw choices of P == 1.
template <typename T, int NW>
__global__ void __launch_bounds__(kThreads)
roll_apply_kernel(const RollParams<T> prm) {
  const int S = prm.S;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= S) return;
  const T* __restrict__ xs = prm.xs;
  const T* __restrict__ pos = prm.pos;
  const T x = __ldg(xs + t);
  const T p = __ldg(pos + t);
  uint32_t mine[kMaxWords];
  load_words_n<NW>(prm, t, mine);
  T dsum = prm.acc_in ? __ldg(prm.acc_in + t) : T(0);
  T csum = prm.w_in ? __ldg(prm.w_in + t) : T(0);
  for (int b = 0; b < prm.n_buckets; ++b) {
    int ja, jb;
    partners(t, prm.kmod[b], S, ja, jb);
    uint32_t plus, minus;
    bucket_choices<NW>(prm.ki[b], plus, minus);
    uint32_t wa[kMaxWords], wb[kMaxWords];
    load_words_n<NW>(prm, ja, wa);
    load_words_n<NW>(prm, jb, wb);
    const T xa = __ldg(xs + ja), pa = __ldg(pos + ja);
    const T xb = __ldg(xs + jb), pb = __ldg(pos + jb);
    T w1, w2;
    // partner ahead (t + k): I chose +k, or they chose -k
    const T u1 = half_1d(
        x, p, xa, pa,
        weight_words<T, NW>(mine, wa, plus, minus, t < prm.ahead[b],
                            prm.last_live),
        prm.eta, w1);
    // partner behind (t - k): I chose -k, or they chose +k
    const T u2 = half_1d(
        x, p, xb, pb,
        weight_words<T, NW>(mine, wb, minus, plus, t >= prm.k[b],
                            prm.last_live),
        prm.eta, w2);
    dsum = add_rn(add_rn(dsum, u1), u2);
    csum = add_rn(add_rn(csum, w1), w2);
  }
  prm.out[t] = add_rn(x, div_rn(dsum, csum < T(1) ? T(1) : csum));
}

// D: dimensions (1-8); NW: choice words per step (1-4), 0 for the raw
// choices of P == 1.
template <typename T, int D, int NW>
__global__ void __launch_bounds__(kThreadsNd)
roll_apply_nd_kernel(const RollParams<T> prm) {
  const int S = prm.S;
  const int t = blockIdx.x * kThreadsNd + threadIdx.x;
  if (t >= S) return;
  const T* __restrict__ pos = prm.pos;
  // row d of [D, S] / [2D, S] at d * S, formed in 64 bits
  const T* __restrict__ rows[D];
#pragma unroll
  for (int d = 0; d < D; ++d) rows[d] = prm.xs + static_cast<long long>(d) * S;
  const T p = __ldg(pos + t);
  T c[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    c[d] = __ldg(rows[d] + t);
    acc[d] = prm.acc_in ? __ldg(prm.acc_in + static_cast<long long>(d) * S + t)
                        : T(0);
  }
  uint32_t mine[kMaxWords];
  load_words_n<NW>(prm, t, mine);
  T wacc = prm.w_in ? __ldg(prm.w_in + t) : T(0);
  for (int b = 0; b < prm.n_buckets; ++b) {
    int ja, jb;
    partners(t, prm.kmod[b], S, ja, jb);
    uint32_t plus, minus;
    bucket_choices<NW>(prm.ki[b], plus, minus);
    uint32_t wa[kMaxWords], wb[kMaxWords];
    load_words_n<NW>(prm, ja, wa);
    load_words_n<NW>(prm, jb, wb);
    T ca[D], cb[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ca[d] = __ldg(rows[d] + ja);
      cb[d] = __ldg(rows[d] + jb);
    }
    const T pa = __ldg(pos + ja), pb = __ldg(pos + jb);
    T u1[D], u2[D], w1, w2;
    // partner ahead (t + k): I chose +k, or they chose -k
    half_nd<T, D>(p, c, pa, ca,
                  weight_words<T, NW>(mine, wa, plus, minus, t < prm.ahead[b],
                                      prm.last_live),
                  prm.eta, w1, u1);
    // partner behind (t - k): I chose -k, or they chose +k
    half_nd<T, D>(p, c, pb, cb,
                  weight_words<T, NW>(mine, wb, minus, plus, t >= prm.k[b],
                                      prm.last_live),
                  prm.eta, w2, u2);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = add_rn(add_rn(acc[d], u1[d]), u2[d]);
    wacc = add_rn(add_rn(wacc, w1), w2);
  }
  // the chosen end's rows take the mean update, the other end's + 0
  const bool lane0 = __ldg(prm.lane0 + t) != 0;
  const T div = wacc < T(1) ? T(1) : wacc;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const T upd = div_rn(acc[d], div);
    const long long r0 = static_cast<long long>(d) * S + t;
    const long long r1 = static_cast<long long>(D + d) * S + t;
    prm.out[r0] = add_rn(__ldg(prm.cs + r0), lane0 ? upd : T(0));
    prm.out[r1] = add_rn(__ldg(prm.cs + r1), lane0 ? T(0) : upd);
  }
}

// ---- the f64 kernels: a tile of steps and its halo in shared memory ----

// A staged step's words: NWS of them padded to 1, 2 or 4 (one shared
// load); its doubles (1D: x, pos; nD: my_c's D coordinates, my_pos)
// padded to an even count (loaded two at a time).
__host__ __device__ constexpr int padded_words(int nws) {
  return nws == 1 ? 1 : nws == 2 ? 2 : 4;
}
__host__ __device__ constexpr int padded_doubles(int n) { return n + (n & 1); }

// Shared memory of an f64 kernel for a halo h: the kTile + 2h steps
// [t0 - h, t0 + kTile + h), each `row_bytes` of doubles, then each
// `word_bytes` of words, then the pair table of `n_pairs` entries, each
// `tab_bytes` of doubles and one 4-byte word of weights (byte offsets).
struct TileLayout {
  int n_st, words, tab_f, tab_w, bytes;
};

__host__ __device__ inline TileLayout tile_layout(int h, int row_bytes,
                                                  int word_bytes, int n_pairs,
                                                  int tab_bytes) {
  TileLayout L;
  L.n_st = kTile + 2 * h;
  L.words = row_bytes * L.n_st;
  L.tab_f = (L.words + word_bytes * L.n_st + 15) & ~15;
  L.tab_w = L.tab_f + tab_bytes * n_pairs;
  L.bytes = L.tab_w + 4 * n_pairs;
  return L;
}

// (t mod S) for any int t.
__device__ __forceinline__ int wrap_index(int t, int S) {
  t %= S;
  return t < 0 ? t + S : t;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(kBytes)
               : "memory");
}

// Stage the steps [t0 - h, t0 + kTile + h), each taken mod S: step i's
// DP doubles at st[i * DP] (n_rows of them: row r < n_rows - 1 at
// xs + r * S, the last one pos) and its words at sw[i * NWP].
template <int DP, int NWS>
__device__ __forceinline__ void stage_tile(const RollParams<double>& prm,
                                           int n_rows, int t0, int h,
                                           int n_st, double* st,
                                           uint32_t* sw) {
  constexpr int NWP = padded_words(NWS);
  const int S = prm.S;
  for (int i = threadIdx.x; i < n_st; i += kTile) {
    int g = t0 - h + i;
    g = g >= 0 && g < S ? g : wrap_index(g, S);
    for (int r = 0; r < n_rows; ++r) {
      const double* row = r == n_rows - 1
                              ? prm.pos
                              : prm.xs + static_cast<long long>(r) * S;
      cp_async<8>(st + i * DP + r, row + g);
    }
#pragma unroll
    for (int j = 0; j < NWS; ++j) {
      cp_async<4>(sw + i * NWP + j, prm.words[j] + g);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Staged step i's words, in one shared load.
template <int NWS>
__device__ __forceinline__ void staged_words(const uint32_t* sw, int i,
                                             uint32_t (&w)[kMaxWords]) {
  constexpr int NWP = padded_words(NWS);
  if (NWP == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(sw)[i];
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if (NWP == 2) {
    const uint2 v = reinterpret_cast<const uint2*>(sw)[i];
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = sw[i];
  }
}

// Staged step i's DP doubles, two at a time.
template <int DP>
__device__ __forceinline__ void staged_row(const double* st, int i,
                                           double (&v)[DP]) {
  const double2* p = reinterpret_cast<const double2*>(st + i * DP);
#pragma unroll
  for (int d = 0; d < DP / 2; ++d) {
    const double2 q = p[d];
    v[2 * d] = q.x;
    v[2 * d + 1] = q.y;
  }
}

// Both ends' weights of the pair (a, b = a + k), a word at a time, as
// weight_words counts them at each end: end a the proposals whose field
// at a is `plus` or, where `guard` holds, whose field at b is `minus`;
// end b the converse.  The ends' wrap guards (a < S - k and b >= k, for
// a, b in [0, S)) hold together.
template <int NW>
__device__ __forceinline__ void pair_weights(const uint32_t (&fa)[kMaxWords],
                                             const uint32_t (&fb)[kMaxWords],
                                             uint32_t plus, uint32_t minus,
                                             bool guard, uint32_t last_live,
                                             int& na, int& nb) {
  if (NW == 0) {
    const bool a = fa[0] == plus, b = fb[0] == minus;
    na = a || (guard && b);
    nb = b || (guard && a);
    return;
  }
  uint32_t ma = 0u, mb = 0u;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t live = j == NW - 1 ? last_live : 0x80808080u;
    ma |= eq_fields(fa[j], plus, live) >> j;
    mb |= eq_fields(fb[j], minus, live) >> j;
  }
  const uint32_t g = guard ? 0xFFFFFFFFu : 0u;
  na = __popc(ma | (mb & g));
  nb = __popc(mb | (ma & g));
}

// The pair's d != 0, safe and mu (pair_base with a unit weight: 1 where
// the pair counts).
__device__ __forceinline__ bool pair_valid(double pa, double pb, double eta,
                                           double& safe, double& mu) {
  double one;
  pair_base(pa, pb, 1.0, eta, one, safe, mu);
  return one != 0.0;
}

// The nD pair's update scale r from its delta, as half_nd forms it
// (delta[0] = 1e-9 where mag^2 == 0, flagged in `zero`): the same at
// both ends, as mag^2 is.
template <int D>
__device__ __forceinline__ double pair_scale(double (&delta)[D], double safe,
                                             double mu, bool& zero) {
  double mag2 = __dmul_rn(delta[0], delta[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    mag2 = __dadd_rn(mag2, __dmul_rn(delta[d], delta[d]));
  }
  zero = mag2 == 0.0;
  if (zero) {
    delta[0] = 1e-9;
    mag2 = 1e-18;
  }
  const double inv = __ddiv_rn(1.0, __dsqrt_rn(mag2));
  const double mag = __dmul_rn(mag2, inv);
  const double r_raw =
      __dmul_rn(__dmul_rn(__dmul_rn(mu, __dsub_rn(mag, safe)), 0.5), inv);
  return r_raw > 1e30 ? 1e30 : r_raw;
}

// A tile's staged steps (DP doubles and the words of each, from t0 - h)
// and the guard rule: where S >= kTile + 2 kHalo (`fast`) the pair
// (a, a + k) with a = t0 + j - k in [-k, S) wraps, and fails its guard,
// exactly where a < 0 or a + k >= S; otherwise a mod S < S - k, or never
// where k >= S.
struct Tile {
  const double* st;
  const uint32_t* sw;
  int h, t0;
  bool fast;
};

__device__ __forceinline__ bool pair_guard(const RollParams<double>& prm,
                                           const Tile& tl, int b, int a) {
  const int k = prm.k[b];
  return tl.fast ? a >= 0 && a + k < prm.S
                 : wrap_index(a, prm.S) < prm.ahead[b];
}

// Both ends of pair j of short bucket b in 1D: the updates and the
// weights (0 where d == 0) the ends a = t0 + j - k (staged at h - k + j)
// and a + k (at h + j) receive, the weights packed na | nb << 8.
struct Pair1d {
  double2 u;
  uint32_t w;
};

template <int NW>
__device__ __forceinline__ Pair1d pair_1d(const RollParams<double>& prm,
                                          const Tile& tl, int b, int j) {
  constexpr int NWS = NW == 0 ? 1 : NW;
  const int k = prm.k[b];
  const int la = tl.h - k + j, lb = tl.h + j;
  uint32_t plus, minus;
  bucket_choices<NW>(prm.ki[b], plus, minus);
  uint32_t fa[kMaxWords], fb[kMaxWords];
  staged_words<NWS>(tl.sw, la, fa);
  staged_words<NWS>(tl.sw, lb, fb);
  const double2 A = reinterpret_cast<const double2*>(tl.st)[la];   // x, pos
  const double2 B = reinterpret_cast<const double2*>(tl.st)[lb];
  int na, nb;
  pair_weights<NW>(fa, fb, plus, minus, pair_guard(prm, tl, b, tl.t0 + j - k),
                   prm.last_live, na, nb);
  double safe, mu;
  const bool valid = pair_valid(A.y, B.y, prm.eta, safe, mu);
  double dxa = __dsub_rn(A.x, B.x);
  double dxb = __dsub_rn(B.x, A.x);
  dxa = dxa == 0.0 ? 1e-9 : dxa;
  dxb = dxb == 0.0 ? 1e-9 : dxb;
  // mu * (|dx| - safe), the same at both ends; then half_1d's signs
  const double q = __dmul_rn(mu, __dsub_rn(fabs(dxa), safe));
  na = valid ? na : 0;
  nb = valid ? nb : 0;
  Pair1d r;
  r.u.x = __dmul_rn(-__int2double_rn(na),
                    __dmul_rn(q, dxa >= 0.0 ? 0.5 : -0.5));
  r.u.y = __dmul_rn(-__int2double_rn(nb),
                    __dmul_rn(q, dxb >= 0.0 ? 0.5 : -0.5));
  r.w = static_cast<uint32_t>(na) | static_cast<uint32_t>(nb) << 8;
  return r;
}

// The nD twin: r (the same at both ends) and the weights, packed
// na | nb << 8 | (mag^2 == 0) << 16.
struct PairNd {
  double r;
  uint32_t w;
};

template <int D, int NW>
__device__ __forceinline__ PairNd pair_nd(const RollParams<double>& prm,
                                          const Tile& tl, int b, int j) {
  constexpr int NWS = NW == 0 ? 1 : NW;
  constexpr int DP = padded_doubles(D + 1);
  const int k = prm.k[b];
  const int la = tl.h - k + j, lb = tl.h + j;
  uint32_t plus, minus;
  bucket_choices<NW>(prm.ki[b], plus, minus);
  uint32_t fa[kMaxWords], fb[kMaxWords];
  staged_words<NWS>(tl.sw, la, fa);
  staged_words<NWS>(tl.sw, lb, fb);
  double A[DP], B[DP];   // coordinates, then pos
  staged_row<DP>(tl.st, la, A);
  staged_row<DP>(tl.st, lb, B);
  int na, nb;
  pair_weights<NW>(fa, fb, plus, minus, pair_guard(prm, tl, b, tl.t0 + j - k),
                   prm.last_live, na, nb);
  double safe, mu;
  const bool valid = pair_valid(A[D], B[D], prm.eta, safe, mu);
  double delta[D];
#pragma unroll
  for (int d = 0; d < D; ++d) delta[d] = __dsub_rn(A[d], B[d]);
  bool zero;
  PairNd r;
  r.r = pair_scale<D>(delta, safe, mu, zero);
  r.w = static_cast<uint32_t>(valid ? na : 0) |
        static_cast<uint32_t>(valid ? nb : 0) << 8 |
        static_cast<uint32_t>(zero) << 16;
  return r;
}

// Pair j of short bucket b sits at table entry off_b + j, off_b the sum
// of kTile + k over the buckets before it.  Thread tid takes pair tid of
// every short bucket, two buckets a round (two independent chains; with
// an odd count the last round repeats its first, unstored), then the
// extra pairs j in [kTile, kTile + k) of all of them round robin:
// extra e is pair kTile + e - (the k of the buckets before) of the
// first bucket whose k it does not pass.
struct Extra {
  int b, j, entry;
};

__device__ __forceinline__ Extra extra_pair(const RollParams<double>& prm,
                                            int e) {
  int b = 0, off = 0;
  while (e >= prm.k[b]) {
    e -= prm.k[b];
    off += kTile + prm.k[b];
    ++b;
  }
  return Extra{b, kTile + e, off + kTile + e};
}

// 1D f64.  A block owns the tile [t0, t0 + kTile), one step per thread.
// The short buckets (the prefix of n_short) run from shared memory: the
// tile and its halo h are staged once; the block evaluates each pair
// (a, a + k) of each short bucket with an end in the tile once (pair j
// of bucket b: a = t0 + j - k, j in [0, kTile + k)), both ends' updates
// and weights into the pair table, and after one barrier step t adds,
// per short bucket in order, pair t - t0 + k's first end and pair
// t - t0's second.  The long buckets follow as in the f32 kernel.
template <int NW>
__global__ void __launch_bounds__(kTile)
roll_apply_kernel_tiled(const __grid_constant__ RollParams<double> prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NWS = NW == 0 ? 1 : NW;
  const int S = prm.S;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const int t = t0 + tid;
  const bool live = t < S;
  const double* __restrict__ xs = prm.xs;
  const double* __restrict__ pos = prm.pos;
  double x = 0.0, p = 0.0, dsum = 0.0, csum = 0.0;
  uint32_t mine[kMaxWords] = {};
  if (live) {
    x = __ldg(xs + t);
    p = __ldg(pos + t);
    load_words_n<NW>(prm, t, mine);
    dsum = prm.acc_in ? __ldg(prm.acc_in + t) : 0.0;
    csum = prm.w_in ? __ldg(prm.w_in + t) : 0.0;
  }
  if (prm.n_short > 0) {
    const int h = prm.halo, n = prm.n_pairs;
    const TileLayout L =
        tile_layout(h, 16, 4 * padded_words(NWS), n, 16);
    double* st = reinterpret_cast<double*>(smem);
    uint32_t* sw = reinterpret_cast<uint32_t*>(smem + L.words);
    double2* tu = reinterpret_cast<double2*>(smem + L.tab_f);
    uint32_t* tw = reinterpret_cast<uint32_t*>(smem + L.tab_w);
    stage_tile<2, NWS>(prm, 2, t0, h, L.n_st, st, sw);
    const Tile tl{st, sw, h, t0, S >= kTile + 2 * kHalo};
    for (int b = 0, off = 0; b < prm.n_short; b += 2) {
      const bool two = b + 1 < prm.n_short;
      const Pair1d r1 = pair_1d<NW>(prm, tl, b, tid);
      const Pair1d r2 = pair_1d<NW>(prm, tl, two ? b + 1 : b, tid);
      tu[off + tid] = r1.u;
      tw[off + tid] = r1.w;
      off += kTile + prm.k[b];
      if (two) {
        tu[off + tid] = r2.u;
        tw[off + tid] = r2.w;
        off += kTile + prm.k[b + 1];
      }
    }
    for (int e = tid; e < n - prm.n_short * kTile; e += kTile) {
      const Extra x = extra_pair(prm, e);
      const Pair1d r = pair_1d<NW>(prm, tl, x.b, x.j);
      tu[x.entry] = r.u;
      tw[x.entry] = r.w;
    }
    __syncthreads();
    if (live) {
      for (int b = 0, off = 0; b < prm.n_short; off += kTile + prm.k[b], ++b) {
        const int i1 = off + tid + prm.k[b], i2 = off + tid;
        const uint32_t w1 = tw[i1], w2 = tw[i2];
        dsum = __dadd_rn(__dadd_rn(dsum, tu[i1].x), tu[i2].y);
        csum = __dadd_rn(__dadd_rn(csum, __int2double_rn(w1 & 0xFFu)),
                         __int2double_rn(w2 >> 8));
      }
    }
  }
  if (!live) return;
  // the long buckets, as roll_apply_kernel
  for (int b = prm.n_short; b < prm.n_buckets; ++b) {
    int ja, jb;
    partners(t, prm.kmod[b], S, ja, jb);
    uint32_t plus, minus;
    bucket_choices<NW>(prm.ki[b], plus, minus);
    uint32_t fa[kMaxWords], fb[kMaxWords];
    load_words_n<NW>(prm, ja, fa);
    load_words_n<NW>(prm, jb, fb);
    double w1, w2;
    const double u1 = half_1d(
        x, p, __ldg(xs + ja), __ldg(pos + ja),
        weight_words<double, NW>(mine, fa, plus, minus, t < prm.ahead[b],
                                 prm.last_live),
        prm.eta, w1);
    const double u2 = half_1d(
        x, p, __ldg(xs + jb), __ldg(pos + jb),
        weight_words<double, NW>(mine, fb, minus, plus, t >= prm.k[b],
                                 prm.last_live),
        prm.eta, w2);
    dsum = __dadd_rn(__dadd_rn(dsum, u1), u2);
    csum = __dadd_rn(__dadd_rn(csum, w1), w2);
  }
  prm.out[t] = __dadd_rn(x, __ddiv_rn(dsum, csum < 1.0 ? 1.0 : csum));
}

// nD f64, as the 1D kernel: a staged step holds my_c's D coordinates and
// my_pos; the pair table holds each pair's r (the same at both ends),
// both ends' weights and whether mag^2 == 0, and step t forms its own
// delta to its staged partner (the other end's negated, exactly, but for
// delta[0] = 1e-9 where mag^2 == 0) and -(w * r) * delta.
template <int D, int NW>
__global__ void __launch_bounds__(kTile)
roll_apply_nd_kernel_tiled(const __grid_constant__ RollParams<double> prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NWS = NW == 0 ? 1 : NW;
  constexpr int DP = padded_doubles(D + 1);
  const int S = prm.S;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const int t = t0 + tid;
  const bool live = t < S;
  const double* __restrict__ pos = prm.pos;
  // row d of [D, S] / [2D, S] at d * S, formed in 64 bits
  const double* __restrict__ rows[D];
#pragma unroll
  for (int d = 0; d < D; ++d) rows[d] = prm.xs + static_cast<long long>(d) * S;
  double p = 0.0, wacc = 0.0, c[D], acc[D];
  uint32_t mine[kMaxWords] = {};
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = acc[d] = 0.0;
  if (live) {
    p = __ldg(pos + t);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      c[d] = __ldg(rows[d] + t);
      acc[d] = prm.acc_in
                   ? __ldg(prm.acc_in + static_cast<long long>(d) * S + t)
                   : 0.0;
    }
    load_words_n<NW>(prm, t, mine);
    wacc = prm.w_in ? __ldg(prm.w_in + t) : 0.0;
    // the combine's inputs, read after every bucket: into L2 now
    asm volatile("prefetch.global.L2 [%0];" ::"l"(prm.lane0 + t));
#pragma unroll
    for (int d = 0; d < 2 * D; ++d) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          prm.cs + static_cast<long long>(d) * S + t));
    }
  }
  if (prm.n_short > 0) {
    const int h = prm.halo, n = prm.n_pairs;
    const TileLayout L =
        tile_layout(h, 8 * DP, 4 * padded_words(NWS), n, 8);
    double* st = reinterpret_cast<double*>(smem);
    uint32_t* sw = reinterpret_cast<uint32_t*>(smem + L.words);
    double* tr = reinterpret_cast<double*>(smem + L.tab_f);
    uint32_t* tw = reinterpret_cast<uint32_t*>(smem + L.tab_w);
    stage_tile<DP, NWS>(prm, D + 1, t0, h, L.n_st, st, sw);
    const Tile tl{st, sw, h, t0, S >= kTile + 2 * kHalo};
    for (int b = 0, off = 0; b < prm.n_short; b += 2) {
      const bool two = b + 1 < prm.n_short;
      const PairNd r1 = pair_nd<D, NW>(prm, tl, b, tid);
      const PairNd r2 = pair_nd<D, NW>(prm, tl, two ? b + 1 : b, tid);
      tr[off + tid] = r1.r;
      tw[off + tid] = r1.w;
      off += kTile + prm.k[b];
      if (two) {
        tr[off + tid] = r2.r;
        tw[off + tid] = r2.w;
        off += kTile + prm.k[b + 1];
      }
    }
    for (int e = tid; e < n - prm.n_short * kTile; e += kTile) {
      const Extra x = extra_pair(prm, e);
      const PairNd r = pair_nd<D, NW>(prm, tl, x.b, x.j);
      tr[x.entry] = r.r;
      tw[x.entry] = r.w;
    }
    __syncthreads();
    if (live) {
      for (int b = 0, off = 0; b < prm.n_short; off += kTile + prm.k[b], ++b) {
        const int k = prm.k[b];
        const int i1 = off + tid + k, i2 = off + tid;
        const uint32_t tw1 = tw[i1], tw2 = tw[i2];
        const double w1 = __int2double_rn(tw1 & 0xFFu);
        const double w2 = __int2double_rn((tw2 >> 8) & 0xFFu);
        const double nwr1 = -__dmul_rn(w1, tr[i1]);
        const double nwr2 = -__dmul_rn(w2, tr[i2]);
        double ca[DP], cb[DP];
        staged_row<DP>(st, h + tid + k, ca);
        staged_row<DP>(st, h + tid - k, cb);
        double u1[D], u2[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          double d1 = __dsub_rn(c[d], ca[d]);
          double d2 = __dsub_rn(c[d], cb[d]);
          if (d == 0) {
            d1 = tw1 >> 16 ? 1e-9 : d1;
            d2 = tw2 >> 16 ? 1e-9 : d2;
          }
          u1[d] = __dmul_rn(nwr1, d1);
          u2[d] = __dmul_rn(nwr2, d2);
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          acc[d] = __dadd_rn(__dadd_rn(acc[d], u1[d]), u2[d]);
        }
        wacc = __dadd_rn(__dadd_rn(wacc, w1), w2);
      }
    }
  }
  if (!live) return;
  // the long buckets and the combine, as roll_apply_nd_kernel
  for (int b = prm.n_short; b < prm.n_buckets; ++b) {
    int ja, jb;
    partners(t, prm.kmod[b], S, ja, jb);
    uint32_t plus, minus;
    bucket_choices<NW>(prm.ki[b], plus, minus);
    uint32_t fa[kMaxWords], fb[kMaxWords];
    load_words_n<NW>(prm, ja, fa);
    load_words_n<NW>(prm, jb, fb);
    double ca[D], cb[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ca[d] = __ldg(rows[d] + ja);
      cb[d] = __ldg(rows[d] + jb);
    }
    double u1[D], u2[D], w1, w2;
    half_nd<double, D>(p, c, __ldg(pos + ja), ca,
                       weight_words<double, NW>(mine, fa, plus, minus,
                                                t < prm.ahead[b],
                                                prm.last_live),
                       prm.eta, w1, u1);
    half_nd<double, D>(p, c, __ldg(pos + jb), cb,
                       weight_words<double, NW>(mine, fb, minus, plus,
                                                t >= prm.k[b], prm.last_live),
                       prm.eta, w2, u2);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      acc[d] = __dadd_rn(__dadd_rn(acc[d], u1[d]), u2[d]);
    }
    wacc = __dadd_rn(__dadd_rn(wacc, w1), w2);
  }
  const bool lane0 = __ldg(prm.lane0 + t) != 0;
  const double div = wacc < 1.0 ? 1.0 : wacc;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const double upd = __ddiv_rn(acc[d], div);
    const long long r0 = static_cast<long long>(d) * S + t;
    const long long r1 = static_cast<long long>(D + d) * S + t;
    prm.out[r0] = __dadd_rn(__ldg(prm.cs + r0), lane0 ? upd : 0.0);
    prm.out[r1] = __dadd_rn(__ldg(prm.cs + r1), lane0 ? 0.0 : upd);
  }
}

// The f64 kernels' short prefix: the leading buckets with k <= kHalo
// whose staged tile and pair table fit kSmemBudget (staged steps of
// `row_bytes` of doubles, table entries of `tab_bytes` of doubles).
// Returns the shared memory it takes (0: none).
int short_prefix(RollParams<double>& prm, int row_bytes, int tab_bytes) {
  prm.n_short = prm.halo = prm.n_pairs = 0;
  if (prm.S > INT_MAX - (kTile + 2 * kHalo)) return 0;
  const int word_bytes = 4 * padded_words(prm.n_words);
  int bytes = 0;
  for (int b = 0; b < prm.n_buckets && prm.k[b] <= kHalo; ++b) {
    const int h = prm.k[b] > prm.halo ? prm.k[b] : prm.halo;
    const int n = prm.n_pairs + kTile + prm.k[b];
    const int need = tile_layout(h, row_bytes, word_bytes, n, tab_bytes).bytes;
    if (need > kSmemBudget) break;
    prm.n_short = b + 1;
    prm.halo = h;
    prm.n_pairs = n;
    bytes = need;
  }
  return bytes;
}

// Launch an f64 kernel with `bytes` of shared memory.
template <typename K>
int launch_tiled(K kernel, const RollParams<double>& prm, int bytes,
                 cudaStream_t st) {
  kernel<<<(prm.S + kTile - 1) / kTile, kTile, bytes, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int check_and_fill(RollParams<T>& prm, int device, const T* xs, const T* pos,
                   const int* w0, const int* w1, const int* w2, const int* w3,
                   int n_words, int proposals, int S, T eta, const int* ks,
                   const int* kis, int n_buckets, const T* acc_in,
                   const T* w_in, T* out) {
  if (S <= 0 || n_buckets < 0 || n_buckets > kMaxBuckets || n_words < 1 ||
      n_words > kMaxWords || proposals < 1 || proposals > kMaxProposals ||
      (proposals == 1 && n_words != 1) ||
      (proposals > 1 && n_words != (proposals + 3) / 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b = 0; b < n_buckets; ++b) {
    if (ks[b] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  prm.xs = xs;
  prm.pos = pos;
  prm.words[0] = w0;
  prm.words[1] = w1;
  prm.words[2] = w2;
  prm.words[3] = w3;
  prm.acc_in = acc_in;
  prm.w_in = w_in;
  prm.lane0 = nullptr;
  prm.cs = nullptr;
  prm.out = out;
  prm.S = S;
  prm.proposals = proposals;
  prm.n_words = n_words;
  prm.n_buckets = n_buckets;
  prm.eta = eta;
  for (int b = 0; b < kMaxBuckets; ++b) {
    prm.k[b] = b < n_buckets ? ks[b] : 0;
    prm.ki[b] = b < n_buckets ? kis[b] : 0;
    prm.kmod[b] = prm.k[b] % S;
    prm.ahead[b] = prm.k[b] < S ? S - prm.k[b] : 0;
  }
  const int used = proposals - 4 * (n_words - 1);   // fields of the last word
  prm.last_live = 0x80808080u >> (8 * (4 - used));
  return 0;
}

template <typename T>
int roll_1d(int device, const T* xs, const T* pos, const int* w0,
            const int* w1, const int* w2, const int* w3, int n_words,
            int proposals, int S, T eta, const int* ks, const int* kis,
            int n_buckets, const T* dsum, const T* csum, T* out,
            void* stream) {
  RollParams<T> prm;
  const int err = check_and_fill(prm, device, xs, pos, w0, w1, w2, w3,
                                 n_words, proposals, S, eta, ks, kis,
                                 n_buckets, dsum, csum, out);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = proposals == 1 ? 0 : n_words;
  if constexpr (std::is_same<T, double>::value) {
    const int bytes = short_prefix(prm, 16, 16);
    switch (nw) {
      case 0: return launch_tiled(roll_apply_kernel_tiled<0>, prm, bytes, st);
      case 1: return launch_tiled(roll_apply_kernel_tiled<1>, prm, bytes, st);
      case 2: return launch_tiled(roll_apply_kernel_tiled<2>, prm, bytes, st);
      case 3: return launch_tiled(roll_apply_kernel_tiled<3>, prm, bytes, st);
      default: return launch_tiled(roll_apply_kernel_tiled<4>, prm, bytes, st);
    }
  } else {
    const int blocks = (S + kThreads - 1) / kThreads;
    switch (nw) {
      case 0: roll_apply_kernel<T, 0><<<blocks, kThreads, 0, st>>>(prm); break;
      case 1: roll_apply_kernel<T, 1><<<blocks, kThreads, 0, st>>>(prm); break;
      case 2: roll_apply_kernel<T, 2><<<blocks, kThreads, 0, st>>>(prm); break;
      case 3: roll_apply_kernel<T, 3><<<blocks, kThreads, 0, st>>>(prm); break;
      default: roll_apply_kernel<T, 4><<<blocks, kThreads, 0, st>>>(prm); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int launch_nd(RollParams<T>& prm, cudaStream_t st) {
  const int nw = prm.proposals == 1 ? 0 : prm.n_words;
  if constexpr (std::is_same<T, double>::value) {
    const int bytes = short_prefix(prm, 8 * padded_doubles(D + 1), 8);
    switch (nw) {
      case 0: return launch_tiled(roll_apply_nd_kernel_tiled<D, 0>, prm, bytes, st);
      case 1: return launch_tiled(roll_apply_nd_kernel_tiled<D, 1>, prm, bytes, st);
      case 2: return launch_tiled(roll_apply_nd_kernel_tiled<D, 2>, prm, bytes, st);
      case 3: return launch_tiled(roll_apply_nd_kernel_tiled<D, 3>, prm, bytes, st);
      default: return launch_tiled(roll_apply_nd_kernel_tiled<D, 4>, prm, bytes, st);
    }
  } else {
    const int blocks = (prm.S + kThreadsNd - 1) / kThreadsNd;
    switch (nw) {
      case 0: roll_apply_nd_kernel<T, D, 0><<<blocks, kThreadsNd, 0, st>>>(prm); break;
      case 1: roll_apply_nd_kernel<T, D, 1><<<blocks, kThreadsNd, 0, st>>>(prm); break;
      case 2: roll_apply_nd_kernel<T, D, 2><<<blocks, kThreadsNd, 0, st>>>(prm); break;
      case 3: roll_apply_nd_kernel<T, D, 3><<<blocks, kThreadsNd, 0, st>>>(prm); break;
      default: roll_apply_nd_kernel<T, D, 4><<<blocks, kThreadsNd, 0, st>>>(prm); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int roll_nd(int device, const T* my_pos, const T* my_c, int D,
            const unsigned char* lane0, const T* cs, const int* w0,
            const int* w1, const int* w2, const int* w3, int n_words,
            int proposals, int S, T eta, const int* ks, const int* kis,
            int n_buckets, const T* acc, const T* wacc, T* out,
            void* stream) {
  if (D < 1 || D > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  RollParams<T> prm;
  const int err = check_and_fill(prm, device, my_c, my_pos, w0, w1, w2, w3,
                                 n_words, proposals, S, eta, ks, kis,
                                 n_buckets, acc, wacc, out);
  if (err != 0) return err;
  prm.lane0 = lane0;
  prm.cs = cs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return launch_nd<T, 1>(prm, st);
    case 2: return launch_nd<T, 2>(prm, st);
    case 3: return launch_nd<T, 3>(prm, st);
    case 4: return launch_nd<T, 4>(prm, st);
    case 5: return launch_nd<T, 5>(prm, st);
    case 6: return launch_nd<T, 6>(prm, st);
    case 7: return launch_nd<T, 7>(prm, st);
    default: return launch_nd<T, 8>(prm, st);
  }
}

}  // namespace

// C interfaces, bound with ctypes.  Device pointers: xs, pos, w0..w3
// (n_words of them, the rest NULL), dsum / csum (NULL: +0), out.  Host
// arrays: ks, kis (n_buckets entries, 0 allowed: the combine alone).
// Launch on `stream` of device `device`; return cudaGetLastError() as an
// int (0 = launched).  The _f64 entry points take double arrays and eta.
extern "C" int gfasort_roll_apply(
    int device, const float* xs, const float* pos,
    const int* w0, const int* w1, const int* w2, const int* w3,
    int n_words, int proposals, int S, float eta,
    const int* ks, const int* kis, int n_buckets,
    const float* dsum, const float* csum, float* out, void* stream) {
  return roll_1d<float>(device, xs, pos, w0, w1, w2, w3, n_words, proposals,
                        S, eta, ks, kis, n_buckets, dsum, csum, out, stream);
}

extern "C" int gfasort_roll_apply_f64(
    int device, const double* xs, const double* pos,
    const int* w0, const int* w1, const int* w2, const int* w3,
    int n_words, int proposals, int S, double eta,
    const int* ks, const int* kis, int n_buckets,
    const double* dsum, const double* csum, double* out, void* stream) {
  return roll_1d<double>(device, xs, pos, w0, w1, w2, w3, n_words, proposals,
                         S, eta, ks, kis, n_buckets, dsum, csum, out, stream);
}

// The nD twin: my_pos [S], my_c [D, S], lane0 [S] (bytes 0 / 1), cs
// [2D, S], acc [D, S] / wacc [S] (NULL: +0), out [2D, S]; 1 <= D <= 8.
extern "C" int gfasort_roll_apply_nd(
    int device, const float* my_pos, const float* my_c, int D,
    const unsigned char* lane0, const float* cs,
    const int* w0, const int* w1, const int* w2, const int* w3,
    int n_words, int proposals, int S, float eta,
    const int* ks, const int* kis, int n_buckets,
    const float* acc, const float* wacc, float* out, void* stream) {
  return roll_nd<float>(device, my_pos, my_c, D, lane0, cs, w0, w1, w2, w3,
                        n_words, proposals, S, eta, ks, kis, n_buckets, acc,
                        wacc, out, stream);
}

extern "C" int gfasort_roll_apply_nd_f64(
    int device, const double* my_pos, const double* my_c, int D,
    const unsigned char* lane0, const double* cs,
    const int* w0, const int* w1, const int* w2, const int* w3,
    int n_words, int proposals, int S, double eta,
    const int* ks, const int* kis, int n_buckets,
    const double* acc, const double* wacc, double* out, void* stream) {
  return roll_nd<double>(device, my_pos, my_c, D, lane0, cs, w0, w1, w2, w3,
                         n_words, proposals, S, eta, ks, kis, n_buckets, acc,
                         wacc, out, stream);
}
