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
// Both kernels are templated on the float type as well: the f64 route
// (gfasort_tpu/ops/sweep.py:328-380 and sweep_nd.py:105-185 at f64, where
// every bucket of a phase is a roll bucket) runs them in double, with
// the double ops in the same order (__d*_rn), the constants 1e-9, 0.5,
// 1e-18 and 1e30 and eta in double, and the nD rsqrt as 1.0 /
// __dsqrt_rn, as the plain version's sqrt_rn.  A double load is twice a
// float's bytes, and the double IEEE divide and square root are long
// instruction sequences: the f64 kernels are bound by those beside the
// field match.
// Left for later: evaluating each pair once (the bucket kernels' pair
// table does not reach partners k > KMAX away).

#include <cuda_runtime.h>
#include <stdint.h>

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
  const int blocks = (S + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (proposals == 1 ? 0 : n_words) {
    case 0: roll_apply_kernel<T, 0><<<blocks, kThreads, 0, st>>>(prm); break;
    case 1: roll_apply_kernel<T, 1><<<blocks, kThreads, 0, st>>>(prm); break;
    case 2: roll_apply_kernel<T, 2><<<blocks, kThreads, 0, st>>>(prm); break;
    case 3: roll_apply_kernel<T, 3><<<blocks, kThreads, 0, st>>>(prm); break;
    default: roll_apply_kernel<T, 4><<<blocks, kThreads, 0, st>>>(prm); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
void launch_nd(const RollParams<T>& prm, int blocks, cudaStream_t st) {
  switch (prm.proposals == 1 ? 0 : prm.n_words) {
    case 0: roll_apply_nd_kernel<T, D, 0><<<blocks, kThreadsNd, 0, st>>>(prm); break;
    case 1: roll_apply_nd_kernel<T, D, 1><<<blocks, kThreadsNd, 0, st>>>(prm); break;
    case 2: roll_apply_nd_kernel<T, D, 2><<<blocks, kThreadsNd, 0, st>>>(prm); break;
    case 3: roll_apply_nd_kernel<T, D, 3><<<blocks, kThreadsNd, 0, st>>>(prm); break;
    default: roll_apply_nd_kernel<T, D, 4><<<blocks, kThreadsNd, 0, st>>>(prm); break;
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
  const int blocks = (S + kThreadsNd - 1) / kThreadsNd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: launch_nd<T, 1>(prm, blocks, st); break;
    case 2: launch_nd<T, 2>(prm, blocks, st); break;
    case 3: launch_nd<T, 3>(prm, blocks, st); break;
    case 4: launch_nd<T, 4>(prm, blocks, st); break;
    case 5: launch_nd<T, 5>(prm, blocks, st); break;
    case 6: launch_nd<T, 6>(prm, blocks, st); break;
    case 7: launch_nd<T, 7>(prm, blocks, st); break;
    default: launch_nd<T, 8>(prm, blocks, st); break;
  }
  return static_cast<int>(cudaGetLastError());
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
