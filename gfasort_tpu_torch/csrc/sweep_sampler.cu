// Per-sweep sampler of the sweep engines, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port's counterpart of the XLA
// fusions of gfasort_tpu/ops/sweep_common.py::sweep_rng (hash mode,
// :34-85), ::sample_blocks (:491-566) and ::pack_choices /
// pack_choices_words (:249-269).  The plain PyTorch version,
// ops/sweep_common.py::sample_words_ref, runs the same composition one
// torch op at a time.  For every step t and proposal p < P:
//   h = mix(t + b1[p]), bits = mix(h ^ b2[p]),
//   u = (mix(h ^ (b2[p] * 0x9E3779B9 + 0x632BE59B)) >> 8) * 2^-24,
// then the shared-chain sampler: the direction coin (bit 30, or the
// path's last step) picks the backward or the forward chain (its jump
// space min(avail, space) and the Zipf constants of that space's
// bucket), the Zipf draw (bit 31, or every draw while cooling) or the
// uniform one, the stochastic snap to the offset set (promotion by
// bits 20-28 against the draw's place between two offsets) or the
// downward one, the activity coin (bits 0-19 against active_frac * 2^20)
// and the end guards.  The choice is ki (jump +offs[ki]), ~ki (jump
// -offs[ki]) or INACTIVE.  Outputs: for P > 1 the ceil(P/4) packed words
// (proposal p in the signed 8-bit field p % 4 of word p / 4, INACTIVE ->
// 127, unused fields 0); for P == 1 the raw choice array; on request
// proposal 0's end coin (bits >> 29) & 1 for the nD engine.
//
// What bounds it on the card: integer work.  It reads rank and cnt (8
// bytes) and writes 4 bytes per word (12 at P = 12) per step, but does
// per proposal about 60 int32 ops (three murmur finalisers, 31 with the
// counter's add and the XORs; the coins, the draws' selects, the offset
// search, the activity and the packing), a logf, an expf and an IEEE
// divide, and 5 conversions (chip_smoke.py::ops_sampler writes them out).
//
// Design: one thread per step, the kernel templated on P (a compile-time
// trip count: straight-line code, so the proposals' independent chains
// interleave) and on the depth of the offset search.  The per-step work
// is hoisted: the two direction chains (jump space, its count, its Zipf
// constants, n and max(avail, 1) as floats, pinned in registers) and
// t * 0x9E3779B9, the first product of every proposal's first mix
// (b1 * 0x9E3779B9 comes from the host).  The phase's constants sit in
// shared memory in a layout that needs no conversion: a search table
// (the offsets padded with INT_MAX to a power of two above K) and, per
// count c = oidx + 1 in [0, K], the snapped offset (torch's wrap for
// oidx = -1), the next one, the first as a float and the span, read with
// one 16-byte load.  The search is branch-free and of fixed depth:
// c += (tab[c + s - 1] <= z) ? s : 0 for s = 2^(D-1) .. 1, which is
// searchsorted(right=True) exactly (c kept as a shared-memory address:
// three instructions a step).  Both draws are computed and one
// selected, and the snap mode, the cooling state and the activity coin
// are masks and selects, so the proposals run as straight-line code.
// u2's nine bits become a float without a conversion (1 + u2 - 1, exact).
// Every f32 op is an explicit round-to-nearest intrinsic in the plain
// version's order (eta_z * u - eta_z + 1 is three rounded ops, 1 + n * e
// two; the build passes --fmad=false), logf / expf are the IEEE-accurate
// library functions (never __expf), NaN becomes 0 before the clamps
// (fmaxf drops it), and float-to-int conversions truncate, so the words
// equal the plain version's on the card bit for bit.
//
// The threefry routes (GFASORT_SWEEP_RNG=threefry at f32, and every f64
// run) have their own kernel, sweep_sampler_tf_kernel<T, DEPTH>, for the
// JAX package's threefry draws (gfasort_tpu/ops/sweep_common.py:62-67):
// per proposal the keys (k1, k2) = split(key, 2) come from the host (the
// run's keys.threefry_key_table), and each step draws in registers,
// with threefry2x32 (20 rounds) of the counter (0, t): bits = b1 ^ b2
// under k1, and under k2 u = ((b1 ^ b2) >> 9 | 1.0f) - 1 at f32 or
// u = ((b1 << 20 | b2 >> 12) | 1.0) - 1 at f64; no [S] draw is written.
// Both kernels share the per-step chains (step_chains) and the
// per-proposal sampler (propose), templated on the float type: at
// double the Zipf draw's exp(alpha * log(arg)) and its 1e-30 clamp, the
// NaN guard, the truncations, the snap's divide and u2 run in double,
// with the library exp / log (never intrinsics) and IEEE double ops.
// What bounds the threefry kernel: integer work, two threefry calls of
// ~76 int32 ops a proposal beside the sampler's ~30, and at f64 the
// double divide, exp and log.  P is a runtime value there (a loop over
// the packed words, the four fields of a word unrolled): the hash
// kernel's per-P instantiation would triple the build for routes that
// plans choose rarely.
// Left for later: folding the sampler into the bucket kernel, so the
// words never go through memory; compacting a warp's Zipf draws in the
// warm case, where half the lanes discard theirs (the draw is ~30% of a
// proposal's instructions, so compaction would save ~15% before its own
// shuffles and shared-memory traffic).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 64;
constexpr int kMaxProposals = 16;
constexpr int kMaxWords = 4;
constexpr int kInactive = 0x7FFFFFF;          // sweep_common.INACTIVE
constexpr int kInactive8 = 127;               // sweep_common.INACTIVE8
constexpr int kThreads = 256;
// the search table: a power of two above kMaxOffsets
constexpr int kTable = 128;
// search depths: K <= 15 (every plan's phase) and K <= 127.  Depth 7
// alone is 5-9% slower at K <= 15 (3 wasted steps in each of the 2 + P
// searches a step; tools/kernel_ab.py, NVIDIA H100)
constexpr int kShallow = 4;
constexpr int kDeep = 7;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct SamplerParams {
  const int* rank;            // [S]
  const int* cnt;             // [S]
  const int* offs;            // [K], ascending
  const float* zeta;          // [K]
  const float* eta_z;         // [K]
  const float* zeta2theta;    // []
  const float* alpha;         // []
  int* words[kMaxWords];      // ceil(P/4) packed words, or the raw choices
  uint8_t* coin;              // [S] proposal 0's end coin, or NULL
  int S;
  int K;
  int space;
  int cooling;
  int thresh;                 // the activity coin's bound; < 0: all active
  int snap_down;
  uint32_t b2[kMaxProposals];
  uint32_t b1g[kMaxProposals];   // b1 * 0x9E3779B9
  uint32_t salt[kMaxProposals];  // b2 * 0x9E3779B9 + 0x632BE59B
};

// The threefry kernel's parameters: the constants in T, and in place of
// the hash words each proposal's key schedules.
template <typename T>
struct TfParams {
  const int* rank;            // [S]
  const int* cnt;             // [S]
  const int* offs;            // [K], ascending
  const T* zeta;              // [K]
  const T* eta_z;             // [K]
  const T* zeta2theta;        // []
  const T* alpha;             // []
  int* words[kMaxWords];      // ceil(P/4) packed words, or the raw choices
  uint8_t* coin;              // [S] proposal 0's end coin, or NULL
  int S;
  int K;
  int space;
  int cooling;
  int thresh;                 // the activity coin's bound; < 0: all active
  int snap_down;
  int proposals;
  // per proposal the key schedules of k1 (bits) and k2 (u): (k0, k1,
  // k0 ^ k1 ^ 0x1BD11BDA) each
  uint32_t ks[kMaxProposals][6];
};

// Per count c = oidx + 1: the snapped offset offs[oidx] (torch's wrap
// for oidx = -1), offs[min(oidx + 1, K - 1)], the first as a float and
// the span max(float(hi) - float(lo), 1) of the stochastic snap.
template <typename T>
struct __align__(16) Snap {
  int lo;
  int hi;
  T lo_f;
  T span;
};

// Per count: the Zipf constants (zeta, eta_z) of the count's bucket.
template <typename T>
struct __align__(2 * sizeof(T)) Chain {
  T zeta;
  T eta_z;
};

// Round-to-nearest arithmetic of either float type, in the plain
// version's order (the build passes --fmad=false); exp and log are the
// library's IEEE-accurate functions, as torch's CUDA exp / log.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp_lib(float a) { return expf(a); }
__device__ __forceinline__ double exp_lib(double a) { return exp(a); }
__device__ __forceinline__ float log_lib(float a) { return logf(a); }
__device__ __forceinline__ double log_lib(double a) { return log(a); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ int trunc_i(float a) { return __float2int_rz(a); }
__device__ __forceinline__ int trunc_i(double a) { return __double2int_rz(a); }
template <typename T>
__device__ __forceinline__ T to_float(int a);
template <>
__device__ __forceinline__ float to_float<float>(int a) { return __int2float_rn(a); }
template <>
__device__ __forceinline__ double to_float<double>(int a) { return __int2double_rn(a); }
// A value kept in a register: the compiler would recompute it per
// proposal.
__device__ __forceinline__ void pin(float& a) { asm volatile("" : "+f"(a)); }
__device__ __forceinline__ void pin(double& a) { asm volatile("" : "+d"(a)); }
__device__ __forceinline__ void pin(int& a) { asm volatile("" : "+r"(a)); }

// u2 = ((bits >> 20) & 0x1FF) * 2^-9, exactly, without a conversion:
// the nine bits as the top of a mantissa, 1 + u2 - 1.
__device__ __forceinline__ void u2_of(uint32_t bits, float& u2) {
  u2 = __fsub_rn(
      __uint_as_float(((bits >> 6) & (0x1FFu << 14)) | 0x3F800000u), 1.0f);
}
__device__ __forceinline__ void u2_of(uint32_t bits, double& u2) {
  const unsigned long long m =
      static_cast<unsigned long long>((bits >> 20) & 0x1FFu) << 43;
  u2 = __dsub_rn(
      __longlong_as_double(static_cast<long long>(m | 0x3FF0000000000000ull)),
      1.0);
}

// The murmur3 finaliser after its first product (sweep_common._mix is
// mix_tail(x * 0x9E3779B9)).
__device__ __forceinline__ uint32_t mix_tail(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  return mix_tail(x * kGolden);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3) ^ x0;
}

// threefry2x32, 20 rounds, of the counter (0, lo) under the key schedule
// (k0, k1, k2 = k0 ^ k1 ^ 0x1BD11BDA): ops/jrandom.threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t k2, uint32_t lo,
                                             uint32_t& b1, uint32_t& b2) {
  uint32_t x0 = k0;
  uint32_t x1 = lo + k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  b1 = x0;
  b2 = x1;
}

// jax.random.uniform's mantissa from threefry's two output words: f32
// from b1 ^ b2, f64 from the 64 bits b1 << 32 | b2; OR-ed with 1.0,
// minus 1 (exact).
__device__ __forceinline__ void uniform_of(uint32_t b1, uint32_t b2, float& u) {
  u = __fsub_rn(__uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u), 1.0f);
}
__device__ __forceinline__ void uniform_of(uint32_t b1, uint32_t b2, double& u) {
  const unsigned long long m =
      (static_cast<unsigned long long>(b1) << 20) | (b2 >> 12);
  u = __dsub_rn(__longlong_as_double(
                    static_cast<long long>(m | 0x3FF0000000000000ull)),
                1.0);
}

// One step of the offset search per STEP = 2^(D-1) .. 1: load the entry
// STEP - 1 past the running shared-memory address, and where it is <= z
// move the address STEP entries on.  Written in PTX so that each step is
// a load with an immediate offset, a compare and a predicated add.  The
// asm is volatile: it reads shared memory that the block wrote before
// its barrier, and a volatile asm is never moved across __syncthreads().
template <int STEP>
__device__ __forceinline__ void search_steps(uint32_t& addr, int z) {
  asm volatile("{\n\t.reg .s32 v;\n\t.reg .pred q;\n\t"
      "ld.shared.s32 v, [%0+%2];\n\t"
      "setp.le.s32 q, v, %1;\n\t"
      "@q add.u32 %0, %0, %3;\n\t}"
      : "+r"(addr) : "r"(z), "n"(4 * (STEP - 1)), "n"(4 * STEP));
  if constexpr (STEP > 1) search_steps<STEP / 2>(addr, z);
}

// The number of offsets <= z, i.e. torch.searchsorted(offs, z,
// right=True): a branch-free search of fixed depth over the padded table
// (INT_MAX past the offsets; z < INT_MAX).
template <int DEPTH>
__device__ __forceinline__ int count_le(const int* tab, int z) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tab));
  uint32_t addr = base;
  search_steps<1 << (DEPTH - 1)>(addr, z);
  return static_cast<int>((addr - base) >> 2);
}

// The phase's tables in shared memory, written by the whole block before
// its barrier: the padded search table and, per count, the chain and
// the snap entries.
template <typename T>
__device__ __forceinline__ void fill_tables(const int* offs, const T* zeta,
                                            const T* eta_z, int K, int* tab,
                                            Chain<T>* chain, Snap<T>* snap) {
  for (int j = threadIdx.x; j < kTable; j += blockDim.x) {
    tab[j] = j < K ? offs[j] : 0x7FFFFFFF;
  }
  for (int c = threadIdx.x; c <= K; c += blockDim.x) {
    const int i = c == 0 ? K - 1 : c - 1;        // offs[c - 1], wrapped
    const int hi = offs[c < K - 1 ? c : K - 1];
    Snap<T> e;
    e.lo = offs[i];
    e.hi = hi;
    e.lo_f = to_float<T>(e.lo);
    const T span = sub_rn(to_float<T>(hi), e.lo_f);
    e.span = span < T(1) ? T(1) : span;
    snap[c] = e;
    chain[c] = Chain<T>{zeta[i], eta_z[i]};
  }
}

// A step's two direction chains and flags, computed once per step: the
// jump space, its bucket's Zipf constants, n = max(space, 1) and
// max(avail, 1) as floats, and the coins' forcing masks (bit 31, Zipf,
// while cooling; bit 30, backward, on the path's last step).
template <typename T>
struct StepChains {
  int avail_b, avail_f;
  int js_b, js_f;
  Chain<T> chain_b, chain_f;
  T n_b, n_f, av_b, av_f;
  bool has_path, back_base, not_last;
  uint32_t zipf_force, back_force;
};

template <typename T, int DEPTH>
__device__ __forceinline__ StepChains<T> step_chains(int rank, int cnt,
                                                     int space, int cooling,
                                                     const int* tab,
                                                     const Chain<T>* chain) {
  StepChains<T> st;
  st.avail_b = rank;
  st.avail_f = cnt - 1 - rank;
  st.js_b = st.avail_b < space ? st.avail_b : space;
  st.js_f = st.avail_f < space ? st.avail_f : space;
  const int js1_b = st.js_b > 1 ? st.js_b : 1;
  const int js1_f = st.js_f > 1 ? st.js_f : 1;
  st.chain_b = chain[count_le<DEPTH>(tab, js1_b)];
  st.chain_f = chain[count_le<DEPTH>(tab, js1_f)];
  st.n_b = to_float<T>(js1_b);
  st.n_f = to_float<T>(js1_f);
  st.av_b = to_float<T>(st.avail_b > 1 ? st.avail_b : 1);
  st.av_f = to_float<T>(st.avail_f > 1 ? st.avail_f : 1);
  pin(st.n_b);
  pin(st.n_f);
  pin(st.av_b);
  pin(st.av_f);
  pin(st.js_b);
  pin(st.js_f);
  st.has_path = cnt > 1;
  st.back_base = rank > 0;
  st.not_last = rank < cnt - 1;
  st.zipf_force = cooling ? 0x80000000u : 0u;
  st.back_force = rank == cnt - 1 ? 0x40000000u : 0u;
  return st;
}

// One proposal's choice from its draws (bits, u): ki (jump +offs[ki]),
// ~ki (jump -offs[ki]), and whether it is active.  The direction coin
// picks a chain, the Zipf or the uniform draw is selected (both are
// computed), the draw snaps to the offsets (stochastically by bits
// 20-28, or down), then the activity coin (bits 0-19 below thresh) and
// the end guards.
template <typename T, int DEPTH>
__device__ __forceinline__ bool propose(const StepChains<T>& st,
                                        const int* tab, const Snap<T>* snap,
                                        T zeta2theta, T alpha, bool stoch,
                                        uint32_t thresh, uint32_t bits, T u,
                                        int& choice) {
  const bool use_zipf = static_cast<int>(bits | st.zipf_force) < 0;
  const bool backward = st.back_base && ((bits | st.back_force) & 0x40000000u);
  const bool forward = !backward && st.not_last;
  const int avail = backward ? st.avail_b : st.avail_f;
  const int jump_space = backward ? st.js_b : st.js_f;
  const T zeta = backward ? st.chain_b.zeta : st.chain_f.zeta;
  const T eta_z = backward ? st.chain_b.eta_z : st.chain_f.eta_z;
  const T n = backward ? st.n_b : st.n_f;
  // sweep_common.zipf_core: the inverse-CDF Zipf draw
  const T uz = mul_rn(u, zeta);
  T arg = add_rn(sub_rn(mul_rn(eta_z, u), eta_z), T(1));
  arg = arg < T(1e-30) ? T(1e-30) : arg;   // a NaN passes, as in clamp_min
  const T e = exp_lib(mul_rn(alpha, log_lib(arg)));
  // NaN -> 0, then the clamps to [0, n]: fmax returns the operand that
  // is not NaN, and general = 1 + n * e is never -0
  const T general = fmin_(fmax_(add_rn(T(1), mul_rn(n, e)), T(0)), n);
  int zz = uz < T(1) ? 1 : (uz < zeta2theta ? 2 : trunc_i(general));
  zz = zz < jump_space ? zz : jump_space;
  // the uniform draw
  const int zu = 1 + trunc_i(mul_rn(u, backward ? st.av_b : st.av_f));
  const int z = use_zipf ? zz : zu;

  // the snap: c = searchsorted(offs, max(z, 1), right=True) = oidx + 1
  // (z < INT_MAX: a draw never exceeds its jump space or avail + 1)
  const int c = count_le<DEPTH>(tab, z > 1 ? z : 1);
  const Snap<T> s = snap[c];
  T u2;
  u2_of(bits, u2);
  const T qfrac = div_rn(sub_rn(to_float<T>(z), s.lo_f), s.span);
  const bool promote = stoch && u2 < qfrac && s.hi <= avail;
  const int oidx = c - 1 + (promote ? 1 : 0);
  const int off_sel = promote ? s.hi : s.lo;
  choice = backward ? ~oidx : oidx;
  return (forward || backward) && st.has_path && off_sel <= avail &&
         (bits & 0xFFFFFu) < thresh;
}

// A proposal's signed 8-bit field (INACTIVE8 where it is not active).
__device__ __forceinline__ uint32_t field_of(bool active, int choice) {
  return active ? static_cast<uint32_t>(choice) & 0xFFu : kInactive8;
}

template <int P, int DEPTH>
__global__ void __launch_bounds__(kThreads)
sweep_sampler_kernel(const SamplerParams prm) {
  __shared__ int s_tab[kTable];
  __shared__ Chain<float> s_chain[kMaxOffsets + 1];
  __shared__ Snap<float> s_snap[kMaxOffsets + 1];
  fill_tables(prm.offs, prm.zeta, prm.eta_z, prm.K, s_tab, s_chain, s_snap);
  const float zeta2theta = *prm.zeta2theta;
  const float alpha = *prm.alpha;
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= prm.S) return;

  const StepChains<float> st = step_chains<float, DEPTH>(
      prm.rank[t], prm.cnt[t], prm.space, prm.cooling, s_tab, s_chain);
  // every activity coin passes under a bound of 2^20
  const uint32_t thresh =
      prm.thresh < 0 ? 0x100000u : static_cast<uint32_t>(prm.thresh);
  const bool stoch = prm.snap_down == 0;
  const uint32_t step_g = static_cast<uint32_t>(t) * kGolden;

  constexpr int kWords = P == 1 ? 1 : (P + 3) / 4;
  uint32_t packed[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) packed[j] = 0u;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // sweep_common.sweep_rng, hash mode: (t + b1) * golden = t * golden
    // + b1 * golden (mod 2^32)
    const uint32_t h = mix_tail(step_g + prm.b1g[p]);
    const uint32_t bits = mix(h ^ prm.b2[p]);
    const float u = __fmul_rn(__uint2float_rn(mix(h ^ prm.salt[p]) >> 8),
                              5.9604644775390625e-08f);
    if (p == 0 && prm.coin != nullptr) {
      prm.coin[t] = static_cast<uint8_t>((bits >> 29) & 1u);
    }
    int choice;
    const bool active = propose<float, DEPTH>(st, s_tab, s_snap, zeta2theta,
                                              alpha, stoch, thresh, bits, u,
                                              choice);
    if (P == 1) {
      packed[0] = static_cast<uint32_t>(active ? choice : kInactive);
    } else {
      packed[p >> 2] |= field_of(active, choice) << (8 * (p & 3));
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    prm.words[j][t] = static_cast<int>(packed[j]);
  }
}

template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
sweep_sampler_tf_kernel(const TfParams<T> prm) {
  __shared__ int s_tab[kTable];
  __shared__ Chain<T> s_chain[kMaxOffsets + 1];
  __shared__ Snap<T> s_snap[kMaxOffsets + 1];
  // the keys, for a runtime proposal index: a kernel parameter indexed
  // at run time would be copied to local memory, so one thread copies
  // them with constant indices
  __shared__ uint32_t s_ks[kMaxProposals][6];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < kMaxProposals; ++p) {
#pragma unroll
      for (int k = 0; k < 6; ++k) s_ks[p][k] = prm.ks[p][k];
    }
  }
  fill_tables(prm.offs, prm.zeta, prm.eta_z, prm.K, s_tab, s_chain, s_snap);
  const T zeta2theta = *prm.zeta2theta;
  const T alpha = *prm.alpha;
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= prm.S) return;

  const StepChains<T> st = step_chains<T, DEPTH>(
      prm.rank[t], prm.cnt[t], prm.space, prm.cooling, s_tab, s_chain);
  const uint32_t thresh =
      prm.thresh < 0 ? 0x100000u : static_cast<uint32_t>(prm.thresh);
  const bool stoch = prm.snap_down == 0;
  const uint32_t ctr = static_cast<uint32_t>(t);

  const int P = prm.proposals;
  const int n_words = P == 1 ? 1 : (P + 3) >> 2;
  for (int w = 0; w < n_words; ++w) {
    uint32_t packed = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * w + j;
      if (p >= P) break;
      // jax.random.bits(k1, (S,)) and uniform(k2, (S,)) at step t
      uint32_t b1, b2;
      threefry2x32(s_ks[p][0], s_ks[p][1], s_ks[p][2], ctr, b1, b2);
      const uint32_t bits = b1 ^ b2;
      threefry2x32(s_ks[p][3], s_ks[p][4], s_ks[p][5], ctr, b1, b2);
      T u;
      uniform_of(b1, b2, u);
      if (p == 0 && prm.coin != nullptr) {
        prm.coin[t] = static_cast<uint8_t>((bits >> 29) & 1u);
      }
      int choice;
      const bool active = propose<T, DEPTH>(st, s_tab, s_snap, zeta2theta,
                                            alpha, stoch, thresh, bits, u,
                                            choice);
      if (P == 1) {
        packed = static_cast<uint32_t>(active ? choice : kInactive);
      } else {
        packed |= field_of(active, choice) << (8 * j);
      }
    }
    // word w's array, selected among the parameters' constant indices
    int* const dst = w == 0 ? prm.words[0]
                   : w == 1 ? prm.words[1]
                   : w == 2 ? prm.words[2] : prm.words[3];
    dst[t] = static_cast<int>(packed);
  }
}

template <typename T>
cudaError_t launch_tf(const TfParams<T>& prm, int blocks, cudaStream_t st) {
  if (prm.K < (1 << kShallow)) {
    sweep_sampler_tf_kernel<T, kShallow><<<blocks, kThreads, 0, st>>>(prm);
  } else {
    sweep_sampler_tf_kernel<T, kDeep><<<blocks, kThreads, 0, st>>>(prm);
  }
  return cudaGetLastError();
}

template <typename T>
int sampler_tf(int device, const int* rank, const int* cnt, int S,
               const int* offs, const void* zeta, const void* eta_z,
               const void* zeta2theta, const void* alpha, int K, int space,
               int cooling, int thresh, int snap_down, int proposals,
               const unsigned* keys, int* const (&words)[kMaxWords],
               unsigned char* coin, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  TfParams<T> prm;
  prm.rank = rank;
  prm.cnt = cnt;
  prm.offs = offs;
  prm.zeta = static_cast<const T*>(zeta);
  prm.eta_z = static_cast<const T*>(eta_z);
  prm.zeta2theta = static_cast<const T*>(zeta2theta);
  prm.alpha = static_cast<const T*>(alpha);
  for (int j = 0; j < kMaxWords; ++j) prm.words[j] = words[j];
  prm.coin = coin;
  prm.S = S;
  prm.K = K;
  prm.space = space;
  prm.cooling = cooling;
  prm.thresh = thresh;
  prm.snap_down = snap_down;
  prm.proposals = proposals;
  for (int p = 0; p < kMaxProposals; ++p) {
    for (int k = 0; k < 2; ++k) {
      const uint32_t k0 = p < proposals ? keys[4 * p + 2 * k] : 0u;
      const uint32_t k1 = p < proposals ? keys[4 * p + 2 * k + 1] : 0u;
      prm.ks[p][3 * k] = k0;
      prm.ks[p][3 * k + 1] = k1;
      prm.ks[p][3 * k + 2] = k0 ^ k1 ^ 0x1BD11BDAu;
    }
  }
  const int blocks = (S + kThreads - 1) / kThreads;
  return static_cast<int>(
      launch_tf<T>(prm, blocks, static_cast<cudaStream_t>(stream)));
}

template <int P, int DEPTH>
cudaError_t launch_p(const SamplerParams& prm, int blocks, cudaStream_t st) {
  sweep_sampler_kernel<P, DEPTH><<<blocks, kThreads, 0, st>>>(prm);
  return cudaGetLastError();
}

template <int DEPTH>
cudaError_t launch(const SamplerParams& prm, int P, int blocks,
                   cudaStream_t st) {
  switch (P) {
    case 1: return launch_p<1, DEPTH>(prm, blocks, st);
    case 2: return launch_p<2, DEPTH>(prm, blocks, st);
    case 3: return launch_p<3, DEPTH>(prm, blocks, st);
    case 4: return launch_p<4, DEPTH>(prm, blocks, st);
    case 5: return launch_p<5, DEPTH>(prm, blocks, st);
    case 6: return launch_p<6, DEPTH>(prm, blocks, st);
    case 7: return launch_p<7, DEPTH>(prm, blocks, st);
    case 8: return launch_p<8, DEPTH>(prm, blocks, st);
    case 9: return launch_p<9, DEPTH>(prm, blocks, st);
    case 10: return launch_p<10, DEPTH>(prm, blocks, st);
    case 11: return launch_p<11, DEPTH>(prm, blocks, st);
    case 12: return launch_p<12, DEPTH>(prm, blocks, st);
    case 13: return launch_p<13, DEPTH>(prm, blocks, st);
    case 14: return launch_p<14, DEPTH>(prm, blocks, st);
    case 15: return launch_p<15, DEPTH>(prm, blocks, st);
    default: return launch_p<16, DEPTH>(prm, blocks, st);
  }
}

}  // namespace

// C interface, bound with ctypes.  Device pointers: rank, cnt, offs,
// zeta, eta_z, zeta2theta, alpha, w0..w3 (ceil(P/4) of them for P > 1,
// one raw choice array for P == 1; the rest NULL), coin (NULL: not
// written).  Host arrays: b2, b1 (proposals entries).  thresh < 0: every
// proposal active.  Launches on `stream` of device `device` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int gfasort_sweep_sampler(
    int device, const int* rank, const int* cnt, int S,
    const int* offs, const float* zeta, const float* eta_z,
    const float* zeta2theta, const float* alpha, int K, int space,
    int cooling, int thresh, int snap_down, int proposals,
    const unsigned* b2, const unsigned* b1,
    int* w0, int* w1, int* w2, int* w3, unsigned char* coin, void* stream) {
  if (S <= 0 || K < 1 || K > kMaxOffsets || proposals < 1 ||
      proposals > kMaxProposals) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* const words[kMaxWords] = {w0, w1, w2, w3};
  const int n_words = proposals == 1 ? 1 : (proposals + 3) / 4;
  for (int j = 0; j < n_words; ++j) {
    if (words[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  SamplerParams prm;
  prm.rank = rank;
  prm.cnt = cnt;
  prm.offs = offs;
  prm.zeta = zeta;
  prm.eta_z = eta_z;
  prm.zeta2theta = zeta2theta;
  prm.alpha = alpha;
  for (int j = 0; j < kMaxWords; ++j) prm.words[j] = words[j];
  prm.coin = coin;
  prm.S = S;
  prm.K = K;
  prm.space = space;
  prm.cooling = cooling;
  prm.thresh = thresh;
  prm.snap_down = snap_down;
  for (int p = 0; p < kMaxProposals; ++p) {
    const uint32_t w2 = p < proposals ? b2[p] : 0u;
    const uint32_t w1 = p < proposals ? b1[p] : 0u;
    prm.b2[p] = w2;
    prm.b1g[p] = w1 * kGolden;
    prm.salt[p] = w2 * kGolden + 0x632BE59Bu;
  }
  const int blocks = (S + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      K < (1 << kShallow) ? launch<kShallow>(prm, proposals, blocks, st)
                          : launch<kDeep>(prm, proposals, blocks, st);
  return static_cast<int>(err);
}


// The threefry routes' entry: as gfasort_sweep_sampler, with the
// constants zeta, eta_z, zeta2theta and alpha in float (f64 == 0) or
// double (f64 == 1) and, in place of the hash words, `keys` (host,
// proposals x 4 words): each proposal's k1 (two words) then k2 (two
// words), a row of keys.threefry_key_table.
extern "C" int gfasort_sweep_sampler_tf(
    int device, const int* rank, const int* cnt, int S,
    const int* offs, const void* zeta, const void* eta_z,
    const void* zeta2theta, const void* alpha, int K, int space,
    int cooling, int thresh, int snap_down, int proposals, int f64,
    const unsigned* keys,
    int* w0, int* w1, int* w2, int* w3, unsigned char* coin, void* stream) {
  if (S <= 0 || K < 1 || K > kMaxOffsets || proposals < 1 ||
      proposals > kMaxProposals || keys == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* const words[kMaxWords] = {w0, w1, w2, w3};
  const int n_words = proposals == 1 ? 1 : (proposals + 3) / 4;
  for (int j = 0; j < n_words; ++j) {
    if (words[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  return f64 ? sampler_tf<double>(device, rank, cnt, S, offs, zeta, eta_z,
                                  zeta2theta, alpha, K, space, cooling,
                                  thresh, snap_down, proposals, keys, words,
                                  coin, stream)
             : sampler_tf<float>(device, rank, cnt, S, offs, zeta, eta_z,
                                 zeta2theta, alpha, K, space, cooling, thresh,
                                 snap_down, proposals, keys, words, coin,
                                 stream);
}
