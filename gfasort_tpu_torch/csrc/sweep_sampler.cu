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

// Per count c = oidx + 1: the snapped offset offs[oidx] (torch's wrap
// for oidx = -1), offs[min(oidx + 1, K - 1)], the first as a float and
// the span max(float(hi) - float(lo), 1) of the stochastic snap.
struct __align__(16) Snap {
  int lo;
  int hi;
  float lo_f;
  float span;
};

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

template <int P, int DEPTH>
__global__ void __launch_bounds__(kThreads)
sweep_sampler_kernel(const SamplerParams prm) {
  __shared__ int s_tab[kTable];
  __shared__ float2 s_chain[kMaxOffsets + 1];   // (zeta, eta_z) by count
  __shared__ Snap s_snap[kMaxOffsets + 1];
  const int K = prm.K;
  for (int j = threadIdx.x; j < kTable; j += blockDim.x) {
    s_tab[j] = j < K ? prm.offs[j] : 0x7FFFFFFF;
  }
  for (int c = threadIdx.x; c <= K; c += blockDim.x) {
    const int i = c == 0 ? K - 1 : c - 1;        // offs[c - 1], wrapped
    const int hi = prm.offs[c < K - 1 ? c : K - 1];
    Snap e;
    e.lo = prm.offs[i];
    e.hi = hi;
    e.lo_f = __int2float_rn(e.lo);
    const float span = __fsub_rn(__int2float_rn(hi), e.lo_f);
    e.span = span < 1.0f ? 1.0f : span;
    s_snap[c] = e;
    s_chain[c] = make_float2(prm.zeta[i], prm.eta_z[i]);
  }
  const float zeta2theta = *prm.zeta2theta;
  const float alpha = *prm.alpha;
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= prm.S) return;

  const int rank = prm.rank[t];
  const int cnt = prm.cnt[t];
  // the two direction chains, once per step: the jump space, its
  // bucket's Zipf constants, n = max(space, 1) and max(avail, 1) as floats
  const int avail_b = rank;
  const int avail_f = cnt - 1 - rank;
  int js_b = avail_b < prm.space ? avail_b : prm.space;
  int js_f = avail_f < prm.space ? avail_f : prm.space;
  const int js1_b = js_b > 1 ? js_b : 1;
  const int js1_f = js_f > 1 ? js_f : 1;
  const float2 chain_b = s_chain[count_le<DEPTH>(s_tab, js1_b)];
  const float2 chain_f = s_chain[count_le<DEPTH>(s_tab, js1_f)];
  float n_b = __int2float_rn(js1_b);
  float n_f = __int2float_rn(js1_f);
  float av_b = __int2float_rn(avail_b > 1 ? avail_b : 1);
  float av_f = __int2float_rn(avail_f > 1 ? avail_f : 1);
  // kept in registers: the compiler would recompute them per proposal
  asm volatile("" : "+f"(n_b), "+f"(n_f), "+f"(av_b), "+f"(av_f));
  asm volatile("" : "+r"(js_b), "+r"(js_f));
  const bool has_path = cnt > 1;
  const bool back_base = rank > 0;
  const bool not_last = rank < cnt - 1;
  // the coins as bit masks: bit 31 (Zipf) is forced while cooling, bit
  // 30 (backward) on the path's last step; every activity coin passes
  // under a bound of 2^20
  const uint32_t zipf_force = prm.cooling ? 0x80000000u : 0u;
  const uint32_t back_force = rank == cnt - 1 ? 0x40000000u : 0u;
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

    const bool use_zipf = static_cast<int>(bits | zipf_force) < 0;
    const bool backward = back_base && ((bits | back_force) & 0x40000000u);
    const bool forward = !backward && not_last;
    const int avail = backward ? avail_b : avail_f;
    const int jump_space = backward ? js_b : js_f;
    const float zeta = backward ? chain_b.x : chain_f.x;
    const float eta_z = backward ? chain_b.y : chain_f.y;
    const float n = backward ? n_b : n_f;
    // sweep_common.zipf_core: the inverse-CDF Zipf draw
    const float uz = __fmul_rn(u, zeta);
    float arg = __fadd_rn(__fsub_rn(__fmul_rn(eta_z, u), eta_z), 1.0f);
    arg = arg < 1e-30f ? 1e-30f : arg;   // a NaN passes, as in clamp_min
    const float e = expf(__fmul_rn(alpha, logf(arg)));
    // NaN -> 0, then the clamps to [0, n]: fmaxf returns the operand that
    // is not NaN, and general = 1 + n * e is never -0
    const float general =
        fminf(fmaxf(__fadd_rn(1.0f, __fmul_rn(n, e)), 0.0f), n);
    int zz = uz < 1.0f ? 1 : (uz < zeta2theta ? 2 : __float2int_rz(general));
    zz = zz < jump_space ? zz : jump_space;
    // the uniform draw
    const int zu = 1 + __float2int_rz(__fmul_rn(u, backward ? av_b : av_f));
    const int z = use_zipf ? zz : zu;

    // the snap: c = searchsorted(offs, max(z, 1), right=True) = oidx + 1
    // (z < INT_MAX: a draw never exceeds its jump space or avail + 1)
    const int c = count_le<DEPTH>(s_tab, z > 1 ? z : 1);
    const Snap s = s_snap[c];
    // u2 = ((bits >> 20) & 0x1FF) * 2^-9, exactly: 1 + u2 - 1
    const float u2 = __fsub_rn(
        __uint_as_float(((bits >> 6) & (0x1FFu << 14)) | 0x3F800000u), 1.0f);
    const float qfrac = __fdiv_rn(__fsub_rn(__int2float_rn(z), s.lo_f), s.span);
    const bool promote = stoch && u2 < qfrac && s.hi <= avail;
    const int oidx = c - 1 + (promote ? 1 : 0);
    const int off_sel = promote ? s.hi : s.lo;
    const bool active = (forward || backward) && has_path && off_sel <= avail &&
                        (bits & 0xFFFFFu) < thresh;
    const int choice = backward ? ~oidx : oidx;
    if (P == 1) {
      packed[0] = static_cast<uint32_t>(active ? choice : kInactive);
    } else {
      const uint32_t field =
          active ? static_cast<uint32_t>(choice) & 0xFFu : kInactive8;
      packed[p >> 2] |= field << (8 * (p & 3));
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    prm.words[j][t] = static_cast<int>(packed[j]);
  }
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
