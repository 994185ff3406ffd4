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
// What bounds it on the card: operations.  It reads rank and cnt (8
// bytes) and writes 4 bytes per word (12 at P = 12) per step, and does
// per proposal three murmur finalisers, a logf and an expf, one IEEE
// divide and one or two binary searches over the offset set.
//
// Design: one thread per step, every proposal in registers, the phase's
// constants (K <= 64 offsets and their Zipf constants) in shared memory.
// The two direction chains (jump space, bucket index, zeta, eta_z) are
// computed once per step and selected per proposal, as the plain
// version does.  Every f32 op is an explicit round-to-nearest intrinsic
// in the plain version's order (eta_z * u - eta_z + 1 is three rounded
// ops, 1 + n * e two; the build passes --fmad=false), logf / expf are
// the IEEE-accurate library functions (never __expf), NaN is replaced
// before the clamps, and float-to-int conversions truncate, so the words
// equal the plain version's on the card bit for bit.
// Left for later: folding the sampler into the bucket kernel, so the
// words never go through memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 64;
constexpr int kMaxProposals = 16;
constexpr int kMaxWords = 4;
constexpr int kInactive = 0x7FFFFFF;          // sweep_common.INACTIVE
constexpr int kInactive8 = 127;               // sweep_common.INACTIVE8
constexpr int kThreads = 256;

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
  int proposals;
  int cooling;
  int thresh;                 // the activity coin's bound; < 0: all active
  int snap_down;
  uint32_t b2[kMaxProposals];
  uint32_t b1[kMaxProposals];
};

// The murmur3 finaliser with the golden-ratio premultiply
// (sweep_common._mix).
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x *= 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// torch.searchsorted(offs, z, right=True) - 1: the index of the largest
// offset <= z (-1 where every offset exceeds z).
__device__ __forceinline__ int snap_idx(const int* offs, int K, int z) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= z) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// offs[i] as torch indexes it: a negative index counts from the end.
__device__ __forceinline__ int wrap(int i, int K) { return i < 0 ? i + K : i; }

// sweep_common.zipf_core: the inverse-CDF Zipf draw from the selected
// bucket constants.
__device__ __forceinline__ int zipf_core(float u, int jump_space, float zeta,
                                         float eta_z, float zeta2theta,
                                         float alpha) {
  const float n = __int2float_rn(jump_space > 1 ? jump_space : 1);
  const float uz = __fmul_rn(u, zeta);
  float arg = __fadd_rn(__fsub_rn(__fmul_rn(eta_z, u), eta_z), 1.0f);
  arg = arg < 1e-30f ? 1e-30f : arg;   // a NaN passes, as in clamp_min
  const float e = expf(__fmul_rn(alpha, logf(arg)));
  float general = __fadd_rn(1.0f, __fmul_rn(n, e));
  if (isnan(general)) general = 0.0f;
  general = general < 0.0f ? 0.0f : general;
  general = general > n ? n : general;
  const int g = __float2int_rz(general);
  const int z = uz < 1.0f ? 1 : (uz < zeta2theta ? 2 : g);
  return z < jump_space ? z : jump_space;
}

__global__ void __launch_bounds__(kThreads)
sweep_sampler_kernel(const SamplerParams prm) {
  __shared__ int s_offs[kMaxOffsets];
  __shared__ float s_zeta[kMaxOffsets];
  __shared__ float s_eta_z[kMaxOffsets];
  const int K = prm.K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    s_offs[j] = prm.offs[j];
    s_zeta[j] = prm.zeta[j];
    s_eta_z[j] = prm.eta_z[j];
  }
  const float zeta2theta = *prm.zeta2theta;
  const float alpha = *prm.alpha;
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= prm.S) return;

  const int rank = prm.rank[t];
  const int cnt = prm.cnt[t];
  // the two direction chains, once per step
  const int avail_b = rank;
  const int avail_f = cnt - 1 - rank;
  int js[2];
  float zeta_d[2], eta_z_d[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int avail = d == 0 ? avail_b : avail_f;
    js[d] = avail < prm.space ? avail : prm.space;
    const int idx = wrap(snap_idx(s_offs, K, js[d] > 1 ? js[d] : 1), K);
    zeta_d[d] = s_zeta[idx];
    eta_z_d[d] = s_eta_z[idx];
  }
  const bool has_path = cnt > 1;
  const bool back_base = rank > 0;
  const bool last = rank == cnt - 1;
  const bool not_last = rank < cnt - 1;

  const uint32_t step = static_cast<uint32_t>(t);
  uint32_t packed[kMaxWords] = {0u, 0u, 0u, 0u};
  int raw = kInactive;
  // unrolled over the largest P, so `packed` stays in registers
#pragma unroll
  for (int p = 0; p < kMaxProposals; ++p) {
    if (p >= prm.proposals) break;
    // sweep_common.sweep_rng, hash mode
    const uint32_t h = mix(step + prm.b1[p]);
    const uint32_t bits = mix(h ^ prm.b2[p]);
    const uint32_t salt = prm.b2[p] * 0x9E3779B9u + 0x632BE59Bu;
    const float u =
        __fmul_rn(__uint2float_rn(mix(h ^ salt) >> 8), 5.9604644775390625e-08f);
    if (p == 0 && prm.coin != nullptr) {
      prm.coin[t] = static_cast<uint8_t>((bits >> 29) & 1u);
    }

    const bool coin1 = (bits >> 31) == 1u;
    const bool coin2 = ((bits >> 30) & 1u) == 1u;
    const bool use_zipf = coin1 || prm.cooling;
    const bool backward = back_base && (coin2 || last);
    const bool forward = !backward && not_last;
    const int avail = backward ? avail_b : avail_f;
    int z;
    if (use_zipf) {
      z = zipf_core(u, backward ? js[0] : js[1],
                    backward ? zeta_d[0] : zeta_d[1],
                    backward ? eta_z_d[0] : eta_z_d[1], zeta2theta, alpha);
    } else {
      z = 1 + __float2int_rz(
                  __fmul_rn(u, __int2float_rn(avail > 1 ? avail : 1)));
    }
    int oidx = snap_idx(s_offs, K, z > 1 ? z : 1);
    int off_sel = s_offs[wrap(oidx, K)];
    if (!prm.snap_down) {
      const int off_hi = s_offs[oidx + 1 < K - 1 ? oidx + 1 : K - 1];
      const float off_lo = __int2float_rn(off_sel);
      const float u2 = __fmul_rn(__uint2float_rn((bits >> 20) & 0x1FFu),
                                 0.001953125f);
      float span = __fsub_rn(__int2float_rn(off_hi), off_lo);
      span = span < 1.0f ? 1.0f : span;
      const float qfrac =
          __fdiv_rn(__fsub_rn(__int2float_rn(z), off_lo), span);
      if (u2 < qfrac && off_hi <= avail) {
        ++oidx;
        off_sel = off_hi;
      }
    }
    bool active = (forward || backward) && has_path && off_sel <= avail;
    if (prm.thresh >= 0) {
      active = active && static_cast<int>(bits & 0xFFFFFu) < prm.thresh;
    }
    const int choice = active ? (backward ? ~oidx : oidx) : kInactive;
    if (prm.proposals == 1) {
      raw = choice;
    } else {
      const uint32_t field =
          static_cast<uint32_t>(choice == kInactive ? kInactive8 : choice) &
          0xFFu;
      packed[p >> 2] |= field << (8 * (p & 3));
    }
  }
  if (prm.proposals == 1) {
    prm.words[0][t] = raw;
  } else {
    const int n_words = (prm.proposals + 3) / 4;
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j) {
      if (j < n_words) prm.words[j][t] = static_cast<int>(packed[j]);
    }
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
  prm.proposals = proposals;
  prm.cooling = cooling;
  prm.thresh = thresh;
  prm.snap_down = snap_down;
  for (int p = 0; p < kMaxProposals; ++p) {
    prm.b2[p] = p < proposals ? b2[p] : 0u;
    prm.b1[p] = p < proposals ? b1[p] : 0u;
  }
  const int blocks = (S + kThreads - 1) / kThreads;
  sweep_sampler_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      prm);
  return static_cast<int>(cudaGetLastError());
}
