// nD bucket-apply kernel of the layout sweep engine, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gfasort_tpu/ops/sweep_dense.py::
// build_dense_apply_nd (kernel body :521-605, spec apply_ref :458-501).
// For every step s and every bucket (k, ki) in list order, +k before -k,
// the pair (s, s +- k) gets the weight w = number of proposals p with
//   +k: my field == ki  or the partner's (at s+k) == ~ki
//   -k: my field == ~ki or the partner's (at s-k) == ki
// and the update d = |pos - pos_o| (w = 0, safe = 1 where d == 0),
// mu = min(eta / safe, 1), delta = c - c_o over the D rows,
// mag2 = sum of delta^2 in dimension order (where 0: delta[0] = 1e-9,
// mag2 = 1e-18), inv = 1 / sqrt(mag2), mag = mag2 * inv,
// r = min(mu * (mag - safe) * 0.5 * inv, 1e30),
// acc[d] -= (w * r) * delta[d], wacc += w.  Reads past either end give
// pos = c = 0 and the INACTIVE (P == 1) or PACKED_INACTIVE (P > 1) word.
//
// What bounds it on the card: memory traffic.  Each step reads its own
// (1 + n_words + D) words and, per bucket and sign, the partner's: that
// is (1 + n_words + D) * (1 + 2 * n_buckets) 4-byte reads, and it writes
// D + 1 words.  Adjacent threads read adjacent s +- k, so every read is
// coalesced, and the partner reads of nearby buckets mostly hit L1/L2.
// The arithmetic is about 3D + 25 f32 ops per bucket and sign, two of
// them IEEE divides and one a square root.
//
// Design: one thread per step, partner reads straight from global
// memory, the D + 1 sums in registers in the spec's order; D is a
// template parameter so the coordinate loops unroll.  Every f32 op is an
// explicit round-to-nearest intrinsic (and the build passes
// --fmad=false), so no multiply-add is contracted into an FMA.  The JAX
// spec's rsqrt is computed as __fdiv_rn(1, __fsqrt_rn(x)): CUDA's rsqrtf
// is approximate, and the plain PyTorch version computes the same two
// correctly rounded ops.  Left for later: a shared-memory tile with a
// +-kmax halo.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kMaxWords = 4;
constexpr int kMaxDims = 8;                   // ops/sweep_dense.MAX_DIMS
constexpr int kInactive = 0x7FFFFFF;          // sweep_common.INACTIVE
constexpr int kPackedInactive = 0x7F7F7F7F;   // sweep_common.PACKED_INACTIVE
constexpr int kThreads = 256;

struct NdParams {
  const float* pos;      // [S] the chosen end's path position
  const float* c;        // [D, S] the chosen end's coordinates
  const int* words[kMaxWords];
  float* acc;            // [D, S]
  float* wacc;           // [S]
  int S;
  int proposals;
  int n_words;
  int n_buckets;
  float eta;
  int k[kMaxBuckets];
  int ki[kMaxBuckets];
};

// Signed 8-bit field f of a packed choice word.
__device__ __forceinline__ int field(int word, int f) {
  return static_cast<int>(static_cast<unsigned>(word) << (24 - 8 * f)) >> 24;
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads)
dense_apply_nd_kernel(const NdParams prm) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= prm.S) return;
  const int fill = PACKED ? kPackedInactive : kInactive;
  const long long S = prm.S;
  const float ps = prm.pos[s];
  float mc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) mc[d] = prm.c[d * S + s];
  int mine[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    mine[j] = j < prm.n_words ? prm.words[j][s] : fill;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  float wacc = 0.0f;
  for (int b = 0; b < prm.n_buckets; ++b) {
    const int k = prm.k[b];
    const int ki = prm.ki[b];
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      const long long o = sg == 0 ? (long long)s + k : (long long)s - k;
      const bool in = o >= 0 && o < S;
      float po = 0.0f;
      float co[D];
#pragma unroll
      for (int d = 0; d < D; ++d) co[d] = 0.0f;
      int theirs[kMaxWords];
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) theirs[j] = fill;
      if (in) {
        po = prm.pos[o];
#pragma unroll
        for (int d = 0; d < D; ++d) co[d] = prm.c[d * S + o];
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j) {
          if (j < prm.n_words) theirs[j] = prm.words[j][o];
        }
      }
      const int want_mine = sg == 0 ? ki : ~ki;
      const int want_theirs = sg == 0 ? ~ki : ki;
      float w = 0.0f;
      if (PACKED) {
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            if (4 * j + f < prm.proposals) {
              const bool hit = field(mine[j], f) == want_mine ||
                               field(theirs[j], f) == want_theirs;
              w = __fadd_rn(w, hit ? 1.0f : 0.0f);
            }
          }
        }
      } else {
        const bool hit = mine[0] == want_mine || theirs[0] == want_theirs;
        w = hit ? 1.0f : 0.0f;
      }
      const float dist = fabsf(__fsub_rn(ps, po));
      const bool valid = dist != 0.0f;
      w = valid ? w : 0.0f;
      const float safe = valid ? dist : 1.0f;
      const float mu = fminf(__fdiv_rn(prm.eta, safe), 1.0f);
      float delta[D];
#pragma unroll
      for (int d = 0; d < D; ++d) delta[d] = __fsub_rn(mc[d], co[d]);
      float mag2 = __fmul_rn(delta[0], delta[0]);
#pragma unroll
      for (int d = 1; d < D; ++d) {
        mag2 = __fadd_rn(mag2, __fmul_rn(delta[d], delta[d]));
      }
      if (mag2 == 0.0f) {
        delta[0] = 1e-9f;
        mag2 = 1e-18f;
      }
      const float inv = __fdiv_rn(1.0f, __fsqrt_rn(mag2));
      const float mag = __fmul_rn(mag2, inv);
      const float r_raw =
          __fmul_rn(__fmul_rn(__fmul_rn(mu, __fsub_rn(mag, safe)), 0.5f), inv);
      // a NaN passes through, as in torch.clamp_max and jnp.minimum
      const float r = r_raw > 1e30f ? 1e30f : r_raw;
      const float wr = __fmul_rn(w, r);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[d] = __fsub_rn(acc[d], __fmul_rn(wr, delta[d]));
      }
      wacc = __fadd_rn(wacc, w);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) prm.acc[d * S + s] = acc[d];
  prm.wacc[s] = wacc;
}

template <int D>
void launch(const NdParams& prm, bool packed, cudaStream_t stream) {
  const int blocks = (prm.S + kThreads - 1) / kThreads;
  if (packed) {
    dense_apply_nd_kernel<D, true><<<blocks, kThreads, 0, stream>>>(prm);
  } else {
    dense_apply_nd_kernel<D, false><<<blocks, kThreads, 0, stream>>>(prm);
  }
}

}  // namespace

// C interface, bound with ctypes.  Device pointers: pos [S], c [D, S],
// w0..w3 (n_words of them, the rest NULL), acc [D, S], wacc [S].  Host
// arrays: ks, kis (n_buckets entries).  Launches on `stream` of device
// `device` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int gfasort_dense_apply_nd(
    int device, const float* pos, const float* c, int dims,
    const int* w0, const int* w1, const int* w2, const int* w3,
    int n_words, int proposals, int S, float eta,
    const int* ks, const int* kis, int n_buckets,
    float* acc, float* wacc, void* stream) {
  if (S <= 0 || dims < 1 || dims > kMaxDims || n_buckets < 1 ||
      n_buckets > kMaxBuckets || n_words < 1 || n_words > kMaxWords ||
      proposals < 1 || (proposals == 1 && n_words != 1) ||
      (proposals > 1 && n_words != (proposals + 3) / 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  NdParams prm;
  prm.pos = pos;
  prm.c = c;
  prm.words[0] = w0;
  prm.words[1] = w1;
  prm.words[2] = w2;
  prm.words[3] = w3;
  prm.acc = acc;
  prm.wacc = wacc;
  prm.S = S;
  prm.proposals = proposals;
  prm.n_words = n_words;
  prm.n_buckets = n_buckets;
  prm.eta = eta;
  for (int b = 0; b < kMaxBuckets; ++b) {
    prm.k[b] = b < n_buckets ? ks[b] : 0;
    prm.ki[b] = b < n_buckets ? kis[b] : 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool packed = proposals > 1;
  switch (dims) {
    case 1: launch<1>(prm, packed, st); break;
    case 2: launch<2>(prm, packed, st); break;
    case 3: launch<3>(prm, packed, st); break;
    case 4: launch<4>(prm, packed, st); break;
    case 5: launch<5>(prm, packed, st); break;
    case 6: launch<6>(prm, packed, st); break;
    case 7: launch<7>(prm, packed, st); break;
    default: launch<8>(prm, packed, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
