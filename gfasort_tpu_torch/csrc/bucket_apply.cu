// Bucket-apply kernel of the 1D sweep engine, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gfasort_tpu/ops/sweep_dense.py::
// build_bucket_apply (kernel body :251-342, spec apply_ref :199-238).
// For every step s and every bucket (k, ki) in list order, +k before -k,
// the pair (s, s +- k) gets the weight w = number of proposals p with
//   +k: my field == ki  or the partner's (at s+k) == ~ki
//   -k: my field == ~ki or the partner's (at s-k) == ki
// and the update d = |pos - pos_o| (w = 0, safe = 1 where d == 0),
// mu = min(eta / safe, 1), dx = xs - xs_o (1e-9 where 0),
// r = mu * (|dx| - safe) * (+-0.5 by the sign of dx),
// dsum -= w * r, csum += w.  Reads past either end give xs = pos = 0 and
// the INACTIVE (P == 1) or PACKED_INACTIVE (P > 1) choice word.
//
// What bounds it on the card: instruction issue, not memory.  The
// inputs are read about once from HBM (partner reads of a block's
// buckets hit L1/L2), so the bytes bound is far below the time it takes
// to evaluate every pair (a weight count, an IEEE divide and ~10 more
// f32 ops for each bucket and step) and the latency of the partner loads.
//
// Design, to issue fewer instructions while staying bit-identical:
// - Each pair is evaluated once.  The pair (t, t+k) read from t (+k)
//   and from t+k (-k) has the same weight, d, safe, mu, |dx| and so the
//   same w * r up to its sign: t+k's dx is -dx, so its r is -r, or r
//   itself where dx == 0 (both readings then take dx = 1e-9).  A block
//   owns kTile consecutive steps, kSteps per thread held in registers.
//   Per bucket, each step evaluates its own +k pair, applies w * r and
//   leaves (w, the partner's update) in a shared-memory pair table;
//   after one barrier each step takes its -k update from the table
//   entry of s - k, or, where s - k lies before the tile (the first k
//   steps, every step when k >= kTile), evaluates that pair itself.
//   So a bucket costs kTile + min(k, kTile) evaluations, not 2 kTile.
//   The table is double-buffered: one barrier per bucket.  A thread
//   loads the +k partners of all its steps before it evaluates any: the
//   IEEE divide's slow-path call keeps the compiler from hoisting those
//   loads itself, and their latency was exposed (PERF.md).
// - Proposal counts are byte-SIMD for P > 1: an xor/and/add/or test
//   marks the unequal 8-bit fields of a packed word, a field hits unless
//   both its tests are unequal, and the hits are masked to the first P
//   fields (pack_choices leaves unused fields 0, which equals ki = 0).
//   The words' per-byte hit counts are added in one register and summed
//   by one multiply; the count (an integer <= 16) becomes an f32 by
//   2^23 arithmetic, so it equals the spec's f32 sum of 0/1 terms.  No
//   quarter-rate __popc or int-to-float conversion is issued.
// - Every f32 op is an explicit round-to-nearest intrinsic (and the
//   build passes --fmad=false), so no multiply-add is contracted into
//   an FMA; both sums run in the spec's order, so the result equals the
//   plain PyTorch version bit for bit.
// Left for later: staging the partner window in shared memory, and
// folding the sampler into the kernel so the packed words never go
// through memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kMaxWords = 4;
constexpr int kInactive = 0x7FFFFFF;          // sweep_common.INACTIVE
constexpr int kPackedInactive = 0x7F7F7F7F;   // sweep_common.PACKED_INACTIVE
constexpr int kThreads = 256;
constexpr int kSteps = 4;                     // steps per thread
constexpr int kTile = kThreads * kSteps;      // steps per block

struct BucketParams {
  const float* xs;
  const float* pos;
  const int* words[kMaxWords];
  float* dsum;
  float* csum;
  int S;
  int proposals;
  int n_buckets;
  float eta;
  int k[kMaxBuckets];
  int ki[kMaxBuckets];
};

// Bit 7 of every byte of x ^ y or of its low seven bits plus 0x7F: set
// unless the byte of x equals y's (no carry crosses a byte).
__device__ __forceinline__ unsigned byte_ne(unsigned x, unsigned y) {
  const unsigned v = x ^ y;
  return ((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v;
}

// The f32 value of a small non-negative int, exactly: 2^23 + n minus 2^23
// (two full-rate ops in place of a quarter-rate conversion).
__device__ __forceinline__ float small_int_to_float(int n) {
  return __fsub_rn(__int_as_float(0x4B000000 | n), 8388608.0f);
}

// Step i's xs, pos and choice words; past either end 0 and the fill.
template <int NW, bool PACKED>
__device__ __forceinline__ void load_step(const BucketParams& prm, long long i,
                                          float& x, float& p, int (&w)[NW]) {
  const bool in = i >= 0 && i < prm.S;
  x = in ? prm.xs[i] : 0.0f;
  p = in ? prm.pos[i] : 0.0f;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    w[j] = in ? prm.words[j][i] : (PACKED ? kPackedInactive : kInactive);
  }
}

// The f32 weight of the pair (a, a+k): the number of proposals with a's
// field equal to ki or a+k's equal to ~ki.  `last` keeps the used fields
// of the last packed word.
template <int NW, bool PACKED>
__device__ __forceinline__ float pair_weight(const int (&wa)[NW],
                                             const int (&wb)[NW], int ki,
                                             unsigned last) {
  if (!PACKED) return (wa[0] == ki || wb[0] == ~ki) ? 1.0f : 0.0f;
  const unsigned want_a = 0x01010101u * static_cast<unsigned>(ki);
  const unsigned want_b = 0x01010101u * (static_cast<unsigned>(~ki) & 0xFFu);
  unsigned hits = 0;   // per byte: the hits among the words' fields there
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const unsigned keep = j < NW - 1 ? 0x80808080u : last;
    hits += (~(byte_ne(wa[j], want_a) & byte_ne(wb[j], want_b)) & keep) >> 7;
  }
  // the four byte counts (each <= 4) summed into the top byte
  return small_int_to_float(static_cast<int>((hits * 0x01010101u) >> 24));
}

// The pair (a, b = a+k) in a's +k reading: its weight w (0 where the
// positions coincide), the update a subtracts (w * r) and the one b
// subtracts in its -k reading.
__device__ __forceinline__ void pair_update(float xa, float pa, float xb,
                                            float pb, float weight, float eta,
                                            float& w, float& upd_a,
                                            float& upd_b) {
  const float d = fabsf(__fsub_rn(pa, pb));
  const bool valid = d != 0.0f;
  w = valid ? weight : 0.0f;
  const float safe = valid ? d : 1.0f;
  const float mu = fminf(__fdiv_rn(eta, safe), 1.0f);
  float dx = __fsub_rn(xa, xb);
  const bool tie = dx == 0.0f;
  dx = tie ? 1e-9f : dx;
  const float half_sgn = dx >= 0.0f ? 0.5f : -0.5f;
  const float r = __fmul_rn(__fmul_rn(mu, __fsub_rn(fabsf(dx), safe)), half_sgn);
  upd_a = __fmul_rn(w, r);
  // b's dx is -dx, so its r is -r; on a tie both readings take 1e-9
  upd_b = tie ? upd_a : -upd_a;
}

// NW: choice words per step; PACKED: 8-bit fields (P > 1) or one raw
// choice (P == 1).
template <int NW, bool PACKED>
__global__ void __launch_bounds__(kThreads)
bucket_apply_kernel(const BucketParams prm) {
  __shared__ float tab_w[2][kTile];     // the +k pair's weight
  __shared__ float tab_u[2][kTile];     // and its partner's -k update
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const unsigned last =
      PACKED ? 0x80808080u >> (8 * (4 * NW - prm.proposals)) : 0u;
  float x[kSteps], ps[kSteps], dsum[kSteps], csum[kSteps];
  int mine[kSteps][NW];
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    load_step<NW, PACKED>(prm, t0 + q * kThreads + threadIdx.x, x[q], ps[q],
                          mine[q]);
    dsum[q] = 0.0f;
    csum[q] = 0.0f;
  }

  for (int b = 0; b < prm.n_buckets; ++b) {
    const int k = prm.k[b];
    const int ki = prm.ki[b];
    float* tw = tab_w[b & 1];
    float* tu = tab_u[b & 1];
    // +k: my pair (s, s+k), applied now, kept for s+k's -k reading;
    // every step's partner is loaded before any pair is evaluated
    float xo[kSteps], po[kSteps];
    int theirs[kSteps][NW];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      load_step<NW, PACKED>(prm, t0 + q * kThreads + threadIdx.x + k, xo[q],
                            po[q], theirs[q]);
    }
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int j = q * kThreads + threadIdx.x;
      float w, upd, upd_o;
      pair_update(x[q], ps[q], xo[q], po[q],
                  pair_weight<NW, PACKED>(mine[q], theirs[q], ki, last),
                  prm.eta, w, upd, upd_o);
      dsum[q] = __fsub_rn(dsum[q], upd);
      csum[q] = __fadd_rn(csum[q], w);
      tw[j] = w;
      tu[j] = upd_o;
    }
    __syncthreads();
    // -k: the pair (s-k, s), from the table inside the tile
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int j = q * kThreads + threadIdx.x;
      float w, upd;
      if (j >= k) {
        w = tw[j - k];
        upd = tu[j - k];
      } else {
        float xo, po, upd_o;
        int theirs[NW];
        load_step<NW, PACKED>(prm, t0 + j - k, xo, po, theirs);
        pair_update(xo, po, x[q], ps[q],
                    pair_weight<NW, PACKED>(theirs, mine[q], ki, last), prm.eta,
                    w, upd_o, upd);
      }
      dsum[q] = __fsub_rn(dsum[q], upd);
      csum[q] = __fadd_rn(csum[q], w);
    }
  }
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const long long s = t0 + q * kThreads + threadIdx.x;
    if (s < prm.S) {
      prm.dsum[s] = dsum[q];
      prm.csum[s] = csum[q];
    }
  }
}

template <int NW, bool PACKED>
void launch(const BucketParams& prm, cudaStream_t stream) {
  const int blocks = (prm.S + kTile - 1) / kTile;
  bucket_apply_kernel<NW, PACKED><<<blocks, kThreads, 0, stream>>>(prm);
}

}  // namespace

// C interface, bound with ctypes.  Device pointers: xs, pos, w0..w3
// (n_words of them, the rest NULL), dsum, csum.  Host arrays: ks, kis
// (n_buckets entries).  Launches on `stream` of device `device` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int gfasort_bucket_apply(
    int device, const float* xs, const float* pos,
    const int* w0, const int* w1, const int* w2, const int* w3,
    int n_words, int proposals, int S, float eta,
    const int* ks, const int* kis, int n_buckets,
    float* dsum, float* csum, void* stream) {
  if (S <= 0 || n_buckets < 1 || n_buckets > kMaxBuckets ||
      n_words < 1 || n_words > kMaxWords || proposals < 1 ||
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
  BucketParams prm;
  prm.xs = xs;
  prm.pos = pos;
  prm.words[0] = w0;
  prm.words[1] = w1;
  prm.words[2] = w2;
  prm.words[3] = w3;
  prm.dsum = dsum;
  prm.csum = csum;
  prm.S = S;
  prm.proposals = proposals;
  prm.n_buckets = n_buckets;
  prm.eta = eta;
  for (int b = 0; b < kMaxBuckets; ++b) {
    prm.k[b] = b < n_buckets ? ks[b] : 0;
    prm.ki[b] = b < n_buckets ? kis[b] : 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (proposals == 1) {
    launch<1, false>(prm, st);
  } else {
    switch (n_words) {
      case 1: launch<1, true>(prm, st); break;
      case 2: launch<2, true>(prm, st); break;
      case 3: launch<3, true>(prm, st); break;
      default: launch<4, true>(prm, st); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
