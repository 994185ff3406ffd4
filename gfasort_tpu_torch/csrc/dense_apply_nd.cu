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
// What bounds it on the card: instruction issue, not memory.  The
// inputs are read about once from HBM (partner reads of a block's
// buckets hit L1/L2); evaluating a pair takes a weight count, two IEEE
// divides, a square root and ~3D + 15 more f32 ops.
//
// Design, to issue fewer instructions while staying bit-identical:
// - Each pair is evaluated once.  The pair (t, t+k) read from t (+k)
//   and from t+k (-k) has the same weight, d, safe, mu, mag2 (squares
//   of negated deltas are equal) and so the same w * r; t+k's deltas
//   are -delta, except the guarded delta[0] = 1e-9 where mag2 == 0,
//   which both readings take.  So t+k's update (w * r) * delta'[d] is
//   the negation of t's, or t's own in dimension 0 on that guard.  A
//   block owns kTile consecutive steps, kSteps per thread held in
//   registers.  Per bucket, each step evaluates its own +k pair, applies
//   it and leaves (w, the partner's D updates) in a shared-memory pair
//   table; after one barrier each step takes its -k updates from the
//   table entry of s - k, or, where s - k lies before the tile (the
//   first k steps, every step when k >= kTile), evaluates that pair
//   itself.  So a bucket costs kTile + min(k, kTile) evaluations, not
//   2 kTile.  The table ((D + 1) x kTile floats, 36 KB at most) is
//   double-buffered: one barrier per bucket.  Two steps per thread (a
//   512-step tile, fewer registers, more warps in flight), read-only
//   loads (__ldg) and 32-bit step indices measured faster here than the
//   1D kernel's four steps per thread, 64-bit indices and partner
//   loads hoisted ahead of the evaluations (PERF.md).
// - Proposal counts are byte-SIMD for P > 1: an xor/and/add/or test
//   marks the unequal 8-bit fields of a packed word, a field hits unless
//   both its tests are unequal, and the hits are masked to the first P
//   fields (pack_choices leaves unused fields 0, which equals ki = 0).
//   The words' per-byte hit counts are added in one register and summed
//   by one multiply; the count (an integer <= 16) becomes an f32 by
//   2^23 arithmetic, so it equals the spec's f32 sum of 0/1 terms.
// - Every f32 op is an explicit round-to-nearest intrinsic (and the
//   build passes --fmad=false), so no multiply-add is contracted into
//   an FMA.  The JAX spec's rsqrt is __frcp_rn(__fsqrt_rn(x)), the
//   correctly rounded reciprocal of the correctly rounded root: CUDA's
//   rsqrtf is approximate, and the plain PyTorch version computes the
//   same two ops (1 / sqrt).  The sums run in the spec's order,
//   so the result equals the plain version bit for bit.  (A zero update
//   may carry the other sign than the spec's; acc starts at +0 and
//   never becomes -0, so acc - (+0) and acc - (-0) are equal.)
// D is a template parameter (1-8) so the coordinate loops unroll.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kMaxWords = 4;
constexpr int kMaxDims = 8;                   // ops/sweep_dense.MAX_DIMS
constexpr int kInactive = 0x7FFFFFF;          // sweep_common.INACTIVE
constexpr int kPackedInactive = 0x7F7F7F7F;   // sweep_common.PACKED_INACTIVE
constexpr int kThreads = 256;
constexpr int kSteps = 2;                     // steps per thread
constexpr int kTile = kThreads * kSteps;      // steps per block

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

// Step i's position, coordinates and choice words; past either end 0
// and the fill.
// Indices are taken modulo 2^32: s + k stays below 2^32 (S, k < 2^31)
// and s - k < 0 wraps to 2^31 or more, so one compare finds both ends.
template <int D, bool PACKED>
__device__ __forceinline__ void load_step(const NdParams& prm, unsigned i,
                                          float& p, float (&c)[D],
                                          int (&w)[kMaxWords]) {
  const bool in = i < static_cast<unsigned>(prm.S);
  p = in ? __ldg(prm.pos + i) : 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    c[d] = in ? __ldg(prm.c + static_cast<size_t>(d) * prm.S + i) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    w[j] = in && j < prm.n_words ? __ldg(prm.words[j] + i)
                                 : (PACKED ? kPackedInactive : kInactive);
  }
}

// The f32 weight of the pair (a, a+k): the number of proposals with a's
// field equal to ki or a+k's equal to ~ki.  `keep[j]` keeps the used
// fields of word j.
template <bool PACKED>
__device__ __forceinline__ float pair_weight(const int (&wa)[kMaxWords],
                                             const int (&wb)[kMaxWords], int ki,
                                             const unsigned (&keep)[kMaxWords],
                                             int n_words) {
  if (!PACKED) return (wa[0] == ki || wb[0] == ~ki) ? 1.0f : 0.0f;
  const unsigned want_a = 0x01010101u * static_cast<unsigned>(ki);
  const unsigned want_b = 0x01010101u * (static_cast<unsigned>(~ki) & 0xFFu);
  unsigned hits = 0;   // per byte: the hits among the words' fields there
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    if (j < n_words) {
      hits += (~(byte_ne(wa[j], want_a) & byte_ne(wb[j], want_b)) & keep[j])
              >> 7;
    }
  }
  // the four byte counts (each <= 4) summed into the top byte
  return small_int_to_float(static_cast<int>((hits * 0x01010101u) >> 24));
}

// The pair (a, b = a+k) in a's +k reading: its weight w (0 where the
// positions coincide), the updates a subtracts ((w * r) * delta[d]) and
// the ones b subtracts in its -k reading.
template <int D>
__device__ __forceinline__ void pair_update(float pa, const float (&ca)[D],
                                            float pb, const float (&cb)[D],
                                            float weight, float eta,
                                            float& w, float (&upd_a)[D],
                                            float (&upd_b)[D]) {
  const float dist = fabsf(__fsub_rn(pa, pb));
  const bool valid = dist != 0.0f;
  w = valid ? weight : 0.0f;
  const float safe = valid ? dist : 1.0f;
  const float mu = fminf(__fdiv_rn(eta, safe), 1.0f);
  float delta[D];
#pragma unroll
  for (int d = 0; d < D; ++d) delta[d] = __fsub_rn(ca[d], cb[d]);
  float mag2 = __fmul_rn(delta[0], delta[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    mag2 = __fadd_rn(mag2, __fmul_rn(delta[d], delta[d]));
  }
  const bool tie = mag2 == 0.0f;
  if (tie) {
    delta[0] = 1e-9f;
    mag2 = 1e-18f;
  }
  const float inv = __frcp_rn(__fsqrt_rn(mag2));   // == __fdiv_rn(1, .)
  const float mag = __fmul_rn(mag2, inv);
  const float r_raw =
      __fmul_rn(__fmul_rn(__fmul_rn(mu, __fsub_rn(mag, safe)), 0.5f), inv);
  // a NaN passes through, as in torch.clamp_max and jnp.minimum
  const float r = r_raw > 1e30f ? 1e30f : r_raw;
  const float wr = __fmul_rn(w, r);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    upd_a[d] = __fmul_rn(wr, delta[d]);
    upd_b[d] = -upd_a[d];
  }
  // on the guard both readings take delta[0] = 1e-9
  if (tie) upd_b[0] = upd_a[0];
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads)
dense_apply_nd_kernel(const NdParams prm) {
  // [2][D + 1][kTile]: the +k pair's weight, then its partner's D
  // updates, per buffer
  extern __shared__ float tab[];
  const unsigned t0 = blockIdx.x * kTile;
  const size_t S = prm.S;
  unsigned keep[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    const int used = prm.proposals - 4 * j;   // fields of word j in use
    keep[j] = used >= 4 ? 0x80808080u
                        : (used > 0 ? 0x80808080u >> (8 * (4 - used)) : 0u);
  }
  float ps[kSteps], mc[kSteps][D], acc[kSteps][D], wacc[kSteps];
  int mine[kSteps][kMaxWords];
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    load_step<D, PACKED>(prm, t0 + q * kThreads + threadIdx.x, ps[q], mc[q],
                         mine[q]);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[q][d] = 0.0f;
    wacc[q] = 0.0f;
  }

  for (int b = 0; b < prm.n_buckets; ++b) {
    const int k = prm.k[b];
    const int ki = prm.ki[b];
    float* tw = tab + (b & 1) * (D + 1) * kTile;
    // +k: my pair (s, s+k), applied now, kept for s+k's -k reading
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int j = q * kThreads + threadIdx.x;
      float po, co[D], w, upd[D], upd_o[D];
      int theirs[kMaxWords];
      load_step<D, PACKED>(prm, t0 + j + k, po, co, theirs);
      pair_update<D>(ps[q], mc[q], po, co,
                     pair_weight<PACKED>(mine[q], theirs, ki, keep,
                                        prm.n_words),
                     prm.eta, w, upd, upd_o);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[q][d] = __fsub_rn(acc[q][d], upd[d]);
        tw[(d + 1) * kTile + j] = upd_o[d];
      }
      wacc[q] = __fadd_rn(wacc[q], w);
      tw[j] = w;
    }
    __syncthreads();
    // -k: the pair (s-k, s), from the table inside the tile
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int j = q * kThreads + threadIdx.x;
      float w, upd[D];
      if (j >= k) {
        w = tw[j - k];
#pragma unroll
        for (int d = 0; d < D; ++d) upd[d] = tw[(d + 1) * kTile + j - k];
      } else {
        float po, co[D], upd_o[D];
        int theirs[kMaxWords];
        load_step<D, PACKED>(prm, t0 + j - k, po, co, theirs);
        pair_update<D>(po, co, ps[q], mc[q],
                       pair_weight<PACKED>(theirs, mine[q], ki, keep,
                                          prm.n_words),
                       prm.eta, w, upd_o, upd);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) acc[q][d] = __fsub_rn(acc[q][d], upd[d]);
      wacc[q] = __fadd_rn(wacc[q], w);
    }
  }
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const unsigned s = t0 + q * kThreads + threadIdx.x;
    if (s < S) {
#pragma unroll
      for (int d = 0; d < D; ++d) prm.acc[d * S + s] = acc[q][d];
      prm.wacc[s] = wacc[q];
    }
  }
}

template <int D>
void launch(const NdParams& prm, bool packed, cudaStream_t stream) {
  // under the 48 KB a block may take without opting in
  const size_t smem = sizeof(float) * 2 * (D + 1) * kTile;
  static_assert(sizeof(float) * 2 * (kMaxDims + 1) * kTile <= 48 * 1024,
                "the pair table outgrows the default shared-memory limit");
  const int blocks = (prm.S + kTile - 1) / kTile;
  if (packed) {
    dense_apply_nd_kernel<D, true><<<blocks, kThreads, smem, stream>>>(prm);
  } else {
    dense_apply_nd_kernel<D, false><<<blocks, kThreads, smem, stream>>>(prm);
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
  for (int b = 0; b < n_buckets; ++b) {
    if (ks[b] < 1) return static_cast<int>(cudaErrorInvalidValue);
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
