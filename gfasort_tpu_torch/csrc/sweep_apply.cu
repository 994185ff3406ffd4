// Fused sweep-apply kernel: every bucket of a static offset set in one
// pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gfasort_tpu/ops/sweep_pallas.py::
// build_sweep_apply (kernel body :88-180, pallas_call :183).  The inputs
// are padded as that kernel's layout says: xs, pos (f32) and sidx (i32)
// have L = S_pad + 2H entries and hold step s at H + s, with zeros
// (INACTIVE for sidx) around the steps; rank and cnt (i32) have S_pad
// entries, 0 on the padded steps.  For every padded step s and every
// bucket ki of the offset set (offset k = offs[ki]), in list order:
//   ahead  (partner at s + k): pair_ok = rank + k < cnt,
//          w_bool = sidx[s] == ki  || sidx[s + k] == ~ki;
//   behind (partner at s - k): pair_ok = rank >= k,
//          w_bool = sidx[s] == ~ki || sidx[s - k] == ki;
//   d = |pos - pos_o|, valid = pair_ok && d != 0, w = valid && w_bool,
//   safe = valid ? d : 1, mu = min(eta / safe, 1),
//   dx = xs - xs_o (1e-9 where 0), mag = |dx|,
//   r = (mu * (mag - safe) / 2 / mag) * dx, contribution -w * r;
//   dsum += (ahead + behind), csum += (w_ahead + w_behind).
// out[s] = xs + dsum / max(csum, 1).  A padded step has rank = cnt = 0,
// so both guards fail there, and H >= every k keeps each +-k read inside
// the padded arrays: the kernel checks no index.
//
// What bounds it on the card: memory traffic.  Each step reads its own 5
// words and, per bucket and sign, the partner's 3 words (xs, pos, sidx),
// and writes one word.  Adjacent threads read adjacent s +- k, so every
// read is coalesced; partners of small offsets hit L1/L2, those of large
// offsets (up to ~250k steps on a 4M-step index) stream from memory once
// more per bucket.  Three IEEE divides per bucket and sign are the rest.
//
// Design: one thread per padded step, partner reads straight from global
// memory, both sums in registers in the spec's order, the offsets by
// value in the parameter block.  Every f32 op is an explicit
// round-to-nearest intrinsic (and the build passes --fmad=false), so each
// result is rounded as the plain PyTorch version rounds it.  rank + k is
// taken in 64 bits, so no offset can overflow the guard.  Left for later:
// a shared-memory tile with a halo for the small offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 64;
constexpr int kThreads = 256;

struct SweepParams {
  const float* xs;     // [L]
  const float* pos;    // [L]
  const int* sidx;     // [L]
  const int* rank;     // [S_pad]
  const int* cnt;      // [S_pad]
  float* out;          // [S_pad]
  int S_pad;
  int H;
  int K;
  float eta;
  int offs[kMaxOffsets];
};

// One partner's contribution (dd, ww) to step s, in the spec's op order.
__device__ __forceinline__ void half(float x, float p, float xo, float po,
                                     bool pair_ok, bool w_bool, float eta,
                                     float& dd, float& ww) {
  const float d = fabsf(__fsub_rn(p, po));
  const bool valid = pair_ok && d != 0.0f;
  const float w = (valid && w_bool) ? 1.0f : 0.0f;
  const float safe = valid ? d : 1.0f;
  const float mu = fminf(__fdiv_rn(eta, safe), 1.0f);
  float dx = __fsub_rn(x, xo);
  dx = dx == 0.0f ? 1e-9f : dx;
  const float mag = fabsf(dx);
  const float r = __fmul_rn(
      __fdiv_rn(__fdiv_rn(__fmul_rn(mu, __fsub_rn(mag, safe)), 2.0f), mag),
      dx);
  dd = __fmul_rn(-w, r);
  ww = w;
}

__global__ void __launch_bounds__(kThreads)
sweep_apply_kernel(const SweepParams prm) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= prm.S_pad) return;
  const int c = prm.H + s;
  const float x = prm.xs[c];
  const float p = prm.pos[c];
  const int si = prm.sidx[c];
  const long long rank = prm.rank[s];
  const long long cnt = prm.cnt[s];

  float dsum = 0.0f;
  float csum = 0.0f;
  for (int ki = 0; ki < prm.K; ++ki) {
    const int k = prm.offs[ki];
    float d1, w1, d2, w2;
    // partner ahead (s + k): I chose +k, or they chose -k
    half(x, p, prm.xs[c + k], prm.pos[c + k], rank + k < cnt,
         si == ki || prm.sidx[c + k] == ~ki, prm.eta, d1, w1);
    // partner behind (s - k): I chose -k, or they chose +k
    half(x, p, prm.xs[c - k], prm.pos[c - k], rank >= k,
         si == ~ki || prm.sidx[c - k] == ki, prm.eta, d2, w2);
    dsum = __fadd_rn(dsum, __fadd_rn(d1, d2));
    csum = __fadd_rn(csum, __fadd_rn(w1, w2));
  }
  prm.out[s] = __fadd_rn(x, __fdiv_rn(dsum, fmaxf(csum, 1.0f)));
}

}  // namespace

// C interface, bound with ctypes.  Device pointers: xs, pos, sidx ([L],
// L = S_pad + 2H), rank, cnt, out ([S_pad]).  Host array: offs (K
// entries, each in [1, H]).  Launches on `stream` of device `device` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int gfasort_sweep_apply(
    int device, const float* xs, const float* pos, const int* sidx,
    const int* rank, const int* cnt, int S_pad, int H, float eta,
    const int* offs, int K, float* out, void* stream) {
  if (S_pad <= 0 || H < 0 || K < 1 || K > kMaxOffsets ||
      static_cast<long long>(S_pad) + 2LL * H >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b = 0; b < K; ++b) {
    if (offs[b] < 1 || offs[b] > H) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  SweepParams prm;
  prm.xs = xs;
  prm.pos = pos;
  prm.sidx = sidx;
  prm.rank = rank;
  prm.cnt = cnt;
  prm.out = out;
  prm.S_pad = S_pad;
  prm.H = H;
  prm.K = K;
  prm.eta = eta;
  for (int b = 0; b < kMaxOffsets; ++b) prm.offs[b] = b < K ? offs[b] : 0;
  const int blocks = (S_pad + kThreads - 1) / kThreads;
  sweep_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
