// Fused sweep-apply kernel: every bucket of a static offset set in one
// pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gfasort_tpu/ops/sweep_pallas.py::
// build_sweep_apply (kernel body :88-180, pallas_call :183); its spec is
// ops/sweep_fused.py::sweep_apply_ref.  The inputs are padded as that
// kernel's layout says: xs, pos (f32) and sidx (i32) have L = S_pad + 2H
// entries and hold step s at H + s, with zeros (INACTIVE for sidx) around
// the steps; rank and cnt (i32) have S_pad entries, 0 on the padded
// steps.  For every padded step s and every bucket ki of the offset set
// (offset k = offs[ki]), in list order:
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
// the padded arrays.
//
// What bounds it on the card: instruction issue, not memory.  The inputs
// are read about once from HBM, far below the time it takes to issue the
// pair evaluations (an IEEE divide by mag behind its slow-path branch,
// eta / safe where safe > eta, ~15 more f32 ops) and each bucket's loads,
// guards, table traffic and sums (PERF.md).
//
// Design, to evaluate fewer pairs and keep more of them in flight while
// staying bit-identical:
// - Each near pair is evaluated once.  Both readings of (t, t+k) have the
//   same w_bool, d, safe, mu and mag, and t+k's dx is -dx (round-to-
//   nearest subtraction is antisymmetric), so t+k's contribution is the
//   negation of t's, or t's itself where dx == 0 (both readings then take
//   1e-9).  The guards are per side: t's ahead guard and t+k's behind
//   guard agree on a path-contiguous index but may differ on arbitrary
//   ones.  A block owns kTile consecutive steps, kSteps per thread (256 as
//   128 x 2: the fastest of the shapes timed, PERF.md).  For
//   a bucket with k < kTile each step evaluates its ahead pair and leaves
//   (w, the partner's update) in a shared-memory pair table, w = -1 where
//   its ahead guard failed; after one barrier a step whose behind guard
//   holds takes its update from the entry of s - k where that lies in the
//   tile and holds a pair, and evaluates the pair itself otherwise (the
//   tile's first k steps).  The table's buffers alternate over the near
//   buckets: one barrier each.  A side whose guard fails adds a zero with
//   w = 0, as the spec's -0 * r does (r is finite where xs - xs_o is).
//   Far buckets (k >= kTile, uniform over the block) evaluate both sides
//   per step, no barrier.  A zero may come out with the other sign than
//   the spec's; dsum starts at +0 and can never become -0, so that sign
//   never reaches the output.
// - The near window [t0 - kn, t0 + kTile + kn) of xs, pos and sidx (kn:
//   the largest near offset, rounded up to 4) is staged in shared memory
//   by three bulk asynchronous copies (cp.async.bulk, completed on an
//   mbarrier), so near partners are shared-memory reads that need no
//   64-bit addresses.  Where a pointer is not 16-byte aligned, or H or
//   S_pad is not a multiple of 4, the same kernel reads them from global
//   memory instead.
// - A thread's evaluations run in phases over its steps: every partner
//   load, then every pair's subtractions and selects, then every
//   eta / safe, then every divide by mag.  Each IEEE divide sits behind
//   its own slow-path branch, which the compiler does not schedule
//   across; the phases keep the independent work of the steps together.
// - Exact divide cuts: x / 2 is x * 0.5 for every f32, and eta / safe is
//   >= 1 wherever safe <= eta (so mu = 1 there without the divide).  At
//   the first sweeps (large eta) the divide is skipped almost everywhere,
//   at the last (eta ~ eps) nowhere; the divide by mag stays.
// - Every f32 op is an explicit round-to-nearest intrinsic (and the build
//   passes --fmad=false), so each result is rounded as the plain PyTorch
//   version rounds it.  The ahead guard is taken in 64 bits, so no offset
//   can overflow it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 64;
constexpr int kThreads = 128;
constexpr int kSteps = 2;                     // steps per thread
constexpr int kTile = kThreads * kSteps;      // steps per block

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
  int kn;              // the near window's halo (0: no near bucket)
  float eta;
  int offs[kMaxOffsets];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion is counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Wait for phase 0 of the mbarrier `bar`; a copy that never lands traps
// (a launch failure) instead of hanging the card.
__device__ __forceinline__ void wait_phase0(unsigned bar) {
  for (int spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(0u) : "memory");
    if (done) return;
    if (spin > (1 << 20)) __trap();
  }
}

// One reading of a pair, its guard taken as held: the weight and the
// operands of its two divides.
struct Pair {
  float w, safe, dx, mag;
  bool tie;   // dx was 0: the other reading's update is this one's
};

__device__ __forceinline__ Pair pair_begin(float x, float p, float xo,
                                           float po, bool w_bool) {
  Pair e;
  const float d = fabsf(__fsub_rn(p, po));
  const bool valid = d != 0.0f;
  e.w = (valid && w_bool) ? 1.0f : 0.0f;
  e.safe = valid ? d : 1.0f;
  const float dx = __fsub_rn(x, xo);
  e.tie = dx == 0.0f;
  e.dx = e.tie ? 1e-9f : dx;
  e.mag = fabsf(e.dx);
  return e;
}

// mu = min(eta / safe, 1); eta / safe >= 1 where safe <= eta
__device__ __forceinline__ float pair_mu(const Pair& e, float eta) {
  float mu = 1.0f;
  if (!(e.safe <= eta)) mu = fminf(__fdiv_rn(eta, e.safe), 1.0f);
  return mu;
}

// The reading side's update -w * r; x / 2 is x * 0.5 for every f32
__device__ __forceinline__ float pair_end(const Pair& e, float mu) {
  const float r = __fmul_rn(
      __fdiv_rn(__fmul_rn(__fmul_rn(mu, __fsub_rn(e.mag, e.safe)), 0.5f),
                e.mag),
      e.dx);
  return __fmul_rn(-e.w, r);
}

template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
sweep_apply_kernel(const SweepParams prm) {
  __shared__ float tab_w[2][kTile];   // the ahead pair's weight, -1: no pair
  __shared__ float tab_u[2][kTile];   // and its partner's behind update
  __shared__ __align__(8) unsigned long long bar_mem;
  extern __shared__ __align__(16) float wnd[];   // the near window
  const int W = kTile + 2 * prm.kn;
  const float* wx = wnd + prm.kn;
  const float* wp = wnd + W + prm.kn;
  const int* ws = reinterpret_cast<const int*>(wnd + 2 * W) + prm.kn;
  const unsigned bar = smem_addr(&bar_mem);
  const unsigned t0 = blockIdx.x * static_cast<unsigned>(kTile);
  if (STAGED) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int g = prm.H + static_cast<int>(t0) - prm.kn;
      const int L = prm.S_pad + 2 * prm.H;
      const unsigned bytes = 4u * static_cast<unsigned>(min(W, L - g));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(3u * bytes) : "memory");
      bulk_load(wnd, prm.xs + g, bytes, bar);
      bulk_load(wnd + W, prm.pos + g, bytes, bar);
      bulk_load(wnd + 2 * W, prm.sidx + g, bytes, bar);
    }
  }
  float x[kSteps], p[kSteps], dsum[kSteps], csum[kSteps];
  int c[kSteps], si[kSteps], rank[kSteps], room[kSteps];
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const unsigned s = t0 + q * kThreads + threadIdx.x;
    const bool in = s < static_cast<unsigned>(prm.S_pad);
    // a step past S_pad reads step 0's inputs; both its guards fail
    c[q] = prm.H + (in ? static_cast<int>(s) : 0);
    x[q] = prm.xs[c[q]];
    p[q] = prm.pos[c[q]];
    si[q] = prm.sidx[c[q]];
    rank[q] = in ? prm.rank[s] : 0;
    // the ahead guard rank + k < cnt is k < cnt - rank (k in [1, H])
    const long long left = in ? static_cast<long long>(prm.cnt[s]) - rank[q] : 0;
    room[q] = static_cast<int>(left < 0 ? 0 : (left > 0x7FFFFFFF ? 0x7FFFFFFF : left));
    dsum[q] = 0.0f;
    csum[q] = 0.0f;
  }
  if (STAGED) wait_phase0(bar);

  int near = 0;   // near buckets so far: the table buffers alternate by it
  for (int b = 0; b < prm.K; ++b) {
    const int k = prm.offs[b];
    if (k < kTile) {
      // near bucket: the ahead pair once, the behind side from the table
      float* tw = tab_w[near & 1];
      float* tu = tab_u[near & 1];
      ++near;
      float xa[kSteps], pa[kSteps];
      int sa[kSteps];
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int j = q * kThreads + threadIdx.x;
        xa[q] = STAGED ? wx[j + k] : prm.xs[c[q] + k];
        pa[q] = STAGED ? wp[j + k] : prm.pos[c[q] + k];
        sa[q] = STAGED ? ws[j + k] : prm.sidx[c[q] + k];
      }
      Pair e[kSteps];
      float mu[kSteps];
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        e[q] = pair_begin(x[q], p[q], xa[q], pa[q], si[q] == b || sa[q] == ~b);
      }
#pragma unroll
      for (int q = 0; q < kSteps; ++q) mu[q] = pair_mu(e[q], prm.eta);
      float wa[kSteps], ua[kSteps];
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int j = q * kThreads + threadIdx.x;
        const bool ok = k < room[q];
        const float u = pair_end(e[q], mu[q]);
        wa[q] = ok ? e[q].w : 0.0f;
        ua[q] = ok ? u : 0.0f;
        tw[j] = ok ? e[q].w : -1.0f;
        tu[j] = e[q].tie ? u : -u;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int j = q * kThreads + threadIdx.x;
        float wb = 0.0f, ub = 0.0f;
        if (rank[q] >= k) {
          const float tw_j = j >= k ? tw[j - k] : -1.0f;
          if (tw_j >= 0.0f) {
            wb = tw_j;
            ub = tu[j - k];
          } else {   // s - k before the tile, or its ahead guard failed
            const Pair eb = pair_begin(
                x[q], p[q], STAGED ? wx[j - k] : prm.xs[c[q] - k],
                STAGED ? wp[j - k] : prm.pos[c[q] - k],
                si[q] == ~b || (STAGED ? ws[j - k] : prm.sidx[c[q] - k]) == b);
            wb = eb.w;
            ub = pair_end(eb, pair_mu(eb, prm.eta));
          }
        }
        dsum[q] = __fadd_rn(dsum[q], __fadd_rn(ua[q], ub));
        csum[q] = __fadd_rn(csum[q], __fadd_rn(wa[q], wb));
      }
    } else {
      // far bucket: both sides evaluated by the step itself
      Pair e[2][kSteps];
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const float xa = prm.xs[c[q] + k], pa = prm.pos[c[q] + k];
        const float xb = prm.xs[c[q] - k], pb = prm.pos[c[q] - k];
        const int sa = prm.sidx[c[q] + k], sb = prm.sidx[c[q] - k];
        e[0][q] = pair_begin(x[q], p[q], xa, pa, si[q] == b || sa == ~b);
        e[1][q] = pair_begin(x[q], p[q], xb, pb, si[q] == ~b || sb == b);
      }
      float mu[2][kSteps];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < kSteps; ++q) mu[h][q] = pair_mu(e[h][q], prm.eta);
      }
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const bool ok_a = k < room[q], ok_b = rank[q] >= k;
        const float ua = ok_a ? pair_end(e[0][q], mu[0][q]) : 0.0f;
        const float ub = ok_b ? pair_end(e[1][q], mu[1][q]) : 0.0f;
        const float wa = ok_a ? e[0][q].w : 0.0f;
        const float wb = ok_b ? e[1][q].w : 0.0f;
        dsum[q] = __fadd_rn(dsum[q], __fadd_rn(ua, ub));
        csum[q] = __fadd_rn(csum[q], __fadd_rn(wa, wb));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const unsigned s = t0 + q * kThreads + threadIdx.x;
    if (s < static_cast<unsigned>(prm.S_pad)) {
      prm.out[s] = __fadd_rn(x[q], __fdiv_rn(dsum[q], fmaxf(csum[q], 1.0f)));
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  int kn = 0;   // the largest near offset
  for (int b = 0; b < K; ++b) {
    if (offs[b] < 1 || offs[b] > H) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (offs[b] < kTile && offs[b] > kn) kn = offs[b];
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
  // the window's copies need 16-byte aligned starts and sizes
  const bool staged = kn > 0 && H % 4 == 0 && S_pad % 4 == 0 &&
                      aligned16(xs) && aligned16(pos) && aligned16(sidx);
  prm.kn = staged ? (kn + 3) & ~3 : 0;
  const int blocks = (S_pad + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged) {
    const int smem = 3 * (kTile + 2 * prm.kn) * static_cast<int>(sizeof(float));
    const cudaError_t attr = cudaFuncSetAttribute(
        sweep_apply_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    sweep_apply_kernel<true><<<blocks, kThreads, smem, st>>>(prm);
  } else {
    sweep_apply_kernel<false><<<blocks, kThreads, 0, st>>>(prm);
  }
  return static_cast<int>(cudaGetLastError());
}
