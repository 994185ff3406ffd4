// Shift-sum probe kernels, for Hopper (sm_90a):
//   out[s] = sum_{k = -halo .. halo} x[s + k], x = 0 outside [0, S),
// summed in ascending k from the k = -halo term, each add rounded to
// nearest.  The zero-padded terms are added, not skipped (-0 + +0 is +0),
// so every output equals ops/shift_sum.py::shift_sum_ref bit for bit.
//
// Replaces the three mechanism probes of scratch/dense_probe.py:
// pallas_transpose (:81), pallas_laneroll (:116) and pallas_dma (:152).
// Each computed this 17-term sum (halo 8) through one TPU mechanism: a
// VMEM transpose, static lane rolls, or 17 element-offset DMAs.  Those
// are TPU workarounds; on the card the question they asked becomes how a
// thread should reach its shifted neighbours.  Two answers, side by side:
// registers and shuffles (global), or a tile staged in shared memory
// (smem).  The zero-padded edge is pallas_dma's; the first two probes
// wrapped inside each 64k block instead.
//
// What bounds it on the card: memory traffic, one 4-byte word in and one
// out per element (0.160 ms at 2^26 elements at 3.35 TB/s).  The 2 * halo
// adds per element take at most a quarter of that time at halo 16.  The
// first designs did not reach the traffic's rate: `global` made one
// guarded 4-byte load per term (17 per output at halo 8), so L1 requests
// set its pace; `smem` staged a tile a scalar at a time, then summed and
// stored it with nothing in flight.  Both designs below move 16-byte
// vectors and keep loads in flight.
//
// Coordinates.  x may start anywhere on a 4-byte boundary: A = (address of
// x / 4) mod 4 elements past a 16-byte boundary.  Vector v is the aligned
// 16 bytes holding x[4v - A .. 4v + 3 - A]; output vector v is out[4v ..
// 4v + 3] (out is 16-byte aligned).  The four outputs of output vector v
// read the vectors v + kLo .. v + kHi (Window below): the aligned superset
// of the halo.  A is a template parameter, so every register index is a
// constant.  A vector wholly inside [0, S) is one 16-byte load; the at most
// two that straddle an end of x are loaded element by element with zeros
// outside, and those wholly outside are zeros.
//
//   global: no shared memory.  A thread owns one output vector and loads
//     its own input vector (__ldg, 16 bytes).  The lanes of a warp hold 32
//     consecutive vectors and take their neighbours' elements by shuffles,
//     2 * halo per thread, each source lane offering the register its
//     reader needs.  Only the lanes at the warp's ends load one more vector
//     each: -kLo lanes the vectors left of the warp, kHi lanes those right
//     of it, so a warp loads 32 - kLo + kHi vectors for its 32.
//   smem: a block owns a tile of kThreads output vectors.  The tile's
//     input vectors and their halo reach shared memory by 16-byte cp.async
//     (the straddling and the zero vectors by plain stores); after one
//     barrier a thread sums its output vector from kHi - kLo + 1
//     consecutive 16-byte shared loads (a warp reads 32 consecutive
//     vectors, with no bank conflict).  Loads stay in flight through the
//     other blocks resident on the SM.  A persistent grid that walked the tiles
//     through a ring of 2, 3 or 4 stages, copying the next tiles while it
//     summed, took 4-8% longer at 2^26 elements (PERF.md), so a block
//     stages one tile.
// Both store 16-byte vectors with the streaming hint (__stcs), so at 2^26
// the output does not push the input out of L2; the last output vector,
// where S is not a multiple of 4, is stored element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block, both kernels

// The vectors v + kLo .. v + kHi that output vector v reads:
// kLo = floor((A - HALO) / 4), kHi = floor((HALO + 3 + A) / 4).
template <int HALO, int A>
struct Window {
  static constexpr int kLo = A >= HALO ? 0 : -((HALO - A + 3) / 4);
  static constexpr int kHi = (HALO + 3 + A) / 4;
  static constexpr int kVecs = kHi - kLo + 1;
  // w[q] (q < 4 kVecs) holds element 4 (v + kLo) + q of the vector space;
  // output 4v + c's term k is w[kQ + c + k]
  static constexpr int kQ = A - 4 * kLo;
};

__device__ __forceinline__ float elem(const float* __restrict__ x, int g,
                                      int S) {
  return (g >= 0 && g < S) ? __ldg(x + g) : 0.0f;
}

// Vector v of x: x[4v - A .. 4v + 3 - A], zeros outside [0, S).
template <int A>
__device__ __forceinline__ float4 load_vec(const float* __restrict__ x, int v,
                                           int S) {
  const int g = 4 * v - A;
  if (g >= 0 && g <= S - 4) {
    return __ldg(reinterpret_cast<const float4*>(x + g));
  }
  return make_float4(elem(x, g, S), elem(x, g + 1, S), elem(x, g + 2, S),
                     elem(x, g + 3, S));
}

// The four sums of one output vector from its window w (Window::kQ).
template <int HALO, int A>
__device__ __forceinline__ float4 window_sums(const float* w) {
  constexpr int Q = Window<HALO, A>::kQ;
  float r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float acc = w[Q + c - HALO];
#pragma unroll
    for (int k = -HALO + 1; k <= HALO; ++k) acc = __fadd_rn(acc, w[Q + c + k]);
    r[c] = acc;
  }
  return make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void store_vec(float* __restrict__ out, int v,
                                          float4 r, int S) {
  const int s = 4 * v;
  if (s <= S - 4) {
    __stcs(reinterpret_cast<float4*>(out + s), r);
    return;
  }
  if (s < S) out[s] = r.x;
  if (s + 1 < S) out[s + 1] = r.y;
  if (s + 2 < S) out[s + 2] = r.z;
}

template <int HALO, int A>
__global__ void __launch_bounds__(kThreads)
shift_sum_global(const float* __restrict__ x, float* __restrict__ out,
                 int S) {
  using W = Window<HALO, A>;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kThreads + threadIdx.x;   // output vector
  if (4 * (v - lane) >= S) return;                     // the warp is past S
  const float4 own = load_vec<A>(x, v, S);
  // lanes 32 + kLo .. 31 hold the vectors left of the warp, lanes
  // 0 .. kHi - 1 the vectors right of it
  float4 edge = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane >= 32 + W::kLo) {
    edge = load_vec<A>(x, v - 32, S);
  } else if (lane < W::kHi) {
    edge = load_vec<A>(x, v + 32, S);
  }
  const float o4[4] = {own.x, own.y, own.z, own.w};
  const float e4[4] = {edge.x, edge.y, edge.z, edge.w};
  float w[4 * W::kVecs];
#pragma unroll
  for (int m = W::kLo; m <= W::kHi; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = 4 * (m - W::kLo) + c;
      if (q < W::kQ - HALO || q > W::kQ + 3 + HALO) {
        w[q] = 0.0f;   // no term of this thread
      } else if (m == 0) {
        w[q] = o4[c];
      } else {
        // reader lane - m sits in the warp: the source offers its own
        // vector; the reader wrapped around the warp: its edge vector
        const bool mine = m > 0 ? lane >= m : lane < 32 + m;
        w[q] = __shfl_sync(0xffffffffu, mine ? o4[c] : e4[c],
                           (lane + m) & 31);
      }
    }
  }
  store_vec(out, v, window_sums<HALO, A>(w), S);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

template <int HALO, int A>
__global__ void __launch_bounds__(kThreads)
shift_sum_smem(const float* __restrict__ x, float* __restrict__ out, int S) {
  using W = Window<HALO, A>;
  // vectors blockIdx.x kThreads + kLo .. blockIdx.x kThreads + kThreads - 1
  // + kHi
  constexpr int kStaged = kThreads + W::kHi - W::kLo;
  __shared__ float4 tile[kStaged];
  const int v0 = blockIdx.x * kThreads + W::kLo;
  for (int i = threadIdx.x; i < kStaged; i += kThreads) {
    const int g = 4 * (v0 + i) - A;
    if (g >= 0 && g <= S - 4) {
      cp_async16(tile + i, x + g);
    } else {
      tile[i] = make_float4(elem(x, g, S), elem(x, g + 1, S),
                            elem(x, g + 2, S), elem(x, g + 3, S));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const float4* src = tile + threadIdx.x;
  float w[4 * W::kVecs];
#pragma unroll
  for (int m = 0; m < W::kVecs; ++m) {
    const float4 q = src[m];
    w[4 * m] = q.x;
    w[4 * m + 1] = q.y;
    w[4 * m + 2] = q.z;
    w[4 * m + 3] = q.w;
  }
  store_vec(out, blockIdx.x * kThreads + threadIdx.x, window_sums<HALO, A>(w),
            S);
}

template <int HALO, int A>
cudaError_t launch(const float* x, float* out, int S, bool smem,
                   cudaStream_t stream) {
  const int blocks = ((S + 3) / 4 + kThreads - 1) / kThreads;
  if (smem) {
    shift_sum_smem<HALO, A><<<blocks, kThreads, 0, stream>>>(x, out, S);
  } else {
    shift_sum_global<HALO, A><<<blocks, kThreads, 0, stream>>>(x, out, S);
  }
  return cudaGetLastError();
}

template <int HALO>
cudaError_t launch_halo(const float* x, float* out, int S, bool smem, int a,
                        cudaStream_t stream) {
  switch (a) {
    case 0: return launch<HALO, 0>(x, out, S, smem, stream);
    case 1: return launch<HALO, 1>(x, out, S, smem, stream);
    case 2: return launch<HALO, 2>(x, out, S, smem, stream);
    default: return launch<HALO, 3>(x, out, S, smem, stream);
  }
}

}  // namespace

// C interface, bound with ctypes.  Device pointers x (4-byte aligned) and
// out (16-byte aligned), [S] each; halo one of 1, 2, 4, 8, 16; variant 0 =
// global, 1 = smem.  Launches on `stream` of device `device` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int gfasort_shift_sum(int device, const float* x, float* out,
                                 int S, int halo, int variant, void* stream) {
  if (S <= 0 || S > (1 << 30) || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (xa % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int a = static_cast<int>((xa / 4) % 4);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool smem = variant == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (halo) {
    case 1: err = launch_halo<1>(x, out, S, smem, a, st); break;
    case 2: err = launch_halo<2>(x, out, S, smem, a, st); break;
    case 4: err = launch_halo<4>(x, out, S, smem, a, st); break;
    case 8: err = launch_halo<8>(x, out, S, smem, a, st); break;
    case 16: err = launch_halo<16>(x, out, S, smem, a, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

// Outputs a thread computes in one pass of the kernel's body (variant 0 =
// global, 1 = smem): the divisor of a per-output instruction count.
extern "C" int gfasort_shift_sum_outputs_per_pass(int variant) {
  return variant == 0 || variant == 1 ? 4 : 0;
}
