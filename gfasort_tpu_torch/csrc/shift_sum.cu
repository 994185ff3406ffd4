// Shift-sum probe kernels, for Hopper (sm_90a):
//   out[s] = sum_{k = -halo .. halo} x[s + k], x = 0 outside [0, S),
// summed in ascending k from the k = -halo term, each add rounded to
// nearest.
//
// Replaces the three mechanism probes of scratch/dense_probe.py:
// pallas_transpose (:81), pallas_laneroll (:116) and pallas_dma (:152).
// Each computed this 17-term sum (halo 8) through one TPU mechanism: a
// VMEM transpose, static lane rolls, or 17 element-offset DMAs.  Those
// are TPU workarounds; on the card the question they asked becomes how a
// thread should reach its shifted neighbours.  Two answers, side by side:
//   - global: one thread per element, 2 * halo + 1 loads from global
//     memory (neighbouring threads share cache lines, so L1 serves most);
//   - smem:   a block copies its tile of kTile elements plus +-halo into
//     shared memory once, then every thread sums from there.
// The zero-padded edge is pallas_dma's; the first two probes wrapped
// inside each 64k block instead.
//
// What bounds it on the card: memory traffic, one word in and one word
// out per element; the 2 * halo adds per element are far below the f32
// rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                    // elements per thread (smem)
constexpr int kTile = kThreads * kItems;     // elements per block (smem)

template <int HALO>
__global__ void __launch_bounds__(kThreads)
shift_sum_global(const float* __restrict__ x, float* __restrict__ out,
                 int S) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  float acc = s - HALO >= 0 ? x[s - HALO] : 0.0f;
#pragma unroll
  for (int k = -HALO + 1; k <= HALO; ++k) {
    const int o = s + k;
    acc = __fadd_rn(acc, (o >= 0 && o < S) ? x[o] : 0.0f);
  }
  out[s] = acc;
}

template <int HALO>
__global__ void __launch_bounds__(kThreads)
shift_sum_smem(const float* __restrict__ x, float* __restrict__ out, int S) {
  __shared__ float tile[kTile + 2 * HALO];
  const int base = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile + 2 * HALO; i += kThreads) {
    const int g = base - HALO + i;
    tile[i] = (g >= 0 && g < S) ? x[g] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = threadIdx.x + j * kThreads;   // tile[e] holds x[s - HALO]
    const int s = base + e;
    if (s < S) {
      float acc = tile[e];
#pragma unroll
      for (int k = 1; k <= 2 * HALO; ++k) acc = __fadd_rn(acc, tile[e + k]);
      out[s] = acc;
    }
  }
}

template <int HALO>
void launch(const float* x, float* out, int S, bool smem,
            cudaStream_t stream) {
  if (smem) {
    shift_sum_smem<HALO><<<(S + kTile - 1) / kTile, kThreads, 0, stream>>>(
        x, out, S);
  } else {
    shift_sum_global<HALO>
        <<<(S + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x, out, S);
  }
}

}  // namespace

// C interface, bound with ctypes.  Device pointers x, out ([S]); halo one
// of 1, 2, 4, 8, 16; variant 0 = global, 1 = smem.  Launches on `stream`
// of device `device` and returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int gfasort_shift_sum(int device, const float* x, float* out,
                                 int S, int halo, int variant, void* stream) {
  if (S <= 0 || S > (1 << 30) || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool smem = variant == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (halo) {
    case 1: launch<1>(x, out, S, smem, st); break;
    case 2: launch<2>(x, out, S, smem, st); break;
    case 4: launch<4>(x, out, S, smem, st); break;
    case 8: launch<8>(x, out, S, smem, st); break;
    case 16: launch<16>(x, out, S, smem, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
