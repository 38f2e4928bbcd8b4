// The RG-LRU scan as one thread per (b, d) channel: the form of K5 before the
// slab walk of `src/repro_torch/csrc/rglru.cu`, kept as the baseline that
// `tools/rglru_variants.py` builds alone and holds every variant to, bit for
// bit, and times beside them.  It is not part of the kernel library.
//
// Each thread walks t = 0..S-1 with h in a register; neighbouring threads take
// neighbouring channels, so loads and stores are coalesced along d, and loads
// for kLruUnroll steps are issued before their multiplies.  The step is an
// unfused multiply and add (__fmul_rn, __fadd_rn), the plain version's two
// roundings.  At B = 1, D = 2560 that is 20 blocks on 132 SMs with 16 floats a
// thread in flight: about 0.2 TB/s by Little's law.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kLruThreads = 128;
constexpr int kLruUnroll = 8;

__global__ void __launch_bounds__(kLruThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * kLruThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t base = (int64_t)blockIdx.y * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* yp = y + base;
  float h = h0[(int64_t)blockIdx.y * D + d];
  int t = 0;
  for (; t + kLruUnroll <= S; t += kLruUnroll) {
    float av[kLruUnroll], bv[kLruUnroll];
#pragma unroll
    for (int u = 0; u < kLruUnroll; ++u) {
      av[u] = __ldg(ap + (int64_t)(t + u) * D);
      bv[u] = __ldg(bp + (int64_t)(t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < kLruUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      yp[(int64_t)(t + u) * D] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(__ldg(ap + (int64_t)t * D), h), __ldg(bp + (int64_t)t * D));
    yp[(int64_t)t * D] = h;
  }
  h_last[(int64_t)blockIdx.y * D + d] = h;
}

}  // namespace repro_torch

// a, b, y: (B, S, D) float32 contiguous; h0, h_last: (B, D) float32
// contiguous.  Returns the CUDA error code of the launch (0 = success).
extern "C" int repro_torch_rglru(const void* a, const void* b, const void* h0, void* y,
                                 void* h_last, int B, int S, int D, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((D + kLruThreads - 1) / kLruThreads, B);
  rglru_kernel<<<grid, kLruThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_last),
      S, D);
  return (int)cudaGetLastError();
}
