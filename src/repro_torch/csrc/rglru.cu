// K5 — RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over (B, S, D), fp32.
//
// Replaces the TPU kernel `rglru_fwd` (src/repro/kernels/rglru/kernel.py).
// That kernel tiles channels into VMEM blocks and solves each time chunk with
// a log-depth associative scan on the vector unit, carrying h in scratch
// across the sequential chunk axis of its grid.
//
// Bound on an H100: bytes — a and b read once, y written once (12 B per
// element) against the card's memory bandwidth; the two flops per element
// are nothing beside that.
//
// Design: one thread per (b, d) channel walks t = 0..S-1 with h in a
// register.  Neighbouring threads take neighbouring channels, so every load
// of a[b, t, :] and b[b, t, :] and every store of y[b, t, :] is coalesced
// along d.  Loads for kUnroll steps are issued before their multiplies, so
// the dependent chain h -> h waits on arithmetic, not on memory.  The step is
// an unfused multiply and add (__fmul_rn, __fadd_rn), the same two roundings
// as the plain version `a[:, t] * h + b[:, t]`, so the two agree bit for bit.
// The loop stops at S: no identity padding of time, as the TPU wrapper needs.
// At B = 1, D = 2560 that is 2560 threads on 132 SMs with a 2048-step chain:
// far from the bytes bound by construction; splitting time into chunks with a
// carry pass is the way to fill the card.
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
