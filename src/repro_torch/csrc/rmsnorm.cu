// K4 — fused RMSNorm: x * rsqrt(mean(x^2) + eps) * w, fp32 math.
//
// Replaces the TPU kernel `rmsnorm_fwd` (src/repro/kernels/rmsnorm/kernel.py).
//
// Bound on an H100: bytes — rows * d * (input + output bytes) + 4 * d for the
// weight, against the card's memory bandwidth.
//
// Design: one thread block per row, 16-byte loads, fp32 sum of squares
// reduced by warp shuffles and one shared-memory step, one write.  The second
// pass re-reads the row, which is still in L1/L2 (a row is at most 72 KB), so
// device memory sees one read and one write.  Rows are taken as they come:
// there is no padding to a block of rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kNormThreads = 256;

template <typename T> struct NormVec;
template <> struct NormVec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <> struct NormVec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    float4 raw = *reinterpret_cast<const float4*>(p);
    out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
               int d, float eps) {
  constexpr int N = NormVec<T>::N;
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;
  const int chunks = d / N;

  float sumsq = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kNormThreads) {
    float v[N];
    NormVec<T>::load(xr + c * N, v);
#pragma unroll
    for (int i = 0; i < N; ++i) sumsq = fmaf(v[i], v[i], sumsq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
  __shared__ float warp_sums[kNormThreads / 32];
  __shared__ float inv_rms;
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sumsq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kNormThreads / 32; ++i) total += warp_sums[i];
    inv_rms = rsqrtf(total / (float)d + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  for (int c = threadIdx.x; c < chunks; c += kNormThreads) {
    float v[N], wv[N];
    NormVec<T>::load(xr + c * N, v);
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      float4 w4 = *reinterpret_cast<const float4*>(w + c * N + i);
      wv[i] = w4.x; wv[i + 1] = w4.y; wv[i + 2] = w4.z; wv[i + 3] = w4.w;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * inv * wv[i];
    NormVec<T>::store(orow + c * N, v);
  }
}

}  // namespace repro_torch

// x, out: (rows, d) contiguous, 16-byte aligned, d a multiple of 8; w: (d,)
// float32.  dtype: 0 = bfloat16, 1 = float32.  Returns the CUDA error code of
// the launch (0 = success).
extern "C" int repro_torch_rmsnorm(const void* x, const void* w, void* out, int dtype,
                                   int rows, int d, float eps, void* stream) {
  using namespace repro_torch;
  if (rows < 1 || d < 8 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kNormThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<float><<<rows, kNormThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
