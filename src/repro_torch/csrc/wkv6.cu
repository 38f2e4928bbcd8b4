// K6 — RWKV6 WKV recurrence, per (batch, head) with a (C x C) fp32 state:
//
//     y_t[j]   = sum_i r_t[i] S[i,j]  +  (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//     S[i,j]  <-  w_t[i] S[i,j] + k_t[i] v_t[j]
//
// Replaces the TPU kernel `wkv_fwd` (src/repro/kernels/rwkv6/kernel.py).
// That kernel runs the chunked parallel form: per chunk of L steps it builds
// the pairwise decay tensor exp(li_{i-1} - li_j) of shape (L, L, C) in VMEM
// and does the intra-chunk work as matrix products.  At L = 32, C = 64 that
// tensor alone is 256 KB, more than the 227 KB of shared memory a block can
// have, so it is not carried over.
//
// Bound on an H100: at C = 64 about 5 C^2 fp32 flops per (step, head) against
// 12 bytes per element moved (bf16 r, k, v, y and fp32 w): operations, by a
// little, against the 67 TFLOP/s of fp32 outside the tensor cores.
//
// Design: the sequential form of the plain version `wkv_scan`.  One block of
// C = 64 threads per (b, h); thread j keeps column S[:, j] (64 fp32) in
// registers for the whole sequence.  Per step, thread i publishes r_t[i],
// k_t[i], w_t[i] and r_t[i] u[i] k_t[i] in shared memory (double-buffered,
// one barrier a step), and every thread reads them as broadcasts.  The next
// step's loads are issued before this step's arithmetic.  r, k, v are read in
// their own type and the model's (B, S, H, C) layout, w in fp32; y is written
// in r's type, the last state in fp32.  The state update is an unfused
// multiply-multiply-add, the plain version's roundings.  A ragged sequence
// needs no padding: the loop stops at S.  Only B * H blocks run (40 at
// B = 1), one 2-warp block per SM: the chunked tensor-core form is the way to
// fill the card, later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWkvC = 64;  // head size = threads per block

template <typename T> __device__ __forceinline__ float wkv_load(const T* p);
template <> __device__ __forceinline__ float wkv_load<float>(const float* p) {
  return __ldg(p);
}
template <> __device__ __forceinline__ float wkv_load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ void wkv_store(T* p, float x);
template <> __device__ __forceinline__ void wkv_store<float>(float* p, float x) { *p = x; }
template <> __device__ __forceinline__ void wkv_store<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kWkvC)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_last,
            int S, int H) {
  __shared__ __align__(16) float sr[2][kWkvC];
  __shared__ __align__(16) float sk[2][kWkvC];
  __shared__ __align__(16) float sw[2][kWkvC];
  __shared__ __align__(16) float sp[2][kWkvC];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const int64_t step = (int64_t)H * kWkvC;  // elements between time steps
  const int64_t at = (int64_t)b * S * step + (int64_t)h * kWkvC + j;

  float st[kWkvC];  // column j of the state
  const float* s0p = s0 + (int64_t)bh * kWkvC * kWkvC + j;
#pragma unroll
  for (int i = 0; i < kWkvC; ++i) st[i] = s0p[i * kWkvC];
  const float uj = u[h * kWkvC + j];

  float rn = wkv_load(r + at), kn = wkv_load(k + at), vn = wkv_load(v + at);
  float wn = __ldg(w + at);
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    sp[buf][j] = rn * uj * kn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < S) {  // the next step's loads fly while this step computes
      const int64_t nx = at + (int64_t)(t + 1) * step;
      rn = wkv_load(r + nx);
      kn = wkv_load(k + nx);
      vn = wkv_load(v + nx);
      wn = __ldg(w + nx);
    }
    const float4* r4 = reinterpret_cast<const float4*>(sr[buf]);
    const float4* k4 = reinterpret_cast<const float4*>(sk[buf]);
    const float4* w4 = reinterpret_cast<const float4*>(sw[buf]);
    const float4* p4 = reinterpret_cast<const float4*>(sp[buf]);
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, coef[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kWkvC / 4; ++q) {
      const float4 rq = r4[q], kq = k4[q], wq = w4[q], pq = p4[q];
      const int i = 4 * q;
      acc[0] = fmaf(rq.x, st[i], acc[0]);
      acc[1] = fmaf(rq.y, st[i + 1], acc[1]);
      acc[2] = fmaf(rq.z, st[i + 2], acc[2]);
      acc[3] = fmaf(rq.w, st[i + 3], acc[3]);
      coef[0] += pq.x;
      coef[1] += pq.y;
      coef[2] += pq.z;
      coef[3] += pq.w;
      st[i] = __fadd_rn(__fmul_rn(wq.x, st[i]), __fmul_rn(kq.x, vj));
      st[i + 1] = __fadd_rn(__fmul_rn(wq.y, st[i + 1]), __fmul_rn(kq.y, vj));
      st[i + 2] = __fadd_rn(__fmul_rn(wq.z, st[i + 2]), __fmul_rn(kq.z, vj));
      st[i + 3] = __fadd_rn(__fmul_rn(wq.w, st[i + 3]), __fmul_rn(kq.w, vj));
    }
    const float out = ((acc[0] + acc[1]) + (acc[2] + acc[3]))
                      + ((coef[0] + coef[1]) + (coef[2] + coef[3])) * vj;
    wkv_store(y + at + (int64_t)t * step, out);
  }
  float* sl = s_last + (int64_t)bh * kWkvC * kWkvC + j;
#pragma unroll
  for (int i = 0; i < kWkvC; ++i) sl[i * kWkvC] = st[i];
}

}  // namespace repro_torch

// r, k, v, y: (B, S, H, 64) of `dtype` (0 = bfloat16, 1 = float32); w:
// (B, S, H, 64) float32; u: (H, 64) float32; s0, s_last: (B, H, 64, 64)
// float32; all contiguous.  Returns the CUDA error code of the launch.
extern "C" int repro_torch_wkv6(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* s0, void* y, void* s_last,
                                int dtype, int B, int S, int H, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  if (dtype == 0) {
    wkv6_kernel<__nv_bfloat16><<<blocks, kWkvC, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(s_last), S, H);
  } else if (dtype == 1) {
    wkv6_kernel<float><<<blocks, kWkvC, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(y), static_cast<float*>(s_last), S, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
