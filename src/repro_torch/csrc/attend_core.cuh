// Online-softmax attention core of the decode kernel's FMA route (K2,
// flash_decode.cu: an fp32 q, and a bf16 q's widened rows over quantized
// codes) and of the prefill kernel's FMA route (K1 over fp32, and a bf16 q
// over the fp32 K / V of a dequantized page pool: flash_prefill.cu).  K1's
// bf16 route and K2's bf16 widened q run the tensor-core body of
// attend_tc.cuh instead, and K2's single bf16 token (over values or codes)
// the split route of decode_split.cuh.
//
// One thread block owns RT query rows and walks a contiguous interval of KV
// blocks.  The running max / denominator / accumulator stay on chip for the
// whole walk (m, l in shared memory, the accumulator in registers); K and V
// stream through shared memory one block at a time, converted to fp32 on the
// way in, and all arithmetic is fp32.  Each row carries its own live slot
// range [lo, hi), so causal, sliding-window, ragged and per-request masks are
// all the same comparison in logical slot space.
//
// K and V may have another element type than q and o: bf16 or fp32 values,
// or int8 / fp8 (e4m3, e5m2) codes of a quantized cache.  A block of codes is
// dequantized on the way into shared memory as float(code) * scale, with the
// one fp32 scale of the page (per KV head) that holds the block — a block
// never straddles a page — and the fp32 arithmetic that follows is the same
// as for values.
//
// Thread layout: 16 threads along the KV block (TX) by RT/MR along the rows.
// Scores are an MR x 4 register tile per thread, the output an MR x (D/16)
// register tile (column c of a thread is tx + 16*c).  Shared rows are padded
// by one float so the strided reads of both products are conflict-free.
//
// This is the simple-and-right version: plain FMAs, synchronous loads, one
// block walking a row tile's whole interval.  Its bound on an H100 is the
// decode's bytes (K2) or, for K1's FMA route, the fp32 peak; the routes that
// most calls take are the tensor-core ones (attend_tc.cuh,
// decode_split.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kBKV = 64;          // shared-memory capacity of one KV block
constexpr int kTX = 16;           // threads along the KV block
constexpr int kMC = kBKV / kTX;   // score columns per thread
constexpr float kNegInf = -1e30f;

template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
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
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    float4 raw = *reinterpret_cast<const float4*>(p);
    out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
  }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

// One-byte codes of a quantized cache: 8 per 8-byte load, converted exactly
// to fp32 (int8 and both fp8 formats are subsets of fp32).
template <typename C>
struct CodeVec {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const C* p, float* out) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const C* c = reinterpret_cast<const C*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(c[i]);
  }
};
template <> struct Vec<int8_t> : CodeVec<int8_t> {};
template <> struct Vec<__nv_fp8_e4m3> : CodeVec<__nv_fp8_e4m3> {};
template <> struct Vec<__nv_fp8_e5m2> : CodeVec<__nv_fp8_e5m2> {};

// Whether an element type holds codes that need their page's scale.
template <typename T> struct IsCode { static constexpr bool value = true; };
template <> struct IsCode<__nv_bfloat16> { static constexpr bool value = false; };
template <> struct IsCode<float> { static constexpr bool value = false; };

// Floats of dynamic shared memory one block needs.
template <int RT>
__host__ __device__ inline size_t attend_smem_bytes(int D) {
  size_t floats = (size_t)(RT + 2 * kBKV) * (D + 1)   // q, k, v tiles
                + (size_t)RT * (kBKV + 1)             // scores / probabilities
                + 3 * (size_t)RT;                     // m, l, alpha
  return floats * sizeof(float) + 2 * (size_t)RT * sizeof(int);  // lo, hi
}

// Copy `rows` rows of D elements (row r at base + r * stride) into a padded
// fp32 tile; rows outside [row_begin, row_end) are zero-filled and never read.
// Codes of a quantized cache come out as float(code) * scale.
template <typename T, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t stride,
                                          int rows, int row_begin, int row_end, int D,
                                          float scale) {
  constexpr int N = Vec<T>::N;
  const int cpr = D / N;  // vector loads per row
  for (int c = threadIdx.x; c < rows * cpr; c += NT) {
    const int r = c / cpr;
    const int d0 = (c - r * cpr) * N;
    float vals[N];
    if (r >= row_begin && r < row_end) {
      Vec<T>::load(base + (int64_t)r * stride + d0, vals);
      if (IsCode<T>::value) {
#pragma unroll
        for (int i = 0; i < N; ++i) vals[i] *= scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) vals[i] = 0.f;
    }
    float* out = dst + r * (D + 1) + d0;
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = vals[i];
  }
}

// Where the rows of this block live and what each may see.
//   q_row(r) / o_row(r): global pointers of row r (r < nrows)
//   lo(r), hi(r):        live logical slots of row r are lo <= kp < hi
//   store_lse(r, m, l):  keeps row r's softmax statistics, or does nothing
// Where the KV blocks live (elements of type TK).
//   k_block(jb) / v_block(jb): pointer to slot jb * bkv of this (batch, head)
//   k_scale(jb) / v_scale(jb): the block's dequant scale (codes only)
//   slot_stride:               elements between consecutive slots
template <typename T, typename TK, int RT, int MR, int DC, class Rows, class Blocks>
__device__ void attend_rows(const Rows& rows, const Blocks& blocks, int nrows, int D,
                            int bkv, int blk_begin, int blk_end, int walk_begin,
                            int walk_end, int slot_begin, int slot_end, float scale,
                            float softcap) {
  constexpr int TY = RT / MR;
  constexpr int NT = kTX * TY;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + RT * (D + 1);
  float* vs = ks + kBKV * (D + 1);
  float* ss = vs + kBKV * (D + 1);
  float* m_s = ss + RT * (kBKV + 1);
  float* l_s = m_s + RT;
  float* a_s = l_s + RT;
  int* lo_s = reinterpret_cast<int*>(a_s + RT);
  int* hi_s = lo_s + RT;

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // -- q tile, row bounds, running statistics --------------------------------
  {
    constexpr int N = Vec<T>::N;
    const int cpr = D / N;
    for (int c = tid; c < RT * cpr; c += NT) {
      const int r = c / cpr;
      const int d0 = (c - r * cpr) * N;
      float vals[N];
      if (r < nrows) {
        Vec<T>::load(rows.q_row(r) + d0, vals);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) qs[r * (D + 1) + d0 + i] = vals[i];
    }
    for (int r = tid; r < RT; r += NT) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
      a_s[r] = 1.f;
      lo_s[r] = r < nrows ? rows.lo(r) : 0;
      hi_s[r] = r < nrows ? rows.hi(r) : 0;  // empty range: padded rows see nothing
    }
  }
  float acc[MR][DC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  __syncthreads();

  // -- walk the KV blocks ------------------------------------------------------
  // [walk_begin, walk_end) is streamed; only [blk_begin, blk_end) is computed
  // (they differ for the unpruned baseline, which streams dead blocks too).
  for (int jb = walk_begin; jb < walk_end; ++jb) {
    const int k_start = jb * bkv;
    // rows of the tile that hold live slots of this problem
    const int row_begin = max(0, slot_begin - k_start);
    const int row_end = min(bkv, slot_end - k_start);
    load_tile<TK, NT>(ks, blocks.k_block(jb), blocks.slot_stride_k, kBKV, row_begin,
                      row_end, D, blocks.k_scale(jb));
    load_tile<TK, NT>(vs, blocks.v_block(jb), blocks.slot_stride_v, kBKV, row_begin,
                      row_end, D, blocks.v_scale(jb));
    __syncthreads();
    if (jb >= blk_begin && jb < blk_end) {
      // scores: MR x kMC register tile of q . k
      float s[MR][kMC];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < kMC; ++j) s[i][j] = 0.f;
      const float* qrow = qs + (ty * MR) * (D + 1);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[MR], kv[kMC];
#pragma unroll
        for (int i = 0; i < MR; ++i) qv[i] = qrow[i * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < kMC; ++j) kv[j] = ks[(tx + kTX * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < kMC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int r = ty * MR + i;
        const int lo = lo_s[r], hi = hi_s[r];
#pragma unroll
        for (int j = 0; j < kMC; ++j) {
          const int col = tx + kTX * j;
          const int kp = k_start + col;
          float val = s[i][j] * scale;
          if (softcap > 0.f) val = tanhf(val / softcap) * softcap;
          const bool live = col < bkv && kp >= lo && kp < hi;
          ss[r * (kBKV + 1) + col] = live ? val : kNegInf;
        }
      }
      __syncthreads();

      // online softmax, one warp per row: p = exp(s - m_new) * mask
      for (int r = warp; r < RT; r += NW) {
        const int lo = lo_s[r], hi = hi_s[r];
        float v0 = ss[r * (kBKV + 1) + lane];
        float v1 = ss[r * (kBKV + 1) + lane + 32];
        float mx = fmaxf(v0, v1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const int kp0 = k_start + lane, kp1 = k_start + lane + 32;
        const bool live0 = lane < bkv && kp0 >= lo && kp0 < hi;
        const bool live1 = lane + 32 < bkv && kp1 >= lo && kp1 < hi;
        const float p0 = live0 ? expf(v0 - m_new) : 0.f;
        const float p1 = live1 ? expf(v1 - m_new) : 0.f;
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        ss[r * (kBKV + 1) + lane] = p0;
        ss[r * (kBKV + 1) + lane + 32] = p1;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[r] = alpha;
          m_s[r] = m_new;
          l_s[r] = alpha * l_s[r] + sum;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p . v
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float alpha = a_s[ty * MR + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      }
      const float* prow = ss + (ty * MR) * (kBKV + 1);
      for (int j = 0; j < kBKV; ++j) {
        float pv[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i) pv[i] = prow[i * (kBKV + 1) + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = tx + kTX * c;
          if (col < D) {
            const float vv = vs[j * (D + 1) + col];
#pragma unroll
            for (int i = 0; i < MR; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
          }
        }
      }
    }
    __syncthreads();  // the next block overwrites the tiles
  }

  // -- finalize: out = acc / max(l, 1e-30) (a fully masked row yields 0) --------
  // Rows that keep their softmax statistics (the training forward) store
  // lse = m + log(max(l, 1e-30)); a fully masked row keeps m = -1e30, so the
  // backward's exp(s - lse) of its masked scores stays finite and is masked.
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ty * MR + i;
    if (r < nrows) {
      const float denom = fmaxf(l_s[r], 1e-30f);
      if (tx == 0) rows.store_lse(r, m_s[r], denom);
      T* out = rows.o_row(r);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + kTX * c;
        if (col < D) out[col] = Vec<T>::from_float(acc[i][c] / denom);
      }
    }
  }
}

// Raise the dynamic shared-memory limit of `kernel` to `smem` and launch it.
template <typename Args>
inline cudaError_t launch_with_smem(void (*kernel)(Args), dim3 grid, dim3 block,
                                    size_t smem, cudaStream_t stream, const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace repro_torch
