// K6 — RWKV6 WKV recurrence, per (batch, head) with a (C x C) fp32 state:
//
//     y_t[j]   = sum_i r_t[i] S[i,j]  +  (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//     S[i,j]  <-  w_t[i] S[i,j] + k_t[i] v_t[j]
//
// Replaces the TPU kernel `wkv_fwd` (src/repro/kernels/rwkv6/kernel.py),
// which runs the chunked parallel form with the (C x C) state carried across
// the chunks of one (b, h) in VMEM scratch, in order on one core.
//
// Bound on an H100: bytes.  At C = 64 the function is ~5 C^2 flops per
// (step, head) against 12 bytes per element moved (bf16 r, k, v, y and fp32
// w): 0.019 ms of bytes at the main shape (B1 S2048 H40), 0.025 ms of
// operations at fp32's 67 TFLOP/s, 0.002 ms at the tensor cores' bf16 rate.
//
// Design: the chunked form, parallel over chunks of L = kWkvChunk = 32 steps
// (PERF.md gives L = 64's time, from tools/wkv_variants.py), so the card
// holds B x H x N blocks of eight warps (2560 at the main shape) rather than
// the B x H = 40 of a walk over time.  Three launches:
//
// 1. wkv6_chunk_state_kernel, grid (N, H, B): each chunk alone.
//    li = cumsum(log max(w, 1e-30)) over the chunk; its state increment
//    dS = (k * exp(li_L - li))^T v and its decay exp(li_L), li_L the cumsum
//    at the chunk's last step.  Written to `states` (B, H, N, C, C) and
//    `decay` (B, H, N, C).
// 2. wkv6_state_scan_kernel, one thread per state element (B H C^2 of
//    them): S_{n+1} = exp(li_L,n) S_n + dS_n in chunk order from s0,
//    overwriting dS_n with S_n, the state entering chunk n; S_N is s_last.
//    Sixteen chunks' loads are issued before their sixteen dependent steps.
// 3. wkv6_chunk_out_kernel, grid (N, H, B):
//    y = (r * exp(li_prev)) S_n + A v with li_prev the cumsum before each
//    step and A the causal (L x L) intra-chunk matrix,
//    A[i,j] = sum_c r_i[c] k_j[c] exp(li_{i-1}[c] - li_j[c]) (j < i),
//    A[i,i] = sum_c r_i[c] u[c] k_i[c].
//
// Stability: every exponent is <= 0 for any decay, as in the reference; the
// (L, L, C) pairwise-decay tensor (256 KB at L = 32, more than a block's
// 227 KB of shared memory) is never built.  A is cut into 16-step
// sub-blocks.  On a diagonal sub-block the pairwise decay of j < i,
// exp(li_{i-1} - li_j), is the product of the clamped decays between them,
// kept as a running product in registers while a thread walks i (decays
// are at most 1, so it can only underflow; no exponential at all).  Between sub-blocks I > J the decay is
// factored at the boundary b = 16 I - 1, the last step before block I:
// r^_i = r_i exp(li_{i-1} - li_b) and k^_j = k_j exp(li_b - li_j) — both
// exponents <= 0 — and A's block row I left of the diagonal is the plain
// product r^ k^T.
//
// Products on the tensor cores: (r * exp(li_prev)) S_n, A v, k~^T v and
// r^ k^T run as mma.sync m16n8k16 over bf16 fragments (mma_tile.cuh).  An
// fp32 operand enters as three exact bf16 parts (24 significant bits, as P
// does in attend_tc.cuh), and of the part products those whose parts' ranks
// sum to 3 or more (each below 2^-24 of the product) are dropped: six
// products for an fp32 x fp32 pair, three for fp32 x bf16, one for bf16 x
// bf16 (bf16 r, k, v are exact in one part).  Each k-slice's products are
// summed from zero, smallest first, and added to the running sum in IEEE
// fp32 (`mma_add`).  Against fp32 FMA: 6x / 3x the tensor-core issue of one
// bf16 product, and the splitting's integer work, for a rate 15x fp32's.
// Operands are built from fp32 shared memory by each lane (no ldmatrix).
//
// r, k, v are read in their own type and the model's (B, S, H, C) layout, w
// in fp32; y is written in r's type, the last state in fp32.  A ragged last
// chunk needs no padding: its missing steps read as w = 1, k = r = v = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kWkvC = 64;        // head size
constexpr int kWkvChunk = 32;    // steps of a chunk, L
constexpr int kWkvWarps = 8;
constexpr int kWkvThreads = kWkvWarps * 32;
constexpr int kWkvStateN = 32 / kWkvWarps;  // n-tiles of a warp's share of dS
constexpr int kWkvLD = kWkvC + 4;  // floats of a (., C) shared row
constexpr int kWkvScanUnroll = 16;

template <typename T> __device__ __forceinline__ void wkv_store2(T* p, float x, float y);
template <> __device__ __forceinline__ void wkv_store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <> __device__ __forceinline__ void wkv_store2<__nv_bfloat16>(__nv_bfloat16* p, float x,
                                                                      float y) {
  tc::store_bf16x2(p, x, y);
}
template <typename T> struct WkvParts { static constexpr int value = 3; };  // fp32 r, k, v
template <> struct WkvParts<__nv_bfloat16> { static constexpr int value = 1; };

// ---------------------------------------------------------------------------
// Warp-level products of fp32 operands held in shared memory
// ---------------------------------------------------------------------------

// The NP bf16 parts of (x, y), each packed as one operand register (x low).
template <int NP>
__device__ __forceinline__ void split_pair(uint32_t (&out)[NP], float x, float y) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const uint32_t xb = __float_as_uint(x) & 0xffff0000u;
    const uint32_t yb = __float_as_uint(y) & 0xffff0000u;
    out[j] = __byte_perm(xb, yb, 0x7632);
    x -= __uint_as_float(xb);
    y -= __uint_as_float(yb);
  }
}

// acc (16 x 8 NN, this lane's fragments) += A (16 x K) B (K x 8 NN), with
// A(m, k) = a(m0 + m, k) and B(k, n) = b(k, n0 + n) read from fp32 shared
// memory and split into PA / PB bf16 parts; K a multiple of 16.
template <int PA, int PB, int NN, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NN][4], FA a, FB b, int m0, int n0, int K,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t fa[PA][4], p[PA];
    split_pair<PA>(p, a(m0 + g, k0 + 2 * t), a(m0 + g, k0 + 2 * t + 1));
#pragma unroll
    for (int j = 0; j < PA; ++j) fa[j][0] = p[j];
    split_pair<PA>(p, a(m0 + g + 8, k0 + 2 * t), a(m0 + g + 8, k0 + 2 * t + 1));
#pragma unroll
    for (int j = 0; j < PA; ++j) fa[j][1] = p[j];
    split_pair<PA>(p, a(m0 + g, k0 + 2 * t + 8), a(m0 + g, k0 + 2 * t + 9));
#pragma unroll
    for (int j = 0; j < PA; ++j) fa[j][2] = p[j];
    split_pair<PA>(p, a(m0 + g + 8, k0 + 2 * t + 8), a(m0 + g + 8, k0 + 2 * t + 9));
#pragma unroll
    for (int j = 0; j < PA; ++j) fa[j][3] = p[j];
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      const int n = n0 + nn * 8 + g;
      uint32_t b0[PB], b1[PB];
      split_pair<PB>(b0, b(k0 + 2 * t, n), b(k0 + 2 * t + 1, n));
      split_pair<PB>(b1, b(k0 + 2 * t + 8, n), b(k0 + 2 * t + 9, n));
      // the part products of rank sum < 3, smallest first, from zero
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int rank = 2; rank >= 0; --rank)
#pragma unroll
        for (int pa = PA - 1; pa >= 0; --pa) {
          const int pb = rank - pa;
          if (pb >= 0 && pb < PB) tc::mma(s, fa[pa], b0[pb], b1[pb]);
        }
      acc[nn][0] += s[0]; acc[nn][1] += s[1]; acc[nn][2] += s[2]; acc[nn][3] += s[3];
    }
  }
}

// ---------------------------------------------------------------------------
// The chunk's inputs in shared memory
// ---------------------------------------------------------------------------

// Eight consecutive values of a step as fp32, in one or two vector loads.
struct F8 { float v[8]; };
template <typename T> __device__ __forceinline__ F8 load8(const T* p);
template <> __device__ __forceinline__ F8 load8<float>(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}
template <> __device__ __forceinline__ F8 load8<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  F8 out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out.v[2 * i] = __uint_as_float(w[i] << 16);  // the lower element
    out.v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  return out;
}

// Steps t < Ln of a chunk (at = its step 0 of (b, h)) in two halves, so
// that a block issues every load of its four inputs before it waits on one:
// `issue_chunk` loads a thread's groups of eight values into registers,
// `store_chunk` writes them to dst[t][c] as fp32, zero past Ln — with LOG,
// log max(w, 1e-30), zero past Ln as w = 1 would give, and, where `decay`
// is given, max(w, 1e-30) there (1 past Ln).
template <int L>
struct ChunkRegs {
  static constexpr int G8 = kWkvC / 8;              // groups of 8 values a step
  static constexpr int PER = L * G8 / kWkvThreads;  // groups a thread
  static_assert(L * G8 % kWkvThreads == 0, "the chunk's groups are dealt evenly");
  F8 g[PER];
};
template <int L, typename T>
__device__ __forceinline__ ChunkRegs<L> issue_chunk(const T* src, int64_t at, int64_t step,
                                                    int Ln) {
  using R = ChunkRegs<L>;
  R regs;
#pragma unroll
  for (int p = 0; p < R::PER; ++p) {
    const int i = threadIdx.x + p * kWkvThreads, t = i / R::G8, c = i % R::G8 * 8;
    if (t < Ln) regs.g[p] = load8<T>(src + at + t * step + c);
  }
  return regs;
}
template <int L, bool LOG>
__device__ __forceinline__ void store_chunk(float* dst, const ChunkRegs<L>& regs, int Ln,
                                            float* decay = nullptr) {
  using R = ChunkRegs<L>;
#pragma unroll
  for (int p = 0; p < R::PER; ++p) {
    const int i = threadIdx.x + p * kWkvThreads, t = i / R::G8, c = i % R::G8 * 8;
    float x[8], wc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wc[e] = t >= Ln ? 1.f : fmaxf(regs.g[p].v[e], 1e-30f);
      x[e] = t >= Ln ? 0.f : LOG ? logf(wc[e]) : regs.g[p].v[e];
    }
    float4* d = reinterpret_cast<float4*>(dst + t * kWkvLD + c);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
    if (decay != nullptr) {
      float4* dw = reinterpret_cast<float4*>(decay + t * kWkvLD + c);
      dw[0] = make_float4(wc[0], wc[1], wc[2], wc[3]);
      dw[1] = make_float4(wc[4], wc[5], wc[6], wc[7]);
    }
  }
}

// li[t][c] = the sum of the log-decays of steps 0..t, in step order.
template <int L>
__device__ __forceinline__ void cumsum_steps(float* li) {
  if (threadIdx.x < kWkvC) {
    float run = 0.f;
    for (int t = 0; t < L; ++t) {
      run += li[t * kWkvLD + threadIdx.x];
      li[t * kWkvLD + threadIdx.x] = run;
    }
  }
}

struct WkvArgs {
  const void* r; const void* k; const void* v; const float* w; const float* u;
  const float* s0;
  void* y; float* s_last;
  float* states;  // (B, H, N, C, C): dS_n, then S_n
  float* decay;   // (B, H, N, C)
  int S, H, N;
};

// ---------------------------------------------------------------------------
// 1. each chunk's state increment and decay
// ---------------------------------------------------------------------------

template <typename T, int L>
__global__ void __launch_bounds__(kWkvThreads)
wkv6_chunk_state_kernel(WkvArgs a) {
  extern __shared__ __align__(16) float wsm[];
  float* li = wsm;                  // (L, C)
  float* kt = li + L * kWkvLD;      // (L, C): k, then k~ = k exp(li_L - li)
  float* vs = kt + L * kWkvLD;      // (L, C)
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = n * L, Ln = min(L, a.S - t0);
  const int64_t step = (int64_t)a.H * kWkvC;
  const int64_t at = ((int64_t)b * a.S + t0) * step + (int64_t)h * kWkvC;
  {
    const auto w = issue_chunk<L>(a.w, at, step, Ln);
    const auto k = issue_chunk<L>(static_cast<const T*>(a.k), at, step, Ln);
    const auto v = issue_chunk<L>(static_cast<const T*>(a.v), at, step, Ln);
    store_chunk<L, true>(li, w, Ln);
    store_chunk<L, false>(kt, k, Ln);
    store_chunk<L, false>(vs, v, Ln);
  }
  __syncthreads();
  cumsum_steps<L>(li);
  __syncthreads();
  const int64_t bhn = ((int64_t)b * a.H + h) * a.N + n;
  for (int i = threadIdx.x; i < L * kWkvC; i += kWkvThreads) {
    const int t = i / kWkvC, c = i % kWkvC;
    const float end = li[(L - 1) * kWkvLD + c];
    kt[t * kWkvLD + c] *= expf(fminf(end - li[t * kWkvLD + c], 0.f));
    if (t == 0) a.decay[bhn * kWkvC + c] = expf(end);
  }
  __syncthreads();
  // dS (C x C) = k~^T v: warp w owns rows 16 (w % 4).. and, of the columns,
  // group w / 4 of kWkvStateN n-tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kWkvStateN][4];
#pragma unroll
  for (int j = 0; j < kWkvStateN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  warp_mma<3, WkvParts<T>::value, kWkvStateN>(
      acc, [&](int i, int t) { return kt[t * kWkvLD + i]; },
      [&](int t, int j) { return vs[t * kWkvLD + j]; }, 16 * (warp % 4),
      warp / 4 * kWkvStateN * 8, L, lane);
  float* ds = a.states + bhn * kWkvC * kWkvC;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < kWkvStateN; ++j) {
    const int col = warp / 4 * kWkvStateN * 8 + j * 8 + 2 * tq, row = 16 * (warp % 4) + g;
    *reinterpret_cast<float2*>(ds + row * kWkvC + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(ds + (row + 8) * kWkvC + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. the states entering each chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
wkv6_state_scan_kernel(WkvArgs a, int64_t elems) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  constexpr int CC = kWkvC * kWkvC;
  const int64_t bh = e / CC;
  const int ij = (int)(e % CC), i = ij / kWkvC;
  float* x = a.states + bh * a.N * CC + ij;
  const float* d = a.decay + bh * a.N * kWkvC + i;
  float s = a.s0[e];
  for (int n0 = 0; n0 < a.N; n0 += kWkvScanUnroll) {
    float xs[kWkvScanUnroll], ds[kWkvScanUnroll];
#pragma unroll
    for (int u = 0; u < kWkvScanUnroll; ++u) {
      if (n0 + u < a.N) {
        xs[u] = __ldcg(x + (int64_t)(n0 + u) * CC);
        ds[u] = __ldcg(d + (int64_t)(n0 + u) * kWkvC);
      }
    }
#pragma unroll
    for (int u = 0; u < kWkvScanUnroll; ++u) {
      if (n0 + u < a.N) {
        x[(int64_t)(n0 + u) * CC] = s;
        s = __fadd_rn(__fmul_rn(ds[u], s), xs[u]);  // the plain version's two roundings
      }
    }
  }
  a.s_last[e] = s;
}

// ---------------------------------------------------------------------------
// 3. each chunk's output
// ---------------------------------------------------------------------------

template <int L>
struct WkvOutSmem {
  static constexpr int LDA = L + 4;
  static constexpr int LI = 0, R = LI + L * kWkvLD, K = R + L * kWkvLD, V = K + L * kWkvLD,
                       ST = V + L * kWkvLD, A = ST + kWkvC * kWkvLD, RH = A + L * LDA,
                       KH = RH + 16 * kWkvLD, FLOATS = KH + (L - 16) * kWkvLD;
  static constexpr size_t bytes = (size_t)FLOATS * sizeof(float);
};

template <typename T, int L>
__global__ void __launch_bounds__(kWkvThreads)
wkv6_chunk_out_kernel(WkvArgs a) {
  using Sm = WkvOutSmem<L>;
  constexpr int LDA = Sm::LDA;
  extern __shared__ __align__(16) float wsm[];
  float* li = wsm + Sm::LI;  // (L, C) cumsum of the log-decays
  float* rs = wsm + Sm::R;   // (L, C) r, then r * exp(li_prev)
  float* ks = wsm + Sm::K;
  float* vs = wsm + Sm::V;
  float* st = wsm + Sm::ST;  // (C, C) the state entering the chunk
  float* am = wsm + Sm::A;   // (L, L) the intra-chunk matrix
  float* rh = wsm + Sm::RH;  // (16, C) r^ of one sub-block row
  float* kh = wsm + Sm::KH;  // (16 I, C) k^ left of it
  float* wc = rh;            // (L, C) max(w, 1e-30), until r^ and k^ take its place
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = n * L, Ln = min(L, a.S - t0);
  const int64_t step = (int64_t)a.H * kWkvC;
  const int64_t at = ((int64_t)b * a.S + t0) * step + (int64_t)h * kWkvC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {  // the entering state (four float4 a thread) and the chunk, all in flight
    constexpr int PER = kWkvC * kWkvC / 4 / kWkvThreads;
    const float4* src = reinterpret_cast<const float4*>(
        a.states + (((int64_t)b * a.H + h) * a.N + n) * kWkvC * kWkvC);
    float4 buf[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) buf[p] = __ldcg(src + threadIdx.x + p * kWkvThreads);
    const auto w = issue_chunk<L>(a.w, at, step, Ln);
    const auto r = issue_chunk<L>(static_cast<const T*>(a.r), at, step, Ln);
    const auto k = issue_chunk<L>(static_cast<const T*>(a.k), at, step, Ln);
    const auto v = issue_chunk<L>(static_cast<const T*>(a.v), at, step, Ln);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * kWkvThreads;
      *reinterpret_cast<float4*>(st + i / (kWkvC / 4) * kWkvLD + i % (kWkvC / 4) * 4) = buf[p];
    }
    store_chunk<L, true>(li, w, Ln, wc);
    store_chunk<L, false>(rs, r, Ln);
    store_chunk<L, false>(ks, k, Ln);
    store_chunk<L, false>(vs, v, Ln);
  }
  __syncthreads();
  cumsum_steps<L>(li);
  __syncthreads();

  // A's diagonal sub-blocks: thread (j, group of 8 channels) walks the rows
  // i > j of its sub-block with the pairwise decay exp(li_{i-1} - li_j) =
  // prod_{j < m < i} max(w_m, 1e-30) as a running product in registers
  // (decays are at most 1, so it can only underflow); the 8 groups of a pair
  // are summed by shuffles in a fixed order.  Zero right of the diagonal.
  {
    const int jl = threadIdx.x % 128 / 8, c0 = threadIdx.x % 8 * 8;
    const float* u = a.u + h * kWkvC + c0;
    auto group_sum = [](float x) {
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      return x + __shfl_xor_sync(0xffffffffu, x, 4);
    };
    for (int blk = threadIdx.x / 128; blk < L / 16; blk += kWkvThreads / 128) {
      const int j = 16 * blk + jl;
      float kj[8], d[8], part = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kj[e] = ks[j * kWkvLD + c0 + e];
        d[e] = 1.f;
        part += rs[j * kWkvLD + c0 + e] * u[e] * kj[e];
      }
      part = group_sum(part);
      if (c0 == 0) am[j * LDA + j] = part;
      for (int il = 1; il < 16; ++il) {
        const int i = 16 * blk + il;
        part = 0.f;
        if (il > jl) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            part += rs[i * kWkvLD + c0 + e] * kj[e] * d[e];
            d[e] *= wc[i * kWkvLD + c0 + e];
          }
        }
        part = group_sum(part);
        if (il > jl && c0 == 0) am[i * LDA + j] = part;
      }
    }
  }
  for (int e = threadIdx.x; e < L * L; e += kWkvThreads) {
    const int i = e / L, j = e % L;
    if (j > i) am[i * LDA + j] = 0.f;
  }
  // A's block rows I >= 1 left of the diagonal: r^ k^T, factored at
  // b = 16 I - 1
  for (int I = 1; I < L / 16; ++I) {
    const int bnd = 16 * I - 1;
    __syncthreads();  // the previous block row's r^ / k^ are consumed
    for (int e = threadIdx.x; e < 16 * kWkvC; e += kWkvThreads) {
      const int i = e / kWkvC, c = e % kWkvC, row = 16 * I + i;
      rh[i * kWkvLD + c] = rs[row * kWkvLD + c] *
                           expf(fminf(li[(row - 1) * kWkvLD + c] - li[bnd * kWkvLD + c], 0.f));
    }
    for (int e = threadIdx.x; e < 16 * I * kWkvC; e += kWkvThreads) {
      const int j = e / kWkvC, c = e % kWkvC;
      kh[j * kWkvLD + c] = ks[j * kWkvLD + c] *
                           expf(fminf(li[bnd * kWkvLD + c] - li[j * kWkvLD + c], 0.f));
    }
    __syncthreads();
    // 16 x 16 I outputs: n-tiles of 8 columns dealt to the warps
    for (int nt = warp; nt < 2 * I; nt += kWkvWarps) {
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      warp_mma<3, 3, 1>(
          acc, [&](int i, int c) { return rh[i * kWkvLD + c]; },
          [&](int c, int j) { return kh[j * kWkvLD + c]; }, 0, nt * 8, kWkvC, lane);
      const int g = lane >> 2, tq = lane & 3, col = nt * 8 + 2 * tq;
      am[(16 * I + g) * LDA + col] = acc[0][0];
      am[(16 * I + g) * LDA + col + 1] = acc[0][1];
      am[(16 * I + g + 8) * LDA + col] = acc[0][2];
      am[(16 * I + g + 8) * LDA + col + 1] = acc[0][3];
    }
  }
  __syncthreads();  // A is whole; r is free to become r~
  for (int e = threadIdx.x; e < L * kWkvC; e += kWkvThreads) {
    const int t = e / kWkvC, c = e % kWkvC;
    if (t > 0) rs[t * kWkvLD + c] *= expf(li[(t - 1) * kWkvLD + c]);
  }
  __syncthreads();

  // y = r~ S_n + A v: warp w owns rows 16 (w % (L / 16)).. and, of the
  // columns, group w / (L / 16) of NN n-tiles
  constexpr int MT = L / 16, NN = 8 * MT / kWkvWarps;
  static_assert(kWkvWarps % MT == 0 && NN >= 1, "the warps tile the chunk's output");
  const int m0 = 16 * (warp % MT), n0 = warp / MT * NN * 8;
  float ys[NN][4], yi[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ys[j][e] = yi[j][e] = 0.f;
  warp_mma<3, 3, NN>(
      ys, [&](int i, int c) { return rs[i * kWkvLD + c]; },
      [&](int c, int j) { return st[c * kWkvLD + j]; }, m0, n0, kWkvC, lane);
  warp_mma<3, WkvParts<T>::value, NN>(
      yi, [&](int i, int j) { return am[i * LDA + j]; },
      [&](int j, int c) { return vs[j * kWkvLD + c]; }, m0, n0, L, lane);
  T* y = static_cast<T*>(a.y);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    const int col = n0 + j * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m0 + g + 8 * half;
      if (t < Ln)
        wkv_store2<T>(y + at + t * step + col, ys[j][2 * half] + yi[j][2 * half],
                      ys[j][2 * half + 1] + yi[j][2 * half + 1]);
    }
  }
}

template <typename T, int L>
static cudaError_t launch_wkv6(const WkvArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(a.N, a.H, B);
  const size_t state_smem = (size_t)3 * L * kWkvLD * sizeof(float);
  const size_t out_smem = WkvOutSmem<L>::bytes;
  cudaError_t err = cudaFuncSetAttribute(wkv6_chunk_state_kernel<T, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)state_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_chunk_out_kernel<T, L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out_smem);
  if (err != cudaSuccess) return err;
  wkv6_chunk_state_kernel<T, L><<<grid, kWkvThreads, state_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t elems = (int64_t)B * a.H * kWkvC * kWkvC;
  wkv6_state_scan_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(a, elems);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_chunk_out_kernel<T, L><<<grid, kWkvThreads, out_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace repro_torch

// r, k, v, y: (B, S, H, 64) of `dtype` (0 = bfloat16, 1 = float32); w:
// (B, S, H, 64) float32; u: (H, 64) float32; s0, s_last: (B, H, 64, 64)
// float32; all contiguous.  `chunk` must be the compiled-in kWkvChunk (the
// caller sizes the scratch by it); with N = ceil(S / chunk) chunks,
// `states` is fp32 scratch of B * H * N * 64 * 64
// floats and `decay` of B * H * N * 64.  Three launches on `stream`; returns
// the CUDA error code of the first that failed (0 = success).
extern "C" int repro_torch_wkv6(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* s0, void* y, void* s_last,
                                void* states, void* decay, int dtype, int B, int S, int H,
                                int chunk, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || H < 1 || chunk != kWkvChunk) return (int)cudaErrorInvalidValue;
  WkvArgs a{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
            static_cast<const float*>(s0), y, static_cast<float*>(s_last),
            static_cast<float*>(states), static_cast<float*>(decay),
            S, H, (S + chunk - 1) / chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_wkv6<__nv_bfloat16, kWkvChunk>(a, B, s);
  if (dtype == 1) return (int)launch_wkv6<float, kWkvChunk>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
