// K3 — fused flash attention backward (two passes, pruned in both directions).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// behind `flash_attention_bwd` (src/repro/kernels/flash_attention/kernel.py):
// from the forward's residuals (q, k, v, o, lse) and the output cotangent dO,
// recompute each probability tile P = exp(s - lse) under the forward's mask
// (causal, sliding window, ragged kp < T, optional softcap), form
// dS = P * (dP - delta) with dP = dO V^T and delta = rowsum(dO * O) (times
// 1 - (s/c)^2 under a softcap c), and reduce
//   dq = dS K * scale                (pass 1, per q block)
//   dv = P^T dO, dk = dS^T Q * scale (pass 2, per KV block)
// GQA maps q head h to KV head h / G; K and V are never replicated.
//
// Bound on an H100: operations — five products of 2 * D flops per live
// (q, k) pair and q head (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) against the
// bf16 tensor-core peak; the bytes (q, k, v, o, dO, lse in, dq, dk, dv out)
// are far below that line at training lengths.
//
// Design (simple and right first; tensor cores are later work):
//  - Pass 1, dq: grid (q blocks, H, B), one block per 64 q rows of one head.
//    It computes delta for its rows from dO and O (fused: no separate
//    reduction launch), writes it for pass 2, and walks exactly the KV blocks
//    [kv_lo, kv_hi) the forward walked, accumulating dq in fp32 registers.
//  - Pass 2, dk / dv: grid (KV blocks, K, B), one block per 32 KV rows of one
//    KV head.  It loops the G q heads of its group and, for each, the
//    reachable q blocks [q_lo, q_hi) of the transposed schedule, keeping dk
//    and dv in fp32 registers across the whole group, and writes them once,
//    group-summed, in k's type.  No atomics: every output element has one
//    writer, so the result is the same from run to run.
//  - All products are fp32 FMAs over fp32 tiles in shared memory, rows padded
//    by one float (conflict-free strided reads), as in attend_core.cuh.
//    Shared memory sets the tiles: at D = 256 pass 1 holds q, dO (64 rows),
//    K, V (32 rows) and the dS tile, 202 KB; pass 2 holds K, V (32 rows),
//    q, dO (64 rows) and the P and dS tiles, 210 KB — under the 227 KB a
//    block may have, one block per SM.
//  - Pass 2's grid is small at MQA shapes (gemma-2b's microbatch: B K T/32 =
//    64 blocks on 132 SMs), and its first KV block walks every q block of all
//    G heads: that block is the critical path.  Splitting the group or the
//    q walk across blocks needs a second reduction pass; it is later work.
#include "attend_core.cuh"

namespace repro_torch {

constexpr int kBwdTX = 16;      // threads along a score tile's columns
constexpr int kDqRows = 64;     // pass 1: q rows per block
constexpr int kDqMR = 4;        //         rows per thread
constexpr int kDqKV = 32;       //         KV rows per tile
constexpr int kDkvRows = 32;    // pass 2: KV rows per block
constexpr int kDkvMR = 2;       //         rows per thread
constexpr int kDkvQ = 64;       //         q rows per tile
constexpr int kBwdThreads = 256;
static_assert(kBwdTX * kDqRows / kDqMR == kBwdThreads, "pass 1 thread count");
static_assert(kBwdTX * kDkvRows / kDkvMR == kBwdThreads, "pass 2 thread count");

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S), written by pass 1, read by pass 2
  void* dq; void* dk; void* dv;
  int S, T, H, G, D;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_st, dk_sh;  // dk and dv share one layout
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
  int block_q, block_kv, pruned;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The forward's mask for the pair (qp, kp), both inside their sequences.
__device__ __forceinline__ bool pair_live(const BwdArgs& a, int qp, int kp) {
  if (!a.causal) return true;
  return kp <= qp && (a.window <= 0 || kp > qp - a.window);
}

// P and dS of one (q, k) pair from its raw score q.k and dO.v.
__device__ __forceinline__ void p_ds(const BwdArgs& a, bool live, float qk, float dov,
                                     float lse, float delta, float& p, float& ds) {
  float s = qk * a.scale;
  if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
  p = live ? expf(s - lse) : 0.f;
  ds = p * (dov - delta);
  if (a.softcap > 0.f) {
    const float t = s / a.softcap;
    ds *= 1.f - t * t;
  }
}

inline size_t dq_smem_bytes(int D) {
  return ((size_t)2 * kDqRows * (D + 1) + (size_t)2 * kDqKV * (D + 1)
          + (size_t)kDqRows * (kDqKV + 1) + 2 * (size_t)kDqRows) * sizeof(float);
}

inline size_t dkv_smem_bytes(int D) {
  return ((size_t)2 * kDkvRows * (D + 1) + (size_t)2 * kDkvQ * (D + 1)
          + (size_t)2 * kDkvRows * (kDkvQ + 1) + 2 * (size_t)kDkvQ) * sizeof(float);
}

// ---------------------------------------------------------------------------
// Pass 1: dq (and delta) for one q block of one head
// ---------------------------------------------------------------------------
template <typename T, int DC>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int RT = kDqRows, MR = kDqMR, BK = kDqKV, MC = BK / kBwdTX;
  constexpr int NT = kBwdThreads, NW = NT / 32;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.G;
  const int D = a.D, bq = a.block_q, bkv = a.block_kv;
  const int nk = (a.T + bkv - 1) / bkv;
  const int q_start = iq * bq;
  const int nrows = min(bq, a.S - q_start);
  const int tid = threadIdx.x, tx = tid % kBwdTX, ty = tid / kBwdTX;
  const int lane = tid % 32, warp = tid / 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + RT * (D + 1);
  float* ks = dos + RT * (D + 1);
  float* vs = ks + BK * (D + 1);
  float* dss = vs + BK * (D + 1);
  float* lse_s = dss + RT * (BK + 1);
  float* delta_s = lse_s + RT;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + (int64_t)q_start * a.q_ss;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh
                  + (int64_t)q_start * a.do_ss;
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh + (int64_t)q_start * a.o_ss;
  const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const int64_t stat = ((int64_t)b * a.H + h) * a.S + q_start;  // (B, H, S) row

  load_tile<T, NT>(qs, q, a.q_ss, RT, 0, nrows, D, 1.f);
  load_tile<T, NT>(dos, dout, a.do_ss, RT, 0, nrows, D, 1.f);
  __syncthreads();

  // delta = rowsum(dO * O), one warp per row; padded rows see nothing
  for (int r = warp; r < RT; r += NW) {
    float sum = 0.f;
    if (r < nrows) {
      const T* orow = o + (int64_t)r * a.o_ss;
      for (int d = lane; d < D; d += 32) sum = fmaf(dos[r * (D + 1) + d], to_float(orow[d]), sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      delta_s[r] = sum;
      lse_s[r] = r < nrows ? a.lse[stat + r] : 0.f;
      if (r < nrows) a.delta[stat + r] = sum;
    }
  }

  int lo = 0, hi = nk;
  if (a.causal) {
    if (a.window > 0) lo = max(0, (q_start - (a.window - 1)) / bkv);
    hi = min(nk, (q_start + bq - 1) / bkv + 1);
  }
  const bool pruned = a.pruned && a.causal;
  const int walk_begin = pruned ? lo : 0, walk_end = pruned ? hi : nk;

  float acc[MR][DC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int jb = walk_begin; jb < walk_end; ++jb) {
    const int k_start = jb * bkv;
    const int krows = min(bkv, a.T - k_start);
    load_tile<T, NT>(ks, kbase + (int64_t)k_start * a.k_st, a.k_st, BK, 0, krows, D, 1.f);
    load_tile<T, NT>(vs, vbase + (int64_t)k_start * a.v_st, a.v_st, BK, 0, krows, D, 1.f);
    __syncthreads();
    if (jb >= lo && jb < hi) {
      float s[MR][MC], dp[MR][MC];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) s[i][j] = dp[i][j] = 0.f;
      const float* qrow = qs + (ty * MR) * (D + 1);
      const float* drow = dos + (ty * MR) * (D + 1);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[MR], ov[MR], kv[MC], vv[MC];
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          qv[i] = qrow[i * (D + 1) + d];
          ov[i] = drow[i * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          kv[j] = ks[(tx + kBwdTX * j) * (D + 1) + d];
          vv[j] = vs[(tx + kBwdTX * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < MC; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int r = ty * MR + i;
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          const int col = tx + kBwdTX * j;
          const bool live = r < nrows && col < krows && pair_live(a, q_start + r, k_start + col);
          float p, ds;
          p_ds(a, live, s[i][j], dp[i][j], lse_s[r], delta_s[r], p, ds);
          dss[r * (BK + 1) + col] = ds;
        }
      }
      __syncthreads();
      // dq += dS K
      const float* dsrow = dss + (ty * MR) * (BK + 1);
      for (int j = 0; j < krows; ++j) {
        float dv_[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i) dv_[i] = dsrow[i * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = tx + kBwdTX * c;
          if (col < D) {
            const float kv = ks[j * (D + 1) + col];
#pragma unroll
            for (int i = 0; i < MR; ++i) acc[i][c] = fmaf(dv_[i], kv, acc[i][c]);
          }
        }
      }
    }
    __syncthreads();  // the next block overwrites the tiles
  }

  T* dq = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh + (int64_t)q_start * a.dq_ss;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ty * MR + i;
    if (r < nrows) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + kBwdTX * c;
        if (col < D) dq[(int64_t)r * a.dq_ss + col] = Vec<T>::from_float(acc[i][c] * a.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: dk and dv for one KV block of one KV head, its whole group summed
// ---------------------------------------------------------------------------
template <typename T, int DC>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int RT = kDkvRows, MR = kDkvMR, BQ = kDkvQ, MC = BQ / kBwdTX;
  constexpr int NT = kBwdThreads;
  const int ik = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int D = a.D, bq = a.block_q, bkv = a.block_kv;
  const int nq = (a.S + bq - 1) / bq;
  const int k_start = ik * bkv;
  const int nrows = min(bkv, a.T - k_start);
  const int tid = threadIdx.x, tx = tid % kBwdTX, ty = tid / kBwdTX;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + RT * (D + 1);
  float* qs = vs + RT * (D + 1);
  float* dos = qs + BQ * (D + 1);
  float* ps = dos + BQ * (D + 1);
  float* dss = ps + RT * (BQ + 1);
  float* lse_s = dss + RT * (BQ + 1);
  float* delta_s = lse_s + BQ;

  load_tile<T, NT>(ks, static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh
                   + (int64_t)k_start * a.k_st, a.k_st, RT, 0, nrows, D, 1.f);
  load_tile<T, NT>(vs, static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh
                   + (int64_t)k_start * a.v_st, a.v_st, RT, 0, nrows, D, 1.f);

  // the transposed walk: q blocks that can see this KV block
  int lo = 0, hi = nq;
  if (a.causal) {
    lo = min(k_start / bq, nq - 1);
    if (a.window > 0) {
      const int k1 = min(k_start + bkv, a.T) - 1;
      hi = max(1, min(nq, (k1 + a.window - 1) / bq + 1));
    }
  }
  const bool pruned = a.pruned && a.causal;
  const int walk_begin = pruned ? lo : 0, walk_end = pruned ? hi : nq;

  float dk[MR][DC], dv[MR][DC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kh * a.G + g;
    const T* qh = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* doh = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const int64_t stat = ((int64_t)b * a.H + h) * a.S;
    for (int iq = walk_begin; iq < walk_end; ++iq) {
      const int q_start = iq * bq;
      const int qrows = min(bq, a.S - q_start);
      load_tile<T, NT>(qs, qh + (int64_t)q_start * a.q_ss, a.q_ss, BQ, 0, qrows, D, 1.f);
      load_tile<T, NT>(dos, doh + (int64_t)q_start * a.do_ss, a.do_ss, BQ, 0, qrows, D, 1.f);
      for (int r = tid; r < BQ; r += NT) {
        lse_s[r] = r < qrows ? a.lse[stat + q_start + r] : 0.f;
        delta_s[r] = r < qrows ? a.delta[stat + q_start + r] : 0.f;
      }
      __syncthreads();
      if (iq >= lo && iq < hi) {
        float s[MR][MC], dp[MR][MC];
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < MC; ++j) s[i][j] = dp[i][j] = 0.f;
        const float* krow = ks + (ty * MR) * (D + 1);
        const float* vrow = vs + (ty * MR) * (D + 1);
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float kv[MR], vv[MR], qv[MC], ov[MC];
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            kv[i] = krow[i * (D + 1) + d];
            vv[i] = vrow[i * (D + 1) + d];
          }
#pragma unroll
          for (int j = 0; j < MC; ++j) {
            qv[j] = qs[(tx + kBwdTX * j) * (D + 1) + d];
            ov[j] = dos[(tx + kBwdTX * j) * (D + 1) + d];
          }
#pragma unroll
          for (int i = 0; i < MR; ++i)
#pragma unroll
            for (int j = 0; j < MC; ++j) {
              s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
              dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const int c = ty * MR + i;
#pragma unroll
          for (int j = 0; j < MC; ++j) {
            const int r = tx + kBwdTX * j;
            const bool live = c < nrows && r < qrows && pair_live(a, q_start + r, k_start + c);
            float p, ds;
            p_ds(a, live, s[i][j], dp[i][j], lse_s[r], delta_s[r], p, ds);
            ps[c * (BQ + 1) + r] = p;
            dss[c * (BQ + 1) + r] = ds;
          }
        }
        __syncthreads();
        // dv += P^T dO, dk += dS^T Q
        const float* prow = ps + (ty * MR) * (BQ + 1);
        const float* dsrow = dss + (ty * MR) * (BQ + 1);
        for (int r = 0; r < qrows; ++r) {
          float pv[MR], dsv[MR];
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            pv[i] = prow[i * (BQ + 1) + r];
            dsv[i] = dsrow[i * (BQ + 1) + r];
          }
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const int col = tx + kBwdTX * c;
            if (col < D) {
              const float ov = dos[r * (D + 1) + col];
              const float qv = qs[r * (D + 1) + col];
#pragma unroll
              for (int i = 0; i < MR; ++i) {
                dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
                dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
              }
            }
          }
        }
      }
      __syncthreads();  // the next q block overwrites the tiles
    }
  }

  T* dk_out = static_cast<T*>(a.dk) + b * a.dk_sb + kh * a.dk_sh + (int64_t)k_start * a.dk_st;
  T* dv_out = static_cast<T*>(a.dv) + b * a.dk_sb + kh * a.dk_sh + (int64_t)k_start * a.dk_st;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int c = ty * MR + i;
    if (c < nrows) {
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int col = tx + kBwdTX * cc;
        if (col < D) {
          dk_out[(int64_t)c * a.dk_st + col] = Vec<T>::from_float(dk[i][cc] * a.scale);
          dv_out[(int64_t)c * a.dk_st + col] = Vec<T>::from_float(dv[i][cc]);
        }
      }
    }
  }
}

template <typename T, int DC>
static cudaError_t launch_bwd_dc(const BwdArgs& a, int B, int K, int passes,
                                 cudaStream_t stream) {
  const int nq = (a.S + a.block_q - 1) / a.block_q;
  const int nk = (a.T + a.block_kv - 1) / a.block_kv;
  if (passes & 1) {
    cudaError_t err = launch_with_smem(flash_bwd_dq_kernel<T, DC>, dim3(nq, a.H, B),
                                       dim3(kBwdThreads), dq_smem_bytes(a.D), stream, a);
    if (err != cudaSuccess) return err;
  }
  if (passes & 2)
    return launch_with_smem(flash_bwd_dkv_kernel<T, DC>, dim3(nk, K, B), dim3(kBwdThreads),
                            dkv_smem_bytes(a.D), stream, a);
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_bwd(const BwdArgs& a, int B, int K, int passes,
                              cudaStream_t stream) {
  if (a.D <= 64) return launch_bwd_dc<T, 4>(a, B, K, passes, stream);
  if (a.D <= 128) return launch_bwd_dc<T, 8>(a, B, K, passes, stream);
  return launch_bwd_dc<T, 16>(a, B, K, passes, stream);
}

}  // namespace repro_torch

// dtype of every operand but lse / delta: 0 = bfloat16, 1 = float32.  q, o,
// dout, dq are (B, S, H, D), k, v, dk, dv (B, T, K, D), addressed through
// strides in elements (dk and dv share theirs); lse and delta are contiguous
// (B, H, S) fp32, delta written by pass 1.  `passes`: 3 launches pass 1 then
// pass 2 on `stream` (the training path); 1 or 2 launches one of them alone
// (pass 2 reading the delta of an earlier pass 1), for timing each.
// Returns the first CUDA error (0 = success).
extern "C" int repro_torch_flash_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int S, int T, int H, int K, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_st, long long dk_sh,
    int causal, int window, float softcap, float scale,
    int block_q, int block_kv, int pruned, int passes, void* stream) {
  using namespace repro_torch;
  if (passes < 1 || passes > 3 ||
      D > 256 || D % 8 != 0 || H % K != 0 || block_q < 1 || block_q > kDqRows ||
      block_q > kDkvQ || block_kv < 1 || block_kv > kDqKV || block_kv > kDkvRows ||
      S < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, S, T, H, H / K, D,
            q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
            do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_st, dk_sh,
            causal, window, softcap, scale, block_q, block_kv, pruned};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bwd<__nv_bfloat16>(a, B, K, passes, s);
  if (dtype == 1) return (int)launch_bwd<float>(a, B, K, passes, s);
  return (int)cudaErrorInvalidValue;
}
