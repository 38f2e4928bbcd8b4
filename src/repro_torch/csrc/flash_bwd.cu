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
// Two routes, chosen by the type before any launch:
//  - bf16: the tensor-core route.  Every product is a warp-level mma.sync
//    m16n8k16 on swizzled bf16 tiles (mma_tile.cuh), tiles stream through
//    two-stage cp.async rings, and P / dS go from one product into the next
//    as register fragments, each the three exact bf16 parts of its fp32
//    value, every product summed apart and added in IEEE fp32 — fp32's
//    accuracy, as in K1 (flash_prefill.cu says why).
//    Pass 1, dq (flash_bwd_dq_tc_kernel): grid (q blocks, H, B), 64 q rows
//    per block (4 warps of 16), the last q block first.  It computes delta
//    for its rows (fused: no separate reduction launch) and writes it for
//    pass 2, then walks exactly the forward's KV interval [kv_lo, kv_hi) in
//    64-row K / V tiles: S = Q K^T and dP = dO V^T in registers, 32 KV
//    columns at a time, P and dS formed on the fragments by the plain
//    version's own formula, dS repacked as the A operand of dQ += dS K (K
//    through ldmatrix.trans).  At D = 256 a second set of four warps takes
//    the upper 128 columns of dq (recomputing the same S / dP rows), so a
//    thread holds 64 dq sums and nothing spills.
//    Pass 2, dk / dv (flash_bwd_dkv_tc_kernel), computed transposed: S^T =
//    K Q^T and dP^T = V dO^T with the block's 64 KV rows as the mma's M, so
//    P^T and dS^T are register A fragments of dV += P^T dO and dK += dS^T Q
//    (dO and Q through ldmatrix.trans), 16 q columns at a time.  Four warps
//    take 16 KV rows each; at D = 256 a second set of four takes the upper
//    128 columns of the sums (recomputing the same S^T / dP^T rows), so a
//    thread holds at most 128 fp32 sums.  The block walks [q_lo, q_hi) from
//    its last q block back to the diagonal, every q head of its share of the
//    group at each step, with a cp.async ring of Q, dO, lse and delta tiles:
//    a KV row's causal probabilities grow towards the diagonal, so the fp32
//    sums take their small terms first.  The group is split across
//    `n_split` blocks (grid (KV blocks, K n_split, B), KV block 0 — the
//    longest causal walk — first) so that MQA shapes fill the card; with
//    n_split > 1 every block writes fp32 partial sums to a
//    (2, n_split, B, T, K, D) scratch and a third launch
//    (flash_bwd_dkv_reduce_kernel) adds them in split order and rounds once
//    to k's type.  No atomics: the result is the same bit for bit from run
//    to run.
//  - fp32: the FMA route (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): fp32
//    FMAs over fp32 tiles in shared memory, rows padded by one float; pass 2
//    one block per (32 KV rows, KV head) looping the whole group.  The
//    tensor cores' TF32 would not hold fp32's accuracy.
#include "attend_core.cuh"
#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kBwdTX = 16;      // FMA route: threads along a score tile's columns
constexpr int kDqRows = 64;     // pass 1: q rows per block
constexpr int kDqMR = 4;        //         rows per thread
constexpr int kDqKV = 32;       //         KV rows per tile
constexpr int kDkvRows = 32;    // pass 2: KV rows per block
constexpr int kDkvMR = 2;       //         rows per thread
constexpr int kDkvQ = 64;       //         q rows per tile
constexpr int kBwdThreads = 256;
static_assert(kBwdTX * kDqRows / kDqMR == kBwdThreads, "pass 1 thread count");
static_assert(kBwdTX * kDkvRows / kDkvMR == kBwdThreads, "pass 2 thread count");
constexpr int kTcBwdQ = 64;     // tensor-core route: q rows per pass-1 block / pass-2 tile
constexpr int kTcBwdKV = 64;    //                    KV rows per pass-2 block / pass-1 tile
constexpr int kTcParts = 3;     //                    bf16 parts of P and dS

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S), written by pass 1, read by pass 2
  void* dq; void* dk; void* dv;
  float* partial;    // (2, n_split, B, T, K, D) fp32 dk / dv partials (n_split > 1)
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
  int n_split;         // tensor-core pass 2: blocks per KV head's group
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

// ---------------------------------------------------------------------------
// Tensor-core route (bf16)
// ---------------------------------------------------------------------------

// Whether a (q block, KV block) tile holds a pair the mask removes: it
// crosses the diagonal, the window's edge, or the end of either sequence.
// Other tiles skip the per-element mask.
__device__ __forceinline__ bool tile_edge(const BwdArgs& a, int q_start, int bq, int k_start,
                                          int bkv) {
  return k_start + bkv > a.T || q_start + bq > a.S ||
         (a.causal && (k_start + bkv - 1 > q_start ||
                       (a.window > 0 && k_start <= q_start + bq - 1 - a.window)));
}

template <int DP>
struct TcDqShape {
  static constexpr int CW = DP > 128 ? 2 : 1;  // column groups of the dq sums
  static constexpr int NW = 4 * CW;            // 4 x 16 q rows per column group
  static constexpr int BQ = kTcBwdQ, BKV = kTcBwdKV;
  static constexpr int KC = 32;                // KV columns per register chunk
  static constexpr int DCOL = DP / CW;         // dq columns per warp
  static constexpr int CH = DP / 8;
  // q, dO, two stages of (K, V), lse and delta of the block's rows
  static constexpr size_t smem =
      (size_t)(2 * BQ + 4 * BKV) * DP * sizeof(__nv_bfloat16) + 2 * BQ * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(TcDqShape<DP>::NW * 32)
flash_bwd_dq_tc_kernel(BwdArgs a) {
  using namespace tc;
  using Sh = TcDqShape<DP>;
  constexpr int NW = Sh::NW, BQ = Sh::BQ, BKV = Sh::BKV, KC = Sh::KC, CH = Sh::CH;
  constexpr int NT = NW * 32, NDT = Sh::DCOL / 8, NKC = KC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BQ * DP;
  bf16* ring = dos + BQ * DP;  // stage s: K at ring + 2 s BKV DP, V after it
  float* lse_s = reinterpret_cast<float*>(ring + 4 * BKV * DP);
  float* delta_s = lse_s + BQ;

  // the last q block, the longest causal walk, goes first
  const int nq = gridDim.x, hb = gridDim.y * gridDim.z;
  const int64_t lin = blockIdx.x + (int64_t)nq * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  const int iq = nq - 1 - (int)(lin / hb);
  const int h = (int)(lin % hb) % a.H, b = (int)(lin % hb) / a.H;
  const int kh = h / a.G;
  const int nk = (a.T + BKV - 1) / BKV;
  const int q_start = iq * BQ;
  const int nrows = min(BQ, a.S - q_start);
  int lo = 0, hi = nk;
  if (a.causal) {
    if (a.window > 0) lo = max(0, (q_start - (a.window - 1)) / BKV);
    hi = min(nk, (q_start + BQ - 1) / BKV + 1);
  }
  const bool pruned = a.pruned && a.causal;
  const int walk_begin = pruned ? lo : 0, walk_end = pruned ? hi : nk;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh
                  + (int64_t)q_start * a.q_ss;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh
                     + (int64_t)q_start * a.do_ss;
  const bf16* o = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh
                  + (int64_t)q_start * a.o_ss;
  const bf16* kbase = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const int64_t stat = ((int64_t)b * a.H + h) * a.S + q_start;  // (B, H, S) row

  load_tile_async<BQ, CH, NT>(qs, q, a.q_ss, nrows, a.D);
  load_tile_async<BQ, CH, NT>(dos, dout, a.do_ss, nrows, a.D);
  cp_async_commit();
  auto load_kv = [&](int jb, int stage) {
    const int k0 = jb * BKV;
    bf16* ks = ring + stage * 2 * BKV * DP;
    load_tile_async<BKV, CH, NT>(ks, kbase + (int64_t)k0 * a.k_st, a.k_st, a.T - k0, a.D);
    load_tile_async<BKV, CH, NT>(ks + BKV * DP, vbase + (int64_t)k0 * a.v_st, a.v_st,
                                 a.T - k0, a.D);
    cp_async_commit();
  };
  if (walk_begin < walk_end) {
    load_kv(walk_begin, 0);
    cp_async_wait<1>();  // q and dO have landed
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // delta = rowsum(dO * O), one warp per row; padded rows see nothing
  for (int r = warp; r < BQ; r += NW) {
    float sum = 0.f;
    if (r < nrows) {
      const bf16* orow = o + (int64_t)r * a.o_ss;
      for (int d = lane; d < a.D; d += 32)
        sum = fmaf(__bfloat162float(dos[swz<CH>(r, d >> 3) + (d & 7)]),
                   __bfloat162float(orow[d]), sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      delta_s[r] = sum;
      lse_s[r] = r < nrows ? a.lse[stat + r] : 0.f;
      if (r < nrows) a.delta[stat + r] = sum;
    }
  }
  __syncthreads();
  const int rg = warp % 4, cg = warp / 4;  // 16 q rows, DCOL columns of dq
  float row_lse[2], row_delta[2];
  int row_qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg * 16 + g + 8 * i;
    row_lse[i] = lse_s[r];
    row_delta[i] = delta_s[r];
    row_qp[i] = q_start + r;
  }

  float dq[NDT][4];
#pragma unroll
  for (int d = 0; d < NDT; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int jb = walk_begin, it = 0; jb < walk_end; ++jb, ++it) {
    if (jb + 1 < walk_end) {
      load_kv(jb + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (jb >= lo && jb < hi) {
      const bf16* ks = ring + (it & 1) * 2 * BKV * DP;
      const bf16* vs = ks + BKV * DP;
      const int k_start = jb * BKV;
      const bool edge = tile_edge(a, q_start, BQ, k_start, BKV);
#pragma unroll 1
      for (int kc = 0; kc < BKV; kc += KC) {
        // S = Q K^T and dP = dO V^T over KC KV columns, 16 rows per warp
        float s[NKC][4], dp[NKC][4];
#pragma unroll
        for (int n = 0; n < NKC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; c += 2) {
          uint32_t qa[4], da[4];
          load_a<CH>(qa, qs, rg * 16, c, lane);
          load_a<CH>(da, dos, rg * 16, c, lane);
#pragma unroll
          for (int n = 0; n < NKC; n += 2) {
            uint32_t kf[4], vf[4];
            load_b_nk<CH>(kf, ks, kc + n * 8, c, lane);
            load_b_nk<CH>(vf, vs, kc + n * 8, c, lane);
            mma_add(s[n], qa, kf[0], kf[1]);
            mma_add(s[n + 1], qa, kf[2], kf[3]);
            mma_add(dp[n], da, vf[0], vf[1]);
            mma_add(dp[n + 1], da, vf[2], vf[3]);
          }
        }
        // dS on the fragments (into s)
#pragma unroll
        for (int n = 0; n < NKC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int kp = k_start + kc + n * 8 + 2 * t + (e & 1);
            const bool live = !edge || (kp < a.T && row_qp[i] < a.S &&
                                        pair_live(a, row_qp[i], kp));
            float p, ds;
            p_ds(a, live, s[n][e], dp[n][e], row_lse[i], row_delta[i], p, ds);
            s[n][e] = ds;
          }
        // dQ += dS K, dS split into three bf16 fragments
#pragma unroll
        for (int kt = 0; kt < KC / 16; ++kt) {
          uint32_t dsa[kTcParts][4];
          c_to_a_parts<kTcParts>(dsa, s[2 * kt], s[2 * kt + 1]);
#pragma unroll
          for (int d = 0; d < NDT; d += 2) {
            uint32_t kf[4];
            load_b_kn<CH>(kf, ks, kc + kt * 16, cg * NDT + d, lane);
            mma_parts_add<kTcParts>(dq[d], dsa, kf[0], kf[1]);
            mma_parts_add<kTcParts>(dq[d + 1], dsa, kf[2], kf[3]);
          }
        }
      }
    }
    __syncthreads();  // the next copy overwrites this stage
  }
  cp_async_wait<0>();

  bf16* dq_out = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh
                 + (int64_t)q_start * a.dq_ss;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg * 16 + g + 8 * i;
    if (r < nrows) {
#pragma unroll
      for (int d = 0; d < NDT; ++d) {
        const int col = cg * Sh::DCOL + d * 8 + 2 * t;
        if (col < a.D)
          store_bf16x2(dq_out + (int64_t)r * a.dq_ss + col, dq[d][2 * i] * a.scale,
                       dq[d][2 * i + 1] * a.scale);
      }
    }
  }
}

template <int DP>
struct TcDkvShape {
  static constexpr int CW = DP > 128 ? 2 : 1;  // column groups of the dk / dv sums
  static constexpr int NW = 4 * CW;            // 4 x 16 KV rows per column group
  static constexpr int BKV = kTcBwdKV, BQ = kTcBwdQ;
  static constexpr int QC = 16;                // q columns of S^T per register chunk
  static constexpr int DCOL = DP / CW;         // dk / dv columns per warp
  static constexpr int CH = DP / 8;
  // K, V, two stages of (Q, dO) and of (lse, delta)
  static constexpr size_t smem =
      (size_t)(2 * BKV + 4 * BQ) * DP * sizeof(__nv_bfloat16) + 4 * BQ * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(TcDkvShape<DP>::NW * 32)
flash_bwd_dkv_tc_kernel(BwdArgs a) {
  using namespace tc;
  using Sh = TcDkvShape<DP>;
  constexpr int NW = Sh::NW, BQ = Sh::BQ, BKV = Sh::BKV, QC = Sh::QC, CH = Sh::CH;
  constexpr int NT = NW * 32, NDT = Sh::DCOL / 8, NQC = QC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BKV * DP;
  bf16* ring = vs + BKV * DP;  // stage s: Q at ring + 2 s BQ DP, dO after it
  float* stats = reinterpret_cast<float*>(ring + 4 * BQ * DP);  // stage s: lse, delta

  // KV block 0, the longest causal walk, goes first: ik varies slowest
  const int nk = gridDim.x, per = gridDim.y * gridDim.z;
  const int64_t lin = blockIdx.x + (int64_t)nk * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  const int ik = (int)(lin / per);
  const int ksplit = (int)(lin % per) % gridDim.y, b = (int)(lin % per) / gridDim.y;
  const int ns = a.n_split, kh = ksplit / ns, sp = ksplit % ns;
  const int B = gridDim.z, K = gridDim.y / ns;
  const int heads = a.G / ns, h_begin = kh * a.G + sp * heads;
  const int nq = (a.S + BQ - 1) / BQ;
  const int k_start = ik * BKV;
  const int nrows = min(BKV, a.T - k_start);

  // the transposed walk: q blocks that can see this KV block
  int lo = 0, hi = nq;
  if (a.causal) {
    lo = min(k_start / BQ, nq - 1);
    if (a.window > 0) {
      const int k1 = min(k_start + BKV, a.T) - 1;
      hi = max(1, min(nq, (k1 + a.window - 1) / BQ + 1));
    }
  }
  const bool pruned = a.pruned && a.causal;
  const int walk_begin = pruned ? lo : 0, walk_end = pruned ? hi : nq;
  const int nwalk = walk_end - walk_begin, items = heads * nwalk;

  load_tile_async<BKV, CH, NT>(ks, static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh
                               + (int64_t)k_start * a.k_st, a.k_st, nrows, a.D);
  load_tile_async<BKV, CH, NT>(vs, static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh
                               + (int64_t)k_start * a.v_st, a.v_st, nrows, a.D);
  cp_async_commit();
  // item i: q block walk_end - 1 - i / heads, q head h_begin + i % heads.  The
  // walk runs from the last q block back to the diagonal, every head of the
  // share at each step: under a causal mask a KV row's probabilities grow
  // towards the diagonal, so the fp32 sums take their small terms while
  // they are small themselves.
  auto load_item = [&](int i, int stage) {
    const int h = h_begin + i % heads;
    const int q_start = (walk_end - 1 - i / heads) * BQ;
    const int qrows = a.S - q_start;
    bf16* qs = ring + stage * 2 * BQ * DP;
    load_tile_async<BQ, CH, NT>(qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh
                                + (int64_t)q_start * a.q_ss, a.q_ss, qrows, a.D);
    load_tile_async<BQ, CH, NT>(qs + BQ * DP, static_cast<const bf16*>(a.dout) + b * a.do_sb
                                + h * a.do_sh + (int64_t)q_start * a.do_ss, a.do_ss, qrows,
                                a.D);
    const int64_t stat = ((int64_t)b * a.H + h) * a.S + q_start;
    float* st = stats + stage * 2 * BQ;
    for (int j = threadIdx.x; j < 2 * BQ; j += NT) {
      const int r = j % BQ;
      const bool ok = r < qrows;
      const float* src = (j < BQ ? a.lse : a.delta) + stat + r;
      cp_async4(st + j, ok ? src : a.lse, ok);
    }
    cp_async_commit();
  };
  if (items > 0) load_item(0, 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % 4, cg = warp / 4;  // 16 KV rows, DCOL columns
  int row_kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row_kp[i] = k_start + rg * 16 + g + 8 * i;
  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int d = 0; d < NDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) {
      load_item(i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int iq = walk_end - 1 - i / heads;
    if (iq >= lo && iq < hi) {
      const bf16* qs = ring + (i & 1) * 2 * BQ * DP;
      const bf16* dos = qs + BQ * DP;
      const float* lse_s = stats + (i & 1) * 2 * BQ;
      const float* delta_s = lse_s + BQ;
      const int q_start = iq * BQ;
      const bool edge = tile_edge(a, q_start, BQ, k_start, BKV);
#pragma unroll 1
      for (int qc = 0; qc < BQ; qc += QC) {
        // S^T = K Q^T and dP^T = V dO^T over QC q columns, 16 KV rows per warp
        float st[NQC][4], dpt[NQC][4];
#pragma unroll
        for (int n = 0; n < NQC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; c += 2) {
          uint32_t ka[4], va[4];
          load_a<CH>(ka, ks, rg * 16, c, lane);
          load_a<CH>(va, vs, rg * 16, c, lane);
#pragma unroll
          for (int n = 0; n < NQC; n += 2) {
            uint32_t qf[4], of[4];
            load_b_nk<CH>(qf, qs, qc + n * 8, c, lane);
            load_b_nk<CH>(of, dos, qc + n * 8, c, lane);
            mma_add(st[n], ka, qf[0], qf[1]);
            mma_add(st[n + 1], ka, qf[2], qf[3]);
            mma_add(dpt[n], va, of[0], of[1]);
            mma_add(dpt[n + 1], va, of[2], of[3]);
          }
        }
        // P^T (into st) and dS^T (into dpt) on the fragments
#pragma unroll
        for (int n = 0; n < NQC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = qc + n * 8 + 2 * t + (e & 1);
            const int qp = q_start + col, kp = row_kp[e >> 1];
            const bool live = !edge || (kp < a.T && qp < a.S && pair_live(a, qp, kp));
            float p, ds;
            p_ds(a, live, st[n][e], dpt[n][e], lse_s[col], delta_s[col], p, ds);
            st[n][e] = p;
            dpt[n][e] = ds;
          }
        // dV += P^T dO, dK += dS^T Q over this warp's columns, P^T and dS^T
        // split into three bf16 fragments
#pragma unroll
        for (int kt = 0; kt < QC / 16; ++kt) {
          uint32_t pa[kTcParts][4], dsa[kTcParts][4];
          c_to_a_parts<kTcParts>(pa, st[2 * kt], st[2 * kt + 1]);
          c_to_a_parts<kTcParts>(dsa, dpt[2 * kt], dpt[2 * kt + 1]);
#pragma unroll
          for (int d = 0; d < NDT; d += 2) {
            uint32_t of[4], qf[4];
            load_b_kn<CH>(of, dos, qc + kt * 16, cg * NDT + d, lane);
            load_b_kn<CH>(qf, qs, qc + kt * 16, cg * NDT + d, lane);
            mma_parts_add<kTcParts>(dv[d], pa, of[0], of[1]);
            mma_parts_add<kTcParts>(dv[d + 1], pa, of[2], of[3]);
            mma_parts_add<kTcParts>(dk[d], dsa, qf[0], qf[1]);
            mma_parts_add<kTcParts>(dk[d + 1], dsa, qf[2], qf[3]);
          }
        }
      }
    }
    __syncthreads();  // the next copy overwrites this stage
  }
  cp_async_wait<0>();

  // n_split == 1: dk, dv in k's type; else this split's fp32 partials
  const int64_t plane = (int64_t)B * a.T * K * a.D;  // one split's elements
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg * 16 + g + 8 * i;
    if (r >= nrows) continue;
    const int kp = k_start + r;
    bf16* dk_row = static_cast<bf16*>(a.dk) + b * a.dk_sb + kh * a.dk_sh + (int64_t)kp * a.dk_st;
    bf16* dv_row = static_cast<bf16*>(a.dv) + b * a.dk_sb + kh * a.dk_sh + (int64_t)kp * a.dk_st;
    const int64_t e0 = (((int64_t)b * a.T + kp) * K + kh) * a.D;
    float* pk = a.partial + (int64_t)sp * plane + e0;
    float* pv = a.partial + (int64_t)(ns + sp) * plane + e0;
#pragma unroll
    for (int d = 0; d < NDT; ++d) {
      const int col = cg * Sh::DCOL + d * 8 + 2 * t;
      if (col >= a.D) continue;
      if (ns == 1) {
        store_bf16x2(dk_row + col, dk[d][2 * i] * a.scale, dk[d][2 * i + 1] * a.scale);
        store_bf16x2(dv_row + col, dv[d][2 * i], dv[d][2 * i + 1]);
      } else {
        *reinterpret_cast<float2*>(pk + col) = make_float2(dk[d][2 * i], dk[d][2 * i + 1]);
        *reinterpret_cast<float2*>(pv + col) = make_float2(dv[d][2 * i], dv[d][2 * i + 1]);
      }
    }
  }
}

// dk = scale * sum_s dk_partial[s], dv = sum_s dv_partial[s], in split order
// (fp32), rounded once to bf16: four elements per thread.
__global__ void __launch_bounds__(256) flash_bwd_dkv_reduce_kernel(BwdArgs a, int B, int K) {
  const int64_t plane = (int64_t)B * a.T * K * a.D;
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= plane) return;
  const int ns = a.n_split;
  float4 sk = *reinterpret_cast<const float4*>(a.partial + e);
  float4 sv = *reinterpret_cast<const float4*>(a.partial + (int64_t)ns * plane + e);
  for (int s = 1; s < ns; ++s) {
    const float4 pk = *reinterpret_cast<const float4*>(a.partial + (int64_t)s * plane + e);
    const float4 pv = *reinterpret_cast<const float4*>(a.partial + (int64_t)(ns + s) * plane + e);
    sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
    sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
  }
  const int d = (int)(e % a.D);
  int64_t rest = e / a.D;
  const int kh = (int)(rest % K);
  rest /= K;
  const int t = (int)(rest % a.T), b = (int)(rest / a.T);
  const int64_t off = b * a.dk_sb + (int64_t)t * a.dk_st + kh * a.dk_sh + d;
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(a.dk) + off;
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(a.dv) + off;
  tc::store_bf16x2(dk, sk.x * a.scale, sk.y * a.scale);
  tc::store_bf16x2(dk + 2, sk.z * a.scale, sk.w * a.scale);
  tc::store_bf16x2(dv, sv.x, sv.y);
  tc::store_bf16x2(dv + 2, sv.z, sv.w);
}

template <int DP>
static cudaError_t launch_bwd_tc(const BwdArgs& a, int B, int K, int passes,
                                 cudaStream_t stream) {
  const int nq = (a.S + kTcBwdQ - 1) / kTcBwdQ;
  const int nk = (a.T + kTcBwdKV - 1) / kTcBwdKV;
  if (passes & 1) {
    cudaError_t err = launch_with_smem(flash_bwd_dq_tc_kernel<DP>, dim3(nq, a.H, B),
                                       dim3(TcDqShape<DP>::NW * 32), TcDqShape<DP>::smem,
                                       stream, a);
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    cudaError_t err = launch_with_smem(flash_bwd_dkv_tc_kernel<DP>,
                                       dim3(nk, K * a.n_split, B),
                                       dim3(TcDkvShape<DP>::NW * 32), TcDkvShape<DP>::smem,
                                       stream, a);
    if (err != cudaSuccess || a.n_split == 1) return err;
    const int64_t vec4 = (int64_t)B * a.T * K * a.D / 4;
    flash_bwd_dkv_reduce_kernel<<<(unsigned)((vec4 + 255) / 256), 256, 0, stream>>>(a, B, K);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// FMA route (fp32)
// ---------------------------------------------------------------------------

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
static cudaError_t launch_bwd_fma(const BwdArgs& a, int B, int K, int passes,
                              cudaStream_t stream) {
  if (a.D <= 64) return launch_bwd_dc<T, 4>(a, B, K, passes, stream);
  if (a.D <= 128) return launch_bwd_dc<T, 8>(a, B, K, passes, stream);
  return launch_bwd_dc<T, 16>(a, B, K, passes, stream);
}

}  // namespace repro_torch

// dtype of every operand but lse / delta: 0 = bfloat16 (the tensor-core
// route, whose tiles are compiled in: block_q and block_kv must be 64), 1 =
// float32 (the FMA route: block_q up to 64, block_kv up to 32).  q, o, dout,
// dq are (B, S, H, D), k, v, dk, dv (B, T, K, D), addressed through strides
// in elements (dk and dv share theirs); lse and delta are contiguous
// (B, H, S) fp32, delta written by pass 1.  `n_split` (tensor-core route)
// divides the group H / K: the dk / dv pass runs n_split blocks per KV
// block and head, and with n_split > 1 `partial` is a contiguous fp32
// (2, n_split, B, T, K, D) scratch that pass 2 fills and reduces.
// `passes`: 3 launches pass 1 then pass 2 on `stream` (the training path);
// 1 or 2 launches one of them alone (pass 2 reading the delta of an earlier
// pass 1), for timing each.  *route is set to the route launched (1 tensor
// cores, 0 FMA; -1 none).  Returns the first CUDA error (0 = success).
extern "C" int repro_torch_flash_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, float* partial,
    int dtype, int B, int S, int T, int H, int K, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_st, long long dk_sh,
    int causal, int window, float softcap, float scale,
    int block_q, int block_kv, int pruned, int n_split, int passes, int* route,
    void* stream) {
  using namespace repro_torch;
  *route = -1;
  if (passes < 1 || passes > 3 || D > 256 || D % 8 != 0 || H % K != 0 || S < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, partial, S, T, H, H / K, D,
            q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
            do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_st, dk_sh,
            causal, window, softcap, scale, block_q, block_kv, pruned, n_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (block_q != kTcBwdQ || block_kv != kTcBwdKV || n_split < 1 || (H / K) % n_split != 0 ||
        (n_split > 1 && (passes & 2) && partial == nullptr))
      return (int)cudaErrorInvalidValue;
    *route = 1;
    if (D <= 64) return (int)launch_bwd_tc<64>(a, B, K, passes, s);
    if (D <= 128) return (int)launch_bwd_tc<128>(a, B, K, passes, s);
    return (int)launch_bwd_tc<256>(a, B, K, passes, s);
  }
  if (block_q < 1 || block_q > kDqRows || block_q > kDkvQ || block_kv < 1 ||
      block_kv > kDqKV || block_kv > kDkvRows)
    return (int)cudaErrorInvalidValue;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  *route = 0;
  return (int)launch_bwd_fma<float>(a, B, K, passes, s);
}
