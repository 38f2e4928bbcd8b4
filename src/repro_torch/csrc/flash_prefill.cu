// K1 — flash attention forward (prefill / dense mode).
//
// Replaces the TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py, `_flash_kernel_pruned` over
// `_attend_block`): softmax(Q K^T / sqrt(D) [softcap] + mask) V with an
// online softmax over KV blocks, causal and sliding-window masks, GQA by
// kv_head = h / G, ragged kp < kv_len.  Given an `lse` pointer (the training
// forward) it also writes each row's softmax statistics lse = m + log(l) as
// (B, H, S) fp32 — the residual the fused backward (flash_bwd.cu) recomputes
// probabilities from, as the TPU kernel's `return_lse` does.
//
// Bound on an H100: operations — 4 * D * (live q.k pairs) * H flops against
// the bf16 tensor-core peak; the bytes (q, k, v read once, o written once)
// are far below that line at prefill lengths.
//
// Two routes, chosen by the type pair before any launch:
//  - bf16 q, k, v: the tensor-core route (flash_prefill_tc_kernel over the
//    body in attend_tc.cuh, which says how it computes).  Every product is a
//    warp-level mma.sync m16n8k16 (mma_tile.cuh).  Grid (q blocks, H, B),
//    the last q block — the longest causal walk — launched first.  A block
//    holds 64 q rows (4 warps of 16, and at D = 256 a second set of four for
//    the upper half of the output's columns; 8 warps of 128 rows measured
//    slower at yi-6b's prefill: one block of 190+ registers a thread per SM
//    against two) and streams 64-row K and V tiles through a two-stage
//    cp.async ring.  P enters P V as the three exact bf16 parts of its fp32
//    value and every product is added in IEEE fp32, so the route keeps
//    fp32's accuracy for about three times the tensor work of one bf16 P V.
//    A head dim under 64, or between the instantiated 64 / 128 / 256, is
//    zero-padded in shared memory.  K2's bf16 widened-q mode runs the same
//    body, so its rows agree with this kernel's bit for bit.
//  - fp32 q, k, v, and a bf16 q over fp32 K / V (the quantized page pool's
//    first prefill attends over the dequantized values, as the reference
//    kernel reads every operand as fp32): fp32 FMAs over fp32 tiles
//    (attend_core.cuh), the block sizes as requested up to 64 x 64.  The
//    tensor cores' TF32 would not hold these types' accuracy.
// The entry point reports the route it launched (`route`: 1 tensor cores,
// 0 FMA), and the wrapper counts what it reports.
// Both walk exactly the reachable KV blocks [kv_lo(iq), kv_hi(iq)) under
// `pruned` (a loop bound replaces the TPU kernel's clamp-and-elide grid),
// and every block, streamed but computed only where reachable, without it.
// q / k / v / o are read in the model layout (B, S, H, D) / (B, T, K, D)
// through strides: no transposed or padded copy of any operand.  A fully
// masked row gives output 0 and lse = -1e30 + log(1e-30), as the backward
// expects.
#include "attend_core.cuh"
#include "attend_tc.cuh"

namespace repro_torch {

constexpr int kPrefillRT = 64;  // FMA route: q rows per block
constexpr int kPrefillMR = 4;

struct PrefillArgs {
  const void* q; const void* k; const void* v; void* o;
  float* lse;  // (B, H, S) fp32, or nullptr
  int S, T, H, G, D;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
  int block_q, block_kv, pruned;
};

// ---------------------------------------------------------------------------
// Tensor-core route (bf16): the body is attend_tc.cuh's
// ---------------------------------------------------------------------------

// The block's q rows: positions q_start + r of one (batch, head).
struct PrefillTcRows {
  const tc::bf16* q; tc::bf16* o;
  int64_t q_ss, o_ss;
  int nrows;
  float* lse;  // this (batch, head)'s row of lse at q_start, or nullptr
  int q_start, T, causal, window;
  __device__ __forceinline__ int lo(int r) const {
    return (causal && window > 0) ? q_start + r - window + 1 : 0;
  }
  __device__ __forceinline__ int hi(int r) const { return causal ? min(T, q_start + r + 1) : T; }
  __device__ __forceinline__ void store_o(int r, int col, float x, float y) const {
    tc::store_bf16x2(o + (int64_t)r * o_ss + col, x, y);
  }
  __device__ __forceinline__ void store_lse(int r, float x) const {
    if (lse != nullptr) lse[r] = x;
  }
};

// K / V tiles of a dense (B, T, K, D) operand: slots past T read as 0.
struct DenseTcTiles {
  static constexpr bool kCodes = false;
  const tc::bf16* k; const tc::bf16* v;  // at (batch, KV head)
  int64_t k_st, v_st;
  int T;
  template <int R, int CH, int NT>
  __device__ __forceinline__ void load(tc::bf16* ks, tc::bf16* vs, int jb, int D) const {
    const int k0 = jb * R;
    tc::load_tile_async<R, CH, NT>(ks, k + (int64_t)k0 * k_st, k_st, T - k0, D);
    tc::load_tile_async<R, CH, NT>(vs, v + (int64_t)k0 * v_st, v_st, T - k0, D);
  }
};

template <int DP>
__global__ void __launch_bounds__(TcShape<DP>::NT)
flash_prefill_tc_kernel(PrefillArgs a) {
  using Sh = TcShape<DP>;
  constexpr int BQ = Sh::BQ, BKV = Sh::BKV;
  // the last q block, the longest causal walk, goes first
  const int nq = gridDim.x, hb = gridDim.y * gridDim.z;
  const int64_t lin = blockIdx.x + (int64_t)nq * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  const int iq = nq - 1 - (int)(lin / hb);
  const int h = (int)(lin % hb) % a.H, b = (int)(lin % hb) / a.H;
  const int kh = h / a.G;
  const int nk = (a.T + BKV - 1) / BKV;
  const int q_start = iq * BQ;
  int lo = 0, hi = nk;
  if (a.causal) {
    if (a.window > 0) lo = max(0, (q_start - (a.window - 1)) / BKV);
    hi = min(nk, (q_start + BQ - 1) / BKV + 1);
  }
  const bool pruned = a.pruned && a.causal;
  PrefillTcRows rows{
      static_cast<const tc::bf16*>(a.q) + b * a.q_sb + h * a.q_sh + (int64_t)q_start * a.q_ss,
      static_cast<tc::bf16*>(a.o) + b * a.o_sb + h * a.o_sh + (int64_t)q_start * a.o_ss,
      a.q_ss, a.o_ss, min(BQ, a.S - q_start),
      a.lse != nullptr ? a.lse + ((int64_t)b * a.H + h) * a.S + q_start : nullptr,
      q_start, a.T, a.causal, a.window};
  DenseTcTiles tiles{static_cast<const tc::bf16*>(a.k) + b * a.k_sb + kh * a.k_sh,
                     static_cast<const tc::bf16*>(a.v) + b * a.v_sb + kh * a.v_sh,
                     a.k_st, a.v_st, a.T};
  tc_attend<DP>(rows, tiles, a.D, pruned ? lo : 0, pruned ? hi : nk, lo, hi, a.scale,
                a.softcap);
}

template <int DP>
static cudaError_t launch_prefill_tc(const PrefillArgs& a, int B, cudaStream_t stream) {
  using Sh = TcShape<DP>;
  const int nq = (a.S + Sh::BQ - 1) / Sh::BQ;
  return launch_with_smem(flash_prefill_tc_kernel<DP>, dim3(nq, a.H, B), dim3(Sh::NT),
                          Sh::smem, stream, a);
}

// ---------------------------------------------------------------------------
// FMA route (fp32, and bf16 q over fp32 K / V)
// ---------------------------------------------------------------------------

template <typename T>
struct PrefillRows {
  const T* q; T* o;
  float* lse;  // this (batch, head)'s row of lse, or nullptr
  int64_t q_ss, o_ss;
  int q_start, T_len, causal, window;
  __device__ __forceinline__ const T* q_row(int r) const { return q + (int64_t)(q_start + r) * q_ss; }
  __device__ __forceinline__ T* o_row(int r) const { return o + (int64_t)(q_start + r) * o_ss; }
  __device__ __forceinline__ int lo(int r) const {
    return (causal && window > 0) ? q_start + r - window + 1 : 0;
  }
  __device__ __forceinline__ int hi(int r) const {
    return causal ? min(T_len, q_start + r + 1) : T_len;
  }
  __device__ __forceinline__ void store_lse(int r, float m, float l) const {
    if (lse != nullptr) lse[q_start + r] = m + logf(l);
  }
};

template <typename TK>
struct DenseBlocks {
  const TK* k; const TK* v;
  int64_t slot_stride_k, slot_stride_v;
  int bkv;
  __device__ __forceinline__ const TK* k_block(int jb) const { return k + (int64_t)jb * bkv * slot_stride_k; }
  __device__ __forceinline__ const TK* v_block(int jb) const { return v + (int64_t)jb * bkv * slot_stride_v; }
  __device__ __forceinline__ float k_scale(int) const { return 1.f; }  // values, not codes
  __device__ __forceinline__ float v_scale(int) const { return 1.f; }
};

template <typename T, typename TK, int DC>
__global__ void __launch_bounds__(kTX * kPrefillRT / kPrefillMR)
flash_prefill_kernel(PrefillArgs a) {
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.G;
  const int bq = a.block_q, bkv = a.block_kv;
  const int nk = (a.T + bkv - 1) / bkv;
  const int q_start = iq * bq;
  const int nrows = min(bq, a.S - q_start);

  int lo = 0, hi = nk;
  if (a.causal) {
    if (a.window > 0) lo = max(0, (q_start - (a.window - 1)) / bkv);
    hi = min(nk, (q_start + bq - 1) / bkv + 1);
  }
  PrefillRows<T> rows{
      static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh,
      static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh,
      a.lse != nullptr ? a.lse + ((int64_t)b * a.H + h) * a.S : nullptr,
      a.q_ss, a.o_ss, q_start, a.T, a.causal, a.window};
  DenseBlocks<TK> blocks{
      static_cast<const TK*>(a.k) + b * a.k_sb + kh * a.k_sh,
      static_cast<const TK*>(a.v) + b * a.v_sb + kh * a.v_sh,
      a.k_st, a.v_st, bkv};
  const bool pruned = a.pruned && a.causal;
  attend_rows<T, TK, kPrefillRT, kPrefillMR, DC>(
      rows, blocks, nrows, a.D, bkv, lo, hi, pruned ? lo : 0, pruned ? hi : nk,
      /*slot_begin=*/0, /*slot_end=*/a.T, a.scale, a.softcap);
}

template <typename T, typename TK>
static cudaError_t launch_prefill_fma(const PrefillArgs& a, int B, cudaStream_t stream) {
  const int nq = (a.S + a.block_q - 1) / a.block_q;
  dim3 grid(nq, a.H, B);
  dim3 block(kTX * kPrefillRT / kPrefillMR);
  const size_t smem = attend_smem_bytes<kPrefillRT>(a.D);
  if (a.D <= 64)
    return launch_with_smem(flash_prefill_kernel<T, TK, 4>, grid, block, smem, stream, a);
  if (a.D <= 128)
    return launch_with_smem(flash_prefill_kernel<T, TK, 8>, grid, block, smem, stream, a);
  return launch_with_smem(flash_prefill_kernel<T, TK, 16>, grid, block, smem, stream, a);
}

}  // namespace repro_torch

// dtype (q and o) / kv_dtype (k and v): 0 = bfloat16, 1 = float32; the pairs
// (0, 0) — the tensor-core route, whose tiles are compiled in: block_q and
// block_kv must be 64 —, and
// (1, 1), (0, 1) — the FMA route, any block_q, block_kv up to 64.  Strides
// are in elements.  `lse` is a contiguous (B, H, S) fp32 output, or null.
// *route is set to the route launched (1 tensor cores, 0 FMA; -1 none).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int repro_torch_flash_prefill(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
    int kv_dtype,
    int B, int S, int T, int H, int K, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale,
    int block_q, int block_kv, int pruned, int* route, void* stream) {
  using namespace repro_torch;
  *route = -1;
  if (D > 256 || D % 8 != 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  PrefillArgs a{q, k, v, o, lse, S, T, H, H / K, D,
                q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
                causal, window, softcap, scale, block_q, block_kv, pruned};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kv_dtype == 0) {
    if (block_q != kTcQ || block_kv != kTcKV) return (int)cudaErrorInvalidValue;
    *route = 1;
    if (D <= 64) return (int)launch_prefill_tc<64>(a, B, s);
    if (D <= 128) return (int)launch_prefill_tc<128>(a, B, s);
    return (int)launch_prefill_tc<256>(a, B, s);
  }
  if (block_q < 1 || block_q > kPrefillRT || block_kv < 1 || block_kv > kBKV ||
      kv_dtype != 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  *route = 0;
  if (dtype == 1) return (int)launch_prefill_fma<float, float>(a, B, s);
  return (int)launch_prefill_fma<__nv_bfloat16, float>(a, B, s);
}
