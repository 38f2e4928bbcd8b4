// K1 — flash attention forward (prefill / dense mode).
//
// Replaces the TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py): softmax(Q K^T / sqrt(D)
// [softcap] + mask) V with an online softmax over KV blocks, causal and
// sliding-window masks, GQA by kv_head = h / G, ragged kp < kv_len.  K/V
// may be fp32 under a bf16 q: the quantized page pool's first prefill attends
// over the dequantized fp32 values, as the reference kernel does (it reads
// every operand as fp32 and writes the output in q's type).
//
// Bound on an H100: operations — 4 * D * (live q.k pairs) * H flops against
// the bf16 tensor-core peak; the bytes (q, k, v read once, o written once)
// are far below that line at prefill lengths.
//
// Design: grid (q blocks, H, B), one thread block per 64 q positions of one
// head.  The block loops over exactly the reachable KV blocks
// [kv_lo(iq), kv_hi(iq)) (the TPU kernel's clamp-and-elide walk needs a
// static grid; a loop bound does not).  q / k / v / o are addressed in the
// model layout (B, S, H, D) / (B, T, K, D) through strides, so no transposed
// or zero-padded copy of any operand is ever made; ragged edges are masked
// in the kernel.  Products are fp32 FMAs for every input type (see
// attend_core.cuh); moving the bf16 products to the tensor cores is what a
// later change has to do to approach the bound.  `lse` is not written: it
// belongs to the backward, which is not ported yet.
#include "attend_core.cuh"

namespace repro_torch {

constexpr int kPrefillRT = 64;  // q rows per block
constexpr int kPrefillMR = 4;

struct PrefillArgs {
  const void* q; const void* k; const void* v; void* o;
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

template <typename T>
struct PrefillRows {
  const T* q; T* o;
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
static cudaError_t launch_prefill(const PrefillArgs& a, int B, cudaStream_t stream) {
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
// (0, 0), (1, 1) and (0, 1).  Strides are in elements.  Returns the CUDA
// error code of the launch (0 = success).
extern "C" int repro_torch_flash_prefill(
    const void* q, const void* k, const void* v, void* o, int dtype, int kv_dtype,
    int B, int S, int T, int H, int K, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale,
    int block_q, int block_kv, int pruned, void* stream) {
  using namespace repro_torch;
  if (D > 256 || D % 8 != 0 || H % K != 0 || block_q < 1 || block_q > kPrefillRT ||
      block_kv < 1 || block_kv > kBKV)
    return (int)cudaErrorInvalidValue;
  PrefillArgs a{q, k, v, o, S, T, H, H / K, D,
                q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
                causal, window, softcap, scale, block_q, block_kv, pruned};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kv_dtype == 0) return (int)launch_prefill<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  if (dtype == 1 && kv_dtype == 1) return (int)launch_prefill<float, float>(a, B, s);
  if (dtype == 0 && kv_dtype == 1) return (int)launch_prefill<__nv_bfloat16, float>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
