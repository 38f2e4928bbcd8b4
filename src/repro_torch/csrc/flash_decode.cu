// K2 — flash decode: S >= 1 new q tokens against a KV cache that already
// holds them.
//
// Replaces the TPU kernel `flash_decode_fwd`
// (src/repro/kernels/flash_attention/decode.py): per-request `index`, live
// block interval [dec_lo, dec_hi), per-row boundary
// kp < clip(index + r/G + 1, 1, kv_len), sliding window on linear caches,
// ring caches (T == W, no window), widened q (q_span tokens per request) and
// paged pools addressed through per-request block tables.  The quantized
// (int8 / fp8 pool) mode is not ported yet.
//
// Bound on an H100: bytes — every live K and V slot is read once,
// sum_b live_slots(b) * K * D * 2 * sizeof(T) per call, against the card's
// memory bandwidth; the q rows and the output are noise beside that.
//
// Design: grid (B, K, row tiles).  The block loads index[b] itself, computes
// lo / hi with the reference's arithmetic and loops exactly over the live
// blocks — there are no overshoot steps to elide.  The cache is read in the
// model's own layout, (B, T, K, D) or (P, page, K, D), through strides: no
// transposed copy of the cache per layer per token.  With a block table,
// logical block jb resolves to (tables[b, jb / spb], jb % spb); every mask
// stays in logical slot space, so the paged and the dense walk do the same
// arithmetic in the same order and agree bit for bit.  Slots outside the live
// range of the request are never read (dead pages may hold anything).  q rows
// are addressed in the model layout (B, S, H, D): row r of KV head kh is token
// r / G, head kh * G + r % G, so no folded copy of q or o is made either.
//
// One block per (request, KV head) leaves most of the card idle at serving
// batch sizes (B * K = 32 blocks on 132 SMs); splitting the KV walk across
// blocks is later work.
#include "attend_core.cuh"

namespace repro_torch {

constexpr int kDecodeRT = 16;  // q rows per block
constexpr int kDecodeMR = 2;

struct DecodeArgs {
  const void* q; const void* k; const void* v; void* o;
  const int* index;   // (B,)
  const int* tables;  // (B, NB) or nullptr
  int NB, page_size;
  int S, T, G, D;     // T: logical cache length
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_st, k_sh;  // k_sb: batch stride (dense) or page stride (paged)
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int window;      // <= 0: none
  float softcap;   // <= 0: none
  float scale;
  int block_kv, pruned;
};

template <typename T>
struct DecodeRows {
  const T* q; T* o;  // at (b, token 0, head kh * G)
  int64_t q_ss, q_sh, o_ss, o_sh;
  int row0, G, index, T_len, window;
  __device__ __forceinline__ const T* q_row(int r) const {
    const int g = row0 + r;
    return q + (int64_t)(g / G) * q_ss + (int64_t)(g % G) * q_sh;
  }
  __device__ __forceinline__ T* o_row(int r) const {
    const int g = row0 + r;
    return o + (int64_t)(g / G) * o_ss + (int64_t)(g % G) * o_sh;
  }
  __device__ __forceinline__ int lo(int r) const {
    return window > 0 ? index + (row0 + r) / G - window + 1 : 0;
  }
  __device__ __forceinline__ int hi(int r) const {
    return max(1, min(T_len, index + (row0 + r) / G + 1));
  }
};

template <typename T>
struct CacheBlocks {
  const T* k; const T* v;  // at head kh (and at request b when dense)
  int64_t slot_stride_k, slot_stride_v;
  int64_t page_stride_k, page_stride_v;
  const int* table;  // this request's row, or nullptr
  int bkv, spb;      // spb: blocks per page
  __device__ __forceinline__ const T* k_block(int jb) const {
    if (table == nullptr) return k + (int64_t)jb * bkv * slot_stride_k;
    return k + (int64_t)table[jb / spb] * page_stride_k +
           (int64_t)(jb % spb) * bkv * slot_stride_k;
  }
  __device__ __forceinline__ const T* v_block(int jb) const {
    if (table == nullptr) return v + (int64_t)jb * bkv * slot_stride_v;
    return v + (int64_t)table[jb / spb] * page_stride_v +
           (int64_t)(jb % spb) * bkv * slot_stride_v;
  }
};

template <typename T, int DC>
__global__ void __launch_bounds__(kTX * kDecodeRT / kDecodeMR)
flash_decode_kernel(DecodeArgs a) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int row0 = blockIdx.z * kDecodeRT;
  const int R = a.S * a.G;
  const int nrows = min(kDecodeRT, R - row0);
  const int bkv = a.block_kv;
  const int nk = (a.T + bkv - 1) / bkv;
  const int index = a.index[b];

  // live interval, as the reference computes it
  const int last_live = max(1, min(a.T, index + a.S));  // clip(index + q_span, 1, T)
  const int hi = (last_live + bkv - 1) / bkv;
  int lo = 0;
  if (a.window > 0) lo = max(0, min((index + 1 - a.window) / bkv, hi - 1));

  const bool paged = a.tables != nullptr;
  DecodeRows<T> rows{
      static_cast<const T*>(a.q) + b * a.q_sb + (int64_t)kh * a.G * a.q_sh,
      static_cast<T*>(a.o) + b * a.o_sb + (int64_t)kh * a.G * a.o_sh,
      a.q_ss, a.q_sh, a.o_ss, a.o_sh, row0, a.G, index, a.T, a.window};
  CacheBlocks<T> blocks{
      static_cast<const T*>(a.k) + (paged ? 0 : b * a.k_sb) + kh * a.k_sh,
      static_cast<const T*>(a.v) + (paged ? 0 : b * a.v_sb) + kh * a.v_sh,
      a.k_st, a.v_st, a.k_sb, a.v_sb,
      paged ? a.tables + (int64_t)b * a.NB : nullptr,
      bkv, paged ? a.page_size / bkv : 1};
  // pruned: stream only the live blocks and, inside them, only the slots the
  // request can see.  Unpruned baseline: stream every block of the cache.
  const int slot_begin = a.pruned ? (a.window > 0 ? max(0, index + 1 - a.window) : 0) : 0;
  const int slot_end = a.pruned ? last_live : a.T;
  attend_rows<T, kDecodeRT, kDecodeMR, DC>(
      rows, blocks, nrows, a.D, bkv, lo, hi, a.pruned ? lo : 0, a.pruned ? hi : nk,
      slot_begin, slot_end, a.scale, a.softcap);
}

template <typename T>
static cudaError_t launch_decode(const DecodeArgs& a, int B, int K, cudaStream_t stream) {
  const int R = a.S * a.G;
  dim3 grid(B, K, (R + kDecodeRT - 1) / kDecodeRT);
  dim3 block(kTX * kDecodeRT / kDecodeMR);
  const size_t smem = attend_smem_bytes<kDecodeRT>(a.D);
  if (a.D <= 64)
    return launch_with_smem(flash_decode_kernel<T, 4>, grid, block, smem, stream, a);
  if (a.D <= 128)
    return launch_with_smem(flash_decode_kernel<T, 8>, grid, block, smem, stream, a);
  return launch_with_smem(flash_decode_kernel<T, 16>, grid, block, smem, stream, a);
}

}  // namespace repro_torch

// dtype: 0 = bfloat16, 1 = float32.  Strides are in elements.  `tables` may
// be null (dense cache); then k_sb / v_sb are batch strides, else page
// strides.  Returns the CUDA error code of the launch (0 = success).
extern "C" int repro_torch_flash_decode(
    const void* q, const void* k, const void* v, void* o,
    const void* index, const void* tables, int dtype,
    int B, int S, int T, int H, int K, int D, int NB, int page_size,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int window, float softcap, float scale, int block_kv, int pruned, void* stream) {
  using namespace repro_torch;
  if (D > 256 || D % 8 != 0 || H % K != 0 || block_kv < 1 || block_kv > kBKV || T < 1)
    return (int)cudaErrorInvalidValue;
  if (tables != nullptr && (page_size % block_kv != 0 || (long long)NB * page_size < T))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, o, static_cast<const int*>(index), static_cast<const int*>(tables),
               NB, page_size, S, T, H / K, D,
               q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
               window, softcap, scale, block_kv, pruned};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_decode<__nv_bfloat16>(a, B, K, s);
  if (dtype == 1) return (int)launch_decode<float>(a, B, K, s);
  return (int)cudaErrorInvalidValue;
}
