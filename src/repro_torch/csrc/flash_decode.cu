// K2 — flash decode: S >= 1 new q tokens against a KV cache that already
// holds them.
//
// Replaces the TPU kernel `flash_decode_fwd`
// (src/repro/kernels/flash_attention/decode.py): per-request `index`, live
// block interval [dec_lo, dec_hi), per-row boundary
// kp < clip(index + r/G + 1, 1, kv_len), sliding window on linear caches,
// ring caches (T == W, no window), widened q (q_span tokens per request),
// paged pools addressed through per-request block tables, and the quantized
// mode: int8 / fp8 (e4m3, e5m2) K/V codes with one fp32 scale per page and KV
// head — (P, K) for a pool, (B, NP, K) with `scale_page` slots per row for a
// dense cache — dequantized per streamed block (reference body decode.py
// :233-243, scale index maps :401-419).
//
// Bound on an H100: bytes — every live K and V slot is read once,
// sum_b live_slots(b) * K * D * 2 * sizeof(KV element) per call (plus one
// fp32 scale per page and head in the quantized mode), against the card's
// memory bandwidth; the q rows and the output are noise beside that.
//
// Quantized mode: one kernel body with the other modes.  `block_kv` divides
// the page (or the dense scale row), so one scalar scale covers a block; it
// is read through the same table entry as the block's codes, and the codes
// become float(code) * scale on their way into shared memory.  The online
// softmax after that is the unquantized one, so a paged and a dense cache of
// the same codes and scales agree bit for bit.
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
  const float* ksc; const float* vsc;  // dequant scales, or nullptr
  int64_t sc_b, sc_p, sc_k;  // scale strides: batch (dense), page / row, head
  int scale_page;            // dense quantized caches: slots per scale row
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
  __device__ __forceinline__ void store_lse(int, float, float) const {}  // serving only
};

template <typename TK>
struct CacheBlocks {
  const TK* k; const TK* v;  // at head kh (and at request b when dense)
  int64_t slot_stride_k, slot_stride_v;
  int64_t page_stride_k, page_stride_v;
  const int* table;  // this request's row, or nullptr
  int bkv, spb;      // spb: blocks per page
  const float* ksc; const float* vsc;  // at head kh (and request b when dense)
  int64_t sc_p;      // elements between scale rows (pages / dense rows)
  int scale_page;    // dense: slots per scale row
  __device__ __forceinline__ const TK* k_block(int jb) const {
    if (table == nullptr) return k + (int64_t)jb * bkv * slot_stride_k;
    return k + (int64_t)table[jb / spb] * page_stride_k +
           (int64_t)(jb % spb) * bkv * slot_stride_k;
  }
  __device__ __forceinline__ const TK* v_block(int jb) const {
    if (table == nullptr) return v + (int64_t)jb * bkv * slot_stride_v;
    return v + (int64_t)table[jb / spb] * page_stride_v +
           (int64_t)(jb % spb) * bkv * slot_stride_v;
  }
  // the scale row of block jb: its page, or its dense row
  __device__ __forceinline__ int64_t scale_row(int jb) const {
    return table != nullptr ? (int64_t)table[jb / spb]
                            : (int64_t)jb * bkv / scale_page;
  }
  __device__ __forceinline__ float k_scale(int jb) const {
    return ksc == nullptr ? 1.f : ksc[scale_row(jb) * sc_p];
  }
  __device__ __forceinline__ float v_scale(int jb) const {
    return vsc == nullptr ? 1.f : vsc[scale_row(jb) * sc_p];
  }
};

template <typename T, typename TK, int DC>
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
  const int64_t sc_off = (paged ? 0 : b * a.sc_b) + kh * a.sc_k;
  CacheBlocks<TK> blocks{
      static_cast<const TK*>(a.k) + (paged ? 0 : b * a.k_sb) + kh * a.k_sh,
      static_cast<const TK*>(a.v) + (paged ? 0 : b * a.v_sb) + kh * a.v_sh,
      a.k_st, a.v_st, a.k_sb, a.v_sb,
      paged ? a.tables + (int64_t)b * a.NB : nullptr,
      bkv, paged ? a.page_size / bkv : 1,
      a.ksc == nullptr ? nullptr : a.ksc + sc_off,
      a.vsc == nullptr ? nullptr : a.vsc + sc_off,
      a.sc_p, a.scale_page};
  // pruned: stream only the live blocks and, inside them, only the slots the
  // request can see.  Unpruned baseline: stream every block of the cache.
  const int slot_begin = a.pruned ? (a.window > 0 ? max(0, index + 1 - a.window) : 0) : 0;
  const int slot_end = a.pruned ? last_live : a.T;
  attend_rows<T, TK, kDecodeRT, kDecodeMR, DC>(
      rows, blocks, nrows, a.D, bkv, lo, hi, a.pruned ? lo : 0, a.pruned ? hi : nk,
      slot_begin, slot_end, a.scale, a.softcap);
}

template <typename T, typename TK>
static cudaError_t launch_decode(const DecodeArgs& a, int B, int K, cudaStream_t stream) {
  const int R = a.S * a.G;
  dim3 grid(B, K, (R + kDecodeRT - 1) / kDecodeRT);
  dim3 block(kTX * kDecodeRT / kDecodeMR);
  const size_t smem = attend_smem_bytes<kDecodeRT>(a.D);
  if (a.D <= 64)
    return launch_with_smem(flash_decode_kernel<T, TK, 4>, grid, block, smem, stream, a);
  if (a.D <= 128)
    return launch_with_smem(flash_decode_kernel<T, TK, 8>, grid, block, smem, stream, a);
  return launch_with_smem(flash_decode_kernel<T, TK, 16>, grid, block, smem, stream, a);
}

// The KV element type: the same as q's for values, or a code type.
template <typename T>
static cudaError_t launch_decode_kv(const DecodeArgs& a, int kv_dtype, int dtype, int B, int K,
                                    cudaStream_t stream) {
  if (kv_dtype == dtype) return launch_decode<T, T>(a, B, K, stream);
  if (kv_dtype == 2) return launch_decode<T, int8_t>(a, B, K, stream);
  if (kv_dtype == 3) return launch_decode<T, __nv_fp8_e4m3>(a, B, K, stream);
  if (kv_dtype == 4) return launch_decode<T, __nv_fp8_e5m2>(a, B, K, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch

// dtype (q and o): 0 = bfloat16, 1 = float32.  kv_dtype (k and v): the same
// as dtype, or a code type — 2 = int8, 3 = float8_e4m3fn, 4 = float8_e5m2 —
// which needs the fp32 scales ksc / vsc (else both null).  Strides are in
// elements.  `tables` may be null (dense cache); then k_sb / v_sb are batch
// strides, else page strides.  Scales are addressed ksc[b * sc_b + row * sc_p
// + kh * sc_k], row = the block's page (paged; sc_b unused) or its slot /
// scale_page (dense).  Returns the CUDA error code of the launch (0 = success).
extern "C" int repro_torch_flash_decode(
    const void* q, const void* k, const void* v, void* o,
    const void* index, const void* tables, const void* ksc, const void* vsc,
    int dtype, int kv_dtype,
    int B, int S, int T, int H, int K, int D, int NB, int page_size,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long sc_b, long long sc_p, long long sc_k, int scale_page,
    int window, float softcap, float scale, int block_kv, int pruned, void* stream) {
  using namespace repro_torch;
  if (D > 256 || D % 8 != 0 || H % K != 0 || block_kv < 1 || block_kv > kBKV || T < 1)
    return (int)cudaErrorInvalidValue;
  if (tables != nullptr && (page_size % block_kv != 0 || (long long)NB * page_size < T))
    return (int)cudaErrorInvalidValue;
  const bool codes = kv_dtype >= 2;
  if (dtype < 0 || dtype > 1 || kv_dtype > 4 || (!codes && kv_dtype != dtype) ||
      codes != (ksc != nullptr) || (ksc == nullptr) != (vsc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (codes && tables == nullptr && (scale_page < 1 || scale_page % block_kv != 0))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, o, static_cast<const int*>(index), static_cast<const int*>(tables),
               static_cast<const float*>(ksc), static_cast<const float*>(vsc),
               sc_b, sc_p, sc_k, scale_page,
               NB, page_size, S, T, H / K, D,
               q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
               window, softcap, scale, block_kv, pruned};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_decode_kv<__nv_bfloat16>(a, kv_dtype, dtype, B, K, s);
  return (int)launch_decode_kv<float>(a, kv_dtype, dtype, B, K, s);
}
