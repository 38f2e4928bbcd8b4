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
// dense cache (reference body decode.py :233-243, scale index maps :401-419).
//
// Bound on an H100: bytes — every live K and V slot is read once,
// sum_b live_slots(b) * K * D * 2 * sizeof(KV element) per call (plus the
// fp32 scales in the quantized mode), against the card's memory bandwidth;
// the q rows and the output are noise beside that.
//
// Three routes, chosen by the call's types and token count and reported
// through `route`:
//
// - 2, one token with a bf16 q over bf16 values or int8 / fp8 codes (every
//   serving decode step): the split route (decode_split.cuh,
//   flash_decode_split_kernel).  The KV walk is cut into fixed chunks of
//   logical slots spread over the card, the GQA group runs on the tensor
//   cores, the dequant scales are factored out of the products, and the
//   chunks are combined in chunk order.
// - 1, widened q (S > 1 bf16 tokens: a prefix-shared admission's suffix, a
//   prefill chunk, and a quantized pool's first prefill at index 0) over
//   bf16 values or int8 / fp8 codes: the tensor-core mode
//   (flash_decode_tc_kernel), K1's bf16 body (attend_tc.cuh) over 64-slot
//   tiles of the cache, grid (q blocks of 64 tokens, H, B), each token's row
//   masked exactly as below.  A row's bits then equal K1's for the same row
//   of the whole prompt (over codes: this mode's own row of the whole
//   prompt at index 0): a shared and an unshared admission write the same
//   suffix rows.  Codes are copied as they are beside their per-slot
//   scales, widened to bf16 exactly in shared memory, and the scales are
//   factored out of the products, as the split route does; a slot's scale
//   is read per slot, so a tile may span pages smaller than 64 slots.
//   Slots outside the request's live range are zero-filled, never read.
// - 0, the rest (an fp32 q — the accuracy policy — over fp32 values or
//   codes): the FMA body
//   (attend_core.cuh, flash_decode_kernel), grid (B, K, row tiles).  The
//   block loads index[b] itself, computes lo / hi with the reference's
//   arithmetic and loops exactly over the live blocks.  Row r of KV head kh
//   is token r / G, head kh * G + r % G.  A block of codes is dequantized on
//   its way into shared memory: `block_kv` divides the page (or the dense
//   scale row), so one scalar scale covers a block.
//
// Every route reads the cache in the model's own layout, (B, T, K, D) or
// (P, page, K, D), through strides: no transposed copy per layer per token.
// With a block table every mask stays in logical slot space, so the paged
// and the dense walk do the same arithmetic in the same order and agree bit
// for bit; slots outside the live range of the request are never read (dead
// pages may hold anything).
//
// A rank's share of a sequence-split cache (the `Share` of decode_split.cuh)
// runs each route over the rank's slots alone, with every row's live bounds
// counted in those slots (none may be live: o = 0, lse = -inf), and writes
// fp32 o and each row's lse for the ranks' merge; with no share every route
// is bit for bit what it is without one.
#include <type_traits>

#include "attend_core.cuh"
#include "attend_tc.cuh"
#include "decode_split.cuh"

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
  float* part;   // split route: fp32 chunk partials (B, H, chunks, D + 2)
  int* tickets;  // split route: (B, K x row tiles) counters, 0 between calls
  Share share;   // a rank's share of the slots (sub == 0: the whole cache)
  float* lse;    // a share's call: (B, S, H) fp32 lse, o in fp32
  int64_t lse_sb, lse_ss;
};

template <typename T>
struct DecodeRows {
  const T* q; T* o;  // at (b, token 0, head kh * G)
  int64_t q_ss, q_sh, o_ss, o_sh;
  int row0, G, index, T_len, window;
  Share share;
  float* lse;        // a share's call: at (b, token 0, head kh * G), else nullptr
  int64_t lse_ss;
  __device__ __forceinline__ const T* q_row(int r) const {
    const int g = row0 + r;
    return q + (int64_t)(g / G) * q_ss + (int64_t)(g % G) * q_sh;
  }
  __device__ __forceinline__ T* o_row(int r) const {
    const int g = row0 + r;
    return o + (int64_t)(g / G) * o_ss + (int64_t)(g % G) * o_sh;
  }
  __device__ __forceinline__ int lo(int r) const {
    return share.lo(index + (row0 + r) / G, window);
  }
  __device__ __forceinline__ int hi(int r) const {
    return share.hi(index + (row0 + r) / G, T_len);
  }
  // a share's call keeps lse = m + log l, -inf where the row saw nothing
  __device__ __forceinline__ void store_lse(int r, float m, float l) const {
    if (lse == nullptr) return;
    const int g = row0 + r;
    lse[(int64_t)(g / G) * lse_ss + g % G] = m <= kNegInf ? tc::neg_inf() : m + logf(l);
  }
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

  // live interval, as the reference computes it: clip(index + q_span, 1, T)
  // on a whole cache
  const int last_live = a.share.hi(index + a.S - 1, a.T);
  const int hi = (last_live + bkv - 1) / bkv;
  int lo = 0;
  if (a.window > 0) lo = max(0, min(a.share.lo(index, a.window) / bkv, hi - 1));

  const bool paged = a.tables != nullptr;
  DecodeRows<T> rows{
      static_cast<const T*>(a.q) + b * a.q_sb + (int64_t)kh * a.G * a.q_sh,
      static_cast<T*>(a.o) + b * a.o_sb + (int64_t)kh * a.G * a.o_sh,
      a.q_ss, a.q_sh, a.o_ss, a.o_sh, row0, a.G, index, a.T, a.window, a.share,
      a.lse == nullptr ? nullptr : a.lse + b * a.lse_sb + (int64_t)kh * a.G,
      a.lse_ss};
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
  const int slot_begin = a.pruned ? max(0, a.share.lo(index, a.window)) : 0;
  const int slot_end = a.pruned ? last_live : a.T;
  attend_rows<T, TK, kDecodeRT, kDecodeMR, DC>(
      rows, blocks, nrows, a.D, bkv, lo, hi, a.pruned ? lo : 0, a.pruned ? hi : nk,
      slot_begin, slot_end, a.scale, a.softcap);
}

// ---------------------------------------------------------------------------
// Widened q over bf16 values or codes: the tensor-core mode
// ---------------------------------------------------------------------------

// The block's q rows: tokens q0 + r of one (request, head), at positions
// index + q0 + r, masked as DecodeRows masks them.  kShare (a share's call,
// its own instantiation: the whole cache's keeps the code it had without
// the block mode) writes o in fp32 and keeps each row's lse.
template <bool kShare>
struct DecodeTcRows {
  using TO = std::conditional_t<kShare, float, tc::bf16>;
  const tc::bf16* q; TO* o;
  int64_t q_ss, o_ss;
  int nrows;
  int pos0, T, window;  // pos0 = index + q0
  Share share;
  float* lse;           // a share's call: at (b, token q0, head h)
  int64_t lse_ss;
  __device__ __forceinline__ int lo(int r) const {
    if constexpr (kShare) return share.lo(pos0 + r, window);
    else return window > 0 ? pos0 + r - window + 1 : 0;
  }
  __device__ __forceinline__ int hi(int r) const {
    if constexpr (kShare) return share.hi(pos0 + r, T);
    else return max(1, min(T, pos0 + r + 1));
  }
  __device__ __forceinline__ void store_o(int r, int col, float x, float y) const {
    if constexpr (kShare) {
      *reinterpret_cast<float2*>(o + (int64_t)r * o_ss + col) = make_float2(x, y);
    } else {
      tc::store_bf16x2(o + (int64_t)r * o_ss + col, x, y);
    }
  }
  // x = m + log l, exactly kNegInf where the row saw nothing (m = -inf)
  __device__ __forceinline__ void store_lse(int r, float x) const {
    if constexpr (kShare) lse[(int64_t)r * lse_ss] = x == kNegInf ? tc::neg_inf() : x;
  }
};

// one past the last slot a row at position p sees, and (under a window) the
// first: a share's in its slots, a whole cache's clip(p + 1, 1, T) and
// p - window + 1
template <bool kShare>
__device__ __forceinline__ int tc_row_hi(const DecodeArgs& a, int p) {
  if constexpr (kShare) return a.share.hi(p, a.T);
  else return max(1, min(a.T, p + 1));
}
template <bool kShare>
__device__ __forceinline__ int tc_row_lo(const DecodeArgs& a, int p) {
  if constexpr (kShare) return a.share.lo(p, a.window);
  else return p - a.window + 1;
}

// 64-slot tiles of a dense cache or, through the request's block table, of
// a page pool; slots outside [slot_begin, slot_end) are zero-filled.
struct CacheTcTiles {
  static constexpr bool kCodes = false;
  const tc::bf16* k; const tc::bf16* v;  // at head kh (and request b when dense)
  int64_t k_st, v_st, k_sp, v_sp;        // slot strides, page strides
  const int* table;                      // this request's row, or nullptr
  int page_size, slot_begin, slot_end;
  template <int R, int CH, int NT>
  __device__ __forceinline__ void load(tc::bf16* ks, tc::bf16* vs, int jb, int D) const {
#pragma unroll 4
    for (int i = threadIdx.x; i < R * CH; i += NT) {
      const int r = i / CH, c = i % CH, slot = jb * R + r;
      const bool ok = slot >= slot_begin && slot < slot_end && c * 8 < D;
      int64_t ko = 0, vo = 0;
      if (ok) {
        if (table != nullptr) {
          const int64_t page = table[slot / page_size], at = slot % page_size;
          ko = page * k_sp + at * k_st;
          vo = page * v_sp + at * v_st;
        } else {
          ko = (int64_t)slot * k_st;
          vo = (int64_t)slot * v_st;
        }
      }
      tc::cp_async16(ks + tc::swz<CH>(r, c), ok ? k + ko + c * 8 : k, ok);
      tc::cp_async16(vs + tc::swz<CH>(r, c), ok ? v + vo + c * 8 : v, ok);
    }
  }
};

// The same tiles over int8 / fp8 codes: a stage holds tile jb's K codes
// ([R][DP] bytes), its V codes, then the R slots' K scales and V scales
// (fp32; a slot's scale row is its page, or slot / scale_page when dense);
// slots outside [slot_begin, slot_end) read as code 0 and scale 0.
template <typename TK>
struct CacheTcCodeTiles {
  static constexpr bool kCodes = true;
  const TK* k; const TK* v;               // at head kh (and request b when dense)
  int64_t k_st, v_st, k_sp, v_sp;         // slot strides, page strides
  const int* table;                       // this request's row, or nullptr
  int page_size, slot_begin, slot_end;
  const float* ksc; const float* vsc;     // at head kh (and request b when dense)
  int64_t sc_p;                           // elements between scale rows
  int scale_page;                         // dense: slots per scale row
  template <int R, int CH, int NT>
  __device__ __forceinline__ void load(unsigned char* st, int jb, int D) const {
    constexpr int DP = CH * 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < R * CH; i += NT) {
      const int r = i / CH, c = i % CH, slot = jb * R + r;
      const bool ok = slot >= slot_begin && slot < slot_end && c * 8 < D;
      int64_t ko = 0, vo = 0;
      if (ok) {
        if (table != nullptr) {
          const int64_t page = table[slot / page_size], at = slot % page_size;
          ko = page * k_sp + at * k_st;
          vo = page * v_sp + at * v_st;
        } else {
          ko = (int64_t)slot * k_st;
          vo = (int64_t)slot * v_st;
        }
      }
      tc::cp_async8(st + r * DP + c * 8, ok ? k + ko + c * 8 : k, ok);
      tc::cp_async8(st + (R + r) * DP + c * 8, ok ? v + vo + c * 8 : v, ok);
    }
    float* sc = reinterpret_cast<float*>(st + 2 * R * DP);
    for (int r = threadIdx.x; r < R; r += NT) {
      const int slot = jb * R + r;
      const bool ok = slot >= slot_begin && slot < slot_end;
      const int64_t row = !ok ? 0 : table != nullptr ? (int64_t)table[slot / page_size]
                                                     : (int64_t)(slot / scale_page);
      tc::cp_async4(sc + r, ok ? ksc + row * sc_p : ksc, ok);
      tc::cp_async4(sc + R + r, ok ? vsc + row * sc_p : vsc, ok);
    }
  }
  // a landed stage's codes widened into the swizzled bf16 K / V tiles
  template <int R, int CH, int NT>
  __device__ __forceinline__ void widen(tc::bf16* ks, tc::bf16* vs,
                                        const unsigned char* st) const {
    constexpr int DP = CH * 8;
    // at D 256 the body already holds 64 output sums a thread: widening one
    // chunk at a time keeps it clear of spills
#pragma unroll(CH > 16 ? 1 : 4)
    for (int i = threadIdx.x; i < R * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      *reinterpret_cast<uint4*>(ks + tc::swz<CH>(r, c)) = codes_to_bf16x8<TK>(st + r * DP + c * 8);
      *reinterpret_cast<uint4*>(vs + tc::swz<CH>(r, c)) =
          codes_to_bf16x8<TK>(st + (R + r) * DP + c * 8);
    }
  }
};

template <int DP, typename TK, bool kShare>
__global__ void __launch_bounds__(TcShape<DP>::NT)
flash_decode_tc_kernel(DecodeArgs a) {
  using Sh = TcShape<DP>;
  constexpr int BQ = Sh::BQ, BKV = Sh::BKV;
  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.G;
  const int q0 = iq * BQ, nrows = min(BQ, a.S - q0);
  const int index = a.index[b];
  const int nk = (a.T + BKV - 1) / BKV;
  // the call's live slots, as the FMA mode computes them, and this block's
  // tiles: from its first row's window to its last row's boundary
  const int last_live = tc_row_hi<kShare>(a, index + a.S - 1);
  const int hi = (tc_row_hi<kShare>(a, index + q0 + nrows - 1) + BKV - 1) / BKV;
  int lo = 0;
  if (a.window > 0) lo = max(0, min(tc_row_lo<kShare>(a, index + q0) / BKV, hi - 1));
  const int slot_begin =
      a.pruned && a.window > 0 ? max(0, tc_row_lo<kShare>(a, index)) : 0;
  const int slot_end = a.pruned ? last_live : a.T;

  const bool paged = a.tables != nullptr;
  using Rows = DecodeTcRows<kShare>;
  Rows rows{
      static_cast<const tc::bf16*>(a.q) + b * a.q_sb + (int64_t)h * a.q_sh + (int64_t)q0 * a.q_ss,
      static_cast<typename Rows::TO*>(a.o) + b * a.o_sb + (int64_t)h * a.o_sh +
          (int64_t)q0 * a.o_ss,
      a.q_ss, a.o_ss, nrows, index + q0, a.T, a.window, a.share,
      kShare ? a.lse + b * a.lse_sb + (int64_t)q0 * a.lse_ss + h : nullptr, a.lse_ss};
  const int* table = paged ? a.tables + (int64_t)b * a.NB : nullptr;
  const TK* kp = static_cast<const TK*>(a.k) + (paged ? 0 : b * a.k_sb) + kh * a.k_sh;
  const TK* vp = static_cast<const TK*>(a.v) + (paged ? 0 : b * a.v_sb) + kh * a.v_sh;
  const int walk_begin = a.pruned ? lo : 0, walk_end = a.pruned ? hi : nk;
  if constexpr (IsCode<TK>::value) {
    const int64_t sc_off = (paged ? 0 : b * a.sc_b) + kh * a.sc_k;
    CacheTcCodeTiles<TK> tiles{kp, vp, a.k_st, a.v_st, a.k_sb, a.v_sb, table,
                               a.page_size, slot_begin, slot_end,
                               a.ksc + sc_off, a.vsc + sc_off, a.sc_p, a.scale_page};
    tc_attend<DP>(rows, tiles, a.D, walk_begin, walk_end, lo, hi, a.scale, a.softcap);
  } else {
    CacheTcTiles tiles{kp, vp, a.k_st, a.v_st, a.k_sb, a.v_sb, table,
                       a.page_size, slot_begin, slot_end};
    tc_attend<DP>(rows, tiles, a.D, walk_begin, walk_end, lo, hi, a.scale, a.softcap);
  }
}

template <int DP, typename TK>
static cudaError_t launch_decode_tc(const DecodeArgs& a, int B, int H, cudaStream_t stream) {
  using Sh = TcShape<DP>;
  dim3 grid((a.S + Sh::BQ - 1) / Sh::BQ, H, B);
  const size_t smem = IsCode<TK>::value ? Sh::smem_codes : Sh::smem;
  if (a.lse != nullptr)
    return launch_with_smem(flash_decode_tc_kernel<DP, TK, true>, grid, dim3(Sh::NT), smem,
                            stream, a);
  return launch_with_smem(flash_decode_tc_kernel<DP, TK, false>, grid, dim3(Sh::NT), smem,
                          stream, a);
}

// The tensor-core mode at the padded head dim of `a.D` (64, 128 or 256).
template <typename TK>
static cudaError_t launch_decode_tc_d(const DecodeArgs& a, int B, int H, cudaStream_t stream) {
  if (a.D <= 64) return launch_decode_tc<64, TK>(a, B, H, stream);
  if (a.D <= 128) return launch_decode_tc<128, TK>(a, B, H, stream);
  return launch_decode_tc<256, TK>(a, B, H, stream);
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

// The FMA body over codes, for an fp32 q (a bf16 q over codes takes the
// split route for one token, the tensor-core mode for more).
static cudaError_t launch_decode_codes(const DecodeArgs& a, int kv_dtype, int B, int K,
                                       cudaStream_t stream) {
  if (kv_dtype == 2) return launch_decode<float, int8_t>(a, B, K, stream);
  if (kv_dtype == 3) return launch_decode<float, __nv_fp8_e4m3>(a, B, K, stream);
  if (kv_dtype == 4) return launch_decode<float, __nv_fp8_e5m2>(a, B, K, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch

// dtype (q and o): 0 = bfloat16, 1 = float32.  kv_dtype (k and v): the same
// as dtype, or a code type — 2 = int8, 3 = float8_e4m3fn, 4 = float8_e5m2 —
// which needs the fp32 scales ksc / vsc (else both null).  Strides are in
// elements.  `tables` may be null (dense cache); then k_sb / v_sb are batch
// strides, else page strides.  Scales are addressed ksc[b * sc_b + row * sc_p
// + kh * sc_k], row = the slot's page (paged; sc_b unused) or its slot /
// scale_page (dense).  One bf16 token (S == 1) over bf16 values or codes
// takes the split route: it needs `part`, fp32 scratch of B * H *
// ceil(T / split_chunk) * (D + 2) floats, and `tickets`, B * K *
// ceil(G / 16) ints that are 0 (the kernel leaves them 0); `split_chunk`
// must equal the compiled chunk.  S > 1 bf16 tokens over bf16 values or
// codes take the tensor-core mode.  A rank's share of a sequence-split cache
// (`blk_sub` > 0: the cache holds its slots l of the cache's slots
// (l / blk_sub) * blk_span + blk_phase + l % blk_sub; T counts the share's
// slots) runs every route over the share with the rows' live bounds in the
// share's slots, writes o as float32 (o's strides in floats) and each row's
// lse = m + log l to `lse` (float32, strides lse_sb per request and lse_ss
// per token, heads contiguous; -inf and o = 0 where a row sees no slot: the
// caller fills o with 0 and lse with -inf first, since the split route
// launches no block for a request with nothing live).  Both have their tiles compiled in (block_kv is not
// read).  *route is set to the route launched (2 split, 1 tensor cores, 0
// FMA; -1 none).  Returns the CUDA error code of the launch (0 = success).
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
    int window, float softcap, float scale, int block_kv, int pruned,
    void* part, void* tickets, int split_chunk,
    int blk_sub, int blk_span, int blk_phase, void* lse, long long lse_sb, long long lse_ss,
    int* route, void* stream) {
  using namespace repro_torch;
  *route = -1;
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
  if (blk_sub < 0 || (blk_sub > 0 && (lse == nullptr || blk_span < blk_sub || blk_phase < 0 ||
                                      blk_phase + blk_sub > blk_span)))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, o, static_cast<const int*>(index), static_cast<const int*>(tables),
               static_cast<const float*>(ksc), static_cast<const float*>(vsc),
               sc_b, sc_p, sc_k, scale_page,
               NB, page_size, S, T, H / K, D,
               q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
               window, softcap, scale, block_kv, pruned,
               static_cast<float*>(part), static_cast<int*>(tickets),
               Share{blk_sub, blk_span, blk_phase},
               blk_sub > 0 ? static_cast<float*>(lse) : nullptr, lse_sb, lse_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && S == 1) {
    if (part == nullptr || tickets == nullptr || split_chunk != kSplitChunk)
      return (int)cudaErrorInvalidValue;
    *route = 2;
    if (kv_dtype == 0) return (int)launch_decode_split_d<__nv_bfloat16>(a, B, K, s);
    if (kv_dtype == 2) return (int)launch_decode_split_d<int8_t>(a, B, K, s);
    if (kv_dtype == 3) return (int)launch_decode_split_d<__nv_fp8_e4m3>(a, B, K, s);
    return (int)launch_decode_split_d<__nv_fp8_e5m2>(a, B, K, s);
  }
  if (dtype == 0) {  // S > 1 bf16 tokens over bf16 values or codes
    *route = 1;
    if (kv_dtype == 0) return (int)launch_decode_tc_d<__nv_bfloat16>(a, B, H, s);
    if (kv_dtype == 2) return (int)launch_decode_tc_d<int8_t>(a, B, H, s);
    if (kv_dtype == 3) return (int)launch_decode_tc_d<__nv_fp8_e4m3>(a, B, H, s);
    return (int)launch_decode_tc_d<__nv_fp8_e5m2>(a, B, H, s);
  }
  *route = 0;
  if (kv_dtype == 1) return (int)launch_decode<float, float>(a, B, K, s);
  return (int)launch_decode_codes(a, kv_dtype, B, K, s);
}
