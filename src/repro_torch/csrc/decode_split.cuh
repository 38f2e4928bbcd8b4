// K2's single-token step on the tensor cores, with the KV walk split into
// fixed chunks of logical slots (flash_decode.cu's route 2, "tc_split").
//
// Replaces, for one new token with a bf16 q over bf16 values or over the
// int8 / fp8 (e4m3, e5m2) codes of a quantized cache, the reference's
// `_flash_decode_kernel` (src/repro/kernels/flash_attention/decode.py
// :182-274): per-request `index`, live tiles [lo, hi) and the boundary
// kp < clip(index + 1, 1, T), sliding window on linear caches, ring caches,
// softcap, paged pools through block tables, one fp32 scale per page (or
// dense scale row) and KV head, a fully masked row giving 0, and the
// unpruned baseline that streams every tile and computes only the live ones.
//
// Bound on an H100: bytes.  Every live K and V slot is read once (2 bytes an
// element for values, 1 for codes, plus one fp32 scale per slot and tensor);
// the G q rows and the output are noise beside that, and the G-row products
// are ~G flops a byte, far under the card's ~295.
//
// Design.
// - Chunks.  The cache's logical slots are cut into chunks of kSplitChunk
//   slots (a multiple of the schedule's 64-slot tile), counted from slot 0.
//   The chunk does not depend on B, on K, on the card's SM count or on
//   whether the cache is paged: a request's rows keep their bits when a
//   batch admits or retires its neighbours, and every mask and address
//   stays in logical slot space, so a paged and a dense cache of the same
//   values give the same bits.  Grid (chunks of T, K x row tiles, B); a
//   block whose chunk holds none of its request's walked tiles exits at
//   once.
// - Rows.  The G q heads of one KV head are the rows of one m16 tile
//   (padding rows zero; G > 16 takes more row tiles).  The block's four
//   warps split the chunk, not the rows: the chunk is cut into steps of BT
//   slots (2048 / DP, at least 16: 32, 16, 16 at padded head dim 64, 128,
//   256, so that a step's K and V are 8 KB of bf16, 16 KB at 256) and step
//   j goes to warp j % 4.  Each warp keeps its own m, l and fp32 sums over
//   its steps; the four are merged in shared memory in warp order.
// - Pipeline.  Each warp streams its steps through its own ring of
//   kSplitStages cp.async stages.  Little's law: the card's 3.35 TB/s over
//   132 SMs is ~25 bytes a ns an SM; at ~1 us of memory latency under load
//   an SM needs ~25 KB in flight.  Two stages of 8 KB (values) or 4 KB
//   (codes) a warp keep 64 / 32 KB in flight a block — at D >= 128 a warp
//   has at most two steps of a chunk, so both are in flight from the start
//   — and a block's 68 KB of shared memory (136 KB at D 256) lets three
//   blocks share an SM (one at D 256): in flight ~2-8x the need, and one
//   block's loads overlap another's merge and combine.
//   (tools/decode_chunk_variants.py measures three stages, longer steps and
//   chunks of 256 to 1024 slots against this.)
// - Products.  S = q K^T and P V are mma.sync m16n8k16 over bf16 fragments
//   (mma_tile.cuh); P enters P V as kTcParts exact bf16 parts and every
//   product is summed from zero and added in IEEE fp32, as K1's body does
//   (attend_tc.cuh), so the route keeps fp32's accuracy.
// - Codes.  Every int8, e4m3 and e5m2 code is exact in bf16.  A step's
//   codes land in shared memory as they are (the codes' own bytes), and the
//   warp widens them into the same bf16 tiles the values use.  The scales
//   are factored out of the products: score column j (one slot) is
//   multiplied by its K scale times 1/sqrt(D) in fp32 before the softmax,
//   and p_j by its V scale in fp32 before the parts split (the denominator
//   l takes the unscaled p).  A slot's scale is read per slot:
//   table[slot / page_size] when paged, row slot / scale_page when dense,
//   so any page size works and paged and dense read the same value.
// - A rank's share.  Under a sequence split the cache holds the rank's
//   slots (`Share`): the walk is the same over them, only each row's live
//   bounds are the share's, and the call writes fp32 o with each row's lse
//   for the ranks' merge.  A request with nothing live on the rank launches
//   no block; its o = 0 and lse = -inf are the wrapper's fill.
// - Combine.  A chunk's unnormalised (m, l, acc) go to fp32 scratch that
//   the wrapper allocates; the last block of a (request, KV head, row tile)
//   to finish — an atomic ticket, which that block resets for the next call
//   — combines the chunks in chunk order and writes o.  No atomic touches
//   the arithmetic, so two calls give the same bits.  A request whose walk
//   is one chunk writes o directly: the combine of one chunk gives the same
//   bits.
#pragma once

#include <type_traits>

#include "attend_core.cuh"
#include "mma_tile.cuh"

namespace repro_torch {

// A rank's share of the cache's slots under a sequence split (its slot l holds
// the cache's slot (l / sub) * span + phase + l % sub; sub == 0: the whole
// cache).  The walk, the tiles and the pages stay in the rank's own slot
// space; only a row's live bounds change: on a whole cache the reference's
// clip(p + 1, 1, T), on a share the count of its slots that hold slots <= p
// (0 where none does: the row sees nothing, o = 0 and lse = -inf).
struct Share {
  int sub, span, phase;
  // the share's slots holding cache slots <= x
  __device__ __forceinline__ int count(int x) const {
    if (x < 0) return 0;
    const int q = x / span, rem = x - q * span;
    return q * sub + min(max(rem - phase + 1, 0), sub);
  }
  // one past the last slot a row at position p sees, of T
  __device__ __forceinline__ int hi(int p, int T) const {
    return sub > 0 ? min(T, count(p)) : max(1, min(T, p + 1));
  }
  // the first slot it sees under a window (negative on a whole cache)
  __device__ __forceinline__ int lo(int p, int window) const {
    if (window <= 0) return 0;
    return sub > 0 ? count(p - window) : p - window + 1;
  }
};

constexpr int kSplitChunk = 128;  // logical slots of a chunk (decode.py SPLIT_CHUNK)
constexpr int kSplitTile = 64;    // slots of a schedule tile (decode_schedule at 64)
constexpr int kSplitWarps = 4;
constexpr int kSplitStages = 2;   // cp.async ring of a warp
constexpr int kSplitStep = 2048;  // K elements of a step (BT x DP), BT >= 16
constexpr int kSplitRows = 16;    // q rows of a block: one m16 tile

template <int DP, bool CODES>
struct SplitShape {
  static constexpr int CH = DP / 8;      // 8-element chunks of a row
  static constexpr int BT = kSplitStep / DP > 16 ? kSplitStep / DP : 16;  // slots of a step
  static constexpr int NT = kSplitWarps * 32;
  static constexpr int TILE = BT * DP;   // elements of a step's K (or V)
  static constexpr int STAGE = (CODES ? 2 : 4) * TILE;  // bytes of a stage's K and V
  static constexpr int SCALES = CODES ? 2 * BT * 4 : 0;  // its K and V scales
  // a warp's region: the ring and, for codes, the bf16 K / V a step is
  // widened into; after the walk it holds the warp's m, l and sums
  static constexpr int WARP = kSplitStages * (STAGE + SCALES) + (CODES ? 4 * TILE : 0);
  static constexpr int OSTRIDE = DP + 8;  // floats of a merge row (float2 stores conflict-free)
  static constexpr size_t smem = (size_t)kSplitRows * DP * 2 + (size_t)kSplitWarps * WARP;
  static_assert(BT % 16 == 0 && kSplitChunk % kSplitTile == 0 && kSplitChunk % BT == 0,
                "a chunk holds whole tiles and whole steps");
  static_assert((2 * kSplitRows + kSplitRows * OSTRIDE) * 4 <= WARP,
                "the merge fits a warp's region");
};

// Codes widened to bf16 exactly with integer and fp32 arithmetic only (the
// conversion instructions, I2F and F2F, issue at a quarter of the fp32 rate,
// and a step widens 4096 codes a warp).  `code_f32<C, i>(w)` is byte i of w
// as the fp32 value of its code:
// - int8: x + 128 as the low byte of 2^23's fp32 bits, less 2^23 + 128;
// - e4m3 (bias 7) / e5m2 (bias 15): the sign to bit 31, exponent and
//   mantissa just below fp32's exponent field (bit 20 / 21 on), then times
//   2^120 / 2^112 — exact for normal and subnormal codes alike (no flush to
//   zero without fast math).  The NaN / inf codes come out finite; a
//   quantized cache holds none (its codes are clamped to the format's max).
// Every code is exact in bf16, so the top 16 bits of its fp32 value are its
// bf16 (`bf16x2_top`).
template <typename C, int i>
__device__ __forceinline__ float code_f32(uint32_t w) {
  if constexpr (std::is_same<C, int8_t>::value) {
    const uint32_t u = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | i);
    return __uint_as_float(u) - 8388736.f;  // 2^23 + 128
  } else {
    constexpr bool E4M3 = std::is_same<C, __nv_fp8_e4m3>::value;
    const uint32_t v = __byte_perm(w, 0u, (i << 12) | 0x444);  // the code in bits 24-31
    const uint32_t bits = (v & 0x80000000u) |
                          (E4M3 ? (v >> 4) & 0x07F00000u : (v >> 3) & 0x0FE00000u);
    return __uint_as_float(bits) * (E4M3 ? 0x1p120f : 0x1p112f);
  }
}

__device__ __forceinline__ uint32_t bf16x2_top(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Eight codes (8 bytes of shared memory) widened to eight bf16, exactly.
template <typename C>
__device__ __forceinline__ uint4 codes_to_bf16x8(const unsigned char* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  uint4 out;
  out.x = bf16x2_top(code_f32<C, 0>(raw.x), code_f32<C, 1>(raw.x));
  out.y = bf16x2_top(code_f32<C, 2>(raw.x), code_f32<C, 3>(raw.x));
  out.z = bf16x2_top(code_f32<C, 0>(raw.y), code_f32<C, 1>(raw.y));
  out.w = bf16x2_top(code_f32<C, 2>(raw.y), code_f32<C, 3>(raw.y));
  return out;
}

// `Args` is flash_decode.cu's DecodeArgs (with its `part` and `tickets`).
template <int DP, typename TK, class Args>
__global__ void __launch_bounds__(kSplitWarps * 32, (DP > 128 ? 1 : 3))
flash_decode_split_kernel(Args a) {
  using namespace tc;
  constexpr bool CODES = IsCode<TK>::value;
  using Sh = SplitShape<DP, CODES>;
  constexpr int CH = Sh::CH, BT = Sh::BT, NT = Sh::NT, TILE = Sh::TILE;
  constexpr int CT = kSplitChunk / kSplitTile;  // tiles of a chunk
  constexpr int NKT = BT / 8;                   // n-tiles of a step's scores

  const int c = blockIdx.x, b = blockIdx.z;
  const int RT = (a.G + kSplitRows - 1) / kSplitRows;
  const int kh = blockIdx.y / RT, rt = blockIdx.y % RT;
  const int H = gridDim.y / RT * a.G, nc = gridDim.x;
  const int row0 = rt * kSplitRows, nrows = min(kSplitRows, a.G - row0);
  const int h0 = kh * a.G + row0;  // the head of row 0
  const int index = a.index[b];

  // the walked tiles, as the reference's schedule computes them (q_span 1),
  // and the chunks that hold them
  const int last_live = a.share.hi(index, a.T);
  const int hi_t = (last_live + kSplitTile - 1) / kSplitTile;
  int lo_t = 0;
  if (a.window > 0) lo_t = max(0, min(a.share.lo(index, a.window) / kSplitTile, hi_t - 1));
  const int c_begin = a.pruned ? lo_t / CT : 0;
  const int c_end = a.pruned ? (hi_t + CT - 1) / CT : nc;  // nc: the cache's chunks
  if (c < c_begin || c >= c_end) return;
  const int n_chunks = c_end - c_begin;

  // every row of one token sees the slots row_lo <= kp < row_hi; the walk
  // reads [slot_begin, slot_end) and zero-fills the rest
  const int row_lo = a.share.lo(index, a.window);
  const int row_hi = last_live;
  const int slot_begin = a.pruned ? max(0, row_lo) : 0;
  const int slot_end = a.pruned ? last_live : a.T;
  const int cs = c * kSplitChunk;  // the chunk's first slot
  // steps [j0, j1) of the chunk: pruned, those holding a readable slot;
  // unpruned, every step of the cache, computed only where a slot is live
  int j0 = 0, j1;
  if (a.pruned) {
    const int first = max(slot_begin, cs), end = min(slot_end, cs + kSplitChunk);
    j0 = (first - cs) / BT;
    j1 = end > first ? (end - cs + BT - 1) / BT : j0;
  } else {
    j1 = (min(a.T, cs + kSplitChunk) - cs + BT - 1) / BT;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* wbase = smem_raw + kSplitRows * DP * 2 + warp * Sh::WARP;

  // -- the q rows: heads h0 .. h0 + nrows - 1 of token 0 ----------------------
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + (int64_t)h0 * a.q_sh;
  for (int i = tid; i < kSplitRows * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r < nrows && ch * 8 < a.D;
    cp_async16(qs + swz<CH>(r, ch), ok ? qp + (int64_t)r * a.q_sh + ch * 8 : qp, ok);
  }
  cp_async_commit();

  // -- this warp's steps: j = jw, jw + 4, ... < j1 ------------------------------
  const int jw = j0 + ((warp - j0 % kSplitWarps) + kSplitWarps) % kSplitWarps;
  const int nsteps = jw < j1 ? (j1 - jw + kSplitWarps - 1) / kSplitWarps : 0;

  const bool paged = a.tables != nullptr;
  const int* table = paged ? a.tables + (int64_t)b * a.NB : nullptr;
  const TK* kp = static_cast<const TK*>(a.k) + (paged ? 0 : b * a.k_sb) + kh * a.k_sh;
  const TK* vp = static_cast<const TK*>(a.v) + (paged ? 0 : b * a.v_sb) + kh * a.v_sh;
  const int64_t sc_off = (paged ? 0 : b * a.sc_b) + kh * a.sc_k;
  const float* ksc = CODES ? a.ksc + sc_off : nullptr;
  const float* vsc = CODES ? a.vsc + sc_off : nullptr;

  auto stage_ptr = [&](int stage) { return wbase + stage * (Sh::STAGE + Sh::SCALES); };
  auto issue = [&](int j, int stage) {
    unsigned char* st = stage_ptr(stage);
    const int s0 = cs + j * BT;
#pragma unroll 4
    for (int i = lane; i < BT * CH; i += 32) {
      const int r = i / CH, ch = i % CH, slot = s0 + r;
      const bool ok = slot >= slot_begin && slot < slot_end && ch * 8 < a.D;
      int64_t ko = 0, vo = 0;
      if (ok) {
        if (paged) {
          const int64_t page = table[slot / a.page_size], at = slot % a.page_size;
          ko = page * a.k_sb + at * a.k_st;
          vo = page * a.v_sb + at * a.v_st;
        } else {
          ko = (int64_t)slot * a.k_st;
          vo = (int64_t)slot * a.v_st;
        }
      }
      if constexpr (CODES) {
        cp_async8(st + r * DP + ch * 8, ok ? kp + ko + ch * 8 : kp, ok);
        cp_async8(st + TILE + r * DP + ch * 8, ok ? vp + vo + ch * 8 : vp, ok);
      } else {
        bf16* ks = reinterpret_cast<bf16*>(st);
        cp_async16(ks + swz<CH>(r, ch), ok ? kp + ko + ch * 8 : kp, ok);
        cp_async16(ks + TILE + swz<CH>(r, ch), ok ? vp + vo + ch * 8 : vp, ok);
      }
    }
    if constexpr (CODES) {
      float* sc = reinterpret_cast<float*>(st + Sh::STAGE);
      for (int r = lane; r < BT; r += 32) {
        const int slot = s0 + r;
        const bool ok = slot >= slot_begin && slot < slot_end;
        const int64_t row = !ok ? 0 : paged ? (int64_t)table[slot / a.page_size]
                                            : (int64_t)(slot / a.scale_page);
        cp_async4(sc + r, ok ? ksc + row * a.sc_p : ksc, ok);
        cp_async4(sc + BT + r, ok ? vsc + row * a.sc_p : vsc, ok);
      }
    }
  };

  // the ring's first steps in flight, one commit group a stage (empty past
  // the warp's last step, so that the count of groups stays uniform)
#pragma unroll
  for (int p = 0; p < kSplitStages - 1; ++p) {
    if (p < nsteps) issue(jw + p * kSplitWarps, p);
    cp_async_commit();
  }
  cp_async_wait<kSplitStages - 1>();  // the q copy has landed
  __syncthreads();

  float o[CH][4];
#pragma unroll
  for (int d = 0; d < CH; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  for (int k = 0; k < nsteps; ++k) {
    const int j = jw + k * kSplitWarps;
    const int ahead = k + kSplitStages - 1;  // into the stage step k - 1 used
    if (ahead < nsteps) issue(jw + ahead * kSplitWarps, ahead % kSplitStages);
    cp_async_commit();
    cp_async_wait<kSplitStages - 1>();  // step k has landed
    __syncwarp();
    const int s0 = cs + j * BT;
    if (s0 >= row_hi || s0 + BT <= row_lo) {  // streamed only (the unpruned baseline)
      __syncwarp();
      continue;
    }
    const unsigned char* st = stage_ptr(k % kSplitStages);
    const bf16* ks;
    const float* sc = reinterpret_cast<const float*>(st + Sh::STAGE);
    if constexpr (CODES) {
      // widen the codes into this warp's bf16 K / V tiles
      bf16* kb = reinterpret_cast<bf16*>(wbase + kSplitStages * (Sh::STAGE + Sh::SCALES));
#pragma unroll 4
      for (int i = lane; i < BT * CH; i += 32) {
        const int r = i / CH, ch = i % CH;
        *reinterpret_cast<uint4*>(kb + swz<CH>(r, ch)) = codes_to_bf16x8<TK>(st + r * DP + ch * 8);
        *reinterpret_cast<uint4*>(kb + TILE + swz<CH>(r, ch)) =
            codes_to_bf16x8<TK>(st + TILE + r * DP + ch * 8);
      }
      __syncwarp();
      ks = kb;
    } else {
      ks = reinterpret_cast<const bf16*>(st);
    }
    const bf16* vs = ks + TILE;

    // S = q K^T, 16 x BT, over the head dim's live k-slices
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ch = 0; ch < CH; ch += 2) {
      if (ch * 8 < a.D) {
        uint32_t qa[4];
        load_a<CH>(qa, qs, 0, ch, lane);
#pragma unroll
        for (int n = 0; n < NKT; n += 2) {
          uint32_t kf[4];
          load_b_nk<CH>(kf, ks, n * 8, ch, lane);
          mma_add(s[n], qa, kf[0], kf[1]);
          mma_add(s[n + 1], qa, kf[2], kf[3]);
        }
      }
    }
    // scale (times the slot's K scale for codes), softcap, mask; then the
    // online softmax of attend_tc.cuh: p = exp(s - m), m -inf while a row
    // has seen nothing
    const bool edge = s0 < row_lo || s0 + BT > row_hi;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float val = s[n][e] * (CODES ? sc[col] * a.scale : a.scale);
        if (a.softcap > 0.f) val = tanhf(val / a.softcap) * a.softcap;
        if (edge && (s0 + col < row_lo || s0 + col >= row_hi)) val = neg_inf();
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], m_use[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      m_use[i] = m_new == neg_inf() ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_use[e >> 1]);
        rs[e >> 1] += p;
        // codes: the V scale joins p before the parts split; l keeps p
        s[n][e] = CODES ? p * sc[BT + n * 8 + 2 * t + (e & 1)] : p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int d = 0; d < CH; ++d) {
      o[d][0] *= alpha[0]; o[d][1] *= alpha[0];
      o[d][2] *= alpha[1]; o[d][3] *= alpha[1];
    }
    // O += P V over the head dim's live column tiles
#pragma unroll
    for (int kt = 0; kt < BT / 16; ++kt) {
      uint32_t pa[kTcParts][4];
      c_to_a_parts<kTcParts>(pa, s[2 * kt], s[2 * kt + 1]);
#pragma unroll
      for (int d = 0; d < CH; d += 2) {
        if (d * 8 < a.D) {
          uint32_t vf[4];
          load_b_kn<CH>(vf, vs, kt * 16, d, lane);
          mma_parts_add<kTcParts>(o[d], pa, vf[0], vf[1]);
          mma_parts_add<kTcParts>(o[d + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncwarp();  // the next copy overwrites this stage
  }
  cp_async_wait<0>();
  __syncwarp();

  // -- this warp's rows into its region: m, l (summed over the row's four
  //    lanes) and the sums ----------------------------------------------------
  float* mw = reinterpret_cast<float*>(wbase);
  float* lw = mw + kSplitRows;
  float* ow = lw + kSplitRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (t == 0) {
      mw[g + 8 * i] = m[i];
      lw[g + 8 * i] = lsum;
    }
  }
#pragma unroll
  for (int d = 0; d < CH; ++d) {
    if (d * 8 < a.D) {
      *reinterpret_cast<float2*>(ow + g * Sh::OSTRIDE + d * 8 + 2 * t) =
          make_float2(o[d][0], o[d][1]);
      *reinterpret_cast<float2*>(ow + (g + 8) * Sh::OSTRIDE + d * 8 + 2 * t) =
          make_float2(o[d][2], o[d][3]);
    }
  }
  __syncthreads();

  // -- the chunk: the four warps merged in warp order ---------------------------
  const float* wm[kSplitWarps];
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w)
    wm[w] = reinterpret_cast<const float*>(smem_raw + kSplitRows * DP * 2 + w * Sh::WARP);
  // a share's call writes fp32 o and each row's lse = m + log l (-inf where
  // the row saw nothing); a whole cache's, bf16 o
  const bool share = a.share.sub > 0;
  const int64_t o_off = b * a.o_sb + (int64_t)h0 * a.o_sh;
  bf16* op = static_cast<bf16*>(a.o) + o_off;
  float* op32 = static_cast<float*>(a.o) + o_off;
  float* lsep = share ? a.lse + (int64_t)b * a.lse_sb + h0 : nullptr;
  float* part_o = a.part;                             // (B, H, nc, D)
  float* part_ml = a.part + (int64_t)gridDim.z * H * nc * a.D;  // (B, H, nc, 2)
  for (int i = tid; i < nrows * a.D; i += NT) {
    const int r = i / a.D, d = i - r * a.D;
    float M = neg_inf();
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, wm[w][r]);
    const float Mu = M == neg_inf() ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float e = expf(wm[w][r] - Mu);
      L += wm[w][kSplitRows + r] * e;
      A += wm[w][2 * kSplitRows + r * Sh::OSTRIDE + d] * e;
    }
    if (n_chunks == 1) {
      if (share) {
        op32[(int64_t)r * a.o_sh + d] = A / fmaxf(L, 1e-30f);
        if (d == 0) lsep[r] = L > 0.f ? Mu + logf(L) : neg_inf();
      } else {
        op[(int64_t)r * a.o_sh + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
      }
    } else {
      const int64_t row = ((int64_t)b * H + h0 + r) * nc + c;
      part_o[row * a.D + d] = A;
      if (d == 0) {
        part_ml[2 * row] = M;
        part_ml[2 * row + 1] = L;
      }
    }
  }
  if (n_chunks == 1) return;

  // -- the last block of this (request, KV head, row tile) combines ------------
  __shared__ int is_last;
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  int* ticket = a.tickets + (int64_t)b * gridDim.y + blockIdx.y;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == n_chunks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // per row: M over the chunks, then L = sum of l exp(m - M) in chunk order
  float* Ms = reinterpret_cast<float*>(smem_raw + kSplitRows * DP * 2);  // free now
  float* Ls = Ms + kSplitRows;
  const float2* ml = reinterpret_cast<const float2*>(part_ml);
  const int64_t row0_ml = ((int64_t)b * H + h0) * nc + c_begin;  // row r at + r * nc
  if (tid < nrows) {
    const float2* p = ml + row0_ml + (int64_t)tid * nc;
    float M = neg_inf();
#pragma unroll 8
    for (int cc = 0; cc < n_chunks; ++cc) M = fmaxf(M, __ldcg(p + cc).x);
    const float Mu = M == neg_inf() ? 0.f : M;
    float L = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float2 x = __ldcg(p + cc);
      L += x.y * expf(x.x - Mu);
    }
    Ms[tid] = Mu;
    Ls[tid] = fmaxf(L, 1e-30f);
    if (share) lsep[tid] = L > 0.f ? Mu + logf(L) : neg_inf();
  }
  __syncthreads();
  // o = (sum of acc exp(m - M) in chunk order) / L, four columns a thread
  const int D4 = a.D / 4;
  for (int i = tid; i < nrows * D4; i += NT) {
    const int r = i / D4, d4 = i - r * D4;
    const int64_t row = row0_ml + (int64_t)r * nc;
    const float4* src = reinterpret_cast<const float4*>(part_o + row * a.D) + d4;
    const float Mu = Ms[r];
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float e = expf(__ldcg(ml + row + cc).x - Mu);
      const float4 x = __ldcg(src + (int64_t)cc * D4);
      A.x += x.x * e; A.y += x.y * e; A.z += x.z * e; A.w += x.w * e;
    }
    const float L = Ls[r];
    if (share) {
      float* dst = op32 + (int64_t)r * a.o_sh + 4 * d4;
      dst[0] = A.x / L; dst[1] = A.y / L; dst[2] = A.z / L; dst[3] = A.w / L;
    } else {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(op + (int64_t)r * a.o_sh + 4 * d4);
      dst[0] = __floats2bfloat162_rn(A.x / L, A.y / L);
      dst[1] = __floats2bfloat162_rn(A.z / L, A.w / L);
    }
  }
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
}

template <int DP, typename TK, class Args>
static cudaError_t launch_decode_split(const Args& a, int B, int K, cudaStream_t stream) {
  using Sh = SplitShape<DP, IsCode<TK>::value>;
  const int RT = (a.G + kSplitRows - 1) / kSplitRows;
  dim3 grid((a.T + kSplitChunk - 1) / kSplitChunk, K * RT, B);
  return launch_with_smem(flash_decode_split_kernel<DP, TK, Args>, grid, dim3(Sh::NT), Sh::smem,
                          stream, a);
}

// The split route at the padded head dim of `a.D` (64, 128 or 256).
template <typename TK, class Args>
static cudaError_t launch_decode_split_d(const Args& a, int B, int K, cudaStream_t stream) {
  if (a.D <= 64) return launch_decode_split<64, TK>(a, B, K, stream);
  if (a.D <= 128) return launch_decode_split<128, TK>(a, B, K, stream);
  return launch_decode_split<256, TK>(a, B, K, stream);
}

}  // namespace repro_torch
