// Tensor-core attention body of K1's bf16 route (flash_prefill.cu) and of
// K2's widened-q mode (flash_decode.cu) over bf16 values or int8 / fp8
// codes: one block of up to 64 q rows walks 64-row K / V tiles, every
// product a warp-level mma.sync m16n8k16 (mma_tile.cuh).
//
// The q tile and a two-stage ring of K / V tiles live in shared memory as
// unpadded swizzled bf16 (160 KB at D = 256); the next tile's cp.async copy
// is in flight while the current one is multiplied.  S = Q K^T stays in
// registers; scale, softcap and mask are applied to the fragments (the mask
// only in a tile that crosses some row's live range), the row max and sum
// are reduced over the four lanes of a row, and P goes from the S fragments
// straight into P V as kTcParts A fragments, the exact bf16 parts of its
// fp32 value.  Every product is summed apart from its running sum and added
// in IEEE fp32 (`mma_add`): the tensor cores truncate a sum they are given
// to add to.  The softmax is the plain version's own arithmetic
// (p = exp(s - m), m = -inf while a row has seen nothing, true division at
// the end), so the route keeps fp32's accuracy.
//
// Over codes (`Tiles::kCodes`: a quantized cache, one fp32 scale per page
// or dense scale row and KV head) the ring holds each tile's raw code bytes
// and their per-slot scales instead (two stages of 2 x 64 x DP bytes + 512
// B), and one bf16 K / V tile beside it: once a tile's codes have landed,
// the block widens them into that tile exactly (every int8, e4m3 and e5m2
// code is a bf16), while the next tile's codes are in flight.  The scales
// are factored out of the products, as the split route does
// (decode_split.cuh): score j is multiplied by its K scale x 1/sqrt(D) in
// fp32, p_j by its V scale before the parts split, and l sums the unscaled
// p.  Shared memory: 80 / 160 KB at D 128 / 256 over values, 81 / 161 KB
// over codes.
//
// Four warps own 16 q rows each.  At D = 256 a second set of four warps
// takes the upper 128 output columns (recomputing the same S rows), so a
// thread holds 64 output sums and nothing spills.
//
// A q row's result depends only on its q values, its live slot range and
// the K / V values (codes and scales) of the tiles it is walked over —
// never on the other rows of its block, on which tiles outside its range
// the block also walks (a fully masked tile leaves m, l and the sums as
// they were), or on whether a slot outside every row's range was read or
// zero-filled.  So a row computes the same bits in either kernel: the
// suffix of a prompt attended by K2 over a page pool equals the same rows
// of K1 over the whole prompt, and over codes the same rows of K2 over the
// whole prompt at index 0.
//
// `Rows` gives the block's q rows (q, q_ss, o, o_ss, nrows), each row's live
// slots lo(r) <= kp < hi(r) (both non-decreasing in r) and store_lse; `Tiles`
// issues the cp.async copies of tile jb's K and V slots, zero-filling any
// slot it must not read (over codes: the codes and their scales, and
// `widen` turns a landed stage into the bf16 tiles).
#pragma once

#include "attend_core.cuh"
#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kTcQ = 64;     // q rows per block
constexpr int kTcKV = 64;    // KV rows per tile
constexpr int kTcParts = 3;  // bf16 parts of P in P V

// Tiles of the body at padded head dim DP (64, 128 or 256).
template <int DP>
struct TcShape {
  static constexpr int NS = DP > 128 ? 2 : 1;  // warp sets over the output's columns
  static constexpr int NW = kTcQ / 16 * NS;    // warps
  static constexpr int NT = NW * 32;
  static constexpr int BQ = kTcQ;
  static constexpr int BKV = kTcKV;
  static constexpr int CH = DP / 8;            // 16-byte chunks per row
  // q tile + two stages of (K, V)
  static constexpr size_t smem = (size_t)(BQ + 4 * BKV) * DP * sizeof(__nv_bfloat16);
  // over codes: a stage of the code ring (K and V codes, then their K and V
  // scales), and the q tile + one bf16 (K, V) + two code stages
  static constexpr size_t CODE_STAGE = (size_t)2 * BKV * DP + 2 * BKV * sizeof(float);
  static constexpr size_t smem_codes =
      (size_t)(BQ + 2 * BKV) * DP * sizeof(__nv_bfloat16) + 2 * CODE_STAGE;
};

// Walks KV tiles [walk_begin, walk_end), computing those in [lo, hi) and
// only streaming the others (the unpruned baseline).
template <int DP, class Rows, class Tiles>
__device__ __forceinline__ void tc_attend(const Rows& rows, const Tiles& tiles, int D,
                                          int walk_begin, int walk_end, int lo, int hi,
                                          float scale, float softcap) {
  using namespace tc;
  using Sh = TcShape<DP>;
  constexpr int BQ = Sh::BQ, BKV = Sh::BKV, CH = Sh::CH, NT = Sh::NT;
  constexpr int NKT = BKV / 8, NDT = DP / 8 / Sh::NS;  // n-tiles of S, d-tiles of a warp's o
  constexpr bool CODES = Tiles::kCodes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  // values: stage s's K at ring + 2 s BKV DP, V after it; codes: the
  // widened K and V tiles, then the code ring at `cring`
  bf16* ring = qs + BQ * DP;
  unsigned char* cring = reinterpret_cast<unsigned char*>(ring + 2 * BKV * DP);

  load_tile_async<BQ, CH, NT>(qs, rows.q, rows.q_ss, rows.nrows, D);
  cp_async_commit();
  auto load_kv = [&](int jb, int stage) {
    if constexpr (CODES) {
      tiles.template load<BKV, CH, NT>(cring + stage * Sh::CODE_STAGE, jb, D);
    } else {
      bf16* ks = ring + stage * 2 * BKV * DP;
      tiles.template load<BKV, CH, NT>(ks, ks + BKV * DP, jb, D);
    }
    cp_async_commit();
  };
  if (walk_begin < walk_end) load_kv(walk_begin, 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp % (BQ / 16), cs = warp / (BQ / 16);  // row group, column set
  const int g = lane >> 2, t = lane & 3;
  // this thread's two rows, rw * 16 + g and + 8, and the tile range in which
  // every row of the block sees every slot
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lo[i] = rows.lo(rw * 16 + g + 8 * i);
    row_hi[i] = rows.hi(rw * 16 + g + 8 * i);
  }
  const int all_lo = rows.lo(BQ - 1), all_hi = rows.hi(0);
  float o[NDT][4];
#pragma unroll
  for (int d = 0; d < NDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  // one live tile: its K / V in shared memory as bf16 (and, over codes, its
  // per-slot K and V scales)
  auto attend_tile = [&](const bf16* ks, const bf16* vs, const float* ksc, const float* vsc,
                         int jb) {
    // S = Q K^T, 16 x 64 per warp
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; c += 2) {
      uint32_t qa[4];
      load_a<CH>(qa, qs, rw * 16, c, lane);
#pragma unroll
      for (int n = 0; n < NKT; n += 2) {
        uint32_t kf[4];
        load_b_nk<CH>(kf, ks, n * 8, c, lane);
        mma_add(s[n], qa, kf[0], kf[1]);
        mma_add(s[n + 1], qa, kf[2], kf[3]);
      }
    }
    // scale (times the slot's K scale over codes), softcap and mask, then
    // the online softmax in the plain version's own arithmetic:
    // p = exp(s - m), m -inf while a row has seen nothing
    const int k_start = jb * BKV;
    const bool edge = k_start < all_lo || k_start + BKV > all_hi;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float val;
        if constexpr (CODES) {
          val = s[n][e] * (ksc[n * 8 + 2 * t + (e & 1)] * scale);
        } else {
          val = s[n][e] * scale;
        }
        if (softcap > 0.f) val = tanhf(val / softcap) * softcap;
        if (edge) {
          const int kp = k_start + n * 8 + 2 * t + (e & 1);
          if (kp < row_lo[i] || kp >= row_hi[i]) val = neg_inf();
        }
        s[n][e] = val;
        mx[i] = fmaxf(mx[i], val);
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
        // over codes the V scale joins p before the parts split; l keeps p
        if constexpr (CODES) {
          s[n][e] = p * vsc[n * 8 + 2 * t + (e & 1)];
        } else {
          s[n][e] = p;
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int d = 0; d < NDT; ++d) {
      o[d][0] *= alpha[0]; o[d][1] *= alpha[0];
      o[d][2] *= alpha[1]; o[d][3] *= alpha[1];
    }
    // O += P V over this warp's column set, P split into bf16 fragments
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      uint32_t pa[kTcParts][4];
      c_to_a_parts<kTcParts>(pa, s[2 * kt], s[2 * kt + 1]);
#pragma unroll
      for (int d = 0; d < NDT; d += 2) {
        uint32_t vf[4];
        load_b_kn<CH>(vf, vs, kt * 16, cs * NDT + d, lane);
        mma_parts_add<kTcParts>(o[d], pa, vf[0], vf[1]);
        mma_parts_add<kTcParts>(o[d + 1], pa, vf[2], vf[3]);
      }
    }
  };

  for (int jb = walk_begin, it = 0; jb < walk_end; ++jb, ++it) {
    if constexpr (CODES) {
      cp_async_wait<0>();
      __syncthreads();  // tile jb's codes have landed; every warp is done with tile jb - 1
      // the next tile's codes go into the stage tile jb - 1 used
      if (jb + 1 < walk_end) load_kv(jb + 1, (it + 1) & 1);
      if (jb >= lo && jb < hi) {
        const unsigned char* st = cring + (it & 1) * Sh::CODE_STAGE;
        tiles.template widen<BKV, CH, NT>(ring, ring + BKV * DP, st);
        __syncthreads();  // the bf16 tiles are whole
        const float* ksc = reinterpret_cast<const float*>(st + 2 * BKV * DP);
        attend_tile(ring, ring + BKV * DP, ksc, ksc + BKV, jb);
      }
    } else {
      if (jb + 1 < walk_end) {
        load_kv(jb + 1, (it + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (jb >= lo && jb < hi) {
        const bf16* ks = ring + (it & 1) * 2 * BKV * DP;
        attend_tile(ks, ks + BKV * DP, nullptr, nullptr, jb);
      }
      __syncthreads();  // the next copy overwrites this stage
    }
  }
  cp_async_wait<0>();  // an empty walk leaves the q copy in flight

  // out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)), m = -1e30 for a
  // row that saw no key
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = fmaxf(quad_sum(l[i]), 1e-30f);
    const int r = rw * 16 + g + 8 * i;
    if (r < rows.nrows) {
      bf16* orow = rows.o + (int64_t)r * rows.o_ss;
#pragma unroll
      for (int d = 0; d < NDT; ++d) {
        const int col = (cs * NDT + d) * 8 + 2 * t;
        if (col < D) store_bf16x2(orow + col, o[d][2 * i] / denom, o[d][2 * i + 1] / denom);
      }
      if (cs == 0 && t == 0) rows.store_lse(r, (m[i] == neg_inf() ? kNegInf : m[i]) + logf(denom));
    }
  }
}

}  // namespace repro_torch
