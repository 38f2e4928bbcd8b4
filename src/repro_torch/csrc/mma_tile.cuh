// Tensor-core tile layer shared by the bf16 routes of K1 and K2's widened q
// (attend_tc.cuh), K2's single-token split route (decode_split.cuh) and K3
// (flash_bwd.cu): warp-level mma.sync products of bf16 tiles held in shared
// memory, fed by cp.async copies and ldmatrix loads.
//
// Layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" with .bf16 inputs
// and .f32 accumulators, and "Warp-level matrix load instruction: ldmatrix";
// the CUDA toolkit's PTX documentation).  Within a warp, lane l is the pair
// (g, t) = (l / 4, l % 4):
//   A, 16 x 16, row-major, four .b32 registers of two bf16 each:
//     a0 (row g,   cols 2t, 2t+1)    a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g,   cols 2t+8, 2t+9)  a3 (row g+8, cols 2t+8, 2t+9)
//   B, 16 x 8 (k x n), two registers:
//     b0 (rows 2t, 2t+1 of column g)  b1 (rows 2t+8, 2t+9 of column g)
//   C / D, 16 x 8 fp32, four floats:
//     c0, c1 (row g, cols 2t, 2t+1)   c2, c3 (row g+8, cols 2t, 2t+1)
// The lower 16 bits of a register hold the element of the lower column (A)
// or row (B).  ldmatrix.x4 loads four 8 x 8 b16 matrices: lanes 8i..8i+7
// give the row addresses of matrix i, and register i of lane l receives row
// g, elements 2t and 2t+1 of matrix i (.trans: row 2t and 2t+1 of column g),
// which is exactly one A or B register above.
//
// So C's n-tiles 2j and 2j+1 of one product, split into three bf16 parts,
// are A fragments of k-slice j of the next product whose products add up to
// the fp32 one (`c_to_a_parts`): probabilities and score gradients go from
// one mma into the next without leaving registers.
//
// Shared tiles are bf16 rows of CH 16-byte chunks (8 elements), unpadded.
// Chunk c of row r lives at chunk c ^ (r % 8) (`swz`): the eight rows that
// one ldmatrix matrix reads (consecutive, starting at a multiple of 8) then
// fall into eight different bank groups, and so do the eight 16-byte
// cp.async writes of a row's first eight chunks.  CH must be a multiple of
// 8 (head dims 64, 128, 256).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of chunk `chunk` of row `row` in a swizzled tile.
template <int CH>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(CH % 8 == 0, "a swizzled row holds a multiple of 8 chunks");
  return row * (CH * 8) + ((chunk ^ (row & 7)) << 3);
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared without registers.  With `valid` false nothing
// is read (src-size 0) and the destination is zero-filled.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy R rows of a bf16 tile (row r at src + r * stride, D elements) into a
// swizzled shared tile of CH chunks per row.  Rows r >= nvalid and chunks
// past D are zero-filled, so ragged tails and a padded head dim read as 0.
template <int R, int CH, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int64_t stride,
                                                int nvalid, int D) {
#pragma unroll 4
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < nvalid && c * 8 < D;
    cp_async16(dst + swz<CH>(r, c), ok ? src + (int64_t)r * stride + c * 8 : src, ok);
  }
}

// ---------------------------------------------------------------------------
// ldmatrix
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment of the 16 x 16 block at rows row0.., chunks chunk0,
// chunk0 + 1 of a row-major tile (lanes 0-15 address rows 0-15 of chunk0,
// lanes 16-31 the same rows of chunk0 + 1).
template <int CH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0,
                                       int chunk0, int lane) {
  ldsm_x4(a, tile + swz<CH>(row0 + (lane & 15), chunk0 + (lane >> 4)));
}

// B fragments of two n-tiles (rows n0..n0+15 of the tile) over one k-slice
// (chunks chunk0, chunk0 + 1) of a tile stored [n][k] — K for Q K^T, Q for
// K Q^T: b[0], b[1] are n-tile 0's b0, b1 and b[2], b[3] n-tile 1's.
template <int CH>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile, int n0,
                                          int chunk0, int lane) {
  ldsm_x4(b, tile + swz<CH>(n0 + (lane & 7) + ((lane >> 4) << 3),
                            chunk0 + ((lane >> 3) & 1)));
}

// B fragments of two n-tiles (chunks chunk0, chunk0 + 1, i.e. columns
// 8 chunk0 .. 8 chunk0 + 15) over the k-slice rows k0..k0+15 of a tile
// stored [k][n] — V for P V, K for dS K, dO for P^T dO, Q for dS^T Q —
// through the transposing load.
template <int CH>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile, int k0,
                                          int chunk0, int lane) {
  ldsm_x4_trans(b, tile + swz<CH>(k0 + (lane & 15), chunk0 + (lane >> 4)));
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16, bf16 inputs, fp32 accumulators: d += a b
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C fragments of n-tiles 2j (c0) and 2j + 1 (c1) as the A fragments of
// k-slice j of the next product, split into NP bf16 parts whose sum is each
// value x: part j is the top 16 bits — a bf16 — of what parts 0..j-1 left
// of x, and every subtraction is exact.  Three parts carry x's 24
// significant bits whole; `mma_parts_add` feeds them to NP products.
template <int NP>
__device__ __forceinline__ void c_to_a_parts(uint32_t (&a)[NP][4], const float (&c0)[4],
                                             const float (&c1)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* c = i < 2 ? c0 : c1;
    float x = c[2 * (i & 1)], y = c[2 * (i & 1) + 1];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const uint32_t xb = __float_as_uint(x) & 0xffff0000u;
      const uint32_t yb = __float_as_uint(y) & 0xffff0000u;
      a[j][i] = __byte_perm(xb, yb, 0x7632);  // x's bf16 low, y's high
      x -= __uint_as_float(xb);
      y -= __uint_as_float(yb);
    }
  }
}

// d += a b, through a product of its own that starts from zero and is then
// added to d in IEEE fp32.  The tensor cores align the 16 products of one
// mma and its accumulator to their largest exponent and truncate what falls
// below fp32's last bit: fed a running sum many times its products (an
// output summed over a long walk), they drop those products' low bits with
// the same sign every time.  Summed apart, a product loses bits only against
// its own 16 terms, and the running sum rounds to nearest.
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b0, b1);
  d[0] += t[0]; d[1] += t[1]; d[2] += t[2]; d[3] += t[3];
}

// d += (sum over the parts of a) b: the parts' products summed apart,
// smallest part first, then added to d (as mma_add).
template <int NP>
__device__ __forceinline__ void mma_parts_add(float (&d)[4], const uint32_t (&a)[NP][4],
                                              uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = NP - 1; j >= 0; --j) mma(t, a[j], b0, b1);
  d[0] += t[0]; d[1] += t[1]; d[2] += t[2]; d[3] += t[3];
}

// Reduce a per-row value over the four lanes (t = 0..3) that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -inf: a masked score, and the running max of a row that has seen none.
__device__ __forceinline__ float neg_inf() { return __int_as_float((int)0xff800000u); }

// Store two adjacent fp32 values as bf16 (4-byte aligned: even column).
__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

}  // namespace tc
}  // namespace repro_torch
