// K5's slab walk fed by 1D bulk copies: a variant of
// `src/repro_torch/csrc/rglru.cu` kept for `tools/rglru_variants.py`, which
// builds it alone at every slab, tile and ring depth it sweeps, holds it to
// the baseline bit for bit, and times it beside the shipped cp.async feed.
// It is not part of the kernel library.
//
// The same blocks, ring, mbarrier hand-offs and walk as the shipped kernel;
// only the feed differs.  The producer warp fills a stage with one
// `cp.async.bulk` a 64-byte tile row of a and of b, completing on the stage's
// `full` mbarrier by bytes, and the storer warp writes the walked tile back
// with one bulk store a row.  On an H100 this feed moves ~0.5 TB/s at the
// main shape (one request a row), against ~2.4 TB/s for cp.async.  A D that
// is no multiple of 4 (or an operand not 16-byte aligned) takes the shipped
// kernel's walk fed by 4-byte cp.async copies.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"  // from src/repro_torch/csrc

namespace repro_torch {

constexpr int kLruSlab = 16;      // channels a block: one walker lane each
constexpr int kLruTile = 64;      // time steps a stage
constexpr int kLruStages = 6;     // stages in the ring
constexpr int kLruUnroll = 8;     // steps whose loads the walker issues ahead
constexpr int kLruThreads = 96;   // walker, producer, storer warps

constexpr int kLruTileFloats = kLruTile * kLruSlab;
constexpr size_t kLruStageBytes = 2 * kLruTileFloats * sizeof(float);
constexpr size_t kLruSmemBytes = kLruStages * kLruStageBytes + 3 * kLruStages * sizeof(uint64_t);
static_assert(kLruSlab == 8 || kLruSlab == 16 || kLruSlab == 32,
              "a slab is some of the walker warp's lanes, whole 16-byte copies a row");
static_assert(kLruTile % kLruUnroll == 0, "a tile walks in whole groups");
static_assert(kLruSmemBytes <= 232448, "the ring must fit one block's shared memory");

namespace lru {

using tc::smem_addr;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Arrive on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk stores have read their shared source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order this thread's shared-memory writes before later bulk copies read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kVec>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  if constexpr (kVec == 4)
    tc::cp_async16(dst, src, valid);
  else
    tc::cp_async4(dst, src, valid);
}

template <int kVec>
__device__ __forceinline__ void store(float* dst, const float* src) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else
    *dst = *src;
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// One lane's walk of a whole tile: a at as[t * kLruSlab], b at bs[...], h
// written over b.  The loads of group g + 1 are issued before group g's
// chain, so the chain waits on arithmetic, not on shared memory.
__device__ __forceinline__ float walk_tile(const float* as, float* bs, float h) {
  constexpr int kGroups = kLruTile / kLruUnroll;
  float av[2][kLruUnroll], bv[2][kLruUnroll];
#pragma unroll
  for (int u = 0; u < kLruUnroll; ++u) {
    av[0][u] = as[u * kLruSlab];
    bv[0][u] = bs[u * kLruSlab];
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int cur = g & 1;
    if (g + 1 < kGroups) {
#pragma unroll
      for (int u = 0; u < kLruUnroll; ++u) {
        const int t = (g + 1) * kLruUnroll + u;
        av[cur ^ 1][u] = as[t * kLruSlab];
        bv[cur ^ 1][u] = bs[t * kLruSlab];
      }
    }
#pragma unroll
    for (int u = 0; u < kLruUnroll; ++u) {
      h = step(av[cur][u], h, bv[cur][u]);
      bs[(g * kLruUnroll + u) * kLruSlab] = h;
    }
  }
  return h;
}

}  // namespace lru

struct LruArgs {
  const float* a;
  const float* b;
  const float* h0;
  float* y;
  float* h_last;
  int S, D;
};

// kVec: floats a cp.async copy or a store moves (4, or 1 for a D that is no
// multiple of 4); kBulk: the 1D bulk feed (kVec 4 only).
template <bool kBulk, int kVec>
__global__ void __launch_bounds__(kLruThreads) rglru_kernel(const LruArgs p) {
  static_assert(!kBulk || kVec == 4, "bulk copies move 16-byte multiples");
  using namespace lru;
  extern __shared__ __align__(128) unsigned char lru_smem[];
  float* ring = reinterpret_cast<float*>(lru_smem);  // stage s: a, then b
  uint64_t* full = reinterpret_cast<uint64_t*>(lru_smem + kLruStages * kLruStageBytes);
  uint64_t* walked = full + kLruStages;
  uint64_t* empty = walked + kLruStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = blockIdx.x * kLruSlab;
  const int width = min(kLruSlab, p.D - d0);  // channels of this slab
  const int64_t base = (int64_t)blockIdx.y * p.S * p.D + d0;  // a[b, 0, d0]
  const int tiles = (p.S + kLruTile - 1) / kLruTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLruStages; ++s) {
      mbar_init(&full[s], kBulk ? 1 : 32);
      mbar_init(&walked[s], 32);
      mbar_init(&empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // walker
    const bool live = lane < width;
    float h = live ? p.h0[(int64_t)blockIdx.y * p.D + d0 + lane] : 0.f;
    for (int k = 0; k < tiles; ++k) {
      const int s = k % kLruStages;
      const int rows = min(kLruTile, p.S - k * kLruTile);
      const float* as = ring + s * 2 * kLruTileFloats + lane;
      float* bs = ring + s * 2 * kLruTileFloats + kLruTileFloats + lane;
      mbar_wait(&full[s], (k / kLruStages) & 1);
      if (lane < kLruSlab) {
        if (rows == kLruTile) {
          h = walk_tile(as, bs, h);
        } else {
          for (int t = 0; t < rows; ++t) {
            h = step(as[t * kLruSlab], h, bs[t * kLruSlab]);
            bs[t * kLruSlab] = h;
          }
        }
      }
      if constexpr (kBulk) fence_proxy_async();
      mbar_arrive(&walked[s]);
    }
    if (live) p.h_last[(int64_t)blockIdx.y * p.D + d0 + lane] = h;
  } else if (warp == 1) {  // producer
    constexpr int kChunks = kLruSlab / kVec;  // copies a tile row
    for (int k = 0; k < tiles; ++k) {
      const int s = k % kLruStages;
      if (k >= kLruStages) mbar_wait(&empty[s], (k / kLruStages - 1) & 1);
      const int rows = min(kLruTile, p.S - k * kLruTile);
      float* as = ring + s * 2 * kLruTileFloats;
      float* bs = as + kLruTileFloats;
      const int64_t g = base + (int64_t)k * kLruTile * p.D;
      if constexpr (kBulk) {
        const uint32_t row_bytes = width * sizeof(float);
        if (lane == 0) mbar_arrive_expect_tx(&full[s], 2u * rows * row_bytes);
        __syncwarp();
        for (int r = lane; r < rows; r += 32) {
          bulk_load(as + r * kLruSlab, p.a + g + (int64_t)r * p.D, row_bytes, &full[s]);
          bulk_load(bs + r * kLruSlab, p.b + g + (int64_t)r * p.D, row_bytes, &full[s]);
        }
      } else {
        for (int i = lane; i < rows * kChunks; i += 32) {
          const int r = i / kChunks, c = (i % kChunks) * kVec;
          const bool ok = c < width;  // past a ragged slab: zero-filled
          const int64_t off = g + (int64_t)r * p.D + (ok ? c : 0);
          copy_async<kVec>(as + r * kLruSlab + c, p.a + off, ok);
          copy_async<kVec>(bs + r * kLruSlab + c, p.b + off, ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    if constexpr (!kBulk) tc::cp_async_wait<0>();
  } else {  // storer
    constexpr int kChunks = kLruSlab / kVec;
    for (int k = 0; k < tiles; ++k) {
      const int s = k % kLruStages;
      const int rows = min(kLruTile, p.S - k * kLruTile);
      const float* ys = ring + s * 2 * kLruTileFloats + kLruTileFloats;
      const int64_t g = base + (int64_t)k * kLruTile * p.D;
      mbar_wait(&walked[s], (k / kLruStages) & 1);
      if constexpr (kBulk) {
        for (int r = lane; r < rows; r += 32)
          bulk_store(p.y + g + (int64_t)r * p.D, ys + r * kLruSlab, width * sizeof(float));
        bulk_commit();
        bulk_wait_read();
      } else {
        for (int i = lane; i < rows * kChunks; i += 32) {
          const int r = i / kChunks, c = (i % kChunks) * kVec;
          if (c < width) store<kVec>(p.y + g + (int64_t)r * p.D + c, ys + r * kLruSlab + c);
        }
      }
      mbar_arrive(&empty[s]);
    }
    if constexpr (kBulk) bulk_wait();
  }
}

template <bool kBulk, int kVec>
static cudaError_t launch_rglru(const LruArgs& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rglru_kernel<kBulk, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kLruSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.D + kLruSlab - 1) / kLruSlab, B);
  rglru_kernel<kBulk, kVec><<<grid, kLruThreads, kLruSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro_torch

// a, b, y: (B, S, D) float32 contiguous; h0, h_last: (B, D) float32
// contiguous.  One launch on `stream`; returns the CUDA error code of the
// launch (0 = success).
extern "C" int repro_torch_rglru(const void* a, const void* b, const void* h0, void* y,
                                 void* h_last, int B, int S, int D, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const LruArgs p{static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const float*>(h0), static_cast<float*>(y),
                  static_cast<float*>(h_last), S, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      D % 4 == 0 && ((uintptr_t)a | (uintptr_t)b | (uintptr_t)y) % 16 == 0;
  if (vec4) return (int)launch_rglru<true, 4>(p, B, s);
  return (int)launch_rglru<false, 1>(p, B, s);
}
