// Block-lookup kernels for Hopper (sm_90a), bound to Python with ctypes
// (acoustid_index_tpu_torch/ops/_build.py, ops/block_lookup.py).
//
// Contract shared by the kernels.  A table is a flat array of u32 hashes
// cut into blocks of BLOCK = 1024 entries; with `stride` 2 (the interleaved
// layout, ops/layout.py) block b's hashes sit at [b*2048, b*2048+1024) and
// its docids at [b*2048+1024, b*2048+2048).  For lookup j with block id
// blk[j] and query q[j]:
//     lt[j] = #hashes in block blk[j] that are <  q[j]   (unsigned compare)
//     eq[j] = #hashes in block blk[j] that are == q[j]
// Block ids are clamped into [0, nblk): callers clip them already, the clamp
// only keeps a stray id from reading outside the table.  Tables are int32
// tensors holding u32 bit patterns; here they are read as uint32_t.
//
// K1 block_count replaces the TPU kernels block_lookup,
// block_lookup_wave and block_lookup_resident (unmasked mode) of
// acoustid_index_tpu/ops/pallas_lookup.py.  K1m block_count_masked replaces
// block_lookup_resident's masked mode (lo_b/hi_b, pallas_lookup.py:496-537):
// K1 at stride 1 that counts only the entries whose absolute index
// blk*1024 + i lies in [lo_b[j], hi_b[j]), for top indexes that concatenate
// several sorted runs so that one block can span two of them.  K2
// block_count_emit replaces block_lookup_emit and block_lookup_emit_wave:
// after the count it also
// copies docid rows r = min(lt >> 7, 7) and min(r + 1, 7) of the block
// (2 x 128 u32) to rows[j], so the direct candidate stage reads each run's
// leading docids without a per-posting gather.
//
// What bounds them on the card: each lookup reads one random 4 KB block of
// hashes (plus 1 KB of docid rows for K2, 8 bytes of bounds for K1m) and
// does 1024 compares, so a call of L lookups moves ~L x 4 KB (K2: ~L x 5 KB) from scattered addresses --
// memory latency and DRAM transactions, not arithmetic.  The design keeps
// every byte of those reads useful: one warp per lookup, each lane issuing
// 16-byte loads at consecutive addresses (a warp instruction fetches 512
// contiguous bytes), eight warps per thread block so many blocks are in
// flight per SM to hide the latency, and a warp-wide reduction
// (__reduce_add_sync) instead of shared memory.  Nothing is staged in
// shared memory: each byte is read once.  Binary search inside the block,
// cp.async/TMA pipelining and fusing K2 into the candidate stage are left
// for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 1024;           // postings per block
constexpr int ROWS = BLOCK / 128;     // docid rows of 128 per block
constexpr int WARPS_PER_CTA = 8;      // lookups per thread block
constexpr int VEC_PER_LANE = BLOCK / 4 / 32;  // uint4 loads per lane (8)

__device__ __forceinline__ int64_t block_base(const int32_t* blk, int64_t j,
                                              int64_t nblk, int stride) {
  int64_t b = blk[j];
  b = b < 0 ? 0 : (b >= nblk ? nblk - 1 : b);
  return b * (int64_t)stride * BLOCK;  // u32 offset of the block's hashes
}

// Per-lane lt/eq over 32 hashes of the block, reduced over the warp.
__device__ __forceinline__ void warp_count(const uint32_t* __restrict__ hashes,
                                           uint32_t q, int lane,
                                           unsigned* lt, unsigned* eq) {
  const uint4* v = reinterpret_cast<const uint4*>(hashes);
  unsigned l = 0, e = 0;
#pragma unroll
  for (int i = 0; i < VEC_PER_LANE; ++i) {
    uint4 x = __ldg(v + i * 32 + lane);
    l += (x.x < q) + (x.y < q) + (x.z < q) + (x.w < q);
    e += (x.x == q) + (x.y == q) + (x.z == q) + (x.w == q);
  }
  *lt = __reduce_add_sync(0xffffffffu, l);
  *eq = __reduce_add_sync(0xffffffffu, e);
}

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
block_count_kernel(const uint32_t* __restrict__ table,
                   const int32_t* __restrict__ blk,
                   const uint32_t* __restrict__ q,
                   int32_t* __restrict__ lt_out,
                   int32_t* __restrict__ eq_out,
                   int64_t L, int64_t nblk, int stride) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (j >= L) return;  // whole warp exits together
  const uint32_t* h = table + block_base(blk, j, nblk, stride);
  unsigned lt, eq;
  warp_count(h, q[j], lane, &lt, &eq);
  if (lane == 0) {
    lt_out[j] = (int32_t)lt;
    eq_out[j] = (int32_t)eq;
  }
}

// K1's count restricted to absolute entries in [lo, hi); `first` is the
// absolute index of the block's entry 0.
__device__ __forceinline__ unsigned in_span(int64_t k, int64_t lo, int64_t hi) {
  return (unsigned)(k >= lo && k < hi);
}

__device__ __forceinline__ void warp_count_masked(const uint32_t* __restrict__ hashes,
                                                  uint32_t q, int lane, int64_t first,
                                                  int64_t lo, int64_t hi,
                                                  unsigned* lt, unsigned* eq) {
  const uint4* v = reinterpret_cast<const uint4*>(hashes);
  unsigned l = 0, e = 0;
#pragma unroll
  for (int i = 0; i < VEC_PER_LANE; ++i) {
    uint4 x = __ldg(v + i * 32 + lane);
    const int64_t k = first + (int64_t)(i * 32 + lane) * 4;  // entry of x.x
    const unsigned m0 = in_span(k, lo, hi), m1 = in_span(k + 1, lo, hi);
    const unsigned m2 = in_span(k + 2, lo, hi), m3 = in_span(k + 3, lo, hi);
    l += (m0 & (x.x < q)) + (m1 & (x.y < q)) + (m2 & (x.z < q)) + (m3 & (x.w < q));
    e += (m0 & (x.x == q)) + (m1 & (x.y == q)) + (m2 & (x.z == q)) + (m3 & (x.w == q));
  }
  *lt = __reduce_add_sync(0xffffffffu, l);
  *eq = __reduce_add_sync(0xffffffffu, e);
}

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
block_count_masked_kernel(const uint32_t* __restrict__ table,
                          const int32_t* __restrict__ blk,
                          const uint32_t* __restrict__ q,
                          const int32_t* __restrict__ lo_b,
                          const int32_t* __restrict__ hi_b,
                          int32_t* __restrict__ lt_out,
                          int32_t* __restrict__ eq_out,
                          int64_t L, int64_t nblk) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (j >= L) return;
  const int64_t first = block_base(blk, j, nblk, 1);  // stride 1: offset == entry index
  unsigned lt, eq;
  warp_count_masked(table + first, q[j], lane, first, lo_b[j], hi_b[j], &lt, &eq);
  if (lane == 0) {
    lt_out[j] = (int32_t)lt;
    eq_out[j] = (int32_t)eq;
  }
}

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
block_count_emit_kernel(const uint32_t* __restrict__ inter,
                        const int32_t* __restrict__ blk,
                        const uint32_t* __restrict__ q,
                        int32_t* __restrict__ lt_out,
                        int32_t* __restrict__ eq_out,
                        uint32_t* __restrict__ rows,
                        int64_t L, int64_t nblk) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (j >= L) return;
  const uint32_t* h = inter + block_base(blk, j, nblk, 2);
  unsigned lt, eq;
  warp_count(h, q[j], lane, &lt, &eq);  // every lane holds the sums
  if (lane == 0) {
    lt_out[j] = (int32_t)lt;
    eq_out[j] = (int32_t)eq;
  }
  const int r = min((int)(lt >> 7), ROWS - 1);
  const int r2 = min(r + 1, ROWS - 1);
  // Each docid row is 128 u32 = 32 uint4: one 16-byte copy per lane per row.
  const uint4* d = reinterpret_cast<const uint4*>(h + BLOCK);
  uint4* out = reinterpret_cast<uint4*>(rows + j * 256);
  out[lane] = __ldg(d + r * 32 + lane);
  out[32 + lane] = __ldg(d + r2 * 32 + lane);
}

inline unsigned grid_for(int64_t L) {
  return (unsigned)((L + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int aitpu_block_count(const void* table, const void* blk, const void* q,
                      void* lt, void* eq, long long L, long long nblk,
                      int stride, void* stream) {
  if (L > 0) {
    block_count_kernel<<<grid_for(L), WARPS_PER_CTA * 32, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (int64_t)L, (int64_t)nblk, stride);
  }
  return (int)cudaGetLastError();
}

int aitpu_block_count_masked(const void* table, const void* blk, const void* q,
                             const void* lo_b, const void* hi_b, void* lt,
                             void* eq, long long L, long long nblk,
                             void* stream) {
  if (L > 0) {
    block_count_masked_kernel<<<grid_for(L), WARPS_PER_CTA * 32, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)blk, (const uint32_t*)q,
        (const int32_t*)lo_b, (const int32_t*)hi_b, (int32_t*)lt,
        (int32_t*)eq, (int64_t)L, (int64_t)nblk);
  }
  return (int)cudaGetLastError();
}

int aitpu_block_count_emit(const void* inter, const void* blk, const void* q,
                           void* lt, void* eq, void* rows, long long L,
                           long long nblk, void* stream) {
  if (L > 0) {
    block_count_emit_kernel<<<grid_for(L), WARPS_PER_CTA * 32, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (uint32_t*)rows, (int64_t)L,
        (int64_t)nblk);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
