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
// K1 block_count (replaces block_lookup, block_lookup_wave and the unmasked
// mode of block_lookup_resident, acoustid_index_tpu/ops/pallas_lookup.py)
// and K2 block_count_emit (replaces block_lookup_emit and
// block_lookup_emit_wave) SEARCH the block.  Their precondition: every
// block is non-decreasing as u32.  Every table the port hands them is (the
// merged tier postings with their 0xFFFFFFFF padding, the top index
// hashes[::1024], the sorted mention tables;
// tests/test_torch_block_lookup.py checks it during a search).  Then lt is
// the block's lower bound of q and lt + eq its upper bound.  One thread
// serves one lookup with a branch-free binary search per bound: eleven
// dependent 4-byte loads each, the two chains independent of each other,
// 32 lookups per warp.  A run of any length, up to the whole block, costs
// the same.  K2 then copies docid rows r = min(lt >> 7, 7) and min(r + 1,
// 7) of the block (2 x 128 u32) to rows[j], so the direct candidate stage
// reads each run's leading docids without a per-posting gather; the warp
// copies its 32 lookups' rows together, one lookup at a time, 512
// contiguous bytes per instruction.
//
// What bounds them on the card.  On the main path K1 reads tables that sit
// in the 50 MB L2 (a 1 MiB top index, the memory tier, a mention table):
// there the launch and the chain of dependent L2 loads are the cost, and a
// lookup touches a few 32-byte sectors where the scan below moves its
// whole 4 KB block through L2.  K2 reads a random block of the 2 GiB file
// tier per lookup: scattered HBM sectors for the search, then the two
// 512-byte docid rows and the 1 KB it writes, which are now most of its
// bytes.  The designs not taken -- an 8-lane group per lookup with an
// 8-ary narrowing (K1, K2) and a warp-wide 32-ary search (K2) -- are in
// csrc/block_lookup_designs.cu; measure.py times them beside these at the
// main path's shapes, cold and warm.  On the H100 the group tied K2 and
// K1's main-path pair of calls, and lost everywhere else; the 32-ary
// search lost (PERF.md).
//
// K1m block_count_masked (replaces block_lookup_resident's masked mode,
// lo_b/hi_b, pallas_lookup.py:496-537) keeps the scan: it counts only the
// entries whose absolute index blk*1024 + i lies in [lo_b[j], hi_b[j]),
// for top indexes that concatenate several sorted runs, so its blocks need
// not be sorted and a search would be wrong.  No caller reaches it.
//
// block_count_scan and block_count_emit_scan are the first designs of K1
// and K2, kept to time against on the same card: one warp per lookup
// reads the whole block (each lane eight 16-byte loads at consecutive
// addresses) and sums the compares with __reduce_add_sync.  They need no
// sorted blocks.  No wrapper on the main path reaches them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 1024;           // postings per block
constexpr int ROWS = BLOCK / 128;     // docid rows of 128 per block
constexpr int WARPS_PER_CTA = 8;
constexpr int THREADS = WARPS_PER_CTA * 32;
constexpr int VEC_PER_LANE = BLOCK / 4 / 32;  // scan: uint4 loads per lane (8)

__device__ __forceinline__ int64_t block_base(const int32_t* blk, int64_t j,
                                              int64_t nblk, int stride) {
  int64_t b = blk[j];
  b = b < 0 ? 0 : (b >= nblk ? nblk - 1 : b);
  return b * (int64_t)stride * BLOCK;  // u32 offset of the block's hashes
}

// ---- the search (K1, K2) ----

// The lower bound `lt` (#entries < q) and upper bound `ub` (#entries <=
// q) of q in one sorted block, by one thread: a branch-free binary search
// per bound.  Invariant: the bound lies in [b, b + 2*half]; the probe at
// b + half - 1 halves that, and after the half = 1 step one compare at b
// settles it.  The two chains are independent, so their loads overlap.
__device__ __forceinline__ void thread_search(const uint32_t* __restrict__ h,
                                              uint32_t q, unsigned* lt,
                                              unsigned* ub) {
  unsigned l = 0, u = 0;
#pragma unroll
  for (unsigned half = BLOCK / 2; half > 0; half >>= 1) {
    l += __ldg(h + l + half - 1) < q ? half : 0;
    u += __ldg(h + u + half - 1) <= q ? half : 0;
  }
  *lt = l + (__ldg(h + l) < q);
  *ub = u + (__ldg(h + u) <= q);
}

__global__ void __launch_bounds__(THREADS)
block_count_kernel(const uint32_t* __restrict__ table,
                   const int32_t* __restrict__ blk,
                   const uint32_t* __restrict__ q,
                   int32_t* __restrict__ lt_out,
                   int32_t* __restrict__ eq_out,
                   int64_t L, int64_t nblk, int stride) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= L) return;
  unsigned lt, ub;
  thread_search(table + block_base(blk, j, nblk, stride), q[j], &lt, &ub);
  lt_out[j] = (int32_t)lt;
  eq_out[j] = (int32_t)(ub - lt);
}

__global__ void __launch_bounds__(THREADS)
block_count_emit_kernel(const uint32_t* __restrict__ inter,
                        const int32_t* __restrict__ blk,
                        const uint32_t* __restrict__ q,
                        int32_t* __restrict__ lt_out,
                        int32_t* __restrict__ eq_out,
                        uint32_t* __restrict__ rows,
                        int64_t L, int64_t nblk) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t first = j - lane;  // the warp's first lookup
  if (first >= L) return;          // whole warp exits together
  const int64_t jj = j < L ? j : L - 1;  // the copy below needs the whole warp
  const int64_t off = block_base(blk, jj, nblk, 2);
  unsigned lt, ub;
  thread_search(inter + off, q[jj], &lt, &ub);
  if (j < L) {
    lt_out[j] = (int32_t)lt;
    eq_out[j] = (int32_t)(ub - lt);
  }
  // The warp copies lookup k's rows r and r2 (2 x 32 uint4) for each of its
  // n lookups in turn: lane l moves uint4 l of each row.
  const int r = min((int)(lt >> 7), ROWS - 1);
  const int r2 = min(r + 1, ROWS - 1);
  const int n = (int)min((int64_t)32, L - first);
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const long long ok = __shfl_sync(FULL, (long long)off, k);
    const int rk = __shfl_sync(FULL, r, k), r2k = __shfl_sync(FULL, r2, k);
    const uint4* d = reinterpret_cast<const uint4*>(inter + ok + BLOCK);
    uint4* out = reinterpret_cast<uint4*>(rows + (first + k) * 256);
    out[lane] = __ldg(d + rk * 32 + lane);
    out[32 + lane] = __ldg(d + r2k * 32 + lane);
  }
}

// ---- the scan (K1m; block_count_scan, block_count_emit_scan) ----

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
  *lt = __reduce_add_sync(FULL, l);
  *eq = __reduce_add_sync(FULL, e);
}

__global__ void __launch_bounds__(THREADS)
block_count_scan_kernel(const uint32_t* __restrict__ table,
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
  *lt = __reduce_add_sync(FULL, l);
  *eq = __reduce_add_sync(FULL, e);
}

__global__ void __launch_bounds__(THREADS)
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

__global__ void __launch_bounds__(THREADS)
block_count_emit_scan_kernel(const uint32_t* __restrict__ inter,
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

inline unsigned grid_for(int64_t L, int per_cta) {
  return (unsigned)((L + per_cta - 1) / per_cta);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).

int aitpu_block_count(const void* table, const void* blk, const void* q,
                      void* lt, void* eq, long long L, long long nblk,
                      int stride, void* stream) {
  if (L > 0) {
    block_count_kernel<<<grid_for(L, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (int64_t)L, (int64_t)nblk, stride);
  }
  return (int)cudaGetLastError();
}

int aitpu_block_count_emit(const void* inter, const void* blk, const void* q,
                           void* lt, void* eq, void* rows, long long L,
                           long long nblk, void* stream) {
  if (L > 0) {
    block_count_emit_kernel<<<grid_for(L, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (uint32_t*)rows, (int64_t)L, (int64_t)nblk);
  }
  return (int)cudaGetLastError();
}

int aitpu_block_count_scan(const void* table, const void* blk, const void* q,
                           void* lt, void* eq, long long L, long long nblk,
                           int stride, void* stream) {
  if (L > 0) {
    block_count_scan_kernel<<<grid_for(L, WARPS_PER_CTA), THREADS, 0, (cudaStream_t)stream>>>(
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
    block_count_masked_kernel<<<grid_for(L, WARPS_PER_CTA), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)blk, (const uint32_t*)q,
        (const int32_t*)lo_b, (const int32_t*)hi_b, (int32_t*)lt,
        (int32_t*)eq, (int64_t)L, (int64_t)nblk);
  }
  return (int)cudaGetLastError();
}

int aitpu_block_count_emit_scan(const void* inter, const void* blk, const void* q,
                                void* lt, void* eq, void* rows, long long L,
                                long long nblk, void* stream) {
  if (L > 0) {
    block_count_emit_scan_kernel<<<grid_for(L, WARPS_PER_CTA), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (uint32_t*)rows, (int64_t)L, (int64_t)nblk);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
