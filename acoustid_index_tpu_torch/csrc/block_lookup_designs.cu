// The search designs that K1 and K2 (csrc/block_lookup.cu) did not take,
// kept so that `python -m acoustid_index_tpu_torch.measure` can time them
// against the committed designs on one card, at the main path's shapes.
// Nothing on a path of the port calls them; measure.py binds them with
// ctypes (ops/_build.py, library "designs").
//
// Same contracts and precondition as K1 and K2: every block non-decreasing
// as u32; lt = the block's lower bound of q, eq = upper bound - lt; K2's
// variants also copy docid rows r = min(lt >> 7, 7) and min(r + 1, 7).
//
//   group8 (K1 and K2): a group of 8 lanes per lookup, 4 lookups per warp,
//     narrows each bound 8-ary: each lane reads the first entry of one of 8
//     equal slices, a ballot masked to the group plus __popc picks the
//     bound's slice; 1024 -> 128 -> 16 entries, then the group counts the
//     last 16 (three dependent steps, ~20 sectors per lookup).
//   warp32 (K2): one warp per lookup narrows each bound 32-ary: 32 lanes
//     read one entry each at stride 32, then one coalesced 128-byte segment
//     per bound (two dependent steps).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 1024;
constexpr int ROWS = BLOCK / 128;
constexpr int WARPS_PER_CTA = 8;
constexpr int THREADS = WARPS_PER_CTA * 32;
constexpr int G = 8;  // lanes per lookup in group8

__device__ __forceinline__ int64_t block_base(const int32_t* blk, int64_t j,
                                              int64_t nblk, int stride) {
  int64_t b = blk[j];
  b = b < 0 ? 0 : (b >= nblk ? nblk - 1 : b);
  return b * (int64_t)stride * BLOCK;
}

// #lanes of this lane's group (lanes gshift .. gshift + 7) whose `p` holds.
__device__ __forceinline__ unsigned group_count(bool p, int gshift) {
  return __popc((__ballot_sync(FULL, p) >> gshift) & 0xffu);
}

// Slice s of the bound: the last of the group's slices whose first entry
// is below the bound (slice 0 when none is).
__device__ __forceinline__ unsigned slice_of(unsigned n) { return n ? n - 1 : 0; }

// lt and ub (#entries <= q) of q in a sorted block, by the 8 lanes of a
// group; every lane of the warp calls it (the ballots are warp-wide).
__device__ __forceinline__ void group_search(const uint32_t* __restrict__ h,
                                             uint32_t q, int gl, int gshift,
                                             unsigned* lt, unsigned* ub) {
  // 1024 -> 128: the first entry of each 128-entry slice, shared by both bounds.
  const uint32_t x = __ldg(h + gl * 128);
  unsigned bl = slice_of(group_count(x < q, gshift)) * 128;
  unsigned bu = slice_of(group_count(x <= q, gshift)) * 128;
  // 128 -> 16.
  const uint32_t yl = __ldg(h + bl + gl * 16), yu = __ldg(h + bu + gl * 16);
  bl += slice_of(group_count(yl < q, gshift)) * 16;
  bu += slice_of(group_count(yu <= q, gshift)) * 16;
  // Count the 16 entries, two per lane (64 contiguous bytes per bound).
  const uint2 zl = __ldg(reinterpret_cast<const uint2*>(h + bl) + gl);
  const uint2 zu = __ldg(reinterpret_cast<const uint2*>(h + bu) + gl);
  *lt = bl + group_count(zl.x < q, gshift) + group_count(zl.y < q, gshift);
  *ub = bu + group_count(zu.x <= q, gshift) + group_count(zu.y <= q, gshift);
}

__global__ void __launch_bounds__(THREADS)
count_group8_kernel(const uint32_t* __restrict__ table,
                    const int32_t* __restrict__ blk,
                    const uint32_t* __restrict__ q,
                    int32_t* __restrict__ lt_out,
                    int32_t* __restrict__ eq_out,
                    int64_t L, int64_t nblk, int stride) {
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), gshift = lane & ~(G - 1);
  const int64_t j = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / G;
  if (j - lane / G >= L) return;  // the warp's first lookup: whole warp exits together
  const int64_t jj = j < L ? j : L - 1;  // the ballots need the whole warp
  unsigned lt, ub;
  group_search(table + block_base(blk, jj, nblk, stride), q[jj], gl, gshift, &lt, &ub);
  if (gl == 0 && j < L) {
    lt_out[j] = (int32_t)lt;
    eq_out[j] = (int32_t)(ub - lt);
  }
}

__global__ void __launch_bounds__(THREADS)
emit_group8_kernel(const uint32_t* __restrict__ inter,
                   const int32_t* __restrict__ blk,
                   const uint32_t* __restrict__ q,
                   int32_t* __restrict__ lt_out,
                   int32_t* __restrict__ eq_out,
                   uint32_t* __restrict__ rows,
                   int64_t L, int64_t nblk) {
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), gshift = lane & ~(G - 1);
  const int64_t j = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / G;
  if (j - lane / G >= L) return;
  const int64_t jj = j < L ? j : L - 1;
  const uint32_t* h = inter + block_base(blk, jj, nblk, 2);
  unsigned lt, ub;
  group_search(h, q[jj], gl, gshift, &lt, &ub);
  if (j >= L) return;
  if (gl == 0) {
    lt_out[j] = (int32_t)lt;
    eq_out[j] = (int32_t)(ub - lt);
  }
  // The group copies the two rows (2 x 32 uint4), 128 contiguous bytes per step.
  const int r = min((int)(lt >> 7), ROWS - 1);
  const int r2 = min(r + 1, ROWS - 1);
  const uint4* d = reinterpret_cast<const uint4*>(h + BLOCK);
  uint4* out = reinterpret_cast<uint4*>(rows + j * 256);
#pragma unroll
  for (int k = 0; k < 32; k += G) {
    out[k + gl] = __ldg(d + r * 32 + k + gl);
    out[32 + k + gl] = __ldg(d + r2 * 32 + k + gl);
  }
}

__global__ void __launch_bounds__(THREADS)
emit_warp32_kernel(const uint32_t* __restrict__ inter,
                   const int32_t* __restrict__ blk,
                   const uint32_t* __restrict__ q,
                   int32_t* __restrict__ lt_out,
                   int32_t* __restrict__ eq_out,
                   uint32_t* __restrict__ rows,
                   int64_t L, int64_t nblk) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (j >= L) return;  // whole warp exits together
  const uint32_t* h = inter + block_base(blk, j, nblk, 2);
  const uint32_t qq = q[j];
  // 1024 -> 32: one entry per lane at stride 32, shared by both bounds.
  const uint32_t x = __ldg(h + lane * 32);
  const unsigned bl = slice_of(__popc(__ballot_sync(FULL, x < qq))) * 32;
  const unsigned bu = slice_of(__popc(__ballot_sync(FULL, x <= qq))) * 32;
  // Count the 32 entries of each bound's slice: one 128-byte segment each.
  const unsigned lt = bl + __popc(__ballot_sync(FULL, __ldg(h + bl + lane) < qq));
  const unsigned ub = bu + __popc(__ballot_sync(FULL, __ldg(h + bu + lane) <= qq));
  if (lane == 0) {
    lt_out[j] = (int32_t)lt;
    eq_out[j] = (int32_t)(ub - lt);
  }
  const int r = min((int)(lt >> 7), ROWS - 1);
  const int r2 = min(r + 1, ROWS - 1);
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

// Each returns cudaGetLastError() after the launch (0 = launched); the
// arguments are those of aitpu_block_count / aitpu_block_count_emit.

int aitpu_design_count_group8(const void* table, const void* blk, const void* q,
                              void* lt, void* eq, long long L, long long nblk,
                              int stride, void* stream) {
  if (L > 0) {
    count_group8_kernel<<<grid_for(L, THREADS / G), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (int64_t)L, (int64_t)nblk, stride);
  }
  return (int)cudaGetLastError();
}

int aitpu_design_emit_group8(const void* inter, const void* blk, const void* q,
                             void* lt, void* eq, void* rows, long long L,
                             long long nblk, void* stream) {
  if (L > 0) {
    emit_group8_kernel<<<grid_for(L, THREADS / G), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (uint32_t*)rows, (int64_t)L, (int64_t)nblk);
  }
  return (int)cudaGetLastError();
}

int aitpu_design_emit_warp32(const void* inter, const void* blk, const void* q,
                             void* lt, void* eq, void* rows, long long L,
                             long long nblk, void* stream) {
  if (L > 0) {
    emit_warp32_kernel<<<grid_for(L, WARPS_PER_CTA), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q,
        (int32_t*)lt, (int32_t*)eq, (uint32_t*)rows, (int64_t)L, (int64_t)nblk);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
