// Delta-varint decode of a segment file's columns on the card (sm_90a),
// bound to Python with ctypes (acoustid_index_tpu_torch/ops/_build.py,
// ops/varint.py).
//
// Replaces no TPU kernel: the reference decodes a segment file on the host
// (csrc/aitpu_native.cc, aitpu_decode_postings / aitpu_decode_sorted_u32,
// one thread, one byte at a time) and packs the tier in numpy.  At 2^30
// postings that is ~5.5 GB of varints and an 8 GiB tier, tens of seconds
// of one host thread at every restart.  Here the file's bytes are copied
// to the card as they are, and these kernels turn them into the tier.
//
// Format "dv1" (aitpu_native.cc): LEB128 varints, 7 bits a byte, the high
// bit set on every byte but a value's last ("terminator", byte < 0x80).  A
// u32 takes at most five bytes.  Postings are pairs (delta, dv): hash_i =
// hash_{i-1} + delta_i (u32, wrapping), and docid_i = docid_{i-1} + dv_i
// where delta_i == 0 and i > 0, else dv_i.  Sorted u32 columns (the
// mentioned docs) are single varints with value_i = value_{i-1} + delta_i.
//
// Decode in five launches, each wide over the card:
//   count    one CTA per CHUNK = 4096 bytes: its terminators, and a flag if
//            a terminator follows five continuation bytes (a varint of six
//            or more bytes, which the host decoder refuses);
//   (host)   an exclusive scan of the counts gives each chunk's first
//            varint index; the total must equal the values expected and the
//            last byte must be a terminator, else the stream is refused as
//            the host decoder refuses it (its -1);
//   decode   one CTA per chunk again: each thread takes 16 bytes and the 5
//            before them, ranks its terminators by a block scan, and writes
//            each varint's value at its global index: delta to the hash
//            slot, dv to the docid slot of its pair (or the value to the
//            single column);
//   sums     one CTA per TILE = 1024 values (one tier block): the tile's
//            sum of deltas and its docid aggregate (segmented: whether the
//            tile holds a restart, and the sum of dv since its last one);
//   carries  one CTA scans the tiles' aggregates into each tile's carry-in;
//   apply    one CTA per tile: the scan inside the tile from its carry-in,
//            written in place over the raw values; SENTINEL past n up to the
//            capacity, and the tile's first hash into the top index.
// Values land at slot(i) = (i / 1024) * bstride + i % 1024 of the hash and
// docid bases: bstride 2048 with docid base = hash base + 1024 writes the
// interleaved tier of ops/layout.py directly; bstride 1024 writes plain
// columns.
//
// What bounds it: bytes.  At 2^30 postings the passes read the 5.5 GB
// stream twice and the 8 GiB of values three times and write them twice:
// ~57 GB, ~17 ms at 3.35 TB/s.  Each thread loads its 16 bytes as one
// 16-byte load (the buffer is the allocator's, 256-byte aligned); a
// varint's bytes before the thread's own come from a 5-byte halo.  The
// value writes are 4-byte stores at consecutive slots within a warp.  The
// carries pass runs on one SM over 2^20 tile aggregates (12 MB), ~1 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BYTES = 16;               // bytes per thread
constexpr int CHUNK = THREADS * BYTES;  // bytes per CTA of count and decode
constexpr int HALO = 5;                 // bytes before a thread's own it reads
constexpr int TILE = 1024;              // values per CTA of sums and apply
constexpr int PER = TILE / THREADS;     // values per thread of a tile
constexpr int CARRY_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

__device__ __forceinline__ int64_t slot(int64_t i, int64_t bstride) {
  return (i >> 10) * bstride + (i & (TILE - 1));
}

// w[0 .. HALO) = the HALO bytes before `base` (0 before the stream's start,
// which reads as a terminator), w[HALO .. HALO + BYTES) = bytes from base
// (0 past nbytes; callers mask those by position).
__device__ __forceinline__ void load_window(const uint8_t* data, int64_t nbytes,
                                            int64_t base, uint8_t (&w)[HALO + BYTES]) {
#pragma unroll
  for (int k = 0; k < HALO; k++) {
    int64_t p = base - HALO + k;
    w[k] = (p >= 0 && p < nbytes) ? data[p] : 0;
  }
  if (base + BYTES <= nbytes) {
    uint4 v = *reinterpret_cast<const uint4*>(data + base);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < BYTES; k++) w[HALO + k] = (uint8_t)(words[k >> 2] >> (8 * (k & 3)));
  } else {
#pragma unroll
    for (int k = 0; k < BYTES; k++) {
      int64_t p = base + k;
      w[HALO + k] = p < nbytes ? data[p] : 0;
    }
  }
}

__device__ __forceinline__ uint32_t terminators(const uint8_t (&w)[HALO + BYTES],
                                                int64_t base, int64_t nbytes) {
  uint32_t mask = 0;
#pragma unroll
  for (int k = 0; k < BYTES; k++)
    if (base + k < nbytes && w[HALO + k] < 0x80) mask |= 1u << k;
  return mask;
}

// Exclusive scan of one int over the CTA (THREADS threads).
__device__ __forceinline__ int block_excl_sum(int x) {
  __shared__ int warp_tot[THREADS / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_tot[wid] = inc;
  __syncthreads();
  int off = 0;
  for (int i = 0; i < wid; i++) off += warp_tot[i];
  return off + inc - x;
}

// A run of values, as the scans combine it: h = the sum of its deltas; for
// the docids, f = 1 if it holds a restart (delta != 0, or value 0) and v =
// the sum of dv since its last restart (of all its dv without one).
struct Agg {
  uint32_t h, f, v;
};

__device__ __forceinline__ Agg combine(Agg a, Agg b) {
  return {a.h + b.h, a.f | b.f, b.f ? b.v : a.v + b.v};
}

__device__ __forceinline__ Agg shfl_up(Agg a, int o) {
  return {__shfl_up_sync(FULL, a.h, o), __shfl_up_sync(FULL, a.f, o), __shfl_up_sync(FULL, a.v, o)};
}

// Exclusive scan of x over a CTA of NT threads; *total gets the CTA's whole
// aggregate.  The combine is associative, not commutative: order kept.
template <int NT>
__device__ __forceinline__ Agg block_excl_scan(Agg x, Agg* total) {
  __shared__ Agg warp_tot[NT / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  Agg inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Agg y = shfl_up(inc, o);
    if (lane >= o) inc = combine(y, inc);
  }
  Agg ex = shfl_up(inc, 1);
  if (lane == 0) ex = {0, 0, 0};
  if (lane == 31) warp_tot[wid] = inc;
  __syncthreads();
  Agg off = {0, 0, 0};
  for (int i = 0; i < wid; i++) off = combine(off, warp_tot[i]);
  if (total) {
    Agg t = {0, 0, 0};
    for (int i = 0; i < NT / 32; i++) t = combine(t, warp_tot[i]);
    *total = t;
  }
  return combine(off, ex);
}

__global__ void __launch_bounds__(THREADS) count_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
                                                        int32_t* __restrict__ counts, int32_t* __restrict__ bad) {
  const int64_t base = (int64_t)blockIdx.x * CHUNK + (int64_t)threadIdx.x * BYTES;
  uint8_t w[HALO + BYTES];
  load_window(data, nbytes, base, w);
  const uint32_t mask = terminators(w, base, nbytes);
  bool run = false;
#pragma unroll
  for (int k = 0; k < BYTES; k++)
    run |= ((mask >> k) & 1) && (w[k] & w[k + 1] & w[k + 2] & w[k + 3] & w[k + 4]) >= 0x80;
  if (run) *bad = 1;
  int c = __popc(mask);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(FULL, c, o);
  __shared__ int warp_tot[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int i = 0; i < THREADS / 32; i++) t += warp_tot[i];
    counts[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(THREADS) decode_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
                                                         const int64_t* __restrict__ starts, int pairs,
                                                         uint32_t* hbase, uint32_t* dbase, int64_t bstride,
                                                         int64_t nvals) {
  const int64_t base = (int64_t)blockIdx.x * CHUNK + (int64_t)threadIdx.x * BYTES;
  uint8_t w[HALO + BYTES];
  load_window(data, nbytes, base, w);
  const uint32_t mask = terminators(w, base, nbytes);
  int64_t g = starts[blockIdx.x] + block_excl_sum(__popc(mask));
#pragma unroll
  for (int k = 0; k < BYTES; k++) {
    if (!((mask >> k) & 1)) continue;
    // The varint ends at w[HALO + k]; its continuation bytes precede it
    // (at most four: the count pass refused longer runs).  Built from its
    // last byte down, the shifts drop the bits past 32 as the host's do.
    const int e = HALO + k;
    uint32_t v = w[e];
    bool more = true;
#pragma unroll
    for (int t = 1; t <= 4; t++) {
      more = more && w[e - t] >= 0x80;
      if (more) v = (v << 7) | (w[e - t] & 0x7F);
    }
    if (g < nvals) {
      if (pairs)
        ((g & 1) ? dbase : hbase)[slot(g >> 1, bstride)] = v;
      else
        hbase[slot(g, bstride)] = v;
    }
    g++;
  }
}

// The PER raw values of thread `threadIdx.x` in tile blockIdx.x, as runs.
__device__ __forceinline__ void load_raw(const uint32_t* hbase, const uint32_t* dbase, int64_t bstride,
                                         int64_t n, int pairs, int64_t i0, Agg (&e)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; j++) {
    const int64_t i = i0 + j;
    if (i < n) {
      const uint32_t delta = hbase[slot(i, bstride)];
      if (pairs)
        e[j] = {delta, (uint32_t)(i == 0 || delta != 0), dbase[slot(i, bstride)]};
      else
        e[j] = {delta, 0, 0};
    } else {
      e[j] = {0, 0, 0};
    }
  }
}

__global__ void __launch_bounds__(THREADS) sums_kernel(const uint32_t* hbase, const uint32_t* dbase, int64_t bstride,
                                                       int64_t n, int pairs, uint32_t* __restrict__ tile_h,
                                                       uint32_t* __restrict__ tile_f, uint32_t* __restrict__ tile_v) {
  const int64_t i0 = (int64_t)blockIdx.x * TILE + threadIdx.x * PER;
  Agg e[PER];
  load_raw(hbase, dbase, bstride, n, pairs, i0, e);
  Agg x = e[0];
#pragma unroll
  for (int j = 1; j < PER; j++) x = combine(x, e[j]);
  Agg total;
  block_excl_scan<THREADS>(x, &total);
  if (threadIdx.x == 0) {
    tile_h[blockIdx.x] = total.h;
    tile_f[blockIdx.x] = total.f;
    tile_v[blockIdx.x] = total.v;
  }
}

__global__ void __launch_bounds__(CARRY_THREADS) carries_kernel(const uint32_t* __restrict__ tile_h,
                                                                const uint32_t* __restrict__ tile_f,
                                                                const uint32_t* __restrict__ tile_v, int64_t ntiles,
                                                                uint32_t* __restrict__ carry_h,
                                                                uint32_t* __restrict__ carry_f,
                                                                uint32_t* __restrict__ carry_v) {
  const int64_t per = (ntiles + CARRY_THREADS - 1) / CARRY_THREADS;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  Agg x = {0, 0, 0};
  for (int64_t t = lo; t < hi; t++) x = combine(x, {tile_h[t], tile_f[t], tile_v[t]});
  Agg c = block_excl_scan<CARRY_THREADS>(x, nullptr);
  for (int64_t t = lo; t < hi; t++) {
    carry_h[t] = c.h;
    carry_f[t] = c.f;
    carry_v[t] = c.v;
    c = combine(c, {tile_h[t], tile_f[t], tile_v[t]});
  }
}

__global__ void __launch_bounds__(THREADS) apply_kernel(uint32_t* hbase, uint32_t* dbase, int64_t bstride, int64_t n,
                                                        int64_t cap, int pairs, const uint32_t* __restrict__ carry_h,
                                                        const uint32_t* __restrict__ carry_f,
                                                        const uint32_t* __restrict__ carry_v,
                                                        uint32_t* __restrict__ block_index) {
  const int64_t t = blockIdx.x;
  const int64_t i0 = t * TILE + threadIdx.x * PER;
  if (t * TILE >= n) {  // padding only: uniform over the CTA
#pragma unroll
    for (int j = 0; j < PER; j++) {
      const int64_t i = i0 + j;
      if (i < cap) {
        hbase[slot(i, bstride)] = SENTINEL;
        if (pairs) dbase[slot(i, bstride)] = SENTINEL;
      }
    }
    if (block_index && threadIdx.x == 0) block_index[t] = SENTINEL;
    return;
  }
  Agg e[PER];
  load_raw(hbase, dbase, bstride, n, pairs, i0, e);
  Agg x = e[0];
#pragma unroll
  for (int j = 1; j < PER; j++) x = combine(x, e[j]);
  Agg run = combine({carry_h[t], carry_f[t], carry_v[t]}, block_excl_scan<THREADS>(x, nullptr));
#pragma unroll
  for (int j = 0; j < PER; j++) {
    const int64_t i = i0 + j;
    if (i >= cap) break;
    uint32_t h = SENTINEL, d = SENTINEL;
    if (i < n) {
      run = combine(run, e[j]);
      h = run.h;
      d = run.v;
    }
    hbase[slot(i, bstride)] = h;
    if (pairs) dbase[slot(i, bstride)] = d;
    if (block_index && i == t * TILE) block_index[t] = h;
  }
}

inline unsigned blocks(int64_t n, int64_t per) { return (unsigned)((n + per - 1) / per); }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = launched).

int aitpu_varint_count(const void* data, long long nbytes, void* counts, void* bad, void* stream) {
  if (nbytes > 0)
    count_kernel<<<blocks(nbytes, CHUNK), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (int64_t)nbytes, (int32_t*)counts, (int32_t*)bad);
  return (int)cudaGetLastError();
}

int aitpu_varint_decode(const void* data, long long nbytes, const void* starts, int pairs, void* hbase,
                        void* dbase, long long bstride, long long nvals, void* stream) {
  if (nbytes > 0)
    decode_kernel<<<blocks(nbytes, CHUNK), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (int64_t)nbytes, (const int64_t*)starts, pairs, (uint32_t*)hbase,
        (uint32_t*)dbase, (int64_t)bstride, (int64_t)nvals);
  return (int)cudaGetLastError();
}

// The scans' three passes, one launch each; aitpu_varint_scan runs them in
// turn.  scratch: 6 * ceil(n / TILE) u32 (the tiles' aggregates, then their
// carries).
int aitpu_varint_sums(const void* hbase, const void* dbase, long long bstride, long long n, int pairs,
                      void* scratch, void* stream) {
  const int64_t ntiles = (n + TILE - 1) / TILE;
  uint32_t* sc = (uint32_t*)scratch;
  if (ntiles > 0)
    sums_kernel<<<(unsigned)ntiles, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)hbase, (const uint32_t*)dbase, (int64_t)bstride, (int64_t)n, pairs, sc, sc + ntiles,
        sc + 2 * ntiles);
  return (int)cudaGetLastError();
}

int aitpu_varint_carries(long long n, void* scratch, void* stream) {
  const int64_t ntiles = (n + TILE - 1) / TILE;
  uint32_t* sc = (uint32_t*)scratch;
  if (ntiles > 0)
    carries_kernel<<<1, CARRY_THREADS, 0, (cudaStream_t)stream>>>(sc, sc + ntiles, sc + 2 * ntiles, ntiles,
                                                                  sc + 3 * ntiles, sc + 4 * ntiles, sc + 5 * ntiles);
  return (int)cudaGetLastError();
}

int aitpu_varint_apply(void* hbase, void* dbase, long long bstride, long long n, long long cap, int pairs,
                       void* scratch, void* block_index, void* stream) {
  const int64_t ntiles = (n + TILE - 1) / TILE;
  uint32_t* sc = (uint32_t*)scratch;
  if (cap > 0)
    apply_kernel<<<blocks(cap, TILE), THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t*)hbase, (uint32_t*)dbase, (int64_t)bstride, (int64_t)n, (int64_t)cap, pairs, sc + 3 * ntiles,
        sc + 4 * ntiles, sc + 5 * ntiles, (uint32_t*)block_index);
  return (int)cudaGetLastError();
}

int aitpu_varint_scan(void* hbase, void* dbase, long long bstride, long long n, long long cap, int pairs,
                      void* scratch, void* block_index, void* stream) {
  int rc = aitpu_varint_sums(hbase, dbase, bstride, n, pairs, scratch, stream);
  if (rc == 0) rc = aitpu_varint_carries(n, scratch, stream);
  if (rc == 0) rc = aitpu_varint_apply(hbase, dbase, bstride, n, cap, pairs, scratch, block_index, stream);
  return rc;
}

}  // extern "C"
