// The probes' kernels for Hopper (sm_90a), bound to Python with ctypes
// (acoustid_index_tpu_torch/ops/_build.py, library "probes";
// ops/probe_lookup.py).  They serve the sixteen `pallas_call` sites of the
// reference's TPU measurement scripts under probes/ whose contract K1 or
// K2 (csrc/block_lookup.cu) does not already compute.
//
// Shared contract, as in block_lookup.cu: a table is a flat array of u32
// hashes cut into blocks of BLOCK = 1024 entries, held as int32 bit
// patterns and read here as uint32_t; block ids are clamped into [0, nblk);
// lt = #hashes < q and eq = #hashes == q, unsigned.  Every kernel here
// writes the probes' composite comp = lt + (eq << 12), one int32 per
// lookup, from its own body, as the TPU sites did: lt and eq stay below
// 4096 (a window's sums too), so the fields never carry, and a caller that
// wants the counts takes comp & 0xFFF and comp >> 12.
//
// K3 block_count_pair (replaces probes/_pairkernel.py:21-108
// block_lookup_pair, probes/_probe_dma.py:20-81 block_lookup_pair_dma,
// probes/_probe_smem.py:18-69 block_lookup_pair_smem and
// probes/_probe_floor.py:18-69 make): the two-block window.  Lookup j counts
// q[j] in block blk0[j] and, when blk1[j] > 0, in block blk1[j] too (blk1
// == 0 disables the second block: a real second block is blk0 + 1 >= 1);
// lt and eq are the sums.  `stride` 2 reads the hash half of interleaved
// blocks.  VARIANT is _probe_floor.py:30-48's bisection of the per-lookup
// cost: FULL the window, ONEBLOCK blk0 only, NOREDUCE comp = (blk0's first
// hash < q), EMPTY comp = j % g (no table read).
//
// K4 block_count_emit_docids (replaces probes/_probe_fused.py:76-119
// fused_call and the docid modes of probes/_probe_fused2.py:32-108
// make_kernel): the search over a table of hash/docid blocks, plus E
// docid scalars per lookup: comp[j] = lt + (eq << 12) and d[e][j] =
// docids[lt + e] for lt + e < BLOCK, else 0 (the one-hot extraction of
// _probe_fused.py:101-102 and _probe_fused2.py:77-79).  R is the
// interleave granularity: each block is 2048 words of alternating R-word
// runs of hashes and docids -- R = 1024 the port's interleaved layout (the
// probes' row-major (16, 128) tile), R = 128 _probe_fused2's lane-major
// (8, 256) tile.  MODE SLICE is _probe_fused2.py:80-87's row-slice
// extraction: it reads docid row min(p >> 7, 7), lane p & 127, so for p =
// lt + e >= 1024 it gives docids[896 + (p & 127)] instead of 0.
//
// What bounds K3 and K4 on this card.  Not the bytes they need: the
// sectors at each bound and 12-16 B of I/O per lookup take ~0.0007-0.001 ms
// at 3.35 TB/s, below the ~0.002 ms of any launch at 32,768 lookups
// (_probe_floor's EMPTY).  Each lookup's block is a cold 4 KB somewhere in a
// 1-2 GiB table, and the search's pivots are scattered 32-byte sectors of
// it.  The first design (one thread per lookup, a binary search to each
// bound: 11 dependent 4-byte loads per bound, K4 one more round for its
// docids; now "thread11" in csrc/probe_lookup_designs.cu) was taken to be
// bound by that chain of round trips.  Timing the sector search at arities
// 2, 4 and 8 beside it (measure.py, the probes' shapes, cold; PERF.md)
// showed otherwise: the time follows the distinct sectors a call reads
// (about 0.75 us more per further MB of scattered sectors, ~1.3 TB/s) far
// more than its dependent rounds (~0.2 us a round).  The 8-ary search (4
// rounds, 16 sectors per bound) ran 1.5x slower than thread11, the 4-ary
// (5 rounds, 11 sectors) 1.1x slower.  A binary search over the sectors
// reads the fewest: 7 pivots, each the first hash of a sector, and the
// last pivot below the bound names the bound's sector, already fetched.
//
// So K3 and K4 (csrc/sector_search.cuh) take ARITY 2: one thread per
// lookup -- the cooperative 8- and 32-lane designs of
// csrc/block_lookup_designs.cu lost on the cold tier -- descends over the first hashes of the block's 128 sectors, one
// pivot per bound and round (lt's and ub's shared until a run equal to q
// straddles one), then loads the bound's sector as two 16-byte loads
// (ld.global.nc.v4.u32) and counts it in registers: 8 dependent rounds
// instead of 11, the same sectors as thread11.  K3 runs both blocks'
// descents in the same rounds, a disabled second block's loads predicated
// off.  K4 loads docid sector s with the last hash sector s (it holds
// docids[lt .. lt + 7], since lt is in 8s .. 8s + 8) and, LAZY, the first
// half of sector s + 1 one round later only where lt + E - 1 reaches it:
// no docid round for most lookups and no sector read that is not needed.
// Measured cold, both beat thread11 by 2-3 % at every probe shape; the
// 4- and 8-ary designs stay in the designs library, timed beside.
// K4 writes 4 * (1 + E) bytes per lookup where K2 writes 1 KB.
//
// K5 block_count_staged (replaces the explicit-DMA probes, each of which
// computes the composite:
// probes/_probe_dma2.py:29-219 lookup_dma, lookup_dma_vec, lookup_dma_vec2,
// probes/_probe_ceiling.py:31-122 dma_lookup and probes/_probe_wavemm.py:42-113
// lookup_wave_mm): K1's count over the whole block (exact on any block, as
// every one of those probes computes it), each lookup's 4 KB block staged
// in shared memory by the Tensor Memory Accelerator.  One CTA per SM slot
// walks waves of G lookups; its producer warp's lane 0 issues one 1-D bulk
// copy (cp.async.bulk ... mbarrier::complete_tx) per lookup into an
// NBUF-deep ring of G-block stages in dynamic shared memory, one `full`
// mbarrier per stage; G consumer warps each count one lookup's block from
// shared memory (each lane eight 16-byte loads, conflict-free) and reduce
// with __reduce_add_sync, lane 0 writes the composite, then the warp
// releases the stage through its `empty` mbarrier.  G * NBUF * 4 KB must fit the 227 KB of shared memory a block
// may use (the wrapper raises on anything larger; the probes' g of 32-128
// does not fit and is not shrunk).  Bound: 4 KB per distinct block read
// once (HBM bytes), plus 8 B in and 4 B out per lookup.  Not carried over, because they are TPU workarounds:
// _probe_wavemm's MXU matmul reduction of the compare masks and the
// SMEM-scalar versus one-hot-tile output modes of
// probes/_probe_kernelvariants.py:1-9 and probes/_probe_ceiling.py:46-98 --
// a warp's shuffle reduction and one 4-byte store per lookup replace both.
// A wait on an mbarrier that has not completed after ~2^33 cycles traps, so
// a fault in the ring's bookkeeping ends the launch with an error instead
// of hanging the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sector_search.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448;  // 227 KB: the dynamic shared memory one CTA may use
constexpr int ARITY = 2;  // pivots per sector-search round + 1 (ops/probe_lookup.py SECTOR_ARITY)
constexpr bool LAZY = true;  // K4 loads its second docid sector only where needed (SECTOR_LAZY)

// ---- K5 ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed; trap
// after ~2^33 cycles (seconds) rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 33)) {
      __trap();
    }
  }
}

// One 1-D bulk copy global -> shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int G, int NBUF>
constexpr int staged_smem() {
  return NBUF * G * BLOCK * 4 + 2 * NBUF * 8;
}

template <int G, int NBUF>
__global__ void __launch_bounds__((G + 1) * 32)
block_count_staged_kernel(const uint32_t* __restrict__ table,
                          const int32_t* __restrict__ blk,
                          const uint32_t* __restrict__ q,
                          int32_t* __restrict__ comp,
                          int64_t L, int64_t nblk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);  // [NBUF][G][BLOCK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NBUF * G * BLOCK * 4);
  uint64_t* empty = full + NBUF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrive.expect_tx
      mbar_init(&empty[s], G);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t n_waves = (L + G - 1) / G;
  if (warp == G) {
    // Producer: wave i of this CTA goes to stage i % NBUF once the
    // consumers have released that stage's previous wave.
    unsigned i = 0;
    for (int64_t w = blockIdx.x; w < n_waves; w += gridDim.x, ++i) {
      const int s = i % NBUF;
      mbar_wait(&empty[s], ((i / NBUF) & 1) ^ 1);  // round 0 passes at once
      const int64_t j0 = w * G;
      const int n = (int)min((int64_t)G, L - j0);
      const long long b = lane < n ? clamp_blk(blk[j0 + lane], nblk) : 0;
      if (lane == 0) mbar_expect_tx(&full[s], (unsigned)n * BLOCK * 4);
      for (int k = 0; k < n; ++k) {
        const long long bk = __shfl_sync(FULL, b, k);
        if (lane == 0) bulk_copy(ring + (s * G + k) * BLOCK, table + bk * BLOCK, BLOCK * 4, &full[s]);
      }
    }
  } else {
    // Consumer warp `warp`: lookup w * G + warp of each wave.
    unsigned i = 0;
    for (int64_t w = blockIdx.x; w < n_waves; w += gridDim.x, ++i) {
      const int s = i % NBUF;
      const int64_t j = w * G + warp;
      const uint32_t qj = j < L ? q[j] : 0;
      mbar_wait(&full[s], (i / NBUF) & 1);
      if (j < L) {
        const uint4* v = reinterpret_cast<const uint4*>(ring + (s * G + warp) * BLOCK);
        unsigned l = 0, e = 0;
#pragma unroll
        for (int k = 0; k < BLOCK / 4 / 32; ++k) {
          const uint4 x = v[k * 32 + lane];
          l += (x.x < qj) + (x.y < qj) + (x.z < qj) + (x.w < qj);
          e += (x.x == qj) + (x.y == qj) + (x.z == qj) + (x.w == qj);
        }
        l = __reduce_add_sync(FULL, l);
        e = __reduce_add_sync(FULL, e);
        if (lane == 0) comp[j] = (int32_t)(l + (e << 12));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
}

// Grid of K5: as many CTAs as fit on the card at once (each walks waves),
// never more than there are waves.  The attribute and occupancy are read
// once per instantiation.
template <int G, int NBUF>
int launch_staged(const void* table, const void* blk, const void* q, void* comp,
                  long long L, long long nblk, cudaStream_t st) {
  static_assert(staged_smem<G, NBUF>() <= SMEM_LIMIT, "G x NBUF blocks exceed the shared memory of a CTA");
  constexpr int smem = staged_smem<G, NBUF>();
  constexpr int threads = (G + 1) * 32;
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(block_count_staged_kernel<G, NBUF>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_count_staged_kernel<G, NBUF>, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = per_sm * sms;
  }
  const long long waves = (L + G - 1) / G;
  const unsigned grid = (unsigned)(waves < slots ? waves : slots);
  block_count_staged_kernel<G, NBUF><<<grid, threads, smem, st>>>(
      (const uint32_t*)table, (const int32_t*)blk, (const uint32_t*)q, (int32_t*)comp,
      (int64_t)L, (int64_t)nblk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a template that is not built.

// variant: 0 full, 1 oneblock, 2 noreduce, 3 empty; g: empty's j % g.
int aitpu_block_count_pair(const void* table, const void* blk0, const void* blk1, const void* q,
                           void* comp, long long L, long long nblk, int stride, int variant,
                           int g, void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  return sector_pair<ARITY>(table, blk0, blk1, q, comp, L, nblk, stride, variant, g, (cudaStream_t)stream);
}

// e: 0..4 docids per lookup; r: 1024 or 128; mode: 0 onehot, 1 slice.
int aitpu_block_count_emit_docids(const void* inter, const void* blk, const void* q, void* comp,
                                  void* d, long long L, long long nblk, int e, int r, int mode,
                                  void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  return sector_emit<ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, e, r, mode, (cudaStream_t)stream);
}

// (g, nbuf): g in {1, 4, 8, 16}, nbuf in {2, 3, 4, 8, 16}, g * nbuf * 4 KB
// within the 227 KB of shared memory.
int aitpu_block_count_staged(const void* table, const void* blk, const void* q, void* comp,
                             long long L, long long nblk, int g, int nbuf, void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define AITPU_STAGED(G_, N_) \
  if (g == G_ && nbuf == N_) return launch_staged<G_, N_>(table, blk, q, comp, L, nblk, st);
  AITPU_STAGED(1, 2) AITPU_STAGED(1, 3) AITPU_STAGED(1, 4) AITPU_STAGED(1, 8) AITPU_STAGED(1, 16)
  AITPU_STAGED(4, 2) AITPU_STAGED(4, 3) AITPU_STAGED(4, 4) AITPU_STAGED(4, 8)
  AITPU_STAGED(8, 2) AITPU_STAGED(8, 3) AITPU_STAGED(8, 4)
  AITPU_STAGED(16, 2) AITPU_STAGED(16, 3)
#undef AITPU_STAGED
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
