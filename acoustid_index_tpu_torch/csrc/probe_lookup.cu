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
// blocks.  Like K1 it searches each block (one thread per lookup, a
// branch-free binary search to each bound), so each block must be
// non-decreasing as u32; every probe table is (arange, sorted random,
// sentinel padding).  The two blocks' four chains of eleven dependent loads
// run interleaved in one loop; a disabled second block searches blk0 again
// (the lines it reads are the ones just read) and is masked.  VARIANT is
// _probe_floor.py:30-48's bisection of the per-lookup cost: FULL the
// window, ONEBLOCK blk0 only, NOREDUCE comp = (blk0's first hash < q),
// EMPTY comp = j % g (no table read).  Bound: the sectors at each bound of
// each enabled block, plus 12 B in and 4 B out per lookup; the
// dependent-load chain, not bytes, is what it costs.
//
// K4 block_count_emit_docids (replaces probes/_probe_fused.py:76-119
// fused_call and the docid modes of probes/_probe_fused2.py:32-108
// make_kernel): K2's search over a table of hash/docid blocks, plus E
// docid scalars per lookup: comp[j] = lt + (eq << 12) and d[e][j] =
// docids[lt + e] for lt + e < BLOCK, else 0 (the one-hot extraction of
// _probe_fused.py:101-102 and _probe_fused2.py:77-79).  R is the
// interleave granularity: each block is 2048 words of alternating R-word
// runs of hashes and docids -- R = 1024 the port's interleaved layout (the
// probes' row-major (16, 128) tile), R = 128 _probe_fused2's lane-major
// (8, 256) tile.  MODE SLICE is _probe_fused2.py:80-87's row-slice
// extraction: it reads docid row min(p >> 7, 7), lane p & 127, so for p =
// lt + e >= 1024 it gives docids[896 + (p & 127)] instead of 0.  It writes
// 4 * (1 + E) bytes per lookup where K2 writes 1 KB: bound by the sectors
// at its two bounds plus those holding the E docids, and that output.
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

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 1024;  // hashes per block
constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // 227 KB: the dynamic shared memory one CTA may use

__device__ __forceinline__ int64_t clamp_blk(int64_t b, int64_t nblk) {
  return b < 0 ? 0 : (b >= nblk ? nblk - 1 : b);
}

// Hash i of a block whose hashes are contiguous.
struct Flat {
  const uint32_t* h;
  __device__ __forceinline__ uint32_t operator()(unsigned i) const { return __ldg(h + i); }
};

// Hash i (or, with OFF = R, docid i) of a block of alternating R-word runs.
template <int R, int OFF>
struct Split {
  const uint32_t* b;
  __device__ __forceinline__ uint32_t operator()(unsigned i) const {
    return __ldg(b + (i / R) * (2 * R) + OFF + (i % R));
  }
};

// Lower bound `lt` (#entries < q) and upper bound `ub` (#entries <= q) of q
// in one sorted block: block_lookup.cu's thread_search over a loader.
template <class A>
__device__ __forceinline__ void search(const A& at, uint32_t q, unsigned* lt, unsigned* ub) {
  unsigned l = 0, u = 0;
#pragma unroll
  for (unsigned half = BLOCK / 2; half > 0; half >>= 1) {
    l += at(l + half - 1) < q ? half : 0;
    u += at(u + half - 1) <= q ? half : 0;
  }
  *lt = l + (at(l) < q);
  *ub = u + (at(u) <= q);
}

// The same for two blocks at once: four independent chains in one loop.
__device__ __forceinline__ void search2(const Flat& a, const Flat& b, uint32_t q,
                                        unsigned* lt0, unsigned* ub0,
                                        unsigned* lt1, unsigned* ub1) {
  unsigned l0 = 0, u0 = 0, l1 = 0, u1 = 0;
#pragma unroll
  for (unsigned half = BLOCK / 2; half > 0; half >>= 1) {
    l0 += a(l0 + half - 1) < q ? half : 0;
    u0 += a(u0 + half - 1) <= q ? half : 0;
    l1 += b(l1 + half - 1) < q ? half : 0;
    u1 += b(u1 + half - 1) <= q ? half : 0;
  }
  *lt0 = l0 + (a(l0) < q);
  *ub0 = u0 + (a(u0) <= q);
  *lt1 = l1 + (b(l1) < q);
  *ub1 = u1 + (b(u1) <= q);
}

// ---- K3 ----

enum PairVariant { PAIR_FULL = 0, PAIR_ONEBLOCK = 1, PAIR_NOREDUCE = 2, PAIR_EMPTY = 3 };

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
block_count_pair_kernel(const uint32_t* __restrict__ table,
                        const int32_t* __restrict__ blk0,
                        const int32_t* __restrict__ blk1,
                        const uint32_t* __restrict__ q,
                        int32_t* __restrict__ comp,
                        int64_t L, int64_t nblk, int stride, int g) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= L) return;
  unsigned lt = 0, eq = 0;
  if (VARIANT == PAIR_EMPTY) {
    lt = (unsigned)(j % g);
  } else {
    const uint32_t qj = q[j];
    const Flat h0{table + clamp_blk(blk0[j], nblk) * stride * BLOCK};
    if (VARIANT == PAIR_NOREDUCE) {
      lt = h0(0) < qj;
    } else if (VARIANT == PAIR_ONEBLOCK) {
      unsigned ub;
      search(h0, qj, &lt, &ub);
      eq = ub - lt;
    } else {
      const int32_t b1 = blk1[j];
      const unsigned on = b1 > 0;
      const Flat h1{on ? table + clamp_blk(b1, nblk) * stride * BLOCK : h0.h};
      unsigned l0, u0, l1, u1;
      search2(h0, h1, qj, &l0, &u0, &l1, &u1);
      lt = l0 + on * l1;
      eq = (u0 - l0) + on * (u1 - l1);
    }
  }
  comp[j] = (int32_t)(lt + (eq << 12));
}

// ---- K4 ----

enum EmitMode { EMIT_ONEHOT = 0, EMIT_SLICE = 1 };

template <int E, int R, int MODE>
__global__ void __launch_bounds__(THREADS)
block_count_emit_docids_kernel(const uint32_t* __restrict__ inter,
                               const int32_t* __restrict__ blk,
                               const uint32_t* __restrict__ q,
                               int32_t* __restrict__ comp,
                               uint32_t* __restrict__ d,
                               int64_t L, int64_t nblk) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= L) return;
  const uint32_t* base = inter + clamp_blk(blk[j], nblk) * 2 * BLOCK;
  unsigned lt, ub;
  search(Split<R, 0>{base}, q[j], &lt, &ub);
  comp[j] = (int32_t)(lt + ((ub - lt) << 12));
  const Split<R, R> docid{base};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const unsigned p = lt + e;
    uint32_t v = 0;
    if (MODE == EMIT_SLICE) {
      v = docid(min(p >> 7, (unsigned)(BLOCK / 128 - 1)) * 128 + (p & 127));
    } else if (p < BLOCK) {
      v = docid(p);
    }
    d[e * L + j] = v;  // row e of the (E, L) output: coalesced per e
  }
}

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

inline unsigned grid_for(int64_t L, int per_cta) {
  return (unsigned)((L + per_cta - 1) / per_cta);
}

template <int VARIANT>
int launch_pair(const void* table, const void* blk0, const void* blk1, const void* q, void* comp,
                long long L, long long nblk, int stride, int g, cudaStream_t st) {
  block_count_pair_kernel<VARIANT><<<grid_for(L, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)table, (const int32_t*)blk0, (const int32_t*)blk1, (const uint32_t*)q,
      (int32_t*)comp, (int64_t)L, (int64_t)nblk, stride, g);
  return (int)cudaGetLastError();
}

template <int E, int R, int MODE>
int launch_emit(const void* inter, const void* blk, const void* q, void* comp, void* d,
                long long L, long long nblk, cudaStream_t st) {
  block_count_emit_docids_kernel<E, R, MODE><<<grid_for(L, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q, (int32_t*)comp,
      (uint32_t*)d, (int64_t)L, (int64_t)nblk);
  return (int)cudaGetLastError();
}

template <int E>
int launch_emit_e(const void* inter, const void* blk, const void* q, void* comp, void* d,
                  long long L, long long nblk, int r, int mode, cudaStream_t st) {
  if (r == 1024 && mode == EMIT_ONEHOT) return launch_emit<E, 1024, EMIT_ONEHOT>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 1024 && mode == EMIT_SLICE) return launch_emit<E, 1024, EMIT_SLICE>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 128 && mode == EMIT_ONEHOT) return launch_emit<E, 128, EMIT_ONEHOT>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 128 && mode == EMIT_SLICE) return launch_emit<E, 128, EMIT_SLICE>(inter, blk, q, comp, d, L, nblk, st);
  return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case PAIR_FULL: return launch_pair<PAIR_FULL>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_ONEBLOCK: return launch_pair<PAIR_ONEBLOCK>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_NOREDUCE: return launch_pair<PAIR_NOREDUCE>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_EMPTY: return launch_pair<PAIR_EMPTY>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// e: 0..4 docids per lookup; r: 1024 or 128; mode: 0 onehot, 1 slice.
int aitpu_block_count_emit_docids(const void* inter, const void* blk, const void* q, void* comp,
                                  void* d, long long L, long long nblk, int e, int r, int mode,
                                  void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (e) {
    case 0: return launch_emit_e<0>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 1: return launch_emit_e<1>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 2: return launch_emit_e<2>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 3: return launch_emit_e<3>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 4: return launch_emit_e<4>(inter, blk, q, comp, d, L, nblk, r, mode, st);
  }
  return (int)cudaErrorInvalidValue;
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
