// The designs of K3 block_count_pair and K4 block_count_emit_docids
// (csrc/probe_lookup.cu) that the probes path does not launch, kept so
// that measure.py can time them beside the committed ones on one card, at
// the probes' shapes.  Second source of the "designs" library
// (ops/_build.py); measure.py binds them with ctypes and counts them in no
// LAUNCHES.  Same contracts, arguments and precondition as K3 and K4.
//
//   thread11 (K3 and K4, their first design): one thread per lookup, a
//     branch-free binary search to each bound, 11 dependent 4-byte loads
//     per bound halving from 512 (K3: the two blocks' four chains
//     interleaved in one loop, a disabled second block searching blk0 again
//     and masked); K4 then reads its E docids at lt + e, one more dependent
//     round.
//   sector (K3 and K4, at every arity of SECTOR_ARITIES = 2, 4, 8; K4 with
//     its second docid sector loaded eagerly in the last round or lazily
//     where needed): the sector search of csrc/sector_search.cuh, which
//     probe_lookup.cu launches at its ARITY and LAZY, so that the arities
//     and docid policies can be timed against each other.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sector_search.cuh"

namespace {

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

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
thread11_pair_kernel(const uint32_t* __restrict__ table,
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

template <int E, int R, int MODE>
__global__ void __launch_bounds__(THREADS)
thread11_emit_docids_kernel(const uint32_t* __restrict__ inter,
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

template <int VARIANT>
int launch_thread11_pair(const void* table, const void* blk0, const void* blk1, const void* q, void* comp,
                         long long L, long long nblk, int stride, int g, cudaStream_t st) {
  thread11_pair_kernel<VARIANT><<<grid_for(L, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)table, (const int32_t*)blk0, (const int32_t*)blk1, (const uint32_t*)q,
      (int32_t*)comp, (int64_t)L, (int64_t)nblk, stride, g);
  return (int)cudaGetLastError();
}

template <int E, int R, int MODE>
int launch_thread11_emit(const void* inter, const void* blk, const void* q, void* comp, void* d,
                         long long L, long long nblk, cudaStream_t st) {
  thread11_emit_docids_kernel<E, R, MODE><<<grid_for(L, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q, (int32_t*)comp,
      (uint32_t*)d, (int64_t)L, (int64_t)nblk);
  return (int)cudaGetLastError();
}

template <int E>
int thread11_emit_e(const void* inter, const void* blk, const void* q, void* comp, void* d,
                    long long L, long long nblk, int r, int mode, cudaStream_t st) {
  if (r == 1024 && mode == EMIT_ONEHOT) return launch_thread11_emit<E, 1024, EMIT_ONEHOT>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 1024 && mode == EMIT_SLICE) return launch_thread11_emit<E, 1024, EMIT_SLICE>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 128 && mode == EMIT_ONEHOT) return launch_thread11_emit<E, 128, EMIT_ONEHOT>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 128 && mode == EMIT_SLICE) return launch_thread11_emit<E, 128, EMIT_SLICE>(inter, blk, q, comp, d, L, nblk, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a template or arity that is not built.  The
// arguments are those of aitpu_block_count_pair /
// aitpu_block_count_emit_docids, the sector designs' plus `arity`, one of
// SECTOR_ARITIES: 2, 4, 8, and K4's `lazy` (0 or 1).

int aitpu_design_pair_thread11(const void* table, const void* blk0, const void* blk1, const void* q,
                               void* comp, long long L, long long nblk, int stride, int variant,
                               int g, void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case PAIR_FULL: return launch_thread11_pair<PAIR_FULL>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_ONEBLOCK: return launch_thread11_pair<PAIR_ONEBLOCK>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_NOREDUCE: return launch_thread11_pair<PAIR_NOREDUCE>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_EMPTY: return launch_thread11_pair<PAIR_EMPTY>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

int aitpu_design_emit_docids_thread11(const void* inter, const void* blk, const void* q, void* comp,
                                      void* d, long long L, long long nblk, int e, int r, int mode,
                                      void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (e) {
    case 0: return thread11_emit_e<0>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 1: return thread11_emit_e<1>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 2: return thread11_emit_e<2>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 3: return thread11_emit_e<3>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 4: return thread11_emit_e<4>(inter, blk, q, comp, d, L, nblk, r, mode, st);
  }
  return (int)cudaErrorInvalidValue;
}

int aitpu_design_pair_sector(const void* table, const void* blk0, const void* blk1, const void* q,
                             void* comp, long long L, long long nblk, int stride, int variant,
                             int g, int arity, void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (arity) {
    case 2: return sector_pair<2>(table, blk0, blk1, q, comp, L, nblk, stride, variant, g, st);
    case 4: return sector_pair<4>(table, blk0, blk1, q, comp, L, nblk, stride, variant, g, st);
    case 8: return sector_pair<8>(table, blk0, blk1, q, comp, L, nblk, stride, variant, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

int aitpu_design_emit_docids_sector(const void* inter, const void* blk, const void* q, void* comp,
                                    void* d, long long L, long long nblk, int e, int r, int mode,
                                    int arity, int lazy, void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (arity * 2 + (lazy != 0)) {
    case 4: return sector_emit<2, false>(inter, blk, q, comp, d, L, nblk, e, r, mode, st);
    case 5: return sector_emit<2, true>(inter, blk, q, comp, d, L, nblk, e, r, mode, st);
    case 8: return sector_emit<4, false>(inter, blk, q, comp, d, L, nblk, e, r, mode, st);
    case 9: return sector_emit<4, true>(inter, blk, q, comp, d, L, nblk, e, r, mode, st);
    case 16: return sector_emit<8, false>(inter, blk, q, comp, d, L, nblk, e, r, mode, st);
    case 17: return sector_emit<8, true>(inter, blk, q, comp, d, L, nblk, e, r, mode, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
