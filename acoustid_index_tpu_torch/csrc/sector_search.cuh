// The sector search of K3 block_count_pair and K4 block_count_emit_docids
// (csrc/probe_lookup.cu, whose source note gives the design and its
// reasons), as templates over the arity of a round.  probe_lookup.cu
// launches them at its ARITY (and K4 at its LAZY); csrc/probe_lookup_designs.cu
// builds every arity of SECTOR_ARITIES, both ways, into the "designs"
// library, for measure.py.
//
// A block is 128 sectors of 32 bytes, 8 sorted u32 hashes each.  Per bound
// (lt = #hashes < q, ub = #hashes <= q) the search finds the bound's
// sector s = #{t in 1..127 : first hash of sector t is below the bound}
// in rounds of independent loads: a round of arity K over an interval of
// SIZE sectors from base b reads the first hashes of sectors
// b + CHUNK * i (i = 1..K-1, CHUNK = SIZE / K) and moves b by CHUNK per
// pivot below; 128 -> 1 takes 7 bits (ARITY 2: 7 rounds of 1 pivot; 4: 4
// rounds of 3, 3, 3, 1; 8: 3 rounds of 7, 7, 1).  One more round
// loads sector s as two 16-byte loads and counts it: the bound is 8 s +
// #(hashes of sector s below it).  lt and ub share a round's loads while
// their bases agree; where a run of hashes equal to q straddles a pivot
// they part, and ub issues its own loads in the same round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 1024;  // hashes per block
constexpr int SECTOR = 8;    // u32 per 32-byte sector
constexpr int SECTORS = BLOCK / SECTOR;
constexpr int THREADS = 256;

__device__ __forceinline__ int64_t clamp_blk(int64_t b, int64_t nblk) {
  return b < 0 ? 0 : (b >= nblk ? nblk - 1 : b);
}

inline unsigned grid_for(int64_t L, int per_cta) {
  return (unsigned)((L + per_cta - 1) / per_cta);
}

// Hash i, and the 32-byte sector s, of a block whose hashes are contiguous.
struct Flat {
  const uint32_t* h;
  __device__ __forceinline__ uint32_t operator()(unsigned i) const { return __ldg(h + i); }
  __device__ __forceinline__ const uint4* sector(unsigned s) const {
    return reinterpret_cast<const uint4*>(h + s * SECTOR);
  }
};

// The same (OFF = R: the docids) of a block of alternating R-word runs;
// R >= SECTOR, so a sector never straddles two runs.
template <int R, int OFF>
struct Split {
  static_assert(R % SECTOR == 0, "a sector must lie inside one run");
  const uint32_t* b;
  __device__ __forceinline__ uint32_t operator()(unsigned i) const {
    return __ldg(b + (i / R) * (2 * R) + OFF + (i % R));
  }
  __device__ __forceinline__ const uint4* sector(unsigned s) const {
    const unsigned i = s * SECTOR;
    return reinterpret_cast<const uint4*>(b + (i / R) * (2 * R) + OFF + (i % R));
  }
};

// The descent of NB blocks at once: the rounds from an interval of SIZE
// sectors down to one.  Block n takes part where on[n]; its loads are
// predicated off elsewhere.  sl[n] / su[n]: the lt / ub sector.
template <int ARITY, int SIZE, int NB, class A>
__device__ __forceinline__ void descend(const A (&at)[NB], const bool (&on)[NB], uint32_t q,
                                        unsigned (&sl)[NB], unsigned (&su)[NB]) {
  if constexpr (SIZE > 1) {
    constexpr int K = SIZE < ARITY ? SIZE : ARITY;
    constexpr int CHUNK = SIZE / K;
    uint32_t xl[NB][K - 1], xu[NB][K - 1];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 1; i < K; ++i) {
        xl[n][i - 1] = on[n] ? at[n](SECTOR * (sl[n] + CHUNK * i)) : 0u;
        xu[n][i - 1] = on[n] && su[n] != sl[n] ? at[n](SECTOR * (su[n] + CHUNK * i)) : xl[n][i - 1];
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      unsigned ml = 0, mu = 0;
#pragma unroll
      for (int i = 0; i < K - 1; ++i) {
        ml += xl[n][i] < q;
        mu += xu[n][i] <= q;
      }
      sl[n] += CHUNK * ml;
      su[n] += CHUNK * mu;
    }
    descend<ARITY, CHUNK, NB>(at, on, q, sl, su);
  }
}

// The last round's loads: sector s of a block, as two 16-byte loads
// (ld.global.nc.v4.u32), or zeros where the block is off.
template <class A>
__device__ __forceinline__ void load_sector(const A& at, unsigned s, bool on, uint4 (&v)[2]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  v[0] = on ? __ldg(at.sector(s)) : zero;
  v[1] = on ? __ldg(at.sector(s) + 1) : zero;
}

__device__ __forceinline__ unsigned count_lt(const uint4 (&v)[2], uint32_t q) {
  return (v[0].x < q) + (v[0].y < q) + (v[0].z < q) + (v[0].w < q) +
         (v[1].x < q) + (v[1].y < q) + (v[1].z < q) + (v[1].w < q);
}

__device__ __forceinline__ unsigned count_le(const uint4 (&v)[2], uint32_t q) {
  return (v[0].x <= q) + (v[0].y <= q) + (v[0].z <= q) + (v[0].w <= q) +
         (v[1].x <= q) + (v[1].y <= q) + (v[1].z <= q) + (v[1].w <= q);
}

// lt and ub of q in NB sorted blocks: the descent, then each block's final
// sector(s), all blocks' loads in the same rounds.
template <int ARITY, int NB, class A>
__device__ __forceinline__ void sector_search(const A (&at)[NB], const bool (&on)[NB], uint32_t q,
                                              unsigned (&lt)[NB], unsigned (&ub)[NB]) {
  unsigned sl[NB], su[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) sl[n] = su[n] = 0;
  descend<ARITY, SECTORS, NB>(at, on, q, sl, su);
  uint4 vl[NB][2], vu[NB][2];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    load_sector(at[n], sl[n], on[n], vl[n]);
    load_sector(at[n], su[n], on[n] && su[n] != sl[n], vu[n]);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    lt[n] = SECTOR * sl[n] + count_lt(vl[n], q);
    ub[n] = SECTOR * su[n] + (su[n] != sl[n] ? count_le(vu[n], q) : count_le(vl[n], q));
  }
}

// ---- K3 ----

enum PairVariant { PAIR_FULL = 0, PAIR_ONEBLOCK = 1, PAIR_NOREDUCE = 2, PAIR_EMPTY = 3 };

template <int VARIANT, int ARITY>
__global__ void __launch_bounds__(THREADS)
sector_pair_kernel(const uint32_t* __restrict__ table,
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
      const Flat at[1] = {h0};
      const bool on[1] = {true};
      unsigned l[1], u[1];
      sector_search<ARITY>(at, on, qj, l, u);
      lt = l[0];
      eq = u[0] - l[0];
    } else {
      const int32_t b1 = blk1[j];
      const Flat at[2] = {h0, Flat{table + clamp_blk(b1, nblk) * stride * BLOCK}};
      const bool on[2] = {true, b1 > 0};  // blk1 == 0 disables the second block
      unsigned l[2], u[2];
      sector_search<ARITY>(at, on, qj, l, u);
      lt = l[0] + (on[1] ? l[1] : 0);
      eq = (u[0] - l[0]) + (on[1] ? u[1] - l[1] : 0);
    }
  }
  comp[j] = (int32_t)(lt + (eq << 12));
}

template <int VARIANT, int ARITY>
int launch_sector_pair(const void* table, const void* blk0, const void* blk1, const void* q, void* comp,
                       long long L, long long nblk, int stride, int g, cudaStream_t st) {
  sector_pair_kernel<VARIANT, ARITY><<<grid_for(L, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)table, (const int32_t*)blk0, (const int32_t*)blk1, (const uint32_t*)q,
      (int32_t*)comp, (int64_t)L, (int64_t)nblk, stride, g);
  return (int)cudaGetLastError();
}

template <int ARITY>
int sector_pair(const void* table, const void* blk0, const void* blk1, const void* q, void* comp,
                long long L, long long nblk, int stride, int variant, int g, cudaStream_t st) {
  switch (variant) {
    case PAIR_FULL: return launch_sector_pair<PAIR_FULL, ARITY>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_ONEBLOCK: return launch_sector_pair<PAIR_ONEBLOCK, ARITY>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_NOREDUCE: return launch_sector_pair<PAIR_NOREDUCE, ARITY>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
    case PAIR_EMPTY: return launch_sector_pair<PAIR_EMPTY, ARITY>(table, blk0, blk1, q, comp, L, nblk, stride, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- K4 ----

enum EmitMode { EMIT_ONEHOT = 0, EMIT_SLICE = 1 };

// Word t of the 12 words w (docid sector A, then the first 4 of B).
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[12], unsigned t) {
  uint32_t v = 0;
#pragma unroll
  for (unsigned i = 0; i < 12; ++i) v = t == i ? w[i] : v;
  return v;
}

// The hash sector that fixes lt is s, so lt is in 8s .. 8s + 8 and the E
// <= 4 docids at lt + e lie in docid sector s (A) and the first half of
// sector s + 1 (B).  A is loaded in the hash sector's round.  B is too
// (LAZY false), or, LAZY, only where lt + E - 1 reaches it, in one more
// round: a lookup then reads the docid sectors it needs and no more.  Past
// the block (s = 127, lt + e >= 1024) B is zeros ("onehot") or the first
// half of docid sector 112, docids 896 + (p & 127) ("slice": row
// min(p >> 7, 7)).
template <int E, int R, int MODE, int ARITY, bool LAZY>
__global__ void __launch_bounds__(THREADS)
sector_emit_docids_kernel(const uint32_t* __restrict__ inter,
                          const int32_t* __restrict__ blk,
                          const uint32_t* __restrict__ q,
                          int32_t* __restrict__ comp,
                          uint32_t* __restrict__ d,
                          int64_t L, int64_t nblk) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= L) return;
  const uint32_t* base = inter + clamp_blk(blk[j], nblk) * 2 * BLOCK;
  const uint32_t qj = q[j];
  const Split<R, 0> at[1] = {Split<R, 0>{base}};
  const bool on[1] = {true};
  unsigned sl[1] = {0}, su[1] = {0};
  descend<ARITY, SECTORS, 1>(at, on, qj, sl, su);
  const unsigned s = sl[0], t = su[0];
  const Split<R, R> docid{base};
  const bool past = s + 1 >= SECTORS;
  const bool b_exists = !past || MODE == EMIT_SLICE;
  const unsigned nb = past ? (BLOCK - 128) / SECTOR : s + 1;
  // The last round: the hash sector(s) and the docid sectors together.
  uint4 vl[2], vu[2], a[2], b = make_uint4(0u, 0u, 0u, 0u);
  load_sector(at[0], s, true, vl);
  load_sector(at[0], t, t != s, vu);
  if (E > 0) {
    load_sector(docid, s, true, a);
    if (!LAZY && b_exists) b = __ldg(docid.sector(nb));
  }
  const unsigned lt = SECTOR * s + count_lt(vl, qj);
  const unsigned ub = SECTOR * t + (t != s ? count_le(vu, qj) : count_le(vl, qj));
  comp[j] = (int32_t)(lt + ((ub - lt) << 12));
  if (E > 0) {
    if (LAZY && b_exists && lt - SECTOR * s + E - 1 >= SECTOR) b = __ldg(docid.sector(nb));
    const uint32_t w[12] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w,
                            b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < E; ++e) d[e * L + j] = pick(w, lt - SECTOR * s + e);  // row e of (E, L)
  }
}

template <int E, int R, int MODE, int ARITY, bool LAZY>
int launch_sector_emit(const void* inter, const void* blk, const void* q, void* comp, void* d,
                       long long L, long long nblk, cudaStream_t st) {
  sector_emit_docids_kernel<E, R, MODE, ARITY, LAZY><<<grid_for(L, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)inter, (const int32_t*)blk, (const uint32_t*)q, (int32_t*)comp,
      (uint32_t*)d, (int64_t)L, (int64_t)nblk);
  return (int)cudaGetLastError();
}

template <int E, int ARITY, bool LAZY>
int sector_emit_e(const void* inter, const void* blk, const void* q, void* comp, void* d,
                  long long L, long long nblk, int r, int mode, cudaStream_t st) {
  if (r == 1024 && mode == EMIT_ONEHOT) return launch_sector_emit<E, 1024, EMIT_ONEHOT, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 1024 && mode == EMIT_SLICE) return launch_sector_emit<E, 1024, EMIT_SLICE, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 128 && mode == EMIT_ONEHOT) return launch_sector_emit<E, 128, EMIT_ONEHOT, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, st);
  if (r == 128 && mode == EMIT_SLICE) return launch_sector_emit<E, 128, EMIT_SLICE, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, st);
  return (int)cudaErrorInvalidValue;
}

template <int ARITY, bool LAZY>
int sector_emit(const void* inter, const void* blk, const void* q, void* comp, void* d,
                long long L, long long nblk, int e, int r, int mode, cudaStream_t st) {
  switch (e) {
    case 0: return sector_emit_e<0, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 1: return sector_emit_e<1, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 2: return sector_emit_e<2, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 3: return sector_emit_e<3, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, r, mode, st);
    case 4: return sector_emit_e<4, ARITY, LAZY>(inter, blk, q, comp, d, L, nblk, r, mode, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
