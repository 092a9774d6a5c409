"""The corpora of the configurations, made from --seed.

Every value comes from a counter hash of (seed, stream, index) in 32-bit
integer arithmetic on int64 tensors, so the same seed gives the same
corpus and queries on the card and on the CPU.  A configuration's
`corpus.kind` picks the class:

  * "uniform": docs 1..docs, each with `hashes_per_doc` hashes uniform
    over u32 (bench.py's 10M shape, the hashes drawn from the seed).
  * "bands": the reference bench_100m.py's corpus of 2^doc_bits docs of 8
    hashes, one per band of 2^29 hash values.  In band j the sorted
    position p holds hash j * 2^29 + f(p, j), f monotone in p
    (bench_100m._f_np, copied), so the postings are sorted by
    construction, with pair runs of 2 docs and hot runs of 64.  The seed
    chooses the bijection from position to doc id (an affine map of
    bitrev(p) modulo 2^doc_bits), where the reference bench fixes
    bitrev(p).

Each class gives the postings sorted by (hash, docid) in chunks for the
segment writer, the hashes of given docs for the queries, and for any
query hashes their runs in that sorted order and the docids of the
postings in them, for the plain reference and the needed-bytes count.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

M32 = 0xFFFFFFFF

# Streams of the counter hash: one per kind of value drawn.
CORPUS, TARGET, PICK, NOISE, UPDATE, SAMPLE, PERM = range(1, 8)


def _mul32(h, c: int):
    """(h * c) mod 2^32 for u32 values h held in int64, without overflow."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & M32


def fmix32(h):
    """murmur3's 32-bit finalizer over u32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def stream_keys(seed: int, stream: int) -> Tuple[int, int]:
    """Two 32-bit keys of (seed, stream); any seed below 2^64."""
    if not 0 <= seed < 1 << 64:
        raise ValueError("seed must be in [0, 2^64)")
    lo, hi = seed & M32, (seed >> 32) & M32
    k1 = _fmix32_int(lo ^ _fmix32_int((hi + 0x9E3779B9 * stream) & M32))
    k2 = _fmix32_int(k1 ^ _fmix32_int((stream * 0x85EBCA77 + 0x165667B1) & M32))
    return k1, k2


def draw(seed: int, stream: int, idx):
    """u32 values (int64 tensor) of (seed, stream) at counters idx (int64
    tensor, each below 2^32).  The sum of two mixes of the counter is not
    a bijection, so equal values occur as often as with random draws."""
    k1, k2 = stream_keys(seed, stream)
    return (fmix32(idx ^ k1) + fmix32((idx + k2) & M32)) & M32


def below(seed: int, stream: int, idx, n: int):
    """Integers uniform in [0, n) at counters idx (n <= 2^31)."""
    return (draw(seed, stream, idx) * n) >> 32


def _sort_pairs(h, d):
    """(hash, docid) int64 tensors sorted by the pair, as one int64 key."""
    key = torch.sort(((h - (1 << 31)) << 32) | d).values
    return (key >> 32) + (1 << 31), key & M32


class UniformCorpus:
    """docs 1..n_docs, hashes_per_doc hashes each, uniform over u32."""

    def __init__(self, spec: dict, seed: int):
        self.seed = seed
        self.n_docs = int(spec["docs"])
        self.hpd = int(spec["hashes_per_doc"])
        if self.n_docs * self.hpd >= 1 << 32:
            raise ValueError("uniform corpus: docs * hashes_per_doc must stay below 2^32")
        self.n_postings = self.n_docs * self.hpd
        self._hashes = None  # sorted, host int64
        self._docids = None  # host int32

    def doc_hashes(self, docs):
        """(len(docs), hpd) hashes of docs (1-based int64 tensor)."""
        j = torch.arange(self.hpd, dtype=torch.int64, device=docs.device)
        return draw(self.seed, CORPUS, (docs[:, None] - 1) * self.hpd + j)

    def random_docs(self, idx):
        """Doc ids (1-based) drawn uniformly at counters idx."""
        return below(self.seed, TARGET, idx, self.n_docs) + 1

    def docs_range(self) -> Tuple[int, int]:
        return 1, self.n_docs

    def sorted_chunks(self, dev, chunk: int = 1 << 25) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The postings sorted by (hash, docid), sorted on `dev`, in chunks
        of `chunk` postings (int64 tensors on dev).  Keeps a host copy for
        runs()/postings()."""
        step = max(1, (1 << 24) // self.hpd)
        hs, ds = [], []
        for lo in range(1, self.n_docs + 1, step):
            docs = torch.arange(lo, min(lo + step, self.n_docs + 1), dtype=torch.int64, device=dev)
            hs.append(self.doc_hashes(docs).reshape(-1))
            ds.append(docs.repeat_interleave(self.hpd))
        h, d = _sort_pairs(torch.cat(hs), torch.cat(ds))
        del hs, ds
        self._hashes = h.cpu()
        self._docids = d.to(torch.int32).cpu()
        for s in range(0, self.n_postings, chunk):
            yield h[s : s + chunk], d[s : s + chunk]

    def _host(self):
        if self._hashes is None:
            for _ in self.sorted_chunks(torch.device("cpu")):
                pass
        return self._hashes, self._docids

    def runs(self, q):
        """(lo, count): the run of each hash of q (int64 tensor, any shape)
        in the sorted postings."""
        h, _ = self._host()
        flat = q.reshape(-1).cpu()
        lo = torch.searchsorted(h, flat)
        hi = torch.searchsorted(h, flat, right=True)
        return lo.reshape(q.shape), (hi - lo).reshape(q.shape)

    def docids_at(self, pos):
        """Docids (int64) of sorted postings at positions pos."""
        return self._host()[1][pos].to(torch.int64)


# ---- "bands": the reference bench_100m.py's corpus ----

BAND = 1 << 29


def bitrev(v, bits: int):
    r = torch.zeros_like(v)
    for b in range(bits):
        r |= ((v >> b) & 1) << (bits - 1 - b)
    return r


def band_f(p, j):
    """bench_100m._f_np: band j's in-band offset of sorted position p."""
    hot = ((p >> 6) + j) % (1 << 15) == 0
    pair = ((p + j) % 8 == 7) & (p > 0)
    return torch.where(hot, (p & ~63) * 4, torch.where(pair, (p - 1) * 4, p * 4))


class BandsCorpus:
    """2^doc_bits docs of 8 hashes, one per band (bench_100m.py)."""

    HASHES_PER_DOC = 8

    def __init__(self, spec: dict, seed: int):
        self.seed = seed
        self.bits = int(spec["doc_bits"])
        if int(spec.get("hashes_per_doc", 8)) != self.HASHES_PER_DOC or not 6 <= self.bits <= 27:
            raise ValueError("bands corpus: 8 hashes per doc, doc_bits in [6, 27]")
        self.n_docs = 1 << self.bits
        self.hpd = self.HASHES_PER_DOC
        self.n_postings = self.n_docs * self.hpd
        k1, k2 = stream_keys(seed, PERM)
        self.mul = (k1 | 1) & (self.n_docs - 1)  # odd: a bijection modulo 2^bits
        self.add = k2 & (self.n_docs - 1)

    def doc_at(self, p):
        """Doc id (1-based) at sorted position p."""
        return ((bitrev(p, self.bits) * self.mul + self.add) & (self.n_docs - 1)) + 1

    def position_hashes(self, p):
        j = torch.arange(self.hpd, dtype=torch.int64, device=p.device)
        return j * BAND + band_f(p[:, None], j)

    def random_positions(self, idx):
        return below(self.seed, TARGET, idx, self.n_docs)

    def docs_range(self) -> Tuple[int, int]:
        return 1, self.n_docs

    def sorted_chunks(self, dev, chunk: int = 0):
        """One chunk per band: hashes ascend band by band; inside a run of
        equal hashes the docids are sorted on `dev`."""
        p = torch.arange(self.n_docs, dtype=torch.int64, device=dev)
        d = self.doc_at(p)
        for j in range(self.hpd):
            yield _sort_pairs(j * BAND + band_f(p, j), d)

    def _first(self, target, j):
        """First position p with f(p, j) >= target (int64 tensors)."""
        lo = torch.zeros_like(target)
        count = torch.full_like(target, self.n_docs)
        while bool((count > 0).any()):
            step = count // 2
            go = (count > 0) & (band_f(lo + step, j) < target)
            lo = torch.where(go, lo + step + 1, lo)
            count = torch.where(go, count - step - 1, torch.where(count > 0, step, count))
        return lo

    def runs(self, q):
        flat = q.reshape(-1).cpu().to(torch.int64)
        j = flat >> 29
        off = flat & (BAND - 1)
        a = self._first(off, j)
        b = self._first(off + 1, j)
        return (j * self.n_docs + a).reshape(q.shape), (b - a).reshape(q.shape)

    def docids_at(self, pos):
        """Docids at sorted positions: the set of a run's docids is that of
        its positions, which is all the reference needs (it counts them)."""
        return self.doc_at(pos % self.n_docs)


KINDS = {"uniform": UniformCorpus, "bands": BandsCorpus}


def make(spec: dict, seed: int):
    return KINDS[spec["kind"]](spec, seed)


def target_hashes(corpus, idx):
    """(targets, hashes): for query counters idx, the target doc ids and
    their hashes (len(idx), hashes_per_doc)."""
    if isinstance(corpus, BandsCorpus):
        p = corpus.random_positions(idx)
        return corpus.doc_at(p), corpus.position_hashes(p)
    docs = corpus.random_docs(idx)
    return docs, corpus.doc_hashes(docs)
