"""The plain reference of the search semantics, and the control.

A query's hashes are de-duplicated; each posting of each hash counts one
hit for its doc; docs are ranked by (score desc, id asc); the answer
stops at `limit`, at the first score below min_score, and, once the first
result is in, at the first score below max(min_score, best * pct // 100)
(the reference's SearchResults.finish, upstream fpindex common.zig).  The
sources are the corpus and, in the read/write cell, the newest version of
every written doc; no doc id lies in two sources, so no supersession
arises between them.  Plain PyTorch on the host; it imports nothing of the
program and takes nothing the program made.

The control breaks the guarantee of exact answers in the way a faster
program would be tempted to: it answers from the first half of each
query's sorted distinct hashes only, as a narrower query bucket would.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import msgpack
import torch

Answer = List[Tuple[int, int]]


class Postings:
    """A source of sorted (hash, docid) postings: hashes (int64) and docids."""

    def __init__(self, hashes, docids):
        order = torch.argsort(((hashes - (1 << 31)) << 32) | docids)
        self.hashes, self.docids = hashes[order], docids[order]

    def runs(self, q):
        flat = q.reshape(-1)
        lo = torch.searchsorted(self.hashes, flat)
        hi = torch.searchsorted(self.hashes, flat, right=True)
        return lo.reshape(q.shape), (hi - lo).reshape(q.shape)

    def docids_at(self, pos):
        return self.docids[pos]


def distinct_hashes(hashes, control: bool = False):
    """(sorted hashes, valid mask) of each query row; the control keeps the
    first half (rounded up) of each row's distinct hashes."""
    h = torch.sort(hashes, 1).values
    valid = torch.ones_like(h, dtype=torch.bool)
    valid[:, 1:] = h[:, 1:] != h[:, :-1]
    if control:
        rank = torch.cumsum(valid.to(torch.int64), 1)
        keep = (valid.sum(1, keepdim=True) + 1) // 2
        valid &= rank <= keep
    return h, valid


def scores(sources: Sequence, hashes, control: bool = False):
    """(query index, docid, score) of every doc with a hit, int64 tensors."""
    h, valid = distinct_hashes(hashes.cpu(), control)
    n, width = h.shape
    qs, ds = [], []
    for src in sources:
        lo, cnt = src.runs(h)
        cnt = torch.where(valid, cnt, 0).reshape(-1)
        lo = lo.reshape(-1)
        total = int(cnt.sum())
        if not total:
            continue
        row = torch.repeat_interleave(torch.arange(n * width), cnt)
        within = torch.arange(total) - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        qs.append(row // width)
        ds.append(src.docids_at(lo[row] + within).to(torch.int64))
    if not qs:
        z = torch.zeros(0, dtype=torch.int64)
        return z, z, z
    key, score = torch.unique(torch.cat(qs) * (1 << 32) + torch.cat(ds), return_counts=True)
    return key >> 32, key & 0xFFFFFFFF, score


def search(sources: Sequence, hashes, limit: int, min_score: int, pct: int, control: bool = False) -> List[Answer]:
    """The answer [(id, score), ...] to each query row of `hashes`."""
    n = hashes.shape[0]
    if n >= 1 << 17:
        raise ValueError("at most 2^17 queries per call")
    q, d, s = scores(sources, hashes, control)
    order = torch.argsort((q << 45) | ((4096 - s) << 32) | d)
    q, d, s = q[order].tolist(), d[order].tolist(), s[order].tolist()
    out: List[Answer] = [[] for _ in range(n)]
    ms = [min_score] * n
    for qi, di, si in zip(q, d, s):
        a = out[qi]
        if len(a) >= limit or si < ms[qi]:
            continue
        if not a:
            ms[qi] = max(ms[qi], si * pct // 100)
        a.append((di, si))
    return out


def decode(status: int, body: bytes):
    """A search response as an answer, or None where it is not a 200 with
    a well-formed body."""
    if status != 200:
        return None
    try:
        d = msgpack.unpackb(body, strict_map_key=False)
        return [(int(r["i"]), int(r["s"])) for r in d["r"]]
    except (ValueError, KeyError, TypeError, msgpack.UnpackException):
        return None
