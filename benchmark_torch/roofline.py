"""The least work of the range phase, counted by the benchmark from the
queries it sent and the corpus it made, and the card's peaks.

The range phase finds, for every distinct hash of a query, its run of
postings in the sorted tier.  It needs, at the least (the needed-bytes
arithmetic of acoustid_index_tpu_torch/measure.py:kernel_bound, carried
to a whole query):
  * the 32-byte sectors that hold the entries on each side of the run's
    two bounds (positions lo - 1, lo, hi - 1, hi, within the tier),
    counted once per query;
  * 8 bytes for each posting in the run (its hash and its docid);
  * the query hash read (4 bytes) and its run written as (lo, count)
    (8 bytes).
Positions map to the interleaved tier's words: block b of 1,024 postings
holds its hashes in words [2048 b, 2048 b + 1024) (ops/layout.py, the
layout of every tier at these sizes).
"""

from __future__ import annotations

import json
import os

import torch

from . import reference

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = 1024
SECTOR_WORDS = 8


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def range_bytes_per_query(corpus, hashes) -> float:
    """Mean needed bytes of the range phase over the query rows `hashes`."""
    h, valid = reference.distinct_hashes(hashes.cpu())
    lo, cnt = corpus.runs(h)
    n_post = corpus.n_postings
    bounds = torch.stack([lo - 1, lo, lo + cnt - 1, lo + cnt], -1).clamp(0, n_post - 1)
    word = (bounds // BLOCK) * 2 * BLOCK + bounds % BLOCK
    sector = torch.where(valid[..., None], word // SECTOR_WORDS, -1).reshape(h.shape[0], -1)
    s = torch.sort(sector, 1).values
    distinct = (s >= 0) & torch.cat([torch.ones_like(s[:, :1], dtype=torch.bool), s[:, 1:] != s[:, :-1]], 1)
    per_query = distinct.sum(1) * 32 + torch.where(valid, cnt * 8 + 12, 0).sum(1)
    return float(per_query.to(torch.float64).mean())
