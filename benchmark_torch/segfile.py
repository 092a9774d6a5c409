"""The data directory that one checkpointed file segment leaves, written
by the benchmark's own copy of the program's segment-file writer.

Copied from acoustid_index_tpu_torch/engine/filefmt.py (`write_segment`,
format "ATS2" with the "dv1" delta-varint columns of csrc/aitpu_native.cc),
engine/manifest.py and multi/redirect.py.  The varints are computed on the
card in a few large tensor operations instead of a C++ loop.  The file is
fsynced as the original writes it, so that its write-back is over before
the window opens.

Layout under `root`:
    <index>/current                     redirect {"n", "g": 1, "d": false}
    <index>/v000001/data/manifest       [[1, 0, nil]]
    <index>/v000001/data/<commit 1>.seg the segment, every doc alive
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from queue import Queue
from typing import Iterable, Tuple

import msgpack
import numpy as np
import torch

M32 = 0xFFFFFFFF
U32 = struct.Struct("<I")
GENERATION = 1
COMMIT_ID = 1


def segment_file_name(commit_id: int, merges: int) -> str:
    return f"{commit_id:016x}-{merges:08x}.seg"


def varints(v):
    """LEB128 bytes (uint8 tensor) of u32 values v (int64 tensor), in order."""
    n = (1 + (v >= 1 << 7).to(torch.int64) + (v >= 1 << 14).to(torch.int64)
         + (v >= 1 << 21).to(torch.int64) + (v >= 1 << 28).to(torch.int64))
    start = torch.cumsum(n, 0) - n
    total = int(start[-1] + n[-1]) if v.numel() else 0
    out = torch.empty(total, dtype=torch.uint8, device=v.device)
    for k in range(5):
        m = n > k
        b = ((v[m] >> (7 * k)) & 0x7F) | torch.where(n[m] > k + 1, 0x80, 0)
        out[start[m] + k] = b.to(torch.uint8)
    return out


def encode_postings(chunks: Iterable[Tuple[torch.Tensor, torch.Tensor]], sink) -> int:
    """dv1 postings of the sorted (hash, docid) chunks, handed to sink()
    as host byte arrays in order; returns the postings count.  Each hash
    is the delta from the previous posting's; each docid the delta from
    the previous one where the hash repeats, else the docid itself."""
    prev_h, prev_d, first, n = 0, 0, True, 0
    for h, d in chunks:
        if not h.numel():
            continue
        ph = torch.cat([h.new_tensor([prev_h]), h[:-1]])
        pd = torch.cat([d.new_tensor([prev_d]), d[:-1]])
        dh = (h - ph) & M32
        same = dh == 0
        if first:
            same[0] = False
        dv = torch.where(same, (d - pd) & M32, d)
        sink(varints(torch.stack([dh, dv], 1).reshape(-1)).cpu().numpy())
        prev_h, prev_d, first = int(h[-1]), int(d[-1]), False
        n += int(h.numel())
    return n


class _Crc:
    """Running CRC-32 of the parts, computed on a thread beside the card's
    encoding; keeps the parts in order."""

    def __init__(self):
        self.crc, self.parts, self.nbytes = 0, [], 0
        self._q: Queue = Queue()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while (part := self._q.get()) is not None:
            self.crc = zlib.crc32(part, self.crc)

    def __call__(self, part: np.ndarray):
        self.parts.append(part)
        self.nbytes += part.nbytes
        self._q.put(part)

    def close(self) -> int:
        self._q.put(None)
        self._t.join()
        return self.crc


def write_segment(data_dir: str, corpus, dev) -> str:
    """The corpus as one ATS2 segment of commit 1 in data_dir; returns the
    file name."""
    crc = _Crc()
    n_items = encode_postings(corpus.sorted_chunks(dev), crc)
    postings_bytes = crc.nbytes
    lo, hi = corpus.docs_range()
    docs = torch.arange(lo, hi + 1, dtype=torch.int64, device=dev)
    crc(varints(docs - torch.cat([docs.new_zeros(1), docs[:-1]])).cpu().numpy())
    docs_bytes = crc.nbytes - postings_bytes
    m = hi - lo + 1
    alive = np.full((m + 7) // 8, 0xFF, np.uint8)
    if m % 8:
        alive[-1] = (1 << (m % 8)) - 1
    crc(alive)
    header = {
        "info": [COMMIT_ID, 0, None],
        "metadata": {},
        "num_items": n_items,
        "num_docs": m,
        "min_doc_id": lo,
        "max_doc_id": hi,
        "enc": "dv1",
        "postings_bytes": postings_bytes,
        "docs_bytes": docs_bytes,
        "crc": crc.close(),
    }
    header_bytes = msgpack.packb(header, use_bin_type=True)
    name = segment_file_name(COMMIT_ID, 0)
    with open(os.path.join(data_dir, name), "wb") as f:
        f.write(b"ATS2")
        f.write(U32.pack(len(header_bytes)))
        f.write(header_bytes)
        for part in crc.parts:
            f.write(memoryview(part))
        f.write(U32.pack(zlib.crc32(header_bytes)))
        f.flush()
        os.fsync(f.fileno())
    return name


def write_data_dir(root: str, index: str, corpus, dev) -> int:
    """The data directory of one index holding the corpus as one file
    segment; returns the segment file's size in bytes."""
    name_dir = os.path.join(root, index)
    data_dir = os.path.join(name_dir, f"v{GENERATION:06d}", "data")
    os.makedirs(data_dir)
    name = write_segment(data_dir, corpus, dev)
    with open(os.path.join(data_dir, "manifest"), "wb") as f:
        f.write(msgpack.packb([[COMMIT_ID, 0, None]], use_bin_type=True))
    with open(os.path.join(name_dir, "current"), "wb") as f:
        f.write(msgpack.packb({"n": index, "g": GENERATION, "d": False}, use_bin_type=True))
    return os.path.getsize(os.path.join(data_dir, name))
