"""The one traffic generator: requests built from a configuration's query
shape, a traffic file's parameters and --seed.

Search requests are msgpack `POST /<index>/_search` bodies
{"q": [hashes], "l": limit, "m": min_score, "s": pct, "t": timeout}: each
query takes `target_hashes` of a target doc's hashes, chosen by the seed,
and `noise_hashes` uniform u32 values, over a pool of `pool` queries whose
targets are uniform over the docs.  Update requests are msgpack `POST
/<index>/_update` bodies of `docs` inserts each, cycling over a closed
window of `window` ids above the corpus: update k writes ids
first + (k * docs mod window) ... with the version k * docs // window of
their hashes, so once the window is full every write overwrites docs.

Requests go to the load generator as one buffer: u64 count, then per
request u32 length and the whole HTTP request.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import msgpack
import numpy as np
import torch

from . import corpus as corpus_mod

MSGPACK = "application/vnd.msgpack"


def _http(path: str, body_len: int) -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: {MSGPACK}\r\n"
            f"Content-Length: {body_len}\r\n\r\n").encode()


def _array_head(n: int) -> bytes:
    return bytes([0x90 | n]) if n < 16 else b"\xdc" + struct.pack(">H", n)


def _u32_items(values: np.ndarray) -> np.ndarray:
    """(..., n) u32 values -> (..., n * 5) bytes: each as msgpack uint32."""
    out = np.empty(values.shape + (5,), np.uint8)
    out[..., 0] = 0xCE
    out[..., 1:] = values.astype(">u4").view(np.uint8).reshape(values.shape + (4,))
    return out.reshape(values.shape[:-1] + (values.shape[-1] * 5,))


def frame(rows: np.ndarray) -> bytes:
    """(N, L) request bytes, all of one length -> the load generator's buffer."""
    n, length = rows.shape
    out = np.empty((n, 4 + length), np.uint8)
    out[:, :4] = np.frombuffer(struct.pack("<I", length), np.uint8)
    out[:, 4:] = rows
    return struct.pack("<Q", n) + out.tobytes()


@dataclass
class Queries:
    hashes: torch.Tensor  # (N, Q) int64: the query hashes as sent
    targets: torch.Tensor  # (N,) target doc ids
    limit: int
    min_score: int
    pct: int


def make_queries(corpus, query: dict, n: int, seed: int, offset: int = 0, device=None) -> Queries:
    """The pool's queries [offset, offset + n) of the seed, computed on
    `device` (default the CPU), returned on the CPU."""
    k, m = int(query["target_hashes"]), int(query["noise_hashes"])
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    targets, th = corpus_mod.target_hashes(corpus, idx)
    if k < th.shape[1]:
        j = torch.arange(th.shape[1], dtype=torch.int64, device=device)
        keys = corpus_mod.draw(seed, corpus_mod.PICK, idx[:, None] * th.shape[1] + j)
        th = torch.gather(th, 1, torch.argsort(keys, 1)[:, :k])
    jn = torch.arange(m, dtype=torch.int64, device=device)
    noise = corpus_mod.draw(seed, corpus_mod.NOISE, idx[:, None] * m + jn)
    return Queries(torch.cat([th, noise], 1).cpu(), targets.cpu(), int(query["limit"]), int(query["min_score"]),
                   int(query["pct"]))


def search_requests(q: Queries, index: str, timeout_ms: int) -> bytes:
    n, width = q.hashes.shape
    tail = b"".join([b"\xa1l", msgpack.packb(q.limit), b"\xa1m", msgpack.packb(q.min_score),
                     b"\xa1s", msgpack.packb(q.pct), b"\xa1t", msgpack.packb(int(timeout_ms))])
    head = b"\x85\xa1q" + _array_head(width)
    body_len = len(head) + 5 * width + len(tail)
    prefix = _http(f"/{index}/_search", body_len) + head
    rows = np.empty((n, len(prefix) + 5 * width + len(tail)), np.uint8)
    rows[:, : len(prefix)] = np.frombuffer(prefix, np.uint8)
    rows[:, len(prefix) : len(prefix) + 5 * width] = _u32_items(q.hashes.numpy().astype(np.uint32))
    rows[:, len(prefix) + 5 * width :] = np.frombuffer(tail, np.uint8)
    return frame(rows)


@dataclass
class Updates:
    first_id: int
    window: int
    docs: int
    hashes_per_doc: int
    seed: int

    def ids_versions(self, k: int):
        """Ids (int64) and hash version of update k."""
        off = (k * self.docs) % self.window
        return torch.arange(off, off + self.docs, dtype=torch.int64) + self.first_id, (k * self.docs) // self.window

    def hashes(self, ids, version):
        """(len(ids), hashes_per_doc) hashes of ids at `version` (an int,
        or an int64 tensor of one version per id)."""
        j = torch.arange(self.hashes_per_doc, dtype=torch.int64)
        v = version[:, None] if torch.is_tensor(version) else version
        ctr = ((v * self.window + (ids[:, None] - self.first_id)) * self.hashes_per_doc + j)
        if int(ctr.max()) >= 1 << 32:
            raise ValueError("update counters past 2^32: too many versions")
        return corpus_mod.draw(self.seed, corpus_mod.UPDATE, ctr)

    def final(self, n_updates: int):
        """(ids, hashes, previous hashes) of the window after updates
        [0, n_updates): each id's newest version and the one before."""
        ids = torch.arange(self.window, dtype=torch.int64) + self.first_id
        writes = (n_updates * self.docs - torch.arange(self.window) + self.window - 1) // self.window
        if int(writes.min()) < 2:
            raise ValueError("the read-back needs every id written twice")
        return ids, self.hashes(ids, writes - 1), self.hashes(ids, writes - 2)

    def requests(self, index: str, k0: int, k1: int) -> bytes:
        """Updates [k0, k1) as _update requests."""
        change_head = b"\x81\xa1i\x82\xa1i\xce"
        hashes_head = b"\xa1h" + _array_head(self.hashes_per_doc)
        change_len = len(change_head) + 4 + len(hashes_head) + 5 * self.hashes_per_doc
        body_head = b"\x81\xa1c" + _array_head(self.docs)
        body_len = len(body_head) + self.docs * change_len
        prefix = _http(f"/{index}/_update", body_len) + body_head
        rows = np.empty((k1 - k0, len(prefix) + self.docs * change_len), np.uint8)
        rows[:, : len(prefix)] = np.frombuffer(prefix, np.uint8)
        for r, k in enumerate(range(k0, k1)):
            ids, v = self.ids_versions(k)
            ch = np.empty((self.docs, change_len), np.uint8)
            a = len(change_head)
            ch[:, :a] = np.frombuffer(change_head, np.uint8)
            ch[:, a : a + 4] = ids.numpy().astype(">u4").view(np.uint8).reshape(-1, 4)
            b = a + 4 + len(hashes_head)
            ch[:, a + 4 : b] = np.frombuffer(hashes_head, np.uint8)
            ch[:, b:] = _u32_items(self.hashes(ids, v).numpy().astype(np.uint32))
            rows[r, len(prefix) :] = ch.reshape(-1)
        return frame(rows)
