"""File segments loaded onto the card at restart, and the file tier packed
there from their bytes.

The host path (filefmt.read_segment, then segments.pack_tier_np and the
upload) reads the whole file, decodes its delta-varints on one thread and
lays the tier out in numpy: at 2^30 postings, tens of seconds while the
card sits idle.  Here:

  * `read_segment_card` streams the payload from the file into pinned
    chunks (`os.preadv`, READ_WORKERS threads, two chunks each) and copies
    each chunk to the card as it lands; the payload CRC is computed on the
    host beside the copies, one `zlib.crc32` per chunk (it releases the
    interpreter lock), and the chunks' CRCs are combined in order
    (`crc32_combine`), so it is zlib's own and bit-equal by construction.
    The checks are filefmt's, in its order: magic, header, identity,
    truncation, payload CRC, footer CRC, then the postings stream's varint
    count (ops/varint.scan, the host decoder's -1 as a ValueError).  The
    mentioned docs are decoded on the card and copied back (the mention
    table and the docs runs are host numpy); the postings stay on the card
    as their file bytes.
  * `pack_tier_card` builds the tier on the card.  One segment decodes
    straight into the tier's layout (ops/varint.decode: no columns, no
    sort; the segment's tier is its sorted postings).  Several segments
    decode to columns, drop their superseded postings (a doc that a newer
    segment mentions: filter_superseded's rule, by the newest mention
    ordinal of each doc) and sort by hash with ties in segment order (one
    int64 key, hash then position: ops/build._sorted_keys).  Every field
    equals pack_tier_np's, byte for byte; the host fields come from the
    same segments.tier_frame.
  * `CardSegment` is a memseg.Segment whose `hashes`/`docids` are made on
    first access by one copy back from the card: from the tier for a
    segment packed alone, else from its file bytes decoded again on the
    card.  A segment packed with others keeps those bytes in host memory
    after the pack, not on the card beside the tier.  Later repacks (after
    a checkpoint or merge), merges and snapshots read the columns; nothing
    decodes on the host or in the background.

Index.open takes this path whenever its searcher's device is a card; the
functions also take CPU tensors (ops/varint's plain versions), which the
CPU tests use.
"""

from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import varint
from ..ops.build import _sorted_keys
from ..ops.layout import BLOCK, resident_max_bytes, to_storage, u32, use_interleaved
from ..utils.profiling import bump, counters, trace
from . import filefmt
from .memseg import Segment
from .model import SegmentInfo
from .segments import build_mention_table, tier_frame, tier_from_numpy

READ_CHUNK = 32 << 20  # bytes per pinned chunk of the payload stream
READ_WORKERS = 4  # threads reading, checksumming and copying chunks
FETCH_POSTINGS = 1 << 26  # postings per step of a copy back from the tier
_BIAS = 1 << 31
_M32 = 0xFFFFFFFF

# Segments Index.open loaded by each path, and the copy-backs that fired,
# in the registry as `open.card_segments`, `open.host_segments`,
# `segments.columns_fetched`.
OPEN = counters("open", {"card_segments": 0, "host_segments": 0})
COLUMNS = counters("segments", {"columns_fetched": 0})


# ---- CRC-32 of a payload read in chunks ----

_POLY = 0xEDB88320  # zlib's polynomial, reflected


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the CRC polynomial (zlib's multmodp)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if (a & (m - 1)) == 0:
                return p
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1


_X2N = [1 << 30]  # x^(2^k) modulo the polynomial
for _ in range(31):
    _X2N.append(_multmodp(_X2N[-1], _X2N[-1]))


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib.crc32(a + b) from crc1 = zlib.crc32(a), crc2 = zlib.crc32(b)
    and len2 = len(b) (zlib's crc32_combine)."""
    p, k = 1 << 31, 3  # x^0; len2 bytes are 8 * len2 bits: x^(len2 * 2^3)
    while len2:
        if len2 & 1:
            p = _multmodp(_X2N[k & 31], p)
        len2 >>= 1
        k += 1
    return _multmodp(p, crc1) ^ crc2


# ---- the payload stream ----


def _stream_payload(fd: int, pos: int, length: int, sinks, device: torch.device) -> int:
    """Copy the file's bytes [pos, pos + length) into `sinks` ((offset in
    the payload, uint8 tensor on `device` or numpy array) each, covering
    the payload in order) through pinned chunks; returns their CRC-32."""
    nchunks = -(-length // READ_CHUNK)
    crcs = [0] * nchunks
    workers = min(READ_WORKERS, nchunks)
    card = device.type == "cuda"

    def copy(buf, c0: int, size: int) -> None:
        for off, dst in sinks:
            a, b = max(c0, off), min(c0 + size, off + dst.shape[0])
            if a < b:
                if isinstance(dst, np.ndarray):
                    dst[a - off : b - off] = buf.numpy()[a - c0 : b - c0]
                else:
                    dst[a - off : b - off].copy_(buf[a - c0 : b - c0], non_blocking=card)

    def work(w: int) -> None:
        bufs = [torch.empty(READ_CHUNK, dtype=torch.uint8, pin_memory=card) for _ in range(2)]
        done: List[Optional[torch.cuda.Event]] = [None, None]
        stream = torch.cuda.Stream(device) if card else None
        for k, c in enumerate(range(w, nchunks, workers)):
            buf = bufs[k & 1]
            if done[k & 1] is not None:
                done[k & 1].synchronize()  # its last copy has left the buffer
            c0 = c * READ_CHUNK
            size = min(READ_CHUNK, length - c0)
            view = memoryview(buf.numpy())[:size]
            got = 0
            while got < size:
                r = os.preadv(fd, [view[got:]], pos + c0 + got)
                if r <= 0:
                    raise ValueError("segment file shrank while it was read")
                got += r
            with trace("open.crc"):
                crcs[c] = zlib.crc32(view)
            if card:
                with torch.cuda.stream(stream):
                    copy(buf, c0, size)
                    done[k & 1] = torch.cuda.Event()
                    done[k & 1].record(stream)
            else:
                copy(buf, c0, size)
        for ev in done:
            if ev is not None:
                ev.synchronize()

    if workers:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(work, range(workers)))
    crc = 0
    for c in range(nchunks):
        crc = crc32_combine(crc, crcs[c], min(READ_CHUNK, length - c * READ_CHUNK))
    return crc


# ---- a segment's postings on the card ----


class _FileBytes:
    """A segment's postings as its file holds them: "dv1" varints (with
    their chunk starts, checked) or "raw" u32 columns, on the device they
    were read to (`device`) until `to_host` moves them to host memory."""

    def __init__(self, enc: str, data: torch.Tensor, n: int, starts: Optional[torch.Tensor]):
        self.enc, self.data, self.n, self.starts = enc, data, n, starts
        self.device = data.device

    def to_host(self) -> None:
        """Keep the bytes in host memory, off the card."""
        self.data = self.data.cpu()
        if self.starts is not None:
            self.starts = self.starts.cpu()

    def columns(self, device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hashes, docids), int32 on `device` (default `self.device`); bytes
        held in host memory are copied there first."""
        n = self.n
        data = self.data.to(device or self.device)
        if self.enc == "raw":
            return data[: 4 * n].view(torch.int32), data[4 * n : 8 * n].view(torch.int32)
        h = torch.empty(n, dtype=torch.int32, device=data.device)
        d = torch.empty(n, dtype=torch.int32, device=data.device)
        varint.decode(data, self.starts.to(data.device), n, True, h, d, BLOCK, n)
        return h, d

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        # Raw columns are read where they are; varints decode on the card.
        h, d = self.columns(self.data.device if self.enc == "raw" else None)
        return _to_host(h), _to_host(d)


class _TierColumns:
    """A segment that was packed alone: its postings are the tier's first n."""

    def __init__(self, tier: Dict, n: int):
        self.fields = {k: tier[k] for k in ("inter", "hashes", "docids") if k in tier}
        self.n = n

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        n = self.n
        h = np.empty(n, np.uint32)
        d = np.empty(n, np.uint32)
        for s in range(0, n, FETCH_POSTINGS):  # FETCH_POSTINGS is a multiple of BLOCK
            e = min(s + FETCH_POSTINGS, n)
            if "inter" in self.fields:
                blocks = self.fields["inter"][2 * s : 2 * (-(-e // BLOCK) * BLOCK)].view(-1, 2, BLOCK)
                hs, ds = blocks[:, 0].reshape(-1)[: e - s], blocks[:, 1].reshape(-1)[: e - s]
            else:
                hs, ds = self.fields["hashes"][s:e], self.fields["docids"][s:e]
            torch.from_numpy(h[s:e].view(np.int32)).copy_(hs)
            torch.from_numpy(d[s:e].view(np.int32)).copy_(ds)
        return h, d


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


class CardSegment(Segment):
    """A file segment whose postings live on the card.  `hashes` and
    `docids` are made on first access, by one copy back from the card (see
    the module's docstring), and kept; every other field is host numpy as
    in a Segment.  A subclass with lazy columns, not a new type, so that
    every consumer of Segment takes it unchanged; it compares and hashes by
    identity, as the dataclass's field-wise ones would copy the columns
    back."""

    def __init__(self, info, docs_ids, docs_alive, min_doc_id, max_doc_id, metadata, postings: _FileBytes):
        for k, v in (("info", info), ("docs_ids", docs_ids), ("docs_alive", docs_alive),
                     ("min_doc_id", min_doc_id), ("max_doc_id", max_doc_id), ("metadata", metadata)):
            object.__setattr__(self, k, v)
        object.__setattr__(self, "_n", postings.n)
        object.__setattr__(self, "_source", postings)
        object.__setattr__(self, "_columns", None)
        object.__setattr__(self, "_lock", threading.Lock())

    __eq__ = object.__eq__
    __hash__ = object.__hash__

    def __repr__(self) -> str:
        return f"CardSegment(info={self.info!r}, num_items={self._n}, num_docs={self.num_docs})"

    @property
    def num_items(self) -> int:
        return self._n

    @property
    def file_bytes(self) -> Optional[_FileBytes]:
        """The postings as file bytes on the card, until the segment's tier
        or its host columns take their place."""
        src = self._source
        return src if isinstance(src, _FileBytes) else None

    def _columns_now(self) -> Tuple[np.ndarray, np.ndarray]:
        cols = self._columns
        if cols is None:
            with self._lock:
                cols = self._columns
                if cols is None:
                    with trace("segments.fetch_columns"):
                        cols = self._source.fetch()
                    object.__setattr__(self, "_columns", cols)
                    object.__setattr__(self, "_source", None)
                    bump(COLUMNS, "columns_fetched")
        return cols

    @property
    def hashes(self) -> np.ndarray:
        return self._columns_now()[0]

    @property
    def docids(self) -> np.ndarray:
        return self._columns_now()[1]

    def _packed_alone(self, tier: Dict) -> None:
        with self._lock:
            if self._columns is None:
                object.__setattr__(self, "_source", _TierColumns(tier, self._n))

    def _packed_with_others(self) -> None:
        with self._lock:
            if isinstance(self._source, _FileBytes):
                self._source.to_host()


# ---- read ----


def on_card(device) -> bool:
    """Whether Index.open loads its file segments by this path: whenever
    the searcher's device is a card."""
    return torch.device(device).type == "cuda"


def read_segment_card(dir_path: str, info: SegmentInfo, device) -> CardSegment:
    """filefmt.read_segment's checks, in its order, with the postings left
    on `device` as the file's bytes."""
    device = torch.device(device)
    path = os.path.join(dir_path, filefmt.segment_file_name(info))
    with open(path, "rb", buffering=0) as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        if head[:4] in (filefmt.MAGIC_RAW, filefmt.MAGIC_DV) and len(head) == 8:
            head += f.read(min(filefmt.U32.unpack_from(head, 4)[0], size - 8))
        magic, hdr, file_info, header_bytes, pos, end = filefmt.parse_header(head, path, info)
        n, m = hdr["num_items"], hdr["num_docs"]
        if size < end:
            raise ValueError(f"truncated segment file {path}")

        if magic == filefmt.MAGIC_DV:
            pb, db = hdr["postings_bytes"], hdr["docs_bytes"]
            postings = torch.empty(pb, dtype=torch.uint8, device=device)
            docs = torch.empty(db, dtype=torch.uint8, device=device)
            host = np.empty(end - pos - pb - db, np.uint8)  # the alive bits
            sinks = [(0, postings), (pb, docs), (pb + db, host)]
        else:
            postings = torch.empty(8 * n, dtype=torch.uint8, device=device)
            host = np.empty(end - pos - 8 * n, np.uint8)  # docs_ids, then one byte per alive flag
            sinks = [(0, postings), (8 * n, host)]
        with trace("open.upload"):
            crc = _stream_payload(f.fileno(), pos, end - pos, sinks, device)
        if crc != hdr["crc"]:
            raise ValueError(f"segment payload checksum mismatch in {path}")
        (footer,) = filefmt.U32.unpack_from(os.pread(f.fileno(), 4, end), 0)
        if footer != zlib.crc32(header_bytes):
            raise ValueError(f"segment footer checksum mismatch in {path}")

    if magic == filefmt.MAGIC_DV:
        with trace("open.scan"):
            starts = varint.scan(postings, 2 * n)
        with trace("open.docs"):
            docs_ids = _to_host(varint.decode_columns(docs, m, pairs=False)[0])
        del docs
        file_postings = _FileBytes("dv1", postings, n, starts)
        docs_alive = filefmt._unpack_alive(host, m)
    else:
        file_postings = _FileBytes("raw", postings, n, None)
        docs_ids = host[: 4 * m].view("<u4").astype(np.uint32)
        docs_alive = host[4 * m :].astype(bool)
    return CardSegment(
        info=file_info,
        docs_ids=docs_ids,
        docs_alive=docs_alive,
        min_doc_id=hdr["min_doc_id"],
        max_doc_id=hdr["max_doc_id"],
        metadata=tuple(hdr.get("metadata", {}).items()),
        postings=file_postings,
    )


# ---- pack ----


def _normal(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def packs_on_card(segments: Sequence[Segment], device) -> bool:
    """True when every segment is a CardSegment that still holds its file
    bytes on `device`: the tier is then built there from them."""
    device = _normal(device)
    return bool(segments) and all(
        isinstance(s, CardSegment) and s.file_bytes is not None and s.file_bytes.data.device == device
        for s in segments
    )


def _live_columns(segments: Sequence[CardSegment], mention_table) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each segment's (hashes, docids) on the card with the postings of docs
    that a newer segment mentions dropped: filter_superseded's rule, read
    from the mention table (build_mention_table's: a doc's newest
    mentioning segment), and skipped where no newer segment's doc range
    meets the segment's."""
    ids, ords = mention_table
    dev = segments[0].file_bytes.data.device
    ids_dev = torch.as_tensor(ids.astype(np.int64), device=dev)
    ords_dev = torch.as_tensor(ords.astype(np.int64), device=dev)
    out = []
    newer_lo = newer_hi = None
    for k in range(len(segments) - 1, -1, -1):
        s = segments[k]
        h, d = s.file_bytes.columns()
        if newer_lo is not None and s.num_items and s.min_doc_id <= newer_hi and s.max_doc_id >= newer_lo:
            d64 = u32(d)
            loc = torch.searchsorted(ids_dev, d64).clamp(max=ids_dev.shape[0] - 1)
            newest = torch.where(ids_dev[loc] == d64, ords_dev[loc], k)
            keep = newest <= k
            h, d = h[keep], d[keep]
        out.append((h, d))
        if s.num_docs:
            lo, hi = int(s.docs_ids[0]), int(s.docs_ids[-1])
            newer_lo = lo if newer_lo is None else min(newer_lo, lo)
            newer_hi = hi if newer_hi is None else max(newer_hi, hi)
    return out[::-1]


def _lay_out(h: torch.Tensor, d: torch.Tensor, cap: int, interleaved: bool) -> Dict:
    """Sorted postings (int32 columns) as the tier's device fields."""
    dev = h.device
    hp = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    dp = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    hp[: h.shape[0]] = h
    dp[: d.shape[0]] = d
    out = {"block_index": hp[::BLOCK].clone()}
    if interleaved:
        inter = torch.empty(2 * cap, dtype=torch.int32, device=dev)
        v = inter.view(-1, 2, BLOCK)
        v[:, 0] = hp.view(-1, BLOCK)
        v[:, 1] = dp.view(-1, BLOCK)
        out["inter"] = inter
    else:
        out["hashes"], out["docids"] = hp, dp
    return out


def pack_tier_card(
    segments: Sequence[CardSegment],
    slots: int,
    min_cap: int = 1024,
    min_slots: int = 0,
    min_caps: Optional[Tuple[int, int, int]] = None,
    mentions: bool = True,
) -> Dict:
    """segments.pack_tier's view, built on the segments' device from their
    file bytes; equal to pack_tier_np's, field for field."""
    dev = segments[0].file_bytes.data.device
    with trace("open.frame"):
        mention_table = build_mention_table(segments)
    with trace("open.decode"):
        live = None if len(segments) == 1 else _live_columns(segments, mention_table)
    lens = [segments[0].num_items] if live is None else [h.shape[0] for h, _ in live]
    with trace("open.frame"):
        frame, cap = tier_frame(segments, lens, slots, min_cap, min_slots, min_caps, mention_table)
        view = tier_from_numpy(frame, dev, mentions=mentions)
    interleaved = use_interleaved(cap, resident_max_bytes())
    with trace("open.decode"):
        if live is None and segments[0].file_bytes.enc == "dv1":
            src = segments[0].file_bytes
            if interleaved:
                inter = torch.empty(2 * cap, dtype=torch.int32, device=dev)
                hashes, docids, bstride = inter, inter[BLOCK:], 2 * BLOCK
                fields = {"inter": inter}
            else:
                hashes = torch.empty(cap, dtype=torch.int32, device=dev)
                docids = torch.empty(cap, dtype=torch.int32, device=dev)
                bstride = BLOCK
                fields = {"hashes": hashes, "docids": docids}
            fields["block_index"] = torch.empty(cap // BLOCK, dtype=torch.int32, device=dev)
            varint.decode(src.data, src.starts, src.n, True, hashes, docids, bstride, cap, fields["block_index"])
        elif live is None:
            fields = _lay_out(*segments[0].file_bytes.columns(), cap, interleaved)
        else:
            h = torch.cat([h for h, _ in live])
            d = torch.cat([d for _, d in live])
            del live
            # Stable by hash, ties in segment order: one int64 key of
            # (hash, position), every key distinct.
            key = ((u32(h) - _BIAS) << 32) | torch.arange(h.shape[0], device=dev)
            del h
            key = _sorted_keys(key)
            fields = _lay_out(to_storage((key >> 32) + _BIAS), d[key & _M32], cap, interleaved)
            del key, d
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    view.update(fields)
    if len(segments) == 1:
        segments[0]._packed_alone(view)
    else:  # their columns are not the tier's: the bytes go to host memory
        for s in segments:
            s._packed_with_others()
    return view
