"""Segment file format.

Two encodings behind one reader:

  * "ATS2" (default): delta-varint compressed columns via the native codec
    (native/aitpu_native.cc; ~4x smaller than raw, decoded once at load) —
    the storage role the reference's StreamVByte blocks play
    (upstream fpindex's src/filefmt.zig, block.zig), except decode happens at
    load time, not per query: the TPU search path reads raw HBM columns.
  * "ATS1": raw little-endian u32 columns, written when no codec is
    available; np.frombuffer maps them straight into the packed device view.

Layout (both):
    magic (4 bytes)
    u32 header_len, msgpack header {
        "info": [commit_id, merges, version|nil],
        "metadata": {k: v},
        "num_items": N, "num_docs": M,
        "min_doc_id": int, "max_doc_id": int,
        "crc": crc32 of the payload bytes,
        ATS2 only: "enc": "dv1", "postings_bytes", "docs_bytes",
    }
    payload columns (encoding-dependent)
    u32 footer = crc32(header bytes)  (written last: presence = complete file)

Writes are atomic: temp file + fsync + rename, like the reference
(filefmt.zig:183-203). Reads verify magic, counts and checksums.  On a card,
Index.open reads with engine/card_tier.read_segment_card instead: the same
checks (parse_header here), its varints decoded on the card.

The port's copy of acoustid_index_tpu/engine/filefmt.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import msgpack
import numpy as np

from ..utils import native
from .memseg import Segment
from .model import SegmentInfo

MAGIC_RAW = b"ATS1"
MAGIC_DV = b"ATS2"
U32 = struct.Struct("<I")


def segment_file_name(info: SegmentInfo) -> str:
    return f"{info.commit_id:016x}-{info.merges:08x}.seg"


def _pack_alive(docs_alive: np.ndarray) -> bytes:
    return np.packbits(docs_alive.astype(bool), bitorder="little").tobytes()


def _unpack_alive(buf: bytes, m: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(buf, np.uint8), count=m, bitorder="little").astype(bool)


def write_segment(dir_path: str, segment: Segment) -> str:
    """Atomically write `segment`; returns the file name."""
    name = segment_file_name(segment.info)
    tmp = os.path.join(dir_path, name + ".tmp")
    final = os.path.join(dir_path, name)

    postings_dv = native.encode_postings(segment.hashes, segment.docids)
    docs_dv = native.encode_sorted_u32(segment.docs_ids)

    header = {
        "info": segment.info.to_wire(),
        "metadata": dict(segment.metadata),
        "num_items": segment.num_items,
        "num_docs": segment.num_docs,
        "min_doc_id": segment.min_doc_id,
        "max_doc_id": segment.max_doc_id,
    }

    if postings_dv is not None and docs_dv is not None:
        magic = MAGIC_DV
        alive = _pack_alive(segment.docs_alive)
        parts = [postings_dv, docs_dv, alive]
        header["enc"] = "dv1"
        header["postings_bytes"] = len(postings_dv)
        header["docs_bytes"] = len(docs_dv)
    else:
        magic = MAGIC_RAW
        parts = [
            np.ascontiguousarray(segment.hashes, dtype="<u4").tobytes(),
            np.ascontiguousarray(segment.docids, dtype="<u4").tobytes(),
            np.ascontiguousarray(segment.docs_ids, dtype="<u4").tobytes(),
            np.ascontiguousarray(segment.docs_alive, dtype=np.uint8).tobytes(),
        ]

    crc = 0
    for part in parts:
        crc = zlib.crc32(part, crc)
    header["crc"] = crc
    header_bytes = msgpack.packb(header, use_bin_type=True)

    with open(tmp, "wb") as f:
        f.write(magic)
        f.write(U32.pack(len(header_bytes)))
        f.write(header_bytes)
        for part in parts:
            f.write(part)
        f.write(U32.pack(zlib.crc32(header_bytes)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return name


def parse_header(data: bytes, path: str, info: SegmentInfo):
    """(magic, header, file info, header bytes, payload start, payload end)
    of the segment file whose leading bytes are `data` (at least its magic,
    length word and header), with its magic and identity checked."""
    magic = data[:4]
    if magic not in (MAGIC_RAW, MAGIC_DV):
        raise ValueError(f"bad segment magic in {path}")
    (header_len,) = U32.unpack_from(data, 4)
    header_start = 8
    header_bytes = data[header_start : header_start + header_len]
    hdr = msgpack.unpackb(header_bytes, strict_map_key=False)
    file_info = SegmentInfo.from_wire(hdr["info"])
    if (file_info.commit_id, file_info.merges) != (info.commit_id, info.merges):
        raise ValueError(f"segment identity mismatch in {path}: {file_info} != {info}")

    n = hdr["num_items"]
    m = hdr["num_docs"]
    pos = header_start + header_len
    if magic == MAGIC_DV:
        end = pos + hdr["postings_bytes"] + hdr["docs_bytes"] + (m + 7) // 8
    else:
        end = pos + 4 * n + 4 * n + 4 * m + m
    return magic, hdr, file_info, header_bytes, pos, end


def read_segment(dir_path: str, info: SegmentInfo) -> Segment:
    path = os.path.join(dir_path, segment_file_name(info))
    with open(path, "rb") as f:
        data = f.read()
    magic, hdr, file_info, header_bytes, pos, end = parse_header(data, path, info)
    n = hdr["num_items"]
    m = hdr["num_docs"]

    payload = data[pos:end]
    if len(payload) != end - pos:
        raise ValueError(f"truncated segment file {path}")
    if zlib.crc32(payload) != hdr["crc"]:
        raise ValueError(f"segment payload checksum mismatch in {path}")
    (footer,) = U32.unpack_from(data, end)
    if footer != zlib.crc32(header_bytes):
        raise ValueError(f"segment footer checksum mismatch in {path}")

    if magic == MAGIC_DV:
        pb = hdr["postings_bytes"]
        db = hdr["docs_bytes"]
        hashes, docids = native.decode_postings(payload[:pb], n)
        docs_ids = native.decode_sorted_u32(payload[pb : pb + db], m)
        docs_alive = _unpack_alive(payload[pb + db :], m)
    else:
        hashes = np.frombuffer(payload, dtype="<u4", count=n, offset=0).astype(np.uint32)
        docids = np.frombuffer(payload, dtype="<u4", count=n, offset=4 * n).astype(np.uint32)
        docs_ids = np.frombuffer(payload, dtype="<u4", count=m, offset=8 * n).astype(np.uint32)
        docs_alive = np.frombuffer(payload, dtype=np.uint8, count=m, offset=8 * n + 4 * m).astype(bool)

    return Segment(
        info=file_info,
        hashes=hashes,
        docids=docids,
        docs_ids=docs_ids,
        docs_alive=docs_alive,
        min_doc_id=hdr["min_doc_id"],
        max_doc_id=hdr["max_doc_id"],
        metadata=tuple(hdr.get("metadata", {}).items()),
    )


def delete_segment_file(dir_path: str, info: SegmentInfo) -> None:
    try:
        os.unlink(os.path.join(dir_path, segment_file_name(info)))
    except FileNotFoundError:
        pass


def segment_file_size(dir_path: str, info: SegmentInfo) -> Optional[int]:
    try:
        return os.path.getsize(os.path.join(dir_path, segment_file_name(info)))
    except FileNotFoundError:
        return None
