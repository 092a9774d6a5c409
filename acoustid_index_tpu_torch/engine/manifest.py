"""Manifest: the list of live file segments — THE commit point of a
checkpoint/merge (cf. upstream fpindex's src/manifest.zig:1-5).  A msgpack
array of SegmentInfo wire triples, written atomically (temp + fsync +
rename).  Nothing index-level is stored: "upstream-fed" is derived from any
segment carrying a version.

The port's copy of acoustid_index_tpu/engine/manifest.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import msgpack

from .model import SegmentInfo

MANIFEST_NAME = "manifest"


def read_manifest(dir_path: str) -> List[SegmentInfo]:
    path = os.path.join(dir_path, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return []
    return [SegmentInfo.from_wire(v) for v in msgpack.unpackb(data, strict_map_key=False)]


def write_manifest(dir_path: str, infos: Sequence[SegmentInfo]) -> None:
    path = os.path.join(dir_path, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb([i.to_wire() for i in infos], use_bin_type=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
