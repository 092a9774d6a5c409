"""API models and JSON/msgpack codecs.

Wire compatibility with the reference (upstream fpindex's src/api.zig): JSON
bodies use full field names; msgpack bodies use the compact first-letter
keys (the reference's `field_name_prefix=1` convention).  IndexStats uses
full names in both (its fields collide on the first letter).

The port's copy of acoustid_index_tpu/server/api.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence

import msgpack

from ..engine import errors
from ..engine.model import BulkInsert, Change, Delete, Insert, SetMetadata

DEFAULT_SEARCH_TIMEOUT_MS = 500
MAX_SEARCH_TIMEOUT_MS = 10_000
DEFAULT_SEARCH_LIMIT = 40
MIN_SEARCH_LIMIT = 1
MAX_SEARCH_LIMIT = 100


def _get(d: dict, full: str, short: str, default=None):
    if full in d:
        return d[full]
    if short in d:
        return d[short]
    return default


# ---- request decoding ----


def decode_search_request(d: dict) -> dict:
    query = _get(d, "query", "q")
    if query is None or not isinstance(query, list):
        raise errors.BadRequest("query is required")
    # The reference's msgpack decode rejects non-u32 hashes; do the same
    # instead of surfacing a numpy conversion error as a 500.
    for h in query:
        if not isinstance(h, int) or isinstance(h, bool) or h < 0 or h > 0xFFFFFFFF:
            raise errors.BadRequest("query hashes must be u32 integers")
    return {
        "query": query,
        "timeout": _get(d, "timeout", "t", DEFAULT_SEARCH_TIMEOUT_MS),
        "limit": _get(d, "limit", "l", DEFAULT_SEARCH_LIMIT),
        "min_score": _get(d, "min_score", "m"),
        "score_pct": _get(d, "score_pct", "s", 10),
    }


def decode_change(d: dict) -> Change:
    ins = _get(d, "insert", "i")
    if ins is not None:
        return Insert(id=_get(ins, "id", "i", 0), hashes=_get(ins, "hashes", "h") or ())
    dele = _get(d, "delete", "d")
    if dele is not None:
        return Delete(id=_get(dele, "id", "i", 0))
    sm = _get(d, "set_metadata", "s")
    if sm is not None:
        entries = _get(sm, "entries", "e") or []
        return SetMetadata(entries=[(_get(e, "key", "k"), _get(e, "value", "v")) for e in entries])
    raise errors.BadRequest(f"unknown change: {d!r}")


def decode_update_request(d: dict) -> dict:
    raw = _get(d, "changes", "c")
    if raw is None or not isinstance(raw, list):
        raise errors.BadRequest("changes is required")
    return {
        "changes": [decode_change(c) for c in raw],
        "metadata": _get(d, "metadata", "m"),
        "expected_version": _get(d, "expected_version", "e"),
    }


def _u32_column(v, what: str):
    """A u32 numpy column from either raw little-endian bytes (msgpack bin —
    the fast path) or a JSON-friendly list of ints."""
    import numpy as np

    if isinstance(v, (bytes, bytearray, memoryview)):
        if len(v) % 4:
            raise errors.BadRequest(f"{what} binary length must be a multiple of 4")
        return np.frombuffer(v, dtype="<u4")
    if isinstance(v, list):
        try:
            arr = np.asarray(v, dtype=np.int64)
        except (ValueError, OverflowError):
            raise errors.BadRequest(f"{what} must be u32 integers")
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) > 0xFFFFFFFF):
            raise errors.BadRequest(f"{what} must be u32 integers")
        return arr.astype(np.uint32)
    raise errors.BadRequest(f"{what} must be binary u32 data or a list of ints")


def decode_bulk_request(d: dict) -> dict:
    """POST /:index/_bulk — columnar insert batch.  Body fields: ids (bin or
    list), hashes (bin or list), and either offsets (u32[n+1] spans into
    hashes) or width (fixed hashes-per-doc).  An extension over the
    reference's per-change _update (change.zig has no bulk form); semantics
    are exactly `changes: [insert...]` in order."""
    import numpy as np

    raw_ids = _get(d, "ids", "i")
    raw_hashes = _get(d, "hashes", "h")
    if raw_ids is None or raw_hashes is None:
        raise errors.BadRequest("ids and hashes are required")
    ids = _u32_column(raw_ids, "ids")
    hashes = _u32_column(raw_hashes, "hashes")
    raw_off = _get(d, "offsets", "o")
    if raw_off is not None:
        offsets = _u32_column(raw_off, "offsets")
    else:
        k = _get(d, "width", "k")
        if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
            raise errors.BadRequest("offsets or a positive width is required")
        if hashes.shape[0] != ids.shape[0] * k:
            raise errors.BadRequest("hashes length must be len(ids) * width")
        offsets = np.arange(0, (ids.shape[0] + 1) * k, k, dtype=np.uint32)
    try:
        change = BulkInsert(ids=ids, hashes=hashes, offsets=offsets)
    except ValueError as exc:
        raise errors.BadRequest(str(exc))
    return {
        "changes": [change],
        "metadata": _get(d, "metadata", "m"),
        "expected_version": _get(d, "expected_version", "e"),
    }


def decode_create_index_request(d: dict) -> dict:
    return {
        "expect_does_not_exist": bool(_get(d, "expect_does_not_exist", "e", False)),
        "generation": _get(d, "generation", "g"),
    }


def decode_delete_index_request(d: dict) -> dict:
    return {"expect_exists": bool(_get(d, "expect_exists", "e", False))}


def decode_put_fingerprint_request(d: dict) -> dict:
    hashes = _get(d, "hashes", "h")
    if hashes is None or not isinstance(hashes, list):
        raise errors.BadRequest("hashes is required")
    return {"hashes": hashes}


# ---- response encoding (full names for JSON, short keys for msgpack) ----


def encode_search_response(results, short: bool) -> dict:
    if short:
        return {"r": [{"i": r.id, "s": r.score} for r in results]}
    return {"results": [{"id": r.id, "score": r.score} for r in results]}


def encode_update_response(version: int, short: bool) -> dict:
    return {"v": version} if short else {"version": version}


def encode_create_index_response(d: dict, short: bool) -> dict:
    if short:
        return {"v": d["version"], "r": d["ready"], "g": d["generation"]}
    return d


def encode_delete_index_response(d: dict, short: bool) -> dict:
    return {"d": d["deleted"]} if short else d


def encode_fingerprint_info(d: dict, short: bool) -> dict:
    return {"v": d["version"]} if short else d


def encode_index_info(d: dict, short: bool) -> dict:
    # IndexStats always uses full names (first-letter collisions).
    if short:
        return {"v": d["version"], "m": d["metadata"], "s": d["stats"]}
    return d


def encode_peer_status(d: dict, short: bool) -> dict:
    if short:
        return {"g": d["generation"], "v": d["version"], "f": d["file_version"]}
    return d


def encode_error(name: str, short: bool) -> dict:
    return {"e": name} if short else {"error": name}


# ---- body codecs ----


def decode_body(body: bytes, content_type: str) -> Any:
    try:
        if content_type == "application/json":
            return json.loads(body)
        if content_type == "application/vnd.msgpack":
            return msgpack.unpackb(body, strict_map_key=False)
    except Exception:
        raise errors.BadRequest("malformed body")
    raise errors.UnsupportedMediaType(content_type)


def encode_body(value: Any, content_type: str) -> bytes:
    if content_type == "application/json":
        return json.dumps(value).encode()
    return msgpack.packb(value, use_bin_type=True)
