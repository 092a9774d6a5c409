"""ctypes binding for the native codec library and the native search-plane
front (csrc/aitpu_native.cc, csrc/aitpu_front.cc), and the path of the
native load generator (csrc/aitpu_loadgen.cc).

The port's copy of acoustid_index_tpu/utils/native.py.  It differs in the
build: each library is compiled from the port's own csrc/ with g++ on first
use into acoustid_index_tpu_torch/_build/ (listed in .gitignore), named by a
hash of its source and flags as ops/_build.py names the CUDA library, so an
edited source never loads a stale build.  Every codec caller has a
pure-Python fallback, so the codec library is an accelerator, never a hard
dependency; the front has none (the Python HTTP server is the fallback the
operator chooses by not asking for --search-port).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("acoustid_index_tpu_torch.native")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")

_lock = threading.Lock()
_lib = None
_tried = False


def build(source: str, kind: str) -> str:
    """Path of csrc/`source` compiled as `kind` ("so": a shared library,
    "exe": a program), compiling it first when no build of this exact
    source exists.  Raises on a missing compiler or a failed build."""
    flags = [*CXX_FLAGS, "-shared"] if kind == "so" else list(CXX_FLAGS)
    path = os.path.join(_CSRC, source)
    h = hashlib.sha256(" ".join(flags).encode())
    with open(path, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    suffix = ".so" if kind == "so" else ""
    out = os.path.join(BUILD_DIR, f"{'lib' if kind == 'so' else ''}{stem}-{h.hexdigest()[:16]}{suffix}")
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *flags, "-o", tmp, path] + (["-lpthread"] if source == "aitpu_front.cc" else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cxx)} failed on {source} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build("aitpu_native.cc", "so"))
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            log.warning("native build failed (%s); using pure-Python codecs", exc)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.aitpu_encode_bound.restype = ctypes.c_int64
        lib.aitpu_encode_bound.argtypes = [ctypes.c_int64]
        lib.aitpu_encode_postings.restype = ctypes.c_int64
        lib.aitpu_encode_postings.argtypes = [u32p, u32p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.aitpu_decode_postings.restype = ctypes.c_int64
        lib.aitpu_decode_postings.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u32p, u32p]
        lib.aitpu_encode_sorted_u32.restype = ctypes.c_int64
        lib.aitpu_encode_sorted_u32.argtypes = [u32p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.aitpu_decode_sorted_u32.restype = ctypes.c_int64
        lib.aitpu_decode_sorted_u32.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u32p]
        lib.aitpu_scan_frames.restype = ctypes.c_int64
        lib.aitpu_scan_frames.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


_front_lib = None
_front_tried = False


def front_lib():
    """Loads the native search-plane front end (csrc/aitpu_front.cc),
    building it on first use.  Returns None when it cannot be built or
    loaded -- unlike the codecs there is no pure-Python fallback; callers
    surface the absence as an error when the operator explicitly asked for
    the native front."""
    global _front_lib, _front_tried
    with _lock:
        if _front_tried:
            return _front_lib
        _front_tried = True
        try:
            lib = ctypes.CDLL(build("aitpu_front.cc", "so"))
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            log.warning("native front build failed (%s)", exc)
            return None
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.aitpu_front_start.restype = i64
        lib.aitpu_front_start.argtypes = [i32, i32]
        lib.aitpu_front_next.restype = i64
        lib.aitpu_front_next.argtypes = [i64, u8p, u32p, u32p, u64p, i64, i64]
        lib.aitpu_front_complete.restype = i64
        lib.aitpu_front_complete.argtypes = [i64, u64p, u32p, i64, i64]
        lib.aitpu_front_fail.restype = i64
        lib.aitpu_front_fail.argtypes = [i64, u64p, i64, i32, ctypes.c_char_p]
        lib.aitpu_front_stat.restype = i64
        lib.aitpu_front_stat.argtypes = [i64, i32]
        lib.aitpu_front_stop.restype = i64
        lib.aitpu_front_stop.argtypes = [i64]
        _front_lib = lib
        return _front_lib


def loadgen_path() -> str:
    """The native HTTP load generator (csrc/aitpu_loadgen.cc), built on
    first use: `loadgen --port P --seconds S --conns N --blobs FILE --seed K`
    prints one JSON line {count, miss, window_s, p50_ms, p99_ms}."""
    with _lock:
        return build("aitpu_loadgen.cc", "exe")


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---- postings codec (dv1) ----


def encode_postings(hashes: np.ndarray, docids: np.ndarray) -> Optional[bytes]:
    lib = _load()
    n = hashes.shape[0]
    hashes = np.ascontiguousarray(hashes, dtype=np.uint32)
    docids = np.ascontiguousarray(docids, dtype=np.uint32)
    if lib is not None:
        out = np.empty(lib.aitpu_encode_bound(n), dtype=np.uint8)
        written = lib.aitpu_encode_postings(_u32p(hashes), _u32p(docids), n, _u8p(out), out.shape[0])
        if written < 0:
            return None
        return out[:written].tobytes()
    return _py_encode_postings(hashes, docids)


def decode_postings(buf: bytes, n: int) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is not None:
        hashes = np.empty(n, dtype=np.uint32)
        docids = np.empty(n, dtype=np.uint32)
        raw = np.frombuffer(buf, dtype=np.uint8)
        got = lib.aitpu_decode_postings(_u8p(raw), raw.shape[0], n, _u32p(hashes), _u32p(docids))
        if got != n:
            raise ValueError("corrupt dv1 postings stream")
        return hashes, docids
    return _py_decode_postings(buf, n)


def encode_sorted_u32(values: np.ndarray) -> Optional[bytes]:
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.uint32)
    n = values.shape[0]
    if lib is not None:
        out = np.empty(5 * n + 16, dtype=np.uint8)
        written = lib.aitpu_encode_sorted_u32(_u32p(values), n, _u8p(out), out.shape[0])
        if written < 0:
            return None
        return out[:written].tobytes()
    return _py_encode_sorted(values)


def decode_sorted_u32(buf: bytes, n: int) -> np.ndarray:
    lib = _load()
    if lib is not None:
        values = np.empty(n, dtype=np.uint32)
        raw = np.frombuffer(buf, dtype=np.uint8)
        got = lib.aitpu_decode_sorted_u32(_u8p(raw), raw.shape[0], n, _u32p(values))
        if got != n:
            raise ValueError("corrupt dv1 u32 stream")
        return values
    return _py_decode_sorted(buf, n)


def scan_frames(data: bytes, max_record: int) -> int:
    """Length of the valid framed-record prefix (WAL torn-tail recovery)."""
    lib = _load()
    if lib is not None and data:
        raw = np.frombuffer(data, dtype=np.uint8)
        return int(lib.aitpu_scan_frames(_u8p(raw), raw.shape[0], max_record))
    return -1  # caller falls back to the Python scanner


# ---- pure-Python fallbacks (correct, slower) ----


def _py_varints(buf: bytes):
    v = 0
    shift = 0
    for b in buf:
        v |= (b & 0x7F) << shift
        if b & 0x80:
            shift += 7
            if shift > 28:
                raise ValueError("varint overflow")
        else:
            yield v
            v = 0
            shift = 0
    if shift:
        raise ValueError("truncated varint")


def _py_put_varint(out: bytearray, v: int):
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _py_encode_postings(hashes, docids) -> bytes:
    out = bytearray()
    prev_h = 0
    prev_d = 0
    for i in range(hashes.shape[0]):
        h = int(hashes[i])
        d = int(docids[i])
        delta = (h - prev_h) & 0xFFFFFFFF
        _py_put_varint(out, delta)
        _py_put_varint(out, ((d - prev_d) & 0xFFFFFFFF) if (i > 0 and delta == 0) else d)
        prev_h, prev_d = h, d
    return bytes(out)


def _py_decode_postings(buf: bytes, n: int):
    hashes = np.empty(n, dtype=np.uint32)
    docids = np.empty(n, dtype=np.uint32)
    it = _py_varints(buf)
    prev_h = 0
    prev_d = 0
    for i in range(n):
        delta = next(it)
        dv = next(it)
        h = (prev_h + delta) & 0xFFFFFFFF
        d = ((prev_d + dv) & 0xFFFFFFFF) if (i > 0 and delta == 0) else dv
        hashes[i] = h
        docids[i] = d
        prev_h, prev_d = h, d
    for _ in it:
        raise ValueError("trailing bytes in dv1 stream")
    return hashes, docids


def _py_encode_sorted(values) -> bytes:
    out = bytearray()
    prev = 0
    for v in values:
        _py_put_varint(out, (int(v) - prev) & 0xFFFFFFFF)
        prev = int(v)
    return bytes(out)


def _py_decode_sorted(buf: bytes, n: int) -> np.ndarray:
    values = np.empty(n, dtype=np.uint32)
    prev = 0
    it = _py_varints(buf)
    for i in range(n):
        prev = (prev + next(it)) & 0xFFFFFFFF
        values[i] = prev
    for _ in it:
        raise ValueError("trailing bytes in dv1 stream")
    return values
