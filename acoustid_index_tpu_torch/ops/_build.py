"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each library's sources are compiled on first use into a plain-C shared
library under `acoustid_index_tpu_torch/_build/` (listed in .gitignore),
named by a hash of the sources and flags so an edited kernel never loads a
stale build.  No PyTorch headers are involved, so a build takes seconds.
Nothing here runs at import time: the CPU test suite imports every module
of the port on a machine with no nvcc and no card.

Four libraries: "kernels" (csrc/block_lookup.cu), the kernels the port
runs; "designs" (csrc/block_lookup_designs.cu and
csrc/probe_lookup_designs.cu), the search designs that K1-K4 did not take,
which only measure.py loads to time them; "probes" (csrc/probe_lookup.cu),
K3-K5, the kernels of the probes' contracts that K1 and K2 do not compute
(ops/probe_lookup.py); "varint" (csrc/varint_decode.cu), the decode of a
segment file's delta-varints at restart (ops/varint.py).  The headers of csrc/ (csrc/sector_search.cuh,
included by both K3/K4 sources) enter every library's hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_COUNT = [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P]
_EMIT = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P]
_MASKED = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P]
_I, _LL = ctypes.c_int, ctypes.c_longlong
_PAIR = [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P]
_EMIT_DOCIDS = [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P]
_STAGED = [_P, _P, _P, _P, _LL, _LL, _I, _I, _P]
_PAIR_ARITY = _PAIR[:-1] + [_I, _P]
_EMIT_DOCIDS_ARITY = _EMIT_DOCIDS[:-1] + [_I, _I, _P]

# library -> (sources, {C entry: ctypes argument types})
LIBRARIES = {
    "kernels": (("block_lookup.cu",), {
        "aitpu_block_count": _COUNT,
        "aitpu_block_count_scan": _COUNT,
        "aitpu_block_count_masked": _MASKED,
        "aitpu_block_count_emit": _EMIT,
        "aitpu_block_count_emit_scan": _EMIT,
    }),
    "designs": (("block_lookup_designs.cu", "probe_lookup_designs.cu"), {
        "aitpu_design_count_group8": _COUNT,
        "aitpu_design_emit_group8": _EMIT,
        "aitpu_design_emit_warp32": _EMIT,
        "aitpu_design_pair_thread11": _PAIR,
        "aitpu_design_emit_docids_thread11": _EMIT_DOCIDS,
        "aitpu_design_pair_sector": _PAIR_ARITY,
        "aitpu_design_emit_docids_sector": _EMIT_DOCIDS_ARITY,
    }),
    "probes": (("probe_lookup.cu",), {
        "aitpu_block_count_pair": _PAIR,
        "aitpu_block_count_emit_docids": _EMIT_DOCIDS,
        "aitpu_block_count_staged": _STAGED,
    }),
    "varint": (("varint_decode.cu",), {
        "aitpu_varint_count": [_P, _LL, _P, _P, _P],
        "aitpu_varint_decode": [_P, _LL, _P, _I, _P, _P, _LL, _LL, _P],
        "aitpu_varint_scan": [_P, _P, _LL, _LL, _LL, _I, _P, _P, _P],
        "aitpu_varint_sums": [_P, _P, _LL, _LL, _I, _P, _P],
        "aitpu_varint_carries": [_LL, _P, _P],
        "aitpu_varint_apply": [_P, _P, _LL, _LL, _LL, _I, _P, _P, _P],
    }),
}

_locks = {name: threading.Lock() for name in LIBRARIES}  # one per library: builds may run at once
_libs: dict = {}
build_seconds: dict = {}  # library -> wall time of this process's nvcc run (absent: not built here)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for src in (*LIBRARIES[name][0], *headers):
        with open(os.path.join(_CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libaitpu_{name}-{h.hexdigest()[:16]}.so")


def library(name: str = "kernels") -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed.  Raises on
    any build or load failure -- there is no fallback."""
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        sources, entries = LIBRARIES[name]
        so = _so_path(name)
        if not os.path.exists(so):
            import time

            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [os.path.join(_CSRC, s) for s in sources]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)  # atomic: concurrent builders never see half a file
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        for fn, argtypes in entries.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib
