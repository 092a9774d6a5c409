"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

The sources are compiled on first use into a plain-C shared library under
`acoustid_index_tpu_torch/_build/` (listed in .gitignore), named by a hash
of the sources and flags so an edited kernel never loads a stale build.  No
PyTorch headers are involved, so a build takes seconds.  Nothing here runs
at import time: the CPU test suite imports every module of the port on a
machine with no nvcc and no card.
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
SOURCES = ("block_lookup.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build (None: not built here)

_P = ctypes.c_void_p


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _so_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libaitpu_kernels-{h.hexdigest()[:16]}.so")


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed.  Raises on
    any build or load failure -- there is no fallback."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so):
            import time

            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [os.path.join(_CSRC, s) for s in SOURCES]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)  # atomic: concurrent builders never see half a file
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        lib.aitpu_block_count.restype = ctypes.c_int
        lib.aitpu_block_count.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P,
        ]
        lib.aitpu_block_count_masked.restype = ctypes.c_int
        lib.aitpu_block_count_masked.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P,
        ]
        lib.aitpu_block_count_emit.restype = ctypes.c_int
        lib.aitpu_block_count_emit.argtypes = [
            _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P,
        ]
        _lib = lib
        return lib
