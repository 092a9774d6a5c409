"""Builds and runs the load generator (loadgen/loadgen.cc), each run a
process of its own.

The binary is built once per checkout into benchmark_torch/_build/ (a
fixed directory, git-ignored), named by a hash of its source and flags.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "loadgen", "loadgen.cc")
BUILD_DIR = os.path.join(HERE, "_build")
FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")


def build() -> str:
    """Path of the built load generator, building it first if needed."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"loadgen-{digest}")
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"loadgen build failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@dataclass
class Result:
    summary: dict
    latencies: np.ndarray  # seconds per request of the window; inf: no 200
    records: Dict[int, tuple]  # request index -> (status, first body)


class Run:
    """One load generator process, started with its requests on stdin."""

    def __init__(self, exe: str, mode: str, port: int, requests: bytes, record: str, seed: int,
                 seconds: float = 0.0, conns: int = 1, rate: float = 0.0, period: float = 0.0, drain: float = 60.0,
                 start_at: float = 0.0, cpus=None):
        self.record = record
        args = [exe, "--mode", mode, "--port", str(port), "--requests", "-", "--record", record,
                "--seed", str(seed), "--conns", str(conns), "--seconds", repr(float(seconds)), "--drain", repr(float(drain))]
        if rate:
            args += ["--rate", repr(float(rate))]
        if period:
            args += ["--period", repr(float(period))]
        if start_at:
            args += ["--start-at", repr(float(start_at))]
        self.timeout = max(start_at - time.monotonic(), 0.0) + seconds + drain + 60
        self.proc = subprocess.Popen(args, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        if cpus:
            try:
                os.sched_setaffinity(self.proc.pid, cpus)
            except ProcessLookupError:  # it failed already; wait() reports why
                pass
        try:
            self.proc.stdin.write(requests)
            self.proc.stdin.close()
        except BrokenPipeError:
            pass
        self.proc.stdin = None  # closed: communicate() must not flush it

    def wait(self) -> Result:
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise RuntimeError("the load generator did not finish in time")
        if self.proc.returncode != 0:
            raise RuntimeError(f"the load generator failed ({self.proc.returncode}): {err.decode(errors='replace')[-2000:]}")
        summary = json.loads(out.decode().strip().splitlines()[-1])
        lat = np.fromfile(self.record + ".lat", dtype=np.float64)
        with open(self.record + ".rec", "rb") as f:
            raw = f.read()
        records, pos = {}, 0
        while pos < len(raw):
            idx, status, n = struct.unpack_from("<III", raw, pos)
            records[idx] = (status, raw[pos + 12 : pos + 12 + n])
            pos += 12 + n
        for ext in (".lat", ".rec"):
            os.unlink(self.record + ext)
        return Result(summary, lat, records)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def run(exe: str, mode: str, port: int, requests: bytes, record: str, seed: int, **kw) -> Result:
    return Run(exe, mode, port, requests, record, seed, **kw).wait()


def percentile_ms(lat: np.ndarray, q: float) -> Optional[float]:
    """The q-th percentile (nearest rank) of latencies in ms; a failed
    request (inf) counts as missing every limit."""
    if not lat.size:
        return None
    s = np.sort(lat)
    v = s[max(int(np.ceil(q / 100 * s.size)) - 1, 0)]
    return float(v * 1e3)
