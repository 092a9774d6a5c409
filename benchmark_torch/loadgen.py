"""Builds and runs the load generator (loadgen/loadgen.cc), each run a
process of its own.

The binary is built once per checkout into benchmark_torch/_build/ (a
fixed directory, git-ignored), named by a hash of its source and flags.
A run started with `control=True` can be paused, drained and resumed
inside its window (loadgen.cc's --control).
"""

from __future__ import annotations

import hashlib
import json
import os
import select
import shutil
import socket
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
                 start_at: float = 0.0, cpus=None, control: bool = False):
        self.record = record
        self._ctl = None
        child = None
        args = [exe, "--mode", mode, "--port", str(port), "--requests", "-", "--record", record,
                "--seed", str(seed), "--conns", str(conns), "--seconds", repr(float(seconds)), "--drain", repr(float(drain))]
        if rate:
            args += ["--rate", repr(float(rate))]
        if period:
            args += ["--period", repr(float(period))]
        if start_at:
            args += ["--start-at", repr(float(start_at))]
        if control:
            self._ctl, child = socket.socketpair()
            args += ["--control", str(child.fileno())]
        self.timeout = max(start_at - time.monotonic(), 0.0) + seconds + drain + 60
        try:
            self.proc = subprocess.Popen(args, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         pass_fds=(child.fileno(),) if child else ())
        finally:
            if child:
                child.close()
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

    def pause(self) -> None:
        """Stop sending; drained() then waits for the answers in flight."""
        try:
            self._ctl.sendall(b"p")
        except (BrokenPipeError, ConnectionResetError):  # ended: drained() reads None
            pass

    def drained(self, timeout: float) -> Optional[float]:
        """The generator's CLOCK_MONOTONIC time at which the last answer
        in flight came back after pause(), or None if none came in
        `timeout` seconds."""
        end = time.monotonic() + timeout
        buf = b""
        while not buf.endswith(b"\n"):
            left = end - time.monotonic()
            if left <= 0 or not select.select([self._ctl], [], [], left)[0]:
                return None
            got = self._ctl.recv(64)
            if not got:
                return None
            buf += got
        word, t = buf.decode().split()
        if word != "drained":
            raise RuntimeError(f"the load generator said {buf!r}")
        return float(t)

    def resume(self) -> None:
        """Send again; a generator whose window closed while paused has
        ended, and there is nothing to resume."""
        try:
            self._ctl.sendall(b"r")
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _close_control(self) -> None:
        if self._ctl is not None:
            self._ctl.close()
            self._ctl = None

    def wait(self) -> Result:
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise RuntimeError("the load generator did not finish in time")
        finally:
            self._close_control()
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
        self._close_control()


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
