"""Profiling hooks: torch.profiler spans around the device hot paths
(counterpart of acoustid_index_tpu/utils/profiling.py).

  * `trace(name)` annotates a host span (search dispatch) so that the
    card's timeline lines up with engine phases;
  * `capture(log_dir)` records CPU and CUDA activity into a Chrome trace
    under `log_dir`;
  * `start_profiler_server(port)` (`--profile-port`) is the counterpart of
    the reference's jax.profiler live server, which torch lacks: a
    listener on 127.0.0.1 whose `GET /capture?ms=N` runs `capture` over
    the live process for N ms and answers with the Chrome trace.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

log = logging.getLogger("acoustid_index_tpu_torch.profiling")


@contextlib.contextmanager
def trace(name: str):
    """Annotate a host-side span in the device trace timeline."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture(log_dir: str):
    """Capture a programmatic trace of the block into `log_dir` as a Chrome
    trace (trace-<ns>.json); yields the profiler.  Every thread is
    recorded: the searcher dispatches from its own thread."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=config) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


MAX_CAPTURE_MS = 60_000


class _CaptureHandler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str = "text/plain") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 -- http.server's name
        url = urllib.parse.urlsplit(self.path)
        if url.path != "/capture":
            return self._send(404, b"GET /capture?ms=N\n")
        try:
            ms = float(urllib.parse.parse_qs(url.query).get("ms", ["1000"])[0])
        except ValueError:
            ms = -1.0
        if not 0 < ms <= MAX_CAPTURE_MS:
            return self._send(400, f"ms must be in (0, {MAX_CAPTURE_MS}]\n".encode())
        if not self.server.capturing.acquire(blocking=False):
            return self._send(409, b"a capture is already running\n")
        try:
            with tempfile.TemporaryDirectory(prefix="aitpu-capture-") as d:
                with capture(d):
                    time.sleep(ms / 1e3)
                (path,) = glob.glob(os.path.join(d, "*.json"))
                with open(path, "rb") as f:
                    body = f.read()
        finally:
            self.server.capturing.release()
        self._send(200, body, "application/json")

    def log_message(self, fmt, *args):
        log.debug("profiler server: " + fmt, *args)


def start_profiler_server(port: int) -> ThreadingHTTPServer:
    """Serve `GET /capture?ms=N` on 127.0.0.1:`port` (0 picks a free port:
    the returned server's `server_address[1]`) from a daemon thread; a
    request during a capture gets 409.  Stop with `.shutdown()`."""
    server = ThreadingHTTPServer(("127.0.0.1", port), _CaptureHandler)
    server.daemon_threads = True
    server.capturing = threading.Lock()
    threading.Thread(target=server.serve_forever, name="aitpu-profiler", daemon=True).start()
    log.info("profiler capture server on 127.0.0.1:%d", server.server_address[1])
    return server
