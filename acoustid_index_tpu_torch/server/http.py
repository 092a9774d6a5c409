"""Minimal threaded HTTP/1.1 server.

The reference embeds a coroutine HTTP server (dusty) on io_uring; here the
host control plane is a compact thread-per-connection HTTP/1.1 server on
the stdlib socket layer — the device does the heavy lifting, the host layer
only parses small request bodies and dispatches.  Supports keep-alive,
Content-Length bodies, chunked streaming responses (snapshot export), and
path parameters (":name" segments).  No external dependencies.

The port's copy of acoustid_index_tpu/server/http.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
from dataclasses import dataclass, field
from io import BufferedReader
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

log = logging.getLogger("acoustid_index_tpu_torch.http")

MAX_BODY = 16 * 1024 * 1024  # same request-body cap as the reference CLI

STATUS_TEXT = {
    200: "OK",
    202: "Accepted",
    400: "Bad Request",
    403: "Forbidden",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    410: "Gone",
    413: "Payload Too Large",
    415: "Unsupported Media Type",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
}


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: Optional[bytes]
    params: Dict[str, str] = field(default_factory=dict)


@dataclass
class Response:
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: Union[bytes, str] = b""
    # When set, the body streams as chunked transfer encoding.
    stream: Optional[Iterable[bytes]] = None


Handler = Callable[[Request], Response]


class Router:
    def __init__(self):
        self._routes: List[Tuple[str, List[str], Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler):
        parts = [p for p in pattern.split("/") if p]
        self._routes.append((method, parts, handler))

    def get(self, pattern, handler):
        self.add("GET", pattern, handler)

    def head(self, pattern, handler):
        self.add("HEAD", pattern, handler)

    def post(self, pattern, handler):
        self.add("POST", pattern, handler)

    def put(self, pattern, handler):
        self.add("PUT", pattern, handler)

    def delete(self, pattern, handler):
        self.add("DELETE", pattern, handler)

    def resolve(self, method: str, path: str):
        segs = [p for p in path.split("/") if p]
        found_path = False
        for m, parts, handler in self._routes:
            if len(parts) != len(segs):
                continue
            params = {}
            ok = True
            for pat, seg in zip(parts, segs):
                if pat.startswith(":"):
                    params[pat[1:]] = seg
                elif pat != seg:
                    ok = False
                    break
            if ok:
                found_path = True
                if m == method:
                    return handler, params
        return (None, {"__405__": "1"}) if found_path else (None, {})


def _parse_qs(qs: str) -> Dict[str, str]:
    out = {}
    for pair in qs.split("&"):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        out[k] = v
    return out


class _ConnHandler(socketserver.BaseRequestHandler):
    def handle(self):
        self.request.settimeout(600)
        rfile = self.request.makefile("rb", buffering=65536)
        try:
            while True:
                if not self._one(rfile):
                    return
        except (ConnectionError, socket.timeout, BrokenPipeError, OSError):
            return
        finally:
            try:
                rfile.close()
            except OSError:
                pass

    def _one(self, rfile: BufferedReader) -> bool:
        line = rfile.readline(8192)
        if not line:
            return False
        try:
            method, target, _version = line.decode("latin1").strip().split(" ", 2)
        except ValueError:
            self._send_simple(400, b"bad request line")
            return False
        headers: Dict[str, str] = {}
        while True:
            h = rfile.readline(8192)
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()

        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            self._send_simple(400, b"bad content-length")
            return False
        if length < 0:
            self._send_simple(400, b"bad content-length")
            return False
        if length > MAX_BODY:
            self._send_simple(413, b"body too large")
            return False
        body = rfile.read(length) if length else None

        path, _, qs = target.partition("?")
        req = Request(
            method=method,
            path=path,
            query=_parse_qs(qs),
            headers=headers,
            body=body,
        )

        server: HttpServer = self.server  # type: ignore
        handler, params = server.router.resolve(method, path)
        req.params = params
        if handler is None:
            if params.get("__405__"):
                resp = Response(status=405, body=b"")
            else:
                resp = server.not_found(req)
        else:
            try:
                resp = handler(req)
            except Exception as exc:  # noqa: BLE001 — the app maps errors
                resp = server.error_handler(req, exc)

        keep_alive = headers.get("connection", "").lower() != "close"
        self._send(req, resp, keep_alive)
        return keep_alive

    def _send_simple(self, status: int, body: bytes):
        self._send(None, Response(status=status, body=body), False)

    def _send(self, req: Optional[Request], resp: Response, keep_alive: bool):
        body = resp.body.encode() if isinstance(resp.body, str) else resp.body
        head = [f"HTTP/1.1 {resp.status} {STATUS_TEXT.get(resp.status, 'Unknown')}"]
        for k, v in resp.headers.items():
            head.append(f"{k}: {v}")
        head.append(f"Connection: {'keep-alive' if keep_alive else 'close'}")
        is_head = req is not None and req.method == "HEAD"
        try:
            if resp.stream is not None and not is_head:
                head.append("Transfer-Encoding: chunked")
                self.request.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin1"))
                for chunk in resp.stream:
                    if chunk:
                        self.request.sendall(b"%x\r\n" % len(chunk) + chunk + b"\r\n")
                self.request.sendall(b"0\r\n\r\n")
            else:
                head.append(f"Content-Length: {0 if is_head else len(body)}")
                self.request.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin1"))
                if not is_head and body:
                    self.request.sendall(body)
        except (BrokenPipeError, ConnectionError, OSError):
            raise ConnectionError("client went away")


class HttpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    def __init__(self, host: str, port: int, router: Router, error_handler, not_found):
        self.router = router
        self.error_handler = error_handler
        self.not_found = not_found
        super().__init__((host, port), _ConnHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True, name=f"http:{self.port}")
        t.start()
        return t
