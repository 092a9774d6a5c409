"""Standalone open-loop HTTP load generator for the search fronts
(counterpart of the root bench_client.py; the bench's `--client python`).

    python acoustid_index_tpu_torch/bench_client.py --port P --seconds S \
        --conns N --blobs FILE [--seed K]

Runs in its OWN process (bench.py starts several) so the load generation
never shares the interpreter lock with the server it measures.  Each process
drives `--conns` keep-alive connections with non-blocking sockets through
one selector: every connection is closed-loop (send -> response -> send),
so total in-flight load = processes * conns without thread armies.

Requests are pre-encoded HTTP byte blobs written by bench.py: a msgpack list
of (expected bytes, request bytes).  A response counts as a miss unless its
status is 200 and its body holds the expected bytes (the target doc as the
first result).  It imports only the standard library, numpy and msgpack,
and reads the same blobs and prints the same line as the native load
generator (csrc/aitpu_loadgen.cc).  Unlike the root copy it also reads a
Content-Length that is the response's last header line, as the Python
HTTP server sends it.

Prints one JSON line: {"count", "miss", "window_s", "p50_ms", "p99_ms"}.
"""

import argparse
import json
import selectors
import socket
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--conns", type=int, default=256)
    ap.add_argument("--blobs", required=True, help="msgpack [(expect_bytes, request_bytes), ...]")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import msgpack

    with open(args.blobs, "rb") as f:
        blobs = msgpack.unpackb(f.read(), use_list=True)
    n_blobs = len(blobs)
    rng = np.random.default_rng(args.seed)
    order = rng.integers(0, n_blobs, 1 << 20).tolist()  # pre-drawn indices
    next_i = [0]

    sel = selectors.DefaultSelector()

    class Conn:
        __slots__ = ("sock", "buf", "expect", "t_sent", "out")

        def __init__(self):
            self.sock = socket.create_connection(("127.0.0.1", args.port))
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.sock.setblocking(False)
            self.buf = b""
            self.expect = b""
            self.t_sent = 0.0
            self.out = b""

        def fire(self):
            i = order[next_i[0] & ((1 << 20) - 1)]
            next_i[0] += 1
            self.expect, req = blobs[i]
            self.out = req
            self.t_sent = time.perf_counter()
            self.pump_out()

        def pump_out(self):
            # Non-blocking send of whatever remains.  On EAGAIN the selector
            # must watch for writability: the server won't produce a read
            # event until the request TAIL arrives, so read-only
            # registration would deadlock the connection.
            while self.out:
                try:
                    n = self.sock.send(self.out)
                except BlockingIOError:
                    sel.modify(self.sock, selectors.EVENT_READ | selectors.EVENT_WRITE, self)
                    return
                self.out = self.out[n:]
            sel.modify(self.sock, selectors.EVENT_READ, self)

    count = 0
    miss = 0
    lats = []
    conns = [Conn() for _ in range(args.conns)]
    for c in conns:
        sel.register(c.sock, selectors.EVENT_READ, c)
        c.fire()

    t_start = time.time()
    deadline = t_start + args.seconds
    while time.time() < deadline:
        for key, mask in sel.select(timeout=0.2):
            c = key.data
            if mask & selectors.EVENT_WRITE:
                c.pump_out()
            if not (mask & selectors.EVENT_READ):
                continue
            try:
                data = c.sock.recv(262144)
            except BlockingIOError:
                continue
            if not data:
                raise SystemExit("server closed a keep-alive connection")
            c.buf += data
            # One response per in-flight request; parse complete responses.
            while True:
                hend = c.buf.find(b"\r\n\r\n")
                if hend < 0:
                    break
                head = c.buf[:hend]
                clpos = head.lower().find(b"content-length:")
                if clpos < 0:
                    raise SystemExit(f"response without Content-Length: {head[:200]!r}")
                cl_end = head.find(b"\r", clpos)  # -1: the last header line
                cl = int(head[clpos + 15 : cl_end if cl_end >= 0 else len(head)])
                total = hend + 4 + cl
                if len(c.buf) < total:
                    break
                body = c.buf[hend + 4 : total]
                c.buf = c.buf[total:]
                lats.append(time.perf_counter() - c.t_sent)
                count += 1
                if not head.startswith(b"HTTP/1.1 200") or c.expect not in body:
                    miss += 1
                c.fire()
            c.pump_out()

    window_s = time.time() - t_start
    for c in conns:
        c.sock.close()
    lat_ms = np.asarray(lats, dtype=np.float64) * 1e3
    print(
        json.dumps(
            {
                "count": count,
                "miss": miss,
                "window_s": window_s,
                "p50_ms": float(np.percentile(lat_ms, 50)) if count else None,
                "p99_ms": float(np.percentile(lat_ms, 99)) if count else None,
            }
        )
    )


if __name__ == "__main__":
    main()
