"""The coordinator HTTP service: the changelog protocol over msgpack.

Routes mirror upstream fpindex's src/coordinator_server.zig:42-52:
    POST   /_changelog/:index/:gen          append a batch (optimistic `expected`)
    GET    /_changelog/:index/:gen?after=N&max=M   read entries (never blocks;
                                            paces clients with retry_after_ms)
    PUT    /_index/:name                    register a create (pos = generation)
    DELETE /_index/:name                    register a delete
    GET    /_meta?after=N&max=M             read index lifecycle ops
    GET    /_bootstrap/:index/:gen          stream the corpus (msgpack: header,
                                            change batches, empty-array end)
    POST   /_truncate/:index/:gen?floor=N   drop entries at or below a position

Reads answer immediately with whatever exists and a retry_after_ms hint
(0 when the batch was full, 1000 when idle) — a blocking server would pin
storage transactions open.  Errors: 409 conflict, 404, 410 gone.

The port's copy of acoustid_index_tpu/cluster/coordinator_server.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import logging
from typing import Iterator

import msgpack

from ..engine import errors
from ..engine.model import change_from_wire, change_to_wire
from ..server.http import Request, Response, Router
from .coordinator import Coordinator, MemoryCoordinator

log = logging.getLogger("acoustid_index_tpu_torch.coordinator_server")

IDLE_RETRY_MS = 1000
DEFAULT_MAX_ENTRIES = 1000
MSGPACK = "application/vnd.msgpack"


class CoordinatorApp:
    def __init__(self, coordinator: Coordinator):
        self.coordinator = coordinator
        self.router = Router()
        r = self.router
        r.get("/_health", self.handle_health)
        r.post("/_changelog/:index/:gen", self.handle_append)
        r.get("/_changelog/:index/:gen", self.handle_read)
        r.put("/_index/:name", self.handle_create)
        r.delete("/_index/:name", self.handle_delete)
        r.get("/_meta", self.handle_meta)
        r.get("/_bootstrap/:index/:gen", self.handle_bootstrap)
        r.post("/_truncate/:index/:gen", self.handle_truncate)

    # ---- plumbing ----

    def error_response(self, req: Request, exc: Exception) -> Response:
        if isinstance(exc, errors.IndexError_):
            name, status = exc.name, exc.status
        else:
            log.exception("coordinator error", exc_info=exc)
            name, status = "InternalError", 500
        return Response(
            status=status,
            headers={"Content-Type": MSGPACK},
            body=msgpack.packb({"e": name}, use_bin_type=True),
        )

    def not_found(self, req: Request) -> Response:
        return Response(status=404, body=b"")

    @staticmethod
    def _gen(req: Request) -> int:
        try:
            return int(req.params["gen"])
        except ValueError:
            raise errors.BadRequest("bad generation")

    @staticmethod
    def _pack(value) -> Response:
        return Response(headers={"Content-Type": MSGPACK}, body=msgpack.packb(value, use_bin_type=True))

    def handle_health(self, req: Request) -> Response:
        return Response(body=b"OK\n")

    # ---- data feed ----

    def handle_append(self, req: Request) -> Response:
        if not req.body:
            raise errors.BadRequest("body required")
        d = msgpack.unpackb(req.body, strict_map_key=False)
        changes = [change_from_wire(c) for c in d.get("c") or []]
        expected = d.get("e")
        seq = self.coordinator.append(req.params["index"], self._gen(req), changes, expected)
        return self._pack({"i": seq})

    def handle_read(self, req: Request) -> Response:
        after = int(req.query.get("after", "0") or 0)
        max_entries = min(int(req.query.get("max", str(DEFAULT_MAX_ENTRIES)) or DEFAULT_MAX_ENTRIES), 10_000)
        import time

        # Answer immediately; pace the client with retry_after_ms.
        entries = self.coordinator.read(req.params["index"], self._gen(req), after, max_entries, time.monotonic())
        retry = 0 if len(entries) >= max_entries else IDLE_RETRY_MS if not entries else 0
        return self._pack(
            {
                "e": [{"i": e.id, "c": change_to_wire(e.change)} for e in entries],
                "r": retry,
            }
        )

    # ---- meta feed ----

    def handle_create(self, req: Request) -> Response:
        gen = self.coordinator.create_index(req.params["name"])
        return self._pack({"g": gen})

    def handle_delete(self, req: Request) -> Response:
        pos = self.coordinator.delete_index(req.params["name"])
        return self._pack({"p": pos})

    def handle_meta(self, req: Request) -> Response:
        import time

        after = int(req.query.get("after", "0") or 0)
        max_ops = min(int(req.query.get("max", "1000") or 1000), 10_000)
        ops = self.coordinator.read_meta(after, max_ops, time.monotonic())
        retry = 0 if len(ops) >= max_ops else IDLE_RETRY_MS if not ops else 0
        return self._pack(
            {
                "o": [{"p": op.pos, "k": op.kind[0], "n": op.index_name} for op in ops],
                "r": retry,
            }
        )

    # ---- bootstrap / retention ----

    def handle_bootstrap(self, req: Request) -> Response:
        stream = self.coordinator.open_bootstrap(req.params["index"], self._gen(req))
        if stream is None:
            raise errors.NotImplemented_("feed has complete history; replay instead")

        def chunks() -> Iterator[bytes]:
            try:
                yield msgpack.packb({"p": stream.position}, use_bin_type=True)
                while True:
                    batch = stream.next_batch()
                    if batch is None:
                        break
                    yield msgpack.packb([change_to_wire(c) for c in batch], use_bin_type=True)
                # The empty array is the PROPER-end marker: transports must be
                # able to tell "done" from "died", or a partial corpus would
                # install as complete.
                yield msgpack.packb([], use_bin_type=True)
            finally:
                stream.close()

        return Response(headers={"Content-Type": "application/octet-stream"}, stream=chunks())

    def handle_truncate(self, req: Request) -> Response:
        floor = int(req.query.get("floor", "0") or 0)
        self.coordinator.set_retention_floor(req.params["index"], self._gen(req), floor)
        return self._pack({})
