"""REST API routes over MultiIndex.

Route table and semantics mirror upstream fpindex's src/server.zig:25-50 and
the README's HTTP API table: health probes, search/update, single
fingerprint sugar, index management, snapshot export, peer status.
Content negotiation: an explicit Content-Type wins; with no header, msgpack
when there is a body, JSON otherwise; Accept mirrors the request type.

The port's copy of acoustid_index_tpu/server/app.py: the same code, its
relative imports resolving to the port's own modules (its MultiIndex among
them).
"""

from __future__ import annotations

import os
import logging
from typing import Optional

from ..engine import errors
from ..engine.model import Delete, Insert
from ..multi import snapshot as snapshot_wire
from ..multi.multi_index import MultiIndex, SearchRequestParams
from ..utils.profiling import trace
from . import api
from .http import Request, Response, Router

log = logging.getLogger("acoustid_index_tpu_torch.server")

JSON = "application/json"
MSGPACK = "application/vnd.msgpack"


def request_type(req: Request) -> str:
    ct = req.headers.get("content-type")
    if ct:
        base = ct.split(";")[0].strip().lower()
        if base == JSON:
            return JSON
        if base in (MSGPACK, "application/msgpack", "application/x-msgpack"):
            return MSGPACK
        raise errors.UnsupportedMediaType(base)
    return MSGPACK if req.body else JSON


def response_type(req: Request) -> str:
    accept = req.headers.get("accept", "")
    base = accept.split(";")[0].strip().lower()
    if base == JSON:
        return JSON
    if base in (MSGPACK, "application/msgpack", "application/x-msgpack"):
        return MSGPACK
    try:
        return request_type(req)
    except errors.UnsupportedMediaType:
        return JSON


class App:
    def __init__(self, mi: MultiIndex):
        self.mi = mi
        self.router = Router()
        r = self.router
        r.get("/_metrics", self.handle_metrics)
        r.get("/_health", self.handle_health)
        r.head("/_health", self.handle_health)

        r.get("/:index/_health", self.handle_index_health)
        r.head("/:index/_health", self.handle_index_health)

        r.post("/:index/_search", self.handle_search)
        r.post("/:index/_update", self.handle_update)
        r.post("/:index/_bulk", self.handle_bulk)

        r.get("/:index/_snapshot", self.handle_snapshot_export)
        r.get("/:index/_status", self.handle_peer_status)

        r.head("/:index/:id", self.handle_head_fingerprint)
        r.get("/:index/:id", self.handle_get_fingerprint)
        r.put("/:index/:id", self.handle_put_fingerprint)
        r.delete("/:index/:id", self.handle_delete_fingerprint)

        r.head("/:index", self.handle_head_index)
        r.get("/:index", self.handle_get_index)
        r.put("/:index", self.handle_put_index)
        r.delete("/:index", self.handle_delete_index)

    # ---- helpers ----

    def _respond(self, req: Request, value, status: int = 200) -> Response:
        ct = response_type(req)
        body = api.encode_body(value, ct)
        return Response(status=status, headers={"Content-Type": ct}, body=body)

    def error_response(self, req: Request, exc: Exception) -> Response:
        if isinstance(exc, errors.IndexError_):
            name, status = exc.name, exc.status
        else:
            log.exception("unhandled error", exc_info=exc)
            name, status = "InternalError", 500
        ct = response_type(req)
        return Response(
            status=status,
            headers={"Content-Type": ct},
            body=api.encode_body(api.encode_error(name, ct == MSGPACK), ct),
        )

    def not_found(self, req: Request) -> Response:
        return self.error_response(req, errors.IndexNotFound("route"))

    def _require_body(self, req: Request, decoder):
        if req.body is None:
            raise errors.BadRequest("body required")
        return decoder(api.decode_body(req.body, request_type(req)))

    def _optional_body(self, req: Request, decoder, default: dict):
        if not req.body:
            return default
        return decoder(api.decode_body(req.body, request_type(req)))

    @staticmethod
    def _fingerprint_id(req: Request) -> int:
        raw = req.params.get("id", "")
        try:
            fp = int(raw)
        except ValueError:
            raise errors.BadRequest(f"bad fingerprint id: {raw!r}")
        if fp < 0 or fp > 0xFFFFFFFF:
            raise errors.BadRequest(f"fingerprint id out of u32 range: {raw}")
        return fp

    # ---- system ----

    def handle_metrics(self, req: Request) -> Response:
        return Response(
            body=self.mi.write_metrics(),
            headers={"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    def handle_health(self, req: Request) -> Response:
        return Response(body=b"OK\n")

    def handle_index_health(self, req: Request) -> Response:
        health = self.mi.index_health(req.params["index"])
        if health == "ready":
            return Response(body=b"OK\n")
        if health == "loading":
            return Response(status=503, body=b"LOADING\n")
        return Response(status=404, body=b"")

    # ---- search / update ----

    def handle_search(self, req: Request) -> Response:
        d = self._require_body(req, api.decode_search_request)
        # Sanitize untrusted values (the legacy front-end passes trusted ones).
        try:
            limit = max(min(int(d["limit"]), api.MAX_SEARCH_LIMIT), api.MIN_SEARCH_LIMIT)
            timeout_ms = min(int(d["timeout"]), api.MAX_SEARCH_TIMEOUT_MS)
            min_score = None if d["min_score"] is None else max(int(d["min_score"]), 0)
            score_pct = max(min(int(d["score_pct"]), 100), 0)
        except (TypeError, ValueError):
            raise errors.BadRequest("limit/timeout/min_score/score_pct must be integers")
        results = self.mi.search(
            req.params["index"],
            SearchRequestParams(
                query=d["query"],
                timeout=timeout_ms / 1000.0,
                limit=limit,
                min_score=min_score,
                score_pct=score_pct,
            ),
        )
        ct = response_type(req)
        return self._respond(req, api.encode_search_response(results, ct == MSGPACK))

    def handle_update(self, req: Request) -> Response:
        with trace("update.decode"):
            d = self._require_body(req, api.decode_update_request)
        version = self.mi.update(
            req.params["index"],
            d["changes"],
            metadata=d["metadata"],
            expected_version=d["expected_version"],
        )
        ct = response_type(req)
        return self._respond(req, api.encode_update_response(version, ct == MSGPACK))

    def handle_bulk(self, req: Request) -> Response:
        """Columnar bulk insert: one commit, packed u32 columns end-to-end
        (body -> oplog frame -> vectorized segment build), device packing
        deferred to the first reader."""
        d = self._require_body(req, api.decode_bulk_request)
        version = self.mi.update(
            req.params["index"],
            d["changes"],
            metadata=d["metadata"],
            expected_version=d["expected_version"],
        )
        ct = response_type(req)
        return self._respond(req, api.encode_update_response(version, ct == MSGPACK))

    # ---- single fingerprint (sugar over _update) ----

    def handle_head_fingerprint(self, req: Request) -> Response:
        fp = self._fingerprint_id(req)
        exists = self.mi.check_fingerprint_exists(req.params["index"], fp)
        return Response(status=200 if exists else 404)

    def handle_get_fingerprint(self, req: Request) -> Response:
        fp = self._fingerprint_id(req)
        info = self.mi.get_fingerprint_info(req.params["index"], fp)
        ct = response_type(req)
        return self._respond(req, api.encode_fingerprint_info(info, ct == MSGPACK))

    def handle_put_fingerprint(self, req: Request) -> Response:
        fp = self._fingerprint_id(req)
        d = self._require_body(req, api.decode_put_fingerprint_request)
        self.mi.update(req.params["index"], [Insert(id=fp, hashes=d["hashes"])])
        return self._respond(req, {})

    def handle_delete_fingerprint(self, req: Request) -> Response:
        fp = self._fingerprint_id(req)
        self.mi.update(req.params["index"], [Delete(id=fp)])
        return self._respond(req, {})

    # ---- index management ----

    def handle_head_index(self, req: Request) -> Response:
        exists = self.mi.check_index_exists(req.params["index"])
        return Response(status=200 if exists else 404)

    def handle_get_index(self, req: Request) -> Response:
        info = self.mi.get_index_info(req.params["index"])
        ct = response_type(req)
        return self._respond(req, api.encode_index_info(info, ct == MSGPACK))

    def handle_put_index(self, req: Request) -> Response:
        d = self._optional_body(req, api.decode_create_index_request, {"expect_does_not_exist": False, "generation": None})
        out = self.mi.create_index(req.params["index"], d["expect_does_not_exist"], d["generation"])
        ct = response_type(req)
        status = 200 if out["ready"] else 202
        return self._respond(req, api.encode_create_index_response(out, ct == MSGPACK), status=status)

    def handle_delete_index(self, req: Request) -> Response:
        d = self._optional_body(req, api.decode_delete_index_request, {"expect_exists": False})
        out = self.mi.delete_index(req.params["index"], d["expect_exists"])
        ct = response_type(req)
        return self._respond(req, api.encode_delete_index_response(out, ct == MSGPACK))

    # ---- replication-facing ----

    def handle_peer_status(self, req: Request) -> Response:
        st = self.mi.get_peer_status(req.params["index"])
        ct = response_type(req)
        return self._respond(req, api.encode_peer_status(st, ct == MSGPACK))

    def handle_snapshot_export(self, req: Request) -> Response:
        snap, generation, data_dir = self.mi.acquire_snapshot(req.params["index"])
        stream = snapshot_wire.write_snapshot(snap, generation, data_dir)
        return Response(headers={"Content-Type": "application/octet-stream"}, stream=stream)
