"""HTTP client implementation of the Coordinator interface.

Converts the server's answer-immediately + retry_after_ms protocol into the
blocking `read` contract by polling and sleeping (min 50ms floor, deadline
clamped), mirroring upstream fpindex's src/RemoteCoordinator.zig.  Status
mapping: 410 -> BelowRetention, 403 -> FeedIsReadOnly, 409 ->
VersionMismatch, anything else unexpected -> CoordinatorError.

The port's copy of acoustid_index_tpu/cluster/remote_coordinator.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

import msgpack
import requests

from ..engine import errors
from ..engine.model import Change, change_from_wire, change_to_wire
from .coordinator import BootstrapStream, Coordinator, Entry, MetaOp

log = logging.getLogger("acoustid_index_tpu_torch.remote_coordinator")

MSGPACK = "application/vnd.msgpack"
POLL_FLOOR = 0.05  # never spin faster than this
HTTP_TIMEOUT = 30.0


def _status_error(r: requests.Response) -> Exception:
    if r.status_code == 410:
        return errors.BelowRetention(r.text[:200])
    if r.status_code == 403:
        return errors.FeedIsReadOnly(r.text[:200])
    if r.status_code == 409:
        return errors.VersionMismatch(r.text[:200])
    if r.status_code == 404:
        return errors.IndexNotFound(r.text[:200])
    return errors.CoordinatorError(f"{r.status_code}: {r.text[:200]}")


class _HttpBootstrapStream(BootstrapStream):
    """Decodes the chunked msgpack corpus stream; the empty-array terminator
    discriminates a proper end from a truncated transfer."""

    def __init__(self, resp: requests.Response):
        self._resp = resp
        self._unpacker = msgpack.Unpacker(strict_map_key=False)
        self._iter = resp.iter_content(chunk_size=65536)
        header = self._next_obj()
        if header is None or not isinstance(header, dict):
            raise errors.CoordinatorError("truncated bootstrap stream header")
        self.position = header.get("p", 0)
        self._ended = False

    def _next_obj(self):
        while True:
            try:
                return self._unpacker.unpack()
            except msgpack.OutOfData:
                try:
                    chunk = next(self._iter)
                except StopIteration:
                    return None
                self._unpacker.feed(chunk)

    def next_batch(self) -> Optional[List[Change]]:
        if self._ended:
            return None
        obj = self._next_obj()
        if obj is None:
            # The transport died before the empty-array end marker.
            raise errors.CoordinatorError("bootstrap stream truncated")
        if not isinstance(obj, list):
            raise errors.CoordinatorError("bad bootstrap stream frame")
        if len(obj) == 0:
            self._ended = True
            return None
        return [change_from_wire(c) for c in obj]

    def close(self) -> None:
        self._resp.close()


class RemoteCoordinator(Coordinator):
    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        self._session = requests.Session()

    def close(self) -> None:
        self._session.close()

    # ---- helpers ----

    def _post(self, path: str, body: dict, params=None) -> dict:
        try:
            r = self._session.post(
                self.base_url + path,
                data=msgpack.packb(body, use_bin_type=True),
                headers={"Content-Type": MSGPACK},
                params=params,
                timeout=HTTP_TIMEOUT,
            )
        except requests.RequestException as exc:
            raise errors.CoordinatorError(str(exc)) from exc
        if r.status_code != 200:
            raise _status_error(r)
        return msgpack.unpackb(r.content, strict_map_key=False)

    def _get(self, path: str, params=None) -> dict:
        try:
            r = self._session.get(self.base_url + path, params=params, timeout=HTTP_TIMEOUT)
        except requests.RequestException as exc:
            raise errors.CoordinatorError(str(exc)) from exc
        if r.status_code != 200:
            raise _status_error(r)
        return msgpack.unpackb(r.content, strict_map_key=False)

    # ---- Coordinator interface ----

    def append(self, index_name, generation, changes, expected):
        body = {"c": [change_to_wire(c) for c in changes]}
        if expected is not None:
            body["e"] = expected
        return self._post(f"/_changelog/{index_name}/{generation}", body)["i"]

    def read(self, index_name, generation, after, max_entries, deadline):
        while True:
            d = self._get(
                f"/_changelog/{index_name}/{generation}",
                params={"after": after, "max": max_entries},
            )
            entries = [
                Entry(id=e["i"], change=change_from_wire(e["c"])) for e in d.get("e") or []
            ]
            if entries:
                return entries
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            retry = max((d.get("r") or 0) / 1000.0, POLL_FLOOR)
            time.sleep(min(retry, remaining))

    def create_index(self, name: str) -> int:
        try:
            r = self._session.put(f"{self.base_url}/_index/{name}", timeout=HTTP_TIMEOUT)
        except requests.RequestException as exc:
            raise errors.CoordinatorError(str(exc)) from exc
        if r.status_code != 200:
            raise _status_error(r)
        return msgpack.unpackb(r.content, strict_map_key=False)["g"]

    def delete_index(self, name: str) -> int:
        try:
            r = self._session.delete(f"{self.base_url}/_index/{name}", timeout=HTTP_TIMEOUT)
        except requests.RequestException as exc:
            raise errors.CoordinatorError(str(exc)) from exc
        if r.status_code != 200:
            raise _status_error(r)
        return msgpack.unpackb(r.content, strict_map_key=False)["p"]

    def read_meta(self, after, max_ops, deadline):
        while True:
            d = self._get("/_meta", params={"after": after, "max": max_ops})
            ops = [
                MetaOp(pos=o["p"], kind="create" if o["k"] == "c" else "delete", index_name=o["n"])
                for o in d.get("o") or []
            ]
            if ops:
                return ops
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            retry = max((d.get("r") or 0) / 1000.0, POLL_FLOOR)
            time.sleep(min(retry, remaining))

    def set_retention_floor(self, index_name, generation, floor):
        self._post(f"/_truncate/{index_name}/{generation}", {}, params={"floor": floor})

    def open_bootstrap(self, index_name, generation):
        try:
            r = self._session.get(
                f"{self.base_url}/_bootstrap/{index_name}/{generation}",
                stream=True,
                timeout=HTTP_TIMEOUT,
            )
        except requests.RequestException as exc:
            raise errors.CoordinatorError(str(exc)) from exc
        if r.status_code == 501:
            r.close()
            return None  # feed declares complete history; replay instead
        if r.status_code != 200:
            raise _status_error(r)
        return _HttpBootstrapStream(r)
