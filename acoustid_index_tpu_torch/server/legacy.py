"""Legacy AcoustID line protocol over TCP against the fixed "main" index.

Mirrors upstream fpindex's src/legacy.zig (itself a reimplementation of the
old C++ server): per-connection session attributes (max_results=500,
top_score_percent=10, timeout, idle_timeout=60s), a begin/insert/commit
transaction with buffered index attributes, `search <csv>` with results as
"id:score" pairs, signed-decimal hashes reinterpreted as u32, `OK <r>\r\n`
/ `ERR <msg>\r\n` framing, and read-only mode on replicas (begin rejected).

The port's copy of acoustid_index_tpu/server/legacy.py: the same code, its
relative imports resolving to the port's own modules (its MultiIndex, and
so the port's searcher on the card).  A session's max_results=500 default
is served through the searcher's 512-row output bucket.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
from typing import Dict, List, Optional, Tuple

from ..engine import errors
from ..engine.model import Insert
from ..multi.multi_index import MultiIndex, SearchRequestParams

log = logging.getLogger("acoustid_index_tpu_torch.legacy")

INDEX_NAME = "main"
MAX_LINE = 256 * 1024


class _Session:
    def __init__(self, read_only: bool):
        self.read_only = read_only
        self.max_results = 500
        self.top_score_percent = 10
        self.timeout_ms = 0  # 0 = no timeout
        self.idle_timeout_ms = 60_000
        self.in_txn = False
        self.changes: List = []
        self.attrs: Dict[str, str] = {}

    def clear_txn(self):
        self.changes = []
        self.attrs = {}

    SESSION_ATTRS = ("max_results", "top_score_percent", "timeout", "idle_timeout")

    def attr_field(self, name: str) -> Optional[str]:
        mapping = {
            "max_results": "max_results",
            "top_score_percent": "top_score_percent",
            "timeout": "timeout_ms",
            "idle_timeout": "idle_timeout_ms",
        }
        return mapping.get(name)


def parse_fingerprint(s: str) -> List[int]:
    """Comma-separated signed decimals, reinterpreted as u32."""
    if not s:
        raise ValueError("empty")
    out = []
    for tok in s.split(","):
        v = int(tok)  # may be signed
        out.append(v & 0xFFFFFFFF)
    if not out:
        raise ValueError("empty")
    return out


class _LegacyHandler(socketserver.BaseRequestHandler):
    def handle(self):
        server: LegacyServer = self.server  # type: ignore
        session = _Session(read_only=server.read_only)
        rfile = self.request.makefile("rb", buffering=65536)
        try:
            while True:
                self.request.settimeout(session.idle_timeout_ms / 1000.0 or None)
                try:
                    raw = rfile.readline(MAX_LINE + 1)
                except socket.timeout:
                    self._reply("ERR ", "timeout")
                    return
                if not raw:
                    return  # client closed
                if len(raw) > MAX_LINE:
                    self._reply("ERR ", "line too long")
                    return
                line = raw.decode("latin1").rstrip("\r\n")
                try:
                    ok, payload = server.dispatch(session, line)
                except Exception:
                    log.exception("legacy dispatch failed")
                    ok, payload = False, "internal error"
                self._reply("OK " if ok else "ERR ", payload)
        except (ConnectionError, OSError):
            return
        finally:
            try:
                rfile.close()
            except OSError:
                pass

    def _reply(self, prefix: str, payload: str):
        try:
            self.request.sendall((prefix + payload + "\r\n").encode("latin1"))
        except OSError:
            raise ConnectionError


class LegacyServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, host: str, port: int, mi: MultiIndex, read_only: bool = False):
        self.mi = mi
        self.read_only = read_only
        mi.create_index(INDEX_NAME)  # the protocol serves one fixed index
        super().__init__((host, port), _LegacyHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True, name=f"legacy:{self.port}")
        t.start()
        return t

    # ---- protocol ----

    def dispatch(self, session: _Session, line: str) -> Tuple[bool, str]:
        parts = line.split()
        if not parts:
            return True, ""  # empty line -> OK
        cmd, args = parts[0], parts[1:]

        if cmd == "echo":
            return True, " ".join(args)
        if cmd == "search":
            return self._search(session, args)
        if cmd == "insert":
            return self._insert(session, args)
        if cmd == "begin":
            if session.read_only:
                return False, "read-only replica"
            if session.in_txn:
                return False, "already in transaction"
            session.clear_txn()
            session.in_txn = True
            return True, ""
        if cmd == "commit":
            return self._commit(session)
        if cmd == "rollback":
            if not session.in_txn:
                return False, "not in transaction"
            session.in_txn = False
            session.clear_txn()
            return True, ""
        if cmd in ("optimize", "cleanup"):
            # Merging/cleanup runs in the background; keep the old
            # transaction guard, then no-op.
            if not session.in_txn:
                return False, "not in transaction"
            return True, ""
        if cmd == "get":
            return self._get_attribute(session, args)
        if cmd == "set":
            return self._set_attribute(session, args)
        return False, "unknown command"

    def _search(self, session: _Session, args: List[str]) -> Tuple[bool, str]:
        if len(args) != 1:
            return False, "expected one argument"
        try:
            hashes = parse_fingerprint(args[0])
        except ValueError:
            return False, "invalid fingerprint" if args[0] else "empty fingerprint"
        try:
            results = self.mi.search(
                INDEX_NAME,
                SearchRequestParams(
                    query=hashes,
                    limit=session.max_results,
                    timeout=session.timeout_ms / 1000.0,
                    min_score=1,
                    score_pct=session.top_score_percent,
                ),
            )
        except errors.SearchTimeout:
            return False, "timeout exceeded"
        except errors.IndexError_:
            return False, "search failed"
        return True, " ".join(f"{r.id}:{r.score}" for r in results)

    def _insert(self, session: _Session, args: List[str]) -> Tuple[bool, str]:
        if not session.in_txn:
            return False, "not in transaction"
        if len(args) != 2:
            return False, "expected two arguments"
        try:
            doc_id = int(args[0])
            if doc_id < 0 or doc_id > 0xFFFFFFFF:
                raise ValueError
        except ValueError:
            return False, "invalid document id"
        try:
            hashes = parse_fingerprint(args[1])
        except ValueError:
            return False, "invalid fingerprint" if args[1] else "empty fingerprint"
        session.changes.append(Insert(id=doc_id, hashes=hashes))
        return True, ""

    def _commit(self, session: _Session) -> Tuple[bool, str]:
        if not session.in_txn:
            return False, "not in transaction"
        if session.changes or session.attrs:
            try:
                self.mi.update(
                    INDEX_NAME,
                    session.changes,
                    metadata=session.attrs if session.attrs else None,
                )
            except errors.IndexError_:
                return False, "commit failed"
        session.in_txn = False
        session.clear_txn()
        return True, ""

    @staticmethod
    def _attr_name(args: List[str]) -> Optional[str]:
        if len(args) == 1:
            return args[0]
        if len(args) == 2 and args[0] == "attribute":
            return args[1]
        return None

    def _get_attribute(self, session: _Session, args: List[str]) -> Tuple[bool, str]:
        name = self._attr_name(args)
        if name is None:
            return False, "expected one argument"
        field = session.attr_field(name)
        if field is not None:
            return True, str(getattr(session, field))
        try:
            info = self.mi.get_index_info(INDEX_NAME)
        except errors.IndexError_:
            return True, ""
        return True, info["metadata"].get(name, "")

    def _set_attribute(self, session: _Session, args: List[str]) -> Tuple[bool, str]:
        if len(args) == 2:
            name, value = args
        elif len(args) == 3 and args[0] == "attribute":
            name, value = args[1], args[2]
        else:
            return False, "expected two arguments"
        field = session.attr_field(name)
        if field is not None:
            try:
                setattr(session, field, int(value))
            except ValueError:
                return False, "invalid value"
            return True, ""
        if not session.in_txn:
            return False, "not in transaction"
        session.attrs[name] = value
        return True, ""
