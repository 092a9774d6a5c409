"""The port's legacy line protocol (server/legacy.py) on the CPU: the cases
of tests/test_legacy.py against the port's LegacyServer in this process, a
session script whose reply bytes must equal the reference server's, and
the port's CLI serving `--legacy-port`.  Runs with AITPU_TORCH_DEVICE=cpu.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
from acoustid_index_tpu_torch.multi.multi_index import MultiIndex
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.server.legacy import LegacyServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("AITPU_TORCH_DEVICE", "cpu")
    mp.setattr(port_bl, "CHECK_SORTED", True)
    searcher = BatchingSearcher(device="cpu")
    mi = MultiIndex.open(str(tmp_path_factory.mktemp("legacy")), checkpoint_age=None, sync=False, searcher=searcher)
    srv = LegacyServer("127.0.0.1", 0, mi)
    srv.serve_background()
    yield srv
    srv.shutdown()
    srv.server_close()
    mi.close()
    searcher.close()
    mp.undo()


class Conn:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=20)
        self.buf = b""

    def raw(self, line):
        """One command; its reply line with the CRLF, as bytes."""
        self.sock.sendall(line.encode() + b"\r\n")
        while b"\r\n" not in self.buf:
            data = self.sock.recv(65536)
            if not data:
                raise ConnectionError("closed")
            self.buf += data
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line + b"\r\n"

    def cmd(self, line):
        return self.raw(line)[:-2].decode()

    def close(self):
        self.sock.close()


@pytest.fixture
def conn(server):
    c = Conn(server.port)
    yield c
    c.close()


# ---- tests/test_legacy.py's cases ----


def test_echo_and_unknown(conn):
    assert conn.cmd("echo hello world") == "OK hello world"
    assert conn.cmd("bogus") == "ERR unknown command"
    assert conn.cmd("") == "OK "


def test_transaction_insert_search(conn):
    assert conn.cmd("begin") == "OK "
    assert conn.cmd("insert 1 100,200,300") == "OK "
    # Signed decimals reinterpret as u32.
    assert conn.cmd("insert 2 -1,200") == "OK "
    assert conn.cmd("commit") == "OK "
    resp = conn.cmd("search 100,200,300")
    assert resp.startswith("OK ")
    assert "1:3" in resp
    resp = conn.cmd("search -1")
    assert "2:1" in resp


def test_transaction_guards(conn):
    assert conn.cmd("insert 5 1") == "ERR not in transaction"
    assert conn.cmd("commit") == "ERR not in transaction"
    assert conn.cmd("rollback") == "ERR not in transaction"
    assert conn.cmd("optimize") == "ERR not in transaction"
    assert conn.cmd("begin") == "OK "
    assert conn.cmd("begin") == "ERR already in transaction"
    assert conn.cmd("optimize") == "OK "
    assert conn.cmd("cleanup") == "OK "
    assert conn.cmd("rollback") == "OK "


def test_rollback_discards(conn):
    assert conn.cmd("begin") == "OK "
    assert conn.cmd("insert 77 4242") == "OK "
    assert conn.cmd("rollback") == "OK "
    assert conn.cmd("search 4242") == "OK "


def test_session_and_index_attributes(conn):
    assert conn.cmd("get max_results") == "OK 500"
    assert conn.cmd("set max_results 5") == "OK "
    assert conn.cmd("get max_results") == "OK 5"
    assert conn.cmd("get attribute top_score_percent") == "OK 10"
    # Index attributes require a transaction and persist via commit.
    assert conn.cmd("set myattr hello") == "ERR not in transaction"
    assert conn.cmd("begin") == "OK "
    assert conn.cmd("set myattr hello") == "OK "
    assert conn.cmd("commit") == "OK "
    assert conn.cmd("get myattr") == "OK hello"
    assert conn.cmd("get nosuchattr") == "OK "


def test_bad_inputs(conn):
    assert conn.cmd("search") == "ERR expected one argument"
    assert conn.cmd("search abc") == "ERR invalid fingerprint"
    assert conn.cmd("begin") == "OK "
    assert conn.cmd("insert x 1,2") == "ERR invalid document id"
    assert conn.cmd("insert 1 x,y") == "ERR invalid fingerprint"
    assert conn.cmd("rollback") == "OK "


def test_default_max_results_serves_past_128(conn):
    """Sessions default to max_results=500 (legacy.zig:44) and serve up to
    that many results; 200 matching docs must all come back."""
    assert conn.cmd("get max_results") == "OK 500"
    assert conn.cmd("begin") == "OK "
    for i in range(10001, 10201):
        assert conn.cmd(f"insert {i} 777777") == "OK "
    assert conn.cmd("commit") == "OK "
    resp = conn.cmd("search 777777")
    assert resp.startswith("OK ")
    pairs = resp[3:].split()
    assert len(pairs) == 200, len(pairs)
    assert set(pairs) == {f"{i}:1" for i in range(10001, 10201)}


# ---- the same session, byte for byte, against the reference ----

SESSION = (
    ["echo a  b", "", "bogus", "get max_results", "set max_results 3", "get timeout", "begin"]
    + [f"insert {i} {i},{i + 1},{i + 2},-{i}" for i in range(1, 40)]
    + ["insert 4294967295 5,6,7", "set note x", "commit", "get note", "search 5,6,7", "search 10,11,12,-10"]
    + ["set max_results 500", "search 20,21,22,23", "begin", "insert 21 900", "commit", "search 20,21,22,23"]
    + ["search -1", "search 1,,2", "insert 3 4", "rollback", "set top_score_percent 90", "search 5,6,7,8"]
)


def test_session_replies_are_byte_equal_to_reference(tmp_path, monkeypatch):
    from acoustid_index_tpu.multi.multi_index import MultiIndex as RefMultiIndex
    from acoustid_index_tpu.server.legacy import LegacyServer as RefLegacyServer

    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    searcher = BatchingSearcher(device="cpu")
    nodes = [
        (RefMultiIndex.open(str(tmp_path / "ref"), checkpoint_age=None, sync=False), RefLegacyServer),
        (MultiIndex.open(str(tmp_path / "port"), checkpoint_age=None, sync=False, searcher=searcher), LegacyServer),
    ]
    replies = []
    try:
        for mi, server_cls in nodes:
            srv = server_cls("127.0.0.1", 0, mi)
            srv.serve_background()
            c = Conn(srv.port)
            try:
                replies.append([c.raw(line) for line in SESSION])
            finally:
                c.close()
                srv.shutdown()
                srv.server_close()
    finally:
        for mi, _ in nodes:
            mi.close()
        searcher.close()
    assert replies[0] == replies[1]
    got = dict(zip(SESSION, replies[1]))
    assert got["search 5,6,7"] == b"OK 5:3 4294967295:3 4:2\r\n"
    assert got["search 1,,2"] == b"ERR invalid fingerprint\r\n"


def test_cli_serves_legacy_port(tmp_path):
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    env = dict(os.environ, PYTHONPATH=REPO, AITPU_TORCH_DEVICE="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "acoustid_index_tpu_torch.main", "--dir", str(tmp_path), "--port", "0",
         "--legacy-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    )
    try:
        line = ""
        deadline = time.time() + 120
        while not line.startswith("LISTENING") and time.time() < deadline:
            line = proc.stdout.readline()
        assert line.startswith("LISTENING"), line
        c = Conn(port)
        try:
            assert [c.cmd(x) for x in ("begin", "insert 9 11,22,33,44", "commit", "search 22,33,44,55")] == ["OK "] * 3 + ["OK 9:3"]
        finally:
            c.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
