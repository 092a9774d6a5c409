"""The restart's file tier built on the card (engine/card_tier.py over
ops/varint.py and csrc/varint_decode.cu), held to the host path exactly.

On the CPU: the plain PyTorch version of the card's decode (the same chunk
and tile steps as the kernels, at small chunk and tile sizes so that chunk
boundaries fall inside varints and runs of delta 0, and carries cross
tiles) against the host decoder (utils/native.decode_postings /
decode_sorted_u32), refusing what it refuses; the chunked CRC's combine
against zlib; then the card path on CPU tensors (read_segment_card,
pack_tier_card, Index.open with card_tier.on_card patched) against the host
path (read_segment, pack_tier_np): every field of the tier byte for byte,
the lazy columns equal to the host decode, the same ValueError for a
corrupt file, and a checkpoint after the restart writing the same file.

On a card (`test_cuda_*`, skipped without one; `python -m pytest
tests/test_torch_card_tier.py -k cuda` there): the kernels against the
plain version and the host decoder, and Index.open on the card against
pack_tier_np for ATS2 and ATS1 data directories of 1, 2 and 8 segments.
Every comparison is exact.
"""

import os
import shutil
import zlib

import numpy as np
import pytest
import torch

from acoustid_index_tpu_torch.engine import card_tier, filefmt, manifest
from acoustid_index_tpu_torch.engine.index import Index
from acoustid_index_tpu_torch.engine.memseg import build_segment
from acoustid_index_tpu_torch.engine.model import Delete, Insert, SegmentInfo
from acoustid_index_tpu_torch.engine.searcher import Searcher
from acoustid_index_tpu_torch.engine.segments import FILE_SLOTS, pack_tier_np, tier_from_numpy
from acoustid_index_tpu_torch.ops import varint
from acoustid_index_tpu_torch.utils import native

M32 = 0xFFFFFFFF


def _u8(buf: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(buf), dtype=torch.uint8) if buf else torch.zeros(0, dtype=torch.uint8)


def _varint_len(v: int) -> int:
    return 1 + (v >= 1 << 7) + (v >= 1 << 14) + (v >= 1 << 21) + (v >= 1 << 28)


# ---- postings that exercise the varints ----


def _postings(kind: str, n: int, seed: int):
    """Sorted (hash, docid) pairs, as u32 arrays."""
    rng = np.random.default_rng(seed)
    if kind == "widths":  # deltas and docids of every varint width, 1 to 5 bytes
        steps = np.array([1, 1 << 7, 1 << 14, 1 << 21, 1 << 28], np.uint64)
        h = np.cumsum(steps[rng.integers(0, 5, n)] + rng.integers(0, 100, n).astype(np.uint64)) & M32
        h = np.sort(h).astype(np.uint32)
        d = (steps[rng.integers(0, 5, n)] * rng.integers(1, 15, n).astype(np.uint64) & M32).astype(np.uint32)
    elif kind == "runs":  # long runs of one hash: docid deltas, delta 0
        h = np.sort(rng.integers(0, 6, n).astype(np.uint32) * np.uint32(1 << 29))
        d = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    else:  # uniform hashes, the benchmark's kind
        h = np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint64)).astype(np.uint32)
        d = rng.integers(0, 1 << 27, n, dtype=np.uint64).astype(np.uint32)
    o = np.lexsort((d, h))
    return h[o], d[o]


CASES = [("widths", 1), ("widths", 300), ("runs", 500), ("uniform", 2000), ("runs", 0)]


@pytest.mark.parametrize("chunk,tile", [(4096, 1024), (3, 2), (7, 4), (8, 1), (16, 3)])
@pytest.mark.parametrize("kind,n", CASES)
def test_plain_decode_matches_host_decoder(kind, n, chunk, tile):
    h, d = _postings(kind, n, seed=n + chunk)
    buf = native.encode_postings(h, d)
    want_h, want_d = native.decode_postings(buf, n)
    got_h, got_d = varint.decode_columns(_u8(buf), n, True, chunk=chunk, tile=tile)
    assert np.array_equal(got_h.numpy().view(np.uint32), want_h)
    assert np.array_equal(got_d.numpy().view(np.uint32), want_d)


def test_plain_decode_crosses_chunks_inside_varints_and_runs():
    """The cases above do cut varints and runs: in the 'runs' case some
    varint straddles a 7-byte chunk boundary, and some run of delta 0
    straddles a 4-value tile boundary."""
    h, d = _postings("runs", 500, seed=500 + 7)
    lens = np.array([_varint_len(v) for v in _deltas(h, d)])
    ends = np.cumsum(lens)
    assert int(ends[-1]) == len(native.encode_postings(h, d))
    assert np.any((ends - lens) // 7 != (ends - 1) // 7), "no varint crosses a 7-byte chunk boundary"
    in_run = np.flatnonzero(np.diff(h.astype(np.int64)) == 0) + 1  # pairs that continue a run
    assert np.any(in_run % 4 == 0), "no run of delta 0 crosses a 4-value tile boundary"


def _deltas(h, d):
    out = []
    ph = pd = 0
    for i in range(h.shape[0]):
        delta = (int(h[i]) - ph) & M32
        out += [delta, ((int(d[i]) - pd) & M32) if i and delta == 0 else int(d[i])]
        ph, pd = int(h[i]), int(d[i])
    return out


@pytest.mark.parametrize("chunk,tile", [(4096, 1024), (5, 2), (1, 1)])
@pytest.mark.parametrize("n", [0, 1, 77, 3000])
def test_plain_decode_matches_host_sorted(n, chunk, tile):
    rng = np.random.default_rng(n)
    v = np.unique(rng.integers(0, 1 << 32, n, dtype=np.uint64)).astype(np.uint32)
    buf = native.encode_sorted_u32(v)
    got, none = varint.decode_columns(_u8(buf), v.shape[0], False, chunk=chunk, tile=tile)
    assert none is None
    assert np.array_equal(got.numpy().view(np.uint32), native.decode_sorted_u32(buf, v.shape[0]))


def _host_refuses(buf: bytes, n: int, pairs: bool) -> bool:
    try:
        native.decode_postings(buf, n) if pairs else native.decode_sorted_u32(buf, n)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("pairs", [True, False])
@pytest.mark.parametrize("fault", ["short", "long_terminator", "long_continuation", "six_bytes", "count_low",
                                   "count_high", "empty_with_values", "bytes_for_none"])
def test_plain_decode_refuses_what_the_host_refuses(fault, pairs):
    h, d = _postings("widths", 40, seed=9)
    buf = native.encode_postings(h, d) if pairs else native.encode_sorted_u32(np.unique(h))
    n = 40 if pairs else np.unique(h).shape[0]
    if fault == "short":
        buf = buf[:-1]
    elif fault == "long_terminator":
        buf = buf + b"\x05"
    elif fault == "long_continuation":
        buf = buf + b"\x85"
    elif fault == "six_bytes":
        buf = b"\x81\x82\x83\x84\x85\x01" + buf[1:]  # the first varint takes six bytes
    elif fault == "count_low":
        n -= 1
    elif fault == "count_high":
        n += 1
    elif fault == "empty_with_values":
        buf = b""
    else:
        buf, n = b"\x00", 0
    assert _host_refuses(buf, n, pairs)
    for chunk in (4096, 4):
        with pytest.raises(ValueError):
            varint.decode_columns(_u8(buf), n, pairs, chunk=chunk)


def test_five_byte_varints_keep_the_host_decoders_bits():
    """A fifth byte above 0x0F carries bits past 32: both decoders drop them."""
    buf = bytes([0xFF, 0xFF, 0xFF, 0xFF, 0x7F, 0x00])  # (delta, dv) = (0xFFFFFFFF, 0)
    want = native.decode_postings(buf, 1)
    got = varint.decode_columns(_u8(buf), 1, True, chunk=2, tile=1)
    assert [int(x.numpy().view(np.uint32)[0]) for x in got] == [int(w[0]) for w in want] == [M32, 0]


def test_crc32_combine_matches_zlib():
    rng = np.random.default_rng(3)
    for la, lb in [(0, 0), (1, 0), (0, 5), (1000, 777), (65536, 1), (3, 1 << 20)]:
        a, b = rng.bytes(la), rng.bytes(lb)
        assert card_tier.crc32_combine(zlib.crc32(a), zlib.crc32(b), lb) == zlib.crc32(a + b)


# ---- data directories ----


def _segments(n_seg: int, seed: int, n_docs: int = 120, hot: bool = True):
    """Segments of inserts and deletes over overlapping doc ranges: later
    ones re-insert and delete docs of earlier ones (superseded docs,
    tombstones), and hot hashes make runs and ties across segments."""
    rng = np.random.default_rng(seed)
    segs = []
    for k in range(n_seg):
        ids = rng.choice(np.arange(1, 3 * n_docs), size=n_docs, replace=False)
        changes = []
        for i in ids[: n_docs - 10]:
            m = int(rng.integers(0, 24))
            hs = rng.integers(0, 1 << 32, m, dtype=np.uint64)
            if hot:
                hs[: m // 3] = rng.integers(0, 40, m // 3)
            changes.append(Insert(id=int(i), hashes=tuple(int(x) for x in hs)))
        changes += [Delete(id=int(i)) for i in ids[n_docs - 10 :]]
        segs.append(build_segment(changes, SegmentInfo(commit_id=k + 1, merges=0)))
    return segs


def _big_segment(n_postings: int, seed: int):
    rng = np.random.default_rng(seed)
    changes = [Insert(id=i + 1, hashes=tuple(int(x) for x in rng.integers(0, 1 << 32, 16, dtype=np.uint64)))
               for i in range(n_postings // 16)]
    return [build_segment(changes, SegmentInfo(commit_id=1, merges=0))]


def _write_dir(path: str, segments, raw: bool, monkeypatch) -> str:
    data = os.path.join(path, "data")
    os.makedirs(data, exist_ok=True)
    os.makedirs(os.path.join(path, "oplog"), exist_ok=True)
    with monkeypatch.context() as m:
        if raw:  # no codec: the writer falls back to ATS1
            m.setattr(filefmt.native, "encode_postings", lambda h, d: None)
        for s in segments:
            filefmt.write_segment(data, s)
    manifest.write_manifest(data, [s.info for s in segments])
    return data


def _bytes(x) -> bytes:
    if isinstance(x, (list, tuple)):
        return b"|".join(_bytes(v) for v in x)
    if isinstance(x, dict):
        return b"|".join(k.encode() + b"=" + _bytes(v) for k, v in sorted(x.items()))
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_same_view(got: dict, want: dict) -> None:
    """Every field of two packed views, byte for byte (tokens aside)."""
    keys = set(want) - {"view_token", "owner"}
    assert set(got) - {"view_token", "owner"} == keys
    for k in keys:
        assert _bytes(got[k]) == _bytes(want[k]), k


def _host_view(segments, **kw):
    return tier_from_numpy(pack_tier_np(segments, FILE_SLOTS, **kw), "cpu", mentions=False)


LAYOUTS = [(1, False), (2, False), (8, False), (1, True), (3, True)]


@pytest.mark.parametrize("raw", [False, True], ids=["ATS2", "ATS1"])
@pytest.mark.parametrize("n_seg,interleaved", LAYOUTS)
def test_card_path_on_cpu_matches_the_host_path(tmp_path, monkeypatch, n_seg, interleaved, raw):
    monkeypatch.setattr(card_tier, "READ_CHUNK", 1000)  # several chunks and workers per payload
    if interleaved:
        monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", "0")
        segs = _big_segment(70_000, seed=n_seg) + _segments(n_seg - 1, seed=n_seg)
    else:
        segs = _segments(n_seg, seed=n_seg)
    for k, s in enumerate(segs):
        object.__setattr__(s, "info", SegmentInfo(commit_id=k + 1, merges=0))
    data = _write_dir(str(tmp_path), segs, raw, monkeypatch)
    host = [filefmt.read_segment(data, s.info) for s in segs]
    card = [card_tier.read_segment_card(data, s.info, "cpu") for s in segs]
    for h, c in zip(host, card):
        assert c.num_items == h.num_items and c.num_docs == h.num_docs
        for f in ("docs_ids", "docs_alive"):
            assert _bytes(getattr(c, f)) == _bytes(getattr(h, f)) and getattr(c, f).dtype == getattr(h, f).dtype
        assert (c.info, c.min_doc_id, c.max_doc_id, c.metadata) == (h.info, h.min_doc_id, h.max_doc_id, h.metadata)
    assert card_tier.packs_on_card(card, "cpu") and not card_tier.packs_on_card(host, "cpu")
    want = _host_view(host)
    view = card_tier.pack_tier_card(card, FILE_SLOTS, mentions=False)
    assert ("inter" in view) == interleaved
    _assert_same_view(view, want)
    fetched = card_tier.COLUMNS["columns_fetched"]
    for h, c in zip(host, card):  # the lazy columns: the host decode's arrays
        assert c.hashes.dtype == h.hashes.dtype == np.uint32
        assert np.array_equal(c.hashes, h.hashes) and np.array_equal(c.docids, h.docids)
    assert card_tier.COLUMNS["columns_fetched"] == fetched + len(card)
    _assert_same_view(_host_view(card), want)  # a later host repack reads them


def test_sticky_shapes_pack_alike(tmp_path, monkeypatch):
    """The searcher's high-water capacities and slots give the same tier."""
    segs = _segments(2, seed=4)
    data = _write_dir(str(tmp_path), segs, False, monkeypatch)
    card = [card_tier.read_segment_card(data, s.info, "cpu") for s in segs]
    kw = dict(min_slots=16, min_caps=(8192, 4096, 2048))
    view = card_tier.pack_tier_card(card, FILE_SLOTS, mentions=False, **kw)
    _assert_same_view(view, _host_view(segs, **kw))


def _corrupt(path: str, fault: str) -> None:
    with open(path, "r+b") as f:
        raw = bytearray(f.read())
        if fault == "payload":
            raw[len(raw) // 2] ^= 0x40
        elif fault == "header":
            raw[12] ^= 0x01
        elif fault == "footer":
            raw[-1] ^= 0x01
        elif fault == "magic":
            raw[0] ^= 0x01
        f.seek(0)
        f.truncate()
        f.write(raw if fault != "truncated" else raw[: len(raw) - 9])


FAULTS = ["payload", "header", "footer", "magic", "truncated"]


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the type and message are compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("raw", [False, True], ids=["ATS2", "ATS1"])
@pytest.mark.parametrize("fault", FAULTS)
def test_card_reader_refuses_a_corrupt_file_as_the_host_does(tmp_path, monkeypatch, fault, raw):
    segs = _segments(1, seed=7)
    data = _write_dir(str(tmp_path), segs, raw, monkeypatch)
    _corrupt(os.path.join(data, filefmt.segment_file_name(segs[0].info)), fault)
    want = _error(lambda: filefmt.read_segment(data, segs[0].info))
    assert want is not None
    assert _error(lambda: card_tier.read_segment_card(data, segs[0].info, "cpu")) == want
    if fault != "header":
        assert want[0] is ValueError


def test_card_pack_builds_the_mention_table_once(tmp_path, monkeypatch):
    """Several segments over overlapping doc ranges: the card pack builds
    their mention table once, for the supersession filter and the tier's
    mention fields both."""
    from acoustid_index_tpu_torch.engine import segments as segments_mod

    segs = _segments(3, seed=41)
    data = _write_dir(str(tmp_path), segs, False, monkeypatch)
    card = [card_tier.read_segment_card(data, s.info, "cpu") for s in segs]
    calls = []
    real = segments_mod.build_mention_table

    def counted(segments):
        calls.append(len(segments))
        return real(segments)

    monkeypatch.setattr(card_tier, "build_mention_table", counted)
    monkeypatch.setattr(segments_mod, "build_mention_table", counted)
    view = card_tier.pack_tier_card(card, FILE_SLOTS, mentions=False)
    assert calls == [3]
    _assert_same_view(view, _host_view([filefmt.read_segment(data, s.info) for s in segs]))


def _open(path, card: bool, monkeypatch):
    monkeypatch.setattr(card_tier, "on_card", lambda device: card)
    return Index.open(path, checkpoint_age=None, sync=False, searcher=Searcher("cpu"))


def test_index_open_takes_the_card_path_and_a_checkpoint_writes_the_same_file(tmp_path, monkeypatch):
    """Index.open with the card path (on CPU tensors) against the host path
    on a copy of one data directory: the same file tier, the counters, the
    lazy columns fetched only by the checkpoint's repack, and the same new
    segment file."""
    segs = _segments(3, seed=11)
    base = str(tmp_path / "a")
    _write_dir(base, segs, False, monkeypatch)
    shutil.copytree(base, str(tmp_path / "b"))
    opened = {}
    counts = dict(card_tier.OPEN)
    fetched = card_tier.COLUMNS["columns_fetched"]
    for name, card in (("a", True), ("b", False)):
        opened[name] = _open(str(tmp_path / name), card, monkeypatch)
    assert card_tier.OPEN["card_segments"] == counts["card_segments"] + 3
    assert card_tier.OPEN["host_segments"] == counts["host_segments"] + 3
    a, b = opened["a"], opened["b"]
    try:
        assert all(isinstance(s, card_tier.CardSegment) for s in a.acquire_reader().file)
        _assert_same_view(a.acquire_reader().file_view, b.acquire_reader().file_view)
        assert card_tier.COLUMNS["columns_fetched"] == fetched
        extra = _segments(1, seed=12)[0]
        for idx in (a, b):
            idx.update([Insert(id=int(i), hashes=tuple(int(h) for h in extra.hashes[extra.docids == i]))
                        for i in np.unique(extra.docids)[:40]] + [Delete(id=int(segs[0].docs_ids[3]))])
            assert idx.checkpoint(force=True)
        assert card_tier.COLUMNS["columns_fetched"] == fetched + 3  # the repack read every card segment once
        fa, fb = a.acquire_reader(), b.acquire_reader()
        assert [s.info for s in fa.file] == [s.info for s in fb.file]
        name = filefmt.segment_file_name(fa.file[-1].info)
        with open(os.path.join(a.data_dir, name), "rb") as x, open(os.path.join(b.data_dir, name), "rb") as y:
            assert x.read() == y.read()
        _assert_same_view(fa.file_view, fb.file_view)
    finally:
        a.close()
        b.close()


def test_lazy_columns_fetch_once_under_contention(tmp_path, monkeypatch):
    """Many threads read a card segment's columns at once: one copy-back,
    every thread the same arrays."""
    import sys
    import threading

    segs = _segments(1, seed=17)
    data = _write_dir(str(tmp_path), segs, False, monkeypatch)
    seg = card_tier.read_segment_card(data, segs[0].info, "cpu")
    fetched = card_tier.COLUMNS["columns_fetched"]
    start = threading.Barrier(24)
    got = []

    def read():
        start.wait(timeout=30)
        got.append((seg.hashes, seg.docids))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(got) == 24
    assert card_tier.COLUMNS["columns_fetched"] == fetched + 1
    assert all(h is got[0][0] and d is got[0][1] for h, d in got)
    assert np.array_equal(got[0][0], segs[0].hashes) and np.array_equal(got[0][1], segs[0].docids)


def test_sharded_searcher_reads_the_lazy_columns(tmp_path, monkeypatch):
    """--mesh-shards packs its own per-shard tiers on the host: card
    segments give it their columns, decoded again on the card, once each."""
    from acoustid_index_tpu_torch.parallel.serving import ShardedBatchingSearcher

    segs = _segments(2, seed=13)
    base = str(tmp_path / "a")
    _write_dir(base, segs, False, monkeypatch)
    shutil.copytree(base, str(tmp_path / "b"))
    views = []
    fetched = card_tier.COLUMNS["columns_fetched"]
    for name, card in (("a", True), ("b", False)):
        monkeypatch.setattr(card_tier, "on_card", lambda device, card=card: card)
        searcher = ShardedBatchingSearcher(n_shards=2, device="cpu")
        idx = Index.open(str(tmp_path / name), checkpoint_age=None, sync=False, searcher=searcher)
        try:
            views.append(idx.acquire_reader().file_view)
        finally:
            idx.close()
            searcher.close()
    assert card_tier.COLUMNS["columns_fetched"] == fetched + 2
    _assert_same_view(*views)


# ---- on a card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _aligned(buf: bytes, device) -> torch.Tensor:
    t = torch.empty(len(buf), dtype=torch.uint8, device=device)
    if buf:
        t.copy_(_u8(buf))
    return t


# Past 2^20 postings (1,024 tiles) the carries kernel's threads each scan
# several tiles; the "runs" kind carries a run of delta 0 across them.
@pytest.mark.parametrize("kind,n", CASES + [("uniform", 300_000), ("widths", 70_000), ("runs", 3_000_000),
                                            ("uniform", 4_000_000)])
def test_cuda_decode_matches_plain_and_host(cuda, kind, n):
    h, d = _postings(kind, n, seed=n + 1)
    buf = native.encode_postings(h, d)
    want_h, want_d = native.decode_postings(buf, n)
    data = _aligned(buf, cuda)
    got_h, got_d = varint.decode_columns(data, n, True)
    torch.cuda.synchronize()
    plain_h, plain_d = varint.decode_columns(_u8(buf), n, True)
    for got, plain, want in ((got_h, plain_h, want_h), (got_d, plain_d, want_d)):
        assert np.array_equal(got.cpu().numpy(), plain.numpy())
        assert np.array_equal(got.cpu().numpy().view(np.uint32), want)
    # Straight into the interleaved layout, padded to a larger capacity.
    cap = (-(-max(n, 1) // 1024) + 3) * 1024
    starts = varint.scan(data, 2 * n)
    inter = torch.empty(2 * cap, dtype=torch.int32, device=cuda)
    top = torch.empty(cap // 1024, dtype=torch.int32, device=cuda)
    varint.decode(data, starts, n, True, inter, inter[1024:], 2048, cap, top)
    hp = np.full(cap, M32, np.uint32)
    dp = np.full(cap, M32, np.uint32)
    hp[:n], dp[:n] = want_h, want_d
    v = inter.cpu().numpy().view(np.uint32).reshape(-1, 2, 1024)
    assert np.array_equal(v[:, 0].reshape(-1), hp) and np.array_equal(v[:, 1].reshape(-1), dp)
    assert np.array_equal(top.cpu().numpy().view(np.uint32), hp[::1024])


def test_cuda_decode_counts_each_kernel_launch(cuda):
    """`launches.varint.*`: one launch of each of the five kernels for a
    stream's scan and decode."""
    h, d = _postings("uniform", 5000, seed=9)
    data = _aligned(native.encode_postings(h, d), cuda)
    before = dict(varint.LAUNCHES)
    varint.decode_columns(data, 5000, True)
    torch.cuda.synchronize()
    assert {k: varint.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    assert set(before) == {"count", "decode", "sums", "carries", "apply"}


def test_cuda_decode_sorted_and_refusals(cuda):
    v = np.unique(np.random.default_rng(5).integers(0, 1 << 32, 200_000, dtype=np.uint64)).astype(np.uint32)
    buf = native.encode_sorted_u32(v)
    got, _ = varint.decode_columns(_aligned(buf, cuda), v.shape[0], False)
    assert np.array_equal(got.cpu().numpy().view(np.uint32), v)
    h, d = _postings("widths", 5000, seed=3)
    good = native.encode_postings(h, d)
    for buf, n in [(good[:-1], 5000), (good + b"\x05", 5000), (good + b"\x85", 5000),
                   (b"\x81\x82\x83\x84\x85\x01" + good[1:], 5000), (good, 4999), (good, 5001), (b"\x00", 0)]:
        assert _host_refuses(buf, n, True)
        with pytest.raises(ValueError):
            varint.decode_columns(_aligned(buf, cuda), n, True)


@pytest.mark.parametrize("raw", [False, True], ids=["ATS2", "ATS1"])
@pytest.mark.parametrize("n_seg,interleaved", LAYOUTS)
def test_cuda_index_open_builds_the_host_tier(tmp_path, monkeypatch, cuda, n_seg, interleaved, raw):
    if interleaved:
        monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", "0")
        segs = _big_segment(200_000, seed=n_seg) + _segments(n_seg - 1, seed=n_seg)
    else:
        segs = _segments(n_seg, seed=n_seg)
    for k, s in enumerate(segs):
        object.__setattr__(s, "info", SegmentInfo(commit_id=k + 1, merges=0))
    path = str(tmp_path / "idx")
    _write_dir(path, segs, raw, monkeypatch)
    counts = dict(card_tier.OPEN)
    fetched = card_tier.COLUMNS["columns_fetched"]
    idx = Index.open(path, checkpoint_age=None, sync=False, searcher=Searcher(cuda))
    try:
        assert card_tier.OPEN["card_segments"] == counts["card_segments"] + n_seg
        snap = idx.acquire_reader()
        assert ("inter" in snap.file_view) == interleaved
        # No segment's file bytes stay on the card beside the tier: a
        # segment packed alone gave them up, several keep them in host memory.
        if n_seg == 1:
            assert snap.file[0].file_bytes is None
        else:
            assert all(s.file_bytes is not None and s.file_bytes.data.device.type == "cpu" for s in snap.file)
        host = [filefmt.read_segment(idx.data_dir, s.info) for s in segs]
        _assert_same_view(snap.file_view, _host_view(host))
        assert card_tier.COLUMNS["columns_fetched"] == fetched
        for h, c in zip(host, snap.file):
            assert np.array_equal(c.hashes, h.hashes) and np.array_equal(c.docids, h.docids)
        assert card_tier.COLUMNS["columns_fetched"] == fetched + n_seg
    finally:
        idx.close()


@pytest.mark.parametrize("fault", ["payload", "header", "truncated"])
def test_cuda_index_open_refuses_a_corrupt_file(tmp_path, monkeypatch, cuda, fault):
    segs = _segments(2, seed=21)
    path = str(tmp_path / "idx")
    data = _write_dir(path, segs, False, monkeypatch)
    _corrupt(os.path.join(data, filefmt.segment_file_name(segs[1].info)), fault)
    want = _error(lambda: filefmt.read_segment(data, segs[1].info))
    got = _error(lambda: Index.open(path, checkpoint_age=None, sync=False, searcher=Searcher(cuda)))
    assert got == want and want is not None


def test_cuda_checkpoint_after_a_card_restart_writes_the_host_file(tmp_path, monkeypatch, cuda):
    segs = _segments(2, seed=31)
    base = str(tmp_path / "a")
    _write_dir(base, segs, False, monkeypatch)
    shutil.copytree(base, str(tmp_path / "b"))
    a = Index.open(base, checkpoint_age=None, sync=False, searcher=Searcher(cuda))
    b = Index.open(str(tmp_path / "b"), checkpoint_age=None, sync=False, searcher=Searcher("cpu"))
    try:
        for idx in (a, b):
            idx.update([Insert(id=5000 + i, hashes=(i, i + 1, 1 << 31)) for i in range(30)]
                       + [Delete(id=int(segs[0].docs_ids[0]))])
            assert idx.checkpoint(force=True)
        fa, fb = a.acquire_reader(), b.acquire_reader()
        name = filefmt.segment_file_name(fa.file[-1].info)
        with open(os.path.join(a.data_dir, name), "rb") as x, open(os.path.join(b.data_dir, name), "rb") as y:
            assert x.read() == y.read()
        _assert_same_view(fa.file_view, fb.file_view)
    finally:
        a.close()
        b.close()
