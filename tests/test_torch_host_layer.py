"""The port's own host layer: it imports nothing of the JAX package, its data
directories open in the reference and the reference's open in it, and it
writes segment files, WAL records, manifests, redirects and snapshot streams
byte for byte as the reference does.

Each package builds its own change objects and segments from the same
numpy inputs; nothing of one package is handed to the other.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from acoustid_index_tpu.engine import filefmt as ref_filefmt
from acoustid_index_tpu.engine import manifest as ref_manifest
from acoustid_index_tpu.engine import memseg as ref_memseg
from acoustid_index_tpu.engine import model as ref_model
from acoustid_index_tpu.engine import oplog as ref_oplog
from acoustid_index_tpu.multi import redirect as ref_redirect
from acoustid_index_tpu.utils import native as ref_native
from acoustid_index_tpu_torch.engine import filefmt as port_filefmt
from acoustid_index_tpu_torch.engine import manifest as port_manifest
from acoustid_index_tpu_torch.engine import memseg as port_memseg
from acoustid_index_tpu_torch.engine import model as port_model
from acoustid_index_tpu_torch.engine import oplog as port_oplog
from acoustid_index_tpu_torch.multi import redirect as port_redirect
from acoustid_index_tpu_torch.utils import native as port_native

from oracle import OracleSegment, oracle_search

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "acoustid_index_tpu_torch"


# ---- import hygiene ----


def test_port_imports_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import acoustid_index_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('acoustid_index_tpu', 'jax', 'probes'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), AITPU_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 49  # every module was imported, host layer included
    new = {"ops.build", "engine.device_merge", "models.fingerprint_search", "entry", "server.legacy", "utils.profiling",
           "ops.probe_lookup", "probes", "parallel", "parallel.sharded", "parallel.serving"}
    assert {f"acoustid_index_tpu_torch.{m}" for m in new} <= names


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("root", ["acoustid_index_tpu_torch", "chip_smoke.py"])
def test_no_source_imports_the_reference(root):
    files = sorted((REPO / root).rglob("*.py")) if (REPO / root).is_dir() else [REPO / root]
    assert files
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("acoustid_index_tpu", "jax", "probes")]
    assert not bad, bad


def test_native_builds_from_the_ports_sources():
    """The port's libraries and load generator are its own builds, named by
    a hash of the source, under its _build directory -- never the
    reference's native/ directory."""
    assert port_native.available() and port_native.front_lib() is not None
    paths = (port_native._load()._name, port_native.front_lib()._name, port_native.loadgen_path())
    for path, stem in zip(paths, ("libaitpu_native-", "libaitpu_front-", "aitpu_loadgen-")):
        assert os.path.dirname(path) == str(PORT / "_build") and os.path.basename(path).startswith(stem), path


# ---- byte-equal output ----


def _changes(model, seed, n=60, deletes=(3, 17)):
    rng = np.random.default_rng(seed)
    out = [model.Insert(id=i, hashes=rng.integers(0, 2**32, 24, dtype=np.uint32).tolist()) for i in range(1, n + 1)]
    out += [model.Delete(id=i) for i in deletes]
    out.append(model.SetMetadata(entries=(("k", f"v{seed}"),)))
    return out


def _both_segments(seed, commit_id=4):
    return [
        memseg.build_segment(_changes(model, seed), model.SegmentInfo(commit_id=commit_id, version=commit_id + 10))
        for model, memseg in ((ref_model, ref_memseg), (port_model, port_memseg))
    ]


@pytest.mark.parametrize("codecs", ["native", "python"])
def test_segment_files_and_manifests_are_byte_equal(tmp_path, codecs, monkeypatch):
    if codecs == "python":  # both packages on their pure-Python codec fallback
        for mod in (ref_native, port_native):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    ref_seg, port_seg = _both_segments(seed=1)
    names = []
    for tag, filefmt, seg in (("ref", ref_filefmt, ref_seg), ("port", port_filefmt, port_seg)):
        d = tmp_path / tag
        d.mkdir()
        names.append(os.path.basename(filefmt.write_segment(str(d), seg)))
    assert names[0] == names[1]
    assert (tmp_path / "ref" / names[0]).read_bytes() == (tmp_path / "port" / names[1]).read_bytes()

    # Each package reads the other's file back to the same arrays.
    back_port = port_filefmt.read_segment(str(tmp_path / "ref"), port_seg.info)
    back_ref = ref_filefmt.read_segment(str(tmp_path / "port"), ref_seg.info)
    for a, b in ((back_port, ref_seg), (back_ref, port_seg)):
        for f in ("hashes", "docids", "docs_ids", "docs_alive"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.metadata == b.metadata

    infos = [(m.SegmentInfo(commit_id=4, version=14, merges=2), m.SegmentInfo(commit_id=9)) for m in (ref_model, port_model)]
    ref_manifest.write_manifest(str(tmp_path / "ref"), infos[0])
    port_manifest.write_manifest(str(tmp_path / "port"), infos[1])
    mf = [p for p in os.listdir(tmp_path / "ref") if p not in names]
    assert mf and sorted(mf) == sorted(p for p in os.listdir(tmp_path / "port") if p not in names)
    for p in mf:
        assert (tmp_path / "ref" / p).read_bytes() == (tmp_path / "port" / p).read_bytes()
    assert [i.to_wire() for i in port_manifest.read_manifest(str(tmp_path / "ref"))] == [i.to_wire() for i in infos[0]]


def test_wal_records_and_redirects_are_byte_equal(tmp_path):
    seen = {"ref": [], "port": []}
    for tag, model, oplog in (("ref", ref_model, ref_oplog), ("port", port_model, port_oplog)):
        log = oplog.Oplog.open(str(tmp_path / tag), sync=False, handler=seen[tag].append, max_file_size=4096)
        for seed in range(5):
            log.append(_changes(model, seed, n=12), version=None if seed < 3 else 100 + seed)
        log.close()
    ref_files = sorted(os.listdir(tmp_path / "ref"))
    assert len(ref_files) > 1 and ref_files == sorted(os.listdir(tmp_path / "port"))
    for f in ref_files:
        assert (tmp_path / "ref" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f

    # Replay across packages: the port reads the reference's WAL and back.
    got = {"ref": [], "port": []}
    port_oplog.Oplog.open(str(tmp_path / "ref"), sync=False, handler=got["port"].append).close()
    ref_oplog.Oplog.open(str(tmp_path / "port"), sync=False, handler=got["ref"].append).close()
    assert [t.to_wire() for t in got["port"]] == [t.to_wire() for t in got["ref"]]
    assert len(got["port"]) == 5 and isinstance(got["port"][0].changes[0], port_model.Insert)

    for tag, redirect in (("ref", ref_redirect), ("port", port_redirect)):
        d = tmp_path / f"{tag}_name"
        d.mkdir()
        redirect.write_redirect(str(d), redirect.IndexRedirect(name="main", generation=7))
    assert (tmp_path / "ref_name").iterdir() and sorted(os.listdir(tmp_path / "ref_name")) == sorted(os.listdir(tmp_path / "port_name"))
    for f in os.listdir(tmp_path / "ref_name"):
        assert (tmp_path / "ref_name" / f).read_bytes() == (tmp_path / "port_name" / f).read_bytes()
    assert port_redirect.read_redirect(str(tmp_path / "ref_name")).generation == 7


# ---- cross-package data directories ----


def _package(tag):
    if tag == "ref":
        from acoustid_index_tpu.multi import multi_index, snapshot

        return multi_index, ref_model, snapshot, {}
    from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
    from acoustid_index_tpu_torch.multi import multi_index, snapshot

    return multi_index, port_model, snapshot, {"searcher": BatchingSearcher(device="cpu")}


def _close(mi, kw):
    mi.close()
    if "searcher" in kw:
        kw["searcher"].close()


def _corpus(seed=9, n=50):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(0, 2**32, 16, dtype=np.uint32).tolist() for i in range(1, n + 1)}


def _search_all(mi, mod, queries):
    out = []
    for q in queries:
        res = mi.search("main", mod.SearchRequestParams(query=q, limit=10, min_score=2, timeout=0))
        out.append([(r.id, r.score) for r in res])
    return out


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_data_directory_opens_in_the_other_package(tmp_path, writer, reader):
    """The writer's MultiIndex takes inserts, deletes and a checkpoint, then
    more writes that live only in the WAL; the reader's MultiIndex reopens
    the directory (replaying the WAL) and answers every search as the
    writer did, as the oracle does, and streams the same snapshot bytes."""
    docs = _corpus()
    extra = {i: v for i, v in _corpus(seed=10, n=70).items() if i > 45}  # re-inserts 46..50, new 51..70
    queries = [docs[i][:8] + [7] for i in (1, 2, 9, 30, 44)] + [extra[i][:6] for i in (47, 55, 70)] + [docs[3][:5]]

    mod_w, model_w, snap_w, kw_w = _package(writer)
    mi = mod_w.MultiIndex.open(str(tmp_path), checkpoint_age=None, sync=False, **kw_w)
    mi.create_index("main")
    mi.update("main", [model_w.Insert(id=i, hashes=h) for i, h in docs.items()])
    mi.update("main", [model_w.Delete(id=i) for i in (3, 4)])
    ref = mi._get_ref("main")
    try:
        assert ref.index.checkpoint(force=True)
    finally:
        mi._release_ref(ref)
    mi.update("main", [model_w.Insert(id=i, hashes=h) for i, h in extra.items()] + [model_w.Delete(id=9)])
    want = _search_all(mi, mod_w, queries)
    want_stream = b"".join(snap_w.write_snapshot(*mi.acquire_snapshot("main")))
    _close(mi, kw_w)

    live = {**docs, **extra}
    for i in (3, 4, 9):
        live.pop(i)
    items = [(h, d) for d, hs in live.items() for h in hs]
    oracle = [oracle_search([OracleSegment(items, {d: True for d in live})], q, limit=10, min_score=2) for q in queries]
    assert want == oracle
    assert all(want[k] for k in (0, 1, 4, 5, 6, 7)) and 9 not in [d for d, _ in want[2]]

    mod_r, model_r, snap_r, kw_r = _package(reader)
    mi = mod_r.MultiIndex.open(str(tmp_path), checkpoint_age=None, sync=False, **kw_r)
    try:
        ref = mi._get_ref("main")
        try:
            snap = ref.index.acquire_reader()
            assert snap.file and snap.memory, "expected a file segment and a replayed WAL tail"
        finally:
            mi._release_ref(ref)
        assert _search_all(mi, mod_r, queries) == want
        assert mi.check_fingerprint_exists("main", 50) and mi.check_fingerprint_exists("main", 70)
        assert not mi.check_fingerprint_exists("main", 9) and not mi.check_fingerprint_exists("main", 3)
        # The snapshot stream a peer would pull: same header, same files.
        assert b"".join(snap_r.write_snapshot(*mi.acquire_snapshot("main"))) == want_stream
    finally:
        _close(mi, kw_r)
