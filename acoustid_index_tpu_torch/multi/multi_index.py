"""MultiIndex: named indexes in generation-scoped lineage directories.

Mirrors upstream fpindex's src/MultiIndex.zig: the manager lock is held only
for map lookups and refcounting; searches and updates run outside it.  Each
index name lives under dir/<name>/v<generation>/ with a durable `current`
redirect; delete + recreate always bumps the generation so lineages never
mix.  In replicated mode creates/deletes/updates route through the
Replicator and the meta consumer is the only mutator of the index map.

The port's copy of acoustid_index_tpu/multi/multi_index.py: the same code,
its relative imports resolving to the port's own modules (its Index and
searcher among them).
"""

from __future__ import annotations

import logging
import math
import os
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..engine import errors
from ..engine.index import Index
from ..engine.model import Change, Delete, Insert, SearchOptions, SearchResult, fold_metadata
from ..engine.searcher import Searcher, default_searcher
from . import redirect as index_redirect
from ..server import metrics
from ..utils.profiling import trace

log = logging.getLogger("acoustid_index_tpu_torch.multi")

_NAME_RE = re.compile(r"^[A-Za-z0-9_-]{1,255}$")


def is_valid_name(name: str) -> bool:
    # Index names double as directory names: no separators, no dots.
    return bool(_NAME_RE.match(name))


@dataclass
class IndexRef:
    index: Index
    generation: int
    references: int = 1  # the map's own reference
    being_deleted: bool = False


@dataclass(frozen=True)
class SearchRequestParams:
    query: Sequence[int]
    timeout: float = 0.5
    limit: int = 40
    min_score: Optional[int] = None
    score_pct: int = 10


class MultiIndex:
    def __init__(
        self,
        dir_path: str,
        checkpoint_threshold: int = Index.DEFAULT_CHECKPOINT_THRESHOLD,
        checkpoint_age: Optional[float] = Index.DEFAULT_CHECKPOINT_AGE,
        sync: bool = True,
        load_concurrency: Optional[int] = None,
        searcher: Optional[Searcher] = None,
    ):
        self.dir = dir_path
        self.checkpoint_threshold = checkpoint_threshold
        self.checkpoint_age = checkpoint_age
        self.sync = sync
        self.load_concurrency = load_concurrency
        # ONE semaphore shared by every index this manager opens, so
        # --load-concurrency N bounds total concurrent segment loads (the
        # reference's shared semaphore, MultiIndex.zig:201-223); the
        # per-index × per-manager pool product would otherwise allow N×N.
        # None/0 = unlimited (no semaphore, per --load-concurrency's help;
        # each index still bounds its own pool at min(8, segments)).
        self._load_semaphore = (
            threading.Semaphore(load_concurrency) if load_concurrency else None
        )
        self.searcher = searcher or default_searcher()
        self.replication = None  # set by start_replication (cluster mode)

        self._lock = threading.Lock()
        self._released = threading.Condition(self._lock)
        self._indexes: Dict[str, IndexRef] = {}

    # ---- open / close ----

    @classmethod
    def open(cls, dir_path: str, **kw) -> "MultiIndex":
        os.makedirs(dir_path, exist_ok=True)
        self = cls(dir_path, **kw)
        names = []
        for entry in os.listdir(dir_path):
            name_dir = os.path.join(dir_path, entry)
            if not os.path.isdir(name_dir) or not is_valid_name(entry):
                continue
            r = index_redirect.read_redirect(name_dir)
            if r is None or r.deleted:
                continue
            names.append((entry, r))
        if names:
            workers = self.load_concurrency or min(8, len(names))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                refs = list(pool.map(lambda nr: (nr[0], nr[1], self._open_lineage(nr[0], nr[1].generation)), names))
            for name, r, index in refs:
                self._indexes[name] = IndexRef(index=index, generation=r.generation)
        return self

    def close(self) -> None:
        with self._lock:
            refs = list(self._indexes.values())
            self._indexes.clear()
        for ref in refs:
            ref.index.close()

    def _open_lineage(self, name: str, generation: int) -> Index:
        path = os.path.join(self.dir, name, f"v{generation:06d}")
        os.makedirs(path, exist_ok=True)
        index = Index.open(
            path,
            checkpoint_threshold=self.checkpoint_threshold,
            checkpoint_age=self.checkpoint_age,
            sync=self.sync,
            load_concurrency=self.load_concurrency,
            searcher=self.searcher,
            load_semaphore=self._load_semaphore,
        )
        index.start()
        return index

    # ---- refcounted lookup ----

    def _get_ref(self, name: str) -> IndexRef:
        with self._lock:
            ref = self._indexes.get(name)
            if ref is None or ref.being_deleted:
                raise errors.IndexNotFound(name)
            ref.references += 1
            return ref

    def _get_ref_for_generation(self, name: str, generation: int) -> IndexRef:
        with self._lock:
            ref = self._indexes.get(name)
            if ref is None or ref.being_deleted:
                raise errors.IndexNotFound(name)
            if ref.generation != generation:
                raise errors.IndexNotFound(f"{name} generation {generation} != {ref.generation}")
            ref.references += 1
            return ref

    def _release_ref(self, ref: IndexRef) -> None:
        with self._lock:
            ref.references -= 1
            self._released.notify_all()

    # ---- search / update ----

    def search(self, name: str, request: SearchRequestParams) -> List[SearchResult]:
        deadline = (time.monotonic() + request.timeout) if request.timeout else None
        ref = self._get_ref(name)
        try:
            if self.replication is not None and self.replication.is_bootstrapping(name):
                # A bootstrap is filling this index; every answer would be
                # honest-looking but empty or stale.
                raise errors.IndexNotReady(name)
            metrics.inc_searches(name)
            query = list(request.query)
            options = SearchOptions(
                max_results=request.limit,
                # ceil(|query|/20) when unspecified (MultiIndex.zig:304).
                min_score=request.min_score if request.min_score is not None else (len(query) + 19) // 20,
                min_score_pct=request.score_pct,
            )
            start = time.monotonic()
            results, stats = ref.index.search(query, options, deadline=deadline)
            metrics.observe_search_seconds(name, time.monotonic() - start)
            metrics.observe_postings_scanned(stats.postings_scanned)
            metrics.observe_max_postings_per_hash(stats.max_per_hash)
            metrics.observe_scanned_blocks_per_hash(stats.max_blocks_per_hash)
            if results:
                metrics.inc_search_hit(name)
            else:
                metrics.inc_search_miss(name)
            return results
        finally:
            self._release_ref(ref)

    def update(
        self,
        name: str,
        changes: Sequence[Change],
        metadata: Optional[dict] = None,
        expected_version: Optional[int] = None,
    ) -> int:
        # Fingerprint id 0 is reserved (the "unset" sentinel in segments).
        from ..engine.model import BulkInsert

        for change in changes:
            if isinstance(change, (Insert, Delete)) and change.id == 0:
                raise errors.InvalidFingerprintId("fingerprint id 0 is reserved")
            if isinstance(change, BulkInsert) and change.ids.size and not change.ids.all():
                raise errors.InvalidFingerprintId("fingerprint id 0 is reserved")
        folded = fold_metadata(changes, metadata)

        if self.replication is not None:
            return self.replication.update(name, folded, expected_version)

        ref = self._get_ref(name)
        try:
            metrics.inc_updates(name)
            return ref.index.update(folded, expected_version=expected_version)
        finally:
            self._release_ref(ref)

    def apply_log(self, name: str, generation: int, changes: Sequence[Change], version: int) -> None:
        """Apply changes at an externally-assigned version (the replicated
        consumer's path); `generation` guards against a rebuilt lineage."""
        ref = self._get_ref_for_generation(name, generation)
        try:
            metrics.inc_updates(name)
            ref.index.update(changes, version=version)
        finally:
            self._release_ref(ref)

    # ---- index management ----

    def create_index(self, name: str, expect_does_not_exist: bool = False, generation: Optional[int] = None) -> dict:
        if not is_valid_name(name):
            raise errors.InvalidIndexName(name)
        if self.replication is not None:
            return self._create_index_replicated(name, expect_does_not_exist, generation)

        with self._lock:
            existing = self._indexes.get(name)
            if existing is not None:
                if not existing.being_deleted:
                    # Idempotent, but honor an optimistic generation.
                    if expect_does_not_exist:
                        raise errors.IndexAlreadyExists(name)
                    if generation is not None:
                        if generation < existing.generation:
                            raise errors.OlderIndexAlreadyExists(name)
                        if generation > existing.generation:
                            raise errors.NewerIndexAlreadyExists(name)
                    return {"version": existing.index.version, "ready": True, "generation": existing.generation}
                raise errors.IndexAlreadyExists(name)

            name_dir = os.path.join(self.dir, name)
            os.makedirs(name_dir, exist_ok=True)
            prior = index_redirect.read_redirect(name_dir)
            if generation is not None:
                if prior is not None and generation <= prior.generation:
                    raise errors.OlderIndexAlreadyExists(name)
                gen = generation
            else:
                gen = prior.generation + 1 if prior is not None else 1

            ref = self._install_new_lineage(name, gen)
            return {"version": ref.index.version, "ready": True, "generation": gen}

    def _create_index_replicated(self, name: str, expect_does_not_exist: bool, generation: Optional[int]) -> dict:
        # The coordinator owns generation assignment in replicated mode.
        if generation is not None:
            raise errors.GenerationNotAllowed(name)
        repl = self.replication
        if expect_does_not_exist and self.check_index_exists(name):
            raise errors.IndexAlreadyExists(name)
        gen = repl.coordinator.create_index(name)
        repl.wait_meta_applied(gen)
        with self._lock:
            ref = self._indexes.get(name)
            if ref is None:
                raise errors.IndexNotFound(name)
            return {"version": ref.index.version, "ready": True, "generation": ref.generation}

    def _install_new_lineage(self, name: str, generation: int) -> IndexRef:
        """Caller must hold the manager lock."""
        name_dir = os.path.join(self.dir, name)
        os.makedirs(name_dir, exist_ok=True)
        index_redirect.write_redirect(name_dir, index_redirect.IndexRedirect(name=name, generation=generation))
        index = self._open_lineage(name, generation)
        ref = IndexRef(index=index, generation=generation)
        self._indexes[name] = ref
        return ref

    def delete_index(self, name: str, expect_exists: bool = False) -> dict:
        if self.replication is not None:
            existed = self.check_index_exists(name)
            if not existed and expect_exists:
                raise errors.IndexNotFound(name)
            pos = self.replication.coordinator.delete_index(name)
            self.replication.wait_meta_applied(pos)
            return {"deleted": existed}

        dropped = self._drop_index(name)
        if not dropped and expect_exists:
            raise errors.IndexNotFound(name)
        return {"deleted": dropped}

    def _drop_index(self, name: str) -> bool:
        """Block new borrows, drain outstanding ones, deinit, mark the
        redirect deleted and remove the generation's data dir."""
        with self._lock:
            ref = self._indexes.get(name)
            if ref is None or ref.being_deleted:
                return False
            ref.being_deleted = True
            while ref.references > 1:
                self._released.wait()
            del self._indexes[name]
            gen = ref.generation
        ref.index.close()
        metrics.remove_index(name)
        try:
            name_dir = os.path.join(self.dir, name)
            index_redirect.write_redirect(
                name_dir, index_redirect.IndexRedirect(name=name, generation=gen, deleted=True)
            )
            shutil.rmtree(os.path.join(name_dir, f"v{gen:06d}"), ignore_errors=True)
        except OSError:
            log.warning("failed to mark index %r deleted", name, exc_info=True)
        return True

    # ---- meta-consumer local ops (replicated mode) ----

    def reconcile_create(self, name: str, generation: int) -> None:
        """Converge local state for `name` to a create at `generation`."""
        with self._lock:
            ref = self._indexes.get(name)
            if ref is not None and not ref.being_deleted and ref.generation == generation:
                if self.replication is not None:
                    self.replication.add_consumer(name, generation, ref.index.version)
                return
        self.delete_index_local(name)
        with self._lock:
            ref = self._install_new_lineage(name, generation)
            if self.replication is not None:
                self.replication.add_consumer(name, generation, ref.index.version)

    def delete_index_local(self, name: str) -> None:
        if self.replication is not None:
            self.replication.remove_consumer(name)
        self._drop_index(name)

    def index_names(self) -> List[str]:
        with self._lock:
            return list(self._indexes.keys())

    # ---- bootstrap installs (replicated mode) ----

    def _lineage_dir(self, name: str, generation: int) -> str:
        name_dir = os.path.join(self.dir, name)
        r = index_redirect.read_redirect(name_dir)
        if r is None:
            raise errors.IndexNotFound(name)
        if r.deleted or r.generation != generation:
            raise errors.IndexNotFound(f"{name} generation mismatch")
        return os.path.join(name_dir, r.data_dir())

    def bootstrap_lineage(self, name: str, generation: int, chunks) -> int:
        """Restore a donor snapshot stream into the lineage and swap it in;
        returns the new version (the snapshot watermark).  The IndexRef —
        and thus the data consumer — survives; only the underlying Index is
        swapped (MultiIndex.zig bootstrapLineage)."""
        from . import snapshot as snapshot_wire

        vdir = self._lineage_dir(name, generation)
        restore = os.path.join(vdir, "data.restore")
        shutil.rmtree(restore, ignore_errors=True)
        try:
            with trace("bootstrap.transfer"):
                snapshot_wire.restore_into(restore, chunks, expect_generation=generation)
        except Exception:
            shutil.rmtree(restore, ignore_errors=True)
            raise
        return self._install_bootstrap(name, generation, vdir)

    def bootstrap_lineage_from_source(self, name: str, generation: int, stream) -> int:
        """Build a staging index from the feed's corpus stream, flush it
        fully, and install it through the same swap path a snapshot restore
        uses; returns the position the caller resumes the feed from.

        Staging makes a mid-stream death safe: a dead staging build is just
        a directory the next attempt deletes, while applying into the live
        index and dying at 1%% would leave a node claiming `position` with
        1%% of the data (MultiIndex.zig bootstrapLineageFromSource)."""
        vdir = self._lineage_dir(name, generation)

        # Content decides whether anything installs, never the position:
        # position 0 with a full corpus is the primary migration scenario.
        first = stream.next_batch()
        while first is not None and len(first) == 0:
            first = stream.next_batch()
        if first is None:
            return stream.position  # empty stream: nothing to install

        staging_dir = os.path.join(vdir, "bootstrap.tmp")
        shutil.rmtree(staging_dir, ignore_errors=True)
        from ..engine.index import Index as EngineIndex

        staging = EngineIndex.open(
            staging_dir,
            checkpoint_threshold=self.checkpoint_threshold,
            checkpoint_age=None,
            sync=False,
            searcher=self.searcher,
        )
        try:
            batch = first
            while batch is not None:
                if batch:
                    staging.update(batch, version=stream.position)
                batch = stream.next_batch()
            # Full flush: the swap reopens from disk alone and discards the
            # staging WAL; anything not in a file segment would vanish.
            staging.flush()
        finally:
            staging.close()

        restore = os.path.join(vdir, "data.restore")
        shutil.rmtree(restore, ignore_errors=True)
        os.replace(os.path.join(staging_dir, "data"), restore)
        shutil.rmtree(staging_dir, ignore_errors=True)
        self._install_bootstrap(name, generation, vdir)
        return stream.position

    def _install_bootstrap(self, name: str, generation: int, vdir: str) -> int:
        """Block new borrows, drain outstanding ones, close the live index,
        swap data <- data.restore, drop the stale WAL, reopen."""
        with self._lock:
            ref = self._indexes.get(name)
            if ref is None:
                raise errors.IndexNotFound(name)
            if ref.being_deleted or ref.generation != generation:
                raise errors.IndexNotFound(f"{name} generation mismatch")
            ref.being_deleted = True
            while ref.references > 1:
                self._released.wait()
        try:
            ref.index.close()
            shutil.rmtree(os.path.join(vdir, "data"), ignore_errors=True)
            os.replace(os.path.join(vdir, "data.restore"), os.path.join(vdir, "data"))
            shutil.rmtree(os.path.join(vdir, "oplog"), ignore_errors=True)
            with trace("bootstrap.reopen"):
                ref.index = self._open_lineage(name, generation)
            version = ref.index.version
            with self._lock:
                ref.being_deleted = False
                self._released.notify_all()
            return version
        except Exception:
            # The old Index is closed and unusable; drop the ref so nothing
            # touches it and let the meta consumer rebuild the lineage.
            with self._lock:
                self._indexes.pop(name, None)
                self._released.notify_all()
            metrics.remove_index(name)
            raise

    # ---- info / health / status ----

    def check_index_exists(self, name: str) -> bool:
        with self._lock:
            ref = self._indexes.get(name)
            return ref is not None and not ref.being_deleted

    def index_health(self, name: str) -> str:
        """'ready' | 'loading' | 'missing'. Loading while a bootstrap fills
        the index; global liveness stays independent (see reference notes on
        cold-cluster donor discovery)."""
        with self._lock:
            ref = self._indexes.get(name)
            if ref is None or ref.being_deleted:
                return "missing"
        if self.replication is not None and self.replication.is_bootstrapping(name):
            return "loading"
        return "ready"

    def get_index_info(self, name: str) -> dict:
        ref = self._get_ref(name)
        try:
            snap = ref.index.acquire_reader()
            return {
                "version": snap.version,
                "metadata": snap.metadata(),
                "stats": {
                    "min_doc_id": snap.min_doc_id(),
                    "max_doc_id": snap.max_doc_id(),
                    "num_segments": snap.num_segments(),
                    "num_docs": snap.num_docs(),
                },
            }
        finally:
            self._release_ref(ref)

    def get_peer_status(self, name: str) -> dict:
        ref = self._get_ref(name)
        try:
            return {
                "generation": ref.generation,
                "version": ref.index.version,
                "file_version": ref.index.file_version,
            }
        finally:
            self._release_ref(ref)

    def get_fingerprint_info(self, name: str, fp_id: int) -> dict:
        ref = self._get_ref(name)
        try:
            snap = ref.index.acquire_reader()
            info = snap.get_doc_info(fp_id)
            if info is None or info[1]:
                raise errors.FingerprintNotFound(str(fp_id))
            return {"version": info[0]}
        finally:
            self._release_ref(ref)

    def check_fingerprint_exists(self, name: str, fp_id: int) -> bool:
        ref = self._get_ref(name)
        try:
            snap = ref.index.acquire_reader()
            info = snap.get_doc_info(fp_id)
            return info is not None and not info[1]
        finally:
            self._release_ref(ref)

    def acquire_snapshot(self, name: str):
        """(snapshot, generation, data_dir) for snapshot export / donor
        streaming — taken under one borrow so a concurrent bootstrap swap
        cannot mix an old snapshot with a new lineage's directory."""
        ref = self._get_ref(name)
        try:
            return ref.index.acquire_reader(), ref.generation, ref.index.data_dir
        finally:
            self._release_ref(ref)

    def write_metrics(self) -> str:
        with self._lock:
            for name, ref in self._indexes.items():
                snap = ref.index.acquire_reader()
                metrics.set_docs(name, snap.num_docs())
                metrics.set_version(name, snap.version)
        return metrics.render()
