"""The replication consumers: one meta thread plus one data thread per
index, mirroring upstream fpindex's src/Replicator.zig.

Meta loop: a catch-up phase folds the whole meta history to the final state
per name and reconciles once (dropping stale local indexes the registry no
longer lists); then a streaming phase reconciles per op.  A failing
reconcile is parked and retried on a timer so one poison op cannot wedge
every other index.

Data loop (per lineage): read a batch -> coalesce to ONE commit at
version = max seq -> apply via MultiIndex.apply_log (generation-guarded)
-> mark applied (unblocking read-your-writes waiters).  A below-retention
read triggers ranked-donor snapshot bootstrap: probe peers, vet the donor
watermark against the log, fetch /_snapshot, swap, resume.  An empty
lineage seeds itself before its first read: peer snapshot, else the feed's
corpus stream, else plain replay from 0.  While any bootstrap fills an
index its health reports LOADING and searches answer 503.

Writes route through the coordinator and block until the LOCAL consumer
has applied them (read-your-writes) with an absolute deadline immune to
unrelated broadcasts.

The port's copy of acoustid_index_tpu/cluster/replicator.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..engine import errors
from ..engine.model import Change
from .coordinator import Coordinator, Entry, MetaOp
from . import peers as peers_mod

log = logging.getLogger("acoustid_index_tpu_torch.replicator")

RYW_TIMEOUT = 30.0  # read-your-writes deadline
META_PARK_RETRY = 5.0  # poison-op retry interval
READ_BATCH = 1000
POLL_WINDOW = 1.0  # data/meta read deadline per iteration


class _DeadlineStream:
    """Corpus-stream proxy enforcing the whole-transfer backstop: every
    next_batch() checks the absolute deadline, so a dripping feed cannot
    wedge the consumer forever (the reference's AutoCancel over the entire
    transfer, Replicator.zig:62-69).  The backstop disarms at drain by
    construction — once the end marker is returned, the install phase runs
    with no further checks (disarm-before-install, MultiIndex.zig:644-663)."""

    def __init__(self, inner, deadline: Optional[float], what: str):
        self._inner = inner
        self._deadline = deadline
        self._what = what

    @property
    def position(self) -> int:
        return self._inner.position

    def next_batch(self):
        if self._deadline is not None and time.monotonic() > self._deadline:
            raise errors.ReplicationTimeout(f"{self._what} transfer exceeded its backstop")
        return self._inner.next_batch()

    def close(self) -> None:
        self._inner.close()


@dataclass
class _Consumer:
    name: str
    generation: int
    thread: Optional[threading.Thread] = None
    stop: threading.Event = field(default_factory=threading.Event)
    applied: int = 0
    bootstrapping: bool = False


class Replicator:
    def __init__(
        self,
        mi,
        coordinator: Coordinator,
        peers: Sequence[str] = (),
        bootstrap_timeout: Optional[float] = 1800.0,
        ryw_timeout: float = RYW_TIMEOUT,
    ):
        self.mi = mi
        self.coordinator = coordinator
        self.peers = list(peers)
        self.bootstrap_timeout = bootstrap_timeout
        self.ryw_timeout = ryw_timeout

        self._lock = threading.Lock()
        self._applied_cond = threading.Condition(self._lock)
        self._consumers: Dict[str, _Consumer] = {}
        self._meta_pos = 0
        self._meta_applied = 0
        self._meta_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- lifecycle ----

    def start(self) -> None:
        self._stop.clear()
        self._meta_thread = threading.Thread(target=self._meta_loop, daemon=True, name="repl-meta")
        self._meta_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._meta_thread is not None:
            self._meta_thread.join(timeout=60)
            self._meta_thread = None
        with self._lock:
            consumers = list(self._consumers.values())
        for c in consumers:
            c.stop.set()
        for c in consumers:
            if c.thread is not None:
                c.thread.join(timeout=60)
        with self._lock:
            self._consumers.clear()

    # ---- API used by MultiIndex ----

    def update(self, name: str, changes: Sequence[Change], expected_version: Optional[int]) -> int:
        with self._lock:
            consumer = self._consumers.get(name)
            if consumer is None:
                raise errors.IndexNotFound(name)
            generation = consumer.generation
        seq = self.coordinator.append(name, generation, changes, expected_version)
        self.wait_applied(name, generation, seq)
        return seq

    def wait_applied(self, name: str, generation: int, seq: int) -> None:
        deadline = time.monotonic() + self.ryw_timeout
        with self._applied_cond:
            while True:
                consumer = self._consumers.get(name)
                if consumer is None or consumer.generation != generation:
                    raise errors.IndexNotFound(name)
                if consumer.applied >= seq:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise errors.ReplicationTimeout(f"{name}@{seq} not applied in {self.ryw_timeout}s")
                self._applied_cond.wait(timeout=min(remaining, 1.0))

    def wait_meta_applied(self, pos: int) -> None:
        deadline = time.monotonic() + self.ryw_timeout
        with self._applied_cond:
            while self._meta_applied < pos:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise errors.ReplicationTimeout(f"meta pos {pos} not applied")
                self._applied_cond.wait(timeout=min(remaining, 1.0))

    def is_bootstrapping(self, name: str) -> bool:
        with self._lock:
            c = self._consumers.get(name)
            return c is not None and c.bootstrapping

    def add_consumer(self, name: str, generation: int, start_version: int) -> None:
        """Idempotently ensure the lineage's data consumer runs."""
        with self._lock:
            existing = self._consumers.get(name)
            if existing is not None and existing.generation == generation and existing.thread is not None and existing.thread.is_alive():
                return
            consumer = _Consumer(name=name, generation=generation, applied=start_version)
            consumer.thread = threading.Thread(
                target=self._consume_loop,
                args=(consumer, start_version),
                daemon=True,
                name=f"repl-data:{name}",
            )
            self._consumers[name] = consumer
            consumer.thread.start()

    def remove_consumer(self, name: str) -> None:
        with self._lock:
            consumer = self._consumers.pop(name, None)
        if consumer is not None:
            consumer.stop.set()
            if consumer.thread is not None and consumer.thread is not threading.current_thread():
                consumer.thread.join(timeout=60)

    # ---- meta consumer ----

    def _meta_loop(self) -> None:
        parked: Dict[str, Tuple[MetaOp, float]] = {}
        try:
            parked = self._meta_catch_up()
        except Exception:
            log.exception("meta catch-up failed")
        while not self._stop.is_set():
            # Retry parked (poison) ops on their timer.
            now = time.monotonic()
            for name, (op, when) in list(parked.items()):
                if now >= when:
                    if self._reconcile(op):
                        del parked[name]
                    else:
                        parked[name] = (op, now + META_PARK_RETRY)
            try:
                ops = self.coordinator.read_meta(self._meta_pos, READ_BATCH, time.monotonic() + POLL_WINDOW)
            except Exception:
                log.exception("meta read failed")
                self._stop.wait(1.0)
                continue
            for op in ops:
                if self._stop.is_set():
                    return
                if self._reconcile(op):
                    parked.pop(op.index_name, None)
                else:
                    parked[op.index_name] = (op, time.monotonic() + META_PARK_RETRY)
                self._meta_pos = op.pos
                with self._applied_cond:
                    self._meta_applied = op.pos
                    self._applied_cond.notify_all()

    def _meta_catch_up(self) -> Dict[str, Tuple[MetaOp, float]]:
        """Fold history to the final state per name, reconcile once, and drop
        local indexes the registry no longer lists.  Failed reconciles are
        returned parked, so the streaming loop retries them (a transient
        failure at startup must not leave an index missing forever)."""
        final: Dict[str, MetaOp] = {}
        pos = 0
        while not self._stop.is_set():
            ops = self.coordinator.read_meta(pos, READ_BATCH, time.monotonic())
            if not ops:
                break
            for op in ops:
                final[op.index_name] = op
                pos = op.pos
        self._meta_pos = pos
        active = {n for n, op in final.items() if op.kind == "create"}
        parked: Dict[str, Tuple[MetaOp, float]] = {}
        for name in self.mi.index_names():
            if name not in active:
                try:
                    self.mi.delete_index_local(name)
                except Exception:
                    log.exception("failed to drop stale index %r", name)
        for name, op in final.items():
            if op.kind == "create" and not self._reconcile(op):
                parked[name] = (op, time.monotonic() + META_PARK_RETRY)
        with self._applied_cond:
            self._meta_applied = pos
            self._applied_cond.notify_all()
        return parked

    def _reconcile(self, op: MetaOp) -> bool:
        try:
            if op.kind == "create":
                self.mi.reconcile_create(op.index_name, op.pos)
            else:
                self.mi.delete_index_local(op.index_name)
            return True
        except Exception:
            log.exception("reconcile %s %r failed; parking", op.kind, op.index_name)
            return False

    # ---- data consumer ----

    def _set_bootstrapping(self, consumer: _Consumer, value: bool) -> None:
        with self._lock:
            consumer.bootstrapping = value

    def _consume_loop(self, consumer: _Consumer, start_version: int) -> None:
        name, generation = consumer.name, consumer.generation
        version = start_version
        try:
            if version == 0:
                version = self._seed_empty_lineage(consumer)
            while not consumer.stop.is_set() and not self._stop.is_set():
                try:
                    entries = self.coordinator.read(
                        name, generation, version, READ_BATCH, time.monotonic() + POLL_WINDOW
                    )
                except errors.BelowRetention:
                    version = self._bootstrap_from_peers(consumer, version)
                    continue
                except errors.IndexError_:
                    log.exception("read failed for %r", name)
                    consumer.stop.wait(1.0)
                    continue
                if not entries:
                    continue
                # Coalesce the batch into one commit at the max position.
                changes: List[Change] = [e.change for e in entries]
                target = entries[-1].id
                while not consumer.stop.is_set():
                    try:
                        self.mi.apply_log(name, generation, changes, target)
                        break
                    except errors.IndexNotFound:
                        return  # lineage rebuilt/deleted under us
                    except Exception:
                        log.exception("apply failed for %r@%d; retrying", name, target)
                        consumer.stop.wait(1.0)
                version = target
                with self._applied_cond:
                    consumer.applied = target
                    self._applied_cond.notify_all()
        except Exception:
            log.exception("data consumer for %r died", name)

    def _seed_empty_lineage(self, consumer: _Consumer) -> int:
        """Seeding ladder for an empty lineage: peer snapshot, else the
        feed's corpus stream, else plain replay from 0."""
        name, generation = consumer.name, consumer.generation
        self._set_bootstrapping(consumer, True)
        try:
            donors = peers_mod.find_donors(self.peers, name, generation, 0) if self.peers else []
            for donor in donors:
                v = self._fetch_snapshot(consumer, donor)
                if v is not None:
                    return v
            # The corpus stream, when the feed offers one.  A TRANSIENT
            # failure here must retry, never degrade to replay-from-0: a
            # feed that offers a bootstrap declares its history incomplete,
            # and replaying would install an honest-looking but permanently
            # incomplete index (the exact failure the staging design
            # exists to prevent).
            while not consumer.stop.is_set() and not self._stop.is_set():
                try:
                    stream = self.coordinator.open_bootstrap(name, generation)
                except Exception:
                    log.exception("open_bootstrap failed for %r; retrying", name)
                    consumer.stop.wait(2.0)
                    continue
                if stream is None:
                    return 0  # feed declares complete history; replay IS the bootstrap
                try:
                    version = self.mi.bootstrap_lineage_from_source(
                        name,
                        generation,
                        _DeadlineStream(stream, self._transfer_deadline(), "corpus"),
                    )
                    with self._applied_cond:
                        consumer.applied = max(consumer.applied, version)
                        self._applied_cond.notify_all()
                    return version
                except Exception:
                    log.exception("corpus-stream bootstrap failed for %r; retrying", name)
                    consumer.stop.wait(2.0)
                finally:
                    stream.close()
            return 0
        finally:
            self._set_bootstrapping(consumer, False)

    def _bootstrap_from_peers(self, consumer: _Consumer, after: int) -> int:
        """Below-retention recovery: ranked donors, watermark vetting,
        snapshot fetch + install.  Keeps retrying (the feed is unusable
        below the floor without a donor)."""
        name, generation = consumer.name, consumer.generation
        self._set_bootstrapping(consumer, True)
        try:
            while not consumer.stop.is_set() and not self._stop.is_set():
                donors = peers_mod.find_donors(self.peers, name, generation, after)
                for donor in donors:
                    if not self._can_resume_from(name, generation, donor.file_version):
                        continue
                    v = self._fetch_snapshot(consumer, donor)
                    if v is not None:
                        return v
                log.warning("no usable donor for %r after %d; retrying", name, after)
                consumer.stop.wait(2.0)
            return after
        finally:
            self._set_bootstrapping(consumer, False)

    def _can_resume_from(self, name: str, generation: int, watermark: int) -> bool:
        """A donor is only usable if the feed can serve reads above its
        watermark (probe read vs the retention floor)."""
        try:
            self.coordinator.read(name, generation, watermark, 1, time.monotonic())
            return True
        except errors.BelowRetention:
            return False
        except errors.IndexError_:
            return False

    def _transfer_deadline(self) -> Optional[float]:
        return (time.monotonic() + self.bootstrap_timeout) if self.bootstrap_timeout else None

    def _deadline_chunks(self, r, deadline: Optional[float], what: str):
        """Whole-transfer backstop over an HTTP byte stream: the reference
        arms one AutoCancel over the ENTIRE snapshot transfer and disarms it
        once the stream drains (Replicator.zig:62-69, 351-363).  A requests
        socket timeout is per-socket-op — a donor dripping one byte per few
        seconds would never trip it — and iter_content(N) blocks until N
        bytes accumulate (the deadline check would never run against a slow
        dripper), so this reads via read1(): it returns as soon as ANY data
        arrives, giving the absolute check data-arrival granularity.  EOF
        (= drain) is the disarm point; the install that follows runs
        unclocked.  A truncated stream is caught by the snapshot format's
        own framing/CRC during restore."""
        raw = getattr(r, "raw", None)
        if raw is None or not hasattr(raw, "read1"):
            for chunk in r.iter_content(chunk_size=65536):
                if deadline is not None and time.monotonic() > deadline:
                    raise errors.ReplicationTimeout(f"{what} transfer exceeded its backstop")
                yield chunk
            return
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise errors.ReplicationTimeout(f"{what} transfer exceeded its backstop")
            chunk = raw.read1(65536)
            if not chunk:
                return
            yield chunk

    def _fetch_snapshot(self, consumer: _Consumer, donor) -> Optional[int]:
        import requests

        name, generation = consumer.name, consumer.generation
        deadline = self._transfer_deadline()
        try:
            r = requests.get(
                f"{donor.base_url}/{name}/_snapshot",
                stream=True,
                # Per-socket-op bound (connect / fully-stalled read); the
                # whole-transfer bound is _deadline_chunks.
                timeout=min(30.0, self.bootstrap_timeout) if self.bootstrap_timeout else None,
            )
            if r.status_code != 200:
                r.close()
                return None
            try:
                version = self.mi.bootstrap_lineage(
                    name,
                    generation,
                    self._deadline_chunks(r, deadline, "snapshot"),
                )
            finally:
                r.close()
            with self._applied_cond:
                consumer.applied = max(consumer.applied, version)
                self._applied_cond.notify_all()
            log.info("bootstrapped %r from %s at version %d", name, donor.base_url, version)
            return version
        except Exception:
            log.exception("snapshot fetch from %s failed", donor.base_url)
            return None
