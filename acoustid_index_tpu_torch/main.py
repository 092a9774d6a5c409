"""Process entry point: standalone index node, replica node, or coordinator.

CLI flags mirror the reference's table (upstream fpindex's src/main.zig:40-65,
README "Configuration"); unknown flags warn and continue.

The port's copy of acoustid_index_tpu/main.py; its imports are the port's
own modules.  It differs in the flags whose subsystems are not ported yet
(--profile-port: torch has no counterpart of jax.profiler's live server;
--mesh-shards), which exit with an error instead of starting them, and in
build_server()/stop_server(), split out of run_server() so that an
in-process caller (chip_smoke.py) serves through the same entry as the CLI.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="acoustid-index-tpu-torch", add_help=True)
    p.add_argument("--dir", default="data", help="Data directory")
    p.add_argument("--host", default="127.0.0.1", help="Listen address")
    p.add_argument("--port", type=int, default=8080, help="Listen port")
    p.add_argument("--checkpoint-threshold", type=int, default=100_000)
    p.add_argument("--checkpoint-age-ms", type=int, default=60_000, help="0 disables")
    p.add_argument("--legacy-port", type=int, default=0, help="0 = off")
    p.add_argument(
        "--search-port",
        type=int,
        default=0,
        help="Native C++ search-plane port (search-only fast path; 0 = off, -1 = auto-pick)",
    )
    p.add_argument("--load-concurrency", type=int, default=0, help="0 = unlimited")
    p.add_argument("--coordinator", action="store_true", help="Run as changelog coordinator")
    p.add_argument(
        "--coordinator-dir",
        default=None,
        help="Coordinator mode: persist the changelog here (default: memory only)",
    )
    p.add_argument("--coordinator-url", default=None, help="Replica mode: consume this changelog")
    p.add_argument("--peers", default=None, help="Comma-separated peer base URLs (snapshot donors)")
    p.add_argument("--bootstrap-timeout-ms", type=int, default=1_800_000, help="0 disables")
    p.add_argument("--profile-port", type=int, default=0, help="XLA profiler gRPC port (0 = off)")
    p.add_argument(
        "--mesh-shards",
        type=int,
        default=0,
        help="Serve search hash-range-sharded over an N-device mesh (0 = single device)",
    )
    return p


# Flags whose subsystems import jax in the reference and are not ported yet.
NOT_PORTED = ("profile_port", "mesh_shards")


def build_server(args):
    """Open the indexes under args.dir and bind the HTTP front to them,
    not serving yet.  With args.search_port, the native search plane
    (server/native_front.py) starts serving search on that port at once
    (-1 binds port 0; its port is then front.port); with args.legacy_port,
    so does the legacy line protocol (server/legacy.py; read-only on a
    replica).  Returns (server, mi, replicator, front, legacy), front and
    legacy None without their ports; serve HTTP with
    server.serve_background() and end with stop_server().  run_server()
    is the CLI's loop around it; in-process callers call it directly."""
    from .multi.multi_index import MultiIndex
    from .server.app import App
    from .server.http import HttpServer

    mi = MultiIndex.open(
        args.dir,
        checkpoint_threshold=args.checkpoint_threshold,
        checkpoint_age=(args.checkpoint_age_ms / 1000.0) if args.checkpoint_age_ms else None,
        sync=args.coordinator_url is None,  # upstream owns durability in cluster mode
        load_concurrency=args.load_concurrency or None,
    )

    replicator = None
    if args.coordinator_url:
        from .cluster.remote_coordinator import RemoteCoordinator
        from .cluster.replicator import Replicator

        peers = [u.strip() for u in (args.peers or "").split(",") if u.strip()]
        coordinator = RemoteCoordinator(args.coordinator_url)
        replicator = Replicator(
            mi,
            coordinator,
            peers=peers,
            bootstrap_timeout=(args.bootstrap_timeout_ms / 1000.0) if args.bootstrap_timeout_ms else None,
        )
        mi.replication = replicator
        replicator.start()

    app = App(mi)
    server = HttpServer(args.host, args.port, app.router, app.error_response, app.not_found)

    legacy = None
    if args.legacy_port:
        from .server.legacy import LegacyServer

        legacy = LegacyServer(args.host, args.legacy_port, mi, read_only=replicator is not None)
        legacy.serve_background()

    front = None
    if args.search_port:
        from .server.native_front import NativeFront

        front = NativeFront(mi, max(args.search_port, 0))  # -1 = bind port 0
        front.start()
        logging.info("native search plane on 127.0.0.1:%d", front.port)
    return server, mi, replicator, front, legacy


def stop_server(server, mi, replicator, front=None, legacy=None) -> None:
    """Stop a server that build_server() made and serve_background() ran."""
    server.shutdown()
    server.server_close()
    if front is not None:
        front.stop()
    if legacy is not None:
        legacy.shutdown()
        legacy.server_close()
    if replicator is not None:
        replicator.stop()
    mi.close()
    if hasattr(mi.searcher, "close"):
        mi.searcher.close()  # join the dispatch/collect threads


def run_server(args) -> None:
    server, mi, replicator, front, legacy = build_server(args)
    logging.info("serving on %s:%d (dir=%s)", args.host, server.port, args.dir)
    print(f"LISTENING {server.port}", flush=True)
    if front is not None:
        print(f"SEARCHPLANE {front.port}", flush=True)  # port-0 binds resolve here

    # One search per open index in the background, so the first real query
    # doesn't pay the kernels' one-time build.
    def warm():
        from .multi.multi_index import SearchRequestParams

        # Let the listener answer its first health probes first.
        threading.Event().wait(2.0)
        for name in mi.index_names():
            try:
                mi.search(name, SearchRequestParams(query=[1, 2, 3], timeout=0))
            except Exception:
                logging.debug("warmup search failed for %r", name, exc_info=True)

    threading.Thread(target=warm, daemon=True, name="warmup").start()

    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    server.serve_background()
    stop.wait()
    logging.info("shutting down")
    stop_server(server, mi, replicator, front, legacy)
    # All durability work is behind us (WAL synced, manifests written).
    # Skip interpreter finalization, which could tear the interpreter down
    # under a daemon thread still inside native code.
    logging.shutdown()
    os._exit(0)


def run_coordinator(args) -> None:
    from .cluster.coordinator import MemoryCoordinator
    from .cluster.coordinator_server import CoordinatorApp
    from .server.http import HttpServer

    if args.coordinator_dir:
        from .cluster.file_coordinator import FileCoordinator

        coordinator = FileCoordinator(args.coordinator_dir)
        logging.info("durable changelog in %s", args.coordinator_dir)
    else:
        coordinator = MemoryCoordinator()
    app = CoordinatorApp(coordinator)
    server = HttpServer(args.host, args.port, app.router, app.error_response, app.not_found)
    logging.info("coordinator on %s:%d", args.host, server.port)
    print(f"LISTENING {server.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    server.serve_background()
    stop.wait()
    server.shutdown()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    for flag in unknown:
        logging.warning("ignoring unknown flag: %s", flag)
    for name in NOT_PORTED:
        if getattr(args, name):
            parser.error(f"--{name.replace('_', '-')} is not yet ported to acoustid_index_tpu_torch")
    if args.coordinator:
        run_coordinator(args)
    else:
        run_server(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
