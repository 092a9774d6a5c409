"""Peer discovery and donor ranking for snapshot bootstrap.

Mirrors upstream fpindex's src/peers.zig: config is a list of base URLs;
hostnames are re-resolved on EVERY lookup so one URL naming a Kubernetes
headless Service covers the whole cluster; peers are probed concurrently
with a per-probe timeout; donors are ranked: same generation, file_version
strictly above our resume point (guarantees progress and excludes ourselves
without any node identity), freshest first.

The port's copy of acoustid_index_tpu/cluster/peers.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import logging
import socket
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence
from urllib.parse import urlparse, urlunparse

log = logging.getLogger("acoustid_index_tpu_torch.peers")

PROBE_TIMEOUT = 5.0


@dataclass(frozen=True)
class Donor:
    base_url: str
    generation: int
    version: int
    file_version: int


def resolve_urls(peer_urls: Sequence[str]) -> List[str]:
    """Expand each base URL into one URL per resolved address."""
    out: List[str] = []
    for url in peer_urls:
        parsed = urlparse(url)
        host = parsed.hostname
        port = parsed.port or (443 if parsed.scheme == "https" else 80)
        if host is None:
            continue
        try:
            infos = socket.getaddrinfo(host, port, proto=socket.IPPROTO_TCP)
        except socket.gaierror:
            log.warning("failed to resolve peer %s", host)
            continue
        seen = set()
        for family, _, _, _, sockaddr in infos:
            addr = sockaddr[0]
            if addr in seen:
                continue
            seen.add(addr)
            netloc = f"[{addr}]:{port}" if ":" in addr else f"{addr}:{port}"
            out.append(urlunparse((parsed.scheme or "http", netloc, "", "", "", "")))
    return out


def probe_one(base_url: str, index_name: str) -> Optional[Donor]:
    import requests

    try:
        r = requests.get(
            f"{base_url.rstrip('/')}/{index_name}/_status",
            timeout=PROBE_TIMEOUT,
            headers={"Accept": "application/json"},
        )
        if r.status_code != 200:
            return None
        d = r.json()
        return Donor(
            base_url=base_url.rstrip("/"),
            generation=d["generation"],
            version=d["version"],
            file_version=d["file_version"],
        )
    except Exception:
        return None


def rank_donors(donors: Sequence[Optional[Donor]], generation: int, after: int) -> List[Donor]:
    """Donors for our lineage whose snapshot would move us forward; a donor
    at exactly `after` is useless (and would match ourselves)."""
    good = [
        d
        for d in donors
        if d is not None and d.generation == generation and d.file_version > after
    ]
    return sorted(good, key=lambda d: -d.file_version)


def find_donors(peer_urls: Sequence[str], index_name: str, generation: int, after: int) -> List[Donor]:
    urls = resolve_urls(peer_urls)
    if not urls:
        return []
    with ThreadPoolExecutor(max_workers=min(16, len(urls))) as pool:
        probed = list(pool.map(lambda u: probe_one(u, index_name), urls))
    return rank_donors(probed, generation, after)
