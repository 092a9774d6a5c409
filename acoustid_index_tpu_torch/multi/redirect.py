"""Lineage redirect: data/<name>/current records the active generation and
whether the name is deleted; index data lives in v<generation>/ underneath.
Generation always increases across delete/recreate so lineages never mix —
the durable reconcile key against the meta feed
(cf. upstream fpindex's src/index_redirect.zig).

The port's copy of acoustid_index_tpu/multi/redirect.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import msgpack

REDIRECT_FILE = "current"


@dataclass(frozen=True)
class IndexRedirect:
    name: str
    generation: int
    deleted: bool = False

    def data_dir(self) -> str:
        return f"v{self.generation:06d}"

    def next_generation(self) -> "IndexRedirect":
        return IndexRedirect(name=self.name, generation=self.generation + 1, deleted=False)


def read_redirect(name_dir: str):
    path = os.path.join(name_dir, REDIRECT_FILE)
    try:
        with open(path, "rb") as f:
            d = msgpack.unpackb(f.read(), strict_map_key=False)
    except FileNotFoundError:
        return None
    return IndexRedirect(name=d["n"], generation=d["g"], deleted=d.get("d", False))


def write_redirect(name_dir: str, redirect: IndexRedirect) -> None:
    path = os.path.join(name_dir, REDIRECT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(
            msgpack.packb(
                {"n": redirect.name, "g": redirect.generation, "d": redirect.deleted},
                use_bin_type=True,
            )
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
