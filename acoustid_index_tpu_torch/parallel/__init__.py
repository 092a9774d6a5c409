"""Hash-range sharded search and ingest over a mesh of shards on the
process's cards, with exact cross-shard score combination (counterpart of
acoustid_index_tpu/parallel/)."""

from .sharded import (
    ShardedView,
    build_sharded_view,
    make_mesh,
    sharded_search,
    sharded_ingest_step,
)

__all__ = [
    "ShardedView",
    "build_sharded_view",
    "make_mesh",
    "sharded_search",
    "sharded_ingest_step",
]
