"""Tiered merge policy, adjacent-only.

Derived from Lucene's TieredMergePolicy (Apache-2.0, LUCENE-854), like the
reference (upstream fpindex's src/segment_merge_policy.zig) — restricted to
merging ADJACENT segments so the commit-id ordering that supersession and
SegmentInfo.merge rely on is preserved.

Two pieces:
  * `allowed_segments` — a geometric budget: how many segments an index of
    this total size is allowed before merging should run;
  * `find_merge` — the best adjacent window to merge, scoring candidates by
    skew (how lopsided the merge is; lopsided merges cascade into O(N^2)
    total merge cost) gently biased toward smaller merges.

The port's copy of acoustid_index_tpu/engine/merge_policy.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MergeCandidate:
    start: int  # inclusive index into the segment list
    end: int  # exclusive
    size: int


@dataclass(frozen=True)
class TieredMergePolicy:
    max_segments: Optional[int] = None  # hard cap (used for the memory tier)
    min_segment_size: int = 100
    max_segment_size: int = 1_000_000_000
    segments_per_merge: int = 10
    segments_per_level: int = 10

    def allowed_segments(self, sizes: Sequence[int]) -> int:
        total = 0
        oversized = 0
        for size in sizes:
            if size > self.max_segment_size:
                oversized += 1
            else:
                total += size
        if self.max_segments is not None:
            return self.max_segments + oversized

        merge_factor = max(2, min(self.segments_per_merge, self.segments_per_level))
        allowed_x100 = 0
        level_size = self.min_segment_size
        remaining = total
        while True:
            on_level_x100 = remaining * 100 // level_size
            if on_level_x100 < self.segments_per_level * 100 or level_size >= self.max_segment_size:
                allowed_x100 += on_level_x100
                break
            allowed_x100 += self.segments_per_level * 100
            remaining -= self.segments_per_level * level_size
            level_size = min(self.max_segment_size, level_size * merge_factor)
        return (allowed_x100 + 50) // 100 + oversized

    def find_merge(self, sizes: Sequence[int]) -> Optional[MergeCandidate]:
        best: Optional[MergeCandidate] = None
        best_score = 0.0
        max_merge_size = self.max_segment_size * 2

        for start in range(len(sizes) - 1):
            start_size = sizes[start]
            if start_size > self.max_segment_size:
                continue  # oversized; cannot merge further

            size = 0
            end = start
            while end < len(sizes):
                seg_size = sizes[end]
                if seg_size > self.max_segment_size:
                    break  # cannot include an oversized segment
                size += seg_size
                end += 1
                if end - start > self.segments_per_merge or size > max_merge_size:
                    break
                if size > self.max_segment_size:
                    # Oversized result will not cascade; pretend perfect skew.
                    skew = 1.0 / self.segments_per_merge
                else:
                    skew = start_size / size if size else 1.0
                score = skew * (size ** 0.05 if size else 1.0)
                if best is None or score < best_score:
                    best = MergeCandidate(start=start, end=end, size=size)
                    best_score = score
                if size > self.max_segment_size:
                    break
            # Later windows must not produce a merge bigger than this prefix
            # allows (keeps merges balanced front-to-back).
            max_merge_size = start_size

        return best

    def should_merge(self, sizes: Sequence[int]) -> Optional[MergeCandidate]:
        """The maintenance-loop entry: a candidate of >= 2 segments, only when
        over budget."""
        if len(sizes) <= self.allowed_segments(sizes):
            return None
        cand = self.find_merge(sizes)
        if cand is None or cand.end - cand.start < 2:
            return None
        return cand
