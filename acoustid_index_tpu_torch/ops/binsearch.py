"""Bounded lower/upper bound over a sorted table (counterpart of
acoustid_index_tpu/ops/binsearch.py).

The reference runs a fixed-step binary search because XLA wants static
loops; here `torch.searchsorted` does the same job.  Every table these
serve is sorted over its WHOLE length -- a sorted live run followed by
0xFFFFFFFF sentinel padding -- so the insertion point inside the window
[start, start+length) is the global insertion point clamped into it.
Values are u32 bit patterns; both sides are widened to int64 first (torch
has no unsigned compare).
"""

from __future__ import annotations

import torch

from .layout import u32


def _bound(data, keys, start, length, *, upper: bool) -> torch.Tensor:
    keys = keys.to(torch.int64)
    pos = torch.searchsorted(u32(data), keys.reshape(-1), right=upper).reshape(keys.shape)
    start = torch.as_tensor(start, dtype=torch.int64, device=pos.device)
    end = start + torch.as_tensor(length, dtype=torch.int64, device=pos.device)
    return torch.minimum(torch.maximum(pos, start), end)


def lower_bound(data, keys, start, length) -> torch.Tensor:
    """First index in [start, start+length) whose value is >= key (int64)."""
    return _bound(data, keys, start, length, upper=False)


def upper_bound(data, keys, start, length) -> torch.Tensor:
    """First index in [start, start+length) whose value is > key (int64)."""
    return _bound(data, keys, start, length, upper=True)
