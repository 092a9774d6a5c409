"""Interleaved postings block layout (counterpart of acoustid_index_tpu/ops/layout.py).

Large tiers interleave hashes and docids at block granularity:

    inter[2*cap]:  per 1024-posting block b,
        entries [b*2048,      b*2048+1024) = hashes  of block b
        entries [b*2048+1024, b*2048+2048) = docids of block b

so one block read carries both the compare keys and the payload (the K2
emit kernel, csrc/block_lookup.cu, copies docid rows from the same block it
counts in).  Tables are int32 tensors holding u32 bit patterns; flat
indices are int64 because 2*cap crosses 2^31 at ~1B postings.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# The reference's ops/layout.py is not imported: its package __init__
# imports jax.  BLOCK, use_interleaved and interleave_np are copied as they
# are; tests/test_torch_block_lookup.py holds them equal to the originals.
BLOCK = 1024  # postings per block
_BLOCK_SHIFT = BLOCK.bit_length() - 1


def use_interleaved(cap: int, resident_max_bytes: int) -> bool:
    """True when a tier of postings capacity `cap` packs interleaved: the
    tiers the blocked range path serves (the reference's rule)."""
    return cap >= 64 * BLOCK and cap * 4 > resident_max_bytes


def interleave_np(hashes: np.ndarray, docids: np.ndarray) -> np.ndarray:
    """Host-side pack: (cap,) + (cap,) -> (2*cap,) interleaved blocks."""
    cap = hashes.shape[0]
    assert cap % BLOCK == 0, cap
    out = np.empty(2 * cap, dtype=np.uint32)
    v = out.reshape(-1, 2, BLOCK)
    v[:, 0, :] = hashes.reshape(-1, BLOCK)
    v[:, 1, :] = docids.reshape(-1, BLOCK)
    return out


def resident_max_bytes() -> int:
    # The reference's layout threshold (it sized VMEM residency on a TPU
    # core), not a property of the card: kept so both packages choose the
    # same layout for the same tier, and one AITPU_RESIDENT_MAX_BYTES
    # override forces the interleaved layout in both.
    return int(os.environ.get("AITPU_RESIDENT_MAX_BYTES", str(6 << 20)))


def u32(x: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns (any integer storage) -> exact int64 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def to_storage(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 storage of the same bit pattern:
    one cast, which keeps the low 32 bits (two's complement)."""
    return x.to(torch.int32)


def postings_cap(tier) -> int:
    """Static postings capacity of a packed tier, either layout."""
    if "inter" in tier:
        return tier["inter"].shape[0] // 2
    return tier["hashes"].shape[0]


def _inter_pos(idx: torch.Tensor, payload: bool) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return ((idx >> _BLOCK_SHIFT) << (_BLOCK_SHIFT + 1)) + (BLOCK if payload else 0) + (idx & (BLOCK - 1))


def hash_gather(tier, idx: torch.Tensor) -> torch.Tensor:
    """Tier hash (as int64) at posting index `idx` (caller clips idx)."""
    if "inter" in tier:
        return u32(tier["inter"][_inter_pos(idx, payload=False)])
    return u32(tier["hashes"][idx])


def docid_gather(tier, idx: torch.Tensor) -> torch.Tensor:
    """Tier docid (as int64) at posting index `idx` (caller clips idx)."""
    if "inter" in tier:
        return u32(tier["inter"][_inter_pos(idx, payload=True)])
    return u32(tier["docids"][idx])
