"""Delta-varint decode of segment-file columns on the device
(csrc/varint_decode.cu), and its plain PyTorch version.

The "dv1" columns of a segment file (csrc/aitpu_native.cc) are LEB128
varints: postings as (delta, dv) pairs, mentioned docs as plain deltas.
The host decoder reads them one byte at a time; here they decode chunk by
chunk in parallel, in the kernels' steps:

  * `scan(data, nvals)`: count the terminators (bytes < 0x80) of every
    CHUNK bytes, refuse the stream where the host decoder refuses it (not
    exactly `nvals` varints, a trailing partial varint, a varint of six or
    more bytes), and return each chunk's first varint index (an exclusive
    scan of the counts, int64);
  * `decode(...)`: write each varint's value at its index, then run the
    two scans in tiles of TILE values with a carry into each tile: hashes
    are the inclusive u32 sum of the deltas, docids a segmented sum of dv
    that restarts where delta != 0 or at the first pair (the host's rule,
    aitpu_native.cc `aitpu_decode_postings`).  Values land at slot(i) =
    (i // 1024) * bstride + i % 1024, so one call writes the interleaved
    tier of ops/layout.py (bstride 2048, docids at hashes + 1024) or plain
    columns (bstride 1024), with SENTINEL padding up to `cap` and each
    block's first hash in the top index.

For tensors on the CPU the same steps run as plain PyTorch (the `_plain`
functions, with the chunk and tile sizes as arguments, so the tests cross
chunk and tile boundaries at small sizes); for tensors on a card the
wrappers launch the kernels or raise.  Tables are int32 tensors holding u32
bit patterns, as everywhere in the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import bump, counters
from .layout import BLOCK

CHUNK = 4096  # bytes per chunk of scan and decode (the kernels' CTA: 256 threads x 16 bytes)
TILE = BLOCK  # values per tile of the scans (the kernels' CTA: one tier block)
SENTINEL = 0xFFFFFFFF
_M32 = 0xFFFFFFFF

# Kernel launches, in the registry as `launches.varint.<kernel>`: one key
# for each of csrc/varint_decode.cu's five kernels.
LAUNCHES = counters("launches.varint", {"count": 0, "decode": 0, "sums": 0, "carries": 0, "apply": 0})


def _launched(rc: int, entry: str, *kernels: str) -> None:
    for k in kernels:
        bump(LAUNCHES, k)
    if rc != 0:
        raise RuntimeError(f"varint {entry} launch failed: cudaError {rc}")


def _lib():
    from . import _build

    return _build.library("varint")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_data(data: torch.Tensor) -> None:
    if data.dim() != 1 or data.dtype != torch.uint8 or not data.is_contiguous():
        raise ValueError("varint data must be a contiguous 1-D uint8 tensor")
    if data.is_cuda and data.data_ptr() % 16:
        raise ValueError("varint data on a card must start 16-byte aligned (the kernels load 16 bytes a thread)")


# ---- scan: count, validate, chunk starts ----


def _counts_plain(data: torch.Tensor, chunk: int):
    """(terminators per chunk as int64, True where a terminator follows five
    continuation bytes)."""
    nbytes = data.shape[0]
    term = data < 0x80
    nchunks = -(-nbytes // chunk)
    padded = torch.zeros(nchunks * chunk, dtype=torch.int64)
    padded[:nbytes] = term.to(torch.int64)
    counts = padded.view(nchunks, chunk).sum(1)
    cont = torch.cat([torch.zeros(5, dtype=torch.bool), ~term])  # five terminators before the start
    run = cont[:-5].clone()
    for k in range(1, 5):
        run &= cont[k : k - 5]
    return counts, bool((term & run).any())


def scan(data: torch.Tensor, nvals: int, chunk: int = CHUNK) -> torch.Tensor:
    """Exclusive varint index at each chunk's start (int64, on data's
    device), after checking that `data` holds exactly `nvals` varints of at
    most five bytes each and ends on a terminator; raises ValueError where
    the host decoder returns -1.  One host sync on a card."""
    _check_data(data)
    nbytes = int(data.shape[0])
    if nbytes == 0:
        if nvals:
            raise ValueError("corrupt dv1 stream: no bytes")
        return torch.zeros(0, dtype=torch.int64, device=data.device)
    if data.is_cuda:
        if chunk != CHUNK:
            raise ValueError(f"the kernels' chunk is {CHUNK} bytes")
        counts = torch.empty(-(-nbytes // CHUNK), dtype=torch.int32, device=data.device)
        bad = torch.zeros(1, dtype=torch.int32, device=data.device)
        with torch.cuda.device(data.device):
            rc = _lib().aitpu_varint_count(data.data_ptr(), nbytes, counts.data_ptr(), bad.data_ptr(), _stream(data))
        _launched(rc, "count", "count")
        incl = torch.cumsum(counts, 0, dtype=torch.int64)
        total, run, last = torch.stack([incl[-1], bad[0].to(torch.int64), data[-1].to(torch.int64)]).tolist()
    else:
        counts, run = _counts_plain(data, chunk)
        incl = torch.cumsum(counts, 0)
        total, last = int(incl[-1]), int(data[-1])
    if run:
        raise ValueError("corrupt dv1 stream: a varint longer than five bytes")
    if last >= 0x80:
        raise ValueError("corrupt dv1 stream: a partial varint at its end")
    if total != nvals:
        raise ValueError(f"corrupt dv1 stream: {total} varints, {nvals} expected")
    return incl - counts


# ---- decode: values at their slots, then the scans ----


def _slots(i: torch.Tensor, bstride: int) -> torch.Tensor:
    return (i // BLOCK) * bstride + i % BLOCK


def _values_plain(data: torch.Tensor, starts: torch.Tensor, chunk: int):
    """(global varint index, value) of every varint, as the decode kernel
    computes them: a chunk's first index plus the rank inside the chunk, and
    the value built from the varint's last byte down."""
    b = data.to(torch.int64)
    term = b < 0x80
    pos = torch.nonzero(term).flatten()
    cid = pos // chunk
    rank = torch.cumsum(term.to(torch.int64), 0)[pos] - 1  # rank over the stream
    first = torch.searchsorted(pos, cid * chunk)  # rank of each chunk's first terminator
    g = starts[cid] + (rank - first)
    v = b[pos]
    more = torch.ones_like(pos, dtype=torch.bool)
    for t in range(1, 5):
        prev = torch.where(pos >= t, b[(pos - t).clamp(min=0)], 0)
        more &= prev >= 0x80
        v = torch.where(more, ((v << 7) & _M32) | (prev & 0x7F), v)
    return g, v


def _scans_plain(delta: torch.Tensor, dv: Optional[torch.Tensor], tile: int):
    """Inclusive u32 sums of `delta`, and the segmented sums of `dv` that
    restart where delta != 0 or at 0, computed as the kernels do: per tile,
    a scan of the tiles' aggregates into carries, then each tile from its
    carry.  int64 values in [0, 2^32)."""
    n = delta.shape[0]
    if n == 0:
        return delta, dv
    ntiles = -(-n // tile)

    def tiled(x):
        out = torch.zeros(ntiles * tile, dtype=torch.int64)
        out[:n] = x
        return out.view(ntiles, tile)

    within_h = torch.cumsum(tiled(delta), 1)
    tile_h = within_h[:, -1]
    carry_h = torch.cumsum(tile_h, 0) - tile_h
    hashes = ((within_h + carry_h[:, None]) & _M32).flatten()[:n]
    if dv is None:
        return hashes, None

    restart = tiled(delta) != 0
    restart.view(-1)[0] = True
    d = tiled(dv)
    # Inside a tile: the sum of dv since its last restart (or since its start).
    csum = torch.cumsum(d, 1)
    j = torch.arange(tile).expand(ntiles, tile)
    last = torch.cummax(torch.where(restart, j, -1), 1).values
    before = torch.gather(csum - d, 1, last.clamp(min=0))
    within_d = torch.where(last >= 0, csum - before, csum)
    # Across tiles: each tile's carry is the value at the previous tile's end.
    tile_f, tile_v = restart.any(1), within_d[:, -1]
    t = torch.arange(ntiles)
    tcum = torch.cumsum(tile_v, 0)
    tlast = torch.cummax(torch.where(tile_f, t, -1), 0).values
    end = torch.where(tlast >= 0, tcum - (tcum - tile_v)[tlast.clamp(min=0)], tcum)
    carry_d = torch.cat([torch.zeros(1, dtype=torch.int64), end[:-1]])
    docids = torch.where(last >= 0, within_d, within_d + carry_d[:, None])
    return hashes, (docids & _M32).flatten()[:n]


def decode(
    data: torch.Tensor,
    starts: torch.Tensor,
    n: int,
    pairs: bool,
    hashes: torch.Tensor,
    docids: Optional[torch.Tensor],
    bstride: int,
    cap: int,
    block_index: Optional[torch.Tensor] = None,
    chunk: int = CHUNK,
    tile: int = TILE,
) -> None:
    """Decode the stream `data` (scanned by `scan` for n pairs, or n values
    when not `pairs`) into int32 storage: value i at `hashes` (and its docid
    at `docids`) [slot(i)], SENTINEL at the slots of [n, cap), and with
    `block_index` the hash at every multiple of 1024 below cap.  `docids`
    may be a view of the same storage as `hashes` (the interleaved tier).
    No host sync."""
    _check_data(data)
    span = _slots(torch.tensor(cap - 1), bstride).item() + 1 if cap else 0  # past the highest slot written
    for name, t, need in (("hashes", hashes, span), ("docids", docids if pairs else None, span),
                          ("block_index", block_index, -(-cap // BLOCK))):
        if t is not None and (t.dtype != torch.int32 or t.device != data.device or not t.is_contiguous()
                              or t.numel() < need):
            raise ValueError(f"{name} must be a contiguous int32 tensor of at least {need} on {data.device}")
    if starts.dtype != torch.int64 or starts.shape[0] != -(-data.shape[0] // chunk):
        raise ValueError("starts must be scan()'s chunk starts of this stream")
    if data.is_cuda:
        if (chunk, tile) != (CHUNK, TILE):
            raise ValueError(f"the kernels' chunk and tile are {CHUNK} and {TILE}")
        dev = data.device
        hp = hashes.data_ptr()
        dp = docids.data_ptr() if pairs else hp
        bi = block_index.data_ptr() if block_index is not None else None
        scratch = torch.empty(max(6 * (-(-n // TILE)), 1), dtype=torch.int32, device=dev)
        nvals = 2 * n if pairs else n
        with torch.cuda.device(dev):
            lib = _lib()
            rc = lib.aitpu_varint_decode(data.data_ptr(), data.shape[0], starts.data_ptr(), int(pairs), hp, dp,
                                         bstride, nvals, _stream(data))
            _launched(rc, "decode", *(("decode",) if data.shape[0] else ()))
            rc = lib.aitpu_varint_scan(hp, dp, bstride, n, cap, int(pairs), scratch.data_ptr(), bi, _stream(data))
            _launched(rc, "scan", *(("sums", "carries") if n else ()), *(("apply",) if cap else ()))
        return
    g, v = _values_plain(data, starts.cpu(), chunk)
    if pairs:
        delta, dv = v[0::2], v[1::2]
    else:
        delta, dv = v, None
    h, d = _scans_plain(delta, dv, tile)
    i = torch.arange(cap, dtype=torch.int64)
    hv = torch.full((cap,), SENTINEL, dtype=torch.int64)
    hv[:n] = h
    hashes[_slots(i, bstride)] = hv.to(torch.int32)
    if pairs:
        dvals = torch.full((cap,), SENTINEL, dtype=torch.int64)
        dvals[:n] = d
        docids[_slots(i, bstride)] = dvals.to(torch.int32)
    if block_index is not None:
        block_index.copy_(hv[::BLOCK].to(torch.int32))


def decode_columns(data: torch.Tensor, n: int, pairs: bool, chunk: int = CHUNK, tile: int = TILE):
    """Plain columns of the stream: (hashes, docids) int32 of n pairs, or
    (values, None) of n values; raises ValueError where the host decoder
    refuses the stream."""
    starts = scan(data, 2 * n if pairs else n, chunk)
    h = torch.empty(n, dtype=torch.int32, device=data.device)
    d = torch.empty(n, dtype=torch.int32, device=data.device) if pairs else None
    decode(data, starts, n, pairs, h, d, BLOCK, n, chunk=chunk, tile=tile)
    return h, d
