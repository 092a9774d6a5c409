"""The probes' lookups on the card (counterpart of the sixteen `pallas_call`
sites of the reference's TPU measurement scripts under probes/).

The probes timed, on a TPU, ways to run the block lookup: explicit DMA
rings, lookups per grid step, a two-block window, fused docid emission,
SMEM or one-hot outputs, MXU reductions.  Each still computes a function.
This module gives every site a function of the same name and return
contract, a thin layer over one of five kernels:

    K1  block_lookup.block_count       <- make_landing, make_resident,
                                          make_kernel("plain" | "rm", E=0)
    K2  block_lookup.block_count_emit  <- rowemit_call, lookup_dma_emit
    K3  block_count_pair               <- block_lookup_pair, block_lookup_pair_dma,
                                          block_lookup_pair_smem, make_floor
    K4  block_count_emit_docids        <- fused_call, make_kernel (docids, and
                                          the "lm" layout at E = 0)
    K5  block_count_staged             <- lookup_dma, lookup_dma_vec,
                                          lookup_dma_vec2, dma_lookup, lookup_wave_mm

K3-K5 are csrc/probe_lookup.cu (library "probes"), whose source note says
what each replaces, what bounds it and how it is built; K3 and K4 search
each block by its 32-byte sectors (csrc/sector_search.cuh: rounds of
SECTOR_ARITY - 1 pivot loads, then the bound's sector), K4 fetching its
docid sector in the search's last round.  Each writes the
probes' composite lt + (eq << 12) from its own body, as the TPU sites
did; `counts` takes it apart where a caller wants (lt, eq).  Each wrapper
takes its plain PyTorch version for tensors on the CPU, and launches its
kernel or raises for tensors on a card.  The plain versions count over
whole blocks.  K3 and K4 search the block, so on a card every looked-up
block must be non-decreasing as u32 (every probe table is); with
block_lookup.CHECK_SORTED set, their wrappers check that on the CPU.  K5
counts the whole block and takes any.  Launches count in
block_lookup.LAUNCHES.

The probes' knobs stay in the signatures: G (lookups per grid step or per
wave) and NBUF (the depth of the DMA ring).  For K5 they pick the template:
G lookups per wave, NBUF stages of G blocks in shared memory.  A ring
larger than the 227 KB of shared memory a CTA may use raises on every
device and is never shrunk, so lookup_dma_vec2's and lookup_wave_mm's
defaults (16 x 4 and 64 x 4 blocks) raise.  Elsewhere G and NBUF change no
result.  Both counts of the composite stay below 4096 (a window's sums
too), so its fields never carry.
"""

from __future__ import annotations

import torch

from . import block_lookup as bl
from .block_lookup import _PLAIN_CHUNK, BLOCK, ROWS, _check, _cuda_args, _launched
from .layout import u32

PAIR_VARIANTS = ("full", "oneblock", "noreduce", "empty")  # K3: _probe_floor.py's bisection
EMIT_MODES = ("onehot", "slice")  # K4: _probe_fused2.py's docid extractions
EMIT_LAYOUTS = (1024, 128)  # K4: hash/docid interleave granularity R
STAGED_G = (1, 4, 8, 16)  # K5's templates: those of the fitting (G, NBUF) pairs are built
STAGED_NBUF = (2, 3, 4, 8, 16)
SMEM_BYTES = 232_448  # 227 KB: the shared memory one CTA of an H100 may use
SECTOR_ARITY = 2  # K3's and K4's pivots per round + 1: csrc/probe_lookup.cu's ARITY
SECTOR_LAZY = True  # K4 loads its second docid sector only where needed: csrc/probe_lookup.cu's LAZY


def _lib():
    from . import _build

    return _build.library("probes")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def composite(lt, eq):
    """The probes' packed result lt + (eq << 12), int32."""
    return (lt.to(torch.int32) + (eq.to(torch.int32) << 12)).to(torch.int32)


def counts(comp):
    """(lt, eq) int32 of a composite."""
    return comp & 0xFFF, comp >> 12


# ---- K3 block_count_pair: the two-block window ----


def block_count_pair_plain(table, blk0, blk1, q, stride: int = 1, variant: str = "full", g: int = 8):
    """Plain PyTorch version of K3: the composite (int32) of q[j] over block
    blk0[j] and, when blk1[j] > 0, block blk1[j]; `variant` as K3's."""
    L = blk0.shape[0]
    if variant == "empty":
        return (torch.arange(L, device=table.device) % g).to(torch.int32)
    if variant == "noreduce":
        nblk = table.shape[0] // (stride * BLOCK)
        first = u32(table.view(nblk, stride * BLOCK)[blk0.to(torch.int64).clamp(0, nblk - 1), 0])
        return (first < u32(q)).to(torch.int32)
    lt, eq = bl.block_count_plain(table, blk0, q, stride)
    if variant == "full":
        lt1, eq1 = bl.block_count_plain(table, blk1, q, stride)
        on = (blk1 > 0).to(torch.int32)
        lt, eq = lt + on * lt1, eq + on * eq1
    return composite(lt, eq)


def block_count_pair(table, blk0, blk1, q, stride: int = 1, variant: str = "full", g: int = 8):
    """K3: the composite lt + (eq << 12), int32, of q[j] with lt and eq
    summed over block blk0[j] and, when blk1[j] > 0, block blk1[j] of
    `table` (`stride` 2: the hash half of interleaved blocks).  `variant`
    "oneblock" counts blk0 only, "noreduce" gives (blk0's first hash < q),
    "empty" j % g.  On a card every searched block must be non-decreasing
    as u32."""
    _check(table, blk0, q, stride)
    if blk1.shape != blk0.shape or blk1.device != table.device:
        raise ValueError("blk1 must match blk0's shape and device")
    if variant not in PAIR_VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {PAIR_VARIANTS}")
    if g < 1:
        raise ValueError(f"g must be >= 1, not {g}")
    if table.device.type == "cpu":
        if bl.CHECK_SORTED and variant in ("full", "oneblock"):
            bl._check_sorted("block_count_pair", table, blk0, stride)
            if variant == "full":
                bl._check_sorted("block_count_pair", table, blk1[blk1 > 0], stride)
        return block_count_pair_plain(table, blk0, blk1, q, stride, variant, g)
    blk0, q = _cuda_args(table, blk0, q)
    blk1 = blk1.to(torch.int32).contiguous()
    L = blk0.shape[0]
    comp = torch.empty(L, dtype=torch.int32, device=table.device)
    rc = _lib().aitpu_block_count_pair(
        table.data_ptr(), blk0.data_ptr(), blk1.data_ptr(), q.data_ptr(), comp.data_ptr(),
        L, table.shape[0] // (stride * BLOCK), stride, PAIR_VARIANTS.index(variant), g, _stream(table),
    )
    _launched(rc, "block_count_pair")
    return comp


# ---- K4 block_count_emit_docids: K2's search plus E docid scalars ----


def _blocks(inter, R):
    """(nblk, BLOCK // R, 2, R) view of a table of 2048-word blocks whose
    R-word runs alternate hashes and docids."""
    return inter.view(inter.shape[0] // (2 * BLOCK), BLOCK // R, 2, R)


def block_count_emit_docids_plain(inter, blk, q, E: int, R: int = 1024, mode: str = "onehot"):
    """Plain PyTorch version of K4: (comp (L,), d (E, L)) int32."""
    t4 = _blocks(inter, R)
    nblk = t4.shape[0]
    q = u32(q)
    blk = blk.to(torch.int64).clamp(0, nblk - 1)
    es = torch.arange(E, device=inter.device)
    comps, ds = [], []
    for s in range(0, blk.shape[0], _PLAIN_CHUNK):
        tile = t4[blk[s : s + _PLAIN_CHUNK]]
        h = u32(tile[:, :, 0].reshape(-1, BLOCK))
        dd = tile[:, :, 1].reshape(-1, BLOCK)
        qq = q[s : s + _PLAIN_CHUNK, None]
        lt = (h < qq).sum(1)
        comps.append(composite(lt, (h == qq).sum(1)))
        p = lt[:, None] + es
        if mode == "slice":  # docid row min(p >> 7, 7), lane p & 127
            ds.append(dd.gather(1, torch.clamp(p >> 7, max=ROWS - 1) * 128 + (p & 127)).T)
        else:
            ds.append(torch.where(p < BLOCK, dd.gather(1, p.clamp(max=BLOCK - 1)), 0).T)
    if not comps:
        return torch.zeros(0, dtype=torch.int32, device=inter.device), torch.zeros((E, 0), dtype=torch.int32, device=inter.device)
    return torch.cat(comps), torch.cat(ds, dim=1).to(torch.int32)


def block_count_emit_docids(inter, blk, q, E: int, R: int = 1024, mode: str = "onehot"):
    """K4: comp[j] = lt + (eq << 12) of q[j] in block blk[j] of a table of
    2048-word hash/docid blocks (R-word runs alternating: R = 1024 the
    port's interleaved layout, R = 128 the probes' lane-major tile), and
    d[e][j] = the block's docid at lt + e, or 0 where lt + e >= 1024
    ("onehot"); "slice" reads docid row min(p >> 7, 7), lane p & 127 there.
    E in 0..4.  On a card every block's hashes must be non-decreasing as u32."""
    _check(inter, blk, q, 2)
    if not 0 <= E <= 4:
        raise ValueError(f"E must be in 0..4, not {E}")
    if R not in EMIT_LAYOUTS or mode not in EMIT_MODES:
        raise ValueError(f"(R, mode) = ({R}, {mode!r}): R must be one of {EMIT_LAYOUTS}, mode one of {EMIT_MODES}")
    if inter.device.type == "cpu":
        if bl.CHECK_SORTED:
            bl._check_sorted("block_count_emit_docids", inter, blk, 2, R)
        return block_count_emit_docids_plain(inter, blk, q, E, R, mode)
    blk, q = _cuda_args(inter, blk, q)
    L = blk.shape[0]
    comp = torch.empty(L, dtype=torch.int32, device=inter.device)
    d = torch.empty((E, L), dtype=torch.int32, device=inter.device)
    rc = _lib().aitpu_block_count_emit_docids(
        inter.data_ptr(), blk.data_ptr(), q.data_ptr(), comp.data_ptr(), d.data_ptr(),
        L, inter.shape[0] // (2 * BLOCK), E, R, EMIT_MODES.index(mode), _stream(inter),
    )
    _launched(rc, "block_count_emit_docids")
    return comp, d


# ---- K5 block_count_staged: the whole-block count, staged by TMA ----


def staged_fits(G: int, NBUF: int) -> bool:
    """K5's ring (NBUF stages of G 4 KB blocks, and its mbarriers) fits the
    shared memory of one CTA."""
    return G * NBUF * BLOCK * 4 + 16 * NBUF <= SMEM_BYTES


# The rings the probes' sweeps time: every built (G, NBUF) with G > 1 and
# NBUF <= 4 that fits.
STAGED_SWEEP = tuple((G, N) for G in STAGED_G if G > 1 for N in STAGED_NBUF if N <= 4 and staged_fits(G, N))


def _check_staged(G, NBUF):
    if not staged_fits(G, NBUF):
        raise ValueError(
            f"K5: G x NBUF = {G} x {NBUF} blocks of 4 KB ({G * NBUF * 4} KB) do not fit the "
            f"{SMEM_BYTES // 1024} KB of shared memory a CTA may use"
        )
    if G not in STAGED_G or NBUF not in STAGED_NBUF:
        raise ValueError(f"K5 is built for G in {STAGED_G} and NBUF in {STAGED_NBUF}, not ({G}, {NBUF})")


def block_count_staged_plain(table, blk, q):
    """Plain PyTorch version of K5: the composite of K1's count over the
    whole block."""
    return composite(*bl.block_count_plain(table, blk, q, 1))


def block_count_staged(table, blk, q, G: int = 8, NBUF: int = 4):
    """K5: the composite lt + (eq << 12), int32, of q[j] over the whole
    block blk[j] of `table` (stride 1; any block, sorted or not), each
    block staged in shared memory by a TMA bulk copy: G lookups per wave,
    NBUF stages.  Raises if the ring does not fit, on every device."""
    _check(table, blk, q, 1)
    _check_staged(G, NBUF)
    if table.device.type == "cpu":
        return block_count_staged_plain(table, blk, q)
    blk, q = _cuda_args(table, blk, q)
    L = blk.shape[0]
    comp = torch.empty(L, dtype=torch.int32, device=table.device)
    rc = _lib().aitpu_block_count_staged(
        table.data_ptr(), blk.data_ptr(), q.data_ptr(), comp.data_ptr(),
        L, table.shape[0] // BLOCK, G, NBUF, _stream(table),
    )
    _launched(rc, "block_count_staged")
    return comp


# ---- the probes' functions, same names and return contracts ----
#
# Tables come as the probes pass them, flat or as (-1, 128) / (-1, 256)
# views of one flat table; block ids as int32, queries as u32 values
# (int64) or bit patterns (int32).  lo is int64, as block_lookup's.


def pair_lo(blk0, comp):
    """A window's (lo, eq) from its composite: lo = blk0 * BLOCK + lt, int64."""
    lt, eq = counts(comp)
    return blk0.to(torch.int64) * BLOCK + lt, eq


def block_lookup_pair(hashes, blk0, blk1, queries, stride: int = 1):
    """probes/_pairkernel.py:21: (lo, eq) over the window [blk0, blk1]
    (blk1 == 0 disables the second block), by K3."""
    return pair_lo(blk0, block_count_pair(hashes.reshape(-1), blk0, blk1, queries, stride))


def block_lookup_pair_dma(hashes, blk0, flag, queries):
    """probes/_probe_dma.py:20: (lo, eq) over the fixed window [b0, b0 + 1]
    gated by `flag` (0 or 1: the probe multiplies by it); `hashes` carries
    one sentinel block of padding past the last real block.  By K3."""
    blk1 = torch.where(flag > 0, blk0 + 1, torch.zeros_like(blk0))
    return block_lookup_pair(hashes, blk0, blk1, queries)


def block_lookup_pair_smem(hashes, blk0, blk1, queries):
    """probes/_probe_smem.py:18: block_lookup_pair at stride 1 (the probe
    differs only in its TPU output memory), by K3."""
    return block_lookup_pair(hashes, blk0, blk1, queries)


def make_floor(variant: str, G: int = 8):
    """probes/_probe_floor.py:18 make(variant) with the probe's G: the
    composite of K3's `variant` over (hashes, blk0, blk1, queries)."""
    if variant not in PAIR_VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {PAIR_VARIANTS}")

    def lookup(hashes, blk0, blk1, queries):
        return block_count_pair(hashes.reshape(-1), blk0, blk1, queries, 1, variant, G)

    return lookup


def _staged_composite(hashes2d, blk, queries, G, NBUF):
    return block_count_staged(hashes2d.reshape(-1), blk, queries, G, NBUF)


def lookup_dma(hashes2d, blk, queries, nbuf: int = 8):
    """probes/_probe_dma2.py:29: the composite, one block per slot of an
    nbuf-deep ring: K5 with G = 1."""
    return _staged_composite(hashes2d, blk, queries, 1, nbuf)


def lookup_dma_vec(hashes2d, blk, queries, g: int = 8, nbuf: int = 4):
    """probes/_probe_dma2.py:86: the composite, g blocks per wave: K5."""
    return _staged_composite(hashes2d, blk, queries, g, nbuf)


def lookup_dma_vec2(hashes2d, blk, queries, g: int = 16, nbuf: int = 4):
    """probes/_probe_dma2.py:156: as lookup_dma_vec (the probe differs in
    its TPU reduction).  Its default ring, 16 x 4 blocks, does not fit."""
    return _staged_composite(hashes2d, blk, queries, g, nbuf)


def dma_lookup(hashes2d, blk, queries, vmem_out: bool, nbuf: int = 8):
    """probes/_probe_ceiling.py:31: the composite, flat, in either of the
    probe's output modes (SMEM scalars or a (L // 128, 128) VMEM tile,
    which it returns flattened): K5 with G = 1."""
    return _staged_composite(hashes2d, blk, queries, 1, nbuf)


def lookup_wave_mm(hashes2d, blk, queries, g: int = 64, nbuf: int = 4):
    """probes/_probe_wavemm.py:42: the composite, flat (the probe's
    (n_waves, g) output flattened; its MXU reduction is a TPU workaround):
    K5.  Its default ring, 64 x 4 blocks, does not fit."""
    return _staged_composite(hashes2d, blk, queries, g, nbuf)


def make_landing(G: int, out_mode: str = "smem"):
    """probes/_probe_fused.py:40 make_landing(G) and
    probes/_probe_kernelvariants.py:31 make_landing(G, out_mode): the
    composite of each query in its block of a flat table, by K1 (the
    output mode, SMEM scalars or a one-hot (8, 128) tile per 1024
    lookups, is TPU output memory; both return the flat composite)."""

    def lookup(hashes2d, blk, queries):
        return composite(*bl.block_count(hashes2d.reshape(-1), blk, queries, 1))

    return lookup


def make_resident(G: int, out_mode: str = "smem"):
    """probes/_probe_kernelvariants.py:86: make_landing's composite over a
    small resident table (the probe's top index), by K1."""
    return make_landing(G, out_mode)


def fused_call(G: int, E: int, inter2d, blk, queries):
    """probes/_probe_fused.py:76: (comp, d0, ..., dE-1) over the
    interleaved layout, d_e the docid at lt + e or 0 past the block: K4."""
    comp, d = block_count_emit_docids(inter2d.reshape(-1), blk, queries, E, 1024, "onehot")
    return (comp, *d.unbind(0))


def make_kernel(layout: str, E: int, mode: str = "onehot", G: int = 256):
    """probes/_probe_fused2.py:32: comp + d0 + ... + dE-1 (int32,
    wrapping) over layout "plain" (hashes only, K1), "rm" (R = 1024: K1 at
    stride 2 for E = 0, else K4) or "lm" (R = 128: K4)."""
    if layout not in ("plain", "rm", "lm") or mode not in EMIT_MODES:
        raise ValueError(f"layout {layout!r} / mode {mode!r}")
    if layout == "plain" and E:
        raise ValueError("the plain layout carries no docids")

    def lookup(table2d, blk, queries):
        t = table2d.reshape(-1)
        if layout == "plain" or (layout == "rm" and not E):
            return composite(*bl.block_count(t, blk, queries, 1 if layout == "plain" else 2))
        r, d = block_count_emit_docids(t, blk, queries, E, 1024 if layout == "rm" else 128, mode)
        for e in range(E):
            r = r + d[e]
        return r

    return lookup


def rowemit_call(G: int, inter2d, blk, queries):
    """probes/_probe_fused3.py:35: (comp, rows (2L, 128)), rows 2j and 2j+1
    lookup j's docid rows r = min(lt >> 7, 7) and min(r + 1, 7): K2."""
    lt, eq, rows = bl.block_count_emit(inter2d.reshape(-1), blk, queries)
    return composite(lt, eq), rows.reshape(-1, 128)


def lookup_dma_emit(inter2d, blk, queries, g: int = 64, nbuf: int = 4, nout: int = 2):
    """probes/_probe_dma2.py:222: rowemit_call's contract, by K2 (the
    probe's explicit DMA ring sizes are TPU knobs)."""
    return rowemit_call(g, inter2d, blk, queries)
