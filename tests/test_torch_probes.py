"""The port's probe functions against the sixteen `pallas_call` sites of
probes/, exactly.

Each site's Pallas function runs in interpret mode on the CPU
(`jax.experimental.pallas.pallas_call` patched with interpret=True);
probes/ is not edited.  Every probe file is loaded by `_load`, which execs
only its imports, `def`s and the constants BLOCK / ROWS / G / NBUF: five
of them build 2^26-2^28-entry arrays or run kernels at import (_probe_dma,
_probe_dma2, _probe_smem, _probe_floor, _probe_wavemm), and most put a
fixed directory at the head of sys.path, which would outlive the import
and redirect every later import of the session.  The same numpy inputs go through the
probe and through acoustid_index_tpu_torch.ops.probe_lookup's function of
the same name, whose kernel wrappers run their plain PyTorch versions on
CPU tensors.  Tables of 16-64 sorted blocks hold runs across block
boundaries, duplicate hashes, 0xFFFFFFFF padding and docids with the high
bit set; queries hit at random positions and at the block's end (so lt + e
passes 1024 for the docid extractions), miss, and take 0 and 0xFFFFFFFF.
Every output is an integer: the tolerance is 0.

Also here: the wrappers' CPU path and checks, the CHECK_SORTED hook,
numpy models of K3's and K4's search schedules -- the sector search the
kernels run (csrc/sector_search.cuh, at every arity measure.py times) and
the kernels' first design, a per-thread binary search (thread11) -- held to the plain versions
under hypothesis and on adversarial blocks, and to measure.py's count of
the bytes each design reads; and `test_cuda_*` cases that hold each kernel
and each design not taken to its plain version on a card (`python -m
pytest tests/test_torch_probes.py -k cuda`), skipped without one.
"""

import ast
import functools
import os
import sys
import types

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from acoustid_index_tpu_torch.ops import block_lookup as bl
from acoustid_index_tpu_torch.ops import probe_lookup as port

os.environ.setdefault("AITPU_TORCH_DEVICE", "cpu")

BLOCK = 1024
ROWS = BLOCK // 128
PROBES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "probes")
G = 8  # the probes' lookups per grid step here: interpret mode unrolls G bodies per step


@functools.lru_cache(maxsize=None)
def _load(name: str) -> types.ModuleType:
    """A probe file that computes at import, with only its imports, defs
    and constants BLOCK / ROWS / G / NBUF executed."""
    path = os.path.join(PROBES, name + ".py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [
        n for n in tree.body
        if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
        or (isinstance(n, ast.Assign) and all(isinstance(t, ast.Name) and t.id in ("BLOCK", "ROWS", "G", "NBUF") for t in n.targets))
    ]
    mod = types.ModuleType(f"probes.{name}")
    mod.__file__ = path
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), mod.__dict__)
    return mod


PROBE_FILES = ("_pairkernel", "_probe_ceiling", "_probe_dma", "_probe_dma2", "_probe_floor", "_probe_fused",
               "_probe_fused2", "_probe_fused3", "_probe_kernelvariants", "_probe_smem", "_probe_wavemm")


def test_loading_the_probes_leaves_sys_path_alone():
    """The probe files' own sys.path edits never run here: loading all
    eleven changes no entry of sys.path."""
    before = list(sys.path)
    for name in PROBE_FILES:
        assert hasattr(_load.__wrapped__(name), "BLOCK")
    assert sys.path == before


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Every pallas_call interprets; the probes' env-read knobs are pinned."""
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setenv("AITPU_PAIR_G", str(G))
    for name in ("_probe_floor", "_probe_smem"):
        monkeypatch.setattr(_load(name), "G", G)
    monkeypatch.setattr(_load("_probe_dma"), "NBUF", 4)
    monkeypatch.setattr(_load("_probe_ceiling"), "NBUF", 4)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; u32 arrays as int32 storage of the same bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        np.testing.assert_array_equal(_np(a), b)


def _table(nblk: int, seed: int):
    """(hashes, docids) u32: sorted hashes with many duplicates, an equal run
    across every third block boundary and 700 entries of 0xFFFFFFFF padding;
    docids random with every third one's high bit set."""
    rng = np.random.default_rng(seed)
    h = np.sort(rng.integers(0, 1 << 16, nblk * BLOCK, dtype=np.uint32))
    for b in range(1, nblk, 3):
        h[b * BLOCK - 5 : b * BLOCK + 7] = h[b * BLOCK]
    h = np.sort(h)
    h[-700:] = 0xFFFFFFFF
    d = rng.integers(0, 1 << 32, nblk * BLOCK, dtype=np.uint32)
    d[::3] |= np.uint32(0x80000000)
    return h, d


def _lookups(h, nblk: int, L: int, seed: int, lo: int = 0):
    """(blk int32, q u32): each lookup's query hits its block at a random
    position or at one of its last four, misses (random u32), is the
    block's last hash + 1, its first hash - 1, 0 or 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(lo, nblk - 1, L).astype(np.int32)
    base = blk.astype(np.int64) * BLOCK
    kind = np.arange(L) % 8
    pos = np.where(kind == 1, BLOCK - 1 - rng.integers(0, 4, L), rng.integers(0, BLOCK, L))
    q = h[base + pos].astype(np.int64)
    q[kind == 2] = rng.integers(0, 1 << 32, (kind == 2).sum())
    q[kind == 3] = h[base + BLOCK - 1][kind == 3].astype(np.int64) + 1
    q[kind == 4] = h[base][kind == 4].astype(np.int64) - 1
    q[kind == 5] = 0
    q[kind == 6] = 0xFFFFFFFF
    return blk, (q & 0xFFFFFFFF).astype(np.uint32)


def _interleave(h, d, R: int):
    """One flat table of 2048-word blocks, R-word runs alternating h and d."""
    nblk = h.shape[0] // BLOCK
    return np.stack([h.reshape(nblk, -1, R), d.reshape(nblk, -1, R)], 2).reshape(-1)


def _pair_inputs(nblk=24, L=64, seed=5):
    h, d = _table(nblk, seed)
    blk0, q = _lookups(h, nblk, L, seed + 1, lo=1)
    blk1 = np.where(np.arange(L) % 2 == 0, blk0 + 1, 0).astype(np.int32)  # half the window enabled
    return h, d, blk0, blk1, q


J = jnp.asarray


# ---- the sixteen sites (one case per site and variant) ----


@pytest.mark.parametrize("stride", [1, 2])
def test_pairkernel_block_lookup_pair(stride):
    """probes/_pairkernel.py:93."""
    h, d, blk0, blk1, q = _pair_inputs(seed=5 + stride)
    table = h if stride == 1 else _interleave(h, d, 1024)
    want = _load("_pairkernel").block_lookup_pair(J(table), J(blk0), J(blk1), J(q), stride=stride)
    _eq(port.block_lookup_pair(_t(table), _t(blk0), _t(blk1), _t(q), stride=stride), want)


def test_probe_dma_block_lookup_pair_dma():
    """probes/_probe_dma.py:73, over a table with one sentinel block of
    padding; lookups in the last real block reach into it."""
    h, _, blk0, _, q = _pair_inputs(nblk=17, seed=9)
    hp = np.concatenate([h, np.full(BLOCK, 0xFFFFFFFF, np.uint32)])
    blk0[:8] = 16  # the last real block: its window's second block is the padding
    flag = (np.arange(blk0.shape[0]) % 3 != 0).astype(np.int32)
    want = _load("_probe_dma").block_lookup_pair_dma(J(hp), J(blk0), J(flag), J(q))
    _eq(port.block_lookup_pair_dma(_t(hp), _t(blk0), _t(flag), _t(q)), want)


@pytest.mark.parametrize("nbuf", [2, 4])
def test_probe_dma2_lookup_dma(nbuf):
    """probes/_probe_dma2.py:79."""
    h, _ = _table(16, 11)
    blk, q = _lookups(h, 16, 64, 12)
    want = _load("_probe_dma2").lookup_dma(J(h.reshape(-1, 128)), J(blk), J(q), nbuf=nbuf)
    _eq(port.lookup_dma(_t(h).reshape(-1, 128), _t(blk), _t(q), nbuf=nbuf), want)


@pytest.mark.parametrize("g,nbuf", [(8, 4), (4, 2)])
def test_probe_dma2_lookup_dma_vec(g, nbuf):
    """probes/_probe_dma2.py:149."""
    h, _ = _table(16, 13)
    blk, q = _lookups(h, 16, 64, 14)
    want = _load("_probe_dma2").lookup_dma_vec(J(h.reshape(-1, 128)), J(blk), J(q), g=g, nbuf=nbuf)
    _eq(port.lookup_dma_vec(_t(h).reshape(-1, 128), _t(blk), _t(q), g=g, nbuf=nbuf), want)


@pytest.mark.parametrize("g,nbuf", [(8, 4), (16, 2)])
def test_probe_dma2_lookup_dma_vec2(g, nbuf):
    """probes/_probe_dma2.py:215."""
    h, _ = _table(16, 15)
    blk, q = _lookups(h, 16, 64, 16)
    want = _load("_probe_dma2").lookup_dma_vec2(J(h.reshape(-1, 128)), J(blk), J(q), g=g, nbuf=nbuf)
    _eq(port.lookup_dma_vec2(_t(h).reshape(-1, 128), _t(blk), _t(q), g=g, nbuf=nbuf), want)


def test_probe_dma2_lookup_dma_emit():
    """probes/_probe_dma2.py:321."""
    h, d = _table(16, 17)
    inter = _interleave(h, d, 1024)
    blk, q = _lookups(h, 16, 64, 18)
    want = _load("_probe_dma2").lookup_dma_emit(J(inter.reshape(-1, 128)), J(blk), J(q), g=G, nbuf=4)
    _eq(port.lookup_dma_emit(_t(inter).reshape(-1, 128), _t(blk), _t(q), g=G, nbuf=4), want)


def test_probe_fused_make_landing():
    """probes/_probe_fused.py:66."""
    h, _ = _table(16, 19)
    blk, q = _lookups(h, 16, 64, 20)
    want = _load("_probe_fused").make_landing(G)(J(h.reshape(-1, 128)), J(blk), J(q))
    _eq(port.make_landing(G)(_t(h).reshape(-1, 128), _t(blk), _t(q)), want)


@pytest.mark.parametrize("E", [1, 2, 4])
def test_probe_fused_fused_call(E):
    """probes/_probe_fused.py:115, with lt + e past the block's end."""
    h, d = _table(16, 21 + E)
    inter = _interleave(h, d, 1024)
    blk, q = _lookups(h, 16, 64, 22 + E)
    want = _load("_probe_fused").fused_call(G, E, J(inter.reshape(-1, 128)), J(blk), J(q))
    got = port.fused_call(G, E, _t(inter).reshape(-1, 128), _t(blk), _t(q))
    _eq(got, want)
    lt = _np(got[0]) & 0xFFF
    assert (lt + E - 1 >= BLOCK).any() and (lt < BLOCK - 4).any()  # both sides of the edge ran


FUSED2 = [("plain", 0, "onehot"), ("rm", 0, "onehot"), ("lm", 0, "onehot"),
          ("rm", 2, "onehot"), ("rm", 2, "slice"), ("lm", 2, "onehot"), ("lm", 2, "slice"),
          ("rm", 4, "slice"), ("lm", 4, "onehot")]


@pytest.mark.parametrize("layout,E,mode", FUSED2)
def test_probe_fused2_make_kernel(layout, E, mode):
    """probes/_probe_fused2.py:98: both layouts, both extractions, with
    lt + e past the block's end (where "slice" reads row 7)."""
    h, d = _table(16, 31)
    blk, q = _lookups(h, 16, 64, 32)
    if layout == "plain":
        table, width = h, 128
    else:
        table, width = _interleave(h, d, 1024 if layout == "rm" else 128), 128 if layout == "rm" else 256
    want = _load("_probe_fused2").make_kernel(layout, E, mode, G=G)(J(table.reshape(-1, width)), J(blk), J(q))
    _eq(port.make_kernel(layout, E, mode, G=G)(_t(table).reshape(-1, width), _t(blk), _t(q)), want)


def test_probe_fused3_rowemit_call():
    """probes/_probe_fused3.py:79."""
    h, d = _table(16, 33)
    inter = _interleave(h, d, 1024)
    blk, q = _lookups(h, 16, 64, 34)
    want = _load("_probe_fused3").rowemit_call(G, J(inter.reshape(-1, 128)), J(blk), J(q))
    _eq(port.rowemit_call(G, _t(inter).reshape(-1, 128), _t(blk), _t(q)), want)


@pytest.mark.parametrize("out_mode", ["onehot", "smem"])
def test_probe_kernelvariants_make_landing(out_mode):
    """probes/_probe_kernelvariants.py:78 (the one-hot tile wants 1024 lookups)."""
    h, _ = _table(16, 35)
    blk, q = _lookups(h, 16, 1024 if out_mode == "onehot" else 64, 36)
    want = _load("_probe_kernelvariants").make_landing(G, out_mode)(J(h.reshape(-1, 128)), J(blk), J(q))
    _eq(port.make_landing(G, out_mode)(_t(h).reshape(-1, 128), _t(blk), _t(q)), want)


@pytest.mark.parametrize("out_mode", ["onehot", "smem"])
def test_probe_kernelvariants_make_resident(out_mode):
    """probes/_probe_kernelvariants.py:131 over a small resident table."""
    h, _ = _table(16, 37)
    blk, q = _lookups(h, 16, 1024 if out_mode == "onehot" else 64, 38)
    want = _load("_probe_kernelvariants").make_resident(G, out_mode)(J(h.reshape(-1, 128)), J(blk), J(q))
    _eq(port.make_resident(G, out_mode)(_t(h).reshape(-1, 128), _t(blk), _t(q)), want)


@pytest.mark.parametrize("variant", ["full", "oneblock", "noreduce", "empty"])
def test_probe_floor_make(variant):
    """probes/_probe_floor.py:63, each step of its bisection."""
    h, _, blk0, blk1, q = _pair_inputs(seed=41)
    want = _load("_probe_floor").make(variant)(J(h), J(blk0), J(blk1), J(q))
    _eq(port.make_floor(variant, G)(_t(h), _t(blk0), _t(blk1), _t(q)), want)


@pytest.mark.parametrize("g,nbuf", [(8, 4), (16, 2)])
def test_probe_wavemm_lookup_wave_mm(g, nbuf):
    """probes/_probe_wavemm.py:108, with queries within 800 of the block
    start (its own query shape)."""
    h, _ = _table(16, 43)
    rng = np.random.default_rng(44)
    blk = rng.integers(0, 16, 64).astype(np.int32)
    q = (h[blk.astype(np.int64) * BLOCK].astype(np.int64) + rng.integers(0, 800, 64)).astype(np.uint32)
    want = _load("_probe_wavemm").lookup_wave_mm(J(h.reshape(-1, 128)), J(blk), J(q), g=g, nbuf=nbuf)
    _eq(port.lookup_wave_mm(_t(h).reshape(-1, 128), _t(blk), _t(q), g=g, nbuf=nbuf), want)


@pytest.mark.parametrize("vmem_out", [False, True])
def test_probe_ceiling_dma_lookup(vmem_out):
    """probes/_probe_ceiling.py:119, SMEM scalars and the (L // 128, 128) tile."""
    h, _ = _table(16, 45)
    blk, q = _lookups(h, 16, 128, 46)
    want = _load("_probe_ceiling").dma_lookup(J(h.reshape(-1, 128)), J(blk), J(q), vmem_out)
    _eq(port.dma_lookup(_t(h).reshape(-1, 128), _t(blk), _t(q), vmem_out, nbuf=4), want)


def test_probe_smem_block_lookup_pair_smem():
    """probes/_probe_smem.py:60."""
    h, _, blk0, blk1, q = _pair_inputs(seed=47)
    want = _load("_probe_smem").block_lookup_pair_smem(J(h), J(blk0), J(blk1), J(q))
    _eq(port.block_lookup_pair_smem(_t(h), _t(blk0), _t(blk1), _t(q)), want)


# ---- the wrappers ----


def _kernel_calls(h, d, blk, blk1, q):
    """Each of K3, K4, K5 with its plain version, on CPU tensors."""
    inter = _t(_interleave(h, d, 128))
    th, tb, tb1, tq = _t(h), _t(blk), _t(blk1), _t(q)
    return [
        (lambda: port.block_count_pair(th, tb, tb1, tq), lambda: port.block_count_pair_plain(th, tb, tb1, tq)),
        (lambda: port.block_count_emit_docids(inter, tb, tq, 3, 128, "slice"),
         lambda: port.block_count_emit_docids_plain(inter, tb, tq, 3, 128, "slice")),
        (lambda: port.block_count_staged(th, tb, tq, 4, 3), lambda: port.block_count_staged_plain(th, tb, tq)),
    ]


def test_cpu_path_takes_the_plain_version():
    h, d, blk, blk1, q = _pair_inputs(seed=51)
    before = dict(bl.LAUNCHES)
    for wrapper, plain in _kernel_calls(h, d, blk, blk1, q):
        _eq(wrapper(), plain())
    assert bl.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["pair", "emit_docids", "staged"])
@pytest.mark.parametrize("fault", ["dtype", "length", "device"])
def test_wrappers_check_their_inputs(kernel, fault):
    h, d, blk, blk1, q = _pair_inputs(nblk=4, L=8, seed=53)
    table = _t(_interleave(h, d, 1024)) if kernel == "emit_docids" else _t(h)
    tb, tb1, tq = _t(blk), _t(blk1), _t(q)
    if fault == "dtype":
        table = table.to(torch.int64)
    elif fault == "length":
        table = table[:-BLOCK // 2]
    else:
        tq = torch.empty(tq.shape, dtype=tq.dtype, device="meta")
    call = {
        "pair": lambda: port.block_count_pair(table, tb, tb1, tq),
        "emit_docids": lambda: port.block_count_emit_docids(table, tb, tq, 2),
        "staged": lambda: port.block_count_staged(table, tb, tq, 8, 4),
    }[kernel]
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("g,nbuf", [(16, 4), (8, 8), (64, 4), (128, 2), (32, 2)])
def test_staged_refuses_a_ring_that_does_not_fit(g, nbuf):
    """G x NBUF x 4 KB over 227 KB raises on every device, unshrunk; so do
    the probes' defaults that exceed it."""
    h, _ = _table(4, 55)
    blk, q = _lookups(h, 4, 8, 56)
    with pytest.raises(ValueError, match="do not fit"):
        port.block_count_staged(_t(h), _t(blk), _t(q), g, nbuf)
    assert not port.staged_fits(g, nbuf)
    with pytest.raises(ValueError, match="do not fit"):
        port.lookup_wave_mm(_t(h).reshape(-1, 128), _t(blk), _t(q))


def test_staged_refuses_an_unbuilt_template():
    h, _ = _table(4, 57)
    blk, q = _lookups(h, 4, 8, 58)
    with pytest.raises(ValueError, match="built for"):
        port.block_count_staged(_t(h), _t(blk), _t(q), 2, 2)
    assert [(g, n) for g in port.STAGED_G for n in port.STAGED_NBUF if port.staged_fits(g, n)] == [
        (1, 2), (1, 3), (1, 4), (1, 8), (1, 16), (4, 2), (4, 3), (4, 4), (4, 8), (8, 2), (8, 3), (8, 4), (16, 2), (16, 3)]
    assert port.STAGED_SWEEP == ((4, 2), (4, 3), (4, 4), (8, 2), (8, 3), (8, 4), (16, 2), (16, 3))


@pytest.mark.parametrize("kernel", ["pair_blk0", "pair_blk1", "emit_docids_1024", "emit_docids_128"])
def test_check_sorted_hook_rejects_unsorted_block(kernel, monkeypatch):
    """With block_lookup.CHECK_SORTED set, K3's and K4's wrappers refuse a searched block
    that is not non-decreasing as u32 (0xFFFFFFFF before 0), and pass the
    sorted ones; K5 counts any block."""
    h, d = _table(4, 59)
    bad = h.copy()
    bad[2 * BLOCK + 5], bad[2 * BLOCK + 6] = 0xFFFFFFFF, 0
    q = _t(np.array([5, 6, 7], np.uint32))
    fine, hit = _t(np.array([0, 1, 3], np.int32)), _t(np.array([0, 2, 3], np.int32))
    zero = _t(np.zeros(3, np.int32))

    def call(hh, b):
        if kernel == "pair_blk0":
            return port.block_count_pair(_t(hh), b, zero, q)
        if kernel == "pair_blk1":
            return port.block_count_pair(_t(hh), fine, b, q)
        R = int(kernel.rsplit("_", 1)[1])
        return port.block_count_emit_docids(_t(_interleave(hh, d, R)), b, q, 2, R)

    call(bad, hit)  # off by default
    monkeypatch.setattr(bl, "CHECK_SORTED", True)
    call(h, hit)
    call(bad, fine)
    with pytest.raises(AssertionError, match="block 2 of"):
        call(bad, hit)
    port.block_count_staged(_t(bad), hit, q, 4, 2)


# ---- K3's and K4's search schedule: a numpy model against the plain versions ----


def _bounds_model(at, q):
    """(lt, ub) per row as the first design of K3 and K4 (thread11,
    csrc/probe_lookup_designs.cu) computes them:
    `at(rows, i)` reads hash i of each row's block; per bound a probe at
    b + half - 1 for half = 512 .. 1 moves b up by half when the entry is
    below the bound, then one compare at b settles it."""
    out = []
    for below in (lambda x: x < q, lambda x: x <= q):
        b = np.zeros(q.shape[0], np.int64)
        half = BLOCK // 2
        while half:
            b += np.where(below(at(b + half - 1)), half, 0)
            half //= 2
        out.append(b + below(at(b)))
    return out


def _rows_at(blocks, blk):
    """at(i): hash i of each row's block, i of shape (rows,) or (rows, k)."""
    blk = np.asarray(blk, np.int64)
    return lambda i: blocks[blk.reshape(-1, *([1] * (np.ndim(i) - 1))), i]


SECTOR_ROUNDS = {2: 8, 4: 5, 8: 4}  # dependent rounds of the sector search, its last sector's included


def _sector_bounds_model(at, q, arity):
    """(lt, ub, rounds, s) per row as csrc/sector_search.cuh's sector search
    computes them.  Per bound the search finds the sector s of its bound
    among the block's 128 sectors of 8 hashes: a round over an interval of
    `size` sectors from base b loads the first hashes of sectors b + step *
    i (i = 1 .. k - 1, k = min(arity, size), step = size // k) and moves b
    by step per pivot below the bound; then it loads sector s (two 16-byte
    loads, at 8 s and 8 s + 4) and counts it: the bound is 8 s + the
    sector's hashes below it.  The upper bound shares the lower bound's
    loads while their bases agree and issues its own where they part.
    `rounds`: one (rows, n) array per dependent round of the hash
    positions loaded, -1 where a load is not issued; `s` the lower bound's
    sector."""
    q = q.astype(np.int64)
    sl = np.zeros(q.shape[0], np.int64)
    su = sl.copy()
    rounds = []
    size = BLOCK // 8
    while size > 1:
        k = min(arity, size)
        step = size // k
        piv_l = 8 * (sl[:, None] + step * np.arange(1, k))
        piv_u = 8 * (su[:, None] + step * np.arange(1, k))
        split = (su != sl)[:, None]
        rounds.append(np.concatenate([piv_l, np.where(split, piv_u, -1)], 1))
        sl = sl + step * (at(piv_l) < q[:, None]).sum(1)
        su = su + step * (np.where(split, at(piv_u), at(piv_l)) <= q[:, None]).sum(1)
        size = step
    split = (su != sl)[:, None]
    rounds.append(np.concatenate([8 * sl[:, None] + [0, 4], np.where(split, 8 * su[:, None] + [0, 4], -1)], 1))
    lt = 8 * sl + (at(8 * sl[:, None] + np.arange(8)) < q[:, None]).sum(1)
    ub = 8 * su + (at(8 * su[:, None] + np.arange(8)) <= q[:, None]).sum(1)
    return lt, ub, rounds, sl


def _bounds(at, q, schedule):
    """(lt, ub) by the schedule "thread11" (the first design) or "sectorK"."""
    if schedule == "thread11":
        return _bounds_model(at, q)
    return _sector_bounds_model(at, q, _arity(schedule))[:2]


def _arity(schedule):
    return int(schedule.removeprefix("sector").removesuffix("lazy"))


def _pair_model(h, blk0, blk1, q, variant, g, schedule="thread11"):
    """K3's (lt, eq), which it packs as lt + (eq << 12): the flat table `h`
    (stride 1), each block searched by `schedule`."""
    blocks = h.reshape(-1, BLOCK)
    rows = np.arange(q.shape[0])
    if variant == "empty":
        return rows % g, np.zeros_like(rows)
    if variant == "noreduce":
        return (blocks[blk0, 0] < q).astype(np.int64), np.zeros_like(rows)
    lt0, ub0 = _bounds(_rows_at(blocks, blk0), q, schedule)
    if variant == "oneblock":
        return lt0, ub0 - lt0
    on = blk1 > 0
    lt1, ub1 = _bounds(_rows_at(blocks, np.where(on, blk1, blk0)), q, schedule)
    return lt0 + on * lt1, (ub0 - lt0) + on * (ub1 - lt1)


def _sector_docids(word, lt, s, E, mode):
    """K4's E docids as the sector schedule selects them: docid sector s
    (A) and the first half of sector s + 1 (B), loaded with the last hash
    sector (B, lazily, only where lt + E - 1 reaches it: the same values);
    past the block (s = 127) B is the first half of docid sector 112
    ("slice": row 7, lanes 0-3) or zeros ("onehot"); d_e = word lt - 8 s + e
    of A then B."""
    a = word(8 * s[:, None] + np.arange(8))
    past = (s + 1 >= BLOCK // 8)[:, None]
    b = word(np.where(past, BLOCK - 128, 8 * (s[:, None] + 1)) + np.arange(4))
    if mode == "onehot":
        b = np.where(past, 0, b)
    w = np.concatenate([a, b], 1)
    rows = np.arange(lt.shape[0])
    return [w[rows, lt - 8 * s + e] for e in range(E)]


def _emit_model(inter, blk, q, E, R, mode, schedule="thread11"):
    """K4's (comp, d): the R-layout table `inter`, loads at
    (i // R) * 2R + (i % R) (hashes) and + R (docids); `schedule` as
    _bounds, the sector schedule with its own docid selection."""
    base = blk.astype(np.int64)[:, None] * 2 * BLOCK

    def word(i, off):
        i = np.asarray(i)
        return inter[base.reshape(-1, *([1] * (i.ndim - 1))) + (i // R) * 2 * R + off + (i % R)]

    if schedule != "thread11":
        lt, ub, _, s = _sector_bounds_model(lambda i: word(i, 0), q, _arity(schedule))
        d = _sector_docids(lambda i: word(i, R), lt, s, E, mode)
        return lt + ((ub - lt) << 12), np.array(d, np.uint32).reshape(E, q.shape[0])
    lt, ub = _bounds_model(lambda i: word(i, 0), q)
    d = []
    for e in range(E):
        p = lt + e
        if mode == "slice":
            d.append(word(np.minimum(p >> 7, ROWS - 1) * 128 + (p & 127), R))
        else:
            d.append(np.where(p < BLOCK, word(np.minimum(p, BLOCK - 1), R), 0))
    return lt + ((ub - lt) << 12), np.array(d, np.uint32).reshape(E, q.shape[0])


_U32 = st.one_of(st.integers(0, 0xFFFFFFFF), st.sampled_from([0, 1, (1 << 31) - 1, 1 << 31, 0xFFFFFFFE, 0xFFFFFFFF]))
_CUT = st.one_of(st.integers(0, BLOCK), st.sampled_from([0, 1, 7, 8, 9, 15, 16, 127, 128, 129, 895, 896, 1015, 1016, 1017,
                                                         1020, 1021, 1022, 1023, 1024]))


@st.composite
def _sorted_table(draw):
    """2-4 sorted blocks of equal-value runs, values drawn at the u32 edges."""
    blocks = []
    for _ in range(draw(st.integers(2, 4))):
        k = draw(st.integers(1, 8))
        values = sorted(draw(st.lists(_U32, min_size=k, max_size=k)))
        bounds = [0] + sorted(draw(st.lists(_CUT, min_size=k - 1, max_size=k - 1))) + [BLOCK]
        block = np.empty(BLOCK, np.uint32)
        for v, a, b in zip(values, bounds[:-1], bounds[1:]):
            block[a:b] = v
        blocks.append(block)
    return np.concatenate(blocks)


def _model_queries(h, rng):
    """Every block asked every distinct value of the table, each +- 1, 0,
    0xFFFFFFFF and random u32s; blk1 the next block for half of them."""
    nblk = h.shape[0] // BLOCK
    v = np.unique(h).astype(np.int64)
    cand = np.unique(np.r_[v, v - 1, v + 1, 0, 0xFFFFFFFF, rng.integers(0, 1 << 32, 4)])
    cand = cand[(cand >= 0) & (cand <= 0xFFFFFFFF)].astype(np.uint32)
    blk0 = np.repeat(np.arange(nblk, dtype=np.int32), cand.shape[0])
    q = np.tile(cand, nblk)
    blk1 = np.where((np.arange(q.shape[0]) % 2 == 0) & (blk0 + 1 < nblk), blk0 + 1, 0).astype(np.int32)
    return blk0, blk1, q


PAIR_SCHEDULES = ("thread11",) + tuple(f"sector{a}" for a in (2, 4, 8))  # measure.PAIR_DESIGNS
EMIT_SCHEDULES = PAIR_SCHEDULES + tuple(f"sector{a}lazy" for a in (2, 4, 8))  # measure.EMIT_DESIGNS


def _with_sectors(cases, ids, schedules):
    """Each case under the thread11 schedule (its id as before) and under every
    sector schedule (id + "-sectorK")."""
    out = [pytest.param(*c, "thread11", id=i) for c, i in zip(cases, ids)]
    return out + [pytest.param(*c, sch, id=f"{i}-{sch}") for c, i in zip(cases, ids) for sch in schedules[1:]
                  if c[0] not in ("noreduce", "empty")]


@pytest.mark.parametrize("variant,schedule", _with_sectors([(v,) for v in port.PAIR_VARIANTS], port.PAIR_VARIANTS, PAIR_SCHEDULES))
@settings(max_examples=25, deadline=None)
@given(h=_sorted_table(), seed=st.integers(0, 2**16))
def test_pair_model_matches_plain(variant, schedule, h, seed):
    blk0, blk1, q = _model_queries(h, np.random.default_rng(seed))
    comp = port.block_count_pair_plain(_t(h), _t(blk0), _t(blk1), _t(q), 1, variant, 8)
    lt_m, eq_m = _pair_model(h, blk0, blk1, q, variant, 8, schedule)
    np.testing.assert_array_equal(comp.numpy(), lt_m + (eq_m << 12))
    np.testing.assert_array_equal([x.numpy() for x in port.counts(comp)], [lt_m, eq_m])


_EMIT_CASES = [(1024, "onehot"), (1024, "slice"), (128, "onehot"), (128, "slice")]


@pytest.mark.parametrize("R,mode,schedule", _with_sectors(_EMIT_CASES, [f"{R}-{m}" for R, m in _EMIT_CASES], EMIT_SCHEDULES))
@settings(max_examples=25, deadline=None)
@given(h=_sorted_table(), seed=st.integers(0, 2**16))
def test_emit_docids_model_matches_plain(R, mode, schedule, h, seed):
    rng = np.random.default_rng(seed)
    blk, _, q = _model_queries(h, rng)
    d = rng.integers(0, 1 << 32, h.shape[0], dtype=np.uint32)
    inter = _interleave(h, d, R)
    comp, dd = port.block_count_emit_docids_plain(_t(inter), _t(blk), _t(q), 4, R, mode)
    comp_m, dd_m = _emit_model(inter, blk, q, 4, R, mode, schedule)
    np.testing.assert_array_equal(comp.numpy(), comp_m)
    np.testing.assert_array_equal(dd.numpy(), dd_m.view(np.int32))


def _adversarial_table():
    """(hashes, docids) u32 of 8 sorted blocks at the sector search's
    edges: equal runs straddling sector (8k) and 128-entry boundaries; a
    block all 2^31; hashes >= 2^31 below 0xFFFFFFFF (q = 0xFFFFFFFF gives lt
    = 1024); 1, 3, 5, ... (every lt from 0 to 1024 is some query's, so K4's
    docid sectors run to every run's end at R = 128); 600 zeros then
    0xFFFFFFFF; all 0xFFFFFFFF; all 0; a run across the whole second half."""
    rng = np.random.default_rng(71)
    straddle = np.arange(BLOCK, dtype=np.uint32) * 3 + 10
    for k in (8, 16, 64, 120, 128, 256, 504, 896, 1016):
        straddle[k - 3 : k + 5] = straddle[k - 3]
    for k in (128, 384, 640):
        straddle[k - 9 : k + 11] = straddle[k - 9]
    half = np.sort(rng.integers(0, 1 << 20, BLOCK, dtype=np.uint32))
    half[512:] = half[511]
    blocks = [
        np.sort(straddle),
        np.full(BLOCK, 1 << 31, np.uint32),
        np.sort(rng.integers(1 << 31, 0xFFFFFFFF, BLOCK, dtype=np.uint32)),
        np.arange(BLOCK, dtype=np.uint32) * 2 + 1,
        np.r_[np.zeros(600, np.uint32), np.full(BLOCK - 600, 0xFFFFFFFF, np.uint32)],
        np.full(BLOCK, 0xFFFFFFFF, np.uint32),
        np.zeros(BLOCK, np.uint32),
        half,
    ]
    d = rng.integers(0, 1 << 32, len(blocks) * BLOCK, dtype=np.uint32)
    d[::3] |= np.uint32(0x80000000)
    return np.concatenate(blocks), d


def _adversarial_queries(h):
    """(blk0, blk1, q): every block asked each of its own distinct values,
    each +- 1, 0, 2^31 +- 1 and 0xFFFFFFFF; blk1 the next block for half."""
    blk, q = [], []
    for b, block in enumerate(h.reshape(-1, BLOCK)):
        v = np.unique(block).astype(np.int64)
        cand = np.unique(np.r_[v, v - 1, v + 1, 0, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, 0xFFFFFFFF])
        cand = cand[(cand >= 0) & (cand <= 0xFFFFFFFF)].astype(np.uint32)
        blk.append(np.full(cand.shape[0], b, np.int32))
        q.append(cand)
    blk0, q = np.concatenate(blk), np.concatenate(q)
    nblk = h.shape[0] // BLOCK
    blk1 = np.where((np.arange(q.shape[0]) % 2 == 0) & (blk0 + 1 < nblk), blk0 + 1, 0).astype(np.int32)
    return blk0, blk1, q


@pytest.mark.parametrize("schedule", EMIT_SCHEDULES)
def test_adversarial_blocks_model_matches_plain(schedule):
    """Both kernels' schedules on the adversarial blocks: every K3 variant,
    and K4 at E = 0..4 in both layouts and modes (lt = 1024 with E = 4 in
    both modes is among them)."""
    h, d = _adversarial_table()
    blk0, blk1, q = _adversarial_queries(h)
    for variant in port.PAIR_VARIANTS:
        comp = port.block_count_pair_plain(_t(h), _t(blk0), _t(blk1), _t(q), 1, variant, 8)
        lt_m, eq_m = _pair_model(h, blk0, blk1, q, variant, 8, schedule.removesuffix("lazy"))
        np.testing.assert_array_equal(comp.numpy(), lt_m + (eq_m << 12))
    for R in (1024, 128):
        inter = _interleave(h, d, R)
        for mode in ("onehot", "slice"):
            for E in range(5):
                comp, dd = port.block_count_emit_docids_plain(_t(inter), _t(blk0), _t(q), E, R, mode)
                comp_m, dd_m = _emit_model(inter, blk0, q, E, R, mode, schedule)
                np.testing.assert_array_equal(comp.numpy(), comp_m)
                np.testing.assert_array_equal(dd.numpy(), dd_m.view(np.int32))
    lt = comp.numpy() & 0xFFF
    assert (lt == BLOCK).any() and ((lt > 0) & (lt % 8 == 0)).any() and (lt == 0).any()


@pytest.mark.parametrize("arity", [2, 4, 8])
def test_sector_schedule_rounds_and_loads(arity):
    """The sector search takes SECTOR_ROUNDS[arity] dependent rounds (11
    for the thread11 design, one more for K4's docids), at most arity - 1 pivots
    per bound and round and one final sector; the upper bound issues loads
    of its own only where a run equal to q straddles a pivot; and
    measure.search_schedule, from which measure.kernel_bound counts the
    bytes each design reads, loads the same sectors as this model."""
    import acoustid_index_tpu_torch.measure as m

    h, _ = _adversarial_table()
    blk, _, q = _adversarial_queries(h)
    blocks = h.reshape(-1, BLOCK)
    at = _rows_at(blocks, blk)
    lt, ub, rounds, s = _sector_bounds_model(at, q, arity)
    assert len(rounds) == SECTOR_ROUNDS[arity]
    assert all(r.shape[1] <= 2 * (arity - 1) for r in rounds[:-1]) and rounds[-1].shape[1] == 4
    own = np.concatenate([r[:, r.shape[1] // 2 :] for r in rounds], 1) >= 0  # the upper bound's own loads
    assert own.any() and not own[ub == lt].any()
    rows = torch.from_numpy(blocks[blk].astype(np.int64))
    t_lt, t_ub, reads, t_s = m.search_schedule(
        f"sector{arity}", lambda i: rows.gather(1, i.reshape(i.shape[0], -1)).reshape(i.shape), torch.from_numpy(q.astype(np.int64)))
    np.testing.assert_array_equal(t_lt.numpy(), lt)
    np.testing.assert_array_equal(t_ub.numpy(), ub)
    np.testing.assert_array_equal(t_s.numpy(), s)
    loads = np.concatenate(rounds, 1)
    model = np.unique((np.arange(q.shape[0])[:, None] * 128 + loads // 8)[loads >= 0])
    reads = reads.numpy()
    got = np.unique((np.arange(q.shape[0])[:, None] * 128 + reads // 8)[reads >= 0])
    np.testing.assert_array_equal(got, model)


@pytest.mark.parametrize("kernel", ["pair", "emit_docids_1024", "emit_docids_128"])
def test_read_bytes_follow_the_schedules(kernel):
    """measure.kernel_bound's read_bytes per design: the distinct 32-byte
    sectors that the numpy models load (thread11: each probe it makes;
    the sector designs: their pivots, final sectors and, for K4, the docid
    sectors of the last round), plus the call's I/O."""
    import acoustid_index_tpu_torch.measure as m

    h, d = _adversarial_table()
    blk0, blk1, q = _adversarial_queries(h)
    L = q.shape[0]
    if kernel == "pair":
        s = m._set(_t(h), _t(blk0), port.u32(_t(q)))
        s["blk1"] = _t(blk1)
        rec = m.kernel_bound({"kernel": "block_count_pair", "stride": 1, "variant": "full"}, s)
        words, R, io = BLOCK, None, L * 16
    else:
        R = int(kernel.rsplit("_", 1)[1])
        s = m._set(_t(_interleave(h, d, R)), _t(blk0), port.u32(_t(q)))
        rec = m.kernel_bound({"kernel": "block_count_emit_docids", "stride": 2, "E": 4, "R": R, "mode": "slice"}, s)
        words, io = 2 * BLOCK, L * 8 + L * 4 * 5
    blocks = h.reshape(-1, BLOCK)
    hword = (lambda i: i) if R is None else (lambda i: (i // R) * 2 * R + i % R)
    for schedule in PAIR_SCHEDULES if kernel == "pair" else EMIT_SCHEDULES:
        pos = []  # (block, word) of every load
        lookups = [(blk0, np.ones(L, bool))] + ([(blk1, blk1 > 0)] if kernel == "pair" else [])
        for b, on in lookups:
            b, qq = b[on].astype(np.int64), q[on]
            at = _rows_at(blocks, b)
            if schedule == "thread11":
                probes = []  # every probe of _bounds_model, recorded through `at`
                _bounds_model(lambda i: (probes.append(i), at(i))[1], qq)
                loads = np.stack(probes, 1)
                lt = _bounds_model(at, qq)[0]
                dl = lt[:, None] + np.arange(4)
                dl = np.minimum(dl >> 7, ROWS - 1) * 128 + (dl & 127)
            else:
                lt, _, rounds, sec = _sector_bounds_model(at, qq, _arity(schedule))
                loads = np.concatenate(rounds, 1)
                b_at = np.where(sec + 1 >= 128, BLOCK - 128, 8 * (sec + 1))  # "slice": B exists past the block
                if schedule.endswith("lazy"):  # B only where lt + 3 reaches it (E = 4)
                    b_at = np.where(lt - 8 * sec + 3 >= 8, b_at, 8 * sec)
                dl = np.stack([8 * sec, b_at], 1)
            word = np.where(loads >= 0, hword(np.maximum(loads, 0)), -1)
            if R is not None:
                word = np.concatenate([word, (dl // R) * 2 * R + R + dl % R], 1)
            pos.append((b[:, None] * words + word)[word >= 0] // 8)
        assert rec["read_bytes"][schedule] == np.unique(np.concatenate(pos)).shape[0] * 32 + io, schedule


def test_sector_arity_matches_the_kernel_source():
    """ops/probe_lookup.SECTOR_ARITY and SECTOR_LAZY name the design
    csrc/probe_lookup.cu launches."""
    import re

    src = os.path.join(os.path.dirname(port.__file__), "..", "csrc", "probe_lookup.cu")
    with open(src) as f:
        text = f.read()
    assert int(re.search(r"constexpr int ARITY = (\d+);", text).group(1)) == port.SECTOR_ARITY
    assert re.search(r"constexpr bool LAZY = (\w+);", text).group(1) == str(port.SECTOR_LAZY).lower()


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """An edit of csrc/sector_search.cuh names a new build of the libraries
    that include it, so a stale library never loads."""
    import shutil

    from acoustid_index_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    before = {name: _build._so_path(name) for name in ("probes", "designs", "kernels")}
    with open(csrc / "sector_search.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: _build._so_path(name) for name in before}
    assert after["probes"] != before["probes"] and after["designs"] != before["designs"]
    assert "probe_lookup_designs.cu" in _build.LIBRARIES["designs"][0]


# ---- the CUDA kernels vs their plain versions (card only) ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, *xs):
    return [x.to(dev) for x in xs]


def _same(got, want):
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("variant", ["full", "oneblock", "noreduce", "empty"])
@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_block_count_pair_matches_plain(cuda, stride, variant):
    h, d, blk0, blk1, q = _pair_inputs(nblk=64, L=5000, seed=61)
    table = _t(h if stride == 1 else _interleave(h, d, 1024))
    args = (table, _t(blk0), _t(blk1), _t(q))
    want = port.block_count_pair_plain(*args, stride, variant, 7)
    _same(port.block_count_pair(*_on(cuda, *args), stride, variant, 7), want)


@pytest.mark.parametrize("mode", ["onehot", "slice"])
@pytest.mark.parametrize("R", [1024, 128])
@pytest.mark.parametrize("E", [0, 1, 2, 4])
def test_cuda_block_count_emit_docids_matches_plain(cuda, E, R, mode):
    h, d = _table(64, 63)
    blk, q = _lookups(h, 64, 5000, 64)
    args = (_t(_interleave(h, d, R)), _t(blk), _t(q))
    want = port.block_count_emit_docids_plain(*args, E, R, mode)
    _same(port.block_count_emit_docids(*_on(cuda, *args), E, R, mode), want)


def _pair_kernels(design):
    """K3 as the wrapper launches it, or one of its designs not taken."""
    if design == "kernel":
        return port.block_count_pair
    from acoustid_index_tpu_torch import measure

    return lambda *a: measure.design_pair(design, *a)


def _emit_kernels(design):
    if design == "kernel":
        return port.block_count_emit_docids
    from acoustid_index_tpu_torch import measure

    return lambda *a: measure.design_emit_docids(design, *a)


@pytest.mark.parametrize("variant", ["full", "oneblock", "noreduce", "empty"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("design", PAIR_SCHEDULES)
def test_cuda_pair_designs_match_plain(cuda, design, stride, variant):
    """K3's designs not taken (thread11, every sector arity), from
    the designs library, on test_cuda_block_count_pair_matches_plain's inputs."""
    h, d, blk0, blk1, q = _pair_inputs(nblk=64, L=5000, seed=61)
    table = _t(h if stride == 1 else _interleave(h, d, 1024))
    args = (table, _t(blk0), _t(blk1), _t(q))
    want = port.block_count_pair_plain(*args, stride, variant, 7)
    _same(_pair_kernels(design)(*_on(cuda, *args), stride, variant, 7), want)


@pytest.mark.parametrize("mode", ["onehot", "slice"])
@pytest.mark.parametrize("R", [1024, 128])
@pytest.mark.parametrize("design", EMIT_SCHEDULES)
def test_cuda_emit_docids_designs_match_plain(cuda, design, R, mode):
    """K4's designs not taken at E = 0..4, on test_cuda_block_count_emit_docids_matches_plain's inputs."""
    h, d = _table(64, 63)
    blk, q = _lookups(h, 64, 5000, 64)
    args = (_t(_interleave(h, d, R)), _t(blk), _t(q))
    for E in range(5):
        want = port.block_count_emit_docids_plain(*args, E, R, mode)
        _same(_emit_kernels(design)(*_on(cuda, *args), E, R, mode), want)


@pytest.mark.parametrize("design", ("kernel",) + EMIT_SCHEDULES)
def test_cuda_adversarial_blocks_match_plain(cuda, design):
    """K3 (every variant, strides 1 and 2) and K4 (E = 0..4, both layouts
    and modes) and their designs on the adversarial blocks: runs across
    sector and 128-entry boundaries, a block all equal, q = 0, 2^31 and
    0xFFFFFFFF, hashes >= 2^31, lt = 1024 with E = 4."""
    h, d = _adversarial_table()
    blk0, blk1, q = _adversarial_queries(h)
    for stride in (1, 2):
        args = (_t(h if stride == 1 else _interleave(h, d, 1024)), _t(blk0), _t(blk1), _t(q))
        for variant in port.PAIR_VARIANTS:
            want = port.block_count_pair_plain(*args, stride, variant, 8)
            _same(_pair_kernels(design.removesuffix("lazy"))(*_on(cuda, *args), stride, variant, 8), want)
    for R in (1024, 128):
        args = (_t(_interleave(h, d, R)), _t(blk0), _t(q))
        for mode in ("onehot", "slice"):
            for E in range(5):
                want = port.block_count_emit_docids_plain(*args, E, R, mode)
                _same(_emit_kernels(design)(*_on(cuda, *args), E, R, mode), want)


@pytest.mark.parametrize("g,nbuf", [(g, n) for g in port.STAGED_G for n in port.STAGED_NBUF if port.staged_fits(g, n)])
def test_cuda_block_count_staged_matches_plain(cuda, g, nbuf):
    """Every template, on a table whose blocks are not sorted, with a
    ragged last wave (L not a multiple of G)."""
    rng = np.random.default_rng(65)
    h = rng.integers(0, 1 << 12, 64 * BLOCK, dtype=np.uint32)
    h[::97] = 0xFFFFFFFF
    blk = rng.integers(0, 64, 5003).astype(np.int32)
    q = h[blk.astype(np.int64) * BLOCK + rng.integers(0, BLOCK, 5003)]
    q[::5] = rng.integers(0, 1 << 32, q[::5].shape[0], dtype=np.uint32)
    args = (_t(h), _t(blk), _t(q))
    want = port.block_count_staged_plain(*args)
    _same(port.block_count_staged(*_on(cuda, *args), g, nbuf), want)
