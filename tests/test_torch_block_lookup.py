"""The port's block-lookup layer against the JAX package, exactly.

Same numpy inputs (fixed seeds) go through the reference's Pallas kernels
(interpret mode on the CPU, called directly as tests/test_wave_lookup.py
does; block_lookup_resident in both its unmasked and its masked mode) and through the port's kernel wrappers, which on CPU tensors run
their plain PyTorch versions; then through both packages' range phases
(tier_ranges_blocked with emit on and off, tier_ranges_resident,
mention_lookup_blocked) on the cases of tests/test_blocked_lookup.py.
Every output is an integer or a flag: the tolerance is 0 (exact equality).

K1 and K2 search each block on the card (one thread per lookup, a
branch-free binary search to each bound), which is exact only over blocks
that are non-decreasing as u32.  A numpy model of that probe schedule, and
of the two designs measure.py times beside it (an 8-lane 8-ary group, a
warp-wide 32-ary search), is held equal to the plain versions on
hypothesis-made sorted blocks and on edge-case tables; a search through an
`Index` on the CPU checks that every table the port hands K1/K2 while
serving is sorted within each block, and the CHECK_SORTED hook that the
serving-path tests set is checked to refuse an unsorted one.  The range
phase is checked to convert a call's queries to int32 once.

The CUDA kernels themselves are compared with their plain versions by the
`test_cuda_*` cases, which need a card and skip without one
(`python -m pytest tests/test_torch_block_lookup.py -k cuda` on the card).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from acoustid_index_tpu.ops import layout as ref_layout
from acoustid_index_tpu.ops import pallas_lookup as ref
from acoustid_index_tpu_torch.ops import block_lookup as port
from acoustid_index_tpu_torch.ops import layout as port_layout

os.environ.setdefault("AITPU_TORCH_DEVICE", "cpu")

BLOCK = ref.BLOCK
ROWS = ref.ROWS

# The reference kernels' lookups-per-grid-step knobs: results do not depend
# on them, but interpret mode unrolls G kernel bodies per step, and small G
# keeps the reference side of these tests fast.
SMALL_G = {"AITPU_LOOKUP_G": "8", "AITPU_EMIT_G": "8", "AITPU_RESIDENT_G": "8", "AITPU_WAVE_G": "8"}


@pytest.fixture(autouse=True)
def _small_interpret_steps(monkeypatch):
    for k, v in SMALL_G.items():
        monkeypatch.setenv(k, v)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; u32 arrays as int32 storage of the same bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 and x.ndim == 3 else x


def _table(nblk: int, seed: int = 3):
    """Sorted hashes with an equal run forced across the block 1/2 boundary."""
    rng = np.random.default_rng(seed)
    hashes = np.sort(rng.integers(0, 1 << 20, nblk * BLOCK, dtype=np.uint32))
    if nblk >= 3:
        hashes[BLOCK * 2 - 7 : BLOCK * 2 + 9] = hashes[BLOCK * 2]
        hashes = np.sort(hashes)
    docids = rng.integers(1, 1 << 30, nblk * BLOCK, dtype=np.uint32)
    return hashes, docids


def _lookups(hashes, nblk, L, seed):
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, nblk, L).astype(np.int32)
    blk[: L // 8] = 0  # dead-lookup shape: constant block-0 runs
    q = rng.choice(hashes, L).astype(np.uint32)
    q[1::7] = rng.integers(0, 1 << 20, len(q[1::7]), dtype=np.uint32)  # misses
    q[2::11] = 0xFFFFFFFF  # sentinel-valued queries
    return blk, q


# ---- layout helpers are the reference's ----


@pytest.mark.parametrize("cap", [1024, 64 * 1024, 96 * 1024, 1 << 22])
@pytest.mark.parametrize("budget", [64 * 1024, 6 << 20])
def test_layout_rule_matches_reference(cap, budget):
    assert port_layout.BLOCK == ref_layout.BLOCK
    assert port_layout.use_interleaved(cap, budget) == ref_layout.use_interleaved(cap, budget)


def test_interleave_matches_reference():
    hashes, docids = _table(4, seed=1)
    np.testing.assert_array_equal(
        port_layout.interleave_np(hashes, docids), ref_layout.interleave_np(hashes, docids)
    )


# ---- kernel contracts (K1, K2) vs the reference's Pallas kernels ----


@pytest.mark.parametrize("stride,L", [(1, 64), (1, 192), (1, 1024), (2, 128), (2, 256)])
def test_block_count_matches_wave(stride, L):
    nblk = 8
    hashes, docids = _table(nblk)
    blk, q = _lookups(hashes, nblk, L, seed=11 + L)
    table = hashes if stride == 1 else ref_layout.interleave_np(hashes, docids)
    lo_r, eq_r = jax.jit(lambda t, b, qq: ref.block_lookup_wave(t, b, qq, stride=stride))(
        jnp.asarray(table), jnp.asarray(blk), jnp.asarray(q)
    )
    lo_p, eq_p = port.block_lookup_wave(_t(table), _t(blk), _t(q), stride=stride)
    np.testing.assert_array_equal(_np(lo_p), np.asarray(lo_r))
    np.testing.assert_array_equal(_np(eq_p), np.asarray(eq_r))


@pytest.mark.parametrize("stride", [1, 2])
def test_block_count_matches_grid_kernel(stride):
    nblk = 5
    hashes, docids = _table(nblk, seed=21)
    blk, q = _lookups(hashes, nblk, 256, seed=8)
    table = hashes if stride == 1 else ref_layout.interleave_np(hashes, docids)
    lo_r, eq_r = jax.jit(lambda t, b, qq: ref.block_lookup(t, b, qq, stride=stride))(
        jnp.asarray(table), jnp.asarray(blk), jnp.asarray(q)
    )
    lo_p, eq_p = port.block_lookup(_t(table), _t(blk), _t(q), stride=stride)
    np.testing.assert_array_equal(_np(lo_p), np.asarray(lo_r))
    np.testing.assert_array_equal(_np(eq_p), np.asarray(eq_r))


@pytest.mark.parametrize("kernel", ["emit_wave", "emit"])
@pytest.mark.parametrize("L", [64, 256])
def test_block_count_emit_matches_reference(kernel, L):
    nblk = 6
    hashes, docids = _table(nblk, seed=9)
    inter = ref_layout.interleave_np(hashes, docids)
    blk, q = _lookups(hashes, nblk, L, seed=4 + L)
    fn = ref.block_lookup_emit_wave if kernel == "emit_wave" else ref.block_lookup_emit
    lo_r, cnt_r, rows_r = jax.jit(fn)(jnp.asarray(inter), jnp.asarray(blk), jnp.asarray(q))
    lo_p, cnt_p, rows_p = port.block_lookup_emit_wave(_t(inter), _t(blk), _t(q))
    np.testing.assert_array_equal(_np(lo_p), np.asarray(lo_r))
    np.testing.assert_array_equal(_np(cnt_p), np.asarray(cnt_r))
    np.testing.assert_array_equal(_np(rows_p), np.asarray(rows_r))


@pytest.mark.parametrize("L", [128, 700])
def test_block_count_matches_resident(L):
    nblk = 4
    hashes, _ = _table(nblk, seed=5)
    blk, q = _lookups(hashes, nblk, L, seed=17)
    lt_r, eq_r = jax.jit(ref.block_lookup_resident)(jnp.asarray(hashes), jnp.asarray(blk), jnp.asarray(q))
    lt_p, eq_p = port.block_lookup_resident(_t(hashes), _t(blk), _t(q))
    np.testing.assert_array_equal(_np(lt_p), np.asarray(lt_r))
    np.testing.assert_array_equal(_np(eq_p), np.asarray(eq_r))


def _masked_case(L, seed):
    """A top index that concatenates three sorted runs (a multi-segment
    tier's) plus sentinel padding, and per-lookup [lo_b, hi_b) spans: one
    run, several runs across their bounds, empty (lo == hi and lo > hi), and
    spans over the padding; sentinel queries among them."""
    rng = np.random.default_rng(seed)
    lens = (1500, 2100, 500)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    runs = [np.sort(rng.integers(0, 1 << 16, n, dtype=np.uint32)) for n in lens]
    runs[1][:40] = runs[0][-1]  # equal hashes on both sides of a run bound
    nblk = -(-int(bounds[-1]) // BLOCK) + 1
    table = np.full(nblk * BLOCK, 0xFFFFFFFF, np.uint32)
    table[: bounds[-1]] = np.concatenate(runs)
    kind = rng.integers(0, 4, L)
    seg = rng.integers(0, 3, L)
    lo = bounds[seg].copy()
    hi = bounds[seg + 1].copy()
    cross = kind == 1  # from inside one run to inside a later one
    lo[cross] = rng.integers(0, bounds[1], cross.sum())
    hi[cross] = rng.integers(bounds[2], bounds[3] + 1, cross.sum())
    empty = kind == 2
    lo[empty] = rng.integers(0, table.shape[0], empty.sum())
    hi[empty] = lo[empty] - rng.integers(0, 2, empty.sum())
    pad = kind == 3  # over the sentinel padding
    lo[pad] = rng.integers(bounds[2], bounds[3], pad.sum())
    hi[pad] = table.shape[0]
    blk = np.clip(lo // BLOCK + rng.integers(-1, 2, L), 0, nblk - 1).astype(np.int32)
    q = table[np.clip(lo + rng.integers(0, 64, L), 0, table.shape[0] - 1)].copy()
    q[1::5] = rng.integers(0, 1 << 16, len(q[1::5]), dtype=np.uint32)
    q[3::7] = 0xFFFFFFFF
    return table, blk, q, lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("L", [128, 700])
def test_block_count_masked_matches_resident(L):
    table, blk, q, lo, hi = _masked_case(L, seed=L)
    args = [jnp.asarray(a) for a in (table, blk, q, lo, hi)]
    lt_r, eq_r = jax.jit(ref.block_lookup_resident)(*args)
    lt_p, eq_p = port.block_lookup_resident(_t(table), _t(blk), _t(q), _t(lo), _t(hi))
    np.testing.assert_array_equal(_np(lt_p), np.asarray(lt_r))
    np.testing.assert_array_equal(_np(eq_p), np.asarray(eq_r))
    # The mask matters: unmasked counts differ wherever a span cuts a block.
    lt_u, _ = port.block_lookup_resident(_t(table), _t(blk), _t(q))
    assert (lt_u.numpy() != lt_p.numpy()).any()
    assert (eq_p.numpy()[hi <= lo] == 0).all() and (lt_p.numpy()[hi <= lo] == 0).all()


# ---- K1/K2's search over sorted blocks: a numpy model of the schedule ----

def _search_model(blocks: np.ndarray, q: np.ndarray):
    """(lt, ub) of q[j] in the sorted block blocks[j] as the kernels'
    thread_search computes them: per bound, a probe at b + half - 1 for
    half = 512, 256, ..., 1 moves b up by half when the entry is below the
    bound (< q for lt, <= q for ub); one last compare at b settles it."""
    rows = np.arange(blocks.shape[0])
    q = q.astype(np.uint32)
    out = []
    for below in (lambda x: x < q, lambda x: x <= q):  # lower bound, upper bound
        b = np.zeros(blocks.shape[0], np.int64)
        half = BLOCK // 2
        while half:
            b += np.where(below(blocks[rows, b + half - 1]), half, 0)
            half //= 2
        out.append(b + below(blocks[rows, b]))
    return out[0], out[1]


def _runs_block(values, cuts) -> np.ndarray:
    """A sorted block of equal-value runs: sorted `values`, run i ending at
    sorted `cuts`[i] (the last run ends at BLOCK)."""
    bounds = [0] + sorted(cuts) + [BLOCK]
    block = np.empty(BLOCK, np.uint32)
    for v, a, b in zip(sorted(values), bounds[:-1], bounds[1:]):
        block[a:b] = v
    return block


def _edge_blocks():
    """Sorted blocks at the search's edges: all-equal blocks; runs that
    cross slice edges at every level (16, 128) and a run over seven of the
    eight top slices; values on both sides of 2^31; data then 0xFFFFFFFF
    padding, and a block of padding only."""
    ramp = np.arange(BLOCK, dtype=np.uint32) * 3 + 100
    blocks = [np.full(BLOCK, v, np.uint32) for v in (0, 5, 1 << 31, 0xFFFFFFFF)]
    for a, b in ((15, 17), (127, 129), (120, 136), (112, 144), (1, 1024), (0, 1023), (1008, 1024), (0, 16), (64, 960)):
        blk = ramp.copy()
        blk[a:b] = blk[a]
        blocks.append(np.sort(blk))
    blocks.append((np.arange(BLOCK, dtype=np.int64) - 512 + (1 << 31)).astype(np.uint32))  # across 2^31
    blocks.append(np.sort(np.r_[np.full(900, 0x7FFFFFFF, np.uint32), np.full(124, 0x80000000, np.uint32)]))
    pad = ramp.copy()
    pad[700:] = 0xFFFFFFFF
    blocks.append(pad)
    blocks.append(np.r_[np.full(1000, 7, np.uint32), np.full(24, 0xFFFFFFFF, np.uint32)])
    return np.stack(blocks)


def _queries_for(blocks: np.ndarray, rng) -> tuple:
    """(blk, q): every distinct value of each block, each value +- 1, 0,
    0xFFFFFFFF and a few random u32s, asked of that block."""
    blk, q = [], []
    for b, block in enumerate(blocks):
        v = np.unique(block).astype(np.int64)
        cand = np.unique(np.r_[v, v - 1, v + 1, 0, 0xFFFFFFFF, rng.integers(0, 1 << 32, 4)])
        cand = cand[(cand >= 0) & (cand <= 0xFFFFFFFF)].astype(np.uint32)
        blk.append(np.full(cand.shape[0], b, np.int32))
        q.append(cand)
    return np.concatenate(blk), np.concatenate(q)


def _kary_model(blocks: np.ndarray, q: np.ndarray, slices, last: int):
    """(lt, ub) of q[j] in the sorted block blocks[j] as the k-ary designs
    of csrc/block_lookup_designs.cu compute them: per bound, for each slice
    width w in `slices` the lanes read the first entry of every w-entry
    slice of the current window, and the bound's slice is the last one
    whose first entry is below the bound (the first slice when none is);
    then the window's `last` entries are counted.  group8 is slices (128,
    16) and last 16; warp32 is slices (32,) and last 32."""
    rows = np.arange(blocks.shape[0])[:, None]
    q = q.astype(np.uint32)[:, None]
    out = []
    for below in (lambda x: x < q, lambda x: x <= q):  # lower bound, upper bound
        b = np.zeros((blocks.shape[0], 1), np.int64)
        span = BLOCK
        for w in slices:
            n_below = below(blocks[rows, b + np.arange(0, span, w)]).sum(1, keepdims=True)
            b += np.maximum(n_below - 1, 0) * w
            span = w
        out.append((b + below(blocks[rows, b + np.arange(last)]).sum(1, keepdims=True))[:, 0])
    return out[0], out[1]


MODELS = {
    "thread": _search_model,
    "group8": lambda blocks, q: _kary_model(blocks, q, (128, 16), 16),
    "warp32": lambda blocks, q: _kary_model(blocks, q, (32,), 32),
}


def _check_model(blocks: np.ndarray, blk: np.ndarray, q: np.ndarray, stride: int, model=_search_model) -> None:
    """The model's (lt, eq) equal block_count_plain's at `stride`, and its
    rows (from the model's lt) equal block_count_emit_plain's."""
    docids = np.random.default_rng(0).integers(1, 1 << 31, blocks.size, dtype=np.uint32)
    hashes = blocks.reshape(-1)
    table = hashes if stride == 1 else ref_layout.interleave_np(hashes, docids)
    lt_m, ub_m = model(blocks[blk], q)
    lt_p, eq_p = port.block_count_plain(_t(table), _t(blk), _t(q), stride=stride)
    np.testing.assert_array_equal(lt_m, lt_p.numpy())
    np.testing.assert_array_equal(ub_m - lt_m, eq_p.numpy())
    if stride == 2:
        _, _, rows_p = port.block_count_emit_plain(_t(table), _t(blk), _t(q))
        d = docids.reshape(-1, ROWS, 128)[blk]
        r = np.minimum(lt_m >> 7, ROWS - 1)
        r2 = np.minimum(r + 1, ROWS - 1)
        ar = np.arange(blk.shape[0])
        np.testing.assert_array_equal(np.stack([d[ar, r], d[ar, r2]], 1), _np(rows_p))


@pytest.mark.parametrize("stride", [1, 2])
def test_search_model_matches_plain_on_edge_blocks(stride):
    blocks = _edge_blocks()
    blk, q = _queries_for(blocks, np.random.default_rng(1))
    _check_model(blocks, blk, q, stride)
    lt, ub = _search_model(blocks[blk], q)
    whole = (blk == 1) & (q == 5)  # a run over the whole block
    assert (lt[whole] == 0).all() and (ub[whole] == BLOCK).all()
    pad = (blk == 3) & (q == 0xFFFFFFFF)  # 0xFFFFFFFF over a block of padding
    assert (lt[pad] == 0).all() and (ub[pad] == BLOCK).all()


_U32 = st.one_of(
    st.integers(0, 0xFFFFFFFF),
    st.sampled_from([0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, 0xFFFFFFFE, 0xFFFFFFFF]),
)
# Run ends at and around every 16-entry edge (and so every 128-entry one).
_CUT = st.one_of(
    st.integers(0, BLOCK),
    st.sampled_from(sorted({e + d for e in range(0, BLOCK + 1, 16) for d in (-1, 0, 1) if 0 <= e + d <= BLOCK})),
)


@st.composite
def _sorted_blocks(draw):
    blocks = []
    for _ in range(draw(st.integers(1, 3))):
        k = draw(st.integers(1, 10))
        blocks.append(_runs_block(draw(st.lists(_U32, min_size=k, max_size=k)),
                                  draw(st.lists(_CUT, min_size=k - 1, max_size=k - 1))))
    return np.stack(blocks)


@pytest.mark.parametrize("stride", [1, 2])
@settings(max_examples=60, deadline=None)
@given(blocks=_sorted_blocks(), seed=st.integers(0, 2**16))
def test_search_model_matches_plain(stride, blocks, seed):
    blk, q = _queries_for(blocks, np.random.default_rng(seed))
    _check_model(blocks, blk, q, stride)


# The designs K1 and K2 did not take (csrc/block_lookup_designs.cu, timed
# against the committed ones by measure.py): their probe schedules too.


@pytest.mark.parametrize("design", ["group8", "warp32"])
def test_design_model_matches_plain_on_edge_blocks(design):
    blocks = _edge_blocks()
    blk, q = _queries_for(blocks, np.random.default_rng(2))
    _check_model(blocks, blk, q, 2, MODELS[design])


@pytest.mark.parametrize("design", ["group8", "warp32"])
@settings(max_examples=40, deadline=None)
@given(blocks=_sorted_blocks(), seed=st.integers(0, 2**16))
def test_design_model_matches_plain(design, blocks, seed):
    blk, q = _queries_for(blocks, np.random.default_rng(seed))
    _check_model(blocks, blk, q, 2, MODELS[design])


@pytest.mark.parametrize("kernel", ["block_count", "block_count_emit"])
def test_check_sorted_hook_rejects_unsorted_block(kernel, monkeypatch):
    """With CHECK_SORTED set, K1's and K2's wrappers refuse a looked-up
    block that is not non-decreasing as u32 (0xFFFFFFFF before 0 is out of
    order; as signed int32 it would not be), and pass a sorted one."""
    hashes, docids = _table(4, seed=9)
    bad = hashes.copy()
    bad[2 * BLOCK + 5], bad[2 * BLOCK + 6] = 0xFFFFFFFF, 0
    blk, q = np.array([0, 2, 3], np.int32), np.array([5, 6, 7], np.uint32)

    def call(h):
        if kernel == "block_count":
            return port.block_count(_t(h), _t(blk), _t(q))
        return port.block_count_emit(_t(ref_layout.interleave_np(h, docids)), _t(blk), _t(q))

    plain_bad = call(bad)  # off by default: the plain version counts any block
    monkeypatch.setattr(port, "CHECK_SORTED", True)
    call(hashes)
    with pytest.raises(AssertionError, match="block 2 of"):
        call(bad)
    port.block_count(_t(bad), _t(blk[[0, 2]]), _t(q[[0, 2]]))  # the table's sorted blocks pass
    np.testing.assert_array_equal(plain_bad[0].numpy(), port.block_count_plain(_t(bad), _t(blk), _t(q))[0].numpy())


def test_to_storage_keeps_low_32_bits():
    x = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32, -1, (5 << 32) + 7], np.int64)
    got = port_layout.to_storage(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("path", ["blocked", "blocked_emit", "resident", "mention"])
def test_range_phase_converts_queries_once(path, monkeypatch):
    """Each range-phase call converts its int64 queries to the kernels'
    int32 format once and hands that copy to every K1/K2 call it makes."""
    conversions, handed = [], []
    to_storage = port.to_storage
    monkeypatch.setattr(port, "to_storage", lambda x: conversions.append(x.dtype) or to_storage(x))
    k1, k2 = port.block_count, port.block_count_emit
    monkeypatch.setattr(port, "block_count", lambda t, b, q, stride=1: handed.append(q.dtype) or k1(t, b, q, stride))
    monkeypatch.setattr(port, "block_count_emit", lambda t, b, q: handed.append(q.dtype) or k2(t, b, q))
    if path == "mention":
        monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(16 * 1024))  # resident top index + block lookup
        ids = np.arange(1, 12289, 2, dtype=np.uint32)
        tier = {"mention_ids": _t(ids), "mention_len": torch.tensor(ids.shape[0], dtype=torch.int32)}
        port.mention_lookup_blocked(tier, torch.tensor([1, 3, 4, 0xFFFFFFFF], dtype=torch.int64))
        kernel_calls = 2
    else:
        hashes, queries = _many_straddlers()
        _, port_tier, _ = _tiers(hashes, [hashes.shape[0]], "plain" if path == "resident" else "inter")
        q = torch.tensor([queries * 2], dtype=torch.int64)
        valid = torch.ones_like(q, dtype=torch.bool)
        if path == "resident":
            port.tier_ranges_resident(port_tier, q, valid, 1024)
        else:
            port.tier_ranges_blocked(port_tier, q, valid, 1024, emit=path == "blocked_emit")
        kernel_calls = 1 if path == "resident" else 2
    assert conversions == [torch.int64]
    assert handed == [torch.int32] * kernel_calls


def test_serving_hands_k1_k2_sorted_blocks(tmp_path, monkeypatch):
    """Every table K1 and K2 get while an Index serves on the CPU -- a
    two-segment interleaved file tier, a live memory tier of inserts,
    re-inserts and deletes, its mention table -- is non-decreasing as u32
    within each block: the kernels' precondition."""
    from acoustid_index_tpu_torch.engine import model
    from acoustid_index_tpu_torch.engine.index import Index
    from acoustid_index_tpu_torch.engine.searcher import Searcher

    # The blocked + interleaved layout for a test-sized file tier (the
    # tests of test_torch_search_kernel.py force it the same way).
    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(64 * 1024))
    seen = []

    def record(name, table, stride):
        blocks = table.numpy().view(np.uint32).reshape(-1, stride * BLOCK)[:, :BLOCK]
        seen.append((name, table.shape[0], stride, bool((np.diff(blocks.astype(np.int64), axis=1) >= 0).all())))

    k1, k2 = port.block_count, port.block_count_emit

    def block_count(table, blk, q, stride=1):
        record("K1", table, stride)
        return k1(table, blk, q, stride)

    def block_count_emit(inter, blk, q):
        record("K2", inter, 2)
        return k2(inter, blk, q)

    monkeypatch.setattr(port, "block_count", block_count)
    monkeypatch.setattr(port, "block_count_emit", block_count_emit)

    rng = np.random.default_rng(5)
    docs = {i: rng.integers(0, 1 << 32, 24, dtype=np.uint32).tolist() for i in range(1, 3201)}
    index = Index.open(str(tmp_path), checkpoint_age=None, sync=False, searcher=Searcher("cpu"))
    try:
        for lo, hi in ((1, 1601), (1601, 3201)):  # two file segments
            index.update([model.Insert(id=i, hashes=docs[i]) for i in range(lo, hi)])
            assert index.checkpoint(force=True)
    finally:
        index.close()
    # Reopened with a new searcher, whose memory tier starts small (a
    # searcher keeps each tier's largest capacity): the resident path.
    index = Index.open(str(tmp_path), checkpoint_age=None, sync=False, searcher=Searcher("cpu"))
    try:
        mem_docs = {i: rng.integers(0, 1 << 32, 2, dtype=np.uint32).tolist() for i in range(10_001, 14_301)}
        re_ids = [int(i) for i in rng.choice(np.arange(1, 3201), 50, replace=False)]
        for i in re_ids:
            mem_docs[i] = rng.integers(0, 1 << 32, 24, dtype=np.uint32).tolist()
        del_ids = [i for i in range(3, 3201, 80) if i not in mem_docs]
        index.update([model.Insert(id=i, hashes=h) for i, h in mem_docs.items()] + [model.Delete(id=i) for i in del_ids])
        snap = index.ensure_views(index.acquire_reader())
        assert len(snap.file) == 2 and snap.memory and "inter" in snap.file_view

        opts = model.SearchOptions(max_results=10, min_score=2, min_score_pct=10)
        targets = [1, 777, 1600, 1601, 3200] + re_ids[:3] + del_ids[:3] + [10_001, 14_300]
        for d in targets:
            h = (mem_docs.get(d) or docs[d])[:15]
            noise = rng.integers(0, 1 << 32, 5, dtype=np.uint32).tolist()
            results, _ = index.search(h + noise, opts)
            if d not in del_ids and len(h) >= 2:
                assert results and results[0].id == d
    finally:
        index.close()

    assert all(ok for *_, ok in seen), [s for s in seen if not s[-1]]
    assert any(name == "K2" for name, *_ in seen)
    # K1 over the file tier's top index, the memory tier and its mention table.
    assert len({n for name, n, *_ in seen if name == "K1"}) >= 3, seen


# ---- range phase: tier_ranges_blocked on the cases of test_blocked_lookup ----


def _tiers(hashes: np.ndarray, seg_lens, layout: str, seed: int = 0):
    """(reference tier, port tier) over one merged sorted run, padded like
    tests/test_blocked_lookup.make_tier; layout "plain" or "inter"."""
    n = hashes.shape[0]
    cap = BLOCK
    while cap < n:
        cap *= 2
    h = np.full(cap, 0xFFFFFFFF, np.uint32)
    h[:n] = hashes
    d = np.full(cap, 0xFFFFFFFF, np.uint32)
    d[:n] = np.random.default_rng(seed).integers(1, 1 << 31, n, dtype=np.uint32)
    view = {
        "block_index": np.ascontiguousarray(h[::BLOCK]),
        "seg_start": np.zeros(len(seg_lens), np.int32),
        "seg_len": np.asarray(seg_lens, np.int32),
    }
    if layout == "inter":
        view["inter"] = ref_layout.interleave_np(h, d)
    else:
        view["hashes"], view["docids"] = h, d
    return {k: jnp.asarray(v) for k, v in view.items()}, {k: _t(v) for k, v in view.items()}, h


def _straddle_run(run_start, run_len):
    H = 1_000_000
    n = 4 * BLOCK
    hashes = np.arange(n, dtype=np.uint32)
    hashes[run_start : run_start + run_len] = H
    hashes[run_start + run_len :] = np.arange(H + 1, H + 1 + (n - run_start - run_len), dtype=np.uint32)
    return np.sort(hashes), [H]


def _long_run():
    H = 5_000
    hashes = np.full(6 * BLOCK, H, np.uint32)
    hashes[: BLOCK // 2] = np.arange(BLOCK // 2, dtype=np.uint32)
    return hashes, [H, 7]


def _absent_and_sentinel():
    hashes = np.sort(np.random.default_rng(0).integers(10, 2**31, 3 * BLOCK, dtype=np.uint32))
    return hashes, [5, 0xFFFFFFFF, int(hashes[100]), int(hashes[-1])]


def _many_straddlers():
    hashes = np.arange(6 * BLOCK, dtype=np.uint32) * 3
    straddlers = []
    for b in range(1, 6):
        v = hashes[b * BLOCK]
        hashes[b * BLOCK - 2 : b * BLOCK + 2] = v
        straddlers.append(int(v))
    return hashes, straddlers


CASES = {
    "straddle_0_1": lambda: _straddle_run(BLOCK - 4, 11),
    "run_at_boundary": lambda: _straddle_run(BLOCK, 7),
    "minimal_straddle": lambda: _straddle_run(BLOCK - 1, 2),
    "inside_block": lambda: _straddle_run(500, 5),
    "later_boundary": lambda: _straddle_run(2 * BLOCK - 3, 6),
    "long_run_truncates": _long_run,
    "absent_and_sentinel": _absent_and_sentinel,
    "many_straddlers": _many_straddlers,
    "window_cap_overflow": _many_straddlers,  # run with AITPU_WINDOW_CAP=1
}


def _run_blocked(ref_tier, port_tier, queries, emit, cap_k=2048, B=2, Q=64):
    """The same (B, Q) batch through both packages: row 0 holds the
    queries, row 1 a shifted copy with fewer valid lanes."""
    q = np.zeros((B, Q), np.uint32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        row = list(queries)[b % len(queries) :] + list(queries)[: b % len(queries)]
        row = row[: max(1, len(row) - b)]
        q[b, : len(row)] = row
        lens[b] = len(row)
    valid = np.arange(Q)[None, :] < lens[:, None]
    out_r = ref.tier_ranges_blocked(ref_tier, jnp.asarray(q), jnp.asarray(valid), cap_k, emit=emit)
    out_p = port.tier_ranges_blocked(
        port_tier, torch.from_numpy(q.astype(np.int64)), torch.from_numpy(valid), cap_k, emit=emit
    )
    assert len(out_r) == len(out_p)
    for a, b in zip(out_r, out_p):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    return out_p


@pytest.mark.parametrize("layout,emit", [("plain", False), ("inter", False), ("inter", True)])
@pytest.mark.parametrize("case", list(CASES))
def test_tier_ranges_blocked_matches_reference(case, layout, emit, monkeypatch):
    if case == "window_cap_overflow":
        monkeypatch.setenv("AITPU_WINDOW_CAP", "1")
    hashes, queries = CASES[case]()
    ref_tier, port_tier, h = _tiers(hashes, [hashes.shape[0]], layout)
    out = _run_blocked(ref_tier, port_tier, queries, emit)
    lo, cnt, trunc = out[0][0].numpy(), out[1][0].numpy(), bool(out[2])
    for i, hq in enumerate(queries):  # sane ranges: only equal postings
        assert np.all(h[lo[i] : lo[i] + cnt[i]] == hq)
    if case in ("long_run_truncates", "window_cap_overflow"):
        assert trunc
    elif case != "absent_and_sentinel":
        assert not trunc


@pytest.mark.parametrize("layout,emit", [("plain", False), ("inter", True)])
def test_multisegment_merged_run_matches_reference(layout, emit):
    rng = np.random.default_rng(11)
    n0, n1 = 60_000, 70_000
    h0 = np.sort(rng.integers(0, 2**20, n0, dtype=np.uint32))
    h1 = np.sort(rng.integers(2**21, 2**22, n1, dtype=np.uint32))
    straddle_vals = []
    for k in (1, 5, 40):
        p = k * BLOCK
        h1[p - 2 : p + 2] = h1[p]
        straddle_vals.append(int(h1[p]))
    merged = np.sort(np.concatenate([h0, np.sort(h1)]))
    ref_tier, port_tier, _ = _tiers(merged, [n0, n1], layout, seed=3)
    queries = straddle_vals + [int(h0[0]), int(h0[-1]), int(h1[0]), int(h1[-1]), int(h0[1234]), 5, 0xFFFFFFFE]
    out = _run_blocked(ref_tier, port_tier, queries, emit)
    assert not bool(out[2])


# ---- tier_ranges_resident and mention_lookup_blocked ----


@pytest.mark.parametrize("case", ["straddlers", "long_run"])
def test_tier_ranges_resident_matches_reference(case):
    if case == "straddlers":
        hashes, queries = _many_straddlers()
    else:
        hashes = np.sort(np.concatenate([np.full(3 * BLOCK, 5_000, np.uint32), np.arange(3 * BLOCK, dtype=np.uint32)]))
        queries = [5_000, 3, 4_999, 0xFFFFFFFF]
    ref_tier, port_tier, _ = _tiers(hashes, [hashes.shape[0]], "plain")
    B, Q = 2, 16
    q = np.zeros((B, Q), np.uint32)
    q[:, : len(queries)] = queries
    valid = np.zeros((B, Q), bool)
    valid[0, : len(queries)] = True
    valid[1, :2] = True
    out_r = ref.tier_ranges_resident(ref_tier, jnp.asarray(q), jnp.asarray(valid), 1024)
    out_p = port.tier_ranges_resident(port_tier, torch.from_numpy(q.astype(np.int64)), torch.from_numpy(valid), 1024)
    for a, b in zip(out_r, out_p):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize(
    "budget,n_ids,cap",
    [
        (6 << 20, 6000, 8192),  # whole table resident
        (16 * 1024, 6000, 12288),  # table too big: resident top index + block lookup
        (16 * 1024, 300_000, 1 << 20),  # the same with an unpadded (strided) top index
        (1024, 300_000, 600_064),  # top index too big too: binary search + block lookup
    ],
)
def test_mention_lookup_matches_reference(budget, n_ids, cap, monkeypatch):
    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(budget))
    rng = np.random.default_rng(n_ids)
    ids = np.unique(rng.integers(1, 1 << 30, n_ids, dtype=np.uint32))
    table = np.full(cap, 0xFFFFFFFF, np.uint32)
    table[: ids.shape[0]] = ids
    cand = np.concatenate([rng.choice(ids, 200), rng.integers(0, 1 << 31, 56, dtype=np.uint32)]).astype(np.uint32)
    cand[::50] = 0xFFFFFFFF
    valid = rng.random(cand.shape[0]) < 0.8
    tier = {"mention_ids": table, "mention_len": np.int32(ids.shape[0])}
    got_r = ref.mention_lookup_blocked({k: jnp.asarray(v) for k, v in tier.items()}, jnp.asarray(cand), jnp.asarray(valid))
    got_p = port.mention_lookup_blocked(
        {k: _t(np.asarray(v)) for k, v in tier.items()}, torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(valid)
    )
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(got_r))
    assert got_p.numpy()[valid & np.isin(cand, ids)].all()


# ---- the CUDA kernels vs their plain versions (card only) ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_case(kind: str, seed: int):
    """(hashes, docids, blk, q) of a card test: "random" lookups over a
    sorted 64-block table, or "edges", every edge block with its queries."""
    if kind == "random":
        hashes, docids = _table(64, seed=seed)
        blk, q = _lookups(hashes, 64, 5000, seed=seed + 1)
        return hashes, docids, blk, q
    blocks = _edge_blocks()
    blk, q = _queries_for(blocks, np.random.default_rng(seed))
    docids = np.random.default_rng(seed).integers(1, 1 << 31, blocks.size, dtype=np.uint32)
    return blocks.reshape(-1), docids, blk, q


def _int64_queries(kernel):
    """`kernel` handed the queries as int64 u32 values (the wrapper converts)."""
    return lambda t, b, q, *a, **k: kernel(t, b, q.to(torch.int64) & 0xFFFFFFFF, *a, **k)


@pytest.mark.parametrize("variant", ["search", "search_int64_queries", "scan", "group8"])
@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_block_count_matches_plain(cuda, stride, kind, variant):
    from acoustid_index_tpu_torch import measure

    hashes, docids, blk, q = _cuda_case(kind, seed=2)
    table = hashes if stride == 1 else ref_layout.interleave_np(hashes, docids)
    args = (_t(table), _t(blk), _t(q))
    want = port.block_count_plain(*args, stride=stride)
    kernel = {
        "search": port.block_count,
        "search_int64_queries": _int64_queries(port.block_count),
        "scan": port.block_count_scan,
        "group8": lambda t, b, q, stride: measure.design_count("group8", t, b, q, stride),
    }[variant]
    got = kernel(*(a.to(cuda) for a in args), stride=stride)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("variant", ["search", "search_int64_queries", "scan", "group8", "warp32"])
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_cuda_block_count_emit_matches_plain(cuda, kind, variant):
    from acoustid_index_tpu_torch import measure

    hashes, docids, blk, q = _cuda_case(kind, seed=4)
    args = (_t(ref_layout.interleave_np(hashes, docids)), _t(blk), _t(q))
    want = port.block_count_emit_plain(*args)
    kernel = {
        "search": port.block_count_emit,
        "search_int64_queries": _int64_queries(port.block_count_emit),
        "scan": port.block_count_emit_scan,
        "group8": lambda t, b, q: measure.design_emit("group8", t, b, q),
        "warp32": lambda t, b, q: measure.design_emit("warp32", t, b, q),
    }[variant]
    got = kernel(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_cuda_block_count_masked_matches_plain(cuda):
    table, blk, q, lo, hi = _masked_case(5000, seed=6)
    args = (_t(table), _t(blk), _t(q), _t(lo), _t(hi))
    want = port.block_count_masked_plain(*args)
    got = port.block_count_masked(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
