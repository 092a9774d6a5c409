"""The port's block-lookup layer against the JAX package, exactly.

Same numpy inputs (fixed seeds) go through the reference's Pallas kernels
(interpret mode on the CPU, called directly as tests/test_wave_lookup.py
does; block_lookup_resident in both its unmasked and its masked mode) and through the port's kernel wrappers, which on CPU tensors run
their plain PyTorch versions; then through both packages' range phases
(tier_ranges_blocked with emit on and off, tier_ranges_resident,
mention_lookup_blocked) on the cases of tests/test_blocked_lookup.py.
Every output is an integer or a flag: the tolerance is 0 (exact equality).

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


@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_block_count_matches_plain(cuda, stride):
    nblk = 64
    hashes, docids = _table(nblk, seed=2)
    blk, q = _lookups(hashes, nblk, 5000, seed=3)
    table = hashes if stride == 1 else ref_layout.interleave_np(hashes, docids)
    args = (_t(table), _t(blk), _t(q))
    want = port.block_count_plain(*args, stride=stride)
    got = port.block_count(*(a.to(cuda) for a in args), stride=stride)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_cuda_block_count_emit_matches_plain(cuda):
    nblk = 64
    hashes, docids = _table(nblk, seed=4)
    blk, q = _lookups(hashes, nblk, 5000, seed=5)
    args = (_t(ref_layout.interleave_np(hashes, docids)), _t(blk), _t(q))
    want = port.block_count_emit_plain(*args)
    got = port.block_count_emit(*(a.to(cuda) for a in args))
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
