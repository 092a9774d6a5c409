"""A whole run on the CPU with the timed path broken underneath: `correct`
comes out false for each fault a cell can have, and true without one.
The control (the reference on half of each query's hashes) fails the
comparison at test size on three seeds."""

import time

import msgpack
import numpy as np
import pytest

from benchmark_torch import corpus, harness, reference, registry, traffic

from .conftest import small


def _patch_complete(front, edit):
    orig = front._complete

    def complete(name, tokens, out, out_words):
        out = np.array(out, dtype=np.uint32, copy=True)
        edit(out, (out_words - 5) // 2)
        return orig(name, tokens, out, out_words)

    front._complete = complete


def alter_answer(mi, front):
    """An answer altered where it is produced: the first row's best score."""
    _patch_complete(front, lambda out, ob: out.__setitem__((0, ob), out[0, ob] + 1))


def drop_half(mi, front):
    """Half of each batch left out: its rows come back empty."""
    _patch_complete(front, lambda out, ob: out.__setitem__((slice(len(out) // 2, None), 2 * ob), 0))


def ack_without_apply(mi, front):
    """A write acknowledged with the index left unchanged."""
    index = mi._get_ref("main").index
    mi._release_ref(mi._get_ref("main"))
    index.update = lambda changes, expected_version=None, version=None: index.version


@pytest.mark.parametrize("workload,fault,check", [
    ("fp10m.search", alter_answer, "wrong_answers"),
    ("fp10m.search", drop_half, "wrong_answers"),
    ("fp134m.search", alter_answer, "wrong_answers"),
    ("fp134m.search", drop_half, "wrong_answers"),
    ("fp10m.open", alter_answer, "wrong_answers"),
    ("fp10m.open", drop_half, "wrong_answers"),
    ("fp10m.rw", ack_without_apply, "wrong_readbacks"),
    ("fp10m.rw", drop_half, "wrong_answers"),
])
def test_a_broken_path_is_not_correct(manifest, workload, fault, check):
    cell = small(registry.cell(registry.with_pending(manifest), workload))
    out, _ = harness.run_cell(cell, 2**32 + 99, 2.0, False, time.time(), device="cpu", faults=fault)
    assert out["correct"] is False and out["checks"][check]["value"] > out["checks"][check]["limit"]


@pytest.mark.parametrize("workload", ["fp134m.search", "fp10m.open", "fp10m.rw"])
def test_sound_runs_are_correct(manifest, workload):
    m = registry.with_pending(manifest)
    assert registry.check_manifest(m) == []
    out, _ = harness.run_cell(small(registry.cell(m, workload)), 5, 2.0, False, time.time(), device="cpu")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {x["name"] for x in registry.cell(m, workload).end_to_end}


@pytest.mark.parametrize("config", ["fp10m", "fp134m"])
def test_the_control_is_not_correct(config):
    cfg = registry.load_config(config)
    spec = dict(cfg["corpus"], **({"docs": 20_000} if cfg["corpus"]["kind"] == "uniform" else {"doc_bits": 14}))
    for seed in (1, 2**31 + 5, 2**40 + 3):
        c = corpus.make(spec, seed)
        q = traffic.make_queries(c, cfg["query"], 512, seed)
        args = (q.hashes, q.limit, q.min_score, q.pct)
        want = reference.search([c], *args)
        records = {i: (200, msgpack.packb({"r": [{"i": d, "s": s} for d, s in a]}))
                   for i, a in enumerate(reference.search([c], *args, control=True))}
        assert harness.compare(records, range(512), want) > 0
        sound = {i: (200, msgpack.packb({"r": [{"i": d, "s": s} for d, s in a]})) for i, a in enumerate(want)}
        assert harness.compare(sound, range(512), want) == 0
