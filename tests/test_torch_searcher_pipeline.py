"""The cases of tests/test_searcher_pipeline.py, run against the port on the CPU: the
reference file's own source with its imports renamed to the port's modules
(test_torch_refcases.load).  The cases left out test what the port does
not have by design, each with its reason."""

import pytest

from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher, _pack_rows
from test_torch_refcases import load

LEFT_OUT = {
    'test_cold_sizes_round_up_to_warm_bucket':
        'The port has no XLA precompiler: no warm-shape set, a batch pads plainly to the next BATCH_SIZES entry (engine/searcher.py docstring).',
    'test_batches_split_into_smaller_warm_chunks':
        'The port has no XLA precompiler: no warm-shape set to split a batch into; every batch size runs at once.',
    'test_precompiled_bucket_is_used_after_background_compile':
        'The port has no XLA precompiler: no background compile thread exists to record.',
    'test_warm_defaults_cover_primary_serving_bucket':
        'The port has no XLA precompiler: warm() is a no-op and keeps no set of warm buckets.',
    'test_warm_async_precompiles_serving_bucket':
        'The port has no XLA precompiler: warm_async() is a no-op; no program is compiled ahead of a search.',
    'test_index_write_triggers_background_warm':
        'The port has no XLA precompiler: a write triggers no background warm because there is nothing to compile.',
}

load("test_searcher_pipeline", globals(), LEFT_OUT)


def _run_batch_traced(self, snap, params, items):
    rows = [self._row(padded[:q_len], q_len, opts)[0] for padded, q_len, opts in items]
    return self._fetch(self._launch(snap, params, _pack_rows(params, rows, len(rows))))


@pytest.fixture(autouse=True)
def _one_plain_launch(monkeypatch):
    # The reference's synchronous warm launch (`_run_batch_traced`) is one plain launch in the port.
    monkeypatch.setattr(BatchingSearcher, "_run_batch_traced", _run_batch_traced, raising=False)

