"""The cases of tests/test_review_fixes.py, run against the port on the CPU: the
reference file's own source with its imports renamed to the port's modules
(test_torch_refcases.load).  The cases left out test what the port does
not have by design, each with its reason."""

from test_torch_refcases import load

LEFT_OUT = {
    'test_pick_batch_size_starts_pipeline_for_external_callers':
        'The port has no XLA precompiler: no precompile queue or warm-shape set exists for _pick_batch_size to start.',
}

load("test_review_fixes", globals(), LEFT_OUT)
