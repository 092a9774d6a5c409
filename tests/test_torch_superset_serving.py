"""The cases of tests/test_superset_serving.py, run against the port on the CPU: the
reference file's own source with its imports renamed to the port's modules
(test_torch_refcases.load).  The cases left out test what the port does
not have by design, each with its reason."""

from test_torch_refcases import load

LEFT_OUT = {
    'test_cold_bucket_serves_through_warm_superset':
        'The port has no superset-bucket program choice: with no compile to wait for, a cold bucket runs its own program.',
    'test_rebucketed_rows_preserve_fields':
        'The port has no superset-bucket program choice, so no row is ever re-bucketed into a larger program.',
}

load("test_superset_serving", globals(), LEFT_OUT)
