"""The cases of tests/test_bulk_ingest.py, run against the port on the CPU: the
reference file's own source with its imports renamed to the port's modules
(test_torch_refcases.load)."""

from test_torch_refcases import load

LEFT_OUT: dict[str, str] = {}

load("test_bulk_ingest", globals(), LEFT_OUT)
