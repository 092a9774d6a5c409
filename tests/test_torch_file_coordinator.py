"""The cases of tests/test_file_coordinator.py, run against the port on the CPU: the
reference file's own source with its imports renamed to the port's modules
(test_torch_refcases.load)."""

from test_torch_refcases import load

LEFT_OUT: dict[str, str] = {}

load("test_file_coordinator", globals(), LEFT_OUT)
