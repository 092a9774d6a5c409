"""The benchmark of acoustid_index_tpu_torch: see run.py and PERF.md."""
