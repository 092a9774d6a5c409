"""Per-layer metrics: one file each, `<name>.py`, found by name (registry.py)."""
