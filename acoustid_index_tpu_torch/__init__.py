"""acoustid_index_tpu_torch -- the fingerprint search engine on PyTorch and CUDA.

A port of acoustid_index_tpu (JAX/XLA with Pallas kernels for a TPU) to one
NVIDIA H100.  It carries its own copy of every module it runs: the host
layer (change model, WAL, segment files, manifests, merge policy, HTTP
plumbing, metrics, snapshots, cluster replication, and the C++ codecs,
native search front and load generator under csrc/*.cc, built with g++ at
first use), the legacy line protocol (server/legacy), profiling spans
(utils/profiling), and what runs on the device: tier packing and upload
(engine/segments), segment merges and term-table sorts (engine/
device_merge over ops/build), the batched search program
(ops/search_kernel, also behind models/fingerprint_search and entry) and
the block-lookup kernels (ops/block_lookup over csrc/block_lookup.cu).  Each
copied module's docstring names its counterpart; on-disk and wire formats
are byte-identical, so a data directory written by one package opens in
the other.  It imports neither jax nor anything of acoustid_index_tpu.

The device is `AITPU_TORCH_DEVICE` (default `cuda`; see utils/device.py).
"""

__version__ = "0.1.0"
