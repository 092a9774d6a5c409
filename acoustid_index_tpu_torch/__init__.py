"""acoustid_index_tpu_torch -- the fingerprint search engine on PyTorch and CUDA.

A port of acoustid_index_tpu (JAX/XLA with Pallas kernels for a TPU) to one
NVIDIA H100.  The host layer -- change model, WAL, segment files,
manifests, merge policy, HTTP plumbing, cluster replication -- is imported
from acoustid_index_tpu unchanged (none of it touches jax); this package
carries what ran on the device: tier packing and upload (engine/segments),
the batched search program (ops/search_kernel), the block-lookup kernels
(ops/block_lookup over csrc/block_lookup.cu), and copies of the modules
that reached jax at import (engine/index, engine/searcher,
multi/multi_index, server/app, main).  It never imports jax.

The device is `AITPU_TORCH_DEVICE` (default `cuda`; see utils/device.py).
"""

__version__ = "0.1.0"
