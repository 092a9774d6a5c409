"""The port's device: explicit, never a silent CPU fallback.

Counterpart of acoustid_index_tpu/utils/jaxsetup.py.  `AITPU_TORCH_DEVICE`
names the torch device the index lives on, the way `AITPU_JAX_PLATFORMS`
pins the reference's platform.  The default is `cuda`; when no card is
present that is an error, not a quiet switch to the CPU.  The CPU tests set
`AITPU_TORCH_DEVICE=cpu` explicitly, and on the CPU every kernel wrapper
runs its plain PyTorch version.
"""

from __future__ import annotations

import os

import torch

_ENV = "AITPU_TORCH_DEVICE"


def device() -> torch.device:
    dev = torch.device(os.environ.get(_ENV, "cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{_ENV}={dev} but CUDA is unavailable; set {_ENV}=cpu to run on the CPU"
            )
        # Ids and scores are integers end to end and no stage uses a float
        # matmul, but keep any float32 product exact in case one appears:
        # TF32 keeps ~10 mantissa bits and would corrupt ids above 2^11.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
