"""Device placement for the kernel drivers: one device for now.

lra_tpu shards every bucket's batch axis data-parallel over a jax Mesh
(parallel/mesh.py there).  This port runs on a single CUDA device in
this slice, so the batch needs no rounding and placement is one
host-to-device copy per array; splitting buckets across
``torch.cuda.device_count()`` devices is queued in ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch


def batch_multiple(b: int) -> int:
    """Round a batch size up so the device count divides it (one device:
    unchanged)."""
    return b


def place_many(*arrays, device) -> tuple:
    """numpy arrays -> tensors on ``device``."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 .to(dev, non_blocking=True) for a in arrays)
