"""Explicit device resolution for the port's entry points.

There is no silent fallback: asking for "cuda" on a machine without a
CUDA device raises instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for a "cuda"/"cpu" spec (or a torch.device); raises
    RuntimeError when CUDA is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain torch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
