"""PyTorch / CUDA port of the `repro` serving system for an NVIDIA H100.

The JAX package `repro` is the reference; this package imports nothing of
it and nothing of JAX.  Entry points run on `cuda` unless the caller asks
for the CPU (`device="cpu"`), and raise when no GPU is present and none
was asked for: there is no quiet fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `device` if given, else `cuda`.
    Raises when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev
