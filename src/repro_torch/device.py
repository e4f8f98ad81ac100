"""Device resolution for the PyTorch port.

Every entry point of the port runs on the CUDA card unless its caller
asks for another device.  With no card and no explicit device it raises:
the port never falls back to the CPU on its own, so a run that was meant
for the card cannot silently measure the CPU instead.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else -> ``torch.device(device)`` as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
