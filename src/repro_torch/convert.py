"""Carry model parameters between the JAX reference and the port.

Parameters cross as plain numpy arrays, so this module needs neither
framework's arrays on the other side: the caller converts the reference's
params with ``{k: np.asarray(v) for k, v in params.items()}``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def params_from_jax(params: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Reference params (numpy, same layout) -> float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port params -> numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
